"""Standalone window attention: the port of the JAX
``ops/pallas/window_attention.py`` (``fused_window_attention`` and its fused
backward) to hand-written CUDA for Hopper.

``softmax(q k^T * scale + bias [+ mask]) v`` over windows, with

* ``q [W, h, n, d]``, ``k, v [W, h, nk, d]`` (separate tensors; ``nk`` may
  be a multiple of ``n``: the decoder's ``attention_kv`` reads 192 encoder
  keys per 64-token window), or views ``[W, h, L, n / L, d]`` whose tokens
  come in L bands (the encoder's band regroup); any strides with d
  contiguous (:func:`descriptor`);
* ``bias [h, n, bc]`` float32, broadcast over windows, key j reading column
  ``j % bc`` (``bc`` divides ``nk``: one window's table stands for its tiling
  along the keys);
* ``mask [nW, mr, mc]`` float32 or None, window ``w`` taking ``mask[w % nW]``
  at ``(i % mr, j % mc)`` (the reference's additive -100 SW-MSA shift mask of
  one 64-token window stands for its tiling over bands and keys).

The TPU kernel packs two 64-token windows into one MXU tile and kills the
cross-window logits with -1e9 (``_pack_bias`` / ``_pack_mask``); that
packing is a device of the MXU's 128-wide tiles and is not ported: every
window is its own unit of work on the card.

The plain functions follow the rounding points of the Pallas bodies, not
the XLA composite: forward (Pallas ``_kernel``, :44-72) ``q.k`` accumulated
in fp32 and then scaled, per-row-max softmax in fp32, the probabilities
rounded to v's dtype before ``p.v``; backward (``_bwd_kernel``, :183-241)
the probabilities in fp32, ``g`` in fp32, the five products in fp32, dq /
dk / dv rounded to their inputs' dtypes, ``dbias`` in fp32 summed over
every window.

On a CUDA tensor :func:`window_attention` launches K9 (``csrc/window_attn.cu``)
by :func:`window_path`: in bf16 at the main path's shapes it reads q / k /
v in place and writes its output token-major, ``[L, W, n / L, h, d]`` (the
layout the projection after it reads), returned as a view shaped like q;
elsewhere it runs on joined operands and tiled tables.
:func:`window_attention_bwd` launches K10 (``csrc/window_attn_bwd.cu``). On
a CPU tensor they run the plain functions, which tile the tables inside.
:class:`WindowAttentionFn` is the autograd Function over the two.
``LAUNCHES`` counts the launches, one per launcher call that reached the
card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from torch import Tensor

from .lewin_block import (_DTYPES, _check, _f32, _launch, _ptr, _run,
                          _stream)

LAUNCHES = {"window_attn": 0, "window_attn_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def descriptor(t: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """K9's stride descriptor of an operand ``t``, a view ``[W, h, L, nb, d]``
    (or ``[W, h, n, d]``, one band): the strides in elements of (window,
    head, band, token within the band), then the tokens of a band. The head
    dim must be contiguous."""
    if t.dim() == 4:
        t = t.unsqueeze(2)
    if t.dim() != 5:
        raise ValueError(f"operand of shape {tuple(t.shape)}: expected "
                         "[W, h, n, d] or [W, h, L, n / L, d]")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"operand strides {t.stride()}: the head dim must "
                         "be contiguous")
    sw, sh, sb, st, _ = t.stride()
    return sw, sh, sb, st, t.shape[3]


def grouped(t: torch.Tensor) -> torch.Tensor:
    """An operand as one contiguous ``[W, h, n, d]`` tensor (its bands
    joined: a copy where they are apart)."""
    return t.reshape(t.shape[0], t.shape[1], -1, t.shape[-1]).contiguous()


def _tile(t: Optional[torch.Tensor], rows: int, cols: int):
    """A table ``[..., r, c]`` tiled to ``[..., rows, cols]`` (r divides rows,
    c divides cols), as the reference repeats the window's bias along the
    keys and its shift mask over the bands."""
    if t is None:
        return None
    r, c = t.shape[-2:]
    if rows % r or cols % c:
        raise ValueError(f"a [{r}, {c}] table does not tile [{rows}, {cols}]")
    if (r, c) == (rows, cols):
        return t
    return t.repeat(*([1] * (t.dim() - 2)), rows // r, cols // c)


def _logits(q, k, bias, mask, scale: float, nW: int) -> torch.Tensor:
    """fp32 ``(q.k) * scale + bias [+ mask]``, ``[W, h, n, nk]``, the tables
    tiled to ``[n, nk]``."""
    W, h, n, _ = q.shape
    nk = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + _tile(bias.float(), n, nk)[None]
    if mask is not None:
        mask = _tile(mask.float(), n, nk)
        s = (s.reshape(W // nW, nW, h, n, nk)
             + mask.reshape(1, nW, 1, n, nk)).reshape(W, h, n, nk)
    return s


def probabilities(q, k, bias, mask, scale: float, nW: int) -> torch.Tensor:
    """The fp32 attention probabilities ``[W, h, n, nk]`` (per-row-max
    softmax of :func:`_logits`), for the band modulations that need them."""
    s = _logits(q, k, bias, mask, scale, nW)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def window_attention_plain(q, k, v, bias, mask, scale: float,
                           nW: int) -> torch.Tensor:
    """The Pallas forward body in plain PyTorch: q's shape and dtype (a
    banded ``[W, h, L, n / L, d]`` operand is joined first)."""
    q4, k4, v4 = (t if t.dim() == 4 else grouped(t) for t in (q, k, v))
    p = probabilities(q4, k4, bias, mask, scale, nW)
    out = torch.matmul(p.to(v.dtype).float(), v4.float()).to(q.dtype)
    return out.reshape(q.shape)


def _fold(dbias: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The gradient of a tiled bias ``[h, n, nk]`` folded back onto the
    table ``bias [h, n, bc]``: the sum over its tiles."""
    h, n, nk = dbias.shape
    bc = bias.shape[-1]
    if bc == nk:
        return dbias
    return dbias.reshape(h, n, nk // bc, bc).sum(2)


def window_attention_bwd_plain(q, k, v, bias, mask, g, scale: float,
                               nW: int):
    """The Pallas backward body in plain PyTorch: ``(dq, dk, dv, dbias)``,
    dq / dk / dv in their inputs' dtypes, ``dbias`` float32 in the bias's
    shape."""
    p = probabilities(q, k, bias, mask, scale, nW)
    gf = g.float()
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, v.float().transpose(-1, -2))
    dl = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(dl, k.float()) * scale
    dk = torch.matmul(dl.transpose(-1, -2), q.float()) * scale
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            _fold(dl.sum(0), bias))


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _operands(q, k, v, bias, mask, nW: int, *extra):
    """Checks of K10: contiguous ``[W, h, n, d]`` operands; the fp32 bias
    and mask tiled to ``[n, nk]``."""
    W, h, n, d = q.shape
    nk = k.shape[2]
    _check(q, k, v, bias, mask, *extra)
    for t, shape in ((k, (W, h, nk, d)), (v, (W, h, nk, d)),
                     *((t, (W, h, n, d)) for t in extra)):
        if (tuple(t.shape) != shape or t.dtype != q.dtype
                or not t.is_contiguous()):
            raise ValueError(f"tensor {tuple(t.shape)} {t.dtype}: expected "
                             f"contiguous {shape} {q.dtype}")
    if mask is not None and W % nW:
        raise ValueError(f"{W} windows are not a whole number of images of "
                         f"{nW} windows")
    mask = None if mask is None else _tile(mask.float(), n, nk)
    return (_f32(_tile(bias.float(), n, nk), (h, n, nk)),
            _f32(mask, (nW, n, nk)))


def _aligned(t: torch.Tensor, nbytes: int) -> bool:
    """Whether ``t``'s first element sits on an ``nbytes`` boundary: by its
    address, or, while ``torch.export`` traces the caller (a traced tensor
    has no address), by its offset in its storage, whose base the caching
    allocator aligns to 512 bytes (:func:`launch_window_attn_mma` checks the
    address again)."""
    if torch.compiler.is_exporting():
        return t.storage_offset() * t.element_size() % nbytes == 0
    return t.data_ptr() % nbytes == 0


def window_path(q, k, v, bias, mask) -> str:
    """How K9 runs: ``'mma'``, on the tensor cores with q / k / v read in
    place (bf16; (n, nk, d) = (64, 64, 33..64), (64, 192, 33..64) or (192,
    192, <= 32); the bias one window's ``[h, n, 64]`` or whole, the encoder's
    ``[h, 192, 192]``; the mask one window's ``[nW, 64, 64]``, or at (64,
    192) ``[nW, 64, 192]``; every operand's strides and address allowing
    16-byte copies, 8-byte at d <= 32), else ``'cores'``: the CUDA cores on
    contiguous operands and tiled tables, which the launcher joins (fp32
    and the other shapes)."""
    q5, k5 = (t if t.dim() == 5 else t.unsqueeze(2) for t in (q, k))
    W, h, L, nb, d = q5.shape
    n, nk = L * nb, k5.shape[2] * k5.shape[3]
    bc = bias.shape[-1]
    tile = None if mask is None else tuple(mask.shape[1:])
    if q.dtype != torch.bfloat16:
        return "cores"
    if n == 64 and nk == 64 and 32 < d <= 64:
        ok = bc == 64 and tile in (None, (64, 64))
    elif n == 64 and nk == 192 and 32 < d <= 64:
        ok = (bc, tile) in ((64, None), (64, (64, 64)), (192, None),
                            (192, (64, 192)))
    elif n == 192 and nk == 192 and d <= 32:
        ok = bc == 192 and tile in (None, (64, 64))
    else:
        ok = False
    elems = 8 if d > 32 else 4  # 16- or 8-byte copies
    return "mma" if ok and d % elems == 0 and all(
        _aligned(t, 2 * elems) and all(x % elems == 0 for x in
                                       descriptor(t)[:4])
        for t in (q, k, v)) else "cores"


def window_attention_kernel(q, k, v, bias, mask, scale: float, nW: int):
    """Launch K9 on CUDA tensors, q's shape and dtype out, by
    :func:`window_path`: on the tensor cores q / k / v are read in place
    (any strides with d contiguous, :func:`descriptor`) with the tables as
    given, and the output is written token-major ``[L, W, n / L, h, d]``
    and returned as a view; on the CUDA cores the operands are joined and
    the tables tiled first."""
    banded = q.dim() == 5
    q5, k5, v5 = (t if t.dim() == 5 else t.unsqueeze(2) for t in (q, k, v))
    W, h, L, nb, d = q5.shape
    n, nk = L * nb, k5.shape[2] * k5.shape[3]
    for t in (q, k, v, bias, mask):
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"the CUDA kernels take CUDA tensors, got "
                             f"{t.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernels take float32 or bfloat16, got {q.dtype}")
    for t in (k5, v5):
        if (t.dtype != q.dtype or tuple(t.shape[:2]) != (W, h)
                or t.shape[-1] != d or t.shape[2] * t.shape[3] != nk):
            raise ValueError(f"k / v {tuple(t.shape)} {t.dtype} against q "
                             f"{tuple(q.shape)} {q.dtype}")
    if mask is not None and W % nW:
        raise ValueError(f"{W} windows are not a whole number of images of "
                         f"{nW} windows")
    bias = bias.float().contiguous()
    if bias.dim() != 3 or tuple(bias.shape[:2]) != (h, n) or nk % bias.shape[2]:
        raise ValueError(f"bias {tuple(bias.shape)}: expected [{h}, {n}, bc] "
                         f"with bc dividing {nk}")
    if mask is not None:
        mask = mask.float().contiguous()
        if (mask.dim() != 3 or mask.shape[0] != nW or n % mask.shape[1]
                or nk % mask.shape[2]):
            raise ValueError(f"mask {tuple(mask.shape)}: expected [{nW}, mr, "
                             f"mc] tiling [{n}, {nk}]")
    if window_path(q, k, v, bias, mask) == "cores":
        tiled = None if mask is None else _tile(mask, n, nk).contiguous()
        out = _launch("window_attn", launch_window_attn, grouped(q),
                      grouped(k), grouped(v), _tile(bias, n, nk).contiguous(),
                      tiled, float(scale), nW)
        return out.reshape(q.shape)
    out = _launch("window_attn_mma", launch_window_attn_mma, q, k, v, bias,
                  mask, float(scale), nW)
    o5 = out.permute(1, 3, 0, 2, 4)
    return o5 if banded else o5.squeeze(2)


def launch_window_attn(q: Tensor, k: Tensor, v: Tensor, bias: Tensor,
                       mask: Optional[Tensor], scale: float,
                       nW: int) -> Tensor:
    """K9 on the CUDA cores: contiguous ``[W, h, n, d]`` operands and tables
    tiled to ``[n, nk]`` (:func:`window_attention_kernel`); ``[W, h, n,
    d]`` out."""
    from .build import load

    W, h, n, d = q.shape
    out = torch.empty_like(q)
    _run(load().fairm_window_attn, _ptr(q), _ptr(k), _ptr(v), _ptr(bias),
         _ptr(mask), _ptr(out), W, h, n, k.shape[2], d, nW, scale,
         _DTYPES[q.dtype], _stream(q))
    LAUNCHES["window_attn"] += 1
    return out


def launch_window_attn_mma(q: Tensor, k: Tensor, v: Tensor, bias: Tensor,
                           mask: Optional[Tensor], scale: float,
                           nW: int) -> Tensor:
    """K9 on the tensor cores, q / k / v read in place through their
    strides (:func:`window_attention_kernel`); the output token-major,
    ``[L, W, n / L, h, d]``."""
    from .build import load

    q5, k5, v5 = (t if t.dim() == 5 else t.unsqueeze(2) for t in (q, k, v))
    W, h, L, nb, d = q5.shape
    elems = 8 if d > 32 else 4
    if any(t.data_ptr() % (2 * elems) for t in (q, k, v)):
        raise ValueError("K9's tensor-core form needs q / k / v on "
                         f"{2 * elems}-byte boundaries")
    mr, mc = (1, 1) if mask is None else mask.shape[1:]
    out = torch.empty((L, W, nb, h, d), dtype=q.dtype, device=q.device)
    o5 = out.permute(1, 3, 0, 2, 4)
    desc = (ctypes.c_longlong * 20)(*(x for t in (q5, k5, v5, o5)
                                      for x in descriptor(t)))
    _run(load().fairm_window_attn_mma, _ptr(q), _ptr(k), _ptr(v), _ptr(out),
         _ptr(bias), _ptr(mask), ctypes.addressof(desc), W, h, L * nb,
         k5.shape[2] * k5.shape[3], d, nW, bias.shape[2], mr, mc, scale,
         _stream(q))
    LAUNCHES["window_attn"] += 1
    return out


def window_attention_bwd_kernel(q, k, v, bias, mask, g, scale: float,
                                nW: int):
    """Launch K10 on CUDA tensors (contiguous ``[W, h, n, d]`` operands; the
    tables tiled here); dbias in the bias's shape."""
    from .build import load

    W, h, n, d = q.shape
    nk = k.shape[2]
    g = g.contiguous()
    tiled, mask = _operands(q, k, v, bias, mask, nW, g)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty((h, n, nk), dtype=torch.float32, device=q.device)
    lib = load()
    nbytes = lib.fairm_window_attn_bwd_ws(W, h, n, nk)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
    _run(lib.fairm_window_attn_bwd, _ptr(q), _ptr(k), _ptr(v), _ptr(tiled),
         _ptr(mask), _ptr(g), _ptr(ws), _ptr(dq), _ptr(dk), _ptr(dv),
         _ptr(dbias), nbytes, W, h, n, nk, d, nW, float(scale),
         _DTYPES[q.dtype], _stream(q))
    LAUNCHES["window_attn_bwd"] += 1
    return dq, dk, dv, _fold(dbias, bias)


# ---------------------------------------------------------------------------
# entry points: the plain function on a CPU tensor, the kernel on a CUDA one
# ---------------------------------------------------------------------------


def window_attention(q, k, v, bias, mask: Optional[torch.Tensor],
                     scale: float, nW: int) -> torch.Tensor:
    """``softmax(q k^T * scale + bias [+ mask]) v`` in q's shape and dtype
    (the Pallas ``fused_window_attention``)."""
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, mask, scale, nW)
    return window_attention_kernel(q, k, v, bias, mask, scale, nW)


def window_attention_bwd(q, k, v, bias, mask, g, scale: float, nW: int):
    """Backward of :func:`window_attention`: ``(dq, dk, dv, dbias)``."""
    if q.device.type == "cpu":
        return window_attention_bwd_plain(q, k, v, bias, mask, g, scale, nW)
    return window_attention_bwd_kernel(q, k, v, bias, mask, g, scale, nW)


class WindowAttentionFn(torch.autograd.Function):
    """:func:`window_attention` (K9) with the backward of K10; the mask
    takes no gradient, the bias its fp32 gradient cast to its dtype. The
    forward saves q / k / v as they come (views); the backward joins them
    into the contiguous operands K10 takes."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale, nW):
        ctx.save_for_backward(q, k, v, bias, mask)
        ctx.scale, ctx.nW = scale, nW
        return window_attention(q, k, v, bias, mask, scale, nW)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, mask = ctx.saved_tensors
        dq, dk, dv, dbias = window_attention_bwd(
            grouped(q), grouped(k), grouped(v), bias, mask, grouped(g),
            ctx.scale, ctx.nW)
        return (dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape),
                dbias.to(bias.dtype), None, None, None)
