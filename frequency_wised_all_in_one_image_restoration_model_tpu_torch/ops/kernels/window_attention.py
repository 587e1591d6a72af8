"""Standalone window attention: the port of the JAX
``ops/pallas/window_attention.py`` (``fused_window_attention`` and its fused
backward) to hand-written CUDA for Hopper.

``softmax(q k^T * scale + bias [+ mask]) v`` over windows, with

* ``q [W, h, n, d]``, ``k, v [W, h, nk, d]`` (separate tensors; ``nk`` may
  be a multiple of ``n``: the decoder's ``attention_kv`` reads 192 encoder
  keys per 64-token window);
* ``bias [h, n, nk]`` float32, broadcast over windows;
* ``mask [nW, n, nk]`` float32 or None, window ``w`` taking ``mask[w % nW]``
  (the reference's additive -100 SW-MSA shift mask).

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
and :func:`window_attention_bwd` K10 (``csrc/window_attn_bwd.cu``); on a CPU
tensor they run the plain functions. :class:`WindowAttentionFn` is the
autograd Function over the two. ``LAUNCHES`` counts the launches, one
per launcher call that reached the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from .lewin_block import _DTYPES, _check, _f32, _ptr, _run, _stream

LAUNCHES = {"window_attn": 0, "window_attn_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _logits(q, k, bias, mask, scale: float, nW: int) -> torch.Tensor:
    """fp32 ``(q.k) * scale + bias [+ mask]``, ``[W, h, n, nk]``."""
    W, h, n, _ = q.shape
    nk = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + bias.float()[None]
    if mask is not None:
        s = (s.reshape(W // nW, nW, h, n, nk)
             + mask.float().reshape(1, nW, 1, n, nk)).reshape(W, h, n, nk)
    return s


def probabilities(q, k, bias, mask, scale: float, nW: int) -> torch.Tensor:
    """The fp32 attention probabilities ``[W, h, n, nk]`` (per-row-max
    softmax of :func:`_logits`), for the band modulations that need them."""
    s = _logits(q, k, bias, mask, scale, nW)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def window_attention_plain(q, k, v, bias, mask, scale: float,
                           nW: int) -> torch.Tensor:
    """The Pallas forward body in plain PyTorch: ``[W, h, n, d]`` in q's
    dtype."""
    p = probabilities(q, k, bias, mask, scale, nW)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def window_attention_bwd_plain(q, k, v, bias, mask, g, scale: float,
                               nW: int):
    """The Pallas backward body in plain PyTorch: ``(dq, dk, dv, dbias)``,
    dq / dk / dv in their inputs' dtypes, ``dbias [h, n, nk]`` float32."""
    p = probabilities(q, k, bias, mask, scale, nW)
    gf = g.float()
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, v.float().transpose(-1, -2))
    dl = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(dl, k.float()) * scale
    dk = torch.matmul(dl.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dl.sum(0)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _operands(q, k, v, bias, mask, nW: int, *extra):
    """Checks shared by K9 and K10; the fp32 bias and mask."""
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
    return _f32(bias, (h, n, nk)), _f32(mask, (nW, n, nk))


def window_attention_kernel(q, k, v, bias, mask, scale: float, nW: int):
    """Launch K9 on CUDA tensors."""
    from .build import load

    W, h, n, d = q.shape
    nk = k.shape[2]
    bias, mask = _operands(q, k, v, bias, mask, nW)
    out = torch.empty_like(q)
    _run(load().fairm_window_attn, _ptr(q), _ptr(k), _ptr(v), _ptr(bias),
         _ptr(mask), _ptr(out), W, h, n, nk, d, nW, float(scale),
         _DTYPES[q.dtype], _stream(q))
    LAUNCHES["window_attn"] += 1
    return out


def window_attention_bwd_kernel(q, k, v, bias, mask, g, scale: float,
                                nW: int):
    """Launch K10 on CUDA tensors."""
    from .build import load

    W, h, n, d = q.shape
    nk = k.shape[2]
    g = g.contiguous()
    bias, mask = _operands(q, k, v, bias, mask, nW, g)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty((h, n, nk), dtype=torch.float32, device=q.device)
    lib = load()
    nbytes = lib.fairm_window_attn_bwd_ws(W, h, n, nk)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
    _run(lib.fairm_window_attn_bwd, _ptr(q), _ptr(k), _ptr(v), _ptr(bias),
         _ptr(mask), _ptr(g), _ptr(ws), _ptr(dq), _ptr(dk), _ptr(dv),
         _ptr(dbias), nbytes, W, h, n, nk, d, nW, float(scale),
         _DTYPES[q.dtype], _stream(q))
    LAUNCHES["window_attn_bwd"] += 1
    return dq, dk, dv, dbias


# ---------------------------------------------------------------------------
# entry points: the plain function on a CPU tensor, the kernel on a CUDA one
# ---------------------------------------------------------------------------


def window_attention(q, k, v, bias, mask: Optional[torch.Tensor],
                     scale: float, nW: int) -> torch.Tensor:
    """``softmax(q k^T * scale + bias [+ mask]) v``, ``[W, h, n, d]`` in q's
    dtype (the Pallas ``fused_window_attention``)."""
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
    takes no gradient, the bias its fp32 gradient cast to its dtype."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale, nW):
        ctx.save_for_backward(q, k, v, bias, mask)
        ctx.scale, ctx.nW = scale, nW
        return window_attention(q, k, v, bias, mask, scale, nW)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, mask = ctx.saved_tensors
        dq, dk, dv, dbias = window_attention_bwd(q, k, v, bias, mask, g,
                                                 ctx.scale, ctx.nW)
        return dq, dk, dv, dbias.to(bias.dtype), None, None, None
