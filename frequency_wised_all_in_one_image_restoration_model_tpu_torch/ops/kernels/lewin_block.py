"""LeWin-block kernels: the port of the JAX ``ops/pallas/lewin_block.py``
forward kernels to hand-written CUDA for Hopper (``csrc/``).

Six entry points, signatures as their Pallas counterparts (images
``[B, H, W, C]``, per-head weights ``wq3 [h, C, d]``, ``wp3 [h, d, C]``):

* :func:`block_attention` — ``x + dps * proj(win_attn(LN1(x)))`` with the
  relative-position bias, the SW-MSA mask and the all_DC rank-1 gain
  ``lam`` (K1, ``csrc/lewin_attn.cu``; Pallas ``fused_block_attention``);
* :func:`freq_intra` — per-band window attention on the band-folded batch,
  no residual (K1 with per-band bias tables; ``fused_freq_intra``);
* :func:`freq_inter` — ``res + dps * proj(grouped_attn(y))`` over each
  window's L*n band-grouped tokens (K3, ``csrc/freq_inter.cu``;
  ``fused_freq_inter``);
* :func:`block_ffn` — ``x + dps * LeFF(LN2(x))`` (K2, ``csrc/lewin_ffn.cu``;
  ``fused_block_ffn``);
* :func:`block_merged` — one whole origin-MSA block, the first then the
  last of the above, on the TRUE-layout image with the SW-MSA roll inside
  (K4, ``csrc/lewin_merged.cu``; ``fused_block_merged``);
* :func:`block_freq_merged` — one whole frequency-MSA block, intra ->
  inter -> FFN, likewise (K5, ``csrc/freq_merged.cu``;
  ``fused_block_freq_merged``);
* :func:`block_attention_split` — :func:`block_attention` with the q / k /
  v projections as three [C, C] blocks and the projection's reduction cut
  into fp32 partials (K12, ``csrc/lewin_attn_split.cu``; Pallas
  ``_attn_kernel_split``);
* :func:`block_ffn_split` — :func:`block_ffn` as a sum over hidden blocks,
  linear2's partials in fp32 (K13, ``csrc/lewin_ffn_split.cu``; Pallas
  ``_ffn_kernel_split``).

Each has a ``*_plain`` twin in plain PyTorch that mirrors the JAX package's
XLA composite (``_xla_block_attention`` and friends) with a per-row-max
softmax. A wrapper takes its plain twin only for a tensor on the CPU; on a
CUDA tensor it launches its kernel or raises.

On the card a wrapper is two steps: :func:`attn_operands` /
:func:`ffn_operands` turn the weights into the kernels' formats (GEMM
operands ``[N, kpad(K)]`` in the compute dtype, fp32 biases and tables),
and :func:`attention_kernel`, :func:`freq_inter_kernel`,
:func:`ffn_kernel`, :func:`merged_kernel` and :func:`freq_merged_kernel`
check those operands and launch. The model makes the
operands once per parameter version (``models/uformer_blocks.py``) and
calls the launchers directly. A launcher's last step, the launch itself on
checked operands (``launch_attn`` and the other ``launch_*``), is also the
custom op ``fairm::<name>`` (``custom_ops.py``), which a program that
``torch.export`` traces calls in its place (:func:`_launch`).
``LAUNCHES`` counts kernel launches per kernel (K1 ``lewin_attn`` serves
two entry points), one per launch that reached the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import Tensor

LAUNCHES = {"lewin_attn": 0, "lewin_ffn": 0, "freq_inter": 0,
            "lewin_merged": 0, "freq_merged": 0, "lewin_attn_split": 0,
            "lewin_ffn_split": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------


def _layer_norm(x_img, lns, lnb, eps):
    xf = x_img.float()
    return xf, F.layer_norm(xf, (xf.shape[-1],), lns.float(), lnb.float(), eps)


def _windows(img, win):
    """[B, H, W, C] -> [B*nW, n, C] window-major tokens."""
    B, H, W, C = img.shape
    return (img.reshape(B, H // win, win, W // win, win, C)
            .permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, C))


def _unwindows(t, B, H, W, win):
    """[B*nW, n, C] -> [B, H, W, C]."""
    C = t.shape[-1]
    return (t.reshape(B, H // win, W // win, win, win, C)
            .permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C))


def _heads(xw, w3, b3, dtype):
    """[M, n, C] tokens -> [M, h, n, d] head projections (rounded to dtype,
    as the JAX composites round q/k/v)."""
    h, C, d = w3.shape
    w = w3.permute(1, 0, 2).reshape(C, h * d).to(dtype)
    out = torch.matmul(xw.to(dtype), w).float() + b3.float().reshape(h * d)
    return out.reshape(*xw.shape[:2], h, d).permute(0, 2, 1, 3).to(dtype)


def _softmax_av(q, k, v, bias, mask, groups, nW, dtype):
    """softmax(q k^T * d^-0.5 + bias + mask) v with fp32 logits and a
    per-row-max softmax. ``q/k/v [M, h, n, d]`` over ``M = B*nW`` windows;
    ``bias [groups, h, n, n]`` (window m in group m // (M/groups));
    ``mask [nW, n, n]`` or None (window m at position m % nW)."""
    M, h, n, d = q.shape
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
    logits = (logits.reshape(groups, M // groups, h, n, n)
              + bias.float().reshape(groups, 1, h, n, n))
    if mask is not None:
        logits = (logits.reshape(M // nW, nW, h, n, n)
                  + mask.float().reshape(1, nW, 1, n, n))
    p = torch.softmax(logits.reshape(M, h, n, n), dim=-1)
    return torch.matmul(p.to(dtype), v).float()       # [M, h, n, d]


def split_cols(k: int, kb: int, dtype=None):
    """The ``kb`` ranges of a reduction of width ``k`` as the split kernels
    (K12, K13) cut it: ``kpad(k) / kb`` columns each, a whole number of
    32-wide k-tiles, the last range clipped to ``k``. In bfloat16 the
    kernels run the parts in one launch on 64-wide k-tiles, so there each
    of ``kb > 1`` parts is a whole number of those."""
    if kb < 1 or (kpad(k) // 32) % kb:
        raise ValueError(f"{kb} parts do not divide the {kpad(k) // 32} "
                         f"k-tiles of a width-{k} reduction")
    if dtype == torch.bfloat16 and kb > 1 and kpad(k) % (64 * kb):
        raise ValueError(f"{kb} bfloat16 parts of a width-{k} reduction "
                         f"are not whole 64-wide k-tiles")
    step = kpad(k) // kb
    return [slice(z * step, min((z + 1) * step, k)) for z in range(kb)]


def _split_product(a, w, kb: int):
    """``a @ w`` as ``kb`` partial products over :func:`split_cols` of the
    reduction, each in fp32, added in order (the split kernels' partials)."""
    acc = None
    for s in split_cols(w.shape[0], kb):
        part = torch.matmul(a[..., s], w[s]).float()
        acc = part if acc is None else acc + part
    return acc


def _project(out, wp3, bp, dtype, kb: int = 1):
    """[M, h, n, d] fp32 -> [M, n, C] fp32 output projection, its reduction
    in ``kb`` fp32 partials."""
    M, h, n, d = out.shape
    C = wp3.shape[-1]
    o = out.to(dtype).permute(0, 2, 1, 3).reshape(M, n, h * d)
    return _split_product(o, wp3.reshape(h * d, C).to(dtype), kb) + bp.float()


def _attention_plain(x_img, lns, lnb, wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp,
                     bias, mask, lam, win, eps, res, bias_groups, dps,
                     kb: int = 1):
    B, H, W, C = x_img.shape
    h = wq3.shape[0]
    n = win * win
    nW = (H // win) * (W // win)
    dtype = x_img.dtype
    xf, xn = _layer_norm(x_img, lns, lnb, eps)
    xw = _windows(xn.to(dtype), win)
    q, k, v = (_heads(xw, w, b, dtype) for w, b in
               ((wq3, bq3), (wk3, bk3), (wv3, bv3)))
    # band-major batch: window m belongs to band m // (B/L * nW)
    out = _softmax_av(q, k, v, bias, mask, bias_groups, nW, dtype)
    if lam is not None:
        # all_DC rank-1 modulation: (1+lam) out - (lam/n) sum_m v[m]
        lam_w = lam.float().repeat_interleave(nW, dim=0)[:, :, None, None]
        vs = v.float().sum(dim=2, keepdim=True)
        out = (1.0 + lam_w) * out - (lam_w / n) * vs
    y = _unwindows(_project(out, wp3, bp, dtype, kb), B, H, W, win)
    if dps is not None:
        y = y * dps.float()[:, None, None, None]
    return (xf + y).to(dtype) if res else y.to(dtype)


def block_attention_plain(x_img, lns, lnb, wq3, bq3, wk3, bk3, wv3, bv3, wp3,
                          bp, bias, mask, lam, win: int = 8, eps: float = 1e-6,
                          dps=None):
    """Plain twin of :func:`block_attention` (JAX ``_xla_block_attention``)."""
    return _attention_plain(x_img, lns, lnb, wq3, bq3, wk3, bk3, wv3, bv3,
                            wp3, bp, bias, mask, lam, win, eps, True, 1, dps)


def freq_intra_plain(x_img, lns, lnb, wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp,
                     biasA, mask, L: int, win: int = 8, eps: float = 1e-6):
    """Plain twin of :func:`freq_intra` (JAX ``_xla_freq_intra``)."""
    return _attention_plain(x_img, lns, lnb, wq3, bq3, wk3, bk3, wv3, bv3,
                            wp3, bp, biasA, mask, None, win, eps, False, L,
                            None)


def freq_inter_plain(y_img, res_img, wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp,
                     biasB, mask, L: int = 1, win: int = 8, eps: float = 1e-6,
                     dps=None):
    """Plain twin of :func:`freq_inter` (JAX ``_xla_freq_inter`` plus the
    in-kernel DropPath scale)."""
    LB, H, W, C = y_img.shape
    B = LB // L
    n = win * win
    nW = (H // win) * (W // win)
    dtype = y_img.dtype
    # (l b nW) n c -> (b nW) (l n) c: each window's L band copies grouped
    z = (_windows(y_img, win).reshape(L, B * nW, n, C).transpose(0, 1)
         .reshape(B * nW, L * n, C))
    q, k, v = (_heads(z, w, b, dtype) for w, b in
               ((wq3, bq3), (wk3, bk3), (wv3, bv3)))
    mask_t = None if mask is None else mask.repeat(1, L, L)
    out = _softmax_av(q, k, v, biasB, mask_t, 1, nW, dtype)
    proj = _project(out, wp3, bp, dtype)              # [B*nW, L*n, C]
    y = (proj.reshape(B * nW, L, n, C).transpose(0, 1)
         .reshape(LB * nW, n, C))
    y = _unwindows(y, LB, H, W, win)
    if dps is not None:
        y = y * dps.float()[:, None, None, None]
    return (res_img.float() + y).to(dtype)


def inter_bias(pairs, L: int, win: int = 8):
    """The grouped bias ``[h, L*n, L*n]`` of the cross-band attention, formed
    from the per-pair relative-position tables ``pairs [L*L, (2 win - 1)^2,
    h]`` as the fused K3 forms it on the SM: entry ``(hh, l n + i, m n + j)``
    is ``pairs[l L + m, r(i, j), hh]`` plus the 'inter' band mask (-100
    where ``l == m``, else 0), one fp32 add, with ``r(i, j) = (y_i - y_j +
    win - 1) (2 win - 1) + x_i - x_j + win - 1`` for token ``t = y win +
    x`` (``ops/windows.py::relative_position_index``)."""
    n = win * win
    h = pairs.shape[-1]
    t = torch.arange(n, device=pairs.device)
    y, x = t // win, t % win
    r = ((y[:, None] - y[None, :] + win - 1) * (2 * win - 1)
         + x[:, None] - x[None, :] + win - 1)
    g = (pairs.float()[:, r.reshape(-1)].reshape(L, L, n, n, h)
         .permute(4, 0, 2, 1, 3).reshape(h, L * n, L * n))
    same = torch.eye(L, dtype=torch.bool, device=pairs.device)
    band = torch.where(same, -100.0, 0.0).repeat_interleave(n, 0) \
        .repeat_interleave(n, 1)
    return g + band


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _ffn_plain(x_img, lns, lnb, w1, b1, wd, bd, w2, b2, eps, dps,
               round_hidden: bool):
    dtype = x_img.dtype
    Hd = w1.shape[1]
    xf, xn = _layer_norm(x_img, lns, lnb, eps)
    hdn = _gelu(torch.matmul(xn.to(dtype), w1.to(dtype)).float() + b1.float())
    if round_hidden:
        hdn = hdn.to(dtype).float()
    hdn = F.conv2d(hdn.permute(0, 3, 1, 2),
                   wd.float().permute(2, 0, 1)[:, None], padding=1, groups=Hd)
    hdn = _gelu(hdn.permute(0, 2, 3, 1) + bd.float())
    y = torch.matmul(hdn.to(dtype), w2.to(dtype)).float() + b2.float()
    if dps is not None:
        y = y * dps.float()[:, None, None, None]
    return (xf + y).to(dtype)


def block_ffn_plain(x_img, lns, lnb, w1, b1, wd, bd, w2, b2,
                    eps: float = 1e-6, dps=None):
    """Plain twin of :func:`block_ffn` (JAX ``_xla_block_ffn``): the hidden
    in fp32 from fc1 through the conv, rounded once for fc2."""
    return _ffn_plain(x_img, lns, lnb, w1, b1, wd, bd, w2, b2, eps, dps,
                      False)


def ffn_rounded_hidden_plain(x_img, lns, lnb, w1, b1, wd, bd, w2, b2,
                             eps: float = 1e-6, dps=None):
    """:func:`block_ffn_plain` with the hidden rounded to the compute dtype
    after fc1 + GELU: the rounding points that K2's passes, K13, K4 and K5
    had before they kept the hidden in fp32 as JAX does. ``chip_smoke.py``
    and the card tests hold those kernels closer to :func:`block_ffn_plain`
    than to this twin, on :func:`f2_ffn_weights`."""
    return _ffn_plain(x_img, lns, lnb, w1, b1, wd, bd, w2, b2, eps, dps,
                      True)


def f2_ffn_weights(C: int, randn):
    """LeFF weights ``[w1, b1, wd, bd, w2, b2]`` (hidden 4 C) under which a
    bf16 rounding of the hidden after fc1 shows: fc1's outputs sit near 100
    (bf16 spacing 0.5) and vary by less than 1, and the conv's taps cancel
    (centre 1, the eight others -1/8), so the conv's output away from the
    image's rim is a small difference of large values. ``randn(*shape,
    scale=...)`` draws w1, w2 and b2 in that order, on its device."""
    Hd = 4 * C
    w1 = randn(C, Hd, scale=0.02)
    dev = w1.device
    wd = torch.full((3, 3, Hd), -0.125, device=dev)
    wd[1, 1] = 1.0
    return [w1, torch.full((Hd,), 100.0, device=dev), wd,
            torch.zeros(Hd, device=dev), randn(Hd, C, scale=Hd ** -0.5),
            randn(C, scale=0.1)]


def lewin_attn_split_plain(x_img, lns, lnb, wq3, bq3, wk3, bk3, wv3, bv3, wp3,
                           bp, bias, mask, lam, win: int = 8,
                           eps: float = 1e-6, dps=None, kb: int = 1):
    """Plain twin of :func:`block_attention_split` (JAX
    ``_attn_kernel_split``): q, k and v each projected by its own [C, C]
    block and rounded to the compute dtype before the core (``part.astype
    (dtype)``, lewin_block.py:244-252), the projection's reduction in ``kb``
    fp32 partials."""
    return _attention_plain(x_img, lns, lnb, wq3, bq3, wk3, bk3, wv3, bv3,
                            wp3, bp, bias, mask, lam, win, eps, True, 1, dps,
                            kb)


def lewin_ffn_split_plain(x_img, lns, lnb, w1, b1, wd, bd, w2, b2,
                          eps: float = 1e-6, dps=None, kb: int = 1):
    """Plain twin of :func:`block_ffn_split` (JAX ``_ffn_kernel_split``):
    each of the ``kb`` hidden blocks (:func:`split_cols`) through linear1,
    GELU, the depthwise conv and GELU into its fp32 partial product with its
    rows of ``w2``; the partials added in order in fp32, then b2, dps and
    the residual (lewin_block.py:928-940)."""
    dtype = x_img.dtype
    xf, xn = _layer_norm(x_img, lns, lnb, eps)
    xn = xn.to(dtype)
    acc = None
    for s in split_cols(w1.shape[1], kb):
        hdn = _gelu(torch.matmul(xn, w1[:, s].to(dtype)).float()
                    + b1[s].float())
        hdn = F.conv2d(hdn.permute(0, 3, 1, 2),
                       wd[..., s].float().permute(2, 0, 1)[:, None], padding=1,
                       groups=hdn.shape[-1])
        hdn = _gelu(hdn.permute(0, 2, 3, 1) + bd[s].float())
        part = torch.matmul(hdn.to(dtype), w2[s].to(dtype)).float()
        acc = part if acc is None else acc + part
    y = acc + b2.float()
    if dps is not None:
        y = y * dps.float()[:, None, None, None]
    return (xf + y).to(dtype)


def roll(img, shift: int):
    """The SW-MSA cyclic shift by ``-shift`` along H and W (0: the image)."""
    return torch.roll(img, (-shift, -shift), dims=(1, 2)) if shift else img


def merged_chain(attention, ffn, x_img, ln1s, ln1b, wq3, bq3, wk3, bk3, wv3,
                 bv3, wp3, bp, bias, mask, lam, ln2s, ln2b, w1, b1, wd, bd,
                 w2, b2, win: int = 8, shift: int = 0, eps: float = 1e-6,
                 dps1=None, dps2=None):
    """The function :func:`block_merged` computes, as a chain of its two
    halves (``attention``: :func:`block_attention` or its twin, ``ffn``
    likewise) around the roll; ``u`` between them in the model dtype."""
    u = attention(roll(x_img, shift), ln1s, ln1b, wq3, bq3, wk3, bk3, wv3,
                  bv3, wp3, bp, bias, mask, lam, win, eps, dps1)
    return ffn(roll(u, -shift), ln2s, ln2b, w1, b1, wd, bd, w2, b2, eps, dps2)


def freq_merged_chain(intra, inter, ffn, x_img, ln1s, ln1b, wq3A, bq3A, wk3A,
                      bk3A, wv3A, bv3A, wp3A, bpA, biasA, wq3B, bq3B, wk3B,
                      bk3B, wv3B, bv3B, wp3B, bpB, biasB, mask, ln2s, ln2b,
                      w1, b1, wd, bd, w2, b2, L: int = 1, win: int = 8,
                      shift: int = 0, eps: float = 1e-6, dps1=None,
                      dps2=None):
    """The function :func:`block_freq_merged` computes, as a chain of its
    three parts around the roll; the inter part's residual is the rolled
    image."""
    img = roll(x_img, shift)
    y1 = intra(img, ln1s, ln1b, wq3A, bq3A, wk3A, bk3A, wv3A, bv3A, wp3A,
               bpA, biasA, mask, L, win, eps)
    u = inter(y1, img, wq3B, bq3B, wk3B, bk3B, wv3B, bv3B, wp3B, bpB, biasB,
              mask, L, win, eps, dps1)
    return ffn(roll(u, -shift), ln2s, ln2b, w1, b1, wd, bd, w2, b2, eps, dps2)


def block_merged_plain(*args, **kwargs):
    """Plain twin of :func:`block_merged`: the chain of the plain halves."""
    return merged_chain(block_attention_plain, block_ffn_plain, *args,
                        **kwargs)


def block_freq_merged_plain(*args, **kwargs):
    """Plain twin of :func:`block_freq_merged`: the chain of the plain
    parts."""
    return freq_merged_chain(freq_intra_plain, freq_inter_plain,
                             block_ffn_plain, *args, **kwargs)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIZES = {torch.float32: 4, torch.bfloat16: 2}


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(x: torch.Tensor, *others: Optional[torch.Tensor]) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernels take float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("kernel input must be contiguous")
    for t in others:
        if t is not None and t.device != x.device:
            raise ValueError(f"tensor on {t.device}, input on {x.device}")


def _f32(t: Optional[torch.Tensor], shape) -> Optional[torch.Tensor]:
    if t is None:
        return None
    t = t.float().contiguous()
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"expected shape {tuple(shape)}, got {tuple(t.shape)}")
    return t


def kpad(k: int) -> int:
    """The kernels' padded reduction width (csrc/gemm.cuh ``kpad``)."""
    return (k + 31) // 32 * 32


def _nk(w: torch.Tensor, dtype) -> torch.Tensor:
    """An [N, K] GEMM operand in ``dtype``, K zero-padded to kpad(K)."""
    return F.pad(w.to(dtype), (0, kpad(w.shape[1]) - w.shape[1])).contiguous()


class AttnOperands(NamedTuple):
    """The weights of K1 / K3 in the kernels' formats (:func:`attn_operands`)."""
    heads: int
    wqkv: torch.Tensor   # [3C, kpad(C)] compute dtype, attention scale in q
    bqkv: torch.Tensor   # [3C] fp32, scale in q
    wp: torch.Tensor     # [C, kpad(C)] compute dtype
    bp: torch.Tensor     # [C] fp32
    bias: torch.Tensor   # fp32 [h, n, n], [L, h, n, n] or [h, L*n, L*n]
    # K3 (required there, None for K1): the per-pair tables
    # [L*L, (2 win - 1)^2, h] fp32 that ``bias`` was made from
    # (:func:`inter_bias`), which the fused K3 reads instead of it
    pairs: Optional[torch.Tensor] = None


def attn_operands(wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp, bias,
                  dtype, pairs=None) -> AttnOperands:
    """Per-head weights (``wq3 [h, C, d]``, ``wp3 [h, d, C]``) -> the N x K
    operands of the qkv and proj GEMMs, the scale d^-0.5 folded into q;
    ``pairs``, K3's per-pair tables, as they are (fp32)."""
    h, C, d = wq3.shape
    scale = d ** -0.5
    to_nk = lambda w3: w3.permute(0, 2, 1).reshape(h * d, C)
    wqkv = torch.cat([to_nk(wq3) * scale, to_nk(wk3), to_nk(wv3)], 0)
    bqkv = torch.cat([bq3.reshape(-1) * scale, bk3.reshape(-1),
                      bv3.reshape(-1)])
    return AttnOperands(h, _nk(wqkv, dtype), bqkv.float().contiguous(),
                        _nk(wp3.reshape(C, C).t(), dtype),
                        bp.float().contiguous(), bias.float().contiguous(),
                        None if pairs is None else pairs.float().contiguous())


class FfnOperands(NamedTuple):
    """The weights of K2 in the kernel's formats (:func:`ffn_operands`)."""
    w1: torch.Tensor     # [Hd, kpad(C)] compute dtype
    b1: torch.Tensor     # [Hd] fp32
    wd: torch.Tensor     # [3, 3, Hd] fp32
    bd: torch.Tensor     # [Hd] fp32
    w2: torch.Tensor     # [C, kpad(Hd)] compute dtype
    b2: torch.Tensor     # [C] fp32


def ffn_operands(w1, b1, wd, bd, w2, b2, dtype) -> FfnOperands:
    """``w1 [C, Hd]``, ``wd [3, 3, Hd]``, ``w2 [Hd, C]`` -> K2's operands."""
    f32 = lambda t: t.float().contiguous()
    return FfnOperands(_nk(w1.t(), dtype), f32(b1), f32(wd), f32(bd),
                       _nk(w2.t(), dtype), f32(b2))


def _operand(t: torch.Tensor, shape, dtype, x: torch.Tensor) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != x.device or not t.is_contiguous()):
        raise ValueError(f"operand {tuple(t.shape)} {t.dtype} on {t.device}: "
                         f"expected contiguous {tuple(shape)} {dtype} on "
                         f"{x.device}")


def _check_attn_operands(op: AttnOperands, x: torch.Tensor, bias_shape):
    C = x.shape[-1]
    for t, shape, dt in ((op.wqkv, (3 * C, kpad(C)), x.dtype),
                         (op.bqkv, (3 * C,), torch.float32),
                         (op.wp, (C, kpad(C)), x.dtype),
                         (op.bp, (C,), torch.float32),
                         (op.bias, bias_shape, torch.float32)):
        _operand(t, shape, dt, x)


def _run(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch(name: str, impl, *args):
    """Run a launch ``impl`` (one of the forward launches below, each the
    implementation of the custom op ``fairm::<name>``): through the op while
    ``torch.export`` traces the caller, so that the exported program holds
    the launch as one node (``custom_ops.py``); else directly."""
    if torch.compiler.is_exporting():
        from . import custom_ops  # noqa: F401  registers the fairm:: ops
        return getattr(torch.ops.fairm, name)(*args)
    return impl(*args)


def attention_path(C: int, heads: int, win: int, dtype) -> str:
    """How K1 (and the attention half of K4) runs a block of width ``C``:
    ``'fused'``, one launch with the half's rows on the SM
    (``csrc/attn_fused.cuh``: bf16, 8 x 8 windows, C a multiple of 4 and of
    the heads, kpad(C) <= 224, head dims <= 64), else ``'passes'`` (LN1 +
    gather, the qkv product, the attention core, the projection)."""
    d = C // heads if heads > 0 and C % heads == 0 else 0
    if (dtype == torch.bfloat16 and win == 8 and C % 4 == 0
            and kpad(C) <= 224 and 0 < d <= 64):
        return "fused"
    return "passes"


def attention_kernel(x_img, lns, lnb, op: AttnOperands, mask, lam, win: int,
                     eps: float, res: bool, bias_groups: int, dps):
    """Launch K1 on ``x_img [B, H, W, C]`` (CUDA) with prepared operands:
    :func:`block_attention` for ``res=True, bias_groups=1``,
    :func:`freq_intra` for ``res=False, bias_groups=L``; by
    :func:`attention_path`."""
    B, H, W, C = x_img.shape
    h = op.heads
    n = win * win
    nW = (H // win) * (W // win)
    _check(x_img, lns, mask, lam, dps)
    if H % win or W % win or C % h or B % bias_groups:
        raise ValueError(f"unsupported shape {tuple(x_img.shape)}, h={h}, "
                         f"win={win}, bias_groups={bias_groups}")
    _check_attn_operands(op, x_img, (bias_groups, h, n, n)
                         if bias_groups > 1 else (h, n, n))
    mask = _f32(mask, (nW, n, n))
    lam = _f32(lam, (B, h))
    dps = _f32(dps, (B,))
    lns, lnb = _f32(lns, (C,)), _f32(lnb, (C,))
    fused = attention_path(C, h, win, x_img.dtype) == "fused"
    return _launch("lewin_attn", launch_attn, x_img, lns, lnb, op.wqkv,
                   op.bqkv, op.wp, op.bp, op.bias, mask, lam, dps, h, win,
                   bias_groups, res, fused, float(eps))


def launch_attn(x: Tensor, lns: Tensor, lnb: Tensor, wqkv: Tensor,
                bqkv: Tensor, wp: Tensor, bp: Tensor, bias: Tensor,
                mask: Optional[Tensor], lam: Optional[Tensor],
                dps: Optional[Tensor], heads: int, win: int, groups: int,
                res: bool, fused: bool, eps: float) -> Tensor:
    """K1's launch on checked operands (:func:`attention_kernel`)."""
    from .build import load

    B, H, W, C = x.shape
    dt = x.dtype
    xo = qkv = None
    if not fused:
        # the passes' buffers: the LN'd windows, then the attention rows;
        # the qkv rows
        xo = torch.empty((B * H * W, kpad(C)), dtype=dt, device=x.device)
        qkv = torch.empty((B * H * W, 3 * C), dtype=dt, device=x.device)
    out = torch.empty_like(x)
    # every tensor handed over by address is bound to a name until the
    # launch: a temporary freed earlier could be reused by the next one
    _run(load().fairm_lewin_attn, _ptr(x), _ptr(lns), _ptr(lnb), _ptr(wqkv),
         _ptr(bqkv), _ptr(wp), _ptr(bp), _ptr(bias), _ptr(mask), _ptr(lam),
         _ptr(dps), _ptr(xo), _ptr(qkv), _ptr(out), B, H, W, C, heads, win,
         groups, int(res), _DTYPES[dt], int(fused), eps, _stream(x))
    LAUNCHES["lewin_attn"] += 1
    return out


# The fused K3's least launch in 192-token groups, by kpad(C), where it
# does not take every launch. At res 32, C = 112 on an H100 (device ms,
# fused against passes; tools/bwd_kernel_profile.py --k3, PERF.md section
# 6): 64 groups (B = 4) 0.1094 against 0.0971, 128 groups (B = 8) 0.1089
# against 0.1914, 256 (B = 16) 0.2197 against 0.3150, 512 (B = 32) 0.4443
# against 0.6167. Launches between 64 and 128 groups were not timed and
# keep the passes.
FREQ_INTER_MIN_GROUPS = {128: 128}


def freq_inter_path(C: int, heads: int, win: int, dtype, L: int = 3,
                    groups: Optional[int] = None) -> str:
    """How K3 runs a block of width ``C`` on ``groups`` 192-token groups
    (None: any): ``'fused'``, one launch with each group's rows on the SM
    (``csrc/freq_inter.cu``: bf16, L = 3 bands of 8 x 8 windows, C a
    multiple of 4 and of the heads, head dims <= 32, kpad(C) <= 128: the
    encoder's res 128 / 64 / 32 stages, at res 32 from
    FREQ_INTER_MIN_GROUPS groups), else ``'passes'`` (the band regroup, the
    qkv product, the attention core, the projection with the scatter
    back)."""
    d = C // heads if heads > 0 and C % heads == 0 else 0
    if not (dtype == torch.bfloat16 and win == 8 and L == 3 and C % 4 == 0
            and kpad(C) <= 128 and 0 < d <= 32):
        return "passes"
    least = FREQ_INTER_MIN_GROUPS.get(kpad(C), 0)
    return "fused" if groups is None or groups >= least else "passes"


def freq_inter_kernel(y_img, res_img, op: AttnOperands, mask, L: int,
                      win: int, dps, path: Optional[str] = None):
    """Launch K3 (:func:`freq_inter`) on CUDA tensors with prepared
    operands, by :func:`freq_inter_path` (``path`` names the form instead:
    the two are compared by ``chip_smoke.py``). The operands carry the
    per-pair tables ``op.pairs`` beside the grouped bias: the fused form
    reads the tables, the passes the bias."""
    LB, H, W, C = y_img.shape
    h = op.heads
    n = win * win
    nW = (H // win) * (W // win)
    _check(y_img, res_img, mask, dps)
    if (res_img.shape != y_img.shape or res_img.dtype != y_img.dtype
            or not res_img.is_contiguous()):
        raise ValueError("res_img must match y_img in shape, dtype, layout")
    if H % win or W % win or C % h or LB % L:
        raise ValueError(f"unsupported shape {tuple(y_img.shape)}, h={h}, L={L}")
    _check_attn_operands(op, y_img, (h, L * n, L * n))
    if op.pairs is None:
        raise ValueError("K3's operands carry the per-pair tables: "
                         "attn_operands(..., pairs)")
    _operand(op.pairs, (L * L, (2 * win - 1) ** 2, h), torch.float32, y_img)
    mask = _f32(mask, (nW, n, n))
    dps = _f32(dps, (LB,))
    groups = LB // L * nW
    fused = (path or freq_inter_path(C, h, win, y_img.dtype, L,
                                     groups)) == "fused"
    return _launch("freq_inter", launch_freq_inter, y_img, res_img, op.wqkv,
                   op.bqkv, op.wp, op.bp, op.bias, op.pairs, mask, dps, h,
                   win, L, fused)


def launch_freq_inter(y: Tensor, res: Tensor, wqkv: Tensor, bqkv: Tensor,
                      wp: Tensor, bp: Tensor, bias: Tensor, pairs: Tensor,
                      mask: Optional[Tensor], dps: Optional[Tensor],
                      heads: int, win: int, L: int, fused: bool) -> Tensor:
    """K3's launch on checked operands (:func:`freq_inter_kernel`)."""
    from .build import load

    LB, H, W, C = y.shape
    dt = y.dtype
    zo = qkv = None
    if not fused:
        # the passes' buffers: the regrouped rows, then the attention rows;
        # the qkv rows
        zo = torch.empty((LB * H * W, kpad(C)), dtype=dt, device=y.device)
        qkv = torch.empty((LB * H * W, 3 * C), dtype=dt, device=y.device)
    out = torch.empty_like(y)
    _run(load().fairm_freq_inter, _ptr(y), _ptr(res), _ptr(wqkv), _ptr(bqkv),
         _ptr(wp), _ptr(bp), _ptr(bias), _ptr(pairs), _ptr(mask), _ptr(dps),
         _ptr(zo), _ptr(qkv), _ptr(out), LB, H, W, C, heads, win, L,
         _DTYPES[dt], int(fused), _stream(y))
    LAUNCHES["freq_inter"] += 1
    return out


def _check_ffn_operands(op: FfnOperands, x: torch.Tensor) -> int:
    C = x.shape[-1]
    Hd = op.b1.shape[0]
    for t, shape, dt in ((op.w1, (Hd, kpad(C)), x.dtype),
                         (op.b1, (Hd,), torch.float32),
                         (op.wd, (3, 3, Hd), torch.float32),
                         (op.bd, (Hd,), torch.float32),
                         (op.w2, (C, kpad(Hd)), x.dtype),
                         (op.b2, (C,), torch.float32)):
        _operand(t, shape, dt, x)
    return Hd


def ffn_kernel(x_img, lns, lnb, op: FfnOperands, eps: float, dps):
    """Launch K2 (:func:`block_ffn`) on a CUDA tensor with prepared operands."""
    B, H, W, C = x_img.shape
    _check(x_img, lns, dps)
    _check_ffn_operands(op, x_img)
    lns, lnb = _f32(lns, (C,)), _f32(lnb, (C,))
    dps = _f32(dps, (B,))
    return _launch("lewin_ffn", launch_ffn, x_img, lns, lnb, *op, dps,
                   float(eps))


def launch_ffn(x: Tensor, lns: Tensor, lnb: Tensor, w1: Tensor, b1: Tensor,
               wd: Tensor, bd: Tensor, w2: Tensor, b2: Tensor,
               dps: Optional[Tensor], eps: float) -> Tensor:
    """K2's launch on checked operands (:func:`ffn_kernel`)."""
    from .build import load

    B, H, W, C = x.shape
    Hd = b1.shape[0]
    dt = x.dtype
    M = B * H * W
    lib = load()
    xn = hid1 = hid2 = None
    if not lib.fairm_lewin_ffn_fused(C, _DTYPES[dt]):
        # the four passes' LN2 rows and hidden tensors: fc1's output in fp32,
        # the conv's in the model dtype (the fused kernel keeps its hidden
        # rows on the SM)
        xn = torch.empty((M, kpad(C)), dtype=dt, device=x.device)
        hid1 = torch.empty((M, Hd), dtype=torch.float32, device=x.device)
        hid2 = torch.empty((M, kpad(Hd)), dtype=dt, device=x.device)
    out = torch.empty_like(x)
    _run(lib.fairm_lewin_ffn, _ptr(x), _ptr(lns), _ptr(lnb), _ptr(w1),
         _ptr(b1), _ptr(wd), _ptr(bd), _ptr(w2), _ptr(b2), _ptr(dps),
         _ptr(xn), _ptr(hid1), _ptr(hid2), _ptr(out), B, H, W, C, Hd,
         _DTYPES[dt], eps, _stream(x))
    LAUNCHES["lewin_ffn"] += 1
    return out


# the H100's SMs: the split kernels cut a reduction until its product puts
# at least one CTA on each
SMS = 132


def split_parts(rows: int, cols: int, k: int, dtype) -> int:
    """How many parts a split product cuts its reduction into (K12's
    projection, K13's fc2): the fewest of 1, 2, 4, 8 that gives the ``rows x
    cols`` output at least one CTA per SM, as long as the part divides the
    k-tiles and keeps at least 4 of them. fp32 tiles are csrc/split.cuh's
    FMA core's, 64 x 112 (128 x 112 where those alone fill the card); bf16
    tiles are the TMA / wgmma tile's 128 x 128, and a part is whole 64-column
    k-tiles, so that the parts run in one launch."""
    if dtype == torch.float32:
        tn = -(-cols // 112)
        bm, step = (128 if -(-rows // 128) * tn >= SMS else 64), 1
    else:
        tn = -(-cols // 128)
        bm, step = 128, 2
    ctas = -(-rows // bm) * tn
    kt = kpad(k) // 32
    kb = 1
    while ctas * kb < SMS and kb < 8 and kt % (2 * kb * step) == 0 \
            and kt // (2 * kb) >= 4:
        kb *= 2
    return kb


def attn_split_path(C: int, heads: int, win: int) -> str:
    """How K12 runs a block of width ``C``: ``'fused'``, a launch of a block
    per (window, head) that keeps the head's q / k / v on the SM from the
    product through the core (8 x 8 windows, head dims up to 64: every
    C = 896 stage), else ``'passes'`` (the qkv rows in device memory,
    attention.cuh's core); csrc/lewin_attn_split.cu."""
    d = C // heads if heads > 0 and C % heads == 0 else 0
    return "fused" if win == 8 and 0 < d <= 64 else "passes"


def attention_split_kernel(x_img, lns, lnb, op: AttnOperands, mask, lam,
                           win: int, eps: float, dps, kb: Optional[int] = None,
                           shift: int = 0):
    """Launch K12 (:func:`block_attention_split`) on ``x_img [B, H, W, C]``
    (CUDA) with K1's operands; ``kb`` parts of the projection's reduction,
    by default :func:`split_parts`; by :func:`attn_split_path`. With
    ``shift`` the image is in its true layout and the kernel reads and
    writes it through the SW-MSA roll by ``-shift``: the result is
    ``roll(block_attention_split(roll(x, -shift)), shift)``."""
    B, H, W, C = x_img.shape
    h = op.heads
    n = win * win
    nW = (H // win) * (W // win)
    _check(x_img, lns, mask, lam, dps)
    if H % win or W % win or C % h or not 0 <= shift < win:
        raise ValueError(f"unsupported shape {tuple(x_img.shape)}, h={h}, "
                         f"win={win}, shift={shift}")
    _check_attn_operands(op, x_img, (h, n, n))
    dt = x_img.dtype
    kb = split_parts(B * H * W, C, C, dt) if kb is None else kb
    split_cols(C, kb, dt)
    mask = _f32(mask, (nW, n, n))
    lam = _f32(lam, (B, h))
    dps = _f32(dps, (B,))
    lns, lnb = _f32(lns, (C,)), _f32(lnb, (C,))
    fused = attn_split_path(C, h, win) == "fused"
    return _launch("lewin_attn_split", launch_attn_split, x_img, lns, lnb,
                   op.wqkv, op.bqkv, op.wp, op.bp, op.bias, mask, lam, dps,
                   h, win, shift, kb, fused, float(eps))


def launch_attn_split(x: Tensor, lns: Tensor, lnb: Tensor, wqkv: Tensor,
                      bqkv: Tensor, wp: Tensor, bp: Tensor, bias: Tensor,
                      mask: Optional[Tensor], lam: Optional[Tensor],
                      dps: Optional[Tensor], heads: int, win: int, shift: int,
                      kb: int, fused: bool, eps: float) -> Tensor:
    """K12's launch on checked operands (:func:`attention_split_kernel`)."""
    from .build import load

    B, H, W, C = x.shape
    M = B * H * W
    dt = x.dtype
    dev = x.device
    # the LN'd windows; the passes' qkv rows, the fused form's attention
    # rows; the projection's fp32 parts
    xo = torch.empty((M, kpad(C)), dtype=dt, device=dev)
    qkv = None if fused else torch.empty((M, 3 * C), dtype=dt, device=dev)
    ao = torch.empty((M, kpad(C)), dtype=dt, device=dev) if fused else None
    parts = (torch.empty((kb, M, C), dtype=torch.float32, device=dev)
             if kb > 1 else None)
    out = torch.empty_like(x)
    _run(load().fairm_lewin_attn_split, _ptr(x), _ptr(lns), _ptr(lnb),
         _ptr(wqkv), _ptr(bqkv), _ptr(wp), _ptr(bp), _ptr(bias), _ptr(mask),
         _ptr(lam), _ptr(dps), _ptr(xo), _ptr(qkv), _ptr(ao), _ptr(parts),
         _ptr(out), B, H, W, C, heads, win, shift, kb, _DTYPES[dt],
         int(fused), eps, _stream(x))
    LAUNCHES["lewin_attn_split"] += 1
    return out


def ffn_split_kernel(x_img, lns, lnb, op: FfnOperands, eps: float, dps,
                     kb: Optional[int] = None):
    """Launch K13 (:func:`block_ffn_split`) on a CUDA tensor with K2's
    operands; ``kb`` hidden blocks, by default :func:`split_parts` of
    fc2."""
    B, H, W, C = x_img.shape
    _check(x_img, lns, dps)
    Hd = _check_ffn_operands(op, x_img)
    dt = x_img.dtype
    kb = split_parts(B * H * W, C, Hd, dt) if kb is None else kb
    split_cols(Hd, kb, dt)
    lns, lnb = _f32(lns, (C,)), _f32(lnb, (C,))
    dps = _f32(dps, (B,))
    return _launch("lewin_ffn_split", launch_ffn_split, x_img, lns, lnb, *op,
                   dps, kb, float(eps))


def launch_ffn_split(x: Tensor, lns: Tensor, lnb: Tensor, w1: Tensor,
                     b1: Tensor, wd: Tensor, bd: Tensor, w2: Tensor,
                     b2: Tensor, dps: Optional[Tensor], kb: int,
                     eps: float) -> Tensor:
    """K13's launch on checked operands (:func:`ffn_split_kernel`)."""
    from .build import load

    B, H, W, C = x.shape
    Hd = b1.shape[0]
    M = B * H * W
    dt = x.dtype
    dev = x.device
    xn = torch.empty((M, kpad(C)), dtype=dt, device=dev)
    # fc1's output in fp32, the conv's in the model dtype; fc2's parts
    hid1 = torch.empty((M, Hd), dtype=torch.float32, device=dev)
    hid2 = torch.empty((M, kpad(Hd)), dtype=dt, device=dev)
    parts = (torch.empty((kb, M, C), dtype=torch.float32, device=dev)
             if kb > 1 else None)
    out = torch.empty_like(x)
    _run(load().fairm_lewin_ffn_split, _ptr(x), _ptr(lns), _ptr(lnb),
         _ptr(w1), _ptr(b1), _ptr(wd), _ptr(bd), _ptr(w2), _ptr(b2),
         _ptr(dps), _ptr(xn), _ptr(hid1), _ptr(hid2), _ptr(parts), _ptr(out),
         B, H, W, C, Hd, kb, _DTYPES[dt], eps, _stream(x))
    LAUNCHES["lewin_ffn_split"] += 1
    return out


def _merged_scratch_cols(C: int, Hd: int, freq: bool, fused: bool,
                         dtype, group: bool = False) -> int:
    """Columns per pixel, in elements of ``dtype``, of the merged kernels'
    working buffer: u alone for K5's band-group form (``group``,
    csrc/freq_merged.cu); else (csrc/merged.cuh) the LN'd / attention rows
    and qkv (not with the fused attention half), the intra output (K5), u,
    the hidden after fc1 in fp32 and the conv's output."""
    if group:
        return C
    ffn = C + Hd * 4 // _SIZES[dtype] + kpad(Hd)
    return ffn if fused else kpad(C) + 3 * C + (C if freq else 0) + ffn


def _merged_scratch(x_img, Hd: int, freq: bool, fused: bool,
                    group: bool = False) -> torch.Tensor:
    B, H, W, C = x_img.shape
    cols = _merged_scratch_cols(C, Hd, freq, fused, x_img.dtype, group)
    return torch.empty(B * H * W * cols, dtype=x_img.dtype,
                       device=x_img.device)


def _scratch_rows(scratch, x_img, at: int) -> torch.Tensor:
    """A copy of the ``x_img``-shaped rows at element ``at`` of a merged
    kernel's scratch buffer."""
    return scratch[at:at + x_img.numel()].reshape(x_img.shape).clone()


# the merged kernels' phases, in order: slot i + 1 of a ``stamps`` tensor
# holds the device clock (ns) at the end of phase i, slot 0 the start
MERGED_PHASES = ("LN1 + window gather", "qkv product", "attention core",
                 "projection + scatter", "LN2", "fc1 + GELU",
                 "depthwise conv + GELU", "fc2 + residual")
FREQ_MERGED_PHASES = (MERGED_PHASES[:3]
                      + ("intra projection", "band regroup",
                         "inter qkv product", "inter attention core",
                         "inter projection + scatter") + MERGED_PHASES[4:])
# K4 with the fused attention half (attention_path 'fused')
MERGED_FUSED_PHASES = ("attention half",) + MERGED_PHASES[4:]
# K5's band-group form (freq_merged_path 'group')
FREQ_GROUP_PHASES = ("band groups: LN1, intra, inter", "LeFF tiles")
MERGED_STAMPS = 16


def merged_phases(C: int, heads: int, win: int, dtype) -> tuple:
    """K4's phases for a block of width ``C`` (:func:`attention_path`)."""
    return (MERGED_FUSED_PHASES
            if attention_path(C, heads, win, dtype) == "fused"
            else MERGED_PHASES)


def freq_merged_path(C: int, heads: int, win: int, dtype, L: int = 3) -> str:
    """How K5 runs a block of width ``C``: ``'group'``, one cooperative
    launch of two phases built from the chain's fused bodies (band groups of
    192 rows on the SM: LN1, the intra and the inter half; then the LeFF
    on 8 x 8 tiles; ``csrc/freq_merged.cu``: bf16, L = 3 bands of 8 x 8
    windows, C a multiple of 4 and of the heads, head dims <= 32,
    kpad(C) <= 128: the encoder's res 128 / 64 / 32 stages), else
    ``'phases'`` (``csrc/merged.cuh``: twelve phases over the whole batch,
    the intermediates in a scratch buffer)."""
    d = C // heads if heads > 0 and C % heads == 0 else 0
    if (dtype == torch.bfloat16 and win == 8 and L == 3 and C % 4 == 0
            and kpad(C) <= 128 and 0 < d <= 32):
        return "group"
    return "phases"


def freq_merged_phases(C: int, heads: int, win: int, dtype, L: int = 3,
                       path: Optional[str] = None) -> tuple:
    """K5's phases for a block of width ``C`` by ``path`` (None:
    :func:`freq_merged_path`)."""
    path = path or freq_merged_path(C, heads, win, dtype, L)
    return FREQ_GROUP_PHASES if path == "group" else FREQ_MERGED_PHASES


def _stamps(stamps, x: torch.Tensor) -> None:
    if stamps is not None and (
            stamps.dtype != torch.int64 or stamps.device != x.device
            or stamps.numel() < MERGED_STAMPS or not stamps.is_contiguous()):
        raise ValueError(f"stamps: a contiguous int64 tensor of "
                         f"{MERGED_STAMPS} on {x.device}")


def merged_kernel(x_img, ln1s, ln1b, attn: AttnOperands, mask, lam, ln2s,
                  ln2b, ffn: FfnOperands, win: int, shift: int, eps: float,
                  dps1, dps2, stamps=None, scratch_out=None):
    """Launch K4 (:func:`block_merged`) on the TRUE-layout ``x_img
    [B, H, W, C]`` (CUDA) with the operands of both halves: one launch.
    ``stamps``, an int64 tensor of :data:`MERGED_STAMPS`, receives the
    device clock at the start and after each of :func:`merged_phases`.
    ``scratch_out``, a list, receives ``(u, None)``: a copy of u."""
    B, H, W, C = x_img.shape
    h = attn.heads
    n = win * win
    nW = (H // win) * (W // win)
    _check(x_img, ln1s, ln2s, mask, lam, dps1, dps2)
    if H % win or W % win or C % h or not 0 <= shift < win:
        raise ValueError(f"unsupported shape {tuple(x_img.shape)}, h={h}, "
                         f"win={win}, shift={shift}")
    _check_attn_operands(attn, x_img, (h, n, n))
    _check_ffn_operands(ffn, x_img)
    _stamps(stamps, x_img)
    mask = _f32(mask, (nW, n, n))
    lam = _f32(lam, (B, h))
    dps1, dps2 = _f32(dps1, (B,)), _f32(dps2, (B,))
    ln1s, ln1b = _f32(ln1s, (C,)), _f32(ln1b, (C,))
    ln2s, ln2b = _f32(ln2s, (C,)), _f32(ln2b, (C,))
    fused = attention_path(C, h, win, x_img.dtype) == "fused"
    args = (x_img, ln1s, ln1b, attn.wqkv, attn.bqkv, attn.wp, attn.bp,
            attn.bias, mask, lam, dps1, ln2s, ln2b, *ffn, dps2, h, win, shift,
            fused, float(eps))
    if stamps is None and scratch_out is None:
        return _launch("lewin_merged", launch_merged, *args)
    out, scratch = _launch_merged(*args, stamps)
    if scratch_out is not None:
        # u, the attention half's output (the first rows with the fused
        # half); no y1
        M = B * H * W
        scratch_out.append((_scratch_rows(
            scratch, x_img, 0 if fused else M * (kpad(C) + 3 * C)), None))
    return out


def _launch_merged(x, ln1s, ln1b, wqkv, bqkv, wp, bp, bias, mask, lam, dps1,
                   ln2s, ln2b, w1, b1, wd, bd, w2, b2, dps2, heads: int,
                   win: int, shift: int, fused: bool, eps: float, stamps):
    """K4's launch: ``(out, its scratch buffer)``."""
    from .build import load

    B, H, W, C = x.shape
    Hd = b1.shape[0]
    # bound to names until the launch returns, the scratch included
    scratch = _merged_scratch(x, Hd, False, fused)
    out = torch.empty_like(x)
    _run(load().fairm_lewin_merged, _ptr(x), _ptr(ln1s), _ptr(ln1b),
         _ptr(wqkv), _ptr(bqkv), _ptr(wp), _ptr(bp), _ptr(bias), _ptr(mask),
         _ptr(lam), _ptr(dps1), _ptr(ln2s), _ptr(ln2b), _ptr(w1), _ptr(b1),
         _ptr(wd), _ptr(bd), _ptr(w2), _ptr(b2), _ptr(dps2), _ptr(scratch),
         _ptr(out), _ptr(stamps), scratch.numel(), B, H, W, C, heads, win,
         shift, Hd, _DTYPES[x.dtype], int(fused), eps, _stream(x))
    LAUNCHES["lewin_merged"] += 1
    return out, scratch


def launch_merged(x: Tensor, ln1s: Tensor, ln1b: Tensor, wqkv: Tensor,
                  bqkv: Tensor, wp: Tensor, bp: Tensor, bias: Tensor,
                  mask: Optional[Tensor], lam: Optional[Tensor],
                  dps1: Optional[Tensor], ln2s: Tensor, ln2b: Tensor,
                  w1: Tensor, b1: Tensor, wd: Tensor, bd: Tensor, w2: Tensor,
                  b2: Tensor, dps2: Optional[Tensor], heads: int, win: int,
                  shift: int, fused: bool, eps: float) -> Tensor:
    """K4's launch on checked operands (:func:`merged_kernel`)."""
    return _launch_merged(x, ln1s, ln1b, wqkv, bqkv, wp, bp, bias, mask, lam,
                          dps1, ln2s, ln2b, w1, b1, wd, bd, w2, b2, dps2,
                          heads, win, shift, fused, eps, None)[0]


def freq_merged_kernel(x_img, ln1s, ln1b, intra: AttnOperands,
                       inter: AttnOperands, mask, ln2s, ln2b,
                       ffn: FfnOperands, L: int, win: int, shift: int,
                       eps: float, dps1, dps2, stamps=None, scratch_out=None,
                       path: Optional[str] = None):
    """Launch K5 (:func:`block_freq_merged`) on the TRUE-layout band-major
    ``x_img [L*B, H, W, C]`` (CUDA) with the operands of the three parts:
    one launch, by :func:`freq_merged_path` (``path`` names the form
    instead: the two are compared by ``chip_smoke.py`` and the tests). The
    band-group form reads the inter half's bias from its per-pair tables
    (``inter.pairs``, required there), the phases the grouped bias.
    ``stamps`` as in :func:`merged_kernel`, for :func:`freq_merged_phases`.
    ``scratch_out``, a list, receives ``(u, y1)``: u in the true layout and
    the intra output y1 in the rolled one, which the band-group form then
    also writes to device memory (the backward reads them)."""
    LB, H, W, C = x_img.shape
    h = intra.heads
    n = win * win
    nW = (H // win) * (W // win)
    if (H % win or W % win or C % h or LB % L or inter.heads != h
            or not 0 <= shift < win):
        raise ValueError(f"unsupported shape {tuple(x_img.shape)}, h={h}, "
                         f"L={L}, win={win}, shift={shift}")
    _check_attn_operands(intra, x_img, (L, h, n, n) if L > 1 else (h, n, n))
    _check_attn_operands(inter, x_img, (h, L * n, L * n))
    _check_ffn_operands(ffn, x_img)
    path = path or freq_merged_path(C, h, win, x_img.dtype, L)
    if path not in ("group", "phases"):
        raise ValueError(f"path must be 'group' or 'phases', got {path!r}")
    group = path == "group"
    if group:
        if inter.pairs is None:
            raise ValueError("K5's band-group form reads the inter half's "
                             "per-pair tables: attn_operands(..., pairs)")
        _operand(inter.pairs, (L * L, (2 * win - 1) ** 2, h), torch.float32,
                 x_img)
    _check(x_img, ln1s, ln2s, mask, dps1, dps2)
    _stamps(stamps, x_img)
    mask = _f32(mask, (nW, n, n))
    dps1, dps2 = _f32(dps1, (LB,)), _f32(dps2, (LB,))
    ln1s, ln1b = _f32(ln1s, (C,)), _f32(ln1b, (C,))
    ln2s, ln2b = _f32(ln2s, (C,)), _f32(ln2b, (C,))
    args = (x_img, ln1s, ln1b, intra.wqkv, intra.bqkv, intra.wp, intra.bp,
            intra.bias, inter.wqkv, inter.bqkv, inter.wp, inter.bp,
            inter.bias, inter.pairs if group else None, mask, dps1, ln2s,
            ln2b, *ffn, dps2, h, win, shift, L, group, float(eps))
    if stamps is None and scratch_out is None:
        return _launch("freq_merged", launch_freq_merged, *args)
    out, scratch, y1 = _launch_freq_merged(*args, stamps,
                                           scratch_out is not None)
    if scratch_out is not None:
        if group:
            scratch_out.append((scratch.reshape(x_img.shape), y1))
        else:
            at = LB * H * W * (kpad(C) + 3 * C)
            scratch_out.append((_scratch_rows(scratch, x_img, at + x_img.numel()),
                                _scratch_rows(scratch, x_img, at)))
    return out


def _launch_freq_merged(x, ln1s, ln1b, wqkvA, bqkvA, wpA, bpA, biasA, wqkvB,
                        bqkvB, wpB, bpB, biasB, pairsB, mask, dps1, ln2s, ln2b,
                        w1, b1, wd, bd, w2, b2, dps2, heads: int, win: int,
                        shift: int, L: int, group: bool, eps: float, stamps,
                        want_y1: bool):
    """K5's launch: ``(out, its scratch buffer, y1 or None)``; the
    band-group form writes y1 where ``want_y1``."""
    from .build import load

    LB, H, W, C = x.shape
    Hd = b1.shape[0]
    # bound to names until the launch returns: the scratch (the band-group
    # form's is u), y1 where the caller asks for it
    scratch = _merged_scratch(x, Hd, True, False, group)
    y1 = torch.empty_like(x) if group and want_y1 else None
    out = torch.empty_like(x)
    _run(load().fairm_freq_merged, _ptr(x), _ptr(ln1s), _ptr(ln1b),
         _ptr(wqkvA), _ptr(bqkvA), _ptr(wpA), _ptr(bpA), _ptr(biasA),
         _ptr(wqkvB), _ptr(bqkvB), _ptr(wpB), _ptr(bpB), _ptr(biasB),
         _ptr(pairsB), _ptr(mask), _ptr(dps1), _ptr(ln2s), _ptr(ln2b),
         _ptr(w1), _ptr(b1), _ptr(wd), _ptr(bd), _ptr(w2), _ptr(b2),
         _ptr(dps2), _ptr(scratch), _ptr(y1), _ptr(out), _ptr(stamps),
         scratch.numel(), LB, H, W, C, heads, win, shift, L, Hd,
         _DTYPES[x.dtype], int(group), eps, _stream(x))
    LAUNCHES["freq_merged"] += 1
    return out, scratch, y1


def launch_freq_merged(x: Tensor, ln1s: Tensor, ln1b: Tensor, wqkvA: Tensor,
                       bqkvA: Tensor, wpA: Tensor, bpA: Tensor, biasA: Tensor,
                       wqkvB: Tensor, bqkvB: Tensor, wpB: Tensor, bpB: Tensor,
                       biasB: Tensor, pairsB: Optional[Tensor],
                       mask: Optional[Tensor], dps1: Optional[Tensor],
                       ln2s: Tensor, ln2b: Tensor, w1: Tensor, b1: Tensor,
                       wd: Tensor, bd: Tensor, w2: Tensor, b2: Tensor,
                       dps2: Optional[Tensor], heads: int, win: int,
                       shift: int, L: int, group: bool, eps: float) -> Tensor:
    """K5's launch on checked operands (:func:`freq_merged_kernel`)."""
    return _launch_freq_merged(x, ln1s, ln1b, wqkvA, bqkvA, wpA, bpA, biasA,
                               wqkvB, bqkvB, wpB, bpB, biasB, pairsB, mask,
                               dps1, ln2s, ln2b, w1, b1, wd, bd, w2, b2, dps2,
                               heads, win, shift, L, group, eps, None,
                               False)[0]


# ---------------------------------------------------------------------------
# entry points (the Pallas signatures): the plain twin on a CPU tensor, the
# kernel on a CUDA tensor
# ---------------------------------------------------------------------------


def _kernel_operands(x, make, *weights):
    _check(x, *weights)
    return make(*weights, x.dtype)


def _inter_operands(x, pairs, *weights) -> AttnOperands:
    """K3's / K5's inter operands, with the per-pair tables where given."""
    _check(x, pairs)
    return _kernel_operands(x, attn_operands, *weights)._replace(
        pairs=None if pairs is None else pairs.float().contiguous())


def block_attention(x_img, lns, lnb, wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp,
                    bias, mask, lam, win: int = 8, eps: float = 1e-6,
                    dps=None):
    """``x + dps * proj(win_attn(LN(x)))`` on a (pre-rolled) image.

    ``x_img [B, H, W, C]``; ``lns, lnb [C]``; ``wq3/wk3/wv3 [h, C, d]``,
    ``bq3/bk3/bv3 [h, d]``; ``wp3 [h, d, C]``, ``bp [C]``; ``bias [h, n, n]``;
    ``mask [nW, n, n]`` additive or None; ``lam [B, h]`` all_DC gain or None;
    ``dps [B]`` DropPath branch scale or None. Returns x's shape and dtype.
    """
    if x_img.device.type == "cpu":
        return block_attention_plain(x_img, lns, lnb, wq3, bq3, wk3, bk3,
                                     wv3, bv3, wp3, bp, bias, mask, lam, win,
                                     eps, dps)
    op = _kernel_operands(x_img, attn_operands, wq3, bq3, wk3, bk3, wv3, bv3,
                          wp3, bp, bias)
    return attention_kernel(x_img, lns, lnb, op, mask, lam, win, eps, True, 1,
                            dps)


def freq_intra(x_img, lns, lnb, wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp, biasA,
               mask, L: int, win: int = 8, eps: float = 1e-6):
    """``proj(win_attn_per_band(LN(x)))``, no residual, on the band-major
    folded batch ``x_img [L*B, H, W, C]`` with per-band bias tables
    ``biasA [L, h, n, n]`` (band of image b is ``b // B``). Exact for the
    reference's grouped -100 intra mask: e^-100 mass is below fp32."""
    if x_img.device.type == "cpu":
        return freq_intra_plain(x_img, lns, lnb, wq3, bq3, wk3, bk3, wv3,
                                bv3, wp3, bp, biasA, mask, L, win, eps)
    op = _kernel_operands(x_img, attn_operands, wq3, bq3, wk3, bk3, wv3, bv3,
                          wp3, bp, biasA)
    return attention_kernel(x_img, lns, lnb, op, mask, None, win, eps, False,
                            L, None)


def freq_inter(y_img, res_img, wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp, biasB,
               mask, L: int = 1, win: int = 8, eps: float = 1e-6, dps=None,
               pairs=None):
    """``res + dps * proj(grouped_attn(y))``: attention over each window's
    ``L*n`` band-grouped tokens with ``biasB [h, L*n, L*n]`` (the L x L
    bias tables with the 'inter' band mask folded in) and the SW-MSA mask
    tiled (L, L). ``dps [L*B]`` is indexed by the folded sample ``l*B + b``.
    ``eps`` is unused (no LayerNorm), kept for the Pallas signature.
    ``pairs``: the per-pair tables ``biasB`` was made from
    (:func:`inter_bias`), which K3 needs on a CUDA tensor (its fused form
    reads them in place of ``biasB``, bit for bit the same bias); the plain
    twin reads ``biasB`` only."""
    if y_img.device.type == "cpu":
        return freq_inter_plain(y_img, res_img, wq3, bq3, wk3, bk3, wv3, bv3,
                                wp3, bp, biasB, mask, L, win, eps, dps)
    if pairs is None:
        raise ValueError("K3 needs the per-pair tables biasB was made from")
    op = _inter_operands(y_img, pairs, wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp,
                         biasB)
    return freq_inter_kernel(y_img, res_img, op, mask, L, win, dps)


def block_ffn(x_img, lns, lnb, w1, b1, wd, bd, w2, b2, eps: float = 1e-6,
              dps=None):
    """``x + dps * linear2(gelu(dwconv3x3(gelu(linear1(LN(x))))))``.

    ``w1 [C, Hd]``, ``b1 [Hd]``, ``wd [3, 3, Hd]`` depthwise taps (zero
    padding at the image border), ``bd [Hd]``, ``w2 [Hd, C]``, ``b2 [C]``.
    """
    if x_img.device.type == "cpu":
        return block_ffn_plain(x_img, lns, lnb, w1, b1, wd, bd, w2, b2, eps,
                               dps)
    op = _kernel_operands(x_img, ffn_operands, w1, b1, wd, bd, w2, b2)
    return ffn_kernel(x_img, lns, lnb, op, eps, dps)


def block_attention_split(x_img, lns, lnb, wq3, bq3, wk3, bk3, wv3, bv3, wp3,
                          bp, bias, mask, lam, win: int = 8,
                          eps: float = 1e-6, dps=None,
                          kb: Optional[int] = None):
    """:func:`block_attention` with the q / k / v projections as three
    [C, C] blocks and the projection's reduction in ``kb`` fp32 partials
    (:func:`split_parts` by default): the plain twin on a CPU tensor, K12
    on a CUDA tensor."""
    if kb is None:
        B, H, W, C = x_img.shape
        kb = split_parts(B * H * W, C, C, x_img.dtype)
    if x_img.device.type == "cpu":
        return lewin_attn_split_plain(x_img, lns, lnb, wq3, bq3, wk3, bk3,
                                      wv3, bv3, wp3, bp, bias, mask, lam, win,
                                      eps, dps, kb)
    op = _kernel_operands(x_img, attn_operands, wq3, bq3, wk3, bk3, wv3, bv3,
                          wp3, bp, bias)
    return attention_split_kernel(x_img, lns, lnb, op, mask, lam, win, eps,
                                  dps, kb)


def block_ffn_split(x_img, lns, lnb, w1, b1, wd, bd, w2, b2,
                    eps: float = 1e-6, dps=None, kb: Optional[int] = None):
    """:func:`block_ffn` as a sum over ``kb`` hidden blocks
    (:func:`split_parts` by default), linear2's partials in fp32: the
    plain twin on a CPU tensor, K13 on a CUDA tensor."""
    if kb is None:
        B, H, W, C = x_img.shape
        kb = split_parts(B * H * W, C, w1.shape[1], x_img.dtype)
    if x_img.device.type == "cpu":
        return lewin_ffn_split_plain(x_img, lns, lnb, w1, b1, wd, bd, w2, b2,
                                     eps, dps, kb)
    op = _kernel_operands(x_img, ffn_operands, w1, b1, wd, bd, w2, b2)
    return ffn_split_kernel(x_img, lns, lnb, op, eps, dps, kb)


def block_merged(x_img, ln1s, ln1b, wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp,
                 bias, mask, lam, ln2s, ln2b, w1, b1, wd, bd, w2, b2,
                 win: int = 8, shift: int = 0, eps: float = 1e-6, dps1=None,
                 dps2=None):
    """One whole origin-MSA LeWin block on the TRUE-layout image:
    ``u = x + dps1 * unroll(proj(win_attn(LN1(roll(x)))))`` rounded to
    x's dtype, then ``out = u + dps2 * LeFF(LN2(u))``. ``shift`` is 0 or
    ``win // 2``; ``mask [nW, n, n]`` is indexed by the window of the
    ROLLED image. Arguments as :func:`block_attention` then
    :func:`block_ffn`. Equal to ``block_ffn(unroll(block_attention(roll
    (x))))`` in one launch, without the roll passes."""
    if x_img.device.type == "cpu":
        return block_merged_plain(x_img, ln1s, ln1b, wq3, bq3, wk3, bk3, wv3,
                                  bv3, wp3, bp, bias, mask, lam, ln2s, ln2b,
                                  w1, b1, wd, bd, w2, b2, win, shift, eps,
                                  dps1, dps2)
    attn = _kernel_operands(x_img, attn_operands, wq3, bq3, wk3, bk3, wv3,
                            bv3, wp3, bp, bias)
    ffn = _kernel_operands(x_img, ffn_operands, w1, b1, wd, bd, w2, b2)
    return merged_kernel(x_img, ln1s, ln1b, attn, mask, lam, ln2s, ln2b, ffn,
                         win, shift, eps, dps1, dps2)


def block_freq_merged(x_img, ln1s, ln1b, wq3A, bq3A, wk3A, bk3A, wv3A, bv3A,
                      wp3A, bpA, biasA, wq3B, bq3B, wk3B, bk3B, wv3B, bv3B,
                      wp3B, bpB, biasB, mask, ln2s, ln2b, w1, b1, wd, bd, w2,
                      b2, L: int = 1, win: int = 8, shift: int = 0,
                      eps: float = 1e-6, dps1=None, dps2=None, pairs=None):
    """One whole frequency-MSA LeWin block on the TRUE-layout band-major
    batch ``x_img [L*B, H, W, C]``: ``u = x + dps1 * unroll(inter(intra(
    LN1(roll(x)))))``, then ``out = u + dps2 * LeFF(LN2(u))``. The A
    weights and ``biasA [L, h, n, n]`` are :func:`freq_intra`'s, the B
    weights and ``biasB [h, L*n, L*n]`` :func:`freq_inter`'s; ``dps1``,
    ``dps2 [L*B]`` by the folded sample. Equal to the chain of the three
    entry points around ``torch.roll``, in one launch. ``pairs``: the
    per-pair tables ``biasB`` was made from, which K5's band-group form
    needs on a CUDA tensor (:func:`freq_merged_path`); the plain twin reads
    ``biasB`` only."""
    if x_img.device.type == "cpu":
        return block_freq_merged_plain(
            x_img, ln1s, ln1b, wq3A, bq3A, wk3A, bk3A, wv3A, bv3A, wp3A, bpA,
            biasA, wq3B, bq3B, wk3B, bk3B, wv3B, bv3B, wp3B, bpB, biasB, mask,
            ln2s, ln2b, w1, b1, wd, bd, w2, b2, L, win, shift, eps, dps1,
            dps2)
    intra = _kernel_operands(x_img, attn_operands, wq3A, bq3A, wk3A, bk3A,
                             wv3A, bv3A, wp3A, bpA, biasA)
    inter = _inter_operands(x_img, pairs, wq3B, bq3B, wk3B, bk3B, wv3B, bv3B,
                            wp3B, bpB, biasB)
    ffn = _kernel_operands(x_img, ffn_operands, w1, b1, wd, bd, w2, b2)
    return freq_merged_kernel(x_img, ln1s, ln1b, intra, inter, mask, ln2s,
                              ln2b, ffn, L, win, shift, eps, dps1, dps2)


# ---------------------------------------------------------------------------
# backward: plain twins
# ---------------------------------------------------------------------------
#
# Written out step by step as the Pallas backward bodies (JAX
# ``ops/pallas/lewin_block_bwd.py``) do it: the forward intermediates again,
# then the explicit gradient formulas, every product on operands rounded to
# the compute dtype with fp32 accumulation. ``torch.autograd.grad`` of the
# forward twins is the second reference, in the tests.


def _mm(a, b):
    """A product of operands already rounded to the compute dtype,
    accumulated in fp32 (the MXU / tensor-core contract)."""
    return torch.matmul(a.float(), b.float())


def _ln_stats(x_img, eps):
    xf = x_img.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    rsig = torch.rsqrt(var + eps)
    return (xf - mu) * rsig, rsig


def _ln_bwd(dxn, xhat, rsig, lns):
    """(dx, dlns, dlnb) of ``xn = xhat * lns + lnb``, all fp32."""
    C = dxn.shape[-1]
    dxhat = dxn * lns.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = rsig * (dxhat - m1 - xhat * m2)
    return dx, (dxn * xhat).reshape(-1, C).sum(0), dxn.reshape(-1, C).sum(0)


def _qkv_full(wq3, bq3, wk3, bk3, wv3, bv3, dtype):
    """``wqkv [C, 3C]`` in the compute dtype and ``bqkv [3C]`` fp32, q
    unscaled (the Pallas backward's operand layout)."""
    h, C, d = wq3.shape
    wqkv = torch.cat([w.permute(1, 0, 2).reshape(C, h * d)
                      for w in (wq3, wk3, wv3)], 1).to(dtype)
    bqkv = torch.cat([b.reshape(-1) for b in (bq3, bk3, bv3)]).float()
    return wqkv, bqkv


def _split_qkv_grads(dwqkv, dbqkv, h):
    """``dwqkv [C, 3C]``, ``dbqkv [3C]`` -> the per-head layouts
    ``(dwq3, dbq3, dwk3, dbk3, dwv3, dbv3)``."""
    C = dwqkv.shape[0]
    d = C // h
    to3 = lambda w: w.reshape(C, h, d).permute(1, 0, 2)
    out = []
    for i in range(3):
        out += [to3(dwqkv[:, i * C:(i + 1) * C]),
                dbqkv[i * C:(i + 1) * C].reshape(h, d)]
    return tuple(out)


def _attn_core_bwd(qkv, dout, bias, mask_full, lam_w, groups, h, dtype):
    """The per-window, per-head part of the attention backward. ``qkv
    [M, n, 3C]`` in the compute dtype, ``dout [M, n, C]`` fp32, ``bias
    [groups, h, n, n]``, ``mask_full [M, 1, n, n]`` or None, ``lam_w
    [M, h, 1, 1]`` or None. Returns ``(out_all [M, n, C], dqkv [M, n, 3C])``
    in the compute dtype, ``dbias [groups, h, n, n]`` and ``c_lam [M, h]``
    (None without lam)."""
    M, n, C3 = qkv.shape
    C = C3 // 3
    d = C // h
    scale = d ** -0.5
    heads = lambda t: t.reshape(M, n, h, d).permute(0, 2, 1, 3)
    q, k, v = (heads(qkv[..., i * C:(i + 1) * C]) for i in range(3))
    logits = _mm(q, k.transpose(-1, -2)) * scale
    logits = (logits.reshape(groups, M // groups, h, n, n)
              + bias.float().reshape(groups, 1, h, n, n)).reshape(M, h, n, n)
    if mask_full is not None:
        logits = logits + mask_full
    logits = logits - logits.amax(-1, keepdim=True)
    e = torch.exp(logits)
    p = e / e.sum(-1, keepdim=True)
    og = _mm(p.to(dtype), v)
    do = heads(dout)
    c_lam = None
    if lam_w is not None:
        vs = v.float().sum(2, keepdim=True)
        out_h = (1.0 + lam_w) * og - (lam_w / n) * vs
        c_lam = (do * (og - vs / n)).sum((2, 3))
        dog = (1.0 + lam_w) * do
        dv_extra = do.sum(2, keepdim=True) * (-lam_w / n)
    else:
        out_h, dog, dv_extra = og, do, None
    dog_dt = dog.to(dtype)
    dp = _mm(dog_dt, v.transpose(-1, -2))
    dv = _mm(p.to(dtype).transpose(-1, -2), dog_dt)
    if dv_extra is not None:
        dv = dv + dv_extra
    dl = p * (dp - (dp * p).sum(-1, keepdim=True))
    dbias = dl.reshape(groups, M // groups, h, n, n).sum(1)
    dl_dt = dl.to(dtype)
    dq = _mm(dl_dt, k) * scale
    dk = _mm(dl_dt.transpose(-1, -2), q) * scale
    rows = lambda t: t.to(dtype).permute(0, 2, 1, 3).reshape(M, n, C)
    dqkv = torch.cat([rows(dq), rows(dk), rows(dv)], -1)
    return rows(out_h), dqkv, dbias, c_lam


def attn_block_bwd_plain(x_img, g, lns, lnb, wq3, bq3, wk3, bk3, wv3, bv3,
                         wp3, bp, bias, mask, lam, win: int = 8,
                         eps: float = 1e-6, res: bool = True,
                         bias_groups: int = 1):
    """Plain twin of :func:`attn_block_bwd` (the Pallas body
    ``_attn_bwd_kernel``)."""
    B, H, W, C = x_img.shape
    h = wq3.shape[0]
    n = win * win
    nW = (H // win) * (W // win)
    dt = x_img.dtype
    xhat, rsig = _ln_stats(x_img, eps)
    xn = xhat * lns.float() + lnb.float()
    xw = _windows(xn.to(dt), win)                       # [M, n, C]
    wqkv, bqkv = _qkv_full(wq3, bq3, wk3, bk3, wv3, bv3, dt)
    wp = wp3.reshape(C, C).to(dt)
    qkv = (_mm(xw, wqkv) + bqkv).to(dt)

    gp = _windows(g.float(), win)
    g_dt = gp.to(dt)
    dbp = gp.reshape(-1, C).sum(0)
    dout = _mm(g_dt, wp.t())

    M = xw.shape[0]
    mask_full = None
    if mask is not None:
        mask_full = mask.float().repeat(B, 1, 1)[:, None]
    lam_w = None
    if lam is not None:
        lam_w = lam.float().repeat_interleave(nW, dim=0)[:, :, None, None]
    bias_nb = bias if bias_groups > 1 else bias[None]
    out_all, dqkv, dbias, c_lam = _attn_core_bwd(
        qkv, dout, bias_nb, mask_full, lam_w, bias_groups, h, dt)

    flat = lambda t: t.reshape(M * n, -1)
    dwp = _mm(flat(out_all).t(), flat(g_dt))
    dwqkv = _mm(flat(xw).t(), flat(dqkv))
    dbqkv = flat(dqkv).float().sum(0)
    dxn = _unwindows(_mm(dqkv, wqkv.t()), B, H, W, win)
    dx, dlns, dlnb = _ln_bwd(dxn, xhat, rsig, lns)
    if res:
        dx = dx + g.float()
    d = C // h
    dlam = None if lam is None else c_lam.reshape(B, nW, h).sum(1)
    return (dx.to(dt), dlns, dlnb, *_split_qkv_grads(dwqkv, dbqkv, h),
            dwp.reshape(h, d, C), dbp,
            dbias if bias_groups > 1 else dbias[0], dlam)


def freq_inter_bwd_plain(y_img, g, wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp,
                         biasB, mask, L: int = 1, win: int = 8):
    """Plain twin of :func:`freq_inter_bwd` (the Pallas body
    ``_freq_inter_bwd_kernel``): no residual, ``dres = g`` is the caller's."""
    LB, H, W, C = y_img.shape
    B = LB // L
    h = wq3.shape[0]
    n = win * win
    nW = (H // win) * (W // win)
    dt = y_img.dtype
    group = lambda t: (_windows(t, win).reshape(L, B * nW, n, C)
                       .transpose(0, 1).reshape(B * nW, L * n, C))
    z = group(y_img)
    wqkv, bqkv = _qkv_full(wq3, bq3, wk3, bk3, wv3, bv3, dt)
    wp = wp3.reshape(C, C).to(dt)
    qkv = (_mm(z, wqkv) + bqkv).to(dt)
    gp = group(g.float())
    g_dt = gp.to(dt)
    dbp = gp.reshape(-1, C).sum(0)
    dout = _mm(g_dt, wp.t())
    mask_full = None
    if mask is not None:
        mask_full = mask.float().repeat(B, L, L)[:, None]
    out_all, dqkv, dbias, _ = _attn_core_bwd(
        qkv, dout, biasB[None], mask_full, None, 1, h, dt)
    flat = lambda t: t.reshape(-1, t.shape[-1])
    dwp = _mm(flat(out_all).t(), flat(g_dt))
    dwqkv = _mm(flat(z).t(), flat(dqkv))
    dbqkv = flat(dqkv).float().sum(0)
    dz = _mm(dqkv, wqkv.t())                            # [B*nW, L*n, C]
    dy = _unwindows(dz.reshape(B * nW, L, n, C).transpose(0, 1)
                    .reshape(LB * nW, n, C), LB, H, W, win)
    d = C // h
    return (dy.to(dt), *_split_qkv_grads(dwqkv, dbqkv, h),
            dwp.reshape(h, d, C), dbp, dbias[0])


def _gelu_grad(x):
    """d/dx of the tanh-approximate GELU (the Pallas ``_gelu_grad``)."""
    c, a = 0.7978845608028654, 0.044715
    t = torch.tanh(c * (x + a * x * x * x))
    du = c * (1.0 + 3.0 * a * x * x)
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * du


def ffn_block_bwd_plain(x_img, g, lns, lnb, w1, b1, wd, bd, w2, b2,
                        eps: float = 1e-6):
    """Plain twin of :func:`ffn_block_bwd` (the Pallas body
    ``_ffn_bwd_kernel``, on the whole image instead of row tiles)."""
    B, H, W, C = x_img.shape
    Hd = w1.shape[1]
    dt = x_img.dtype
    xhat, rsig = _ln_stats(x_img, eps)
    xn = (xhat * lns.float() + lnb.float()).to(dt)
    w1c, w2c = w1.to(dt), w2.to(dt)
    wdf = wd.float()
    h1 = _mm(xn, w1c) + b1.float()                      # [B, H, W, Hd]
    a1p = F.pad(_gelu(h1), (0, 0, 1, 1, 1, 1))
    hc = bd.float() + sum(a1p[:, dy:dy + H, dx:dx + W] * wdf[dy, dx]
                          for dy in range(3) for dx in range(3))
    a2 = _gelu(hc)

    gf = g.float()
    g_dt = gf.to(dt)
    dhc = _mm(g_dt, w2c.t()) * _gelu_grad(hc)
    dbd = dhc.reshape(-1, Hd).sum(0)
    dw2 = _mm(a2.to(dt).reshape(-1, Hd).t(), g_dt.reshape(-1, C))
    db2 = gf.reshape(-1, C).sum(0)
    dwd = torch.stack([
        torch.stack([(a1p[:, dy:dy + H, dx:dx + W] * dhc).reshape(-1, Hd).sum(0)
                     for dx in range(3)]) for dy in range(3)])
    dhcp = F.pad(dhc, (0, 0, 1, 1, 1, 1))
    da1 = sum(dhcp[:, 2 - dy:2 - dy + H, 2 - dx:2 - dx + W] * wdf[dy, dx]
              for dy in range(3) for dx in range(3))
    dh1 = da1 * _gelu_grad(h1)
    dh1_dt = dh1.to(dt)
    dw1 = _mm(xn.reshape(-1, C).t(), dh1_dt.reshape(-1, Hd))
    db1 = dh1.reshape(-1, Hd).sum(0)
    dxn = _mm(dh1_dt, w1c.t())
    dx, dlns, dlnb = _ln_bwd(dxn, xhat, rsig, lns)
    return ((dx + gf).to(dt), dlns, dlnb, dw1, db1, dwd, dbd, dw2, db2)


# ---------------------------------------------------------------------------
# backward: CUDA kernels
# ---------------------------------------------------------------------------

LAUNCHES.update({"lewin_attn_bwd": 0, "lewin_ffn_bwd": 0, "freq_inter_bwd": 0})


def _grad_input(x, g):
    _check(x, g)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError("the output gradient must match the input in shape "
                         "and dtype")
    return g.contiguous()


def _workspace(nbytes: int, x: torch.Tensor) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, device=x.device)


def _attn_bwd_operands(x, wq3, bq3, wk3, bk3, wv3, bv3, wp3):
    """The backward's qkv / proj operands: the forward's formats with q
    unscaled (the kernel applies d^-0.5 to the logits, dq and dk, as the
    Pallas body does)."""
    h, C, d = wq3.shape
    if (C != x.shape[-1] or h * d != C or tuple(wp3.shape) != (h, d, C)
            or any(tuple(w.shape) != (h, C, d) for w in (wk3, wv3))
            or any(b.numel() != C for b in (bq3, bk3, bv3))):
        raise ValueError(f"attention weights {tuple(wq3.shape)}, "
                         f"{tuple(wp3.shape)} for C={x.shape[-1]}")
    to_nk = lambda w3: w3.permute(0, 2, 1).reshape(h * d, C)
    wqkv = _nk(torch.cat([to_nk(wq3), to_nk(wk3), to_nk(wv3)], 0), x.dtype)
    bqkv = torch.cat([b.reshape(-1) for b in (bq3, bk3, bv3)]).float()
    return wqkv, bqkv.contiguous(), _nk(wp3.reshape(C, C).t(), x.dtype)


def _attn_bwd_nt_operands(wqkv, wp3):
    """The B operands of ``dqkv Wqkv^T`` and ``gw Wp^T`` in K6 and K8:
    ``Wqkv [C, 3C]`` and ``Wp [C, C]`` as they are, rows zero-padded to
    kpad, from the forward's ``wqkv [3C, kpad(C)]`` and the per-head
    ``wp3``."""
    C = wp3.shape[-1]
    return _nk(wqkv[:, :C].t(), wqkv.dtype), _nk(wp3.reshape(C, C), wqkv.dtype)


def attn_bwd_kernel(x_img, g, lns, lnb, wq3, bq3, wk3, bk3, wv3, bv3, wp3,
                    bias, mask, lam, win: int, eps: float, res: bool,
                    bias_groups: int):
    """Launch K6 (:func:`attn_block_bwd`) on CUDA tensors."""
    from .build import load

    B, H, W, C = x_img.shape
    h = wq3.shape[0]
    n = win * win
    nW = (H // win) * (W // win)
    g = _grad_input(x_img, g)
    _check(x_img, lns, wq3, wp3, bias, mask, lam)
    if H % win or W % win or C % h or B % bias_groups:
        raise ValueError(f"unsupported shape {tuple(x_img.shape)}, h={h}, "
                         f"win={win}, bias_groups={bias_groups}")
    with torch.no_grad():
        wqkv, bqkv, wp = _attn_bwd_operands(x_img, wq3, bq3, wk3, bk3, wv3,
                                            bv3, wp3)
        wqkvn, wpn = _attn_bwd_nt_operands(wqkv, wp3)
        bias = _f32(bias, (bias_groups, h, n, n) if bias_groups > 1
                    else (h, n, n))
        mask = _f32(mask, (nW, n, n))
        lam = _f32(lam, (B, h))
        lns, lnb = _f32(lns, (C,)), _f32(lnb, (C,))
    dev, dt = x_img.device, x_img.dtype
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x_img)
    dln, dwqkv, dbqkv = f32(2, C), f32(C, 3 * C), f32(3 * C)
    dwp, dbp, dbias = f32(C, C), f32(C), torch.empty_like(bias)
    dlam = None if lam is None else f32(B, h)
    lib = load()
    nbytes = lib.fairm_lewin_attn_bwd_ws(B, H, W, C, h, win, bias_groups,
                                         _DTYPES[dt])
    if nbytes < 0:
        raise RuntimeError("fairm_lewin_attn_bwd_ws: the kernel refused "
                           f"{tuple(x_img.shape)}, h={h}, win={win}")
    ws = _workspace(nbytes, x_img)
    _run(lib.fairm_lewin_attn_bwd, _ptr(x_img), _ptr(g), _ptr(lns), _ptr(lnb),
         _ptr(wqkv), _ptr(bqkv), _ptr(wp), _ptr(wqkvn), _ptr(wpn), _ptr(bias),
         _ptr(mask), _ptr(lam), _ptr(ws), _ptr(dx), _ptr(dln), _ptr(dwqkv), _ptr(dbqkv), _ptr(dwp),
         _ptr(dbp), _ptr(dbias), _ptr(dlam), nbytes, B, H, W, C, h, win,
         bias_groups, int(res), _DTYPES[dt], float(eps), _stream(x_img))
    LAUNCHES["lewin_attn_bwd"] += 1
    return (dx, dln[0], dln[1], *_split_qkv_grads(dwqkv, dbqkv, h),
            dwp.reshape(h, C // h, C), dbp, dbias, dlam)


def freq_inter_bwd_kernel(y_img, g, wq3, bq3, wk3, bk3, wv3, bv3, wp3, biasB,
                          mask, L: int, win: int):
    """Launch K8 (:func:`freq_inter_bwd`) on CUDA tensors."""
    from .build import load

    LB, H, W, C = y_img.shape
    h = wq3.shape[0]
    n = win * win
    nW = (H // win) * (W // win)
    g = _grad_input(y_img, g)
    _check(y_img, wq3, wp3, biasB, mask)
    if H % win or W % win or C % h or LB % L:
        raise ValueError(f"unsupported shape {tuple(y_img.shape)}, h={h}, L={L}")
    with torch.no_grad():
        wqkv, bqkv, wp = _attn_bwd_operands(y_img, wq3, bq3, wk3, bk3, wv3,
                                            bv3, wp3)
        wqkvn, wpn = _attn_bwd_nt_operands(wqkv, wp3)
        bias = _f32(biasB, (h, L * n, L * n))
        mask = _f32(mask, (nW, n, n))
    dev, dt = y_img.device, y_img.dtype
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    dy = torch.empty_like(y_img)
    dwqkv, dbqkv, dwp, dbp = f32(C, 3 * C), f32(3 * C), f32(C, C), f32(C)
    dbias = torch.empty_like(bias)
    lib = load()
    nbytes = lib.fairm_freq_inter_bwd_ws(LB, H, W, C, h, win, L, _DTYPES[dt])
    if nbytes < 0:
        raise RuntimeError("fairm_freq_inter_bwd_ws: the kernel refused "
                           f"{tuple(y_img.shape)}, h={h}, win={win}, L={L}")
    ws = _workspace(nbytes, y_img)
    _run(lib.fairm_freq_inter_bwd, _ptr(y_img), _ptr(g), _ptr(wqkv),
         _ptr(bqkv), _ptr(wp), _ptr(wqkvn), _ptr(wpn), _ptr(bias), _ptr(mask),
         _ptr(ws), _ptr(dy), _ptr(dwqkv), _ptr(dbqkv), _ptr(dwp), _ptr(dbp),
         _ptr(dbias), nbytes, LB, H, W, C, h, win, L, _DTYPES[dt],
         _stream(y_img))
    LAUNCHES["freq_inter_bwd"] += 1
    return (dy, *_split_qkv_grads(dwqkv, dbqkv, h),
            dwp.reshape(h, C // h, C), dbp, dbias)


def ffn_bwd_kernel(x_img, g, lns, lnb, w1, b1, wd, bd, w2, eps: float):
    """Launch K7 (:func:`ffn_block_bwd`) on CUDA tensors."""
    from .build import load

    B, H, W, C = x_img.shape
    Hd = w1.shape[1]
    g = _grad_input(x_img, g)
    _check(x_img, lns, w1, wd, w2)
    if (tuple(w1.shape), tuple(wd.shape), tuple(w2.shape)) != (
            (C, Hd), (3, 3, Hd), (Hd, C)):
        raise ValueError(f"FFN weights {tuple(w1.shape)}, {tuple(wd.shape)}, "
                         f"{tuple(w2.shape)} for C={C}")
    with torch.no_grad():  # the products' operands [N, kpad(K)]
        dt = x_img.dtype
        w1t, w1n, w2n = _nk(w1.t(), dt), _nk(w1, dt), _nk(w2, dt)
        b1, bd = _f32(b1, (Hd,)), _f32(bd, (Hd,))
        wd = _f32(wd, (3, 3, Hd))
        lns, lnb = _f32(lns, (C,)), _f32(lnb, (C,))
    dev, dt = x_img.device, x_img.dtype
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x_img)
    dln, dw1, db1 = f32(2, C), f32(C, Hd), f32(Hd)
    dwd, dbd, dw2, db2 = f32(3, 3, Hd), f32(Hd), f32(Hd, C), f32(C)
    lib = load()
    nbytes = lib.fairm_lewin_ffn_bwd_ws(B, H, W, C, Hd, _DTYPES[dt])
    ws = _workspace(nbytes, x_img)
    _run(lib.fairm_lewin_ffn_bwd, _ptr(x_img), _ptr(g), _ptr(lns), _ptr(lnb),
         _ptr(w1t), _ptr(w1n), _ptr(b1), _ptr(wd), _ptr(bd), _ptr(w2n),
         _ptr(ws), _ptr(dx), _ptr(dln), _ptr(dw1), _ptr(db1), _ptr(dwd),
         _ptr(dbd), _ptr(dw2), _ptr(db2), nbytes, B, H, W, C, Hd, _DTYPES[dt],
         float(eps), _stream(x_img))
    LAUNCHES["lewin_ffn_bwd"] += 1
    return dx, dln[0], dln[1], dw1, db1, dwd, dbd, dw2, db2


# ---------------------------------------------------------------------------
# backward: entry points (the Pallas signatures and return layouts)
# ---------------------------------------------------------------------------


def attn_block_bwd(x_img, g, lns, lnb, wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp,
                   bias, mask, lam, win: int = 8, eps: float = 1e-6,
                   res: bool = True, bias_groups: int = 1):
    """Backward of :func:`block_attention` (``res=True``) and
    :func:`freq_intra` (``res=False, bias_groups=L``) without DropPath:
    ``(dx, dlns, dlnb, dwq3, dbq3, dwk3, dbk3, dwv3, dbv3, dwp3, dbp, dbias,
    dlam)`` in the forward's argument layouts, ``dx`` in x's dtype, the rest
    float32; ``dlam`` is None without ``lam``."""
    if x_img.device.type == "cpu":
        return attn_block_bwd_plain(x_img, g, lns, lnb, wq3, bq3, wk3, bk3,
                                    wv3, bv3, wp3, bp, bias, mask, lam, win,
                                    eps, res, bias_groups)
    return attn_bwd_kernel(x_img, g, lns, lnb, wq3, bq3, wk3, bk3, wv3, bv3,
                           wp3, bias, mask, lam, win, eps, res, bias_groups)


def freq_inter_bwd(y_img, g, wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp, biasB,
                   mask, L: int = 1, win: int = 8):
    """Backward of :func:`freq_inter` without the residual and DropPath:
    ``(dy, dwq3, dbq3, dwk3, dbk3, dwv3, dbv3, dwp3, dbp, dbiasB)``."""
    if y_img.device.type == "cpu":
        return freq_inter_bwd_plain(y_img, g, wq3, bq3, wk3, bk3, wv3, bv3,
                                    wp3, bp, biasB, mask, L, win)
    return freq_inter_bwd_kernel(y_img, g, wq3, bq3, wk3, bk3, wv3, bv3, wp3,
                                 biasB, mask, L, win)


def ffn_block_bwd(x_img, g, lns, lnb, w1, b1, wd, bd, w2, b2,
                  eps: float = 1e-6):
    """Backward of :func:`block_ffn` without DropPath:
    ``(dx, dlns, dlnb, dw1, db1, dwd, dbd, dw2, db2)``."""
    if x_img.device.type == "cpu":
        return ffn_block_bwd_plain(x_img, g, lns, lnb, w1, b1, wd, bd, w2, b2,
                                   eps)
    return ffn_bwd_kernel(x_img, g, lns, lnb, w1, b1, wd, bd, w2, eps)


# ---------------------------------------------------------------------------
# autograd Functions: forward K1 / K1 / K3 / K2 (or K4 / K5), backward
# K6 / K6 / K8 / K7; the twins on a CPU tensor
# ---------------------------------------------------------------------------
#
# DropPath inside a block, out = x + s_b * f(x) with a per-image s: the
# backward of u = x + f(x) is fed s * g, then dx += (1 - s) * g (JAX
# ``_attn_bwd``); for the inter half the residual's gradient is the unscaled
# g. ``mask`` and ``dps`` get no gradient.


def _scaled(g, dps):
    if dps is None:
        return g
    return (g.float() * dps.float()[:, None, None, None]).to(g.dtype)


def _fix_dx(dx, g, dps):
    if dps is None:
        return dx
    sf = dps.float()[:, None, None, None]
    return (dx.float() + (1.0 - sf) * g.float()).to(dx.dtype)


def _cast_like(grads, primals):
    return tuple(None if g is None else g.to(p.dtype)
                 for g, p in zip(grads, primals))


def _attn_vjp(x_img, g, lns, lnb, qkvp, bias, mask, lam, win, eps, dps):
    """Gradients of :func:`block_attention` wrt ``(x, lns, lnb, *qkvp, bias,
    lam)``; ``qkvp`` = ``(wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp)``."""
    grads = attn_block_bwd(x_img, _scaled(g, dps), lns, lnb, *qkvp, bias,
                           mask, lam, win, eps, True, 1)
    grads = (_fix_dx(grads[0], g, dps),) + grads[1:]
    return _cast_like(grads, (x_img, lns, lnb, *qkvp, bias,
                              x_img if lam is None else lam))


def _intra_vjp(x_img, g, lns, lnb, qkvp, biasA, mask, L, win, eps):
    grads = attn_block_bwd(x_img, g, lns, lnb, *qkvp, biasA, mask, None, win,
                           eps, False, L)[:12]
    return _cast_like(grads, (x_img, lns, lnb, *qkvp, biasA))


def _inter_vjp(y_img, res_img, g, qkvp, biasB, mask, L, win, dps):
    """Gradients of :func:`freq_inter` wrt ``(y, res, *qkvp, biasB)``."""
    grads = freq_inter_bwd(y_img, _scaled(g, dps), *qkvp, biasB, mask, L, win)
    grads = (grads[0], g.to(res_img.dtype)) + grads[1:]
    return _cast_like(grads, (y_img, res_img, *qkvp, biasB))


def _ffn_vjp(x_img, g, lns, lnb, ffnp, eps, dps):
    grads = ffn_block_bwd(x_img, _scaled(g, dps), lns, lnb, *ffnp, eps)
    grads = (_fix_dx(grads[0], g, dps),) + grads[1:]
    return _cast_like(grads, (x_img, lns, lnb, *ffnp))


class BlockAttention(torch.autograd.Function):
    """:func:`block_attention` with the backward of K6."""

    @staticmethod
    def forward(ctx, x_img, lns, lnb, wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp,
                bias, mask, lam, win, eps, dps):
        ctx.save_for_backward(x_img, lns, lnb, wq3, bq3, wk3, bk3, wv3, bv3,
                              wp3, bp, bias, mask, lam, dps)
        ctx.win, ctx.eps = win, eps
        return block_attention(x_img, lns, lnb, wq3, bq3, wk3, bk3, wv3, bv3,
                               wp3, bp, bias, mask, lam, win, eps, dps)

    @staticmethod
    def backward(ctx, g):
        x_img, lns, lnb, *qkvp, bias, mask, lam, dps = ctx.saved_tensors
        grads = _attn_vjp(x_img, g, lns, lnb, qkvp, bias, mask, lam, ctx.win,
                          ctx.eps, dps)
        return (*grads[:12], None, grads[12], None, None, None)


class FreqIntra(torch.autograd.Function):
    """:func:`freq_intra` with the backward of K6 (per-band bias)."""

    @staticmethod
    def forward(ctx, x_img, lns, lnb, wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp,
                biasA, mask, L, win, eps):
        ctx.save_for_backward(x_img, lns, lnb, wq3, bq3, wk3, bk3, wv3, bv3,
                              wp3, bp, biasA, mask)
        ctx.L, ctx.win, ctx.eps = L, win, eps
        return freq_intra(x_img, lns, lnb, wq3, bq3, wk3, bk3, wv3, bv3, wp3,
                          bp, biasA, mask, L, win, eps)

    @staticmethod
    def backward(ctx, g):
        x_img, lns, lnb, *qkvp, biasA, mask = ctx.saved_tensors
        grads = _intra_vjp(x_img, g, lns, lnb, qkvp, biasA, mask, ctx.L,
                           ctx.win, ctx.eps)
        return (*grads, None, None, None, None)


class FreqInter(torch.autograd.Function):
    """:func:`freq_inter` with the backward of K8 (``pairs`` as there:
    needed on a CUDA tensor)."""

    @staticmethod
    def forward(ctx, y_img, res_img, wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp,
                biasB, mask, L, win, eps, dps, pairs=None):
        ctx.save_for_backward(y_img, res_img, wq3, bq3, wk3, bk3, wv3, bv3,
                              wp3, bp, biasB, mask, dps)
        ctx.L, ctx.win = L, win
        return freq_inter(y_img, res_img, wq3, bq3, wk3, bk3, wv3, bv3, wp3,
                          bp, biasB, mask, L, win, eps, dps,
                          None if pairs is None else pairs.detach())

    @staticmethod
    def backward(ctx, g):
        y_img, res_img, *qkvp, biasB, mask, dps = ctx.saved_tensors
        grads = _inter_vjp(y_img, res_img, g, qkvp, biasB, mask, ctx.L,
                           ctx.win, dps)
        # biasB's gradient reaches the per-pair tables through the autograd
        # of its assembly; ``pairs`` only spares the forward reading biasB
        return (*grads, None, None, None, None, None, None)


class BlockFFN(torch.autograd.Function):
    """:func:`block_ffn` with the backward of K7."""

    @staticmethod
    def forward(ctx, x_img, lns, lnb, w1, b1, wd, bd, w2, b2, eps, dps):
        ctx.save_for_backward(x_img, lns, lnb, w1, b1, wd, bd, w2, b2, dps)
        ctx.eps = eps
        return block_ffn(x_img, lns, lnb, w1, b1, wd, bd, w2, b2, eps, dps)

    @staticmethod
    def backward(ctx, g):
        x_img, lns, lnb, *ffnp, dps = ctx.saved_tensors
        grads = _ffn_vjp(x_img, g, lns, lnb, ffnp, ctx.eps, dps)
        return (*grads, None, None)


def _merged_forward_aux(run):
    """One merged launch through ``run(scratch_out)``; hands back ``(out, u,
    y1)``: ``u`` (true layout) and ``y1`` (K5: the intra output, rolled
    layout) as the launch left them for the backward."""
    keep = []
    out = run(keep)
    u, y1 = keep[0]
    return out, u, y1


class BlockMerged(torch.autograd.Function):
    """:func:`block_merged`: one K4 launch forward, which also hands back
    ``u``; backward the chain K7 on ``u``, roll, K6 on the rolled image,
    roll back (JAX ``_merged_bwd``)."""

    @staticmethod
    def forward(ctx, x_img, ln1s, ln1b, wq3, bq3, wk3, bk3, wv3, bv3, wp3,
                bp, bias, mask, lam, ln2s, ln2b, w1, b1, wd, bd, w2, b2, win,
                shift, eps, dps1, dps2):
        qkvp = (wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp)
        ffnp = (w1, b1, wd, bd, w2, b2)
        if x_img.device.type == "cpu":
            u = roll(block_attention_plain(
                roll(x_img, shift), ln1s, ln1b, *qkvp, bias, mask, lam, win,
                eps, dps1), -shift)
            out = block_ffn_plain(u, ln2s, ln2b, *ffnp, eps, dps2)
        else:
            attn = _kernel_operands(x_img, attn_operands, *qkvp, bias)
            ffn = _kernel_operands(x_img, ffn_operands, *ffnp)
            out, u, _ = _merged_forward_aux(lambda keep: merged_kernel(
                x_img, ln1s, ln1b, attn, mask, lam, ln2s, ln2b, ffn, win,
                shift, eps, dps1, dps2, scratch_out=keep))
        ctx.save_for_backward(x_img, u, ln1s, ln1b, *qkvp, bias, mask, lam,
                              ln2s, ln2b, *ffnp, dps1, dps2)
        ctx.win, ctx.shift, ctx.eps = win, shift, eps
        return out

    @staticmethod
    def backward(ctx, g):
        (x_img, u, ln1s, ln1b, wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp, bias,
         mask, lam, ln2s, ln2b, w1, b1, wd, bd, w2, b2, dps1,
         dps2) = ctx.saved_tensors
        win, shift, eps = ctx.win, ctx.shift, ctx.eps
        gf = _ffn_vjp(u, g, ln2s, ln2b, (w1, b1, wd, bd, w2, b2), eps, dps2)
        ga = _attn_vjp(roll(x_img, shift).contiguous(),
                       roll(gf[0], shift).contiguous(), ln1s, ln1b,
                       (wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp), bias, mask,
                       lam, win, eps, dps1)
        return (roll(ga[0], -shift), *ga[1:12], None, ga[12], *gf[1:], None,
                None, None, None, None)


class BlockFreqMerged(torch.autograd.Function):
    """:func:`block_freq_merged`: one K5 launch forward, which also hands
    back ``u`` and ``y1`` (the band-group form writes them to device memory
    for it); backward the chain K7, roll, K8, K6, add the inter residual's
    gradient, roll back (JAX ``_freq_merged_bwd``). ``pairs`` as in
    :func:`block_freq_merged`: needed on a CUDA tensor where K5 runs its
    band-group form; biasB's gradient reaches the tables through the
    autograd of its assembly."""

    @staticmethod
    def forward(ctx, x_img, ln1s, ln1b, wq3A, bq3A, wk3A, bk3A, wv3A, bv3A,
                wp3A, bpA, biasA, wq3B, bq3B, wk3B, bk3B, wv3B, bv3B, wp3B,
                bpB, biasB, mask, ln2s, ln2b, w1, b1, wd, bd, w2, b2, L, win,
                shift, eps, dps1, dps2, pairs=None):
        pA = (wq3A, bq3A, wk3A, bk3A, wv3A, bv3A, wp3A, bpA)
        pB = (wq3B, bq3B, wk3B, bk3B, wv3B, bv3B, wp3B, bpB)
        ffnp = (w1, b1, wd, bd, w2, b2)
        if x_img.device.type == "cpu":
            img = roll(x_img, shift)
            y1 = freq_intra_plain(img, ln1s, ln1b, *pA, biasA, mask, L, win,
                                  eps)
            u = roll(freq_inter_plain(y1, img, *pB, biasB, mask, L, win, eps,
                                      dps1), -shift)
            out = block_ffn_plain(u, ln2s, ln2b, *ffnp, eps, dps2)
        else:
            intra = _kernel_operands(x_img, attn_operands, *pA, biasA)
            inter = _inter_operands(
                x_img, None if pairs is None else pairs.detach(), *pB, biasB)
            ffn = _kernel_operands(x_img, ffn_operands, *ffnp)
            out, u, y1 = _merged_forward_aux(lambda keep: freq_merged_kernel(
                x_img, ln1s, ln1b, intra, inter, mask, ln2s, ln2b, ffn, L, win,
                shift, eps, dps1, dps2, scratch_out=keep))
        ctx.save_for_backward(x_img, u, y1, ln1s, ln1b, *pA, biasA, *pB,
                              biasB, mask, ln2s, ln2b, *ffnp, dps1, dps2)
        ctx.L, ctx.win, ctx.shift, ctx.eps = L, win, shift, eps
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        x_img, u, y1, ln1s, ln1b = saved[:5]
        pA, biasA = saved[5:13], saved[13]
        pB, biasB = saved[14:22], saved[22]
        mask, ln2s, ln2b = saved[23:26]
        ffnp, (dps1, dps2) = saved[26:32], saved[32:34]
        L, win, shift, eps = ctx.L, ctx.win, ctx.shift, ctx.eps
        gf = _ffn_vjp(u, g, ln2s, ln2b, ffnp, eps, dps2)
        img = roll(x_img, shift).contiguous()
        gi = _inter_vjp(y1, img, roll(gf[0], shift).contiguous(), pB, biasB,
                        mask, L, win, dps1)
        ga = _intra_vjp(img, gi[0], ln1s, ln1b, pA, biasA, mask, L, win, eps)
        dimg = ga[0] + gi[1]              # intra input + inter residual
        return (roll(dimg, -shift), *ga[1:12], *gi[2:11], None, *gf[1:], None,
                None, None, None, None, None, None)
