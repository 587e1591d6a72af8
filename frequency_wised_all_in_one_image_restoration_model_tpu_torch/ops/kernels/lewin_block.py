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
  ``fused_block_freq_merged``).

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
calls the launchers directly. ``LAUNCHES`` counts kernel launches per
kernel (K1 ``lewin_attn`` serves two entry points), one per launcher call
that reached the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

LAUNCHES = {"lewin_attn": 0, "lewin_ffn": 0, "freq_inter": 0,
            "lewin_merged": 0, "freq_merged": 0}


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


def _project(out, wp3, bp, dtype):
    """[M, h, n, d] fp32 -> [M, n, C] fp32 output projection."""
    M, h, n, d = out.shape
    C = wp3.shape[-1]
    o = out.to(dtype).permute(0, 2, 1, 3).reshape(M, n, h * d)
    return torch.matmul(o, wp3.reshape(h * d, C).to(dtype)).float() + bp.float()


def _attention_plain(x_img, lns, lnb, wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp,
                     bias, mask, lam, win, eps, res, bias_groups, dps):
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
    y = _unwindows(_project(out, wp3, bp, dtype), B, H, W, win)
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


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def block_ffn_plain(x_img, lns, lnb, w1, b1, wd, bd, w2, b2,
                    eps: float = 1e-6, dps=None):
    """Plain twin of :func:`block_ffn` (JAX ``_xla_block_ffn``)."""
    dtype = x_img.dtype
    Hd = w1.shape[1]
    xf, xn = _layer_norm(x_img, lns, lnb, eps)
    hdn = _gelu(torch.matmul(xn.to(dtype), w1.to(dtype)).float() + b1.float())
    hdn = F.conv2d(hdn.permute(0, 3, 1, 2),
                   wd.float().permute(2, 0, 1)[:, None], padding=1, groups=Hd)
    hdn = _gelu(hdn.permute(0, 2, 3, 1) + bd.float())
    y = torch.matmul(hdn.to(dtype), w2.to(dtype)).float() + b2.float()
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


def attn_operands(wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp, bias,
                  dtype) -> AttnOperands:
    """Per-head weights (``wq3 [h, C, d]``, ``wp3 [h, d, C]``) -> the N x K
    operands of the qkv and proj GEMMs, the scale d^-0.5 folded into q."""
    h, C, d = wq3.shape
    scale = d ** -0.5
    to_nk = lambda w3: w3.permute(0, 2, 1).reshape(h * d, C)
    wqkv = torch.cat([to_nk(wq3) * scale, to_nk(wk3), to_nk(wv3)], 0)
    bqkv = torch.cat([bq3.reshape(-1) * scale, bk3.reshape(-1),
                      bv3.reshape(-1)])
    return AttnOperands(h, _nk(wqkv, dtype), bqkv.float().contiguous(),
                        _nk(wp3.reshape(C, C).t(), dtype),
                        bp.float().contiguous(), bias.float().contiguous())


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


def attention_kernel(x_img, lns, lnb, op: AttnOperands, mask, lam, win: int,
                     eps: float, res: bool, bias_groups: int, dps):
    """Launch K1 on ``x_img [B, H, W, C]`` (CUDA) with prepared operands:
    :func:`block_attention` for ``res=True, bias_groups=1``,
    :func:`freq_intra` for ``res=False, bias_groups=L``."""
    from .build import load

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
    dt = x_img.dtype
    # working buffers: the LN'd windows, then the attention rows; the qkv rows
    xo = torch.empty((B * H * W, kpad(C)), dtype=dt, device=x_img.device)
    qkv = torch.empty((B * H * W, 3 * C), dtype=dt, device=x_img.device)
    out = torch.empty_like(x_img)
    # every tensor handed over by address is bound to a name until the
    # launch: a temporary freed earlier could be reused by the next one
    _run(load().fairm_lewin_attn, _ptr(x_img), _ptr(lns), _ptr(lnb),
         _ptr(op.wqkv), _ptr(op.bqkv), _ptr(op.wp), _ptr(op.bp),
         _ptr(op.bias), _ptr(mask), _ptr(lam), _ptr(dps), _ptr(xo), _ptr(qkv),
         _ptr(out), B, H, W, C, h, win, bias_groups, int(res), _DTYPES[dt],
         float(eps), _stream(x_img))
    LAUNCHES["lewin_attn"] += 1
    return out


def freq_inter_kernel(y_img, res_img, op: AttnOperands, mask, L: int,
                      win: int, dps):
    """Launch K3 (:func:`freq_inter`) on CUDA tensors with prepared operands."""
    from .build import load

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
    mask = _f32(mask, (nW, n, n))
    dps = _f32(dps, (LB,))
    dt = y_img.dtype
    zo = torch.empty((LB * H * W, kpad(C)), dtype=dt, device=y_img.device)
    qkv = torch.empty((LB * H * W, 3 * C), dtype=dt, device=y_img.device)
    out = torch.empty_like(y_img)
    _run(load().fairm_freq_inter, _ptr(y_img), _ptr(res_img), _ptr(op.wqkv),
         _ptr(op.bqkv), _ptr(op.wp), _ptr(op.bp), _ptr(op.bias), _ptr(mask),
         _ptr(dps), _ptr(zo), _ptr(qkv), _ptr(out), LB, H, W, C, h, win, L,
         _DTYPES[dt], _stream(y_img))
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
    from .build import load

    B, H, W, C = x_img.shape
    _check(x_img, lns, dps)
    Hd = _check_ffn_operands(op, x_img)
    lns, lnb = _f32(lns, (C,)), _f32(lnb, (C,))
    dps = _f32(dps, (B,))
    dt = x_img.dtype
    M = B * H * W
    xn = torch.empty((M, kpad(C)), dtype=dt, device=x_img.device)
    hid1 = torch.empty((M, Hd), dtype=dt, device=x_img.device)
    hid2 = torch.empty((M, kpad(Hd)), dtype=dt, device=x_img.device)
    out = torch.empty_like(x_img)
    _run(load().fairm_lewin_ffn, _ptr(x_img), _ptr(lns), _ptr(lnb),
         _ptr(op.w1), _ptr(op.b1), _ptr(op.wd), _ptr(op.bd), _ptr(op.w2),
         _ptr(op.b2), _ptr(dps), _ptr(xn), _ptr(hid1), _ptr(hid2), _ptr(out),
         B, H, W, C, Hd, _DTYPES[dt], float(eps), _stream(x_img))
    LAUNCHES["lewin_ffn"] += 1
    return out


def _merged_scratch(x_img, Hd: int, freq: bool) -> torch.Tensor:
    """The merged kernels' working buffer (csrc/merged.cuh): per pixel the
    LN'd / attention rows, qkv, (the intra output,) u and both hidden rows."""
    B, H, W, C = x_img.shape
    cols = kpad(C) + 3 * C + (C if freq else 0) + C + Hd + kpad(Hd)
    return torch.empty(B * H * W * cols, dtype=x_img.dtype,
                       device=x_img.device)


# the merged kernels' phases, in order: slot i + 1 of a ``stamps`` tensor
# holds the device clock (ns) at the end of phase i, slot 0 the start
MERGED_PHASES = ("LN1 + window gather", "qkv product", "attention core",
                 "projection + scatter", "LN2", "fc1 + GELU",
                 "depthwise conv + GELU", "fc2 + residual")
FREQ_MERGED_PHASES = (MERGED_PHASES[:3]
                      + ("intra projection", "band regroup",
                         "inter qkv product", "inter attention core",
                         "inter projection + scatter") + MERGED_PHASES[4:])
MERGED_STAMPS = 16


def _stamps(stamps, x: torch.Tensor) -> None:
    if stamps is not None and (
            stamps.dtype != torch.int64 or stamps.device != x.device
            or stamps.numel() < MERGED_STAMPS or not stamps.is_contiguous()):
        raise ValueError(f"stamps: a contiguous int64 tensor of "
                         f"{MERGED_STAMPS} on {x.device}")


def merged_kernel(x_img, ln1s, ln1b, attn: AttnOperands, mask, lam, ln2s,
                  ln2b, ffn: FfnOperands, win: int, shift: int, eps: float,
                  dps1, dps2, stamps=None):
    """Launch K4 (:func:`block_merged`) on the TRUE-layout ``x_img
    [B, H, W, C]`` (CUDA) with the operands of both halves: one launch.
    ``stamps``, an int64 tensor of :data:`MERGED_STAMPS`, receives the
    device clock at the start and after each of :data:`MERGED_PHASES`."""
    from .build import load

    B, H, W, C = x_img.shape
    h = attn.heads
    n = win * win
    nW = (H // win) * (W // win)
    _check(x_img, ln1s, ln2s, mask, lam, dps1, dps2)
    if H % win or W % win or C % h or not 0 <= shift < win:
        raise ValueError(f"unsupported shape {tuple(x_img.shape)}, h={h}, "
                         f"win={win}, shift={shift}")
    _check_attn_operands(attn, x_img, (h, n, n))
    Hd = _check_ffn_operands(ffn, x_img)
    _stamps(stamps, x_img)
    mask = _f32(mask, (nW, n, n))
    lam = _f32(lam, (B, h))
    dps1, dps2 = _f32(dps1, (B,)), _f32(dps2, (B,))
    ln1s, ln1b = _f32(ln1s, (C,)), _f32(ln1b, (C,))
    ln2s, ln2b = _f32(ln2s, (C,)), _f32(ln2b, (C,))
    dt = x_img.dtype
    # bound to names until the launch returns, the scratch included
    scratch = _merged_scratch(x_img, Hd, False)
    out = torch.empty_like(x_img)
    _run(load().fairm_lewin_merged, _ptr(x_img), _ptr(ln1s), _ptr(ln1b),
         _ptr(attn.wqkv), _ptr(attn.bqkv), _ptr(attn.wp), _ptr(attn.bp),
         _ptr(attn.bias), _ptr(mask), _ptr(lam), _ptr(dps1), _ptr(ln2s),
         _ptr(ln2b), _ptr(ffn.w1), _ptr(ffn.b1), _ptr(ffn.wd), _ptr(ffn.bd),
         _ptr(ffn.w2), _ptr(ffn.b2), _ptr(dps2), _ptr(scratch), _ptr(out),
         _ptr(stamps), scratch.numel(), B, H, W, C, h, win, shift, Hd,
         _DTYPES[dt],
         float(eps), _stream(x_img))
    LAUNCHES["lewin_merged"] += 1
    return out


def freq_merged_kernel(x_img, ln1s, ln1b, intra: AttnOperands,
                       inter: AttnOperands, mask, ln2s, ln2b,
                       ffn: FfnOperands, L: int, win: int, shift: int,
                       eps: float, dps1, dps2, stamps=None):
    """Launch K5 (:func:`block_freq_merged`) on the TRUE-layout band-major
    ``x_img [L*B, H, W, C]`` (CUDA) with the operands of the three parts:
    one launch. ``stamps`` as in :func:`merged_kernel`, for
    :data:`FREQ_MERGED_PHASES`."""
    from .build import load

    LB, H, W, C = x_img.shape
    h = intra.heads
    n = win * win
    nW = (H // win) * (W // win)
    _check(x_img, ln1s, ln2s, mask, dps1, dps2)
    if (H % win or W % win or C % h or LB % L or inter.heads != h
            or not 0 <= shift < win):
        raise ValueError(f"unsupported shape {tuple(x_img.shape)}, h={h}, "
                         f"L={L}, win={win}, shift={shift}")
    _check_attn_operands(intra, x_img, (L, h, n, n) if L > 1 else (h, n, n))
    _check_attn_operands(inter, x_img, (h, L * n, L * n))
    Hd = _check_ffn_operands(ffn, x_img)
    _stamps(stamps, x_img)
    mask = _f32(mask, (nW, n, n))
    dps1, dps2 = _f32(dps1, (LB,)), _f32(dps2, (LB,))
    ln1s, ln1b = _f32(ln1s, (C,)), _f32(ln1b, (C,))
    ln2s, ln2b = _f32(ln2s, (C,)), _f32(ln2b, (C,))
    dt = x_img.dtype
    scratch = _merged_scratch(x_img, Hd, True)
    out = torch.empty_like(x_img)
    _run(load().fairm_freq_merged, _ptr(x_img), _ptr(ln1s), _ptr(ln1b),
         _ptr(intra.wqkv), _ptr(intra.bqkv), _ptr(intra.wp), _ptr(intra.bp),
         _ptr(intra.bias), _ptr(inter.wqkv), _ptr(inter.bqkv), _ptr(inter.wp),
         _ptr(inter.bp), _ptr(inter.bias), _ptr(mask), _ptr(dps1), _ptr(ln2s),
         _ptr(ln2b), _ptr(ffn.w1), _ptr(ffn.b1), _ptr(ffn.wd), _ptr(ffn.bd),
         _ptr(ffn.w2), _ptr(ffn.b2), _ptr(dps2), _ptr(scratch), _ptr(out),
         _ptr(stamps), scratch.numel(), LB, H, W, C, h, win, shift, L, Hd,
         _DTYPES[dt],
         float(eps), _stream(x_img))
    LAUNCHES["freq_merged"] += 1
    return out


# ---------------------------------------------------------------------------
# entry points (the Pallas signatures): the plain twin on a CPU tensor, the
# kernel on a CUDA tensor
# ---------------------------------------------------------------------------


def _kernel_operands(x, make, *weights):
    _check(x, *weights)
    return make(*weights, x.dtype)


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
               mask, L: int = 1, win: int = 8, eps: float = 1e-6, dps=None):
    """``res + dps * proj(grouped_attn(y))``: attention over each window's
    ``L*n`` band-grouped tokens with ``biasB [h, L*n, L*n]`` (the L x L
    bias tables with the 'inter' band mask folded in) and the SW-MSA mask
    tiled (L, L). ``dps [L*B]`` is indexed by the folded sample ``l*B + b``.
    ``eps`` is unused (no LayerNorm), kept for the Pallas signature."""
    if y_img.device.type == "cpu":
        return freq_inter_plain(y_img, res_img, wq3, bq3, wk3, bk3, wv3, bv3,
                                wp3, bp, biasB, mask, L, win, eps, dps)
    op = _kernel_operands(y_img, attn_operands, wq3, bq3, wk3, bk3, wv3, bv3,
                          wp3, bp, biasB)
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
                      eps: float = 1e-6, dps1=None, dps2=None):
    """One whole frequency-MSA LeWin block on the TRUE-layout band-major
    batch ``x_img [L*B, H, W, C]``: ``u = x + dps1 * unroll(inter(intra(
    LN1(roll(x)))))``, then ``out = u + dps2 * LeFF(LN2(u))``. The A
    weights and ``biasA [L, h, n, n]`` are :func:`freq_intra`'s, the B
    weights and ``biasB [h, L*n, L*n]`` :func:`freq_inter`'s; ``dps1``,
    ``dps2 [L*B]`` by the folded sample. Equal to the chain of the three
    entry points around ``torch.roll``, in one launch."""
    if x_img.device.type == "cpu":
        return block_freq_merged_plain(
            x_img, ln1s, ln1b, wq3A, bq3A, wk3A, bk3A, wv3A, bv3A, wp3A, bpA,
            biasA, wq3B, bq3B, wk3B, bk3B, wv3B, bv3B, wp3B, bpB, biasB, mask,
            ln2s, ln2b, w1, b1, wd, bd, w2, b2, L, win, shift, eps, dps1,
            dps2)
    intra = _kernel_operands(x_img, attn_operands, wq3A, bq3A, wk3A, bk3A,
                             wv3A, bv3A, wp3A, bpA, biasA)
    inter = _kernel_operands(x_img, attn_operands, wq3B, bq3B, wk3B, bk3B,
                             wv3B, bv3B, wp3B, bpB, biasB)
    ffn = _kernel_operands(x_img, ffn_operands, w1, b1, wd, bd, w2, b2)
    return freq_merged_kernel(x_img, ln1s, ln1b, intra, inter, mask, ln2s,
                              ln2b, ffn, L, win, shift, eps, dps1, dps2)
