"""Modulated deformable convolution v2: the port of the JAX
``ops/deform_conv.py`` (the exact gather composite ``_exact_dcn``) and of
the Pallas kernel ``ops/pallas/dcn.py::dcn_shift_kernel``, as K11
(``csrc/dcn.cu``).

Sampling location of output pixel ``p`` and tap ``t`` is ``p + t * dilation
- padding + offset``; the bilinear sample of a zero-padded image, times the
sigmoided modulation scalar of the tap, enters a contraction over
``(tap, Cin)`` with the ``[kh, kw, Cin, Cout]`` (HWIO) weight.

* :func:`dcn_plain` with ``clamp=None`` is ``_exact_dcn`` (:173-228): zero
  padding and the ``[-1, H]`` clip of ``_bilinear_gather`` (:65-104),
  offsets as all K dy then all K dx, the sample and the modulation in x's
  dtype, the contraction in fp32, the output in x's dtype, then the bias.
  With ``clamp=R`` every offset is first clamped to ``[-R, R]``: the
  semantics of ``dcn_shift_kernel``, whose static shift-sum equals the
  exact composite on clamped offsets (its docstring; the JAX tests assert
  it).
* :func:`dcn` launches K11 on a CUDA tensor: a gather DCNv2 with the exact
  semantics, not the TPU's gather-free shift decomposition, which was a
  workaround for Mosaic's gather limits (``dcn.py:5-10``) and costs about
  six times the arithmetic, by the route :func:`dcn_path` names: in bf16
  at C, Cout <= 64 one implicit GEMM that builds the modulated columns on
  the SM, else a column pass into device memory and a GEMM.
* :class:`DCNFn` is the autograd Function: forward K11, backward
  :func:`dcn_bwd`: :func:`dcn_bwd_plain` on a CPU tensor, K14
  (``csrc/dcn_bwd.cu``) on a CUDA tensor. The JAX package's backward is
  the composite's VJP (``ops/deform_conv.py:107-133``, ``_exact_dcn`` at
  :173), which XLA computes deterministically; the Pallas package has no
  backward DCN kernel. K14 groups the samples by pixel with integer keys
  and adds each pixel's gradient in a fixed order, with no float atomics, so
  a training step through a DCN gives equal bits when run twice (autograd
  of the plain gather would add with ``index_add``'s atomics on the card).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .kernels.lewin_block import (_DTYPES, _check, _f32, _mm, _nk, _ptr,
                                  _run, _stream)

LAUNCHES = {"dcn": 0, "dcn_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _corner_matrix(x: torch.Tensor) -> torch.Tensor:
    """``[B (H+1) (W+1), 4C]``: row (b, y0 + 1, x0 + 1) holds the four
    bilinear corners of base corner (y0, x0) of the zero-padded image."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    hp, wp = h + 1, w + 1
    return torch.cat([xp[:, :hp, :wp], xp[:, :hp, 1:], xp[:, 1:, :wp],
                      xp[:, 1:, 1:]], dim=-1).reshape(b * hp * wp, 4 * c)


def _footing(shape, yy: torch.Tensor, xx: torch.Tensor):
    """Where the samples at ``yy, xx [B, P]`` land in an image of ``shape``
    ``(B, H, W, C)``: their rows of :func:`_corner_matrix` ``[B, P]`` and the
    fractions ``fy, fx`` (fp32). Coordinates at or beyond the rim sample
    the zero pad; the base corner is clipped to H-1 so every row lies
    inside the padded grid."""
    b, h, w, _ = shape
    wp = w + 1
    yyc = yy.clamp(-1.0, float(h))
    xxc = xx.clamp(-1.0, float(w))
    y0 = torch.floor(yyc).clamp(-1.0, float(h - 1))
    x0 = torch.floor(xxc).clamp(-1.0, float(w - 1))
    base = (torch.arange(b, device=yy.device) * ((h + 1) * wp))[:, None]
    idx = (y0 + 1).long() * wp + (x0 + 1).long() + base
    return idx, yyc - y0, xxc - x0


def _bilinear_gather(x: torch.Tensor, yy: torch.Tensor,
                     xx: torch.Tensor) -> torch.Tensor:
    """Sample ``x [B, H, W, C]`` at float coordinates ``yy, xx [B, P]``
    with zero padding outside the image: ``[B, P, C]`` in x's dtype. One
    row gather over the four corners stacked on the channel axis, as
    the JAX ``_bilinear_gather`` does it."""
    b, h, w, c = x.shape
    p = yy.shape[1]
    idx, fy, fx = _footing(x.shape, yy, xx)
    fy = fy[..., None].to(x.dtype)
    fx = fx[..., None].to(x.dtype)
    rows = _corner_matrix(x)[idx.reshape(-1)].reshape(b, p, 4, c)
    return (rows[:, :, 0] * (1 - fy) * (1 - fx)
            + rows[:, :, 1] * (1 - fy) * fx
            + rows[:, :, 2] * fy * (1 - fx)
            + rows[:, :, 3] * fy * fx)


def _coords(off, kh: int, kw: int, padding: int, dilation: int):
    """The sampling coordinates ``yy, xx [B, P K]`` (fp32) of the fp32
    offsets ``off [B, Ho, Wo, 2K]``: output pixel + tap * dilation -
    padding + offset."""
    b, ho, wo, _ = off.shape
    k, p = kh * kw, ho * wo
    oy = off[..., :k].reshape(b, p, k)
    ox = off[..., k:].reshape(b, p, k)
    dev = off.device
    base_y = (torch.arange(ho, device=dev, dtype=torch.float32)[:, None]
              - padding).expand(ho, wo).reshape(-1)
    base_x = (torch.arange(wo, device=dev, dtype=torch.float32)[None, :]
              - padding).expand(ho, wo).reshape(-1)
    tap_y = (torch.arange(kh, device=dev, dtype=torch.float32)[:, None]
             * dilation).expand(kh, kw).reshape(-1)
    tap_x = (torch.arange(kw, device=dev, dtype=torch.float32)[None, :]
             * dilation).expand(kh, kw).reshape(-1)
    yy = (base_y[None, :, None] + tap_y[None, None, :] + oy).reshape(b, p * k)
    xx = (base_x[None, :, None] + tap_x[None, None, :] + ox).reshape(b, p * k)
    return yy, xx


def dcn_plain(x, offset, mask, weight, bias=None, padding: int = 1,
              dilation: int = 1, clamp: Optional[float] = None):
    """DCNv2 forward, stride 1: ``x [B, H, W, Cin]``, ``offset [B, Ho, Wo,
    2K]`` (all K dy, then all K dx), ``mask [B, Ho, Wo, K]`` (sigmoided),
    ``weight [kh, kw, Cin, Cout]``, ``bias [Cout]`` or None ->
    ``[B, Ho, Wo, Cout]`` in x's dtype."""
    b, h, w, cin = x.shape
    kh, kw, _, cout = weight.shape
    k = kh * kw
    ho, wo = offset.shape[1], offset.shape[2]
    p = ho * wo
    off = offset.float()
    if clamp is not None:
        off = off.clamp(-float(clamp), float(clamp))
    yy, xx = _coords(off, kh, kw, padding, dilation)
    m = mask.reshape(b, p, k)
    sample = _bilinear_gather(x, yy, xx)
    col = sample.reshape(b, p, k, cin) * m[..., None].to(sample.dtype)
    out = torch.matmul(col.reshape(b, p, k * cin).float(),
                       weight.to(x.dtype).reshape(k * cin, cout).float())
    out = out.to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.reshape(b, ho, wo, cout)


# The widest input and output channels at which K11 in bf16 runs as the
# implicit GEMM. From the A/B of the two routes on an H100 at B = 4 and 32
# (``tools/bwd_kernel_profile.py --k11``, ``chip_smoke.py`` phase 10;
# PERF.md section 6): the implicit GEMM is ahead at DGRN's C = Cout = 64
# (0.91 of the column route's device time at B = 32, 0.82 at B = 4) and at
# C = 3 (0.98, 0.80), behind at every width of the deformable LeFF,
# C = 112 ... 896 (1.4-4.8x).
DCN_IMPLICIT_MAX_C = 64


def dcn_path(cin: int, cout: int, dtype) -> str:
    """How K11 runs a DCN of ``cin`` -> ``cout`` channels: ``'implicit'``,
    one launch that builds the modulated columns on the SM (bf16, both
    widths at most DCN_IMPLICIT_MAX_C), else ``'columns'``, the column pass
    into a column matrix ``[B Ho Wo, kpad(K cin)]`` in device memory and a
    GEMM."""
    if dtype == torch.bfloat16 and max(cin, cout) <= DCN_IMPLICIT_MAX_C:
        return "implicit"
    return "columns"


def dcn_kernel(x, offset, mask, weight, bias=None, padding: int = 1,
               dilation: int = 1, clamp: Optional[float] = None,
               path: Optional[str] = None):
    """Launch K11 on CUDA tensors (arguments as :func:`dcn_plain`) by
    :func:`dcn_path` (``path`` names the route instead: the two are
    compared by ``chip_smoke.py``; fp32 has the column route only)."""
    from .kernels.build import load

    b, h, w, cin = x.shape
    kh, kw, wcin, cout = weight.shape
    k = kh * kw
    ho, wo = offset.shape[1], offset.shape[2]
    _check(x, offset, mask, weight, bias)
    if wcin != cin or ho != h + 2 * padding - dilation * (kh - 1) \
            or wo != w + 2 * padding - dilation * (kw - 1):
        raise ValueError(f"DCN shapes x {tuple(x.shape)}, offset "
                         f"{tuple(offset.shape)}, weight {tuple(weight.shape)}"
                         f", padding {padding}, dilation {dilation}")
    dt = x.dtype
    off = _f32(offset, (b, ho, wo, 2 * k))
    msk = _f32(mask, (b, ho, wo, k))
    with torch.no_grad():  # the GEMM operand [Cout, kpad(K * Cin)]
        wt = _nk(weight.reshape(k * cin, cout).t(), dt)
    bias = _f32(bias, (cout,))
    path = path or dcn_path(cin, cout, dt)
    if path not in ("implicit", "columns") or (
            path == "implicit" and dt != torch.bfloat16):
        raise ValueError(f"K11 has no route {path!r} in {dt}")
    # the column route stages the modulated columns through device memory
    # for its GEMM; the implicit GEMM builds them on the SM
    cols = None
    if path == "columns":
        cols = torch.empty((b * ho * wo, wt.shape[1]), dtype=dt,
                           device=x.device)
    out = torch.empty((b, ho, wo, cout), dtype=dt, device=x.device)
    _run(load().fairm_dcn, _ptr(x), _ptr(off), _ptr(msk), _ptr(wt),
         _ptr(bias), _ptr(cols), _ptr(out), b, h, w, cin, ho, wo, cout, kh,
         kw, padding, dilation, -1.0 if clamp is None else float(clamp),
         _DTYPES[dt], _stream(x))
    LAUNCHES["dcn"] += 1
    return out


def dcn(x, offset, mask, weight, bias=None, padding: int = 1,
        dilation: int = 1, clamp: Optional[float] = None):
    """The modulated DCNv2: :func:`dcn_plain` on a CPU tensor, K11 on a
    CUDA tensor."""
    if x.device.type == "cpu":
        return dcn_plain(x, offset, mask, weight, bias, padding, dilation,
                         clamp)
    return dcn_kernel(x, offset, mask, weight, bias, padding, dilation, clamp)


def dcn_bwd_plain(x, offset, mask, weight, bias, g, padding: int = 1,
                  dilation: int = 1):
    """Backward of :func:`dcn_plain` (no clamp) written out at K14's
    rounding points: ``(dx, doffset, dmask, dweight, dbias)``, dx in x's
    dtype, the rest fp32, ``dbias`` None without ``bias``. The sample, its
    fractions and every sum in fp32; ``dcol = g W^T`` rounded to x's dtype
    (the product's operands in x's dtype), dx summed in fp32 and rounded
    once; ``dweight`` from the forward's columns (rounded to x's dtype).
    The rim clip passes gradient at its bounds and none beyond them, floor
    none: autograd's conventions on :func:`_bilinear_gather`."""
    b, h, w, cin = x.shape
    kh, kw, _, cout = weight.shape
    k = kh * kw
    ho, wo = offset.shape[1], offset.shape[2]
    pk = ho * wo * k
    dt = x.dtype
    yy, xx = _coords(offset.float(), kh, kw, padding, dilation)
    idx, fy, fx = _footing(x.shape, yy, xx)
    rows = _corner_matrix(x.float())[idx.reshape(-1)].reshape(b, pk, 4, cin)
    v0, v1, v2, v3 = rows.unbind(2)
    fy, fx = fy[..., None], fx[..., None]
    wts = torch.stack([(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx),
                       fy * fx], 2)                         # [b, pk, 4, 1]
    sample = (rows * wts).sum(2)                            # [b, pk, cin]
    m = mask.float().reshape(b, pk, 1)
    g_dt = g.to(dt).reshape(b * ho * wo, cout)
    dcol = _mm(g_dt, weight.to(dt).reshape(k * cin, cout).t()).to(dt).float()
    dcol = dcol.reshape(b, pk, cin)
    dmask = (dcol * sample).sum(-1)
    dfy = (dcol * ((1 - fx) * (v2 - v0) + fx * (v3 - v1))).sum(-1) * m[..., 0]
    dfx = (dcol * ((1 - fy) * (v1 - v0) + fy * (v3 - v2))).sum(-1) * m[..., 0]
    dfy = torch.where((yy >= -1) & (yy <= h), dfy, 0.0)
    dfx = torch.where((xx >= -1) & (xx <= w), dfx, 0.0)
    doffset = torch.cat([dfy.reshape(b, ho, wo, k), dfx.reshape(b, ho, wo, k)],
                        -1)
    contrib = (wts * m[..., None]) * dcol[:, :, None]       # [b, pk, 4, cin]
    hp, wp = h + 1, w + 1
    dxc = torch.zeros(b * hp * wp, 4 * cin, dtype=torch.float32,
                      device=x.device)
    dxc.index_add_(0, idx.reshape(-1), contrib.reshape(b * pk, 4 * cin))
    dxc = dxc.reshape(b, hp, wp, 4, cin)
    dxp = torch.zeros(b, h + 2, w + 2, cin, dtype=torch.float32,
                      device=x.device)
    dxp[:, :hp, :wp] += dxc[..., 0, :]
    dxp[:, :hp, 1:] += dxc[..., 1, :]
    dxp[:, 1:, :wp] += dxc[..., 2, :]
    dxp[:, 1:, 1:] += dxc[..., 3, :]
    cols = (sample * m).to(dt).reshape(b * ho * wo, k * cin)
    dweight = _mm(cols.t(), g_dt).reshape(kh, kw, cin, cout)
    dbias = None if bias is None else g_dt.float().sum(0)
    return (dxp[:, 1:h + 1, 1:w + 1].to(dt), doffset,
            dmask.reshape(b, ho, wo, k), dweight, dbias)


def dcn_bwd_kernel(x, offset, mask, weight, bias, g, padding: int = 1,
                   dilation: int = 1):
    """Launch K14 on CUDA tensors (arguments and results as
    :func:`dcn_bwd_plain`)."""
    from .kernels.build import load

    b, h, w, cin = x.shape
    kh, kw, wcin, cout = weight.shape
    k = kh * kw
    ho, wo = offset.shape[1], offset.shape[2]
    _check(x, offset, mask, weight, bias, g)
    if wcin != cin or ho != h + 2 * padding - dilation * (kh - 1) \
            or wo != w + 2 * padding - dilation * (kw - 1) \
            or tuple(g.shape) != (b, ho, wo, cout):
        raise ValueError(f"DCN backward shapes x {tuple(x.shape)}, offset "
                         f"{tuple(offset.shape)}, weight {tuple(weight.shape)}"
                         f", g {tuple(g.shape)}, padding {padding}, "
                         f"dilation {dilation}")
    if b * ho * wo * k >= 2 ** 31:
        raise ValueError(f"{b * ho * wo * k} samples: K14 numbers them in int32")
    dt = x.dtype
    g = g.to(dt).contiguous()
    # a bf16 step's offset and mask are read as they are (their fp32 values
    # are exact), other dtypes as fp32 copies
    om_bf16 = offset.dtype == mask.dtype == torch.bfloat16
    if om_bf16:
        off, msk = offset.contiguous(), mask.contiguous()
        if (tuple(off.shape) != (b, ho, wo, 2 * k)
                or tuple(msk.shape) != (b, ho, wo, k)):
            raise ValueError(f"offset {tuple(off.shape)}, mask "
                             f"{tuple(msk.shape)}: expected {(b, ho, wo, 2 * k)}"
                             f", {(b, ho, wo, k)}")
    else:
        off = _f32(offset, (b, ho, wo, 2 * k))
        msk = _f32(mask, (b, ho, wo, k))
    with torch.no_grad():  # the dcol product's operand [K * Cin, kpad(Cout)]
        wkn = _nk(weight.reshape(k * cin, cout), dt)
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=x.device)
    dx = torch.empty_like(x)
    doff, dmask = f32(b, ho, wo, 2 * k), f32(b, ho, wo, k)
    dweight = f32(kh, kw, cin, cout)
    dbias = None if bias is None else f32(cout)
    lib = load()
    nbytes = lib.fairm_dcn_bwd_ws(b, h, w, cin, ho, wo, cout, kh, kw,
                                  _DTYPES[dt])
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    _run(lib.fairm_dcn_bwd, _ptr(x), _ptr(off), _ptr(msk), _ptr(wkn), _ptr(g),
         _ptr(ws), _ptr(dx), _ptr(doff), _ptr(dmask), _ptr(dweight),
         _ptr(dbias), nbytes, b, h, w, cin, ho, wo, cout, kh, kw, padding,
         dilation, _DTYPES[dt], int(om_bf16), _stream(x))
    LAUNCHES["dcn_bwd"] += 1
    return dx, doff, dmask, dweight, dbias


def dcn_bwd(x, offset, mask, weight, bias, g, padding: int = 1,
            dilation: int = 1):
    """The backward of :func:`dcn` (no clamp): :func:`dcn_bwd_plain` on a
    CPU tensor, K14 on a CUDA tensor."""
    if x.device.type == "cpu":
        return dcn_bwd_plain(x, offset, mask, weight, bias, g, padding,
                             dilation)
    return dcn_bwd_kernel(x, offset, mask, weight, bias, g, padding, dilation)


class DCNFn(torch.autograd.Function):
    """:func:`dcn` forward (K11 on the card), :func:`dcn_bwd` backward (K14
    on the card). ``bias`` may be None."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, padding, dilation):
        ctx.save_for_backward(x, offset, mask, weight, bias)
        ctx.padding, ctx.dilation = padding, dilation
        return dcn(x, offset, mask, weight, bias, padding, dilation)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        grads = dcn_bwd(*saved, g.contiguous(), ctx.padding, ctx.dilation)
        return (*(d.to(t.dtype) if need and d is not None else None
                  for d, t, need in zip(grads, saved, ctx.needs_input_grad)),
                None, None)
