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
  six times the arithmetic.
* :class:`DCNFn` is the autograd Function: forward K11, backward autograd
  of :func:`dcn_plain` on the saved inputs, as the JAX package's own
  backward is the composite's VJP (``ops/deform_conv.py:120-130``); the
  Pallas package has no backward DCN kernel. On the card that backward
  gathers with ``index_add``, whose float atomics make a step with a
  ``deform_conv`` block not bit-reproducible.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .kernels.lewin_block import _DTYPES, _check, _f32, _nk, _ptr, _run, _stream

LAUNCHES = {"dcn": 0}


def reset_launches() -> None:
    LAUNCHES["dcn"] = 0


def _bilinear_gather(x: torch.Tensor, yy: torch.Tensor,
                     xx: torch.Tensor) -> torch.Tensor:
    """Sample ``x [B, H, W, C]`` at float coordinates ``yy, xx [B, P]``
    with zero padding outside the image: ``[B, P, C]`` in x's dtype. One
    row gather over the four corners stacked on the channel axis, as
    the JAX ``_bilinear_gather`` does it."""
    b, h, w, c = x.shape
    p = yy.shape[1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    hp, wp = h + 1, w + 1
    xc = torch.cat([xp[:, :hp, :wp], xp[:, :hp, 1:], xp[:, 1:, :wp],
                    xp[:, 1:, 1:]], dim=-1).reshape(b * hp * wp, 4 * c)
    # coordinates at or beyond the rim sample the zero pad; the base corner
    # is clipped to H-1 so every gathered row lies inside the padded grid
    yyc = yy.clamp(-1.0, float(h))
    xxc = xx.clamp(-1.0, float(w))
    y0 = torch.floor(yyc).clamp(-1.0, float(h - 1))
    x0 = torch.floor(xxc).clamp(-1.0, float(w - 1))
    fy = (yyc - y0)[..., None].to(x.dtype)
    fx = (xxc - x0)[..., None].to(x.dtype)
    base = (torch.arange(b, device=x.device) * (hp * wp))[:, None]
    idx = (y0 + 1).long() * wp + (x0 + 1).long() + base
    rows = xc[idx.reshape(-1)].reshape(b, p, 4, c)
    return (rows[:, :, 0] * (1 - fy) * (1 - fx)
            + rows[:, :, 1] * (1 - fy) * fx
            + rows[:, :, 2] * fy * (1 - fx)
            + rows[:, :, 3] * fy * fx)


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
    oy = off[..., :k].reshape(b, p, k)
    ox = off[..., k:].reshape(b, p, k)
    m = mask.reshape(b, p, k)
    dev = x.device
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
    sample = _bilinear_gather(x, yy, xx)
    col = sample.reshape(b, p, k, cin) * m[..., None].to(sample.dtype)
    out = torch.matmul(col.reshape(b, p, k * cin).float(),
                       weight.to(x.dtype).reshape(k * cin, cout).float())
    out = out.to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.reshape(b, ho, wo, cout)


def dcn_kernel(x, offset, mask, weight, bias=None, padding: int = 1,
               dilation: int = 1, clamp: Optional[float] = None):
    """Launch K11 on CUDA tensors (arguments as :func:`dcn_plain`)."""
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
    kp = wt.shape[1]
    # the modulated columns, staged through device memory for the GEMM
    cols = torch.empty((b * ho * wo, kp), dtype=dt, device=x.device)
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


class DCNFn(torch.autograd.Function):
    """:func:`dcn` forward (K11 on the card), backward autograd of
    :func:`dcn_plain` on the saved inputs. ``bias`` may be None."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, padding, dilation):
        ctx.save_for_backward(x, offset, mask, weight, bias)
        ctx.padding, ctx.dilation = padding, dilation
        return dcn(x, offset, mask, weight, bias, padding, dilation)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(
                ctx.needs_input_grad[i]) for i, t in enumerate(saved)]
            out = dcn_plain(*inputs, ctx.padding, ctx.dilation)
            want = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, want, g) if want else ())
        return (*(next(grads) if t is not None and t.requires_grad else None
                  for t in inputs), None, None)
