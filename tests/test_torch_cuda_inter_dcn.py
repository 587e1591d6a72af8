"""The fused cross-band attention K3 and K11's two DCN routes in bf16, on
the card.

Every test here is marked ``cuda`` and skips where there is no NVIDIA GPU.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_inter_dcn.py

K3 fused (bf16, the encoder's widths C = 28, 56, 112) against its plain
twin at 2e-2 (``chip_smoke.py``'s KERNEL_TOL: bf16 rounds at other places
than the twin) and bit for bit against its four passes, which read the
grouped bias from device memory where the fused form forms it from the
per-pair tables (the two share their rounding points and their products'
order; the DropPath scales here, 0 and 2, are exact), shifted and not,
with and without DropPath, one image and a batch that leaves a partial
wave of CTAs (140 groups on 132 SMs). K11 (bf16, the implicit GEMM and
the column route) against ``dcn_plain`` at 2e-2, exact and clamped, at
DGRN's and the deform LeFF's widths and off them. ``chip_smoke.py`` checks the main path's
shapes (phases 3 and 10).
"""

import numpy as np
import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
    deform_conv as dc, windows)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
    lewin_block as lb)

L, WIN, RES = 3, 8, 16
N = WIN * WIN
TOL = 2e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return np.random.default_rng(0)


def _t(rng, *shape, scale=1.0, dtype=torch.float32):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).cuda().to(dtype)


def _check(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item() / max(1.0, want.abs().max().item())
    assert err <= TOL, err


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 35])
@pytest.mark.parametrize("dropped", [False, True])
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("C,heads", [(28, 1), (56, 2), (112, 4)])
def test_fused_inter(card, C, heads, shift, dropped, batch):
    """K3 fused in one launch, no regrouped / qkv rows in device memory:
    against its twin, its passes, the wrapper (its route by
    freq_inter_path) and a second launch."""
    d, LB = C // heads, L * batch
    assert lb.freq_inter_path(C, heads, WIN, torch.bfloat16) == "fused"
    y = _t(card, LB, RES, RES, C, scale=0.5, dtype=torch.bfloat16)
    res = _t(card, LB, RES, RES, C, dtype=torch.bfloat16)
    w = [_t(card, heads, C, d, scale=C ** -0.5) if i % 2 == 0 else
         _t(card, heads, d, scale=0.1) for i in range(6)]
    w += [_t(card, heads, d, C, scale=C ** -0.5), _t(card, C, scale=0.1)]
    pairs = _t(card, L * L, (2 * WIN - 1) ** 2, heads, scale=0.5)
    bias = lb.inter_bias(pairs, L, WIN)
    mask = (torch.from_numpy(windows.shift_attn_mask(RES, RES, WIN, shift))
            .cuda() if shift else None)
    dps = (torch.from_numpy((card.random(LB) < 0.5).astype(np.float32) * 2)
           .cuda() if dropped else None)
    op = lb.attn_operands(*w, bias, torch.bfloat16, pairs)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lb.reset_launches()
    got = lb.freq_inter_kernel(y, res, op, mask, L, WIN, dps, "fused")
    torch.cuda.synchronize()
    assert lb.LAUNCHES["freq_inter"] == 1
    # beyond the output, no buffer (the passes' regrouped and qkv rows would
    # take 5 C + 32 bytes a pixel at least)
    assert (torch.cuda.max_memory_allocated() - base
            <= got.numel() * got.element_size() + 4096)
    _check(got, lb.freq_inter_plain(y, res, *w, bias, mask, L, WIN, 1e-6,
                                    dps))
    passes = lb.freq_inter_kernel(y, res, op, mask, L, WIN, dps, "passes")
    assert torch.equal(got, passes)
    # operands without the tables are refused, whatever the form
    for path in (None, "passes"):
        with pytest.raises(ValueError, match="per-pair tables"):
            lb.freq_inter_kernel(y, res, op._replace(pairs=None), mask, L,
                                 WIN, dps, path)
    assert torch.equal(got, lb.freq_inter(y, res, *w, bias, mask, L, WIN,
                                          1e-6, dps, pairs))
    assert torch.equal(got, lb.freq_inter_kernel(y, res, op, mask, L, WIN,
                                                 dps, "fused"))


@pytest.mark.cuda
def test_fused_inter_refuses_what_it_does_not_take(card):
    """The fused form is a route: asked for at a shape it cannot take
    (head dims above 32, fp32) the launch raises, and so does K3 without
    the per-pair tables."""
    C, heads = 224, 4
    x = _t(card, L, RES, RES, C, dtype=torch.bfloat16)
    w = [_t(card, heads, C, C // heads) if i % 2 == 0 else
         _t(card, heads, C // heads) for i in range(6)]
    w += [_t(card, heads, C // heads, C), _t(card, C)]
    pairs = _t(card, L * L, (2 * WIN - 1) ** 2, heads)
    bias = lb.inter_bias(pairs, L, WIN)
    op = lb.attn_operands(*w, bias, torch.bfloat16, pairs)
    with pytest.raises(RuntimeError, match="fairm_freq_inter"):
        lb.freq_inter_kernel(x, x, op, None, L, WIN, None, "fused")
    op32 = lb.attn_operands(*w, bias, torch.float32, pairs)
    with pytest.raises(RuntimeError, match="fairm_freq_inter"):
        lb.freq_inter_kernel(x.float(), x.float(), op32, None, L, WIN, None,
                             "fused")
    with pytest.raises(ValueError, match="per-pair tables"):
        lb.freq_inter_kernel(x, x, op._replace(pairs=None), None, L, WIN,
                             None, "fused")
    with pytest.raises(ValueError, match="per-pair tables"):
        lb.freq_inter(x, x, *w, bias, None, L, WIN, 1e-6, None)


@pytest.mark.cuda
@pytest.mark.parametrize("clamp", [None, 2.0])
@pytest.mark.parametrize("res,C,cout,dil", [
    (16, 64, 64, 1),      # DGRN's width
    (16, 112, 112, 1),    # the deform LeFF's at res 128
    (8, 224, 224, 1),
    (13, 64, 48, 1),      # 507 pixels: a partial tile; Cout below C
    (12, 112, 200, 2),    # dilation 2, Cout above C and off the tile
    (9, 40, 72, 1),       # C off the 32-column k-tile
    (10, 3, 3, 1),        # single channels (the gather without vectors)
])
def test_dcn_implicit_gemm(card, monkeypatch, res, C, cout, dil, clamp):
    """K11 in bf16 by both routes against dcn_plain, with offsets past every
    edge of the image (up to res + 4 pixels) and the bias: the launcher
    hands the implicit GEMM no column matrix and the column route one; the
    wrapper takes the route dcn_path names."""
    B = 3
    x = _t(card, B, res, res, C, scale=0.5, dtype=torch.bfloat16)
    off = torch.from_numpy(((card.random((B, res, res, 18)) * 2 - 1)
                            * (res + 4)).astype(np.float32)).cuda()
    mask = torch.from_numpy(card.random((B, res, res, 9)).astype(
        np.float32)).cuda()
    w = _t(card, 3, 3, C, cout, scale=(9 * C) ** -0.5, dtype=torch.bfloat16)
    bias = _t(card, cout, scale=0.1)
    run, calls = dc._run, []
    monkeypatch.setattr(dc, "_run", lambda fn, *a: (calls.append(a),
                                                    run(fn, *a)))
    want = dc.dcn_plain(x, off, mask, w, bias, dil, dil, clamp)
    outs = {}
    for path in ("implicit", "columns"):
        calls.clear()
        dc.reset_launches()
        outs[path] = dc.dcn_kernel(x, off, mask, w, bias, dil, dil, clamp,
                                   path)
        torch.cuda.synchronize()
        assert dc.LAUNCHES["dcn"] == 1
        # the cols pointer
        assert len(calls) == 1 and (calls[0][5] is None) == (path == "implicit")
        _check(outs[path], want)
    path = dc.dcn_path(C, cout, torch.bfloat16)
    assert path == ("implicit" if max(C, cout) <= 64 else "columns")
    assert torch.equal(outs[path], dc.dcn(x, off, mask, w, bias, dil, dil,
                                          clamp))
