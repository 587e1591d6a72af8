"""The port's LeWin-block entry points (ops/kernels/lewin_block.py).

On the CPU each wrapper runs its plain twin; the plain twins are held to
the JAX package's XLA composites (``_xla_block_attention`` and friends) and
to the Pallas kernels run in interpret mode, with the per-row-max softmax
(``FAIRM_STATIC_SHIFT=off``). Inputs come from numpy seeds. The CUDA
kernels themselves are held to the plain twins on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu.ops import (
    windows as jwin)
from frequency_wised_all_in_one_image_restoration_model_tpu.ops.pallas import (
    lewin_block as jlb)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
    build, lewin_block as tlb)

B, RES, C, H, L, WIN = 2, 16, 16, 2, 3, 8
N = WIN * WIN
TOL = 1e-5        # fp32, per module
BF16_TOL = 2e-2   # bf16 rounds q/k/v and the output (a few ulps of O(1))


@pytest.fixture(autouse=True)
def _row_max_softmax(monkeypatch):
    monkeypatch.setenv("FAIRM_STATIC_SHIFT", "off")


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _attn_np(rng, batch, groups=1):
    d = C // H
    qkv = [_np(rng, H, C, d, scale=0.2) if i % 2 == 0 else
           _np(rng, H, d, scale=0.1) for i in range(6)]
    bias_shape = (groups, H, N, N) if groups > 1 else (H, N, N)
    return ([_np(rng, batch, RES, RES, C, scale=0.5),
             1.0 + _np(rng, C, scale=0.1), _np(rng, C, scale=0.1)]
            + qkv + [_np(rng, H, d, C, scale=0.2), _np(rng, C, scale=0.1),
                     _np(rng, *bias_shape, scale=0.05)])


def _ffn_np(rng, batch=B):
    hd = 4 * C
    return [_np(rng, batch, RES, RES, C, scale=0.5),
            1.0 + _np(rng, C, scale=0.1), _np(rng, C, scale=0.1),
            _np(rng, C, hd, scale=0.2), _np(rng, hd, scale=0.1),
            _np(rng, 3, 3, hd, scale=0.2), _np(rng, hd, scale=0.1),
            _np(rng, hd, C, scale=0.2), _np(rng, C, scale=0.1)]


def _mask(shift):
    return jwin.shift_attn_mask(RES, RES, WIN, shift) if shift else None


def _dps(rng, n, on):
    return (rng.random(n) < 0.5).astype(np.float32) / 0.5 if on else None


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a).astype(dtype)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("use_dps", [False, True])
@pytest.mark.parametrize("use_lam", [False, True])
@pytest.mark.parametrize("shift", [0, 4])
def test_block_attention_plain_matches_xla(rng, shift, use_lam, use_dps):
    args = _attn_np(rng, B)
    mask = _mask(shift)
    lam = _np(rng, B, H, scale=0.3) if use_lam else None
    dps = _dps(rng, B, use_dps)
    got = tlb.block_attention_plain(*map(_t, args), _t(mask), _t(lam), WIN,
                                    1e-6, _t(dps))
    want = jlb._xla_block_attention(*map(_j, args), _j(mask), _j(lam), WIN,
                                    1e-6, dps=_j(dps))
    _close(got, want)


@pytest.mark.parametrize("shift,use_lam,use_dps", [(0, False, False),
                                                   (4, True, True)])
def test_block_attention_plain_matches_pallas(rng, shift, use_lam, use_dps):
    args = _attn_np(rng, B)
    mask = _mask(shift)
    lam = _np(rng, B, H, scale=0.3) if use_lam else None
    dps = _dps(rng, B, use_dps)
    got = tlb.block_attention(*map(_t, args), _t(mask), _t(lam), WIN, 1e-6,
                              _t(dps))
    want = jlb.fused_block_attention(*map(_j, args), _j(mask), _j(lam), WIN,
                                     1e-6, True, _j(dps))
    _close(got, want)


def test_block_attention_plain_bf16_matches_xla(rng):
    args = _attn_np(rng, B)
    lam = _np(rng, B, H, scale=0.3)
    x = [_t(args[0], torch.bfloat16)] + [_t(a) for a in args[1:]]
    got = tlb.block_attention_plain(*x, _t(_mask(4)), _t(lam), WIN, 1e-6)
    xj = [_j(args[0], jnp.bfloat16)] + [_j(a) for a in args[1:]]
    want = jlb._xla_block_attention(*xj, _j(_mask(4)), _j(lam), WIN, 1e-6)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("shift", [0, 4])
def test_freq_intra_plain_matches_jax(rng, shift, pallas):
    args = _attn_np(rng, L * B, groups=L)
    mask = _mask(shift)
    got = tlb.freq_intra(*map(_t, args), _t(mask), L, WIN, 1e-6)
    if pallas:
        want = jlb.fused_freq_intra(*map(_j, args), _j(mask), L, WIN, 1e-6,
                                    True)
    else:
        want = jlb._xla_freq_intra(*map(_j, args), _j(mask), L, WIN, 1e-6)
    _close(got, want)


def _inter_np(rng, use_dps):
    args = _attn_np(rng, L * B)
    y, qkv_proj = args[0], args[3:11]
    res = _np(rng, L * B, RES, RES, C)
    bias = _np(rng, H, L * N, L * N, scale=0.05)
    return y, res, qkv_proj, bias, _dps(rng, L * B, use_dps)


@pytest.mark.parametrize("use_dps", [False, True])
@pytest.mark.parametrize("shift", [0, 4])
def test_freq_inter_plain_matches_xla(rng, shift, use_dps):
    y, res, w, bias, dps = _inter_np(rng, use_dps)
    mask = _mask(shift)
    got = tlb.freq_inter_plain(_t(y), _t(res), *map(_t, w), _t(bias),
                               _t(mask), L, WIN, 1e-6, _t(dps))
    # the composite has no dps: res + dps * branch, branch with res = 0
    branch = jlb._xla_freq_inter(_j(y), jnp.zeros_like(_j(res)), *map(_j, w),
                                 _j(bias), _j(mask), L, WIN, 1e-6)
    scale = 1.0 if dps is None else dps[:, None, None, None]
    _close(got, res + scale * np.asarray(branch))


@pytest.mark.parametrize("shift,use_dps", [(0, False), (4, True)])
def test_freq_inter_plain_matches_pallas(rng, shift, use_dps):
    y, res, w, bias, dps = _inter_np(rng, use_dps)
    mask = _mask(shift)
    got = tlb.freq_inter(_t(y), _t(res), *map(_t, w), _t(bias), _t(mask), L,
                         WIN, 1e-6, _t(dps))
    want = jlb.fused_freq_inter(_j(y), _j(res), *map(_j, w), _j(bias),
                                _j(mask), L, WIN, 1e-6, True, _j(dps))
    _close(got, want)


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("use_dps", [False, True])
def test_block_ffn_plain_matches_jax(rng, use_dps, pallas):
    args = _ffn_np(rng)
    dps = _dps(rng, B, use_dps)
    got = tlb.block_ffn(*map(_t, args), 1e-6, _t(dps))
    if pallas:
        want = jlb.fused_block_ffn(*map(_j, args), 1e-6, True, _j(dps))
    else:
        want = jlb._xla_block_ffn(*map(_j, args), 1e-6, dps=_j(dps))
    _close(got, want)


def test_block_ffn_plain_bf16_matches_xla(rng):
    args = _ffn_np(rng)
    got = tlb.block_ffn_plain(_t(args[0], torch.bfloat16),
                              *map(_t, args[1:]), 1e-6)
    want = jlb._xla_block_ffn(_j(args[0], jnp.bfloat16), *map(_j, args[1:]),
                              1e-6)
    _close(got, want, BF16_TOL)


def test_cpu_tensors_take_the_plain_twin(rng):
    """A wrapper given CPU tensors runs its plain twin, bit for bit, and
    counts no kernel launch."""
    tlb.reset_launches()
    args = list(map(_t, _attn_np(rng, B)))
    mask, lam = _t(_mask(4)), _t(_np(rng, B, H, scale=0.3))
    torch.testing.assert_close(
        tlb.block_attention(*args, mask, lam),
        tlb.block_attention_plain(*args, mask, lam), rtol=0, atol=0)
    fargs = list(map(_t, _ffn_np(rng)))
    torch.testing.assert_close(tlb.block_ffn(*fargs),
                               tlb.block_ffn_plain(*fargs), rtol=0, atol=0)
    torch.testing.assert_close(
        tlb.block_attention_split(*args, mask, lam),
        tlb.lewin_attn_split_plain(*args, mask, lam), rtol=0, atol=0)
    torch.testing.assert_close(tlb.block_ffn_split(*fargs),
                               tlb.lewin_ffn_split_plain(*fargs), rtol=0,
                               atol=0)
    assert set(tlb.LAUNCHES) == {"lewin_attn", "lewin_ffn", "freq_inter",
                                 "lewin_merged", "freq_merged",
                                 "lewin_attn_split", "lewin_ffn_split",
                                 "lewin_attn_bwd", "lewin_ffn_bwd",
                                 "freq_inter_bwd"}
    assert not any(tlb.LAUNCHES.values())


def test_attn_operands_hold_the_per_head_weights(rng):
    """K1 / K3's operands: the qkv rows give q * d^-0.5, k and v of the
    per-head weights, the proj rows give the per-head proj; the padding
    columns up to kpad(C) are zero."""
    a = list(map(_t, _attn_np(rng, B)))
    x, (wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp, bias) = a[0], a[3:12]
    op = tlb.attn_operands(wq3, bq3, wk3, bk3, wv3, bv3, wp3, bp, bias,
                           torch.float32)
    d, kp = C // H, tlb.kpad(C)
    assert op.heads == H and op.wqkv.shape == (3 * C, kp)
    assert op.wp.shape == (C, kp) and not op.wqkv[:, C:].any()
    assert not op.wp[:, C:].any()
    tok = x.reshape(-1, C)
    got = tok @ op.wqkv[:, :C].T + op.bqkv
    want = [torch.einsum("mc,hcd->mhd", tok, w) + b
            for w, b in ((wq3, bq3), (wk3, bk3), (wv3, bv3))]
    want[0] = want[0] * d ** -0.5
    _close(got, torch.cat([w.reshape(-1, C) for w in want], 1))
    o = torch.from_numpy(_np(rng, 8, H, d))
    _close(o.reshape(8, C) @ op.wp[:, :C].T + op.bp,
           torch.einsum("mhd,hdc->mc", o, wp3) + bp)
    torch.testing.assert_close(op.bias, bias, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_operands_hold_the_weights(rng, dtype):
    """K2's operands: N x K GEMM operands in the compute dtype, zero-padded
    to kpad(K); taps and biases in fp32."""
    _, _, _, w1, b1, wd, bd, w2, b2 = map(_t, _ffn_np(rng))
    op = tlb.ffn_operands(w1, b1, wd, bd, w2, b2, dtype)
    hd = 4 * C
    assert op.w1.shape == (hd, tlb.kpad(C)) and op.w1.dtype == dtype
    assert op.w2.shape == (C, tlb.kpad(hd)) and op.w2.dtype == dtype
    assert not op.w1[:, C:].any()
    torch.testing.assert_close(op.w1[:, :C], w1.T.to(dtype), rtol=0, atol=0)
    torch.testing.assert_close(op.w2[:, :hd], w2.T.to(dtype), rtol=0, atol=0)
    for got, want in ((op.b1, b1), (op.wd, wd), (op.bd, bd), (op.b2, b2)):
        assert got.dtype == torch.float32 and got.is_contiguous()
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_build_targets_hopper_and_tracks_sources(tmp_path, monkeypatch):
    cmd = build.compile_command(build.CSRC / "lewin_attn.cu", tmp_path / "a.o") \
        if build.shutil.which("nvcc") else None
    flags = build.ARCH + build.FLAGS
    assert "arch=compute_90a,code=sm_90a" in flags and "-O3" in flags
    assert cmd is None or cmd[1:len(flags) + 1] == flags
    assert {p.name for p in build.sources()} == {
        "lewin_attn.cu", "lewin_ffn.cu", "freq_inter.cu", "lewin_merged.cu",
        "freq_merged.cu", "lewin_attn_bwd.cu", "lewin_ffn_bwd.cu",
        "freq_inter_bwd.cu", "window_attn.cu", "window_attn_bwd.cu", "dcn.cu",
        "lewin_attn_split.cu", "lewin_ffn_split.cu", "dcn_bwd.cu"}
    # the library directory is named by a hash of every csrc file
    for p in build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.source_hash()
    (tmp_path / "gemm.cuh").write_text("// changed\n")
    assert build.source_hash() != before


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No toolkit, no library: the build raises, nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
