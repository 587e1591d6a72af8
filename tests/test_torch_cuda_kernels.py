"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here is marked ``cuda`` and skips where there is no NVIDIA GPU.
This file imports neither JAX nor the JAX package, so it also runs on a
machine without them; there ``tests/conftest.py`` (which imports JAX) is
left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Small shapes with every option on (SW-MSA shift, all_DC ``lam``, DropPath
``dps``, L=3 bands); ``chip_smoke.py`` checks the flagship shapes. The
backward kernels K6-K8 are held against their plain twins output by output,
and the autograd Functions against ``torch.autograd.grad`` of the forward
twins.
"""

import numpy as np
import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    uformer_lewin)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
    windows)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
    lewin_block as lb)

B, RES, C, H, L, WIN = 2, 16, 16, 2, 3, 8
N = WIN * WIN
# max|kernel - plain| / max(1, max|plain|): fp32 differs only in the order
# of summation; bf16 rounds at other places than the plain twin
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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


def _attn(rng, batch, dtype, groups=1):
    d = C // H
    qkv = [_t(rng, H, C, d, scale=0.2) if i % 2 == 0 else
           _t(rng, H, d, scale=0.1) for i in range(6)]
    bias = (_t(rng, groups, H, N, N, scale=0.05) if groups > 1 else
            _t(rng, H, N, N, scale=0.05))
    return ([_t(rng, batch, RES, RES, C, scale=0.5, dtype=dtype),
             1.0 + _t(rng, C, scale=0.1), _t(rng, C, scale=0.1)] + qkv
            + [_t(rng, H, d, C, scale=0.2), _t(rng, C, scale=0.1), bias])


def _mask():
    return torch.from_numpy(windows.shift_attn_mask(RES, RES, WIN, 4)).cuda()


def _dps(rng, n):
    return torch.from_numpy((rng.random(n) < 0.5).astype(np.float32) * 2).cuda()


def _check(got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item() / max(1.0, want.abs().max().item())
    assert err <= TOL[dtype], err


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_block_attention_kernel(card, dtype):
    args = _attn(card, B, dtype) + [_mask(), _t(card, B, H, scale=0.3), WIN,
                                    1e-6, _dps(card, B)]
    lb.reset_launches()
    got = lb.block_attention(*args)
    assert lb.LAUNCHES["lewin_attn"] == 1
    _check(got, lb.block_attention_plain(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_freq_intra_kernel(card, dtype):
    args = _attn(card, L * B, dtype, groups=L) + [_mask(), L, WIN, 1e-6]
    _check(lb.freq_intra(*args), lb.freq_intra_plain(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_freq_inter_kernel(card, dtype):
    a = _attn(card, L * B, dtype)
    args = ([a[0], _t(card, L * B, RES, RES, C, dtype=dtype)] + a[3:11]
            + [_t(card, H, L * N, L * N, scale=0.05), _mask(), L, WIN, 1e-6,
               _dps(card, L * B)])
    _check(lb.freq_inter(*args), lb.freq_inter_plain(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_block_ffn_kernel(card, dtype):
    hd = 4 * C
    args = [_t(card, B, RES, RES, C, scale=0.5, dtype=dtype),
            1.0 + _t(card, C, scale=0.1), _t(card, C, scale=0.1),
            _t(card, C, hd, scale=0.2), _t(card, hd, scale=0.1),
            _t(card, 3, 3, hd, scale=0.2), _t(card, hd, scale=0.1),
            _t(card, hd, C, scale=0.2), _t(card, C, scale=0.1), 1e-6,
            _dps(card, B)]
    _check(lb.block_ffn(*args), lb.block_ffn_plain(*args), dtype)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(card):
    args = _attn(card, B, torch.float16)
    with pytest.raises(TypeError):
        lb.block_attention(*args, None, None)
    x = _attn(card, B, torch.float32)
    x[0] = x[0].transpose(1, 2)          # not contiguous
    with pytest.raises(ValueError):
        lb.block_attention(*x, None, None)


@pytest.mark.cuda
@pytest.mark.parametrize("msa", ["origin", "freq"])
def test_block_kernels_follow_a_weight_reload(card, msa):
    """A LeWin block through the kernels, with its cached operands, matches
    the plain block before and after new weights are loaded."""
    kw = (dict(all_bands_dc=True, encoder_embed_dim=4) if msa == "origin"
          else dict(msa_type="freq", L=L))
    blocks = [uformer_lewin.LeWinBlock(C, RES, H, shift_size=4, impl=impl,
                                       **kw).cuda().eval()
              for impl in ("kernel", "plain")]
    batch = B if msa == "origin" else L * B
    x = _t(card, batch, RES * RES, C, scale=0.5)
    inter = [_t(card, batch, 4, 64) for _ in range(3)]
    for _ in range(2):
        state = {k: _t(card, *v.shape, scale=0.2)
                 for k, v in blocks[0].state_dict().items()}
        for blk in blocks:
            blk.load_state_dict(state)
        lb.reset_launches()
        with torch.no_grad():
            got, want = (blk(x, inter) for blk in blocks)
        assert lb.LAUNCHES["lewin_ffn"] == 1
        _check(got, want, torch.float32)


def _ffn_w(rng):
    hd = 4 * C
    return [_t(rng, C, hd, scale=0.2), _t(rng, hd, scale=0.1),
            _t(rng, 3, 3, hd, scale=0.2), _t(rng, hd, scale=0.1),
            _t(rng, hd, C, scale=0.2), _t(rng, C, scale=0.1)]


def _ln(rng):
    return [1.0 + _t(rng, C, scale=0.1), _t(rng, C, scale=0.1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("dtype", DTYPES)
def test_block_merged_kernel(card, dtype, shift):
    """K4 in one launch: against its twin, and equal to the chain of K1 and
    K2 around torch.roll."""
    args = (_attn(card, B, dtype)
            + [_mask() if shift else None, _t(card, B, H, scale=0.3)]
            + _ln(card) + _ffn_w(card)
            + [WIN, shift, 1e-6, _dps(card, B), _dps(card, B)])
    lb.reset_launches()
    got = lb.block_merged(*args)
    assert lb.LAUNCHES["lewin_merged"] == 1 and sum(lb.LAUNCHES.values()) == 1
    _check(got, lb.block_merged_plain(*args), dtype)
    chain = lb.merged_chain(lb.block_attention, lb.block_ffn, *args)
    assert torch.equal(got, chain)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("dtype", DTYPES)
def test_block_freq_merged_kernel(card, dtype, shift):
    """K5 in one launch: against its twin, and equal to the chain of K1,
    K3 and K2 around torch.roll."""
    a = _attn(card, L * B, dtype, groups=L)
    b = _attn(card, L * B, dtype)
    args = (a + b[3:11] + [_t(card, H, L * N, L * N, scale=0.05),
                           _mask() if shift else None]
            + _ln(card) + _ffn_w(card)
            + [L, WIN, shift, 1e-6, _dps(card, L * B), _dps(card, L * B)])
    lb.reset_launches()
    got = lb.block_freq_merged(*args)
    assert lb.LAUNCHES["freq_merged"] == 1 and sum(lb.LAUNCHES.values()) == 1
    _check(got, lb.block_freq_merged_plain(*args), dtype)
    chain = lb.freq_merged_chain(lb.freq_intra, lb.freq_inter, lb.block_ffn,
                                 *args)
    assert torch.equal(got, chain)


@pytest.mark.cuda
@pytest.mark.parametrize("msa", ["origin", "freq"])
def test_merged_block_matches_the_chain_block(card, msa):
    """LeWinBlock(impl='merged') is one launch and equals impl='kernel'."""
    kw = (dict(all_bands_dc=True, encoder_embed_dim=4) if msa == "origin"
          else dict(msa_type="freq", L=L))
    blocks = [uformer_lewin.LeWinBlock(C, RES, H, shift_size=4, impl=impl,
                                       **kw).cuda().eval()
              for impl in ("merged", "kernel")]
    state = {k: _t(card, *v.shape, scale=0.2)
             for k, v in blocks[0].state_dict().items()}
    for blk in blocks:
        blk.load_state_dict(state)
    batch = B if msa == "origin" else L * B
    x = _t(card, batch, RES * RES, C, scale=0.5)
    inter = [_t(card, batch, 4, 64) for _ in range(3)]
    lb.reset_launches()
    with torch.no_grad():
        got = blocks[0](x, inter)
        assert sum(lb.LAUNCHES.values()) == 1
        want = blocks[1](x, inter)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [5, 6, 10])
@pytest.mark.parametrize("dtype", DTYPES)
def test_merged_kernels_at_widths_off_the_vector_paths(card, monkeypatch,
                                                       dtype, width):
    """Widths that are no multiple of 4 take the element-wise forms of the
    prep pass, the GEMM epilogue and (C=5, bf16) the depthwise conv: K4 and
    K5 still match their twins and equal the chains."""
    monkeypatch.setitem(globals(), "C", width)
    monkeypatch.setitem(globals(), "H", 1)
    args = (_attn(card, B, dtype) + [_mask(), _t(card, B, 1, scale=0.3)]
            + _ln(card) + _ffn_w(card)
            + [WIN, 4, 1e-6, _dps(card, B), _dps(card, B)])
    got = lb.block_merged(*args)
    _check(got, lb.block_merged_plain(*args), dtype)
    assert torch.equal(got, lb.merged_chain(lb.block_attention, lb.block_ffn,
                                            *args))
    a = _attn(card, L * B, dtype, groups=L)
    b = _attn(card, L * B, dtype)
    args = (a + b[3:11] + [_t(card, 1, L * N, L * N, scale=0.05), _mask()]
            + _ln(card) + _ffn_w(card)
            + [L, WIN, 4, 1e-6, _dps(card, L * B), _dps(card, L * B)])
    got = lb.block_freq_merged(*args)
    _check(got, lb.block_freq_merged_plain(*args), dtype)
    assert torch.equal(got, lb.freq_merged_chain(
        lb.freq_intra, lb.freq_inter, lb.block_ffn, *args))


# ---------------------------------------------------------------------------
# backward kernels K6 - K8
# ---------------------------------------------------------------------------


def _check_all(got, want, dtype):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if a is None or b is None:
            assert a is None and b is None
            continue
        _check(a, b, a.dtype if a.dtype == torch.bfloat16 else dtype)


def _grad(rng, like):
    return _t(rng, *like.shape, scale=0.5, dtype=like.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("options", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attn_block_bwd_kernel(card, dtype, options):
    """K6 against its twin: dx and every weight gradient, with and without
    the mask and lam; two launches give equal bits."""
    a = _attn(card, B, dtype)
    extra = ([_mask(), _t(card, B, H, scale=0.3)] if options else [None, None])
    args = [a[0], _grad(card, a[0])] + a[1:] + extra + [WIN, 1e-6, True, 1]
    lb.reset_launches()
    got = lb.attn_block_bwd(*args)
    assert lb.LAUNCHES["lewin_attn_bwd"] == 1
    _check_all(got, lb.attn_block_bwd_plain(*args), dtype)
    again = lb.attn_block_bwd(*args)
    assert all(torch.equal(p, q) for p, q in zip(got, again) if p is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_freq_intra_bwd_kernel(card, dtype):
    """K6 with per-band bias tables and no residual."""
    a = _attn(card, L * B, dtype, groups=L)
    args = [a[0], _grad(card, a[0])] + a[1:] + [_mask(), None, WIN, 1e-6,
                                               False, L]
    _check_all(lb.attn_block_bwd(*args), lb.attn_block_bwd_plain(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_freq_inter_bwd_kernel(card, dtype, masked):
    a = _attn(card, L * B, dtype)
    args = ([a[0], _grad(card, a[0])] + a[3:11]
            + [_t(card, H, L * N, L * N, scale=0.05),
               _mask() if masked else None, L, WIN])
    lb.reset_launches()
    got = lb.freq_inter_bwd(*args)
    assert lb.LAUNCHES["freq_inter_bwd"] == 1
    _check_all(got, lb.freq_inter_bwd_plain(*args), dtype)
    assert all(torch.equal(p, q)
               for p, q in zip(got, lb.freq_inter_bwd(*args)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_ffn_block_bwd_kernel(card, dtype):
    x = _t(card, B, RES, RES, C, scale=0.5, dtype=dtype)
    args = [x, _grad(card, x)] + _ln(card) + _ffn_w(card) + [1e-6]
    lb.reset_launches()
    got = lb.ffn_block_bwd(*args)
    assert lb.LAUNCHES["lewin_ffn_bwd"] == 1
    _check_all(got, lb.ffn_block_bwd_plain(*args), dtype)
    assert all(torch.equal(p, q)
               for p, q in zip(got, lb.ffn_block_bwd(*args)))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [5, 6, 10])
@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_kernels_at_widths_off_the_vector_paths(card, monkeypatch,
                                                         dtype, width):
    monkeypatch.setitem(globals(), "C", width)
    monkeypatch.setitem(globals(), "H", 1)
    a = _attn(card, L * B, dtype, groups=L)
    args = [a[0], _grad(card, a[0])] + a[1:] + [_mask(), None, WIN, 1e-6,
                                               False, L]
    _check_all(lb.attn_block_bwd(*args), lb.attn_block_bwd_plain(*args), dtype)
    a = _attn(card, L * B, dtype)
    args = ([a[0], _grad(card, a[0])] + a[3:11]
            + [_t(card, 1, L * N, L * N, scale=0.05), _mask(), L, WIN])
    _check_all(lb.freq_inter_bwd(*args), lb.freq_inter_bwd_plain(*args), dtype)
    x = _t(card, B, RES, RES, C, scale=0.5, dtype=dtype)
    args = [x, _grad(card, x)] + _ln(card) + _ffn_w(card) + [1e-6]
    _check_all(lb.ffn_block_bwd(*args), lb.ffn_block_bwd_plain(*args), dtype)


def _leaves(args):
    return [a.requires_grad_() if torch.is_tensor(a) and a.is_floating_point()
            else a for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 4])
def test_functions_match_autograd_of_the_forward_twins(card, shift):
    """BlockMerged / BlockFreqMerged (K4 / K5 forward; K7, K8, K6 backward)
    in float32 against torch.autograd.grad of the plain forward, every
    input's gradient, DropPath and lam on."""
    dtype = torch.float32
    mask = _mask() if shift else None
    args = _leaves(_attn(card, B, dtype)) + [mask] + _leaves(
        [_t(card, B, H, scale=0.3)] + _ln(card) + _ffn_w(card)) + [
        WIN, shift, 1e-6, _dps(card, B), _dps(card, B)]
    diff = [a for a in args if torch.is_tensor(a) and a.requires_grad]
    g = _grad(card, args[0])
    lb.reset_launches()
    got = torch.autograd.grad(lb.BlockMerged.apply(*args), diff, g)
    assert (lb.LAUNCHES["lewin_merged"], lb.LAUNCHES["lewin_ffn_bwd"],
            lb.LAUNCHES["lewin_attn_bwd"]) == (1, 1, 1)
    want = torch.autograd.grad(lb.block_merged_plain(*args), diff, g)
    _check_all(got, want, dtype)

    a = _attn(card, L * B, dtype, groups=L)
    b = _attn(card, L * B, dtype)
    args = _leaves(a + b[3:11] + [_t(card, H, L * N, L * N, scale=0.05)]) + [
        mask] + _leaves(_ln(card) + _ffn_w(card)) + [
        L, WIN, shift, 1e-6, _dps(card, L * B), _dps(card, L * B)]
    diff = [t for t in args if torch.is_tensor(t) and t.requires_grad]
    g = _grad(card, args[0])
    lb.reset_launches()
    got = torch.autograd.grad(lb.BlockFreqMerged.apply(*args), diff, g)
    assert (lb.LAUNCHES["freq_merged"], lb.LAUNCHES["lewin_ffn_bwd"],
            lb.LAUNCHES["freq_inter_bwd"], lb.LAUNCHES["lewin_attn_bwd"]) == (
                1, 1, 1, 1)
    want = torch.autograd.grad(lb.block_freq_merged_plain(*args), diff, g)
    _check_all(got, want, dtype)
