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
twins; K8 and the fused K2 also at the edges of their tiles and chunks.
"""

import functools

import numpy as np
import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    uformer_lewin)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
    windows)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
    build, lewin_block as lb)

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


def _inter_bias(rng, heads):
    """The grouped 'inter' bias [h, L*n, L*n] and the per-pair tables it was
    made from, which K3 reads."""
    pairs = _t(rng, L * L, (2 * WIN - 1) ** 2, heads, scale=0.05)
    return lb.inter_bias(pairs, L, WIN), pairs


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
    biasB, pairs = _inter_bias(card, H)
    args = ([a[0], _t(card, L * B, RES, RES, C, dtype=dtype)] + a[3:11]
            + [biasB, _mask(), L, WIN, 1e-6, _dps(card, L * B)])
    _check(lb.freq_inter(*args, pairs), lb.freq_inter_plain(*args), dtype)


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


def _check_chain(got, chain, dtype):
    """K4 / K5 against the chain of kernels they equal, bit for bit in both
    dtypes: K4 / K5 keep the LeFF's hidden in fp32 from fc1 through the
    conv and round it once, after the conv's GELU, as the chain's K2 does
    (fused on the SM at this width in bf16, its passes elsewhere) and as
    JAX does; the chain's fused K3 equals its passes bit for bit."""
    assert got.dtype == dtype
    assert torch.equal(got, chain)


# F2: the kernels that keep the LeFF's hidden in device memory (K2's passes,
# K13, K4, K5) keep it in fp32 from fc1 through the conv, as JAX does. The
# inputs below make a bf16 rounding of it show: fc1's outputs sit near 100
# (bf16 spacing 0.5) and vary by less than 1, and the conv's taps cancel
# (centre 1, the eight others -1/8), so the conv's output away from the
# image's rim is a small difference of large values. A twin that rounds the
# hidden after fc1, as the kernels did before, misses the plain twin there
# by some 0.1-0.3; the kernels by their own bf16 rounding of the conv's
# output and of the block's output (a few 1e-3). F2_FACTOR = 4 asks the
# kernel to be four times closer than that twin: the parent's kernels,
# which rounded as the twin does, miss by the twin's error.
F2_FACTOR = 4.0


def _f2_ffn_w(rng, c):
    return lb.f2_ffn_weights(c, lambda *shape, scale=1.0: _t(rng, *shape,
                                                               scale=scale))


def _f2_args(rng, kernel):
    """(wrapper, plain twin, hidden-rounded twin, chain of kernels or None,
    arguments, launch counter) of one F2 case, bf16."""
    bf = torch.bfloat16
    ones = lambda c: [torch.ones(c).cuda(), torch.zeros(c).cuda()]
    if kernel in ("passes", "split"):
        c = 448                     # K2 runs its passes at C = 448
        args = ([_t(rng, B, RES // 2, RES // 2, c, scale=0.5, dtype=bf)]
                + ones(c) + _f2_ffn_w(rng, c) + [1e-6, _dps(rng, B)])
        if kernel == "passes":
            return (lb.block_ffn, lb.block_ffn_plain,
                    lb.ffn_rounded_hidden_plain, None, args, "lewin_ffn")
        return (lb.block_ffn_split, lb.lewin_ffn_split_plain,
                lb.ffn_rounded_hidden_plain, None, args, "lewin_ffn_split")
    if kernel == "merged":
        a = _attn(rng, B, bf)
        args = (a[:1] + ones(C) + a[3:] + [_mask(), _t(rng, B, H, scale=0.3)]
                + ones(C) + _f2_ffn_w(rng, C) + [WIN, 4, 1e-6, None, None])
        return (lb.block_merged, lb.block_merged_plain,
                lambda *x: lb.merged_chain(lb.block_attention_plain,
                                           lb.ffn_rounded_hidden_plain, *x),
                lambda *x: lb.merged_chain(lb.block_attention, lb.block_ffn,
                                           *x), args, "lewin_merged")
    a = _attn(rng, L * B, bf, groups=L)
    b = _attn(rng, L * B, bf)
    biasB, pairs = _inter_bias(rng, H)
    args = (a[:1] + ones(C) + a[3:] + b[3:11] + [biasB, _mask()] + ones(C)
            + _f2_ffn_w(rng, C) + [L, WIN, 4, 1e-6, None, None])
    run = (functools.partial(lb.block_freq_merged, pairs=pairs)
           if kernel == "freq_merged"
           else _freq_merged_as("phases", _freq_operands(args, pairs)))
    return (run, lb.block_freq_merged_plain,
            lambda *x: lb.freq_merged_chain(lb.freq_intra_plain,
                                            lb.freq_inter_plain,
                                            lb.ffn_rounded_hidden_plain, *x),
            lambda *x: lb.freq_merged_chain(
                lb.freq_intra, functools.partial(lb.freq_inter, pairs=pairs),
                lb.block_ffn, *x),
            args, "freq_merged")


def _freq_merged_as(path, ops):
    """:func:`lb.block_freq_merged` on the card with the operands ``ops``
    (:func:`_freq_operands`), its form forced to ``path`` ('group' or
    'phases'), on the entry point's arguments."""
    def run(x, ln1s, ln1b, *rest):
        mask, ln2s, ln2b = rest[18:21]
        L_, win, shift, eps, dps1, dps2 = rest[27:]
        return lb.freq_merged_kernel(x, ln1s, ln1b, ops[0], ops[1], mask, ln2s,
                                     ln2b, ops[2], L_, win, shift, eps, dps1,
                                     dps2, path=path)
    return run


def _freq_operands(args, pairs):
    """K5's operands (intra, inter with the per-pair tables, LeFF) from the
    entry point's arguments."""
    dt = args[0].dtype
    return (lb.attn_operands(*args[3:12], dt),
            lb.attn_operands(*args[12:21], dt, pairs),
            lb.ffn_operands(*args[24:30], dt))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["passes", "split", "merged", "freq_merged",
                                    "freq_merged_phases"])
def test_leff_hidden_kept_in_fp32(card, kernel):
    """K2's passes, K13, K4 and K5 (both forms) in bf16 are F2_FACTOR times
    closer to their plain twins (and K4 / K5 to the chain of kernels) than
    a twin that rounds the LeFF's hidden to bf16 after fc1, away from the
    rim."""
    run, plain, rounded, chain, args, counter = _f2_args(card, kernel)
    lb.reset_launches()
    got = run(*args)
    torch.cuda.synchronize()
    assert lb.LAUNCHES[counter] == 1
    want = plain(*args)
    _check(got, want, torch.bfloat16)
    inner = (slice(None), slice(1, -1), slice(1, -1))
    err = lambda t, ref: (t.float() - ref.float())[inner].abs().max().item()
    bad = err(rounded(*args), want)
    assert err(got, want) * F2_FACTOR <= bad, (err(got, want), bad)
    if chain is not None:
        ref = chain(*args)
        assert err(got, ref) * F2_FACTOR <= err(rounded(*args), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("dtype", DTYPES)
def test_block_merged_kernel(card, dtype, shift):
    """K4 in one launch: against its twin, and equal to the chain of K1 and
    K2 around torch.roll (:func:`_check_chain`)."""
    args = (_attn(card, B, dtype)
            + [_mask() if shift else None, _t(card, B, H, scale=0.3)]
            + _ln(card) + _ffn_w(card)
            + [WIN, shift, 1e-6, _dps(card, B), _dps(card, B)])
    lb.reset_launches()
    got = lb.block_merged(*args)
    assert lb.LAUNCHES["lewin_merged"] == 1 and sum(lb.LAUNCHES.values()) == 1
    _check(got, lb.block_merged_plain(*args), dtype)
    chain = lb.merged_chain(lb.block_attention, lb.block_ffn, *args)
    _check_chain(got, chain, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("dtype,path", [(torch.float32, None),
                                        (torch.bfloat16, None),
                                        (torch.bfloat16, "phases")])
def test_block_freq_merged_kernel(card, dtype, path, shift):
    """K5 in one launch: against its twin, and equal to the chain of K1,
    K3 and K2 around torch.roll (:func:`_check_chain`); in bf16 by the form
    freq_merged_path chooses (the band groups) and by the twelve phases."""
    a = _attn(card, L * B, dtype, groups=L)
    b = _attn(card, L * B, dtype)
    biasB, pairs = _inter_bias(card, H)
    args = (a + b[3:11] + [biasB, _mask() if shift else None]
            + _ln(card) + _ffn_w(card)
            + [L, WIN, shift, 1e-6, _dps(card, L * B), _dps(card, L * B)])
    run = (functools.partial(lb.block_freq_merged, pairs=pairs) if path is None
           else _freq_merged_as(path, _freq_operands(args, pairs)))
    lb.reset_launches()
    got = run(*args)
    assert lb.LAUNCHES["freq_merged"] == 1 and sum(lb.LAUNCHES.values()) == 1
    _check(got, lb.block_freq_merged_plain(*args), dtype)
    chain = lb.freq_merged_chain(
        lb.freq_intra, functools.partial(lb.freq_inter, pairs=pairs),
        lb.block_ffn, *args)
    _check_chain(got, chain, dtype)


# K5's band-group form at the encoder stages it serves (C, heads): d = 28,
# one to four heads, kpad(C) = 32, 64, 128
GROUP_STAGES = [(28, 1), (56, 2), (112, 4)]


def _freq_block(rng, c, heads, images, shift, dtype=torch.bfloat16):
    """The entry point's arguments for a frequency block of width ``c`` on
    ``images`` images a band (res 16, four windows), and the per-pair
    tables of its grouped bias. DropPath at keep rate 0.9: its scale 1 / 0.9
    is inexact in fp32, so a kernel that rounds the scale and the residual
    otherwise than the chain shows."""
    keep = lambda n: torch.from_numpy(
        (rng.random(n) < 0.9).astype(np.float32) / np.float32(0.9)).cuda()
    d, n_img = c // heads, L * images
    w = [[_t(rng, heads, c, d, scale=c ** -0.5) if i % 2 == 0 else
          _t(rng, heads, d, scale=0.1) for i in range(6)]
         + [_t(rng, heads, d, c, scale=c ** -0.5), _t(rng, c, scale=0.1)]
         for _ in range(2)]
    hd = 4 * c
    ffn = [_t(rng, c, hd, scale=c ** -0.5), _t(rng, hd, scale=0.1),
           _t(rng, 3, 3, hd, scale=1 / 3), _t(rng, hd, scale=0.1),
           _t(rng, hd, c, scale=hd ** -0.5), _t(rng, c, scale=0.1)]
    ln = lambda: [1.0 + _t(rng, c, scale=0.1), _t(rng, c, scale=0.1)]
    pairs = _t(rng, L * L, (2 * WIN - 1) ** 2, heads, scale=0.05)
    args = ([_t(rng, n_img, RES, RES, c, scale=0.5, dtype=dtype)] + ln()
            + w[0] + [_t(rng, L, heads, N, N, scale=0.05)] + w[1]
            + [lb.inter_bias(pairs, L, WIN), _mask() if shift else None]
            + ln() + ffn + [L, WIN, shift, 1e-6, keep(n_img), keep(n_img)])
    return args, pairs


@pytest.mark.cuda
@pytest.mark.parametrize("images", [2, 3], ids=["B2", "ragged B3"])
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("path", ["group", "phases"])
@pytest.mark.parametrize("stage", GROUP_STAGES,
                         ids=[f"C{c}" for c, _ in GROUP_STAGES])
def test_freq_merged_forms(card, stage, path, shift, images):
    """K5 in bf16 at the stages of its band-group form, by either form: one
    launch, against its twin within TOL, equal bits on a second launch.
    The band-group form is what freq_merged_path chooses there; it runs the
    chain's own device code stage by stage, so it equals the chain K1 -> K3
    -> K2 bit for bit (:func:`_check_chain`), and it takes no device memory
    beyond u and the output: no y1, q / k / v, attention or hidden row. The
    twelve phases equal the chain bit for bit too: their LN2 sums each row
    in the order of K2's fused tile, which the chain runs at these widths
    (``merged.cuh::ln2_phase``)."""
    c, heads = stage
    dt = torch.bfloat16
    assert lb.freq_merged_path(c, heads, WIN, dt) == "group"
    args, pairs = _freq_block(card, c, heads, images, shift)
    run = _freq_merged_as(path, _freq_operands(args, pairs))
    run(*args)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lb.reset_launches()
    got = run(*args)
    torch.cuda.synchronize()
    assert lb.LAUNCHES["freq_merged"] == 1 and sum(lb.LAUNCHES.values()) == 1
    scratch = (torch.cuda.max_memory_allocated() - base
               - got.numel() * got.element_size())
    if path == "group":     # u only, the output's size
        assert scratch <= got.numel() * got.element_size(), scratch
    _check(got, lb.block_freq_merged_plain(*args), dt)
    chain = lb.freq_merged_chain(
        lb.freq_intra, functools.partial(lb.freq_inter, pairs=pairs),
        lb.block_ffn, *args)
    _check_chain(got, chain, dt)
    if path == "group":
        assert torch.equal(lb.block_freq_merged(*args, pairs=pairs), got)
    assert torch.equal(run(*args), got)


def _first_difference(got, want) -> str:
    """Where two tensors first differ (row-major), or 'equal'."""
    diff = (got != want).reshape(-1).nonzero()
    if not len(diff):
        return "equal"
    i = diff[0].item()
    idx = np.unravel_index(i, tuple(got.shape))
    return (f"{int((got != want).sum())} elements differ, the first at "
            f"{tuple(int(j) for j in idx)}: {got.reshape(-1)[i].item()} "
            f"against {want.reshape(-1)[i].item()}")


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("stage", GROUP_STAGES + [(224, 8)],
                         ids=[f"C{c}" for c, _ in GROUP_STAGES] + ["C224"])
def test_freq_merged_phases_by_stage(card, stage, shift):
    """K5's twelve phases against the chain K1 -> K3 -> K2, stage by stage:
    the intra output y1 and u, which the phases leave in their scratch
    buffer, against the chain's, and the output against the chain's K2 on
    the phases' own u. Each pair is equal bit for bit; a failure names the
    first stage and element that differ."""
    c, heads = stage
    dt = torch.bfloat16
    args, pairs = _freq_block(card, c, heads, 3, shift)
    x, ln1s, ln1b = args[:3]
    ops = _freq_operands(args, pairs)
    mask, ln2s, ln2b = args[21:24]
    dps1, dps2 = args[-2:]
    kept = []
    got = lb.freq_merged_kernel(x, ln1s, ln1b, ops[0], ops[1], mask, ln2s,
                                ln2b, ops[2], L, WIN, shift, 1e-6, dps1, dps2,
                                scratch_out=kept, path="phases")
    u, y1 = kept[0]
    img = lb.roll(x, shift)
    y1_chain = lb.attention_kernel(img, ln1s, ln1b, ops[0], mask, None, WIN,
                                   1e-6, False, L, None)
    u_chain = lb.roll(lb.freq_inter_kernel(y1_chain, img, ops[1], mask, L,
                                           WIN, dps1), -shift)
    out_on_u = lb.ffn_kernel(u, ln2s, ln2b, ops[2], 1e-6, dps2)
    found = {"y1": _first_difference(y1, y1_chain),
             "u": _first_difference(u, u_chain),
             "out": _first_difference(got, out_on_u)}
    assert all(v == "equal" for v in found.values()), found


@pytest.mark.cuda
def test_freq_merged_group_form_needs_the_tables(card):
    """The band-group form reads the inter half's per-pair tables: without
    them the launcher raises, and the entry point does not run the
    phases in its place."""
    args, _ = _freq_block(card, 28, 1, 2, 4)
    with pytest.raises(ValueError, match="per-pair"):
        lb.block_freq_merged(*args)
    with pytest.raises(ValueError, match="per-pair"):
        lb.BlockFreqMerged.apply(*args)


FUNCTION_TOL = {torch.float32: 5e-4, torch.bfloat16: 6e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 4])
def test_freq_merged_function_in_its_group_form(card, shift):
    """BlockFreqMerged in bf16 at a band-group shape (res 16, C = 28, one
    head): K5's band-group form forward, which hands the backward u and y1,
    then K7, K8, K6. Every gradient equals that of the chain Functions
    (FreqIntra, FreqInter, BlockFFN) bit for bit, and is within
    FUNCTION_TOL of ``torch.autograd.grad`` of the plain forward (each
    weight gradient on max(1, its own largest value, 1% of the largest of
    any), as ``chip_smoke.py`` measures)."""
    dt = torch.bfloat16
    args, pairs = _freq_block(card, 28, 1, 2, shift)
    args = [a.requires_grad_() if torch.is_tensor(a) and i not in (21, 34, 35)
            else a for i, a in enumerate(args)]
    ins = [a for a in args if torch.is_tensor(a) and a.requires_grad]
    g = _t(card, *args[0].shape, scale=0.5, dtype=dt)
    lb.reset_launches()
    got = torch.autograd.grad(lb.BlockFreqMerged.apply(*args, pairs), ins, g)
    assert (lb.LAUNCHES["freq_merged"], lb.LAUNCHES["lewin_ffn_bwd"],
            lb.LAUNCHES["freq_inter_bwd"], lb.LAUNCHES["lewin_attn_bwd"]) == (
                1, 1, 1, 1)
    x, mask = args[0], args[21]
    img = lb.roll(x, shift)
    y1 = lb.FreqIntra.apply(img, *args[1:12], mask, L, WIN, 1e-6)
    u = lb.roll(lb.FreqInter.apply(y1, img, *args[12:21], mask, L, WIN, 1e-6,
                                   args[34], pairs), -shift)
    chain = torch.autograd.grad(
        lb.BlockFFN.apply(u, *args[22:30], 1e-6, args[35]), ins, g)
    assert all(torch.equal(p, q) for p, q in zip(got, chain))
    want = torch.autograd.grad(lb.block_freq_merged_plain(*args), ins, g)
    floor = max([1.0] + [1e-2 * w.float().abs().max().item() for w in want[1:]])
    for i, (p, q) in enumerate(zip(got, want)):
        err = (p.float() - q.float()).abs().max().item()
        assert err <= FUNCTION_TOL[dt] * max(floor if i else 1.0,
                                             q.float().abs().max().item()), (i, err)


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
    K5 still match their twins and equal the chains (:func:`_check_chain`)."""
    monkeypatch.setitem(globals(), "C", width)
    monkeypatch.setitem(globals(), "H", 1)
    args = (_attn(card, B, dtype) + [_mask(), _t(card, B, 1, scale=0.3)]
            + _ln(card) + _ffn_w(card)
            + [WIN, 4, 1e-6, _dps(card, B), _dps(card, B)])
    got = lb.block_merged(*args)
    _check(got, lb.block_merged_plain(*args), dtype)
    _check_chain(got, lb.merged_chain(lb.block_attention, lb.block_ffn,
                                      *args), dtype)
    a = _attn(card, L * B, dtype, groups=L)
    b = _attn(card, L * B, dtype)
    biasB, pairs = _inter_bias(card, 1)
    args = (a + b[3:11] + [biasB, _mask()] + _ln(card) + _ffn_w(card)
            + [L, WIN, 4, 1e-6, _dps(card, L * B), _dps(card, L * B)])
    got = lb.block_freq_merged(*args)
    _check(got, lb.block_freq_merged_plain(*args), dtype)
    _check_chain(got, lb.freq_merged_chain(
        lb.freq_intra, functools.partial(lb.freq_inter, pairs=pairs),
        lb.block_ffn, *args), dtype)


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


# K6 at the edges of the tensor-core core (bf16; fp32 takes the CUDA-core
# core and the FMA products): (label, images, res, C, heads, bias groups,
# shift mask, lam). 61 images of 16 windows: 976 windows, cut into chunks
# whose last is short; one 8x8 image: one window, one chunk, one head.
CORE_CASES = [
    ("decoder d56 shift lam", 2, 16, 56, 1, 1, True, True),
    ("intra d28 three bias groups shift", 6, 16, 28, 1, 3, True, False),
    ("d32 two heads", 2, 16, 64, 2, 1, False, False),
    ("short last chunk lam", 61, 32, 28, 1, 1, True, True),
    ("one window one head", 1, 8, 56, 1, 1, False, False),
]
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CORE_CASES, ids=[c[0] for c in CORE_CASES])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attn_block_bwd_core_edges(card, dtype, case):
    """K6 against its twin, every output within BWD_TOL (the sums over rows
    or windows on max(1, 1% of the largest of them)); two launches give
    equal bits."""
    _, images, res, c, h, groups, shifted, with_lam = case
    d = c // h
    x = _t(card, images, res, res, c, scale=0.5, dtype=dtype)
    w = [_t(card, h, c, d, scale=c ** -0.5) if i % 2 == 0 else
         _t(card, h, d, scale=0.1) for i in range(6)]
    bias = _t(card, *((groups,) if groups > 1 else ()), h, N, N, scale=0.05)
    mask = (torch.from_numpy(windows.shift_attn_mask(res, res, WIN, 4)).cuda()
            if shifted else None)
    lam = _t(card, images, h, scale=0.3) if with_lam else None
    args = ([x, _grad(card, x), 1.0 + _t(card, c, scale=0.1),
             _t(card, c, scale=0.1)] + w
            + [_t(card, h, d, c, scale=c ** -0.5), _t(card, c, scale=0.1), bias,
               mask, lam, WIN, 1e-6, groups == 1, groups])
    lb.reset_launches()
    got = lb.attn_block_bwd(*args)
    assert lb.LAUNCHES["lewin_attn_bwd"] == 1
    want = lb.attn_block_bwd_plain(*args)
    assert len(got) == len(want)
    floor = max([1.0] + [1e-2 * b.float().abs().max().item()
                         for b in want[1:] if b is not None])
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None or b is None:
            assert a is None and b is None
            continue
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.isfinite(a.float()).all()
        err = (a.float() - b.float()).abs().max().item() / max(
            floor if i else 1.0, b.float().abs().max().item())
        assert err <= BWD_TOL[dtype], (i, err)
    again = lb.attn_block_bwd(*args)
    assert all(torch.equal(p, q) for p, q in zip(got, again) if p is not None)


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


# K8 at the edges of the tensor-core core's 192-token block instance (bf16;
# fp32 takes the CUDA-core core and the FMA products): (label, images per
# band, res, C, heads, shift mask). 17 images of 9 windows: 153 band
# groups, cut into chunks whose last is short; res 8 with 16 heads: one
# window an image, the encoder's deepest stage.
INTER_CASES = [
    ("tiled mask", 2, 16, 28, 1, True),
    ("no mask", 2, 16, 28, 1, False),
    ("short last chunk tiled mask", 17, 24, 28, 1, True),
    ("h16 one window an image", 2, 8, 448, 16, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", INTER_CASES, ids=[c[0] for c in INTER_CASES])
@pytest.mark.parametrize("dtype", DTYPES)
def test_freq_inter_bwd_core_edges(card, dtype, case):
    """K8 against its twin, every output within BWD_TOL (the sums over rows
    or groups on max(1, 1% of the largest of them)); two launches give equal
    bits."""
    _, images, res, c, h, shifted = case
    d = c // h
    x = _t(card, L * images, res, res, c, scale=0.5, dtype=dtype)
    w = [_t(card, h, c, d, scale=c ** -0.5) if i % 2 == 0 else
         _t(card, h, d, scale=0.1) for i in range(6)]
    mask = (torch.from_numpy(windows.shift_attn_mask(res, res, WIN, 4)).cuda()
            if shifted else None)
    args = ([x, _grad(card, x)] + w
            + [_t(card, h, d, c, scale=c ** -0.5), _t(card, c, scale=0.1),
               _t(card, h, L * N, L * N, scale=0.05), mask, L, WIN])
    lb.reset_launches()
    got = lb.freq_inter_bwd(*args)
    assert lb.LAUNCHES["freq_inter_bwd"] == 1
    want = lb.freq_inter_bwd_plain(*args)
    assert len(got) == len(want)
    floor = max([1.0] + [1e-2 * b.float().abs().max().item() for b in want[1:]])
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.isfinite(a.float()).all()
        err = (a.float() - b.float()).abs().max().item() / max(
            floor if i else 1.0, b.float().abs().max().item())
        assert err <= BWD_TOL[dtype], (i, err)
    again = lb.freq_inter_bwd(*args)
    assert all(torch.equal(p, q) for p, q in zip(got, again))


# the fused K2 (bf16, C <= 224): (label, images, H, W, C, DropPath). Hidden
# blocks of 32 a step: C = 28 -> 4 (the last half empty), 56 -> 7, 112 -> 14,
# 224 -> 28, every count of the flagship's fused stages.
FFN_CASES = [
    ("halos between images C56", 3, 16, 16, 56, True),
    ("W off the tile C28", 2, 16, 20, 28, True),
    ("H and W off the tile C112", 2, 12, 20, 112, False),
    ("one 8x8 image C224", 1, 8, 8, 224, True),
    ("8x8 images C224", 3, 8, 8, 224, False),
    ("C28 one tile wide", 3, 16, 8, 28, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FFN_CASES, ids=[c[0] for c in FFN_CASES])
def test_block_ffn_fused_edges(card, case):
    """The fused K2 against its twin within TOL: image edges, tiles past the
    image's right and bottom edges, halos that must not reach into the next
    image of the batch, every hidden-block count of the flagship's fused
    stages, with and without DropPath; it launches once, takes no hidden
    tensor in device memory, and a second launch gives equal bits."""
    _, images, hh, ww, c, with_dps = case
    hd = 4 * c
    dt = torch.bfloat16
    x = _t(card, images, hh, ww, c, scale=0.5, dtype=dt)
    # images of the batch far apart, so a halo from a neighbour would show
    x = x + torch.arange(images, device="cuda", dtype=dt)[:, None, None, None] * 4
    w = [1.0 + _t(card, c, scale=0.1), _t(card, c, scale=0.1),
         _t(card, c, hd, scale=c ** -0.5), _t(card, hd, scale=0.1),
         _t(card, 3, 3, hd, scale=1 / 3), _t(card, hd, scale=0.1),
         _t(card, hd, c, scale=hd ** -0.5), _t(card, c, scale=0.1)]
    dps = _dps(card, images) if with_dps else None
    op = lb.ffn_operands(*w[2:], dt)
    assert build.load().fairm_lewin_ffn_fused(c, 1) == 1
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lb.reset_launches()
    got = lb.ffn_kernel(x, w[0], w[1], op, 1e-6, dps)
    torch.cuda.synchronize()
    assert lb.LAUNCHES["lewin_ffn"] == 1
    scratch = (torch.cuda.max_memory_allocated() - base
               - got.numel() * got.element_size())
    assert scratch < images * hh * ww * hd * 2, scratch
    _check(got, lb.block_ffn_plain(x, *w, 1e-6, dps), dt)
    assert torch.equal(got, lb.ffn_kernel(x, w[0], w[1], op, 1e-6, dps))


# the fused K1 (bf16, kpad(C) <= 224) at every stage it serves: (label, C,
# heads, bias groups); the decoder's d = 56 and the encoder's intra
# attention (d = 28, three bias groups, one a band)
FUSED_STAGES = [
    ("decoder C56", 56, 1, 1), ("decoder C112", 112, 2, 1),
    ("decoder C224", 224, 4, 1), ("intra C28", 28, 1, 3),
    ("intra C56", 56, 2, 3), ("intra C112", 112, 4, 3),
    ("intra C224", 224, 8, 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("images", [4, 3], ids=["B4", "ragged B3"])
@pytest.mark.parametrize("shifted", [True, False], ids=["shift lam", "plain"])
@pytest.mark.parametrize("stage", FUSED_STAGES, ids=[s[0] for s in FUSED_STAGES])
def test_fused_attention_at_every_stage(card, stage, shifted, images):
    """K1 takes one fused launch at C <= 224 in bf16 (no qkv or attention
    rows in device memory): against its twin, equal bits on a second
    launch; shifted with the SW-MSA mask, the decoder's with lam and
    DropPath."""
    _, c, h, groups = stage
    d, res, dt = c // h, 16, torch.bfloat16
    assert lb.attention_path(c, h, WIN, dt) == "fused"
    n_img = images * groups
    x = _t(card, n_img, res, res, c, scale=0.5, dtype=dt)
    w = [_t(card, h, c, d, scale=c ** -0.5) if i % 2 == 0 else
         _t(card, h, d, scale=0.1) for i in range(6)]
    w += [_t(card, h, d, c, scale=c ** -0.5), _t(card, c, scale=0.1)]
    ln = [1.0 + _t(card, c, scale=0.1), _t(card, c, scale=0.1)]
    mask = (torch.from_numpy(windows.shift_attn_mask(res, res, WIN, 4)).cuda()
            if shifted else None)
    if groups == 1:
        bias = _t(card, h, N, N, scale=0.05)
        lam = _t(card, n_img, h, scale=0.3) if shifted else None
        dps = _dps(card, n_img) if shifted else None
        args = [x, *ln, *w, bias, mask, lam, WIN, 1e-6, dps]
        run, plain = lb.block_attention, lb.block_attention_plain
    else:
        bias, lam, dps = _t(card, groups, h, N, N, scale=0.05), None, None
        args = [x, *ln, *w, bias, mask, groups, WIN, 1e-6]
        run, plain = lb.freq_intra, lb.freq_intra_plain
    op = lb.attn_operands(*w, bias, dt)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lb.reset_launches()
    got = lb.attention_kernel(x, *ln, op, mask, lam, WIN, 1e-6, groups == 1,
                              groups, dps)
    torch.cuda.synchronize()
    assert lb.LAUNCHES["lewin_attn"] == 1
    # no device memory beyond the output (the passes' rows would take
    # images x res^2 x (kpad(C) + 3C) elements)
    assert (torch.cuda.max_memory_allocated() - base
            - got.numel() * got.element_size()) <= 512
    assert torch.equal(run(*args), got)
    _check(got, plain(*args), dt)
    assert torch.equal(run(*args), got)


# products of the passes on the TMA / wgmma tile (bf16, wide K): (label,
# kernel, C, res, images); M = images x res^2 rows, ragged against the
# tile's 128 at 3 x 64 and 64, and N ragged at C = 448 (3.5 tiles)
WGMMA_CASES = [
    ("K2 C448 K448/1792 M192", "ffn", 448, 8, 3),
    ("K2 C896 K896/3584 M64", "ffn", 896, 8, 1),
    ("K1 C448 K448 N1344 M192", "attn", 448, 8, 3),
    ("K1 C896 K896 N2688 M256", "attn", 896, 16, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_CASES, ids=[c[0] for c in WGMMA_CASES])
def test_wgmma_products(card, case):
    """K2's four passes (fc1 K = C, fc2 K = 4C) and K1's passes (qkv, proj)
    at C = 448 / 896 take the TMA / wgmma tile in bf16: against the twins
    and against the fp32 products, equal bits on a second launch."""
    _, kernel, c, res, images = case
    dt = torch.bfloat16
    x = _t(card, images, res, res, c, scale=0.5, dtype=dt)
    ln = [1.0 + _t(card, c, scale=0.1), _t(card, c, scale=0.1)]
    if kernel == "ffn":
        hd = 4 * c
        w = [_t(card, c, hd, scale=c ** -0.5), _t(card, hd, scale=0.1),
             _t(card, 3, 3, hd, scale=0.2), _t(card, hd, scale=0.1),
             _t(card, hd, c, scale=hd ** -0.5), _t(card, c, scale=0.1)]
        args = [x, *ln, *w, 1e-6, _dps(card, images)]
        run, plain = lb.block_ffn, lb.block_ffn_plain
    else:
        h = c // 56
        w = [_t(card, h, c, 56, scale=c ** -0.5) if i % 2 == 0 else
             _t(card, h, 56, scale=0.1) for i in range(6)]
        w += [_t(card, h, 56, c, scale=c ** -0.5), _t(card, c, scale=0.1)]
        mask = (torch.from_numpy(windows.shift_attn_mask(res, res, WIN, 4))
                .cuda() if res > WIN else None)
        assert lb.attention_path(c, h, WIN, dt) == "passes"
        args = [x, *ln, *w, _t(card, h, N, N, scale=0.05), mask,
                _t(card, images, h, scale=0.3), WIN, 1e-6, _dps(card, images)]
        run, plain = lb.block_attention, lb.block_attention_plain
    got = run(*args)
    _check(got, plain(*args), dt)
    assert torch.equal(run(*args), got)
    # and against the fp32 products: the twin in float32 on the same bf16
    # inputs and bf16-rounded weight matrices
    mats = (3, 7) if kernel == "ffn" else (3, 5, 7, 9)
    args32 = [a.to(dt).float() if i in mats else
              a.float() if torch.is_tensor(a) else a for i, a in enumerate(args)]
    want = plain(*args32)
    err = (got.float() - want).abs().max().item() / max(
        1.0, want.abs().max().item())
    assert err <= TOL[dt], err


@pytest.mark.cuda
@pytest.mark.parametrize("c", [224, 448])
def test_block_merged_at_res32(card, c):
    """K4 where the default route runs it (res 32, shifted, lam, DropPath;
    C = 224 with the fused attention half, 448 with its phases): against
    its twin and its chain, equal bits on a second launch."""
    h, res, images, dt = c // 56, 32, 2, torch.bfloat16
    hd = 4 * c
    x = _t(card, images, res, res, c, scale=0.5, dtype=dt)
    w = [_t(card, h, c, 56, scale=c ** -0.5) if i % 2 == 0 else
         _t(card, h, 56, scale=0.1) for i in range(6)]
    w += [_t(card, h, 56, c, scale=c ** -0.5), _t(card, c, scale=0.1)]
    fw = [_t(card, c, hd, scale=c ** -0.5), _t(card, hd, scale=0.1),
          _t(card, 3, 3, hd, scale=0.2), _t(card, hd, scale=0.1),
          _t(card, hd, c, scale=hd ** -0.5), _t(card, c, scale=0.1)]
    ln = [1.0 + _t(card, c, scale=0.1), _t(card, c, scale=0.1)]
    mask = torch.from_numpy(windows.shift_attn_mask(res, res, WIN, 4)).cuda()
    args = ([x, *ln, *w, _t(card, h, N, N, scale=0.05), mask,
             _t(card, images, h, scale=0.3)] + ln + fw
            + [WIN, 4, 1e-6, _dps(card, images), _dps(card, images)])
    lb.reset_launches()
    got = lb.block_merged(*args)
    assert lb.LAUNCHES["lewin_merged"] == 1
    _check(got, lb.block_merged_plain(*args), dt)
    _check(got, lb.merged_chain(lb.block_attention, lb.block_ffn, *args), dt)
    assert torch.equal(lb.block_merged(*args), got)
