"""The port's merged LeWin blocks (``block_merged``, ``block_freq_merged``).

On the CPU each wrapper runs its plain twin, the chain of the plain halves
around ``torch.roll``. The twins are held to the JAX package's merged Pallas
kernels run in interpret mode (fp32, 5e-5, the tolerance of the JAX
package's own merged-kernel tests) and, in bf16, to the XLA chain (2e-2: a
few bf16 ulps of O(1) values). The softmax takes the per-row max on both
sides (``FAIRM_STATIC_SHIFT=off``). Inputs come from numpy seeds. The CUDA
kernels are held to the twins on the card by
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
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    uformer_lewin)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
    lewin_block as tlb)

B, C, H, L, WIN = 2, 16, 2, 3, 8
N = WIN * WIN
# the flagship decoder's width at each stage resolution on the way down
FLAGSHIP_WIDTH = {128: 56, 64: 112, 32: 224, 16: 448, 8: 896}
TOL = 5e-5        # fp32, a whole block (two or three kernels deep)
BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def _row_max_softmax(monkeypatch):
    monkeypatch.setenv("FAIRM_STATIC_SHIFT", "off")


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _attn_w(rng):
    d = C // H
    qkv = [_np(rng, H, C, d, scale=0.2) if i % 2 == 0 else
           _np(rng, H, d, scale=0.1) for i in range(6)]
    return qkv + [_np(rng, H, d, C, scale=0.2), _np(rng, C, scale=0.1)]


def _ln(rng):
    return [1.0 + _np(rng, C, scale=0.1), _np(rng, C, scale=0.1)]


def _ffn_w(rng):
    hd = 4 * C
    return [_np(rng, C, hd, scale=0.2), _np(rng, hd, scale=0.1),
            _np(rng, 3, 3, hd, scale=0.2), _np(rng, hd, scale=0.1),
            _np(rng, hd, C, scale=0.2), _np(rng, C, scale=0.1)]


def _mask(res, shift):
    return jwin.shift_attn_mask(res, res, WIN, shift) if shift else None


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


def _merged_np(rng, res, shift, use_lam, use_dps):
    """(args up to b2, dps1, dps2) of block_merged, as numpy."""
    args = ([_np(rng, B, res, res, C, scale=0.5)] + _ln(rng) + _attn_w(rng)
            + [_np(rng, H, N, N, scale=0.05), _mask(res, shift),
               _np(rng, B, H, scale=0.3) if use_lam else None]
            + _ln(rng) + _ffn_w(rng))
    return args, _dps(rng, B, use_dps), _dps(rng, B, use_dps)


def _freq_np(rng, res, shift, use_dps):
    """(args up to b2, dps1, dps2) of block_freq_merged, as numpy."""
    args = ([_np(rng, L * B, res, res, C, scale=0.5)] + _ln(rng)
            + _attn_w(rng) + [_np(rng, L, H, N, N, scale=0.05)]
            + _attn_w(rng) + [_np(rng, H, L * N, L * N, scale=0.05),
                              _mask(res, shift)]
            + _ln(rng) + _ffn_w(rng))
    return args, _dps(rng, L * B, use_dps), _dps(rng, L * B, use_dps)


@pytest.mark.parametrize("use_dps", [False, True])
@pytest.mark.parametrize("use_lam", [False, True])
@pytest.mark.parametrize("shift", [0, 4])
def test_block_merged_plain_matches_pallas(rng, shift, use_lam, use_dps):
    args, d1, d2 = _merged_np(rng, 16, shift, use_lam, use_dps)
    got = tlb.block_merged(*map(_t, args), WIN, shift, 1e-6, _t(d1), _t(d2))
    want = jlb.fused_block_merged(*map(_j, args), WIN, shift, 1e-6, True,
                                  _j(d1), _j(d2))
    _close(got, want)


def test_block_merged_plain_matches_pallas_multi_tile(rng, monkeypatch):
    """Res 64 with the Pallas kernel forced to several row tiles, so its
    carry across grid steps (and the wrap-around tile of the shifted block)
    is on the reference side of the comparison."""
    monkeypatch.setenv("FAIRM_MERGED_T_MB", "1")
    args, d1, d2 = _merged_np(rng, 64, 4, True, True)
    assert jlb._merged_choose_t(64, 64, C, 4 * C, WIN, 4) < 64
    got = tlb.block_merged_plain(*map(_t, args), WIN, 4, 1e-6, _t(d1), _t(d2))
    want = jlb.fused_block_merged(*map(_j, args), WIN, 4, 1e-6, True, _j(d1),
                                  _j(d2))
    _close(got, want)


@pytest.mark.parametrize("use_dps", [False, True])
@pytest.mark.parametrize("shift", [0, 4])
def test_block_freq_merged_plain_matches_pallas(rng, shift, use_dps):
    args, d1, d2 = _freq_np(rng, 16, shift, use_dps)
    got = tlb.block_freq_merged(*map(_t, args), L, WIN, shift, 1e-6, _t(d1),
                                _t(d2))
    want = jlb.fused_block_freq_merged(*map(_j, args), L, WIN, shift, 1e-6,
                                       True, _j(d1), _j(d2))
    _close(got, want)


def _bf16_x(args, conv, dtype):
    return [conv(args[0], dtype)] + [conv(a) for a in args[1:]]


def test_block_merged_plain_bf16_matches_xla_chain(rng):
    """bf16: u is rounded to bf16 between the halves on both sides."""
    args, d1, d2 = _merged_np(rng, 16, 4, True, True)
    got = tlb.block_merged_plain(*_bf16_x(args, _t, torch.bfloat16), WIN, 4,
                                 1e-6, _t(d1), _t(d2))
    a = _bf16_x(args, _j, jnp.bfloat16)
    u = jlb._xla_block_attention(jnp.roll(a[0], (-4, -4), axis=(1, 2)),
                                 *a[1:14], WIN, 1e-6, dps=_j(d1))
    assert u.dtype == jnp.bfloat16
    want = jlb._xla_block_ffn(jnp.roll(u, (4, 4), axis=(1, 2)), *a[14:], 1e-6,
                              dps=_j(d2))
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


def test_block_freq_merged_plain_bf16_matches_xla_chain(rng):
    args, _, d2 = _freq_np(rng, 16, 4, True)
    got = tlb.block_freq_merged_plain(*_bf16_x(args, _t, torch.bfloat16), L,
                                      WIN, 4, 1e-6, None, _t(d2))
    a = _bf16_x(args, _j, jnp.bfloat16)
    mask = a[21]
    img = jnp.roll(a[0], (-4, -4), axis=(1, 2))
    y1 = jlb._xla_freq_intra(img, *a[1:12], mask, L, WIN, 1e-6)
    u = jlb._xla_freq_inter(y1, img, *a[12:21], mask, L, WIN, 1e-6)
    want = jlb._xla_block_ffn(jnp.roll(u, (4, 4), axis=(1, 2)), *a[22:], 1e-6,
                              dps=_j(d2))
    _close(got, want, BF16_TOL)


def test_merged_twins_are_the_chains_of_the_halves(rng):
    """The twin of a merged block is, bit for bit, roll -> attention twin(s)
    -> roll back -> FFN twin."""
    args, d1, d2 = _merged_np(rng, 16, 4, True, True)
    a = list(map(_t, args))
    u = tlb.block_attention_plain(torch.roll(a[0], (-4, -4), (1, 2)), *a[1:14],
                                  WIN, 1e-6, _t(d1))
    want = tlb.block_ffn_plain(torch.roll(u, (4, 4), (1, 2)), *a[14:], 1e-6,
                               _t(d2))
    torch.testing.assert_close(
        tlb.block_merged_plain(*a, WIN, 4, 1e-6, _t(d1), _t(d2)), want,
        rtol=0, atol=0)


def test_cpu_tensors_take_the_merged_twins(rng):
    """A merged wrapper given CPU tensors runs its twin and counts no
    kernel launch."""
    tlb.reset_launches()
    args, d1, d2 = _merged_np(rng, 16, 4, True, True)
    a = list(map(_t, args))
    torch.testing.assert_close(
        tlb.block_merged(*a, WIN, 4, 1e-6, _t(d1), _t(d2)),
        tlb.block_merged_plain(*a, WIN, 4, 1e-6, _t(d1), _t(d2)),
        rtol=0, atol=0)
    args, d1, d2 = _freq_np(rng, 16, 4, True)
    a = list(map(_t, args))
    torch.testing.assert_close(
        tlb.block_freq_merged(*a, L, WIN, 4, 1e-6, _t(d1), _t(d2)),
        tlb.block_freq_merged_plain(*a, L, WIN, 4, 1e-6, _t(d1), _t(d2)),
        rtol=0, atol=0)
    assert not any(tlb.LAUNCHES.values())


@pytest.mark.parametrize("msa_type", ["origin", "freq"])
@pytest.mark.parametrize("impl", ["merged", "default"])
def test_lewin_block_routes_agree_on_the_cpu(msa_type, impl):
    """On a CPU tensor every route of a LeWinBlock runs the plain twins:
    'merged' and 'default' equal 'kernel' exactly."""
    def block(which):
        torch.manual_seed(0)
        blk = uformer_lewin.LeWinBlock(
            C, 16, H, shift_size=4, msa_type=msa_type, L=L,
            all_bands_dc=msa_type == "origin", encoder_embed_dim=2,
            impl=which).eval()
        for p in blk.parameters():
            torch.nn.init.normal_(p, std=0.1)
        return blk

    n = L * B if msa_type == "freq" else B
    g = torch.Generator().manual_seed(1)
    x = torch.randn(n, 16 * 16, C, generator=g)
    inter = [torch.randn(B, 16 * 16 // 64, 32, generator=g) for _ in range(L)]
    with torch.no_grad():
        want = block("kernel")(x, inter)
        got = block(impl)(x, inter)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("msa_type,res,shift,dtype,batch,want", [
    ("origin", 128, 4, torch.bfloat16, 32, "kernel"),   # the chain caught up
    ("origin", 32, 4, torch.bfloat16, 32, "merged"),
    ("origin", 32, 0, torch.bfloat16, 32, "kernel"),    # no roll to absorb
    ("origin", 16, 4, torch.bfloat16, 32, "kernel"),
    ("origin", 8, 4, torch.bfloat16, 32, "kernel"),  # res == win: never shifted
    ("freq", 64, 4, torch.bfloat16, 32, "kernel"),
    ("origin", 32, 4, torch.float32, 32, "kernel"),
    # the batch: merged from 32768 tokens (images x res^2) up
    ("origin", 128, 4, torch.bfloat16, 2, "kernel"),
    ("origin", 128, 4, torch.bfloat16, 1, "kernel"),
    ("origin", 64, 4, torch.bfloat16, 8, "kernel"),  # C = 112: the chain
    ("origin", 32, 4, torch.bfloat16, 33, "merged"),
    ("origin", 32, 4, torch.bfloat16, 31, "merged"),
    ("origin", 32, 4, torch.bfloat16, 16, "merged"),
    ("origin", 16, 4, torch.bfloat16, 128, "kernel"),   # not in the table
])
def test_default_route_follows_the_measured_table(msa_type, res, shift, dtype,
                                                  batch, want):
    """impl='default' takes the merged kernel exactly for the blocks in
    DEFAULT_MERGED (shifted origin blocks in bf16, keyed by width) on a
    batch of at least the entry's tokens (res 32 at C = 224: 4096, at
    C = 448: 16384; res 64 at C = 224: 131072, B = 32); a fixed impl is its
    own route whatever the block and the batch."""
    kw = dict(msa_type=msa_type, L=L, all_bands_dc=msa_type == "origin",
              encoder_embed_dim=2, shift_size=shift)
    dim = FLAGSHIP_WIDTH[res]   # the table is keyed by the block's width
    assert uformer_lewin.LeWinBlock(dim, res, H, impl="default",
                                    **kw).route(dtype, batch) == want
    for impl in ("kernel", "merged", "plain"):
        assert uformer_lewin.LeWinBlock(dim, res, H, impl=impl,
                                        **kw).route(dtype, batch) == impl
    for key, tokens in uformer_lewin.DEFAULT_MERGED.items():
        assert key[0] in ("origin", "freq") and key[1] in (128, 64, 32, 16, 8)
        # the decoder's widths, and the encoder's for its frequency blocks
        assert key[4] in ((56, 112, 224, 448, 896) if key[0] == "origin"
                          else (28, 56, 112, 224, 448))
        assert tokens > 0 and tokens % (key[1] * key[1]) == 0


# the encoder's frequency blocks at the stages of K5's band-group form:
# (res, C, shift, band images, route); band images = 3 x tiles
@pytest.mark.parametrize("res,dim,shift,images,want", [
    (128, 28, 4, 96, "merged"),      # shifted: K5 from B = 32
    (128, 28, 4, 12, "kernel"),      # B = 4: the chain (the step's A/B)
    (128, 28, 4, 93, "kernel"),
    (128, 28, 0, 96, "kernel"),      # unshifted: the chain at every batch
    (64, 56, 4, 96, "merged"),
    (64, 56, 4, 48, "kernel"),
    (64, 56, 0, 96, "kernel"),
    (32, 112, 4, 96, "merged"),      # res 32: shifted or not
    (32, 112, 0, 96, "merged"),
    (32, 112, 0, 48, "kernel"),
    (16, 224, 4, 96, "kernel"),      # the phases: the chain
    (8, 448, 0, 96, "kernel"),
])
def test_default_route_runs_k5_where_the_table_names_it(res, dim, shift,
                                                        images, want):
    """DEFAULT_MERGED's "freq" entries (encoder widths, tokens of the
    band-folded batch) send the frequency blocks K5's band-group form is
    ahead for to the merged kernel in bf16; float32 keeps the chain."""
    block = uformer_lewin.LeWinBlock(dim, res, max(1, dim // 28), impl="default",
                                     msa_type="freq", L=L, shift_size=shift)
    assert block.route(torch.bfloat16, images) == want
    assert block.route(torch.float32, images) == "kernel"


@pytest.mark.parametrize("dim,res,batch,want", [
    (224, 32, 4, "merged"),      # the down path's shifted res-32 blocks
    (448, 32, 16, "merged"),     # the up path's, from 16384 tokens
    (448, 32, 8, "kernel"),
    (112, 32, 32, "kernel"),     # a width the table does not name
    (224, 64, 4, "kernel"),      # the up path at res 64: from B = 32
    (224, 64, 31, "kernel"),
    (224, 64, 32, "merged"),
    (112, 64, 32, "kernel"),     # C = 112: the chain at every batch
    (112, 128, 4, "kernel"),
    (112, 128, 32, "kernel"),
    (56, 128, 32, "kernel"),     # the down path at res 128
])
def test_default_merged_table_is_keyed_by_width(dim, res, batch, want):
    """DEFAULT_MERGED names (msa type, res, shifted, dtype, C): blocks of
    one resolution but another width take their own entry."""
    block = uformer_lewin.LeWinBlock(dim, res, H, impl="default",
                                     all_bands_dc=True, encoder_embed_dim=2,
                                     shift_size=4)
    assert block.route(torch.bfloat16, batch) == want
    assert block.route(torch.float32, batch) == "kernel"


@pytest.mark.parametrize("dim,heads,win,dtype,want", [
    (56, 1, 8, torch.bfloat16, "fused"),     # decoder, d = 56
    (112, 2, 8, torch.bfloat16, "fused"),
    (224, 4, 8, torch.bfloat16, "fused"),
    (28, 1, 8, torch.bfloat16, "fused"),     # encoder intra, d = 28
    (224, 8, 8, torch.bfloat16, "fused"),
    (16, 2, 8, torch.bfloat16, "fused"),
    (448, 8, 8, torch.bfloat16, "passes"),   # kpad(C) > 224
    (896, 16, 8, torch.bfloat16, "passes"),
    (56, 1, 8, torch.float32, "passes"),     # fp32 keeps the passes
    (56, 1, 4, torch.bfloat16, "passes"),    # windows of 16 tokens
    (10, 1, 8, torch.bfloat16, "passes"),    # C not a multiple of 4
    (192, 1, 8, torch.bfloat16, "passes"),   # d = 192 > 64
])
def test_k1_path_chooser(dim, heads, win, dtype, want):
    """attention_path: K1 (and K4's attention half) fused on the SM in bf16
    at kpad(C) <= 224 with head dims up to 64, the four passes elsewhere;
    K4's phase list follows it."""
    assert tlb.attention_path(dim, heads, win, dtype) == want
    phases = tlb.merged_phases(dim, heads, win, dtype)
    assert phases == (tlb.MERGED_FUSED_PHASES if want == "fused"
                      else tlb.MERGED_PHASES)
    assert phases[-4:] == tlb.MERGED_PHASES[-4:]


@pytest.mark.parametrize("dim,heads,win,L,dtype,groups,want", [
    (28, 1, 8, 3, torch.bfloat16, 1024, "fused"),   # encoder res 128, B=4
    (28, 1, 8, 3, torch.bfloat16, 1, "fused"),
    (56, 2, 8, 3, torch.bfloat16, 256, "fused"),    # res 64, B=4
    (112, 4, 8, 3, torch.bfloat16, 512, "fused"),   # res 32, B=32
    (112, 4, 8, 3, torch.bfloat16, 256, "fused"),
    (112, 4, 8, 3, torch.bfloat16, 128, "fused"),   # res 32, B=8
    (112, 4, 8, 3, torch.bfloat16, 112, "passes"),  # not timed: the passes
    (112, 4, 8, 3, torch.bfloat16, 64, "passes"),   # res 32, B=4
    (112, 4, 8, 3, torch.bfloat16, None, "fused"),  # any launch
    (16, 2, 8, 3, torch.bfloat16, 8, "fused"),
    (224, 8, 8, 3, torch.bfloat16, 4096, "passes"),  # kpad(C) > 128: res 16
    (448, 16, 8, 3, torch.bfloat16, 1024, "passes"),  # res 8
    (28, 1, 8, 3, torch.float32, 1024, "passes"),   # fp32 keeps the passes
    (28, 1, 8, 1, torch.bfloat16, 1024, "passes"),  # groups of 64 tokens
    (28, 1, 4, 3, torch.bfloat16, 1024, "passes"),  # windows of 16 tokens
    (56, 1, 8, 3, torch.bfloat16, 1024, "passes"),  # d = 56 > 32
    (30, 1, 8, 3, torch.bfloat16, 1024, "passes"),  # C not a multiple of 4
])
def test_k3_path_chooser(dim, heads, win, L, dtype, groups, want):
    """freq_inter_path: K3 fused on the SM in bf16 for L = 3 bands of 8 x 8
    windows, head dims up to 32 and kpad(C) <= 128 (the encoder's res 128,
    64 and 32 stages; at C = 112 from FREQ_INTER_MIN_GROUPS groups), the
    four passes elsewhere."""
    assert tlb.freq_inter_path(dim, heads, win, dtype, L, groups) == want


# the encoder's stages (res, C, heads): C = 28 * 2^s at res 128 >> s
ENCODER_STAGES = [(128, 28, 1), (64, 56, 2), (32, 112, 4), (16, 224, 8),
                  (8, 448, 16)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("stage", ENCODER_STAGES,
                         ids=[f"res{r}" for r, _, _ in ENCODER_STAGES])
def test_k5_path_at_every_encoder_stage(stage, dtype):
    """freq_merged_path: K5's band-group form in bf16 at the encoder's res
    128, 64 and 32 stages (kpad(C) <= 128, head dims 28), the twelve phases
    at res 16 and 8 and in fp32; the phases' names follow the form."""
    res, dim, heads = stage
    want = ("group" if dtype == torch.bfloat16 and res >= 32 else "phases")
    assert tlb.freq_merged_path(dim, heads, WIN, dtype) == want
    assert tlb.freq_merged_phases(dim, heads, WIN, dtype) == (
        tlb.FREQ_GROUP_PHASES if want == "group" else tlb.FREQ_MERGED_PHASES)
    assert tlb.freq_merged_phases(dim, heads, WIN, dtype,
                                  path="phases") == tlb.FREQ_MERGED_PHASES


@pytest.mark.parametrize("dim,heads,win,L", [
    (28, 1, 4, 3),      # windows of 16 tokens
    (28, 1, 8, 1),      # one band: groups of 64 tokens
    (56, 1, 8, 3),      # d = 56 > 32
    (30, 1, 8, 3),      # C not a multiple of 4
    (10, 1, 8, 3),
])
def test_k5_path_off_the_group_form(dim, heads, win, L):
    """Shapes the band-group form does not take keep the phases."""
    assert tlb.freq_merged_path(dim, heads, win, torch.bfloat16,
                                L) == "phases"


@pytest.mark.parametrize("dim", [28, 56, 112])
def test_k5_scratch_of_the_group_form_is_u(dim):
    """The band-group form's scratch is u alone: C columns a pixel, against
    the phases' LN / qkv / y1 / u / fp32 hidden / conv rows."""
    hd = 4 * dim
    bf = torch.bfloat16
    assert tlb._merged_scratch_cols(dim, hd, True, False, bf, group=True) == dim
    assert tlb._merged_scratch_cols(dim, hd, True, False, bf) == (
        tlb.kpad(dim) + 3 * dim + dim + dim + 2 * hd + tlb.kpad(hd))
    assert tlb._merged_scratch_cols(dim, hd, True, False, torch.float32) == (
        tlb.kpad(dim) + 3 * dim + dim + dim + hd + tlb.kpad(hd))


def test_k5_group_form_needs_the_per_pair_tables(rng):
    """freq_merged_kernel raises where the band-group form would run on
    inter operands without the per-pair tables, before it looks at the
    device; the phases read the grouped bias and get as far as the device
    check."""
    dim, heads = 28, 1
    d, hd = dim // heads, 4 * dim
    t = lambda *shape: torch.from_numpy(_np(rng, *shape, scale=0.1))
    pA = [t(heads, dim, d) if i % 2 == 0 else t(heads, d) for i in range(6)]
    pA += [t(heads, d, dim), t(dim)]
    x = t(L * B, 16, 16, dim).bfloat16()
    intra = tlb.attn_operands(*pA, t(L, heads, N, N), torch.bfloat16)
    inter = tlb.attn_operands(*pA, t(heads, L * N, L * N), torch.bfloat16)
    ffn = tlb.ffn_operands(t(dim, hd), t(hd), t(3, 3, hd), t(hd), t(hd, dim),
                           t(dim), torch.bfloat16)
    ln = [torch.ones(dim), torch.zeros(dim)]
    run = lambda path, op: tlb.freq_merged_kernel(
        x, *ln, intra, op, None, *ln, ffn, L, WIN, 0, 1e-6, None, None,
        path=path)
    assert tlb.freq_merged_path(dim, heads, WIN, torch.bfloat16) == "group"
    for path in (None, "group"):
        with pytest.raises(ValueError, match="per-pair"):
            run(path, inter)
    with pytest.raises(ValueError, match="CUDA"):
        run("phases", inter)
    with pytest.raises(ValueError, match="CUDA"):
        run(None, inter._replace(pairs=t(L * L, 225, heads)))
    with pytest.raises(ValueError, match="path"):
        run("fused", inter)


def test_inter_bias_from_pairs_is_the_grouped_bias():
    """The bias the fused K3 forms from the per-pair tables
    (``inter_bias``: table at the pair's relative position + the band mask,
    one fp32 add) equals, bit for bit, the port's assembled operand
    (``FrequencyWindowAttention('inter')``) and the JAX
    ``_FusedFreqAttnParams(kind='inter')`` bias, from one JAX init."""
    import jax

    from frequency_wised_all_in_one_image_restoration_model_tpu.models import (
        uformer_blocks as jub)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
        uformer_blocks as tub)
    params = jub._FusedFreqAttnParams(C, WIN, H, L, "inter")
    variables = params.init(jax.random.PRNGKey(3))
    want = np.asarray(params.apply(variables)[-1])
    tables = np.array(
        variables["params"]["relative_position_bias_tables"])
    port = tub.FrequencyWindowAttention(C, WIN, H, L, "inter")
    with torch.no_grad():
        port.relative_position_bias_tables.copy_(torch.from_numpy(tables))
    assembled = port.kernel_weights()[-1]
    formed = tlb.inter_bias(torch.from_numpy(tables), L, WIN)
    assert formed.dtype == torch.float32 and formed.shape == (H, L * N, L * N)
    assert torch.equal(formed, assembled)
    np.testing.assert_array_equal(formed.numpy(), want)
    op = port.kernel_operands(torch.float32)
    assert torch.equal(op.pairs, torch.from_numpy(tables))
    assert torch.equal(op.bias, assembled)


def test_rounded_hidden_twin_shows_on_the_f2_weights():
    """ffn_rounded_hidden_plain (the LeFF's rounding points before the
    hidden was kept in fp32) equals block_ffn_plain bit for bit in fp32; in
    bf16, on f2_ffn_weights, it misses block_ffn_plain away from the rim
    by far more than the output's own bf16 spacing at its size (2^-6 below
    4), which is what lets the card check tell the two roundings apart."""
    g = torch.Generator().manual_seed(0)
    randn = lambda *shape, scale=1.0: torch.randn(*shape, generator=g) * scale
    w = tlb.f2_ffn_weights(C, randn)
    assert [t.shape for t in w] == [(C, 4 * C), (4 * C,), (3, 3, 4 * C),
                                    (4 * C,), (4 * C, C), (C,)]
    x = randn(2, 8, 8, C, scale=0.5)
    ln = [torch.ones(C), torch.zeros(C)]
    assert torch.equal(tlb.ffn_rounded_hidden_plain(x, *ln, *w),
                       tlb.block_ffn_plain(x, *ln, *w))
    xb = x.bfloat16()
    inner = (slice(None), slice(1, -1), slice(1, -1))
    want = tlb.block_ffn_plain(xb, *ln, *w).float()[inner]
    bad = tlb.ffn_rounded_hidden_plain(xb, *ln, *w).float()[inner]
    assert want.abs().max() < 4
    assert (bad - want).abs().max() >= 4 * 2.0 ** -6


def test_lewin_block_rejects_unknown_impl():
    with pytest.raises(ValueError, match="impl"):
        uformer_lewin.LeWinBlock(C, 16, H, impl="fused")


def test_merged_kernels_refuse_cpu_tensors(rng):
    """The launchers take CUDA tensors only: nothing falls back."""
    args, d1, d2 = _merged_np(rng, 16, 0, False, False)
    a = list(map(_t, args))
    attn = tlb.attn_operands(*a[3:12], torch.float32)
    ffn = tlb.ffn_operands(*a[16:], torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tlb.merged_kernel(a[0], a[1], a[2], attn, None, None, a[14], a[15],
                          ffn, WIN, 0, 1e-6, None, None)
    with pytest.raises(ValueError, match="CUDA"):
        tlb.freq_merged_kernel(a[0], a[1], a[2], attn, attn, None, a[14],
                               a[15], ffn, 1, WIN, 0, 1e-6, None, None)
