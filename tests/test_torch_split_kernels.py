"""The plain versions of the split block kernels K12 / K13
(``lewin_attn_split_plain``, ``lewin_ffn_split_plain``) against the JAX
package's split Pallas kernels, run in interpret mode on the CPU, and
against the plain versions of K1 / K2, which compute the same function.

JAX reaches ``_attn_kernel_split`` / ``_ffn_kernel_split`` only where its
VMEM choosers say so (fp32 at C = 896); here they are monkeypatched as the
JAX package's own tests do (``tests/test_pallas_lewin_block.py:193-226``):
``_attn_weights_fit`` false, ``_ffn_choose_kb`` = 2 or 4. Softmax by the
per-row max (``FAIRM_STATIC_SHIFT=off``). Tolerances: 2e-5 in fp32, 2e-2 in
bf16 (q / k / v, the attention rows and the hidden tensor are rounded to
bf16 at the same points on both sides; the sums run in another order).
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
    lewin_block as tlb)

B, RES, WIN = 2, 16, 8
TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True)
def _row_max_softmax(monkeypatch):
    monkeypatch.setenv("FAIRM_STATIC_SHIFT", "off")


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _pair(a, dtype):
    """The same numpy array as a port tensor and a JAX array, the first
    one (the image) in the compute dtype."""
    if a is None:
        return None, None
    return torch.from_numpy(a).to(dtype), jnp.asarray(a).astype(JDT[dtype])


def _close(got, want, tol):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", [False, True])
def test_attn_split_plain_matches_pallas_split(rng, monkeypatch, dtype,
                                               shifted):
    """C = 64 (two k-tiles: the projection in two fp32 partials), h = 2,
    weights of scale 0.8 / sqrt(C) as in ``test_torch_lewin_kernels.py``;
    shifted: the SW-MSA mask, the all_DC gain and DropPath."""
    C, h = 64, 2
    d = C // h
    x = _np(rng, B, RES, RES, C, scale=0.5)
    w = [1.0 + _np(rng, C, scale=0.1), _np(rng, C, scale=0.1)]
    for _ in range(3):
        w += [_np(rng, h, C, d, scale=0.1), _np(rng, h, d, scale=0.1)]
    w += [_np(rng, h, d, C, scale=0.1), _np(rng, C, scale=0.1),
          _np(rng, h, WIN * WIN, WIN * WIN, scale=0.05)]
    mask = jwin.shift_attn_mask(RES, RES, WIN, 4) if shifted else None
    lam = _np(rng, B, h, scale=0.3) if shifted else None
    dps = np.array([2.0, 0.0], np.float32) if shifted else None
    tx, jx = _pair(x, dtype)
    tw = [torch.from_numpy(a) for a in w]
    jw = [jnp.asarray(a) for a in w]
    extra_t = [None if a is None else torch.from_numpy(a)
               for a in (mask, lam)]
    extra_j = [None if a is None else jnp.asarray(a) for a in (mask, lam)]
    tdps = None if dps is None else torch.from_numpy(dps)
    got = tlb.lewin_attn_split_plain(tx, *tw, *extra_t, WIN, 1e-6, tdps, kb=2)
    monkeypatch.setattr(jlb, "_attn_weights_fit", lambda C_, itemsize: False)
    want = jlb.fused_block_attention(jx, *jw, *extra_j, WIN, 1e-6, True,
                                     None if dps is None else jnp.asarray(dps))
    _close(got, want, TOLS[dtype])
    unsplit = tlb.block_attention_plain(tx, *tw, *extra_t, WIN, 1e-6, tdps)
    _close(got, unsplit, TOLS[dtype])
    assert got.dtype == dtype and got.shape == tx.shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kb", [2, 4])
def test_ffn_split_plain_matches_pallas_split(rng, monkeypatch, dtype, kb):
    """C = 8, Hd = 512 (the JAX test's shape): Hd blocks of 256 or 128,
    DropPath on."""
    C, Hd = 8, 512
    x = _np(rng, B, RES, RES, C, scale=0.5)
    w = [1.0 + _np(rng, C, scale=0.1), _np(rng, C, scale=0.1),
         _np(rng, C, Hd, scale=0.2), _np(rng, Hd, scale=0.1),
         _np(rng, 3, 3, Hd, scale=0.2), _np(rng, Hd, scale=0.1),
         _np(rng, Hd, C, scale=0.2), _np(rng, C, scale=0.1)]
    dps = np.array([0.0, 1.25], np.float32)
    tx, jx = _pair(x, dtype)
    tw = [torch.from_numpy(a) for a in w]
    assert [s.stop - s.start for s in tlb.split_cols(Hd, kb)] == [Hd // kb] * kb
    got = tlb.lewin_ffn_split_plain(tx, *tw, 1e-6, torch.from_numpy(dps),
                                    kb=kb)
    monkeypatch.setattr(jlb, "_ffn_choose_kb", lambda C_, Hd_, itemsize: kb)
    want = jlb.fused_block_ffn(jx, *map(jnp.asarray, w), 1e-6, True,
                               jnp.asarray(dps))
    _close(got, want, TOLS[dtype])
    unsplit = tlb.block_ffn_plain(tx, *tw, 1e-6, torch.from_numpy(dps))
    _close(got, unsplit, TOLS[dtype])


@pytest.mark.parametrize("rows,cols,k,dtype,kb", [
    (256, 896, 896, torch.float32, 4),      # K12's projection, res 8, B = 4
    (1024, 896, 896, torch.float32, 2),     # res 16, B = 4: 128 tiles
    (4096, 896, 896, torch.float32, 1),     # 128-row tiles: 256 of them
    (256, 896, 3584, torch.float32, 8),     # K13's fc2: 32 tiles
    (1024, 896, 3584, torch.float32, 2),
    (2048, 896, 3584, torch.float32, 1),    # res 8, B = 32: 256 tiles
    (256, 896, 3584, torch.bfloat16, 8),    # 14 tiles of 128 x 128
    (1024, 896, 3584, torch.bfloat16, 4),
    (4096, 896, 3584, torch.bfloat16, 1),
    (8192, 896, 3584, torch.bfloat16, 1),
    (256, 896, 896, torch.bfloat16, 2),     # 4 parts: not whole 64-col tiles
    (512, 16, 64, torch.float32, 1),        # two k-tiles: no part below 4
])
def test_split_parts_fills_the_card(rows, cols, k, dtype, kb):
    """The fewest parts that put a CTA on each of the 132 SMs, dividing the
    k-tiles, each part at least 4 of them (fp32 tiles of 64 x 112, 128 x
    112 where those alone fill the card; bf16 tiles of 128 x 128 and parts
    of whole 64-column k-tiles)."""
    assert tlb.split_parts(rows, cols, k, dtype) == kb
    tlb.split_cols(k, kb, dtype)


def test_split_cols_refuses_an_uneven_cut():
    with pytest.raises(ValueError, match="k-tiles"):
        tlb.split_cols(896, 8)   # 28 k-tiles


@pytest.mark.parametrize("k,kb,ok", [
    (896, 2, True), (896, 4, False), (3584, 8, True), (64, 2, False),
    (96, 3, False), (96, 1, True), (192, 3, True)])
def test_split_cols_bf16_parts_are_whole_wgmma_tiles(k, kb, ok):
    """In bfloat16 the kernels run kb > 1 parts in one launch on 64-wide
    k-tiles: a cut into 32-wide halves is refused there, and taken in
    float32 and by the plain twins."""
    tlb.split_cols(k, kb)
    tlb.split_cols(k, kb, torch.float32)
    if ok:
        tlb.split_cols(k, kb, torch.bfloat16)
    else:
        with pytest.raises(ValueError, match="64-wide"):
            tlb.split_cols(k, kb, torch.bfloat16)


@pytest.mark.parametrize("C,h,win,path", [
    (896, 16, 8, "fused"), (56, 1, 8, "fused"), (28, 1, 8, "fused"),
    (896, 16, 4, "passes"), (128, 1, 8, "passes"), (896, 8, 8, "passes")])
def test_attn_split_path(C, h, win, path):
    """K12's fused form: 8 x 8 windows, head dims up to 64."""
    assert tlb.attn_split_path(C, h, win) == path


@pytest.mark.parametrize("dim,res,dtype,batch,want", [
    (896, 8, torch.float32, 1, "split"),        # 64 tokens
    (896, 8, torch.float32, 4, "split"),
    (896, 16, torch.float32, 1, "split"),       # 256 tokens
    (896, 16, torch.float32, 4, "split"),
    (896, 8, torch.float32, 32, "split"),       # 2048 tokens
    (896, 16, torch.float32, 32, "split"),      # 8192 tokens
    (896, 8, torch.bfloat16, 16, "kernel"),     # bf16 res 8: the chain
    (896, 8, torch.bfloat16, 32, "kernel"),
    (896, 16, torch.bfloat16, 4, "kernel"),     # 1024 tokens
    (896, 16, torch.bfloat16, 8, "kernel"),     # 2048 tokens
    (896, 16, torch.bfloat16, 16, "split"),     # 4096 tokens
    (896, 16, torch.bfloat16, 32, "split"),
    (448, 16, torch.float32, 4, "kernel"),      # not in the table
])
def test_default_route_takes_the_split_table(dim, res, dtype, batch, want):
    """impl='default' runs K12 -> K13 exactly for the blocks of
    DEFAULT_SPLIT (the C = 896 stages: fp32 at res 8 and 16, bf16 at res 16)
    on a batch of at least the entry's tokens; impl='split' takes every
    origin block and no frequency block."""
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
        uformer_lewin)

    kw = dict(all_bands_dc=True, encoder_embed_dim=2)
    block = uformer_lewin.LeWinBlock(dim, res, 16, impl="default", **kw)
    assert block.route(dtype, batch) == want
    assert uformer_lewin.LeWinBlock(dim, res, 16, impl="split",
                                    **kw).route(dtype, batch) == "split"
    freq = uformer_lewin.LeWinBlock(8, res, 2, impl="split", msa_type="freq",
                                    L=3)
    assert freq.route(dtype, batch) == "kernel"
    assert uformer_lewin.DEFAULT_SPLIT == {
        (896, torch.float32, 8): 64, (896, torch.float32, 16): 256,
        (896, torch.bfloat16, 16): 4096}
