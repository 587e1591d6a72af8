"""The port's Uformer blocks (models/uformer_blocks.py, uformer_lewin.py)
against the JAX modules, with the JAX ``init`` parameters converted by
``utils.weights.from_jax``; inputs from numpy seeds, fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu.models import (
    uformer_blocks as jblocks, uformer_lewin as jlewin)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    uformer_blocks as tblocks, uformer_lewin as tlewin)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils.weights import (
    from_jax)

TOL = 1e-5
KEYS = {"params": jax.random.PRNGKey(0), "droppath": jax.random.PRNGKey(1)}


def _load(module, variables):
    module.load_state_dict(from_jax(jax.device_get(variables)), strict=True)
    return module.eval()


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shift", [0, 4])
def test_lewin_block_origin_all_dc_matches_jax(rng, monkeypatch, shift):
    monkeypatch.setenv("FAIRM_FUSED_BLOCK", "0")
    dim, res, heads, eed = 16, 16, 2, 4
    x = rng.standard_normal((2, res * res, dim)).astype(np.float32)
    inter = [rng.standard_normal((2, 4, eed * 16)).astype(np.float32)
             for _ in range(3)]
    jblk = jlewin.LeWinBlock(dim=dim, input_resolution=res, num_heads=heads,
                             shift_size=shift, all_bands_num=2,
                             all_bands_dc=True, encoder_embed_dim=eed)
    v = jblk.init(KEYS, jnp.asarray(x), all_inter=[jnp.asarray(a) for a in inter])
    want, _ = jblk.apply(v, jnp.asarray(x),
                         all_inter=[jnp.asarray(a) for a in inter])
    tblk = _load(tlewin.LeWinBlock(dim, res, heads, shift_size=shift,
                                   all_bands_dc=True, encoder_embed_dim=eed), v)
    with torch.no_grad():
        got = tblk(torch.from_numpy(x), [torch.from_numpy(a) for a in inter])
    _close(got, want)


@pytest.mark.parametrize("shift", [0, 4])
def test_lewin_block_freq_matches_jax(rng, monkeypatch, shift):
    monkeypatch.setenv("FAIRM_FUSED_BLOCK", "0")
    dim, res, heads, L = 16, 16, 2, 3
    x = rng.standard_normal((L * 2, res * res, dim)).astype(np.float32)
    jblk = jlewin.LeWinBlock(dim=dim, input_resolution=res, num_heads=heads,
                             shift_size=shift, msa_type="freq", L=L)
    v = jblk.init(KEYS, jnp.asarray(x))
    want, _ = jblk.apply(v, jnp.asarray(x))
    tblk = _load(tlewin.LeWinBlock(dim, res, heads, shift_size=shift,
                                   msa_type="freq", L=L), v)
    with torch.no_grad():
        got = tblk(torch.from_numpy(x))
    _close(got, want)


def test_lewin_block_shift_needs_room():
    # no shift where the stage resolution equals the window (res 8)
    blk = tlewin.LeWinBlock(16, 8, 2, shift_size=4)
    assert blk.shift == 0 and blk.attn_mask is None
    assert tlewin.LeWinBlock(16, 16, 2, shift_size=4).attn_mask.shape == (4, 64, 64)


@pytest.mark.parametrize("msa", ["origin", "freq"])
def test_kernel_operands_are_made_once_per_parameter_version(msa):
    """The kernel operands are cached per dtype and made anew after the
    parameters change, in place or by load_state_dict."""
    kw = dict(all_bands_dc=True) if msa == "origin" else dict(msa_type="freq", L=3)
    blk = tlewin.LeWinBlock(16, 16, 2, **kw)
    attn = blk.attn if msa == "origin" else blk.attn_inter
    first = {}
    for holder, gemm in ((attn, "wqkv"), (blk.mlp, "w1")):
        first[gemm] = holder.kernel_operands(torch.float32)
        assert holder.kernel_operands(torch.float32) is first[gemm]
        bf16 = getattr(holder.kernel_operands(torch.bfloat16), gemm)
        assert bf16.dtype == torch.bfloat16
        assert holder.kernel_operands(torch.float32) is first[gemm]
    state = {k: v + 1.0 for k, v in blk.state_dict().items()}
    blk.load_state_dict(state)
    op = attn.kernel_operands(torch.float32)
    assert op is not first["wqkv"]
    assert not op.wqkv.equal(first["wqkv"].wqkv)
    torch.testing.assert_close(op.bias, attn.kernel_weights()[-1],
                               rtol=0, atol=0)
    with torch.no_grad():
        blk.mlp.linear1.weight.mul_(2.0)
    w1 = blk.mlp.kernel_operands(torch.float32).w1
    torch.testing.assert_close(w1[:, :16], blk.mlp.linear1.weight,
                               rtol=0, atol=0)


def _tokens(rng, b, side, c):
    return rng.standard_normal((b, side * side, c)).astype(np.float32)


@pytest.mark.parametrize("name", ["down", "up", "in", "out"])
def test_projection_layers_match_jax(rng, name):
    if name == "down":
        x = _tokens(rng, 2, 16, 6)
        jm, tm = jblocks.Downsample(12), tblocks.Downsample(6, 12)
    elif name == "up":
        x = _tokens(rng, 2, 8, 12)
        jm, tm = jblocks.Upsample(6), tblocks.Upsample(12, 6)
    elif name == "in":
        x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
        jm, tm = jblocks.InputProj(8), tblocks.InputProj(3, 8)
    else:
        x = _tokens(rng, 2, 16, 8)
        jm, tm = jblocks.OutputProj(3), tblocks.OutputProj(8, 3)
    v = jm.init(KEYS, jnp.asarray(x))
    # non-zero biases so the bias layout is checked too
    v = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape),
                                        jnp.float32), v)
    want = jm.apply(v, jnp.asarray(x))
    tm = _load(tm, v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.float32)
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_drop_path_scale_is_seeded_and_eval_free():
    dp = tlewin.DropPath(0.5)
    assert dp.eval().scale(8, "cpu", None) is None          # eval: identity
    dp.train()
    draws = [dp.scale(64, "cpu", torch.Generator().manual_seed(3))
             for _ in range(2)]
    torch.testing.assert_close(draws[0], draws[1], rtol=0, atol=0)
    assert set(draws[0].tolist()) == {0.0, 2.0}             # {0, 1/keep}
    assert tlewin.DropPath(0.0).train().scale(8, "cpu", None) is None
