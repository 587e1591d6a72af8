"""The LeWin modules no configuration of the CLI builds (JAX reaches them by
building a block or a stage directly): ``SepConv2d`` / ``ConvProjection``
(``token_projection='conv'``), ``ECA1d`` with ``LeFF(use_eca)``, the token
``Mlp`` (``token_mlp`` ``'ffn'`` / ``'mlp'``), and the shifted LeWin block
that each of them makes unfused, against the Flax modules with the JAX
``init`` carried over by ``from_jax`` (every leaf, strict load): outputs at
1e-5, gradients of the input and of every parameter against ``jax.vjp``
at 1e-4 of ``max(1, max|g|)``. Inputs from numpy seeds, fp32, torch on one
thread."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu.models import (
    layers as jlayers, uformer_blocks as jblocks, uformer_lewin as jlewin)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    layers as tlayers, uformer_blocks as tblocks, uformer_lewin as tlewin)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils.weights import (
    from_jax)

TOL = 1e-5
GRAD_TOL = 1e-4
KEYS = {"params": jax.random.PRNGKey(0), "droppath": jax.random.PRNGKey(1)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _check(jmod, jinputs, tmod, tcall, seed=0, pick=_first):
    """``jmod`` initialised on ``jinputs`` (numpy), its variables loaded
    into ``tmod`` strictly; ``pick`` of ``tcall(tmod, *tensors)`` against
    ``pick`` of ``jmod.apply``: the output, then the gradients of every
    input and parameter for a random cotangent."""
    variables = jmod.init(KEYS, *map(jnp.asarray, jinputs))
    tmod.load_state_dict(from_jax(jax.device_get(variables)), strict=True)
    tmod.eval()

    def jfn(params, *xs):
        return pick(jmod.apply({**variables, "params": params}, *xs))

    want, vjp = jax.vjp(jfn, variables["params"], *map(jnp.asarray, jinputs))
    xs = [torch.from_numpy(x).requires_grad_() for x in jinputs]
    got = pick(tcall(tmod, *xs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    g = np.random.default_rng(seed).standard_normal(want.shape).astype(np.float32)
    dparams, *dxs = vjp(jnp.asarray(g))
    names = [n for n, _ in tmod.named_parameters()]
    wrt = xs + [p for _, p in tmod.named_parameters()]
    grads = torch.autograd.grad(got, wrt, torch.from_numpy(g),
                                allow_unused=True)
    grads = [torch.zeros_like(w) if d is None else d
             for d, w in zip(grads, wrt)]
    want_p = from_jax({"params": jax.device_get(dparams)})
    for name, gt, gw in zip([f"input{i}" for i in range(len(xs))] + names,
                            grads, [np.asarray(d) for d in dxs]
                            + [want_p[n].numpy() for n in names]):
        err = np.abs(gt.numpy() - gw).max()
        assert err <= GRAD_TOL * max(1.0, np.abs(gw).max()), (name, err)


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_sepconv_matches_jax(rng):
    _check(jblocks.SepConv2d(10), [_x(rng, 2, 8, 8, 6)],
           tblocks.SepConv2d(6, 10), lambda m, x: m(x, torch.float32))


@pytest.mark.parametrize("kv", [False, True])
def test_conv_projection_matches_jax(rng, kv):
    """q / k / v, the keys from the window itself or from a map of other
    channels (the ``attention_residual`` source)."""
    x = _x(rng, 4, 64, 8)
    inputs = [x, _x(rng, 4, 64, 6)] if kv else [x]
    tm = tblocks.ConvProjection(8, 6 if kv else None)
    for part in range(3):
        _check(jblocks.ConvProjection(heads=2, dim_head=4), inputs, tm,
               lambda m, *xs: m(xs[0], 2, torch.float32,
                                xs[1] if kv else None),
               seed=part, pick=lambda out: out[part])


def test_conv_projection_refuses_encoder_kv():
    with pytest.raises(ValueError, match="token_projection"):
        tblocks.WindowAttention(8, 8, 2, kv_source="attention_kv", dim_kv=8,
                                token_projection="conv")


def test_eca_matches_jax(rng):
    _check(jblocks.ECA1d(), [_x(rng, 2, 16, 12)], tblocks.ECA1d(),
           lambda m, x: m(x))


def test_mlp_matches_jax(rng):
    _check(jlayers.Mlp(32), [_x(rng, 2, 16, 8)], tlayers.Mlp(8, 32),
           lambda m, x: m(x))


def test_leff_eca_matches_jax(rng):
    _check(jblocks.LeFF(32, use_eca=True), [_x(rng, 2, 64, 8)],
           tblocks.LeFF(8, 32, use_eca=True), lambda m, x: m.composite(x))


BLOCKS = [("origin", dict(token_projection="conv")),
          ("origin", dict(token_mlp="ffn")),
          ("origin", dict(token_mlp="mlp")),
          ("freq", dict(token_mlp="ffn"))]


@pytest.mark.parametrize("msa,fields", BLOCKS,
                         ids=[f"{m}-{'-'.join(f.values())}" for m, f in BLOCKS])
def test_shifted_block_matches_jax(rng, monkeypatch, msa, fields):
    """A shifted block (res 16, shift 4) made unfused by the field: the
    attention core is K9's function (its plain version here), the gradient
    K10's."""
    monkeypatch.setenv("FAIRM_FUSED_BLOCK", "0")
    dim, res, heads = 16, 16, 2
    L = 3 if msa == "freq" else 1
    tblk = tlewin.LeWinBlock(dim, res, heads, shift_size=4, msa_type=msa,
                             L=L, **fields)
    assert tblk.unfused
    _check(jlewin.LeWinBlock(dim=dim, input_resolution=res, num_heads=heads,
                             shift_size=4, msa_type=msa, L=L, **fields),
           [_x(rng, 2 * L, res * res, dim)], tblk, lambda m, x: m(x))


def test_stage_passes_the_fields_to_every_block():
    stage = tlewin.BasicUformerLayer(16, 16, 2, 2, token_mlp="mlp",
                                     token_projection="conv")
    for blk in (stage.block0, stage.block1):
        assert blk.unfused and isinstance(blk.mlp, tlayers.Mlp)
        assert isinstance(blk.attn.qkv, tblocks.ConvProjection)
    assert stage.block1.shift == 4
