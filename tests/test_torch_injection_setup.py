"""Shared setup of the tests that hold the port's decoder injection methods
against the JAX package (``tests/test_torch_decoder_*.py``): a tiny
Uformer encoder + decoder (P=32, widths 4, L=3 bands), JAX ``init`` under
``jit``, the parameters JAX initialises to zero (the DCN offset head, the
learnable ``lamb``) drawn at random so that they matter, and the port's
bundle loading the same weights with ``strict=True``. It holds no tests."""

import functools

import jax
import numpy as np
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu import config
from frequency_wised_all_in_one_image_restoration_model_tpu.models import (
    airnet as jairnet)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
    config as tconfig)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    airnet as tairnet)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils.weights import (
    from_jax)

P = 32
TOL_MODEL = 1e-4
# the per-scale set: every per-scale method the decoder takes at once, with
# the learnable modulator (chip_smoke.py's main configuration of the slice)
PER_SCALE_SET = dict(
    degradation_embedding_method=["residual", "modulator", "self_modulator",
                                  "deform_conv", "attention_kv"],
    learnable_modulator=True)
# the method lists of the JAX package's tests/test_uformer.py:87-109
CONFIGS = {
    "all_DC": dict(degradation_embedding_method=["all_DC"]),
    "all_3_bands": dict(degradation_embedding_method=["all_3_bands"]),
    "residual": dict(degradation_embedding_method=["residual"]),
    "self_modulator": dict(degradation_embedding_method=["self_modulator"]),
    "modulator": dict(degradation_embedding_method=["modulator"]),
    "attention_residual": dict(
        degradation_embedding_method=["attention_residual"]),
    "attention_kv": dict(degradation_embedding_method=["attention_kv"]),
    "deform_conv": dict(degradation_embedding_method=["deform_conv"]),
    "residual_self_modulator_all_DC": dict(
        degradation_embedding_method=["residual", "self_modulator", "all_DC"]),
    "residual_modulator_lamb_DC": dict(
        degradation_embedding_method=["residual"], learnable_modulator=True,
        frequency_decompose_type="DC"),
    # depth cap 2: the shifted blocks, whose K / V come from rolled windows
    "per_scale_set": dict(PER_SCALE_SET, uformer_depth_cap=2),
}


def tiny_cfg(**kw):
    base = dict(encoder_type="Uformer", decoder_type="Uformer",
                patch_size=P, crop_test_imgs_size=P, encoder_embed_dim=4,
                embed_dim=4, encoder_dim=8, de_type=["2tasks"], L=3,
                encoder_msa_type="freq", uformer_depth_cap=1, remat=False)
    base.update(kw)
    return config.make_config(**base)


def liven(params, seed: int):
    """``params`` with the zero-initialised offset heads and ``lamb`` drawn
    at random: offsets of a few pixels (past the image edge), gains of
    order 0.5."""
    rng = np.random.default_rng(seed)

    def walk(tree, path):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = walk(val, path + (key,))
                continue
            if "conv_offset_mask" in path:
                val = (rng.uniform(-3.5, 3.5, val.shape) if key == "bias"
                       else 0.1 * rng.standard_normal(val.shape))
            elif key == "lamb":
                val = 0.5 * rng.standard_normal(val.shape)
            out[key] = np.asarray(val, np.float32)
        return out

    return walk(jax.device_get(params), ())


def jax_run(cfg, x):
    """JAX variables (decoder made live) and the eval forward on ``x``."""
    jb = jairnet.build_models(cfg, eval_mode=True)
    enc_vars = jax.jit(lambda r, x: jb.encoder.init(
        {"params": r, "droppath": r}, x, train=False))(
            jax.random.PRNGKey(0), x)
    _, _, ctx = jax.jit(lambda v, x: jb.encoder.apply(v, x, train=False))(
        enc_vars, x)
    dec_vars = jax.jit(lambda r, x, i: jb.decoder.init(
        {"params": r, "droppath": r}, x, i, train=False))(
            jax.random.PRNGKey(1), x, ctx)
    dec_vars = {**dec_vars, "params": liven(dec_vars["params"], 2)}
    y = jax.jit(lambda e, d, x: jairnet.eval_forward(jb, e, d, x))(
        enc_vars, dec_vars, x)
    return jb, jax.device_get(enc_vars), dec_vars, ctx, np.array(y)


def port_bundle(cfg, enc_vars, dec_vars, impl: str = "default",
                eval_mode: bool = True):
    tb = tairnet.build_models(tconfig.from_fields(cfg), "cpu", impl=impl,
                              eval_mode=eval_mode)
    tb.encoder.load_state_dict(from_jax(enc_vars), strict=True)
    tb.decoder.load_state_dict(from_jax(dec_vars), strict=True)
    return tb


@functools.lru_cache(maxsize=None)
def run_config(name: str, seed: int = 5):
    """Everything a comparison of one configuration needs (made once per
    process; the callers only read it)."""
    cfg = tiny_cfg(**CONFIGS[name])
    x = np.random.default_rng(seed).random((2, P, P, 3)).astype(np.float32)
    jb, enc_vars, dec_vars, ctx, y = jax_run(cfg, x)
    return dict(name=name, cfg=cfg, x=x, jb=jb, enc_vars=enc_vars,
                dec_vars=dec_vars, ctx=ctx, y=y,
                bundle=port_bundle(cfg, enc_vars, dec_vars))


def leaves(tree) -> int:
    return len(jax.tree_util.tree_leaves(tree))


def check_config(run):
    """The port's state_dict names every JAX leaf, and the eval forward by
    the default route and by the plain route matches JAX within 1e-4."""
    dec = run["dec_vars"]
    assert len(from_jax(dec)) == leaves(dec)
    assert set(from_jax(dec)) == set(run["bundle"].decoder.state_dict())
    x = torch.from_numpy(run["x"])
    got = tairnet.eval_forward(run["bundle"], x)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, P, P, 3)
    np.testing.assert_allclose(got.numpy(), run["y"], rtol=TOL_MODEL,
                               atol=TOL_MODEL, err_msg=run["name"])
    plain = port_bundle(run["cfg"], run["enc_vars"], dec, impl="plain")
    np.testing.assert_allclose(tairnet.eval_forward(plain, x).numpy(),
                               got.numpy(), rtol=1e-6, atol=1e-6)
