"""The port's other model families against the JAX package, on the CPU: the
ResNet and ViT encoders, the DGRN decoder, the origin-MSA and L = 1 Uformer
encoder and ``SFconv``, at tiny widths (P=32, ``uformer_depth_cap=1``, one
DGRN group of one block, a ViT of depth 2). The whole eval forward of every
new pair, and ``test.main`` for ResNet + DGRN, are in
``test_torch_backbone_pairs.py``.

Weights come from JAX ``init`` through ``from_jax`` (``strict=True``); the
parameters JAX initialises to zero (the DCN offset heads, ``lamb``) are
drawn at random (``liven``) so that they matter. Tolerances: 1e-5 per
module, 1e-4 for a whole forward (float32 on both sides).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu import config
from frequency_wised_all_in_one_image_restoration_model_tpu.models import (
    airnet as jairnet, decoder_dgrn as jdgrn, encoder_resnet as jresnet,
    encoder_vit as jvit, sfnet as jsfnet)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
    config as tconfig)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    airnet as tairnet, decoder_dgrn as tdgrn, encoder_resnet as tresnet,
    encoder_vit as tvit, sfnet as tsfnet)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils.weights import (
    from_jax)
from test_torch_injection_setup import liven

P = 32
TOL = 1e-5
TOL_MODEL = 1e-4
VIT = dict(depth=2, mlp_dim=64)

def tiny_cfg(**kw):
    base = dict(patch_size=P, crop_test_imgs_size=P, encoder_embed_dim=4,
                embed_dim=4, encoder_dim=8, de_type=["2tasks"],
                uformer_depth_cap=1, dgrn_groups=1, dgrn_blocks=1,
                remat=False)
    base.update(kw)
    return config.make_config(**base)


@pytest.fixture(scope="module", autouse=True)
def single_threaded():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(seed=0, b=2):
    return np.random.default_rng(seed).random((b, P, P, 3)).astype(np.float32)


def _init(module, *args, seed=0, **kw):
    variables = jax.jit(lambda r, *a: module.init(
        {"params": r, "dropout": r, "droppath": r}, *a, **kw))(
            jax.random.PRNGKey(seed), *args)
    variables = jax.device_get(variables)
    return {**variables, "params": liven(variables["params"], seed + 7)}


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=msg)


def _load(module, variables):
    module.load_state_dict(from_jax(variables), strict=True)
    return module


@pytest.mark.parametrize("train", [False, True])
def test_resnet_encoder_matches_jax(train):
    """Eval on the running statistics; training on the batch's, which
    also move the running statistics as Flax's do (momentum 0.9). In
    training the outputs are held to 1e-5 of their largest value: Flax's
    variance E[x^2] - E[x]^2 of the first conv's uncentred output loses
    about that much to cancellation in float32, whatever the order of the
    sums."""
    x = _x()
    jm = jresnet.ResNetEncoder(dim=16)
    v = _init(jm, x, train=False)
    tm = _load(tresnet.ResNetEncoder(16), v).train(train)
    got = tm(torch.from_numpy(x))
    if train:
        want, stats = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"]))(v, x)
        new = from_jax({"params": v["params"], **jax.device_get(stats)})
        for name, t in tm.state_dict().items():
            if "running" in name:
                _close(t, new[name], TOL, name)
    else:
        want = jm.apply(v, x, train=False)
    assert got[1].shape == (1, 2, 16) and got[2].shape == (2, P, P, 4)
    for g, w, name in zip(got, want, ("fea", "out", "inter")):
        scale = float(np.abs(np.asarray(w)).max()) if train else 1.0
        _close(g.detach(), w, TOL * max(scale, 1.0), name)
    if not train:
        _close(tm.features(torch.from_numpy(x)).detach(), want[2], TOL)


def test_dgrn_matches_jax():
    """DGRN with the DCN offset heads drawn at random (offsets of a few
    pixels, past the image edge)."""
    x = _x()
    inter = np.random.default_rng(1).standard_normal((2, P, P, 4)).astype(
        np.float32)
    jm = jdgrn.DGRN(n_feats=4, n_groups=1, n_blocks=1)
    v = _init(jm, x, inter)
    want = jm.apply(v, x, inter)
    for impl in ("default", "plain"):
        tm = _load(tdgrn.DGRN(4, 1, 1, impl=impl), v)
        _close(tm(torch.from_numpy(x), torch.from_numpy(inter)).detach(),
               want, TOL, impl)


@pytest.mark.parametrize("decompose,batch_wise", [("DC", False),
                                                  ("3_bands", True)])
def test_vit_encoder_matches_jax(decompose, batch_wise):
    """Band-modulated attention maps with ``lamb`` drawn at random, shared
    or per batch slot."""
    cfg = tiny_cfg(encoder_type="ViT", decoder_type="ResNet",
                   frequency_decompose_type=decompose,
                   batch_wise_decompose=batch_wise, encoder_dim=None)
    x = _x(2, cfg.batch_size)
    jm = jvit.ViTEncoder(cfg=cfg, image_size=P, **VIT)
    v = _init(jm, x, train=False)
    assert v["params"]["attn_0"]["lamb"].shape == (
        2 if decompose == "DC" else 3, cfg.batch_size if batch_wise else 1, 12)
    tm = _load(tvit.ViTEncoder(tconfig.from_fields(cfg), P, **VIT), v).eval()
    want = jm.apply(v, x, train=False)
    got = tm(torch.from_numpy(x))
    for g, w, name in zip(got, want, ("fea", "out", "inter")):
        _close(g.detach(), w, TOL, name)


def test_vit_dropout_keeps_rate_and_scale():
    """The port's dropout: in training about ``rate`` of the elements are
    zero and the rest scaled by 1 / (1 - rate); the same generator state
    gives the same draw; in eval the identity."""
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models.layers import (
        dropout)

    x = torch.ones(200000)
    gen = torch.Generator().manual_seed(0)
    y = dropout(x, 0.1, True, gen)
    kept = y != 0
    assert abs(1.0 - float(kept.float().mean()) - 0.1) < 0.005
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.9))
    again = dropout(x, 0.1, True, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)
    assert dropout(x, 0.1, False, gen) is x


def test_sfconv_matches_jax():
    rng = np.random.default_rng(4)
    low, high = (rng.random((2, 8, 8, 8)).astype(np.float32) for _ in "lh")
    jm = jsfnet.SFconv(features=8)
    v = _init(jm, low, high)
    tm = _load(tsfnet.SFconv(8), v)
    _close(tm(torch.from_numpy(low), torch.from_numpy(high)).detach(),
           jm.apply(v, low, high), TOL)


def _jax_forward(cfg, x, vit=None):
    """JAX bundle and variables (made live), the conditioning and the eval
    forward; ``vit`` overrides the ViT encoder's fields."""
    jb = jairnet.build_models(cfg, eval_mode=True)
    if vit:
        jb = dataclasses.replace(jb, encoder=jb.encoder.clone(**vit))
    enc = _init(jb.encoder, x, train=False)
    _, out, inter = jax.jit(lambda v, x: jb.encoder.apply(v, x, train=False))(
        enc, x)
    dec = _init(jb.decoder, x, inter, train=False, seed=1)
    y = jax.jit(lambda e, d, x: jairnet.eval_forward(jb, e, d, x))(enc, dec, x)
    return jb, enc, dec, jax.device_get((out, inter)), np.asarray(y)


@pytest.mark.parametrize("L", [1, 3])
def test_origin_msa_encoder_matches_jax(L):
    """The origin-MSA Uformer encoder, bands folded into the batch (L = 3)
    or none (L = 1), with ``attention_kv``'s per-stage K / V (band 0 of the
    folded batch)."""
    cfg = tiny_cfg(encoder_type="Uformer", decoder_type="Uformer",
                   encoder_msa_type="origin", L=L,
                   degradation_embedding_method=["attention_kv"])
    x = _x(6)
    jb = jairnet.build_models(cfg, eval_mode=True)
    v = _init(jb.encoder, x, train=False)
    _, out, ctx = jax.jit(lambda v, x: jb.encoder.apply(v, x, train=False))(
        v, x)
    tb = tairnet.build_models(tconfig.from_fields(cfg), "cpu")
    _load(tb.encoder, v)
    with torch.no_grad():
        _, got_out, got = tb.encoder(torch.from_numpy(x))
    _close(got_out, out, TOL)
    assert len(got.band_inter) == L and len(got.kv) == 5
    for g, w in zip(got.band_inter + got.pyramid, ctx.band_inter + ctx.pyramid):
        _close(g, w, TOL)
    for (gk, gv), (wk, wv) in zip(got.kv, ctx.kv):
        assert gk.shape == wk.shape
        _close(gk, wk, TOL)
        _close(gv, wv, TOL)
