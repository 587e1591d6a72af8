"""A joint train step of the per-scale set (``residual modulator
self_modulator deform_conv attention_kv`` with the learnable modulator)
against the JAX package's, on the CPU, as ``test_torch_train_step.py`` holds
the flagship.

One JAX ``TrainState`` at a tiny size (P=32, ``uformer_depth_cap=1``,
widths 8, float32, ``drop_path=0``), its DCN offset heads drawn at random so
that the samples move, is carried over by ``train_state_from_jax``; the
same synthetic batch goes through a joint step of both packages. Compared:
the losses within 1e-5 and every gradient (Adam's first moment after the
first step is 0.1 g) within 1e-4 of its tensor's largest value, floored
at 1e-3 as ``test_torch_train_step.py`` does; the
encoder's K / V reach the decoder's ``to_k`` / ``to_v`` and the encoder.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_injection_setup import PER_SCALE_SET, liven
from frequency_wised_all_in_one_image_restoration_model_tpu import config
from frequency_wised_all_in_one_image_restoration_model_tpu.data.synthetic import (
    SyntheticTrainLoader)
from frequency_wised_all_in_one_image_restoration_model_tpu.models import (
    airnet as jairnet)
from frequency_wised_all_in_one_image_restoration_model_tpu.training import (
    state as jstate, steps as jsteps)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
    config as tconfig)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    airnet as tairnet)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training import (
    checkpoint as tckpt, state as tstate, steps as tsteps)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils.weights import (
    from_jax, train_state_from_jax)

P = 32
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def tiny_cfg(**kw):
    base = dict(encoder_type="Uformer", decoder_type="Uformer",
                patch_size=P, crop_test_imgs_size=P, encoder_embed_dim=8,
                embed_dim=8, encoder_dim=8, de_type=["2tasks"], L=3,
                encoder_msa_type="freq", uformer_depth_cap=1, remat=False,
                dtype="float32", drop_path=0.0, num_frequency_bands_l1=2,
                synthetic_data=True, seed=3, **PER_SCALE_SET)
    base.update(kw)
    return config.make_config(**base)


@pytest.fixture(scope="module", autouse=True)
def single_threaded():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run():
    cfg = tiny_cfg()
    loader = SyntheticTrainLoader(cfg, seed=cfg.seed)
    first, batch = loader.next_batch(), loader.next_batch()
    jb = jairnet.build_models(cfg)
    jst = jstate.create_train_state(cfg, jb, jax.random.PRNGKey(cfg.seed), first)
    jst = jstate.with_learning_rate(jst, cfg.lr)
    params = dict(jst.params)
    params["decoder"] = liven(params["decoder"], 4)
    jst = jst.replace(params=params)
    init = jax.tree_util.tree_map(np.array, jst)
    step = jax.jit(jsteps.make_train_step(cfg, jb, joint=True))
    new, m = step(jst, jsteps.array_batch(batch))
    return dict(cfg=cfg, batch=batch, init=init,
                jnew=jax.tree_util.tree_map(np.array, new),
                jm={k: float(v) for k, v in m.items()})


def _torch_state(run, impl="default"):
    tcfg = tconfig.from_fields(run["cfg"])
    bundle = tairnet.build_models(tcfg, "cpu", impl=impl, eval_mode=False)
    state = tstate.create_train_state(tcfg, bundle)
    tckpt.load_state_tree(state, train_state_from_jax(run["init"]))
    return tcfg, bundle, state


@pytest.fixture(scope="module", params=["default", "plain"])
def stepped(request, run):
    tcfg, bundle, state = _torch_state(run, request.param)
    step = tsteps.make_train_step(tcfg, bundle, joint=True)
    state, m = step(state, tsteps.array_batch(run["batch"], "cpu"))
    return state, {k: float(v) for k, v in m.items()}


def test_losses_match(run, stepped):
    _, m = stepped
    for k in ("loss", "contrast_loss", "l1_loss"):
        assert m[k] == pytest.approx(run["jm"][k], abs=LOSS_TOL), k
    assert m["l1_loss"] > 0.0


def test_gradients_match(run, stepped):
    state, _ = stepped
    adam = run["jnew"].opt_state.inner_state[0]
    for net in ("encoder", "decoder"):
        mu = from_jax({"params": adam.mu[net]})
        for name, p in getattr(state, net).named_parameters():
            want = mu[name].numpy() / 0.1
            scale = max(float(np.abs(want).max()), 1e-3)
            err = float(np.abs(p.grad.numpy() - want).max())
            assert err <= GRAD_TOL * scale, (net, name, err, scale)


def test_new_parameters_take_gradients(stepped):
    """The DCN weight and offset head, the learnable modulator, the
    modulator and self-modulator heads, the residual embeddings and the
    attention_kv projections all learn; so does the encoder through its
    K / V and pyramid (the joint step stops no gradient there)."""
    state, _ = stepped
    grads = {n: float(p.grad.abs().max())
             for n, p in state.decoder.named_parameters()}
    for key in ("mlp.dcn.weight", "mlp.dcn.conv_offset_mask.weight",
                "block0.modulator", "degradation_modulator_embed.weight",
                "norm1.mlp_gamma.weight", "degradation_embed_0.weight",
                "attn.qkv.to_k.weight", "attn.qkv.to_v.weight"):
        assert max(v for n, v in grads.items() if key in n) > 0.0, key
    assert max(float(p.grad.abs().max()) for n, p in
               state.encoder.named_parameters()
               if "block0.attn_inter.qkv.to_kv" in n) > 0.0
