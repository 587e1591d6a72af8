"""The port's train steps of the other model families against the JAX
package's, on the CPU: ``resnet_dgrn`` (ResNet encoder + DGRN) and
``vit_freq`` (ViT with the DC attention-map bands + DGRN), the parity
configurations of the JAX package (``tools/parity_train.py:77-86``).

One JAX ``TrainState`` per family at a tiny size (P=32, one DGRN group of
one block, a ViT of depth 1, float32, the DCN offset heads and ``lamb``
drawn at random) is carried over by ``train_state_from_jax``; the same
synthetic batch goes through a phase-A and a joint step of ``resnet_dgrn``
and the joint step of ``vit_freq`` (whose phase A runs the same encoder
code) in both packages.
Both sides' ViT run with dropout 0 (a field of the JAX module): the two
packages draw dropout from different generators (its rate and scaling are
held in ``test_torch_backbones.py``). Compared: the losses (1e-5), the
gradients through Adam's first moments (1e-4 of the tensor's largest; 3e-4
for the parameters at or below a training-mode BatchNorm, the ResNet
encoder's convolutions and BatchNorm scales, whose batch variance Flax takes as E[x^2] - E[x]^2 of
uncentred activations in float32, one part in 1e5 of cancellation noise in
the forward that the backward amplifies; 1e-2 for the DCN offset heads:
that noise reaches the offsets through ``inter``, and where it moves a
sample across a pixel boundary the bilinear weights' derivative jumps), the
updated parameters where the gradient is above noise (1e-6), the key
encoder (1e-6), the BatchNorm statistics of both encoders (1e-5 of their
largest), queue and pointer. The DGRN trajectory of the JAX package fails
its own parity check (ROADMAP.md, R1): single steps only.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

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
    airnet as tairnet, encoder_vit as tvit)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training import (
    checkpoint as tckpt, state as tstate, steps as tsteps)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils.weights import (
    from_jax, train_state_from_jax)
from test_torch_injection_setup import liven

P = 32
VIT = dict(depth=1, mlp_dim=64)
FAMILIES = {
    "resnet_dgrn": dict(encoder_type="ResNet", encoder_dim=16),
    "vit_freq": dict(encoder_type="ViT", frequency_decompose_type="DC"),
}
# (family, phase): both phases of resnet_dgrn, the joint step of vit_freq
STEPS = [("resnet_dgrn", "A"), ("resnet_dgrn", "B"), ("vit_freq", "B")]


def tiny_cfg(**kw):
    base = dict(decoder_type="ResNet", patch_size=P, crop_test_imgs_size=P,
                de_type=["2tasks"], dgrn_groups=1, dgrn_blocks=1,
                remat=False, dtype="float32", drop_path=0.0,
                num_frequency_bands_l1=2, synthetic_data=True, seed=3)
    base.update(kw)
    return config.make_config(**base)


def jax_bundle(cfg):
    jb = jairnet.build_models(cfg)
    if cfg.encoder_type == "ViT":
        jb = dataclasses.replace(jb, encoder=jb.encoder.clone(dropout=0.0,
                                                              **VIT))
    return jb


def torch_state(cfg, jax_state_np):
    """A port TrainState on the CPU holding the JAX state's values."""
    tcfg = tconfig.from_fields(cfg)
    bundle = tairnet.build_models(tcfg, "cpu", eval_mode=False)
    if cfg.encoder_type == "ViT":
        bundle = dataclasses.replace(bundle, encoder=tvit.ViTEncoder(
            tcfg, P, dropout_rate=0.0, **VIT).train())
    state = tstate.create_train_state(tcfg, bundle)
    tckpt.load_state_tree(state, train_state_from_jax(jax_state_np))
    return tcfg, bundle, state


@pytest.fixture(scope="module", autouse=True)
def single_threaded():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def jax_run(family):
    """The carried-over initial state and JAX's steps of ``family`` (the
    phases of STEPS), made once per process."""
    cfg = tiny_cfg(**FAMILIES[family])
    loader = SyntheticTrainLoader(cfg, seed=cfg.seed)
    first, batch = loader.next_batch(), loader.next_batch()
    jb = jax_bundle(cfg)
    jst = jstate.create_train_state(cfg, jb, jax.random.PRNGKey(cfg.seed), first)
    jst = jstate.with_learning_rate(jst, cfg.lr)
    jst = jst.replace(params={**jst.params, "encoder": liven(
        jst.params["encoder"], 4), "decoder": liven(jst.params["decoder"], 5)})
    init = jax.tree_util.tree_map(np.array, jst)
    out = {"family": family, "cfg": cfg, "batch": batch, "init": init}
    for name in (p for f, p in STEPS if f == family):
        step = jax.jit(jsteps.make_train_step(cfg, jb, joint=name == "B"))
        new, m = step(jst, jsteps.array_batch(batch))
        out[name] = (jax.tree_util.tree_map(np.array, new),
                     {k: float(v) for k, v in m.items()})
    return out


@pytest.fixture(scope="module", params=STEPS, ids="-".join)
def stepped(request):
    """(label, JAX state after, JAX metrics, port state after, port metrics)"""
    family, phase = request.param
    run = jax_run(family)
    tcfg, bundle, state = torch_state(run["cfg"], run["init"])
    assert bundle.num_losses == 1
    step = tsteps.make_train_step(tcfg, bundle, joint=phase == "B")
    state, m = step(state, tsteps.array_batch(run["batch"], "cpu"))
    jnew, jm = run[phase]
    label = f"{run['family']} {phase}"
    return label, jnew, jm, state, {k: float(v) for k, v in m.items()}


def test_losses_match(stepped):
    label, _, jm, _, m = stepped
    for k in ("loss", "contrast_loss", "l1_loss"):
        assert m[k] == pytest.approx(jm[k], abs=1e-5), (label, k)
    assert (m["l1_loss"] > 0.0) == label.endswith("B")


def test_gradients_match(stepped):
    """After the first step Adam's exp_avg is 0.1 g: the gradients of every
    parameter within 1e-4 of the tensor's largest (3e-4 below a BatchNorm,
    1e-2 for the offset heads: see the module's docstring)."""
    label, jnew, _, state, _ = stepped
    adam = jnew.opt_state.inner_state[0]
    for net in ("encoder", "decoder"):
        mu = from_jax({"params": adam.mu[net]})
        for name, p in getattr(state, net).named_parameters():
            scale = max(float(mu[name].abs().max()) / 0.1, 1e-4)
            tol = (1e-2 if "conv_offset_mask" in name else
                   3e-4 if (".Conv_" in name or ".BatchNorm_" in name)
                   else 1e-4)
            np.testing.assert_allclose(
                p.grad.numpy(), mu[name].numpy() / 0.1, rtol=0,
                atol=tol * scale, err_msg=f"{label} {net}.{name}")


def test_updated_parameters_match(stepped):
    label, jnew, _, state, _ = stepped
    adam = jnew.opt_state.inner_state[0]
    lr = state.optimizer.param_groups[0]["lr"]
    for net in ("encoder", "decoder"):
        want = from_jax({"params": jnew.params[net]})
        mu = from_jax({"params": adam.mu[net]})
        for name, p in getattr(state, net).named_parameters():
            got, ref = p.detach().numpy(), want[name].numpy()
            # Adam's first update is lr * g / (|g| + eps): a gradient at
            # the noise level may land on either side of zero
            sure = np.abs(mu[name].numpy()) / 0.1 > 1e-6
            np.testing.assert_allclose(got[sure], ref[sure], rtol=0, atol=1e-6,
                                       err_msg=f"{label} {net}.{name}")
            assert np.abs(got - ref).max() <= 2 * lr + 1e-6


def test_key_encoder_stats_and_queue_match(stepped):
    label, jnew, _, state, _ = stepped
    want_k = from_jax({"params": jnew.moco.params_k, **jnew.moco.extra_k})
    want_q = from_jax({"params": jnew.params["encoder"],
                       **jnew.extra["encoder"]})
    got_q = state.encoder.state_dict()
    stats = [n for n in got_q if "running_" in n]
    assert stats  # ResNet: 18 (mean and var of 9 BatchNorms), ViT: 2
    for got, want, who in ((state.moco.encoder_k.state_dict(), want_k, "key"),
                           (got_q, want_q, "query")):
        for name, v in got.items():
            if name.endswith("num_batches_tracked") or (
                    who == "query" and "running_" not in name):
                continue
            w = want[name].numpy()
            tol = (1e-5 * max(float(np.abs(w).max()), 1.0)
                   if "running_" in name else 1e-6)
            np.testing.assert_allclose(v.numpy(), w, rtol=0, atol=tol,
                                       err_msg=f"{label} {who} {name}")
    np.testing.assert_allclose(state.moco.queue.numpy(), jnew.moco.queue,
                               rtol=1e-5, atol=1e-5)
    assert tuple(state.moco.queue.shape)[0] == 1
    assert int(state.moco.queue_ptr) == int(jnew.moco.queue_ptr)
