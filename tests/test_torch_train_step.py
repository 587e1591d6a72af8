"""The port's train steps against the JAX package's, on the CPU.

One JAX ``TrainState`` of the flagship configuration at a tiny size (P=32,
``uformer_depth_cap=1``, widths 8, float32, ``drop_path=0``) is carried over
by ``train_state_from_jax``; the same synthetic batch goes through a
phase-A step and a joint step of both packages. Compared: the losses (1e-5),
Adam's first moments after the first step, which are the gradients times
``1 - beta1`` (1e-5 of the largest gradient), the second moments, every
updated parameter where the gradient is above noise (Adam's first update is
``lr * sign(g)``), the key encoder (1e-6), the BatchNorm statistics of both
encoders (1e-5), queue and pointer. Two steps run twice give equal bits.
"""

import copy

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
    airnet as tairnet)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training import (
    checkpoint as tckpt, state as tstate, steps as tsteps)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils.weights import (
    from_jax, train_state_from_jax)

P = 32


def tiny_cfg(**kw):
    base = dict(encoder_type="Uformer", decoder_type="Uformer",
                patch_size=P, crop_test_imgs_size=P, encoder_embed_dim=8,
                embed_dim=8, encoder_dim=8, de_type=["2tasks"], L=3,
                encoder_msa_type="freq",
                degradation_embedding_method=["all_DC"],
                uformer_depth_cap=1, remat=False, dtype="float32",
                drop_path=0.0, num_frequency_bands_l1=2, synthetic_data=True,
                seed=3)
    base.update(kw)
    return config.make_config(**base)


def torch_state(cfg, jax_state_np):
    """A port TrainState on the CPU holding the JAX state's values."""
    tcfg = tconfig.from_fields(cfg)
    bundle = tairnet.build_models(tcfg, "cpu", eval_mode=False)
    state = tstate.create_train_state(tcfg, bundle)
    tckpt.load_state_tree(state, train_state_from_jax(jax_state_np))
    return tcfg, bundle, state


@pytest.fixture(scope="module", autouse=True)
def single_threaded():
    """The tensors here are tiny: one thread is faster than many, most of
    all beside other test workers."""
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
    init = jax.tree_util.tree_map(np.array, jst)
    out = {"cfg": cfg, "batch": batch, "init": init}
    for name, joint in (("A", False), ("B", True)):
        step = jax.jit(jsteps.make_train_step(cfg, jb, joint=joint))
        new, m = step(jst, jsteps.array_batch(batch))
        out[name] = (jax.tree_util.tree_map(np.array, new),
                     {k: float(v) for k, v in m.items()})
    return out


@pytest.fixture(scope="module", params=["A", "B"])
def stepped(request, run):
    """(phase, JAX state after, JAX metrics, port state after, port metrics)"""
    phase = request.param
    tcfg, bundle, state = torch_state(run["cfg"], run["init"])
    step = tsteps.make_train_step(tcfg, bundle, joint=phase == "B")
    state, m = step(state, tsteps.array_batch(run["batch"], "cpu"))
    jnew, jm = run[phase]
    return phase, jnew, jm, state, {k: float(v) for k, v in m.items()}


def test_carried_state_matches(run):
    """train_state_from_jax loads every parameter, statistic and the queue."""
    _, bundle, state = torch_state(run["cfg"], run["init"])
    init = run["init"]
    want = from_jax({"params": init.params["encoder"], **init.extra["encoder"]})
    for name, v in bundle.encoder.state_dict().items():
        assert torch.equal(v, want[name].to(v.dtype)), name
    want_k = from_jax({"params": init.moco.params_k, **init.moco.extra_k})
    for name, v in state.moco.encoder_k.state_dict().items():
        assert torch.equal(v, want_k[name].to(v.dtype)), name
    np.testing.assert_array_equal(state.moco.queue.numpy(), init.moco.queue)
    assert int(state.moco.queue_ptr) == 0 and state.step == 0
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
        run["cfg"].lr)
    assert tuple(state.moco.queue.shape) == (3, 8, 3 * run["cfg"].batch_size)


def test_losses_match(stepped):
    phase, _, jm, _, m = stepped
    for k in ("loss", "contrast_loss", "l1_loss"):
        assert m[k] == pytest.approx(jm[k], abs=1e-5), (phase, k)
    if phase == "A":
        assert m["l1_loss"] == 0.0 and m["loss"] == m["contrast_loss"]
    else:
        assert m["l1_loss"] > 0.0


def _adam(jnew):
    return jnew.opt_state.inner_state[0]


def test_gradients_and_moments_match(stepped):
    """After the first step exp_avg = 0.1 g and exp_avg_sq = 0.001 g^2."""
    phase, jnew, _, state, _ = stepped
    adam = _adam(jnew)
    assert int(adam.count) == 1
    gmax = 0.0
    for net in ("encoder", "decoder"):
        mu = from_jax({"params": adam.mu[net]})
        nu = from_jax({"params": adam.nu[net]})
        gmax = max(gmax, max(float(v.abs().max()) for v in mu.values()) / 0.1)
        for name, p in getattr(state, net).named_parameters():
            st = state.optimizer.state[p]
            assert float(st["step"]) == 1.0
            scale = max(float(mu[name].abs().max()), 1e-4)
            np.testing.assert_allclose(
                st["exp_avg"].numpy(), mu[name].numpy(), rtol=1e-4,
                atol=1e-4 * scale, err_msg=f"{phase} {net}.{name} exp_avg")
            np.testing.assert_allclose(
                st["exp_avg_sq"].numpy(), nu[name].numpy(), rtol=1e-3,
                atol=1e-3 * scale * scale * 0.01 + 1e-12,
                err_msg=f"{phase} {net}.{name} exp_avg_sq")
            # p.grad is the gradient itself
            np.testing.assert_allclose(
                p.grad.numpy() * 0.1, mu[name].numpy(), rtol=1e-4,
                atol=1e-4 * scale, err_msg=f"{phase} {net}.{name} grad")
    assert gmax > 0.0
    if phase == "A":  # the decoder takes zero gradients, and Adam counts them
        assert all(float(p.grad.abs().max()) == 0.0
                   for p in state.decoder.parameters())


def test_dlam_reaches_the_encoder(stepped):
    """In the joint step the L1 loss reaches the encoder only through the
    all_DC gain: the decoder's gain MLP and the encoder's blocks carry a
    gradient that phase A's contrastive loss alone does not explain."""
    phase, _, _, state, _ = stepped
    gain = [p for n, p in state.decoder.named_parameters() if "lamb_" in n]
    assert gain
    if phase == "B":
        assert max(float(p.grad.abs().max()) for p in gain) > 0.0
    else:
        assert all(float(p.grad.abs().max()) == 0.0 for p in gain)


def test_updated_parameters_match(stepped):
    phase, jnew, _, state, _ = stepped
    adam = _adam(jnew)
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
                                       err_msg=f"{phase} {net}.{name}")
            assert np.abs(got - ref).max() <= 2 * lr + 1e-6


def test_key_encoder_and_batch_stats_match(stepped):
    phase, jnew, _, state, _ = stepped
    want_k = from_jax({"params": jnew.moco.params_k, **jnew.moco.extra_k})
    want_q = from_jax({"params": jnew.params["encoder"],
                       **jnew.extra["encoder"]})
    for name, v in state.moco.encoder_k.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        tol = 1e-5 if "running_" in name else 1e-6
        np.testing.assert_allclose(v.numpy(), want_k[name].numpy(), rtol=tol,
                                   atol=tol, err_msg=f"{phase} key {name}")
    stats = [n for n in state.encoder.state_dict() if "running_" in n]
    assert len(stats) == 6  # mean and var of the three band heads
    for name in stats:
        np.testing.assert_allclose(
            state.encoder.state_dict()[name].numpy(), want_q[name].numpy(),
            rtol=1e-5, atol=1e-5, err_msg=f"{phase} query {name}")


def test_queue_and_pointer_match(stepped):
    phase, jnew, _, state, _ = stepped
    np.testing.assert_allclose(state.moco.queue.numpy(), jnew.moco.queue,
                               rtol=1e-5, atol=1e-5)
    assert int(state.moco.queue_ptr) == int(jnew.moco.queue_ptr) == 2
    assert state.step == int(jnew.step) == 1


def test_two_steps_twice_give_equal_bits(run):
    finals = []
    for _ in range(2):
        tcfg, bundle, state = torch_state(run["cfg"], run["init"])
        enc_step, joint_step = tsteps.train_steps(tcfg, bundle)
        batch = tsteps.array_batch(run["batch"], "cpu")
        state, _ = enc_step(state, batch)
        state, m = joint_step(state, batch)
        finals.append((tckpt.state_tree(state), float(m["loss"])))
    (a, la), (b, lb_) = finals
    assert la == lb_
    for net in ("encoder", "decoder"):
        for name in a[net]:
            assert torch.equal(a[net][name], b[net][name]), name
    assert torch.equal(a["train_state"]["queue"], b["train_state"]["queue"])
    assert int(a["train_state"]["queue_ptr"]) == 4
    ka, kb = a["train_state"]["encoder_k"], b["train_state"]["encoder_k"]
    assert all(torch.equal(ka[n], kb[n]) for n in ka)


def test_step_order_uses_the_old_queue_and_pre_step_parameters(run):
    """The logits see the queue before the enqueue, and the key encoder is
    averaged with the query parameters before Adam moves them."""
    tcfg, bundle, state = torch_state(run["cfg"], run["init"])
    q0 = state.moco.queue.clone()
    k0 = copy.deepcopy(state.moco.encoder_k.state_dict())
    p0 = copy.deepcopy(state.encoder.state_dict())
    step = tsteps.make_train_step(tcfg, bundle, joint=False)
    state, _ = step(state, tsteps.array_batch(run["batch"], "cpu"))
    b = tcfg.batch_size
    assert torch.equal(state.moco.queue[:, :, b:], q0[:, :, b:])
    assert not torch.equal(state.moco.queue[:, :, :b], q0[:, :, :b])
    norms = torch.linalg.vector_norm(state.moco.queue[:, :, :b], dim=1)
    np.testing.assert_allclose(norms.numpy(), 1.0, atol=1e-5)
    for name, p in state.moco.encoder_k.named_parameters():
        want = k0[name] * 0.999 + p0[name] * 0.001
        np.testing.assert_allclose(p.numpy(), want.numpy(), rtol=0, atol=1e-7)


@pytest.mark.parametrize("upto", ["loss", "grads"])
def test_cut_steps_stop_where_they_say(run, upto):
    tcfg, bundle, state = torch_state(run["cfg"], run["init"])
    p0 = copy.deepcopy(state.decoder.state_dict())
    step = tsteps.make_train_step(tcfg, bundle, joint=True, upto=upto)
    state, m = step(state, tsteps.array_batch(run["batch"], "cpu"))
    assert m["loss"] == pytest.approx(run["B"][1]["loss"], abs=1e-5)
    assert ("gnorm" in m) == (upto == "grads")
    assert int(state.moco.queue_ptr) == 0 and not state.optimizer.state
    for name, v in state.decoder.state_dict().items():
        assert torch.equal(v, p0[name])
    with pytest.raises(ValueError):
        tsteps.make_train_step(tcfg, bundle, joint=True, upto="half")


def test_orbax_train_state_converts(run, tmp_path):
    """tools/jax_ckpt_to_torch.py turns an Orbax train state into a file the
    port resumes from and evaluates from."""
    import importlib.util
    from pathlib import Path

    from frequency_wised_all_in_one_image_restoration_model_tpu.training import (
        checkpoint as jckpt)

    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", Path(__file__).resolve().parents[1] / "tools"
        / "jax_ckpt_to_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    jnew = run["B"][0]
    jckpt.save(str(tmp_path), 7, jnew)
    path = tool.convert(str(tmp_path), 7, out=str(tmp_path / "pt"))
    assert path.endswith("epoch_7.pt")
    _, bundle, state = torch_state(run["cfg"], run["init"])
    tckpt.restore(str(tmp_path / "pt"), 7, state)
    want = train_state_from_jax(jnew)
    got = tckpt.state_tree(state)
    for net in ("encoder", "decoder"):
        for name, v in got[net].items():
            assert torch.equal(v, want[net][name].to(v.dtype)), (net, name)
    ts, wts = got["train_state"], want["train_state"]
    assert ts["step"] == 1 and int(ts["queue_ptr"]) == 2
    assert torch.equal(ts["queue"], wts["queue"])
    assert ts["optimizer"]["count"] == 1
    assert ts["optimizer"]["lr"] == pytest.approx(run["cfg"].lr)
    for kind in ("exp_avg", "exp_avg_sq"):
        for net in ("encoder", "decoder"):
            for name, v in ts["optimizer"][kind][net].items():
                assert torch.equal(v, wts["optimizer"][kind][net][name]), name
    # the same file serves the eval entry point
    eval_bundle = tairnet.build_models(tconfig.from_fields(run["cfg"]), "cpu")
    tckpt.restore_eval(str(tmp_path / "pt"), 7, eval_bundle)
    only = tool.convert(str(tmp_path), 7, out=str(tmp_path / "eval"),
                        eval_only=True)
    assert set(torch.load(only, weights_only=True)) == {"encoder", "decoder"}


@pytest.mark.parametrize("epoch", [0, 1, 2, 3, 61, 62, 121, 128, 130, 254])
def test_lr_staircase_matches(epoch):
    cfg = tiny_cfg(epochs_encoder=2)
    tcfg = tconfig.from_fields(cfg)
    assert tstate.lr_for_epoch(tcfg, epoch) == jstate.lr_for_epoch(cfg, epoch)


def test_with_learning_rate_assigns(run):
    _, _, state = torch_state(run["cfg"], run["init"])
    tstate.with_learning_rate(state, 1.25e-5)
    assert all(g["lr"] == 1.25e-5 for g in state.optimizer.param_groups)
