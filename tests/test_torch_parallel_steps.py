"""Two gloo ranks of the port against the JAX package's single-device step,
on the CPU.

The tiny ResNet encoder + DGRN of ``tests/test_train_step.py`` (the family
with the most BatchNorm: nine in the encoder) at P=32, float32, ``drop_path
0``, the DCN offset heads drawn at random; ``mesh_data 2``, so the global
batch is two loader batches of 2 (4 images, 2 a rank) and the queue holds
K = 3 x 4 = 12 keys. One JAX ``TrainState`` is carried over by
``train_state_from_jax``; a phase-A step and a joint step, each from that
state, run in JAX on one device on the global batch (JAX's own tests equal
that step to its sharded step, ``tests/test_parallel.py``) and on two port
ranks on their halves. Compared at ``tests/test_torch_backbone_steps.py``'s
tolerances: the losses (the ranks' mean), the updated parameters, the key
encoder, the BatchNorm statistics of both encoders, the queue; every
gradient (after the all-reduce) on the measure its test states; the
pointer advances by 4 on both.
"""

import jax
import numpy as np
import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu import config
from frequency_wised_all_in_one_image_restoration_model_tpu.data.synthetic import (
    SyntheticTrainLoader)
from frequency_wised_all_in_one_image_restoration_model_tpu.models import (
    airnet as jairnet)
from frequency_wised_all_in_one_image_restoration_model_tpu.parallel import (
    mesh as jmesh)
from frequency_wised_all_in_one_image_restoration_model_tpu.training import (
    loop as jloop, state as jstate, steps as jsteps)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
    config as tconfig)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.parallel import (
    distributed)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils.weights import (
    from_jax, train_state_from_jax)
from test_torch_injection_setup import liven

import torch_parallel_workers as workers

P = 32
PHASES = ("A", "B")


@pytest.fixture(scope="module", autouse=True)
def single_threaded():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run():
    cfg = config.make_config(
        encoder_type="ResNet", decoder_type="ResNet", encoder_dim=32,
        patch_size=P, crop_test_imgs_size=P, de_type=["2tasks"],
        dgrn_groups=1, dgrn_blocks=1, lr=1e-3, remat=False, dtype="float32",
        drop_path=0.0, synthetic_data=True, seed=3, mesh_data=2)
    loader = SyntheticTrainLoader(cfg, seed=cfg.seed)
    global_batch = lambda: jloop.concat_batches(
        [loader.next_batch() for _ in range(cfg.mesh_data)])
    first, batch = global_batch(), global_batch()
    jb = jairnet.build_models(cfg)
    jst = jstate.create_train_state(cfg, jb, jax.random.PRNGKey(cfg.seed), first)
    jst = jstate.with_learning_rate(jst, cfg.lr)
    jst = jst.replace(params={**jst.params, "encoder": liven(
        jst.params["encoder"], 4), "decoder": liven(jst.params["decoder"], 5)})
    init = jax.tree_util.tree_map(np.array, jst)
    out = {"cfg": cfg}
    for name in PHASES:
        step = jax.jit(jsteps.make_train_step(cfg, jb, joint=name == "B"))
        new, m = step(jst, jsteps.array_batch(batch))
        out[name] = (jax.tree_util.tree_map(np.array, new),
                     {k: float(v) for k, v in m.items()})
    tcfg = tconfig.from_fields(cfg)
    ranks = distributed.spawn(
        workers.run_steps, tcfg, "cpu", train_state_from_jax(init),
        [batch, batch], list(PHASES), True, timeout=600)
    out["ranks"] = ranks
    out["K"] = int(init.moco.queue.shape[-1])
    return out


@pytest.fixture(scope="module", params=PHASES)
def stepped(request, run):
    """(phase, JAX state after, JAX metrics, the ranks' steps)"""
    i = PHASES.index(request.param)
    jnew, jm = run[request.param]
    return request.param, jnew, jm, [r["steps"][i] for r in run["ranks"]]


def test_the_queue_holds_three_global_batches(run):
    assert run["K"] == 12
    for r in run["ranks"]:
        assert r["steps"][0]["tree"]["train_state"]["queue"].shape[-1] == 12
    # JAX's sharded layout of the same batch: rank r holds device r's rows
    sharding = jmesh.batch_sharding(jmesh.make_mesh(2, 1))
    rows = sorted(idx[0].start for idx in
                  sharding.devices_indices_map((4, 3)).values())
    assert rows == [0, 2]


def test_losses_match(stepped):
    phase, _, jm, steps = stepped
    for k in ("loss", "contrast_loss", "l1_loss"):
        mean = sum(s["metrics"][k] for s in steps) / len(steps)
        assert mean == pytest.approx(jm[k], abs=1e-5), (phase, k)


def test_ranks_hold_equal_states(stepped):
    _, _, _, (a, b) = stepped
    for name in a["grads"]:
        assert torch.equal(a["grads"][name], b["grads"][name]), name
    for net in ("encoder", "decoder"):
        for name, v in a["tree"][net].items():
            assert torch.equal(v, b["tree"][net][name]), name
    assert torch.equal(a["tree"]["train_state"]["queue"],
                       b["tree"]["train_state"]["queue"])


def test_gradients_match(stepped):
    """The all-reduced gradients against JAX's (Adam's exp_avg is 0.1 g):
    1e-3 of the tensor's largest, 1e-2 for the DCN offset heads, a tensor's
    largest taken as at least 1e-3 of the step's largest gradient. The port
    in one process on this global batch reads up to 7.8e-4 against JAX (the
    ResNet's BatchNorm and convolution gradients, 1e-5 of the step's
    largest, under nine training-mode BatchNorms; the two ranks read the
    same to two digits): the one-device port's noise at B=4, not the
    ranks'."""
    phase, jnew, _, steps = stepped
    adam = jnew.opt_state.inner_state[0]
    mus = {net: from_jax({"params": adam.mu[net]})
           for net in ("encoder", "decoder")}
    floor = 1e-3 * max(float(w.abs().max()) / 0.1
                       for mu in mus.values() for w in mu.values())
    for net, mu in mus.items():
        for name, w in mu.items():
            g = steps[0]["grads"][f"{net}.{name}"]
            scale = max(float(w.abs().max()) / 0.1, floor)
            tol = 1e-2 if "conv_offset_mask" in name else 1e-3
            np.testing.assert_allclose(
                g.numpy(), w.numpy() / 0.1, rtol=0, atol=tol * scale,
                err_msg=f"{phase} {net}.{name}")


def test_updated_parameters_match(stepped, run):
    phase, jnew, _, steps = stepped
    adam = jnew.opt_state.inner_state[0]
    lr = run["cfg"].lr
    for net in ("encoder", "decoder"):
        want = from_jax({"params": jnew.params[net]})
        mu = from_jax({"params": adam.mu[net]})
        got = steps[0]["tree"][net]
        for name, w in want.items():
            g, ref = got[name].numpy(), w.numpy()
            sure = np.abs(mu[name].numpy()) / 0.1 > 1e-6
            np.testing.assert_allclose(g[sure], ref[sure], rtol=0, atol=1e-6,
                                       err_msg=f"{phase} {net}.{name}")
            assert np.abs(g - ref).max() <= 2 * lr + 1e-6


def test_key_encoder_stats_and_queue_match(stepped):
    phase, jnew, _, steps = stepped
    tree = steps[0]["tree"]
    want_k = from_jax({"params": jnew.moco.params_k, **jnew.moco.extra_k})
    want_q = from_jax({"params": jnew.params["encoder"],
                       **jnew.extra["encoder"]})
    stats = [n for n in tree["encoder"] if "running_" in n]
    assert len(stats) == 18    # mean and var of nine BatchNorms
    for got, want, who in ((tree["train_state"]["encoder_k"], want_k, "key"),
                           (tree["encoder"], want_q, "query")):
        for name, v in got.items():
            if name.endswith("num_batches_tracked") or (
                    who == "query" and "running_" not in name):
                continue
            w = want[name].numpy()
            tol = (1e-5 * max(float(np.abs(w).max()), 1.0)
                   if "running_" in name else 1e-6)
            np.testing.assert_allclose(v.numpy(), w, rtol=0, atol=tol,
                                       err_msg=f"{phase} {who} {name}")
    ts = tree["train_state"]
    np.testing.assert_allclose(ts["queue"].numpy(), jnew.moco.queue,
                               rtol=1e-5, atol=1e-5)
    assert int(ts["queue_ptr"]) == int(jnew.moco.queue_ptr) == 4
