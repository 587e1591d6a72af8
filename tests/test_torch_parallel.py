"""The port's multi-GPU path on the CPU: the mesh rules against the JAX
package's, two gloo ranks against one process, and both entry points with
a mesh.

The ranks are processes started by the port's own
``parallel.distributed.spawn`` on gloo; they run the workers of
``tests/torch_parallel_workers.py``, which import the port only. The JAX
side of a comparison runs here.

* ``make_mesh``'s shape and rank order against JAX's mesh on the 8 virtual
  CPU devices, ``rows_of`` for ranks 0-3 against JAX's batch sharding, the
  ``ValueError`` of a batch that does not divide, ``param_partition_spec``
  over the tiny flagship's tree against JAX's rule (``min_dim=8``).
* Two steps (phase A, then joint) of the tiny flagship with
  ``drop_path 0.1`` on two ranks against the same steps in one process on
  the global batch (tolerances in ``test_two_ranks_match_one_process``),
  the pointer exact, the queue's unwritten columns exact; the two ranks'
  states equal bit for bit; every forward of a rank's encoders and decoder
  sees only its images.
* ``train.main`` with ``mesh_data 2`` (one epoch of each phase, logs and
  checkpoints written once, by rank 0, then a resume); ``test.main`` with
  ``mesh_data 2`` and with ``mesh_task 2`` against the one-process run;
  the runner on an odd number of tiles (the wrap-pad) against one process.
"""

import concurrent.futures
import copy
import dataclasses
import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu import config
from frequency_wised_all_in_one_image_restoration_model_tpu.models import (
    airnet as jairnet)
from frequency_wised_all_in_one_image_restoration_model_tpu.parallel import (
    mesh as jmesh)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
    config as tconfig, train as ttrain)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.data import (
    synthetic as tsynthetic)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.evaluation import (
    runner as trunner)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    airnet as tairnet)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.parallel import (
    distributed, mesh as tmesh)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training import (
    checkpoint as tckpt, state as tstate)

import torch_parallel_workers as workers

P = 32


def tiny_fields(**kw):
    base = dict(encoder_type="Uformer", decoder_type="Uformer",
                patch_size=P, crop_test_imgs_size=P, encoder_embed_dim=8,
                embed_dim=8, encoder_dim=8, de_type=["2tasks"], L=3,
                encoder_msa_type="freq",
                degradation_embedding_method=["all_DC"],
                uformer_depth_cap=1, remat=False, dtype="float32",
                drop_path=0.1, num_frequency_bands_l1=2, synthetic_data=True,
                seed=3)
    base.update(kw)
    return base


def tiny_cfg(test_de_type=None, **kw):
    cfg = tconfig.make_config(**tiny_fields(**kw))
    if test_de_type is not None:  # else derived from de_type
        cfg = dataclasses.replace(cfg, test_de_type=test_de_type)
    return cfg


@pytest.fixture(scope="module", autouse=True)
def single_threaded():
    """The tensors are tiny; the ranks take this process's thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the rules against JAX's -------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 2), (8, 1), (2, 2), (1, 1),
                                   (2, 2, 2), (1, 1, 2), (4, 1, 2)])
def test_make_mesh_matches_jax(shape):
    """The layout, and each rank's coordinates (``(d, t, m)``, its place in
    JAX's device array)."""
    want = jmesh.make_mesh(*shape)
    got = tmesh.make_mesh(*shape)
    assert got.mesh_dim_names == tuple(want.axis_names)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.mesh.numpy(), ids)
    n_task, n_model = want.devices.shape[1:]
    for place, r in np.ndenumerate(ids):
        assert tmesh.coordinates(int(r), n_task, n_model) == place


def test_make_mesh_refuses_the_model_axis():
    """A mesh axis below 1 is refused (the ``model`` axis above 1 is
    ported: ``tests/test_torch_model_axis.py``)."""
    with pytest.raises(ValueError):
        tmesh.make_mesh(0, 1)
    with pytest.raises(ValueError):
        tmesh.make_mesh(1, 1, n_model=0)


@pytest.mark.parametrize("rank", range(4))
def test_rows_of_match_jax_batch_sharding(rank):
    """Rank r holds the block JAX's batch sharding gives device r."""
    n = 8
    sharding = jmesh.batch_sharding(jmesh.make_mesh(2, 2))
    index = sharding.devices_indices_map((n, 3))
    by_id = {d.id: idx[0] for d, idx in index.items()}
    want = by_id[rank]
    got = tmesh.rows_of(n, rank, 4)
    assert (got.start, got.stop) == (want.start, want.stop)


def test_rows_of_refuses_a_batch_that_does_not_divide():
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.rows_of(6, 0, 4)
    with pytest.raises(ValueError, match="not divisible"):
        tconfig.check_ported(tiny_cfg(de_type=["3tasks"], mesh_task=2))
    tconfig.check_ported(tiny_cfg(mesh_data=2, mesh_task=2))


def test_batch_helpers_match_jax():
    """``concat_batches`` and ``tile_batch`` as the JAX package's (the
    global batch of ``mesh_data`` loader batches); ``shard_batch`` cuts
    every field, names included, to the rank's block."""
    from frequency_wised_all_in_one_image_restoration_model_tpu.training import (
        loop as jloop)

    rng = np.random.default_rng(0)
    batches = [{"d1": rng.random((2, 4, 4, 3), np.float32),
                "de_id": np.arange(2, dtype=np.int32) + 2 * i,
                "names": [f"a{i}", f"b{i}"], "step": i} for i in range(3)]
    for got, want in ((tmesh.concat_batches(batches),
                       jloop.concat_batches(batches)),
                      (tmesh.tile_batch(batches[0], 2),
                       jmesh.tile_batch(batches[0], 2))):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))
    joined = tmesh.concat_batches(batches)
    part = tmesh.shard_batch(joined, 1, 3)
    np.testing.assert_array_equal(part["d1"], batches[1]["d1"])
    assert part["names"] == batches[1]["names"] and part["step"] == 0


def _jax_names(path):
    keys = [k.key if hasattr(k, "key") else str(k) for k in path]
    if keys[-1] == "kernel":
        keys[-1] = "weight"
    return ".".join(keys)


def test_param_partition_spec_matches_jax():
    """With a 2-wide model axis and min_dim=8 the port shards exactly the
    tiny flagship's leaves JAX shards, on the output-feature axis."""
    cfg = config.make_config(**tiny_fields())
    jb = jairnet.build_models(cfg)
    key = jax.random.PRNGKey(0)
    rngs = {"params": key, "droppath": key, "dropout": key}
    x = jnp.zeros((2, P, P, 3), jnp.float32)
    enc = jax.eval_shape(lambda: jb.encoder.init(rngs, x, train=True))
    inter = jax.eval_shape(
        lambda v: jb.encoder.apply(v, x, train=False), enc)[2]
    dec = jax.eval_shape(lambda i: jb.decoder.init(rngs, x, i, train=True),
                         inter)
    bundle = tairnet.build_models(tconfig.from_fields(cfg), "cpu")
    for net, tree in (("encoder", enc["params"]), ("decoder", dec["params"])):
        want = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            spec = jmesh.param_partition_spec(path, leaf, 2, min_dim=8)
            if any(a is not None for a in spec):
                want[_jax_names(path)] = len(leaf.shape)
        module = getattr(bundle, net)
        got = {n: s for n, s in tmesh.partition_specs(module, 2, 8).items()
               if any(a is not None for a in s)}
        assert want and set(got) == set(want), (net, set(got) ^ set(want))
        mods = dict(module.named_modules())
        for name, spec in got.items():
            owner = mods[name.rsplit(".", 1)[0]]
            axis = 1 if isinstance(owner, torch.nn.ConvTranspose2d) else 0
            assert spec[axis] == "model" and len(spec) == want[name], name
        assert not any(a is not None for s in tmesh.partition_specs(
            module, 1, 8).values() for a in s)


# --- two ranks against one process, port only ---------------------------------

@pytest.fixture(scope="module")
def two_v_one():
    """Two steps (A, then joint) from one state on the global batch of 4:
    in this process, and on two gloo ranks (2 images each)."""
    cfg = tiny_cfg(mesh_data=2)
    state = tstate.create_train_state(
        cfg, tairnet.build_models(cfg, "cpu", eval_mode=False))
    tree = copy.deepcopy(tckpt.state_tree(state))
    loader = tsynthetic.SyntheticTrainLoader(cfg, seed=cfg.seed)
    batches = [tmesh.concat_batches([loader.next_batch(), loader.next_batch()])
               for _ in range(2)]
    one = workers.run_steps(cfg, "cpu", tree, batches, ["A", "B"])
    ranks = distributed.spawn(workers.run_steps, cfg, "cpu", tree, batches,
                              ["A", "B"], timeout=600)
    return {"cfg": cfg, "tree": tree, "one": one, "ranks": ranks}


def _tensors(tree, prefix=""):
    """Every tensor of a nested tree, by path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tensors(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v
    return out


def test_ranks_stay_equal_bit_for_bit(two_v_one):
    r0, r1 = two_v_one["ranks"]
    assert (r0["rank"], r1["rank"]) == (0, 1)
    for s0, s1 in zip(r0["steps"], r1["steps"]):
        a, b = _tensors(s0["tree"]), _tensors(s1["tree"])
        assert set(a) == set(b)
        for name in a:
            assert torch.equal(a[name], b[name]), name
        for name in s0["grads"]:
            assert torch.equal(s0["grads"][name], s1["grads"][name]), name


@pytest.mark.parametrize("step", [0, 1])
def test_two_ranks_match_one_process(two_v_one, step):
    """The state after each step against the one-process run. Buffers (the
    BatchNorm statistics), the key encoder and the queue within 1e-6 of
    ``max(1, |x|)``; a parameter within 1e-6 of ``max(1, |x|)`` where its
    gradient is above noise and within ``2 lr`` a step everywhere (Adam's
    early updates are ``lr * g / (|g| + eps)``); Adam's moments on the
    gradients' measure, 5e-4 of the tensor's largest. A rank's forward runs
    at batch 2, not 4, and rounds its products otherwise; the L1 losses'
    subgradients carry that noise into the joint step's gradients (measured:
    2e-4 of the tensor's largest at most, the contrastive head's)."""
    one = two_v_one["one"]["steps"][step]
    ranks = [r["steps"][step] for r in two_v_one["ranks"]]
    for k, v in one["metrics"].items():
        mean = sum(r["metrics"][k] for r in ranks) / 2
        assert mean == pytest.approx(v, abs=1e-6), k
    got, want = _tensors(ranks[0]["tree"]), _tensors(one["tree"])
    assert set(got) == set(want)
    lr = two_v_one["cfg"].lr
    moments = "train_state.optimizer.exp_avg."
    for name, w in want.items():
        g = got[name]
        if not w.is_floating_point():
            assert torch.equal(g, w), name
            continue
        net, _, leaf = name.partition(".")
        tol = 1e-6 * max(1.0, float(w.abs().max()))
        if "optimizer.exp_avg" in name:
            tol = 5e-4 * float(w.abs().max())
        elif net in ("encoder", "decoder") and moments + name in want:
            sure = want[moments + name].abs() > 1e-6
            assert float((g - w).abs().max()) <= 2 * lr * (step + 1), name
            g, w = g[sure], w[sure]
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=tol,
                                   err_msg=name)
    b = 4 * (step + 1)   # the global batch, every step
    ts, ts1 = ranks[0]["tree"]["train_state"], one["tree"]["train_state"]
    assert int(ts["queue_ptr"]) == int(ts1["queue_ptr"]) == b % 12
    assert ts["queue"].shape[-1] == 12      # 3 x the global batch
    unwritten = two_v_one["tree"]["train_state"]["queue"][:, :, b:]
    assert torch.equal(ts["queue"][:, :, b:], unwritten)


def test_each_rank_sees_only_its_images(two_v_one):
    """The counterpart of partition.py's guarantee: no rank runs the global
    batch; every forward of the query and key encoders and the decoder
    takes 2 of the 4 images."""
    for r in two_v_one["ranks"]:
        assert r["seen"] == {"encoder": [2, 2], "encoder_k": [2, 2],
                             "decoder": [2]}
    assert two_v_one["one"]["seen"]["encoder"] == [4, 4]


def test_one_process_draws_as_before(two_v_one):
    """Outside a group the step draws from the state's generator itself:
    the one-process run equals a plain run of the same steps."""
    gen = torch.Generator().manual_seed(5)
    assert distributed.rank_generator(gen, 2) is gen
    rows = tmesh.RankRows(torch.Generator().manual_seed(5), 1, 2, 2)
    whole = torch.rand(12, generator=torch.Generator().manual_seed(5))
    # three bands of a 4-image global batch, band-major: rank 1's rows
    want = whole.reshape(3, 2, 2)[:, 1].reshape(-1)
    assert torch.equal(rows.rand((6,), "cpu"), want)
    with pytest.raises(ValueError):
        rows.rand((5,), "cpu")


# --- the entry points ----------------------------------------------------------

def test_train_entry_point_on_two_ranks(tmp_path):
    """One epoch of each phase on two ranks: the logs and the checkpoints
    written once, by rank 0; then a resume from the checkpoint."""
    fields = dict(mesh_data=2, epochs=2, epochs_encoder=1, steps_per_epoch=1,
                  test_de_type=["denoising_bsd68_25"],
                  output_path=str(tmp_path) + "/")
    cfg = tiny_cfg(**fields)
    state = ttrain.main(cfg, device="cpu")
    assert state.step == 2 and int(state.moco.queue_ptr) == 8
    assert state.moco.queue.shape[-1] == 12
    log = (tmp_path / "train.log").read_text().splitlines()
    assert [ln.split(")")[0] for ln in log] == ["Epoch (0", "Epoch (1"]
    results = (tmp_path / "results.log").read_text().splitlines()
    assert results[0] == "2 Epochs Results:" and len(results) == 2
    assert results[1].startswith("denoising_bsd68_25:")
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["best.pt", "epoch_2.pt"]
    saved = torch.load(tmp_path / "ckpt" / "epoch_2.pt", weights_only=True)
    for name, v in saved["encoder"].items():
        assert torch.equal(v, state.encoder.state_dict()[name]), name
    again = ttrain.main(dataclasses.replace(cfg, epochs=3), device="cpu",
                        startpoint=2)
    assert again.step == 3 and int(again.moco.queue_ptr) == 0
    log = (tmp_path / "train.log").read_text().splitlines()
    assert len(log) == 1 and log[0].startswith("Epoch (2)")
    assert "epoch_3.pt" in os.listdir(tmp_path / "ckpt")


def _psnr_ssim(line):
    p, s = line.split(": ")[1].split("/")
    return float(p), float(s)


@pytest.fixture(scope="module")
def one_process_eval(tmp_path_factory):
    """``test.main`` in one process of its own, with a fixed
    ``PYTHONHASHSEED`` (the synthetic sets are seeded by ``hash(task)``)."""
    out = str(tmp_path_factory.mktemp("eval1")) + "/"
    cfg = tiny_cfg(test_de_type=["denoising_bsd68_25", "deraining"],
                   output_path=out)
    mp = multiprocessing.get_context("spawn")
    old = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "7"
    try:
        with concurrent.futures.ProcessPoolExecutor(1, mp_context=mp) as ex:
            rows = ex.submit(workers.eval_main, cfg, "cpu").result(timeout=600)
    finally:
        if old is None:
            del os.environ["PYTHONHASHSEED"]
        else:
            os.environ["PYTHONHASHSEED"] = old
    return cfg, rows


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)], ids=["data2", "task2"])
def test_eval_entry_point_on_two_ranks(one_process_eval, monkeypatch,
                                       tmp_path, mesh):
    cfg1, want = one_process_eval
    cfg = dataclasses.replace(cfg1, mesh_data=mesh[0], mesh_task=mesh[1],
                              output_path=str(tmp_path) + "/",
                              ckpt_path=str(tmp_path) + "/ckpt/")
    monkeypatch.setenv("PYTHONHASHSEED", "7")
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
        test as ttest)
    got = ttest.main(cfg, device="cpu")
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, g), (_, w) in zip(got, want):
        (pg, sg), (pw, sw) = _psnr_ssim(g), _psnr_ssim(w)
        assert abs(pg - pw) <= 1e-3 and abs(sg - sw) <= 1e-5, (g, w)
    log = (tmp_path / f"epoch_{cfg.epochs}_results.log").read_text().splitlines()
    assert [ln.split(":")[0] for ln in log] == [t for t, _ in want]


def test_eval_wrap_pads_an_odd_tile_count():
    """Three 160 x 160 images: 75 tiles, padded to 76, 38 a rank (one chunk
    of 32 and one of 6); rank 0's line equals the one-process run's."""
    cfg = tiny_cfg(mesh_data=2)
    items = list(tsynthetic.SyntheticTestSet(cfg, "deraining", n_images=3,
                                             seed=11))
    bundle = tairnet.build_models(cfg, "cpu")
    enc, dec = bundle.encoder.state_dict(), bundle.decoder.state_dict()
    want = trunner.test_by_task(cfg, bundle, "deraining", epochs=1,
                                dataset=items)
    ranks = distributed.spawn(workers.eval_task, cfg, "cpu", enc, dec,
                              "deraining", items, timeout=600)
    assert ranks[1]["result"] is None
    (pg, sg), (pw, sw) = _psnr_ssim(ranks[0]["result"]), _psnr_ssim(want)
    assert abs(pg - pw) <= 1e-3 and abs(sg - sw) <= 1e-5
    for r in ranks:
        assert r["seen"] == [32, 6]
