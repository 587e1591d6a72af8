"""The port's ``model`` mesh axis above 1 on the CPU.

JAX's rule (``parallel/mesh.py::param_partition_spec``) fixes where each
parameter's columns are stored; the port's ``shard_params`` makes the
rank's column block the master copy Adam steps, and the step writes the
blocks gathered over the model group back into the full parameters.

* Each rank's rows against JAX's ``batch_sharding`` on that device, and
  each sharded leaf's block on a rank against JAX's shard on its device
  (seeded numpy leaves of the tiny flagship's shapes, ``min_dim=8``). These
  are the only JAX calls here: no init, no jit.
* ``(1, 1, 2)``, two gloo ranks, against one process on the same global
  batch, and ``(2, 1, 2)``, four ranks, against ``(2, 1, 1)``, two ranks:
  two steps (phase A, then joint) from one state, every train-state tensor
  (the full parameters, the key encoder, the queue, the BatchNorm
  statistics, the checkpoint tree's full-size moments) and every metric
  equal bit for bit. With at most two batch groups every cross-rank sum has
  two terms, so its order cannot change the bits; Adam is elementwise, so
  a block steps as its slice of the full tensor does.
* A rank's Adam moments and its gradient all-reduce hold exactly its blocks
  and the replicated leaves, and the tree loads back into the sharded state.

The ranks run ``tests/torch_parallel_workers.py::run_steps`` (port only).
"""

import concurrent.futures
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from frequency_wised_all_in_one_image_restoration_model_tpu import config
from frequency_wised_all_in_one_image_restoration_model_tpu.models import (
    airnet as jairnet)
from frequency_wised_all_in_one_image_restoration_model_tpu.parallel import (
    mesh as jmesh)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.data import (
    synthetic as tsynthetic)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    airnet as tairnet)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.parallel import (
    distributed, mesh as tmesh)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training import (
    checkpoint as tckpt, state as tstate)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils import (
    weights)

import torch_parallel_workers as workers
from test_torch_parallel import P, tiny_cfg, tiny_fields

MIN_DIM = 8      # so that the tiny flagship's kernels shard, as JAX's test
PHASES = ["A", "B"]


@pytest.fixture(scope="module", autouse=True)
def single_threaded():
    """The tensors are tiny; the ranks take this process's thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mesh_view(shape, rank):
    """``make_mesh(*shape)`` as rank ``rank`` sees it."""
    layout = tmesh.make_mesh(*shape).mesh
    return DeviceMesh("cpu", layout, mesh_dim_names=tmesh.MESH_AXES,
                      _init_backend=False, _rank=rank)


def _tensors(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tensors(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v
    return out


def assert_trees_equal(got, want):
    got, want = _tensors(got), _tensors(want)
    assert set(got) == set(want)
    bad = [n for n in want if not torch.equal(got[n], want[n])]
    assert not bad, bad[:10]


def sharded_elements(cfg, n_model):
    """The elements a rank's Adam moments (one of the two) and gradient
    all-reduce hold, from the partition specs: a sharded parameter's
    block, every other parameter whole."""
    bundle = tairnet.build_models(cfg, "cpu", eval_mode=False)
    total = 0
    for net in (bundle.encoder, bundle.decoder):
        specs = tmesh.partition_specs(net, n_model, MIN_DIM)
        for name, p in net.named_parameters():
            total += p.numel() // (n_model if "model" in specs[name] else 1)
    return total


# --- the layout against JAX's -------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 1, 2), (4, 1, 2)])
def test_rows_match_jax_batch_sharding(shape):
    """Rank r holds the rows JAX's batch sharding gives device r: the
    block of its batch index, the same for the ranks of a model group."""
    n_data, n_task, n_model = shape
    groups = n_data * n_task
    n = 2 * groups
    placed = jax.device_put(np.arange(n),
                            jmesh.batch_sharding(jmesh.make_mesh(*shape)))
    by_id = {s.device.id: np.asarray(s.data) for s in placed.addressable_shards}
    assert len(by_id) == groups * n_model
    for r in range(groups * n_model):
        d, t, _ = tmesh.coordinates(r, n_task, n_model)
        got = tmesh.rows_of(n, d * n_task + t, groups)
        np.testing.assert_array_equal(np.arange(n)[got], by_id[r], err_msg=r)


@pytest.fixture(scope="module")
def jax_params():
    """Seeded numpy leaves of the tiny flagship's shapes (``eval_shape``,
    no init), by net."""
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
    rng = np.random.default_rng(0)
    return {net: jax.tree_util.tree_map(
        lambda leaf: rng.standard_normal(leaf.shape).astype(np.float32),
        tree["params"]) for net, tree in (("encoder", enc), ("decoder", dec))}


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 1, 2)])
def test_blocks_match_jax_shards(jax_params, shape):
    """Under ``shard_params`` rank r's master block of each sharded leaf
    equals JAX's ``shard_params`` shard on device r (carried across by
    ``from_jax``); the sharded leaves are exactly JAX's."""
    jax_mesh = jmesh.make_mesh(*shape)
    placed = {net: jmesh.shard_params(tree, jax_mesh, min_dim=MIN_DIM)
              for net, tree in jax_params.items()}
    full = {net: weights.from_jax({"params": tree})
            for net, tree in jax_params.items()}
    cfg = tiny_cfg()
    for r in range(int(np.prod(shape))):
        shards = {net: weights.from_jax({"params": jax.tree_util.tree_map(
            lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                      if s.device.id == r)), tree)})
            for net, tree in placed.items()}
        state = tstate.create_train_state(
            cfg, tairnet.build_models(cfg, "cpu", eval_mode=False))
        for net in ("encoder", "decoder"):
            missing = getattr(state, net).load_state_dict(
                full[net], strict=False).missing_keys
            assert not [k for k in missing
                        if k in dict(getattr(state, net).named_parameters())]
        tmesh.shard_params(state, mesh_view(shape, r), MIN_DIM)
        assert state.shards.index == r % shape[2]
        got = {s.name: s.block for s in state.shards.shards}
        want = {f"{net}.{name}": v for net, sd in shards.items()
                for name, v in sd.items() if v.shape != full[net][name].shape}
        assert want and set(got) == set(want)
        for name, block in got.items():
            assert torch.equal(block, want[name]), (r, name)


def test_shard_params_is_a_no_op_at_one():
    cfg = tiny_cfg()
    state = tstate.create_train_state(
        cfg, tairnet.build_models(cfg, "cpu", eval_mode=False))
    opt = state.optimizer
    assert tmesh.shard_params(state, tmesh.make_mesh(1, 1, 1), MIN_DIM) is state
    assert state.shards is None and state.optimizer is opt
    assert state.masters() == state.parameters()


# --- model-axis runs against replicated runs, port only ------------------------

def _start(cfg):
    state = tstate.create_train_state(
        cfg, tairnet.build_models(cfg, "cpu", eval_mode=False))
    tree = copy.deepcopy(tckpt.state_tree(state))
    loader = tsynthetic.SyntheticTrainLoader(cfg, seed=cfg.seed)
    batches = [tmesh.concat_batches([loader.next_batch()
                                     for _ in range(cfg.mesh_data)])
               for _ in PHASES]
    return tree, batches


@pytest.fixture(scope="module")
def runs():
    """``(1, 1, 2)`` (two ranks of one batch group) and this process on the
    same global batch of 2; ``(2, 1, 2)`` (four ranks) and ``(2, 1, 1)``
    (two ranks) on the same global batch of 4. The three groups start at
    once, each waited on by a thread, while this process runs its steps."""
    cfg1, cfg2 = tiny_cfg(), tiny_cfg(mesh_data=2)
    (tree1, batches1), (tree2, batches2) = _start(cfg1), _start(cfg2)
    sharded = (False, MIN_DIM)      # run_steps' restart, min_dim
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        model2 = ex.submit(distributed.spawn, workers.run_steps, cfg1, "cpu",
                           tree1, batches1, PHASES, *sharded, n_model=2,
                           timeout=600)
        data2 = ex.submit(distributed.spawn, workers.run_steps, cfg2, "cpu",
                          tree2, batches2, PHASES, timeout=600)
        model2_data2 = ex.submit(distributed.spawn, workers.run_steps, cfg2,
                                 "cpu", tree2, batches2, PHASES, *sharded,
                                 n_model=2, timeout=600)
        one = workers.run_steps(cfg1, "cpu", tree1, batches1, PHASES)
        return {"model2_v_one": {"cfg": cfg1, "one": one,
                                 "ranks": model2.result(), "n_model": 2},
                "model2_v_data2": {"cfg": cfg2, "data2": data2.result(),
                                   "ranks": model2_data2.result(),
                                   "n_model": 2}}


@pytest.fixture(scope="module")
def model2_v_one(runs):
    return runs["model2_v_one"]


@pytest.fixture(scope="module")
def model2_v_data2(runs):
    return runs["model2_v_data2"]


@pytest.mark.parametrize("step", [0, 1])
def test_model2_matches_one_process_bit_for_bit(model2_v_one, step):
    want = model2_v_one["one"]["steps"][step]
    for r in model2_v_one["ranks"]:
        got = r["steps"][step]
        assert got["metrics"] == want["metrics"]
        assert_trees_equal(got["tree"], want["tree"])


@pytest.mark.parametrize("step", [0, 1])
def test_model2_data2_matches_data2_bit_for_bit(model2_v_data2, step):
    """Rank (b, m) of ``(2, 1, 2)`` against rank b of ``(2, 1, 1)``."""
    data2 = model2_v_data2["data2"]
    for r in model2_v_data2["ranks"]:
        want = data2[r["batch_index"]]["steps"][step]
        got = r["steps"][step]
        assert got["metrics"] == want["metrics"], r["rank"]
        assert_trees_equal(got["tree"], want["tree"])


@pytest.mark.parametrize("run", ["model2_v_one", "model2_v_data2"])
def test_ranks_hold_their_blocks_and_rows(run, request):
    """Each rank's indices are its mesh coordinates; its Adam moments and
    its gradient all-reduce hold its blocks and the replicated leaves,
    exactly; every block equals its slice of the full parameter; the tree
    loads back into the sharded state and builds again equal; every
    forward runs the rows of the rank's batch index."""
    res = request.getfixturevalue(run)
    cfg, n_model = res["cfg"], res["n_model"]
    elements = sharded_elements(cfg, n_model)
    replicated = sharded_elements(cfg, 1)
    assert elements < replicated
    per = cfg.batch_size
    for r in res["ranks"]:
        d, t, m = tmesh.coordinates(r["rank"], cfg.mesh_task, n_model)
        assert (r["batch_index"], r["model_index"]) == (
            d * cfg.mesh_task + t, m)
        for step in r["steps"]:
            assert step["moments"] == elements
            assert step["reduced"] == elements
            assert step["blocks_equal"]
        assert r["reloaded_mismatches"] == []
        assert r["seen"] == {"encoder": [per, per], "encoder_k": [per, per],
                             "decoder": [per]}
