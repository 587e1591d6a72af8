"""Rank workers of ``tests/test_torch_parallel*.py``: run in processes of
their own through ``parallel.distributed.spawn`` (gloo ranks on the CPU).

This module imports the port only, never JAX: the JAX side of a comparison
runs in the pytest process. Each worker is ``fn(cfg, device, *args)`` and
returns tensors, numbers and plain containers (sent back through
``torch.save``).
"""

from __future__ import annotations

import copy

import torch

from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
    test as ttest)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.evaluation import (
    runner)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    airnet)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.parallel import (
    distributed, mesh)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training import (
    checkpoint, state as state_lib, steps)


def state_from_tree(cfg, device, tree):
    """A train state of ``cfg`` on ``device`` holding ``tree``'s values."""
    bundle = airnet.build_models(cfg, device, eval_mode=False)
    state = state_lib.create_train_state(cfg, bundle)
    checkpoint.load_state_tree(state, tree)
    return bundle, state


def _batch_sizes(module, seen):
    """Record the leading size of every input ``module``'s forward sees."""
    return module.register_forward_pre_hook(
        lambda m, args: seen.append(int(args[0].shape[0])))


def run_steps(cfg, device, tree, batches, phases, restart=False,
              min_dim=None):
    """From ``tree``, one step of each phase (``"A"`` encoder only, ``"B"``
    joint) on this rank's rows of the matching global batch, one after the
    other, or each from ``tree`` again with ``restart``. Returns, per step,
    the metrics, the gradients and the train-state tree after it, and the
    batch sizes the query encoder, key encoder and decoder forwards saw.

    With ``min_dim`` the state is first sharded over the group's ``model``
    axis (``mesh.shard_params``); a step then also gives the elements of
    the rank's Adam moments and of its gradient all-reduce (the step's last
    all-reduce), and whether every block equals its slice of the full
    parameter; at the end the tree is loaded back into the state and the
    names where the tree built again differs are returned."""
    torch.set_num_threads(1)
    bundle, state = state_from_tree(cfg, device, tree)
    if min_dim is not None:
        mesh.shard_params(state, mesh.make_mesh(
            cfg.mesh_data, cfg.mesh_task, distributed.model_axis()), min_dim)
    reduced = []
    if distributed.active():
        real = torch.distributed.all_reduce

        def counted(t, *args, **kwargs):
            reduced.append(t.numel())
            return real(t, *args, **kwargs)

        torch.distributed.all_reduce = counted
    seen = {"encoder": [], "encoder_k": [], "decoder": []}
    hooks = [_batch_sizes(state.encoder, seen["encoder"]),
             _batch_sizes(state.moco.encoder_k, seen["encoder_k"]),
             _batch_sizes(state.decoder, seen["decoder"])]
    out = []
    for phase, batch in zip(phases, batches):
        if restart:
            checkpoint.load_state_tree(state, tree)
        step = steps.make_train_step(cfg, bundle, joint=phase == "B")
        local = distributed.shard_global_batch(batch)
        state, m = step(state, steps.array_batch(local, device))
        grads = {f"{net}.{n}": p.grad.detach().clone()
                 for net in ("encoder", "decoder")
                 for n, p in getattr(state, net).named_parameters()
                 if p.grad is not None}
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "grads": grads,
                    "tree": copy.deepcopy(checkpoint.state_tree(state))})
        if min_dim is not None:
            out[-1].update(
                moments=sum(st["exp_avg"].numel()
                            for st in state.optimizer.state.values()),
                reduced=reduced[-1] if reduced else None,
                blocks_equal=all(
                    torch.equal(s.block, state.shards.block_of(s.param, s.param))
                    for s in state.shards.shards))
    for h in hooks:
        h.remove()
    result = {"steps": out, "seen": seen, "rank": distributed.rank(),
              "batch_index": distributed.batch_index(),
              "model_index": distributed.model_index()}
    if min_dim is not None:
        checkpoint.load_state_tree(state, out[-1]["tree"])
        again = checkpoint.state_tree(state)
        result["reloaded_mismatches"] = [
            name for name, (a, b) in _paired(out[-1]["tree"], again)
            if not torch.equal(a, b)]
    return result


def _paired(a, b, prefix=""):
    """``(path, (a's tensor, b's tensor))`` for every tensor of two trees of
    one structure."""
    for k, v in a.items():
        if isinstance(v, dict):
            yield from _paired(v, b[k], f"{prefix}{k}.")
        elif isinstance(v, torch.Tensor):
            yield prefix + k, (v, b[k])


def eval_task(cfg, device, enc_sd, dec_sd, task, items):
    """``test_by_task`` of ``task`` on ``items`` (rank 0 reads them, the
    others get none), and the batch sizes of the eval forwards."""
    torch.set_num_threads(1)
    bundle = airnet.build_models(cfg, device)
    bundle.encoder.load_state_dict(enc_sd)
    bundle.decoder.load_state_dict(dec_sd)
    seen = []
    hook = _batch_sizes(bundle.decoder, seen)
    result = runner.test_by_task(cfg, bundle, task, epochs=1,
                                 dataset=items if distributed.is_main() else None)
    hook.remove()
    return {"result": result, "seen": seen}


def eval_main(cfg, device):
    """``test.main`` in a process of its own (its synthetic sets seeded by
    that process's ``PYTHONHASHSEED``)."""
    torch.set_num_threads(1)
    return ttest.main(cfg, device=device)
