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
    distributed)
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


def run_steps(cfg, device, tree, batches, phases, restart=False):
    """From ``tree``, one step of each phase (``"A"`` encoder only, ``"B"``
    joint) on this rank's rows of the matching global batch, one after the
    other, or each from ``tree`` again with ``restart``. Returns, per step,
    the metrics, the gradients and the train-state tree after it, and the
    batch sizes the query encoder, key encoder and decoder forwards saw."""
    torch.set_num_threads(1)
    bundle, state = state_from_tree(cfg, device, tree)
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
                 for n, p in getattr(state, net).named_parameters()}
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "grads": grads,
                    "tree": copy.deepcopy(checkpoint.state_tree(state))})
    for h in hooks:
        h.remove()
    return {"steps": out, "seen": seen, "rank": distributed.rank()}


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
