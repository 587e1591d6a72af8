"""The device mesh and the sharding rules (the port of the JAX
``parallel/mesh.py``).

The JAX package shards one SPMD program over a ``('data', 'task',
'model')`` mesh: the batch's leading axis is split over ``('data',
'task')`` in device order, the state is replicated, and XLA inserts the
collectives. The port runs one process per card, one rank per process,
with the same layout made explicit:

* rank ``r`` of ``world = n_data * n_task`` holds rows ``[r * per,
  (r + 1) * per)`` of the global batch (:func:`rows_of`), the block that
  device ``d * n_task + t = r`` holds in JAX;
* the state is equal on every rank: broadcast from rank 0 at the start
  (:func:`replicate_state`) and kept equal by the steps (gradients averaged
  over the ranks, BatchNorm on the global batch's statistics, the MoCo
  queue fed the gathered keys; ``training/steps.py``, ``models/layers.py``);
* a random draw is the global batch's draw, this rank's rows kept
  (:class:`RankRows`), so that a step on N ranks equals the step on one
  device.

The ``model`` axis is JAX's tensor-parallel hook: size 1 from every flag.
:func:`param_partition_spec` keeps its rule in torch layouts; a mesh with
``n_model > 1`` is not ported (ROADMAP.md, Queue 1 item 10.8).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

BATCH_AXES = ("data", "task")
MODEL_AXIS = "model"
MESH_AXES = BATCH_AXES + (MODEL_AXIS,)


def make_mesh(n_data: int, n_task: int = 1, n_model: int = 1,
              device_type: str = "cpu"):
    """The ``('data', 'task', 'model')`` mesh of ``n_data * n_task`` ranks in
    rank order, as a ``DeviceMesh``. It is a layout: the port's collectives
    run over the default process group, and no sub-group is made. Under a
    process group its size must be the group's; without one the mesh is the
    layout alone (rank 0's view), at world 1 too."""
    if n_model != 1:
        raise NotImplementedError(
            f"n_model = {n_model}: the tensor-parallel 'model' axis is not "
            "ported (ROADMAP.md, Queue 1 item 10.8)")
    if n_data < 1 or n_task < 1:
        raise ValueError(f"mesh sizes must be at least 1, got data {n_data} "
                         f"task {n_task}")
    from torch.distributed.device_mesh import DeviceMesh

    world, rank = n_data * n_task, 0
    if dist.is_initialized():
        rank = dist.get_rank()
        if dist.get_world_size() != world:
            raise ValueError(f"a mesh of {world} ranks in a process group of "
                             f"{dist.get_world_size()}")
    layout = torch.arange(world).reshape(n_data, n_task, n_model)
    return DeviceMesh(device_type, layout, mesh_dim_names=MESH_AXES,
                      _init_backend=False, _rank=rank)


def rows_of(n_global: int, rank: int, world: int) -> slice:
    """The rows of a global batch of ``n_global`` that ``rank`` holds: a
    contiguous block, ``ValueError`` when the batch does not divide."""
    if n_global % world:
        raise ValueError(f"global batch {n_global} not divisible by "
                         f"{world} ranks")
    per = n_global // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch: Dict, rank: int, world: int) -> Dict:
    """This rank's rows of every array field of a global batch; list fields
    (image names) are cut the same way, others kept."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 1:
            out[k] = v[rows_of(v.shape[0], rank, world)]
        elif isinstance(v, list):
            out[k] = v[rows_of(len(v), rank, world)]
        else:
            out[k] = v
    return out


class RankRows:
    """A generator as one rank draws from it: :meth:`rand` draws the global
    batch's values and keeps this rank's rows, so that every rank's
    generator advances as the one device's does and the draws equal that
    device's. ``per`` is the images a rank holds; a leading axis of
    ``g * per`` rows holds ``g`` groups of them (the Uformer encoder folds
    its ``L`` bands into the batch band-major, ``[L * b]``), and rank ``r``
    holds rows ``l * B + r * per ... l * B + (r + 1) * per - 1`` of group
    ``l`` of the global draw."""

    def __init__(self, generator: Optional[torch.Generator], rank: int,
                 world: int, per: int):
        self.generator, self.rank, self.world, self.per = (
            generator, rank, world, per)

    def rand(self, shape: Sequence[int], device) -> torch.Tensor:
        shape = tuple(shape)
        if shape[0] % self.per:
            raise ValueError(f"{shape[0]} rows are no multiple of the "
                             f"{self.per} images a rank holds")
        groups = shape[0] // self.per
        draw = torch.rand((groups * self.world * self.per, *shape[1:]),
                          generator=self.generator, device=device)
        return draw.reshape(groups, self.world, self.per,
                            *shape[1:])[:, self.rank].reshape(shape)


def rand(shape: Sequence[int], generator, device) -> torch.Tensor:
    """``torch.rand`` from a ``torch.Generator`` (or none), or the rank's
    rows of the global draw from a :class:`RankRows`."""
    if isinstance(generator, RankRows):
        return generator.rand(shape, device)
    return torch.rand(tuple(shape), generator=generator, device=device)


def replicate_state(state) -> None:
    """Make ``state`` (a ``training.state.TrainState``) equal on every rank:
    rank 0's train-state tree broadcast, loaded in place elsewhere (JAX's
    ``replicate_tree``). A no-op outside a group or at world 1."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    from ..training import checkpoint

    tree = None
    if dist.get_rank() == 0:
        tree = _to_cpu(checkpoint.state_tree(state))
    box = [tree]
    dist.broadcast_object_list(box, src=0)
    if dist.get_rank() != 0:
        checkpoint.load_state_tree(state, box[0])


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def param_partition_spec(module: nn.Module, name: str, param: torch.Tensor,
                         n_model: int, min_dim: int = 128
                         ) -> Tuple[Optional[str], ...]:
    """The tensor-parallel rule of one parameter in torch layouts, as a
    ``PartitionSpec``'s entries: the output-feature axis of a Linear weight
    ``[out, in]`` or a convolution's ``[out, in, kh, kw]`` (dim 0), of a
    transposed convolution's ``[in, out, kh, kw]`` (dim 1), sharded over
    ``model`` when it divides and is at least ``min_dim`` wide; everything
    else (biases, norms, tables, the raw DCN weights) replicated. These are
    the leaves JAX's rule shards: the Flax ``kernel`` leaves."""
    spec = [None] * param.ndim
    if n_model <= 1 or name != "weight":
        return tuple(spec)
    if isinstance(module, (nn.Linear, nn.Conv2d)):
        axis = 0
    elif isinstance(module, nn.ConvTranspose2d):
        axis = 1
    else:
        return tuple(spec)
    out = param.shape[axis]
    if out % n_model == 0 and out >= min_dim:
        spec[axis] = MODEL_AXIS
    return tuple(spec)


def partition_specs(model: nn.Module, n_model: int, min_dim: int = 128
                    ) -> Dict[str, Tuple[Optional[str], ...]]:
    """:func:`param_partition_spec` of every parameter, by its name."""
    out = {}
    for mod_name, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            out[full] = param_partition_spec(module, name, p, n_model, min_dim)
    return out


def tile_batch(batch: Dict, factor: int) -> Dict:
    """Grow the batch by repeating its samples ``factor`` times."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1:
            out[k] = np.concatenate([v] * factor, axis=0)
        elif isinstance(v, list):
            out[k] = v * factor
        else:
            out[k] = v
    return out


def concat_batches(batches) -> Dict:
    """Loader batches joined along the batch axis: the global batch of a
    ``mesh_data``-wide mesh (list fields join as lists)."""
    out = {}
    for k, v in batches[0].items():
        if isinstance(v, np.ndarray) and v.ndim >= 1:
            out[k] = np.concatenate([np.asarray(b[k]) for b in batches], 0)
        elif isinstance(v, list):
            out[k] = sum((b[k] for b in batches), [])
        else:
            out[k] = v
    return out
