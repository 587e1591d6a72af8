"""The device mesh and the sharding rules (the port of the JAX
``parallel/mesh.py``).

The JAX package shards one SPMD program over a ``('data', 'task',
'model')`` mesh: the batch's leading axis is split over ``('data',
'task')`` in device order, the state is replicated or, under
:func:`shard_params`, its large kernels column-sharded over ``model``, and
XLA inserts the collectives. The port runs one process per card, one rank
per process, with the same layout made explicit:

* rank ``r`` of ``world = n_data * n_task * n_model`` sits at mesh
  coordinates ``(d, t, m)`` with ``r = (d * n_task + t) * n_model + m``
  (:func:`coordinates`; JAX's device ids in :func:`make_mesh`). Its batch
  index is ``b = d * n_task + t`` of ``n_data * n_task`` batch groups, and
  it holds rows ``[b * per, (b + 1) * per)`` of the global batch
  (:func:`rows_of`), the block JAX's ``P(('data', 'task'))`` gives device
  ``r``: the ``n_model`` ranks of one model group hold the same rows;
* the state is equal on every rank: broadcast from rank 0 at the start
  (:func:`replicate_state`) and kept equal by the steps (gradients averaged
  over the batch group, BatchNorm on the global batch's statistics, the
  MoCo queue fed the gathered keys; ``training/steps.py``,
  ``models/layers.py``);
* a random draw is the global batch's draw, the batch index's rows kept
  (:class:`RankRows`), so that a step on N ranks equals the step on one
  device.

The ``model`` axis is JAX's tensor-parallel hook. JAX's rule
(:func:`param_partition_spec`) fixes where each parameter's columns are
stored; XLA then picks the collectives, and gathering a sharded weight
before it is used is one of the schedules it may pick. The port's block
kernels (K1-K8) take whole weights: making them compute column blocks
would redesign eight kernels, and at the model's widths (28-896) JAX's own
docstring finds that tensor parallelism buys nothing. So the port keeps
the compute whole. :func:`shard_params` makes the master copy of each
sharded parameter, and its two Adam moments, the rank's column block; the
full weight the modules and kernels read is a copy gathered over the model
group after every Adam step (``training/steps.py``). A rank then holds
Adam moments for its blocks and the replicated leaves only, and its
gradient all-reduce carries the same elements.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

BATCH_AXES = ("data", "task")
MODEL_AXIS = "model"
MESH_AXES = BATCH_AXES + (MODEL_AXIS,)


def make_mesh(n_data: int, n_task: int = 1, n_model: int = 1,
              device_type: str = "cpu"):
    """The ``('data', 'task', 'model')`` mesh of ``n_data * n_task *
    n_model`` ranks in rank order (JAX's device ids), as a ``DeviceMesh``.
    It is a layout: the port's collectives run over the sub-groups
    ``parallel/distributed.py`` makes. Under a process group its size must
    be the group's; without one the mesh is the layout alone (rank 0's
    view), at world 1 too."""
    if n_data < 1 or n_task < 1 or n_model < 1:
        raise ValueError(f"mesh sizes must be at least 1, got data {n_data} "
                         f"task {n_task} model {n_model}")
    from torch.distributed.device_mesh import DeviceMesh

    world, rank = n_data * n_task * n_model, 0
    if dist.is_initialized():
        rank = dist.get_rank()
        if dist.get_world_size() != world:
            raise ValueError(f"a mesh of {world} ranks in a process group of "
                             f"{dist.get_world_size()}")
    layout = torch.arange(world).reshape(n_data, n_task, n_model)
    return DeviceMesh(device_type, layout, mesh_dim_names=MESH_AXES,
                      _init_backend=False, _rank=rank)


def coordinates(rank: int, n_task: int = 1, n_model: int = 1
                ) -> Tuple[int, int, int]:
    """The mesh coordinates ``(d, t, m)`` of ``rank`` in :func:`make_mesh`'s
    layout; its batch index is ``d * n_task + t = rank // n_model``."""
    b, m = divmod(rank, n_model)
    d, t = divmod(b, n_task)
    return d, t, m


def rows_of(n_global: int, index: int, groups: int) -> slice:
    """The rows of a global batch of ``n_global`` that batch index
    ``index`` of ``groups`` holds: a contiguous block, ``ValueError`` when
    the batch does not divide."""
    if n_global % groups:
        raise ValueError(f"global batch {n_global} not divisible by "
                         f"{groups} batch groups")
    per = n_global // groups
    return slice(index * per, (index + 1) * per)


def shard_batch(batch: Dict, index: int, groups: int) -> Dict:
    """Batch index ``index``'s rows of every array field of a global batch;
    list fields (image names) are cut the same way, others kept."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 1:
            out[k] = v[rows_of(v.shape[0], index, groups)]
        elif isinstance(v, list):
            out[k] = v[rows_of(len(v), index, groups)]
        else:
            out[k] = v
    return out


class RankRows:
    """A generator as one rank draws from it: :meth:`rand` draws the global
    batch's values and keeps the rows of the rank's batch index, so that
    every rank's generator advances as the one device's does and the draws
    equal that device's. ``per`` is the images a rank holds; a leading axis
    of ``g * per`` rows holds ``g`` groups of them (the Uformer encoder
    folds its ``L`` bands into the batch band-major, ``[L * b]``), and batch
    index ``i`` of ``groups`` holds rows ``l * B + i * per ... l * B + (i +
    1) * per - 1`` of group ``l`` of the global draw."""

    def __init__(self, generator: Optional[torch.Generator], index: int,
                 groups: int, per: int):
        self.generator, self.index, self.groups, self.per = (
            generator, index, groups, per)

    def rand(self, shape: Sequence[int], device) -> torch.Tensor:
        shape = tuple(shape)
        if shape[0] % self.per:
            raise ValueError(f"{shape[0]} rows are no multiple of the "
                             f"{self.per} images a rank holds")
        groups = shape[0] // self.per
        draw = torch.rand((groups * self.groups * self.per, *shape[1:]),
                          generator=self.generator, device=device)
        return draw.reshape(groups, self.groups, self.per,
                            *shape[1:])[:, self.index].reshape(shape)


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


@dataclasses.dataclass
class Shard:
    """One parameter sharded over ``model``: ``param`` is the full weight
    the modules read, ``block`` the master copy Adam steps, the rank's
    slice of ``param`` along ``axis``."""
    name: str             # "<encoder | decoder>.<parameter name>"
    param: nn.Parameter
    block: torch.Tensor
    axis: int


class ParamShards:
    """The sharded parameters of one rank's train state (:func:`shard_params`):
    model index ``index`` of ``n_model`` holds block ``index`` of each, the
    contiguous slice ``[index * k, (index + 1) * k)`` of its axis, ``k =
    size / n_model`` (JAX's shard order)."""

    def __init__(self, shards: List[Shard], index: int, n_model: int):
        self.shards, self.index, self.n_model = shards, index, n_model
        self._by_param = {s.param: s for s in shards}

    def master(self, p: torch.Tensor) -> torch.Tensor:
        """The tensor the optimizer steps for parameter ``p``: its block
        where it is sharded, else ``p`` itself."""
        s = self._by_param.get(p)
        return p if s is None else s.block

    def block_of(self, p: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``full`` (a tensor shaped like ``p``, such
        as a moment of it) where ``p`` is sharded, else ``full`` itself."""
        s = self._by_param.get(p)
        if s is None:
            return full
        k = s.block.shape[s.axis]
        return full.narrow(s.axis, self.index * k, k)

    def stage_grads(self) -> None:
        """Give every block the rank's slice of its parameter's gradient
        and drop the full gradient (the next backward starts from none)."""
        for s in self.shards:
            s.block.grad = self.block_of(s.param, s.param.grad).clone()
            s.param.grad = None

    def refresh(self) -> None:
        """Set every block from its full parameter (after a load)."""
        with torch.no_grad():
            for s in self.shards:
                s.block.copy_(self.block_of(s.param, s.param))


def shard_params(state, mesh, min_dim: int = 128):
    """Shard ``state``'s (a ``training.state.TrainState``) parameters over
    ``mesh``'s ``model`` axis under :func:`param_partition_spec` (JAX's
    name): each sharded parameter's master copy becomes this rank's block
    (``mesh.get_coordinate()``'s model index), Adam is rebuilt over the
    blocks and the replicated leaves in the parameter order, and any Adam
    history is cut to the blocks. The full parameters stay, as the copies
    the modules read. The key encoder, the queue and the BatchNorm
    statistics stay replicated, as JAX's test shards ``params`` only. A
    no-op at ``n_model = 1``; returns ``state``."""
    n_model = mesh.size(MESH_AXES.index(MODEL_AXIS))
    if n_model == 1:
        return state
    if state.shards is not None:
        raise ValueError("the train state is sharded already")
    from . import distributed

    if distributed.active() and distributed.model_axis() != n_model:
        raise ValueError(f"a mesh of model axis {n_model} in a process group "
                         f"of model axis {distributed.model_axis()}")
    index = mesh.get_coordinate()[MESH_AXES.index(MODEL_AXIS)]
    shards = []
    for net in ("encoder", "decoder"):
        module = getattr(state, net)
        specs = partition_specs(module, n_model, min_dim)
        for name, p in module.named_parameters():
            if MODEL_AXIS not in specs[name]:
                continue
            axis = specs[name].index(MODEL_AXIS)
            k = p.shape[axis] // n_model
            shards.append(Shard(f"{net}.{name}", p,
                                p.detach().narrow(axis, index * k, k).clone(),
                                axis))
    sharded = ParamShards(shards, index, n_model)
    old = state.optimizer
    opt = torch.optim.Adam([sharded.master(p) for p in state.parameters()],
                           **old.defaults)
    opt.param_groups[0]["lr"] = old.param_groups[0]["lr"]
    for p in state.parameters():
        st = old.state.get(p)
        if st:
            opt.state[sharded.master(p)] = {
                "step": st["step"].clone(),
                **{k: sharded.block_of(p, st[k]).clone()
                   for k in ("exp_avg", "exp_avg_sq")}}
    state.optimizer, state.shards = opt, sharded
    return state


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
