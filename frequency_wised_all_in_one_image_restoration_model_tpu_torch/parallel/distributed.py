"""Ranks, the process group and the collectives of a multi-GPU run (the
port of the JAX package's ``parallel/distributed.py``).

One process per card, one rank per process. ``--mesh_data`` /
``--mesh_task`` set the number of ranks, ``world = mesh_data * mesh_task``,
times the ``n_model`` a caller of :func:`spawn` / :func:`initialize` asks
for (JAX reaches its ``model`` axis through ``make_mesh`` alone, with no
flag); :func:`spawn` starts them from an entry point:

* without ``--coordinator_address`` one process starts every rank on this
  host, on a local TCP store (JAX's single-process mesh over local
  devices);
* with ``--coordinator_address host:port --num_processes P --process_id p``
  each of ``P`` processes (one a host) starts ``world / P`` ranks, and rank
  ``p * (world / P) + i`` runs on ``cuda:i``: JAX's process-major device
  order.

The backend follows the device: NCCL for CUDA tensors, gloo on the CPU,
never one in place of the other. Data feeding is JAX's contract: every rank
builds the same loader from the same seed, draws the global batch and keeps
the rows of its batch index (:func:`process_slice`).

With a ``model`` axis of ``n_model > 1`` (:func:`form_groups`) rank ``r``
has batch index ``r // n_model`` and model index ``r % n_model``
(``mesh.coordinates``). The collectives of the batch (the rows, the draws,
the BatchNorm moments, the key gather, the metrics' and the gradients'
means) run over the **batch group**, the ranks of one model index, and
divide by its size, the number of batch groups; :func:`gather_blocks`
joins the sharded parameters' blocks over the **model group**, the ranks
of one batch index. At ``n_model = 1`` the batch group is the world.

Outside a process group every function here is the one-device case: rank 0
of 1, the collectives the identity.
"""

from __future__ import annotations

import io
import queue as queue_lib
import socket
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import mesh as mesh_lib


def world_of(cfg) -> int:
    """The ranks the configuration asks for."""
    return cfg.mesh_data * cfg.mesh_task


def active() -> bool:
    """Whether this process is a rank of a process group."""
    return dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def is_main() -> bool:
    """Rank 0 logs, prints, writes the checkpoints and scores the eval."""
    return rank() == 0


def initialize(cfg, device, rank_: int, address: str, n_model: int = 1
               ) -> None:
    """Join the process group of ``world_of(cfg) * n_model`` ranks as
    ``rank_``, the store at ``tcp://<address>``, and make its sub-groups
    (:func:`form_groups`); on a CUDA device make it the current one
    (NCCL's communicators and the object collectives use it)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://{address}",
                            world_size=world_of(cfg) * n_model, rank=rank_)
    form_groups(n_model)


class _ModelAxis:
    """The ``model`` axis of one process group: its size and this rank's
    batch group and model group (``None`` for the batch group means the
    whole group)."""

    def __init__(self, pg=None, n_model: int = 1, batch=None, model=None):
        self.pg, self.n_model, self.batch, self.model = pg, n_model, batch, model


# the axis of the current process group; the process group itself is
# process-wide state of torch.distributed, and its sub-groups with it
_AXIS = _ModelAxis()


def form_groups(n_model: int = 1) -> None:
    """Give the current process group a ``model`` axis of ``n_model``: every
    rank calls it, and makes every batch group (the ranks of one model
    index), then every model group (the ranks of one batch index), in that
    order (``dist.new_group``). At ``n_model = 1`` it makes none: the batch
    group is the world, and every collective runs as without an axis."""
    global _AXIS
    world_, rank_ = dist.get_world_size(), dist.get_rank()
    if n_model < 1 or world_ % n_model:
        raise ValueError(f"a model axis of {n_model} in {world_} ranks")
    batch = model = None
    if n_model > 1:
        for m in range(n_model):
            g = dist.new_group([r for r in range(world_) if r % n_model == m])
            if rank_ % n_model == m:
                batch = g
        for b in range(world_ // n_model):
            g = dist.new_group(list(range(b * n_model, (b + 1) * n_model)))
            if rank_ // n_model == b:
                model = g
    _AXIS = _ModelAxis(dist.group.WORLD, n_model, batch, model)


def _axis() -> _ModelAxis:
    """The current group's axis; size 1 outside a group, or in a group
    whose sub-groups :func:`form_groups` never made."""
    if active() and _AXIS.pg is dist.group.WORLD:
        return _AXIS
    return _ModelAxis()


def model_axis() -> int:
    """``n_model``: the ranks of one model group."""
    return _axis().n_model


def batch_groups() -> int:
    """The number of batch groups, ``n_data * n_task``: the ranks of one
    batch group."""
    return world() // model_axis()


def batch_index() -> int:
    """This rank's batch index, ``d * n_task + t``."""
    return rank() // model_axis()


def model_index() -> int:
    """This rank's model index ``m``."""
    return rank() % model_axis()


def process_slice(n_global: int) -> slice:
    """The rows of a global batch of ``n_global`` (or of a table with a
    slot per sample of it) that this rank holds; ``ValueError`` when it
    does not divide by the batch groups."""
    return mesh_lib.rows_of(n_global, batch_index(), batch_groups())


def shard_global_batch(batch: dict) -> dict:
    """This rank's rows of a global batch (every rank holds the same)."""
    return mesh_lib.shard_batch(batch, batch_index(), batch_groups())


def rank_generator(generator: torch.Generator, per: int):
    """The generator a step hands its modules: under a group a
    :class:`mesh.RankRows` (the global draw, the rows of this rank's batch
    index, ``per`` images), else the generator itself."""
    if not active():
        return generator
    return mesh_lib.RankRows(generator, batch_index(), batch_groups(), per)


def barrier() -> None:
    if active():
        dist.barrier()


def all_gather_rows(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every batch group's ``t`` (all of one shape) joined along ``dim`` in
    batch-index order."""
    if not active():
        return t
    parts = [torch.empty_like(t) for _ in range(batch_groups())]
    dist.all_gather(parts, t.contiguous(), group=_axis().batch)
    return torch.cat(parts, dim=dim)


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) over the batch group whose backward is the
    all-reduce of the gradient over the same group: over the world, each
    model group's equal gradient would be added ``n_model`` times."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=_axis().batch)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return _SumOverRanks.apply(g)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the batch groups, differentiable: its backward sums the
    gradients over them, which carries the cross-rank terms of a statistic
    taken over the global batch."""
    if not active():
        return t
    return _SumOverRanks.apply(t)


def mean_over_ranks(values: dict) -> dict:
    """``{name: 0-d tensor}`` -> ``{name: float}``, each the mean over the
    batch groups (one collective for all of them)."""
    names = sorted(values)
    if not names:
        return {}
    flat = torch.stack([values[k].detach().float().reshape(()) for k in names])
    if active():
        dist.all_reduce(flat, group=_axis().batch)
        flat = flat / batch_groups()
    return dict(zip(names, flat.tolist()))


def mean_grads(params) -> None:
    """Replace every gradient by its mean over the batch groups: one flat
    all-reduce in the fixed parameter order (each gradient set, zeros where
    the loss did not reach), summed in the collective's fixed order, so
    every rank takes the same bits. Under a model axis ``params`` are the
    optimizer's (``TrainState.masters``): a sharded parameter's block."""
    if not active():
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=_axis().batch)
    flat.div_(batch_groups())
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off:off + n].view_as(g))
        off += n


def gather_blocks(blocks: Sequence[torch.Tensor], axes: Sequence[int]
                  ) -> List[torch.Tensor]:
    """The full tensors of which every rank of the model group holds one
    block each (``blocks``, of one dtype, cut along ``axes``): one flat
    ``all_gather`` over the model group, each tensor's blocks joined along
    its axis in model-index order."""
    if not blocks:
        return []
    if len({b.dtype for b in blocks}) != 1:
        raise ValueError("blocks of more than one dtype")
    n_model = model_axis()
    if n_model == 1:
        raise ValueError("no model axis: make the group with n_model > 1")
    flat = torch.cat([b.reshape(-1) for b in blocks])
    parts = [torch.empty_like(flat) for _ in range(n_model)]
    dist.all_gather(parts, flat, group=_axis().model)
    out, off = [], 0
    for b, axis in zip(blocks, axes):
        n = b.numel()
        out.append(torch.cat([p[off:off + n].view(b.shape) for p in parts],
                             dim=axis))
        off += n
    return out


def gather_params(shards: Optional[mesh_lib.ParamShards]) -> None:
    """Write every sharded parameter's gathered blocks into the full
    parameter, in place through ``copy_`` so that its version moves and the
    kernels' cached operands of it are made anew."""
    if shards is None:
        return
    full = gather_blocks([s.block for s in shards.shards],
                         [s.axis for s in shards.shards])
    with torch.no_grad():
        for s, f in zip(shards.shards, full):
            s.param.copy_(f)


def broadcast_value(value: Any) -> Any:
    """Rank 0's ``value`` (any picklable object) on every rank."""
    if not active():
        return value
    box = [value if is_main() else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def free_port() -> int:
    """A free TCP port on this host for the local store."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dumps(value) -> bytes:
    buf = io.BytesIO()
    torch.save(value, buf)
    return buf.getvalue()


def _rank_main(local: int, fn, cfg, device_type: str, base: int,
               address: str, results, threads: int, n_model: int,
               args) -> None:
    """One rank: join the group, run ``fn(cfg, device, *args)``, send its
    result (serialised, on the CPU) or the traceback to the starter."""
    rank_ = base + local
    try:
        if device_type == "cpu":
            torch.set_num_threads(threads)
            device = torch.device("cpu")
        else:
            device = torch.device("cuda", local)
        initialize(cfg, device, rank_, address, n_model)
        try:
            value = fn(cfg, device, *args)
        finally:
            dist.destroy_process_group()
        results.put((local, True, _dumps(value)))
    except BaseException:
        results.put((local, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, cfg, device, *args, n_model: int = 1,
          timeout: float = 3600.0) -> List[Any]:
    """Run ``fn(cfg, device, *args)`` on this host's ranks, each in a process
    of its own (the ``spawn`` start method; ``fn`` importable by name, its
    arguments picklable), and return their results in rank order. The world
    is ``world_of(cfg) * n_model`` ranks with a ``model`` axis of
    ``n_model``. ``device`` ``"cpu"`` runs gloo ranks on the CPU, each on as
    many threads as this process uses; a CUDA device runs NCCL ranks on
    ``cuda:0 ...``. A rank that raises ends the others, and this raises
    with its traceback."""
    world_ = world_of(cfg) * n_model
    nproc = cfg.num_processes if cfg.coordinator_address else 1
    if world_ % nproc:
        raise ValueError(f"{world_} ranks do not divide over {nproc} processes")
    local = world_ // nproc
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() < local:
        raise RuntimeError(f"{local} ranks on this host, "
                           f"{torch.cuda.device_count()} CUDA devices")
    if cfg.coordinator_address:
        address, base = cfg.coordinator_address, cfg.process_id * local
    else:
        address, base = f"localhost:{free_port()}", 0
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = mp.start_processes(
        _rank_main, args=(fn, cfg, device.type, base, address, results,
                          torch.get_num_threads(), n_model, args),
        nprocs=local, join=False, start_method="spawn")
    got = {}
    try:
        waited = 0.0
        while len(got) < local:
            try:
                i, ok, payload = results.get(timeout=1.0)
            except queue_lib.Empty:
                waited += 1.0
                procs.join(timeout=0)   # raises if a rank died
                if waited > timeout:
                    raise TimeoutError(f"ranks gave no result in {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {base + i} failed:\n{payload}")
            got[i] = torch.load(io.BytesIO(payload), map_location="cpu",
                                weights_only=True)
        while not procs.join(timeout=60):
            pass
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
        for p in procs.processes:
            p.join(timeout=30)
    return [got[i] for i in range(local)]


def needs_spawn(cfg) -> bool:
    """Whether an entry point must start its ranks: more than one asked
    for, and this process is not a rank yet."""
    return world_of(cfg) > 1 and not active()

