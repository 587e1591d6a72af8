"""Ranks, the process group and the collectives of a multi-GPU run (the
port of the JAX package's ``parallel/distributed.py``).

One process per card, one rank per process. ``--mesh_data`` /
``--mesh_task`` set the number of ranks, ``world = mesh_data * mesh_task``;
:func:`spawn` starts them from an entry point:

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
its rows (:func:`process_slice`).

Outside a process group every function here is the one-device case: rank 0
of 1, the collectives the identity.
"""

from __future__ import annotations

import io
import queue as queue_lib
import socket
import traceback
from typing import Any, Callable, List

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


def initialize(cfg, device, rank_: int, address: str) -> None:
    """Join the process group of ``world_of(cfg)`` ranks as ``rank_``, the
    store at ``tcp://<address>``; on a CUDA device make it the current one
    (NCCL's communicators and the object collectives use it)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://{address}",
                            world_size=world_of(cfg), rank=rank_)


def process_slice(n_global: int) -> slice:
    """The rows of a global batch of ``n_global`` (or of a table with a
    slot per sample of it) that this rank holds; ``ValueError`` when it
    does not divide by the ranks."""
    return mesh_lib.rows_of(n_global, rank(), world())


def shard_global_batch(batch: dict) -> dict:
    """This rank's rows of a global batch (every rank holds the same)."""
    return mesh_lib.shard_batch(batch, rank(), world())


def rank_generator(generator: torch.Generator, per: int):
    """The generator a step hands its modules: under a group a
    :class:`mesh.RankRows` (the global draw, this rank's rows of ``per``
    images), else the generator itself."""
    if not active():
        return generator
    return mesh_lib.RankRows(generator, rank(), world(), per)


def barrier() -> None:
    if active():
        dist.barrier()


def all_gather_rows(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (all of one shape) joined along ``dim`` in rank
    order."""
    if not active():
        return t
    parts = [torch.empty_like(t) for _ in range(world())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts, dim=dim)


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) whose backward is the all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return _SumOverRanks.apply(g)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks, differentiable: its backward sums the
    gradients over the ranks, which carries the cross-rank terms of a
    statistic taken over the global batch."""
    if not active():
        return t
    return _SumOverRanks.apply(t)


def mean_over_ranks(values: dict) -> dict:
    """``{name: 0-d tensor}`` -> ``{name: float}``, each the mean over the
    ranks (one collective for all of them)."""
    names = sorted(values)
    if not names:
        return {}
    flat = torch.stack([values[k].detach().float().reshape(()) for k in names])
    if active():
        dist.all_reduce(flat)
        flat = flat / world()
    return dict(zip(names, flat.tolist()))


def mean_grads(params) -> None:
    """Replace every gradient by its mean over the ranks: one flat
    all-reduce in the fixed parameter order (each gradient set, zeros where
    the loss did not reach), summed in the collective's fixed order, so
    every rank takes the same bits."""
    if not active():
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat.div_(world())
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off:off + n].view_as(g))
        off += n


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
               address: str, results, threads: int, args) -> None:
    """One rank: join the group, run ``fn(cfg, device, *args)``, send its
    result (serialised, on the CPU) or the traceback to the starter."""
    rank_ = base + local
    try:
        if device_type == "cpu":
            torch.set_num_threads(threads)
            device = torch.device("cpu")
        else:
            device = torch.device("cuda", local)
        initialize(cfg, device, rank_, address)
        try:
            value = fn(cfg, device, *args)
        finally:
            dist.destroy_process_group()
        results.put((local, True, _dumps(value)))
    except BaseException:
        results.put((local, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, cfg, device, *args, timeout: float = 3600.0
          ) -> List[Any]:
    """Run ``fn(cfg, device, *args)`` on this host's ranks, each in a process
    of its own (the ``spawn`` start method; ``fn`` importable by name, its
    arguments picklable), and return their results in rank order. ``device``
    ``"cpu"`` runs gloo ranks on the CPU, each on as many threads as this
    process uses; a CUDA device runs NCCL ranks on ``cuda:0 ...``. A rank
    that raises ends the others, and this raises with its traceback."""
    world_ = world_of(cfg)
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
                          torch.get_num_threads(), args),
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

