"""Checkpoints (the port of the JAX ``training/checkpoint.py``).

The JAX package stores an Orbax tree of its whole train state in a
directory ``<ckpt_path>/epoch_<N>/``, which only JAX can read. The port's
checkpoint is one file, ``<ckpt_path>/epoch_<N>.pt``, written with
``torch.save``: ``{"encoder": state_dict, "decoder": state_dict}`` in the
port's own ``state_dict`` names (those ``utils/weights.py::from_jax``
produces from a Flax tree), which is all the eval entry point reads
(``strict=True``), and, from a training run, ``"train_state"`` beside them:
the step, the MoCo key encoder, queue and pointer, Adam's state (learning
rate, step count and both moments by parameter name) and the DropPath
generator's, so that a resumed run continues as the first would have (:func:`save` / :func:`restore`; same cadence and ``best`` rule as the
JAX package, :class:`RetentionPolicy`). Only tensors, numbers and plain
containers are stored, so every file loads with ``weights_only=True``.
Under a ``model`` mesh axis (``parallel/mesh.py::shard_params``) the tree
holds full-size moments, gathered over the model group, so a checkpoint is
the same file whatever the layout (as JAX's global arrays are); a load
cuts them to the rank's blocks again. Building the tree is then a
collective: every rank of the model group builds it, and rank 0 writes.
``tools/jax_ckpt_to_torch.py`` converts an Orbax tree into such a file.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..models.airnet import ModelBundle
from ..parallel import distributed
from .state import TrainState

MOMENTS = ("exp_avg", "exp_avg_sq")


def ckpt_file(ckpt_path: str, epoch: int) -> str:
    return os.path.abspath(os.path.join(ckpt_path, f"epoch_{epoch}.pt"))


def save_eval(ckpt_path: str, epoch: int, encoder_state: dict,
              decoder_state: dict) -> str:
    """Write ``epoch_<N>.pt`` from the two models' ``state_dict``s."""
    os.makedirs(ckpt_path, exist_ok=True)
    path = ckpt_file(ckpt_path, epoch)
    torch.save({"encoder": dict(encoder_state), "decoder": dict(decoder_state)},
               path)
    return path


def restore_eval(ckpt_path: str, epoch: int, bundle: ModelBundle) -> None:
    """Load ``epoch_<N>.pt`` into the bundle's models, every name matched."""
    state = torch.load(ckpt_file(ckpt_path, epoch), map_location=bundle.device,
                       weights_only=True)
    bundle.encoder.load_state_dict(state["encoder"], strict=True)
    bundle.decoder.load_state_dict(state["decoder"], strict=True)


def has_epoch(ckpt_path: str, epoch: int) -> bool:
    return os.path.isfile(ckpt_file(ckpt_path, epoch))


def select_eval_epoch(ckpt_path: str, requested: int) -> Optional[int]:
    """Pick the checkpoint epoch for evaluation: the requested epoch when
    ``ckpt/epoch_<requested>.pt`` exists (reference test.py:92-94 evaluates
    the named epoch), else the newest one, else None (no checkpoints)."""
    if has_epoch(ckpt_path, requested):
        return requested
    return latest_epoch(ckpt_path)


def latest_epoch(ckpt_path: str) -> Optional[int]:
    if not os.path.isdir(ckpt_path):
        return None
    epochs = []
    for name in os.listdir(ckpt_path):
        if name.startswith("epoch_") and name.endswith(".pt"):
            try:
                epochs.append(int(name[len("epoch_"):-len(".pt")]))
            except ValueError:
                pass
    return max(epochs) if epochs else None


def _train_file(ckpt_path: str, name: str) -> str:
    return os.path.abspath(os.path.join(ckpt_path, name + ".pt"))


def _named_parameters(state: TrainState):
    for net in ("encoder", "decoder"):
        for name, p in getattr(state, net).named_parameters():
            yield net, name, p


def _master(state: TrainState, p: torch.Tensor) -> torch.Tensor:
    return p if state.shards is None else state.shards.master(p)


def optimizer_tree(state: TrainState) -> dict:
    """Adam's state by parameter name: ``lr``, ``count`` (steps taken) and
    the moments ``exp_avg`` / ``exp_avg_sq`` as ``{net: {name: tensor}}``,
    full-size (a sharded parameter's gathered over the model group)."""
    opt = state.optimizer
    tree = {"lr": float(opt.param_groups[0]["lr"]), "count": 0,
            "exp_avg": {"encoder": {}, "decoder": {}},
            "exp_avg_sq": {"encoder": {}, "decoder": {}}}
    for net, name, p in _named_parameters(state):
        st = opt.state.get(_master(state, p))
        if not st:
            continue
        tree["count"] = int(st["step"])
        for k in MOMENTS:
            tree[k][net][name] = st[k]
    if state.shards is not None and tree["count"]:
        keys = [(k, *s.name.split(".", 1)) for k in MOMENTS
                for s in state.shards.shards]
        full = distributed.gather_blocks(
            [tree[k][net][name] for k, net, name in keys],
            [s.axis for s in state.shards.shards] * len(MOMENTS))
        for (k, net, name), f in zip(keys, full):
            tree[k][net][name] = f
    return tree


def load_optimizer_tree(state: TrainState, tree: dict) -> None:
    """Load :func:`optimizer_tree`'s output into the state's Adam (a
    sharded parameter's moments cut to the rank's block)."""
    opt = state.optimizer
    for group in opt.param_groups:
        group["lr"] = float(tree["lr"])
    opt.state.clear()
    count = int(tree["count"])
    if count == 0:
        return

    def moment(k, net, name, p):
        full = tree[k][net][name]
        if state.shards is not None:
            full = state.shards.block_of(p, full)
        return full.to(p.device, p.dtype).clone()

    for net, name, p in _named_parameters(state):
        opt.state[_master(state, p)] = {
            "step": torch.tensor(float(count)),
            **{k: moment(k, net, name, p) for k in MOMENTS}}


def state_tree(state: TrainState) -> dict:
    """The whole train state as tensors, numbers and plain containers."""
    return {
        "encoder": state.encoder.state_dict(),
        "decoder": state.decoder.state_dict(),
        "train_state": {
            "step": int(state.step),
            "encoder_k": state.moco.encoder_k.state_dict(),
            "queue": state.moco.queue,
            "queue_ptr": state.moco.queue_ptr,
            "optimizer": optimizer_tree(state),
            "generator": state.generator.get_state(),
        },
    }


def load_state_tree(state: TrainState, tree: dict) -> TrainState:
    """Load :func:`state_tree`'s output into ``state``, in place."""
    state.encoder.load_state_dict(tree["encoder"], strict=True)
    state.decoder.load_state_dict(tree["decoder"], strict=True)
    if state.shards is not None:
        state.shards.refresh()
    ts = tree["train_state"]
    state.step = int(ts["step"])
    state.moco.encoder_k.load_state_dict(ts["encoder_k"], strict=True)
    device = state.moco.queue.device
    state.moco.queue = ts["queue"].to(device).clone()
    state.moco.queue_ptr = ts["queue_ptr"].to(device).clone()
    load_optimizer_tree(state, ts["optimizer"])
    if ts.get("generator") is not None:  # none in a state carried over from JAX
        state.generator.set_state(ts["generator"].cpu())
    return state


def _save_tree(path: str, state: TrainState) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state_tree(state), tmp)
    os.replace(tmp, path)  # a reader never sees half a file


def save(ckpt_path: str, epoch: int, state: TrainState) -> str:
    """Write the whole train state to ``epoch_<N>.pt``."""
    path = ckpt_file(ckpt_path, epoch)
    _save_tree(path, state)
    return path


def restore(ckpt_path: str, epoch: int, state: TrainState) -> TrainState:
    """Load ``epoch_<N>.pt`` into ``state``; a file without a train state
    (an eval checkpoint) is refused."""
    path = ckpt_file(ckpt_path, epoch)
    tree = torch.load(path, map_location=state.moco.queue.device,
                      weights_only=True)
    if "train_state" not in tree:
        raise ValueError(f"{path} holds the two models only, no train state "
                         "to resume from")
    return load_state_tree(state, tree)


class RetentionPolicy:
    """Keep the last N periodic checkpoints plus the best-PSNR one
    (``best.pt``), as the JAX package does."""

    def __init__(self, ckpt_path: str, every: int = 0, keep: int = 2):
        self.ckpt_path = ckpt_path
        self.every = every
        self.keep = keep
        self.best_psnr = -float("inf")
        self.saved: list[int] = []

    def maybe_save(self, epoch: int, state: TrainState,
                   mean_psnr: Optional[float] = None) -> Optional[str]:
        path = None
        if self.every and (epoch + 1) % self.every == 0:
            path = save(self.ckpt_path, epoch + 1, state)
            self.saved.append(epoch + 1)
            while len(self.saved) > self.keep:
                old = ckpt_file(self.ckpt_path, self.saved.pop(0))
                if os.path.exists(old):
                    os.remove(old)
        if mean_psnr is not None and mean_psnr > self.best_psnr:
            self.best_psnr = mean_psnr
            path = _train_file(self.ckpt_path, "best")
            _save_tree(path, state)
        return path
