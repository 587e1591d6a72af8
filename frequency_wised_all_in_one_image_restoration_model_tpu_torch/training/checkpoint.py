"""Eval checkpoints (the port of the eval part of the JAX
``training/checkpoint.py``: ``has_epoch``, ``select_eval_epoch``,
``latest_epoch``, and a restore of the two models).

The JAX package stores an Orbax tree of its whole train state in a
directory ``<ckpt_path>/epoch_<N>/``, which only JAX can read. The port's
checkpoint is one file, ``<ckpt_path>/epoch_<N>.pt``, written with
``torch.save({"encoder": state_dict, "decoder": state_dict})`` in the
port's own ``state_dict`` names (those ``utils/weights.py::from_jax``
produces from a Flax tree) and loaded with ``strict=True``.
``tools/jax_ckpt_to_torch.py`` converts one into the other. The full train
state (optimizer, MoCo queue) comes with the training slice.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..models.airnet import ModelBundle


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
