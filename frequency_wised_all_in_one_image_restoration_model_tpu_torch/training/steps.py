"""Train steps for the two training phases (the port of the JAX
``training/steps.py``; reference train.py:73-96).

  phase A (epoch < epochs_encoder): contrastive loss only, through MoCo;
  phase B: the whole AirNet: L1 (+ optional frequency-band L1) + weighted
  contrastive loss.

Inside one step the order is MoCo's: momentum-update the key encoder with
the *pre-step* query parameters (moco.py:132), encode the keys without
gradients in train mode (its own BatchNorm statistics, moco.py:131-136),
encode the queries, per-band InfoNCE logits against the *old* queue
(moco.py:141-156), loss, backward, Adam, then ring-enqueue the new keys
(moco.py:164).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ..models import moco
from ..models.airnet import ModelBundle
from . import losses
from .state import TrainState, reproducible_backends

ARRAY_BATCH_KEYS = ("d1", "d2", "c1", "c2", "de_id")


def array_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """The array fields of a loader batch as tensors on ``device`` (drops
    host-side metadata such as image names)."""
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device)
            for k in ARRAY_BATCH_KEYS if k in batch}


def global_norm(params) -> torch.Tensor:
    """The L2 norm of all gradients (optax ``global_norm``), in a few
    launches whatever the number of parameters."""
    grads = [p.grad for p in params if p.grad is not None]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def make_train_step(cfg, bundle: ModelBundle, joint: bool,
                    upto: str = "full") -> Callable:
    """Build the step of one phase; ``joint=False`` is phase A. The step
    changes ``state`` in place and returns ``(state, metrics)`` with the
    metrics as 0-d tensors on the device (no host sync).

    ``upto`` cuts the step short for timing: ``"loss"`` stops after the
    forward (key branch + loss value), ``"grads"`` after the backward (adds
    ``gnorm``), ``"full"`` is the real step. The cut variants still
    momentum-update the key encoder and move the BatchNorm statistics."""
    if upto not in ("loss", "grads", "full"):
        raise ValueError(f"upto must be loss / grads / full, got {upto!r}")
    del bundle  # the modules a step runs are the state's
    reproducible_backends()

    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        gen = state.generator
        enc_k = state.moco.encoder_k

        # --- key branch: EMA update then no-grad forward (moco.py:131-136)
        moco.momentum_update(enc_k, state.encoder)
        with torch.no_grad():
            _, k_list, _ = enc_k(batch["d2"], gen)
            k = moco.normalize_bands(k_list)

        with torch.set_grad_enabled(upto != "loss"):
            _, q_list, ctx = state.encoder(batch["d1"], gen)
            q = moco.normalize_bands(q_list)
            logits = moco.contrastive_logits(q, k, state.moco.queue)
            closs = moco.contrastive_loss(logits)
            if joint:
                restored = state.decoder(batch["d1"], ctx, gen)
                total, l1 = losses.restoration_loss(cfg, restored,
                                                    batch["c1"], closs)
            else:
                total, l1 = closs, torch.zeros((), device=closs.device)
        metrics = {"loss": total.detach(), "contrast_loss": closs.detach(),
                   "l1_loss": l1.detach()}
        state.step += 1
        if upto == "loss":
            return state, metrics

        params = state.parameters()
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        if upto == "grads":
            metrics["gnorm"] = global_norm(params)
            return state, metrics

        # a parameter the loss did not reach (the decoder in phase A) takes a
        # zero gradient, not none: Adam then counts the step for it too, as
        # an update over the whole tree does
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        state.optimizer.step()

        state.moco.queue, state.moco.queue_ptr = moco.dequeue_and_enqueue(
            state.moco.queue, state.moco.queue_ptr, k)
        return state, metrics

    return step


def train_steps(cfg, bundle: ModelBundle):
    """``(encoder_step, joint_step)``."""
    return (make_train_step(cfg, bundle, joint=False),
            make_train_step(cfg, bundle, joint=True))
