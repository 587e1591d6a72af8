"""MoCo: momentum contrast as explicit state (the port of the JAX
``models/moco.py``; reference net/utils/moco.py:6-170).

The key encoder is a second :class:`UformerEncoder` module: its parameters
are the momentum average of the query encoder's, its BatchNorm statistics
are its own. The negative queue ``[num_losses, dim, K]`` holds L2-normalised
key columns and is written through a ring pointer. Nothing here takes a
gradient except the query side of :func:`contrastive_logits`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ..ops.metrics import full_float32


@dataclasses.dataclass
class MoCoState:
    """Non-gradient MoCo state (key encoder + negative queue)."""

    encoder_k: nn.Module       # parameters: EMA of the query encoder's; own BN stats
    queue: torch.Tensor        # [num_losses, dim, K], L2-normalised columns
    queue_ptr: torch.Tensor    # int64 scalar ring pointer (moco.py:42)


def init_queue(generator: torch.Generator, num_losses: int, dim: int,
               K: int) -> torch.Tensor:
    """randn on the generator's device, then per-band L2-normalise along dim
    (moco.py:38-40)."""
    q = torch.randn(num_losses, dim, K, generator=generator,
                    device=generator.device)
    return q / torch.linalg.vector_norm(q, dim=1, keepdim=True)


@torch.no_grad()
def momentum_update(encoder_k: nn.Module, encoder_q: nn.Module,
                    m: float = 0.999) -> None:
    """param_k <- m * param_k + (1 - m) * param_q, in place (moco.py:44-50).
    Parameters only: BatchNorm statistics evolve separately."""
    for pk, pq in zip(encoder_k.parameters(), encoder_q.parameters()):
        pk.mul_(m).add_(pq.detach().to(pk.dtype), alpha=1.0 - m)


def normalize_bands(q: torch.Tensor) -> torch.Tensor:
    """L2-normalise ``[num_losses, B, dim]`` along dim (moco.py:127-128)."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)


def contrastive_logits(q: torch.Tensor, k: torch.Tensor, queue: torch.Tensor,
                       T: float = 0.07) -> torch.Tensor:
    """Per-band InfoNCE logits ``[num_losses, B, 1 + K]``, the positive
    first (labels are all zeros, moco.py:141-161). ``q, k`` normalised
    ``[num_losses, B, dim]``, ``queue [num_losses, dim, K]``. Full float32:
    TF32 would perturb the logits at the 1e-3 level, and the contractions
    are tiny."""
    with full_float32():
        l_pos = (q.float() * k.float()).sum(-1, keepdim=True)
        l_neg = torch.matmul(q.float(), queue.detach().float())
    return torch.cat([l_pos, l_neg], dim=-1) / T


@torch.no_grad()
def dequeue_and_enqueue(queue: torch.Tensor, ptr: torch.Tensor,
                        keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ring-buffer write of the key batch ``[num_losses, B, dim]`` at
    ``ptr``, in place (moco.py:52-66); needs ``K % B == 0`` (K = 3 * batch by
    construction). Returns ``(queue, new pointer)``."""
    b, k = keys.shape[1], queue.shape[-1]
    if k % b:
        raise ValueError(f"queue length {k} is no multiple of the batch {b}")
    # the columns by index, so that the pointer never crosses to the host
    cols = ptr + torch.arange(b, device=queue.device)
    queue.index_copy_(2, cols, keys.transpose(1, 2).to(queue.dtype))
    return queue, (ptr + b) % k


def contrastive_loss(logits: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy against the all-zero labels, averaged over bands
    (train.py:84)."""
    return -torch.log_softmax(logits, dim=-1)[..., 0].mean()
