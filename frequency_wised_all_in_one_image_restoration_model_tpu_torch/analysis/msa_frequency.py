"""Attention-map frequency analysis (the port of the JAX
``analysis/msa_frequency.py``; reference plot_MSA_frequency.py:20-111).

Runs a model under :func:`models.capture.capture` (the port's counterpart
of JAX's ``sow('attn_map')`` hooks, which stand in for the reference's
``debug_mode`` plumbing) and reports the per-band energy of each attention
map. The captured forward forms the probabilities in plain PyTorch, as
JAX's does: no kernel runs the captured attention.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..models import capture
from ..ops import frequency
from .embeddings import to_numpy


def attention_band_energy(attn, num_bands: int = 5,
                          device: Optional[torch.device] = None) -> np.ndarray:
    """``[..., N, N]`` attention map (a tensor or an array) -> normalized
    per-band |spectrum| energy, float32 as JAX sums it; on ``device`` (the
    map's own by default)."""
    attn = torch.as_tensor(attn)
    if device is not None:
        attn = attn.to(device)
    mags = frequency.frequency_decompose(attn.float(), num_bands,
                                         inverse="visual")
    energy = to_numpy(mags.reshape(num_bands, -1).sum(-1))
    total = energy.sum()
    return energy / total if total > 0 else energy


def _captured(fn: Callable, root: nn.Module, name: str, *args, **kwargs
              ) -> Dict[str, torch.Tensor]:
    with torch.inference_mode(), capture.capture(root) as cap:
        fn(*args, **kwargs)
    return cap.named(name)


def collect_attention_maps(fn: Callable, root: nn.Module, *args,
                           **kwargs) -> Dict[str, np.ndarray]:
    """Call ``fn(*args, **kwargs)`` (a forward that runs ``root``, the
    counterpart of JAX's ``apply_fn(variables, ...)``) with the modules
    under ``root`` captured; return their attention maps by path."""
    return {k: to_numpy(v) for k, v in
            _captured(fn, root, "attn_map", *args, **kwargs).items()}


def model_attention_band_report(fn: Callable, root: nn.Module, x,
                                num_bands: int = 5, **kwargs
                                ) -> Dict[str, np.ndarray]:
    """Per-attention-layer band-energy histograms for an input batch; the
    energies are summed on ``root``'s device, one map at a time."""
    device = next(root.parameters()).device
    maps = _captured(fn, root, "attn_map", x, **kwargs)
    return {k: attention_band_energy(v, num_bands, device)
            for k, v in maps.items()}
