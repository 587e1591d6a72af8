"""Training losses: L1, frequency-band L1, and the joint objective (the port
of the JAX ``training/losses.py``; reference train.py:63-92).
"""

from __future__ import annotations

import torch

from ..ops import frequency


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error (torch nn.L1Loss default reduction)."""
    return (pred.float() - target.float()).abs().mean()


def frequency_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                      num_bands: int) -> torch.Tensor:
    """L1 between the per-band masked spectra of pred and target. The
    reference decomposes with ``inverse=False``: stacked (real, imag)
    spectra, not spatial reconstructions (train.py:69-70, 91). Inputs are
    NHWC; the FFT runs over H, W."""
    sp = frequency.frequency_decompose(pred.permute(0, 3, 1, 2), num_bands,
                                       inverse=False)
    st = frequency.frequency_decompose(target.permute(0, 3, 1, 2), num_bands,
                                       inverse=False)
    return (sp - st).abs().mean()


def restoration_loss(cfg, restored, clean, contrast_loss):
    """Joint-phase objective (train.py:87-92). Returns ``(loss, l1 term)``."""
    l1 = l1_loss(restored, clean)
    if cfg.num_frequency_bands_l1 != -1:
        l1 = l1 + cfg.frequency_l1_loss_weight * frequency_l1_loss(
            restored, clean, cfg.num_frequency_bands_l1)
    total = l1 + cfg.contrast_loss_weight * contrast_loss
    return total, l1
