"""Image ops of the reference's utils surface: the port of the JAX
package's ``ops/image.py``.

* :func:`edge_map` — reference ``EdgeComputation`` (utils/image_utils.py:
  14-45): mean absolute finite-difference map, each pixel accumulating its
  left/right/up/down gradients, channel-averaged, divided by 4.
* :func:`slice_image2patches` / :func:`splice_patches2image` — the
  non-overlap-aware grid patchers (utils/image_utils.py:68-98), numpy.
* :func:`gan_loss` — reference ``GANLoss`` (utils/loss_utils.py:6-45):
  LSGAN (MSE against 1/0 targets) and vanilla (sigmoid BCE) modes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def edge_map(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, C] -> [B, H, W, 1]`` mean absolute gradient / 4, in
    float32; the four gradients added in the JAX function's order."""
    x = x.float()
    dx = (x[:, :, 1:, :] - x[:, :, :-1, :]).abs()
    dy = (x[:, 1:, :, :] - x[:, :-1, :, :]).abs()
    # F.pad's pairs run from the last dimension: (C), (W), (H)
    y = (F.pad(dx, (0, 0, 1, 0)) + F.pad(dx, (0, 0, 0, 1))
         + F.pad(dy, (0, 0, 0, 0, 1, 0)) + F.pad(dy, (0, 0, 0, 0, 0, 1)))
    return y.mean(-1, keepdim=True) / 4.0


def slice_image2patches(image: np.ndarray, patch_size: int = 64,
                        overlap: int = 0) -> np.ndarray:
    """HWC -> [N, p+ov, p+ov, C] non-strided grid with edge padding."""
    if image.shape[0] % patch_size or image.shape[1] % patch_size:
        raise ValueError(f"image {image.shape[:2]} is not a grid of "
                         f"{patch_size}-pixel patches")
    h, w = image.shape[:2]
    padded = np.pad(image, ((overlap, overlap), (overlap, overlap), (0, 0)),
                    mode="edge")
    patches = []
    for i in range(h // patch_size):
        for j in range(w // patch_size):
            patches.append(padded[i * patch_size:(i + 1) * patch_size + overlap,
                                  j * patch_size:(j + 1) * patch_size + overlap])
    return np.stack(patches)


def splice_patches2image(patches: np.ndarray, image_size: Tuple[int, int, int],
                         overlap: int = 0) -> np.ndarray:
    """Inverse of :func:`slice_image2patches` (overlap margins dropped)."""
    h, w = image_size[0], image_size[1]
    patch_size = patches.shape[-2] - overlap
    out = np.zeros(image_size, patches.dtype)
    idx = 0
    for i in range(h // patch_size):
        for j in range(w // patch_size):
            out[i * patch_size:(i + 1) * patch_size,
                j * patch_size:(j + 1) * patch_size] = \
                patches[idx, overlap:patch_size + overlap,
                        overlap:patch_size + overlap]
            idx += 1
    return out


def gan_loss(pred: torch.Tensor, target_is_real: bool,
             mode: str = "lsgan") -> torch.Tensor:
    """Discriminator / generator adversarial loss (loss_utils.py:6-45)."""
    target = torch.full_like(pred, 1.0 if target_is_real else 0.0)
    if mode == "lsgan":
        return ((pred - target) ** 2).mean()
    if mode == "vanilla":
        # sigmoid BCE with logits
        return (pred.clamp_min(0) - pred * target
                + torch.log1p(torch.exp(-pred.abs()))).mean()
    raise ValueError(f"unknown gan loss mode {mode!r}")
