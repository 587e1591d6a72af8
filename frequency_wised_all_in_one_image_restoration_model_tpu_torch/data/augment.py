"""Deterministic crop + dihedral augmentation (a copy of the JAX package's
``data/augment.py``: numpy only).

Behavioral match for reference ``utils/image_utils.py:133-182`` (8 dihedral
modes; ``random_augmentation`` always applies one of modes 1..7 — never the
identity) and ``utils/dataset_utils.py:50-59`` (paired random crop), with
per-sample determinism from an explicit ``np.random.Generator`` instead of
the reference's per-worker global ``random`` state (irreproducible by
design; SURVEY.md §7 "Hard parts").
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def crop_img(image: np.ndarray, base: int = 64) -> np.ndarray:
    """Center-crop H and W to multiples of ``base``
    (reference image_utils.py:59-64)."""
    h, w = image.shape[0], image.shape[1]
    ch, cw = h % base, w % base
    return image[ch // 2: h - ch + ch // 2, cw // 2: w - cw + cw // 2, :]


def paired_random_crop(img1: np.ndarray, img2: np.ndarray, size: int,
                       rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Same random window from both images (dataset_utils.py:50-59)."""
    h, w = img1.shape[0], img1.shape[1]
    iy = int(rng.integers(0, h - size + 1))
    ix = int(rng.integers(0, w - size + 1))
    return (img1[iy:iy + size, ix:ix + size],
            img2[iy:iy + size, ix:ix + size])


def dihedral(image: np.ndarray, mode: int) -> np.ndarray:
    """The 8 flip/rot90 modes (image_utils.py:133-163). HWC arrays."""
    if mode == 0:
        return image
    if mode == 1:
        return np.flipud(image)
    if mode == 2:
        return np.rot90(image)
    if mode == 3:
        return np.flipud(np.rot90(image))
    if mode == 4:
        return np.rot90(image, k=2)
    if mode == 5:
        return np.flipud(np.rot90(image, k=2))
    if mode == 6:
        return np.rot90(image, k=3)
    if mode == 7:
        return np.flipud(np.rot90(image, k=3))
    raise ValueError(f"invalid augmentation mode {mode}")


def random_augmentation(*arrays: np.ndarray, rng: np.random.Generator):
    """Apply ONE random non-identity dihedral mode to all inputs
    (image_utils.py:177-182 — note the reference never picks the identity)."""
    mode = int(rng.integers(1, 8))
    return [np.ascontiguousarray(dihedral(a, mode)) for a in arrays]


def to_float01(img_u8: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 [0,1] (torchvision ToTensor semantics, minus the
    CHW transpose — this framework is channels-last)."""
    return img_u8.astype(np.float32) / 255.0
