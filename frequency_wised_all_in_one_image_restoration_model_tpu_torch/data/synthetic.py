"""Deterministic synthetic test sets (a copy of the eval part of the JAX
package's ``data/synthetic.py``: numpy only; the train loader comes with the
training slice).

The reference needs ``data/<task>_test/`` on disk for every run
(dataset_utils.py:160-167). This module synthesizes clean images (smooth
random fields) and applies the same degradation taxonomy, so the eval stack
runs without files. Activated by ``--synthetic_data``.

Copied as it is, :class:`SyntheticTestSet` seeds each task's images with
``hash(task) % 1000``, and ``str`` hashes are salted per process: the images
of a task repeat only within one process, or under a fixed
``PYTHONHASHSEED``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from . import augment


def smooth_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Random smooth uint8 RGB image: low-res noise bilinearly upsampled,
    plus mild texture. Deterministic given the generator state."""
    gh, gw = max(2, h // 16), max(2, w // 16)
    coarse = rng.uniform(0, 255, (gh, gw, 3)).astype(np.float32)
    ys = np.linspace(0, gh - 1, h)
    xs = np.linspace(0, gw - 1, w)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, gh - 1)
    x1 = np.minimum(x0 + 1, gw - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img = ((coarse[y0][:, x0] * (1 - wy) * (1 - wx))
           + (coarse[y0][:, x1] * (1 - wy) * wx)
           + (coarse[y1][:, x0] * wy * (1 - wx))
           + (coarse[y1][:, x1] * wy * wx))
    img = img + rng.normal(0, 4.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def degrade(clean_u8: np.ndarray, task: str, rng: np.random.Generator) -> np.ndarray:
    """Apply the task's degradation to a clean uint8 image.

    'denoising_σ' matches the reference's on-the-fly synthesis exactly
    (dataset_utils.py:122-126: ``clip(gt + randn*σ)``; σ=0 -> random
    {15,25,50}); rain/haze/blur are synthetic stand-ins for the on-disk
    pairs the reference reads.
    """
    img = clean_u8.astype(np.float32)
    h, w = img.shape[:2]
    if task.startswith("denoising"):
        sigma = int(task.split("_")[-1])
        if sigma == 0:
            sigma = int(rng.choice([15, 25, 50]))
        img = img + rng.normal(0, 1, img.shape) * sigma
    elif task == "deraining":
        streaks = np.zeros((h, w), np.float32)
        n = max(4, h * w // 256)
        ys = rng.integers(0, h, n)
        xs = rng.integers(0, w, n)
        length = max(4, h // 8)
        for dy in range(length):
            yy = np.clip(ys + dy, 0, h - 1)
            xx = np.clip(xs + dy // 2, 0, w - 1)
            streaks[yy, xx] = 180.0
        img = np.maximum(img, streaks[:, :, None])
    elif task == "dehazing":
        t = rng.uniform(0.4, 0.7)
        img = img * t + 235.0 * (1 - t)
    elif task == "deblurring":
        k = 5
        pad = np.pad(img, ((k // 2, k // 2), (k // 2, k // 2), (0, 0)), mode="edge")
        out = np.zeros_like(img)
        for dy in range(k):
            for dx in range(k):
                out += pad[dy:dy + h, dx:dx + w]
        img = out / (k * k)
    else:
        raise ValueError(f"unknown task {task!r}")
    return np.clip(img, 0, 255).astype(np.uint8)


class SyntheticTestSet:
    """Per-task eval images (full-size, batch 1 — reference test.py:30-31)."""

    def __init__(self, cfg, task: str, n_images: int = 4,
                 image_size: int = 160, seed: int = 0):
        self.task = task
        base = augment.crop_img(
            np.zeros((image_size, image_size, 3), np.uint8), base=16).shape
        self.items: List[Tuple[str, np.ndarray, np.ndarray]] = []
        rng = np.random.default_rng(seed + hash(task) % 1000)
        for i in range(n_images):
            clean = smooth_image(rng, image_size, image_size)
            clean = augment.crop_img(clean, base=16)
            degraded = degrade(clean, task, rng)
            self.items.append((f"{task}_{i}", augment.to_float01(degraded),
                               augment.to_float01(clean)))
        del base

    def __iter__(self):
        return iter(self.items)

    def __len__(self):
        return len(self.items)
