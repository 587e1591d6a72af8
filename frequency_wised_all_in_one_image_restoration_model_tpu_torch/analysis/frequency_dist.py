"""Degradation frequency-distribution analyses: the port's own copy of the
JAX package's ``analysis/frequency_dist.py`` (numpy), on the port's
``utils/visualization.py``.

Capability match for the plot_frequency_distribution family:

* per-degradation FFT ring-energy histograms over dataset images
  (plot_frequency_distribution.py:10-52);
* per-sample low/high-frequency-content (LFC/HFC) scatter
  (plot_frequency_distribution_2.py:39-55);
* latent-space frequency scatter through the degradation encoder
  (plot_frequency_distribution_3.py:29-45 — runs images through the encoder
  and histograms the spatial ``inter`` map).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from ..utils.visualization import get_frequency_distribution, rgb2gray


def dataset_band_histogram(images: Iterable[np.ndarray], size: float = 0.2,
                           norm: bool = True) -> np.ndarray:
    """Mean ring-energy histogram over images (uint8/float HWC)."""
    acc = None
    n = 0
    for img in images:
        hist = get_frequency_distribution(rgb2gray(np.asarray(img, np.float64)),
                                          size=size, norm=norm)
        acc = hist if acc is None else acc + hist
        n += 1
    if n == 0:
        raise ValueError("no images")
    return acc / n


def per_task_histograms(task_images: Dict[str, Iterable[np.ndarray]],
                        size: float = 0.2) -> Dict[str, np.ndarray]:
    return {t: dataset_band_histogram(imgs, size)
            for t, imgs in task_images.items()}


def lfc_hfc(img: np.ndarray, split: float = 0.5) -> Tuple[float, float]:
    """Low/high frequency content of one image: ring energies below/above
    the split radius (plot_frequency_distribution_2.py semantics)."""
    hist = get_frequency_distribution(rgb2gray(np.asarray(img, np.float64)),
                                      size=0.1, norm=True)
    k = int(len(hist) * split)
    return float(np.sum(hist[:k])), float(np.sum(hist[k:]))


def latent_band_histogram(encode_fn, images: Sequence[np.ndarray],
                          size: float = 0.2) -> np.ndarray:
    """Histogram of the encoder's spatial degradation map: mean over
    channels of |FFT| ring energies (plot_frequency_distribution_3.py)."""
    acc = None
    for img in images:
        inter = np.asarray(encode_fn(img[None]))[0]  # [H, W, C]
        gray = inter.mean(-1)
        hist = get_frequency_distribution(gray.astype(np.float64), size=size)
        acc = hist if acc is None else acc + hist
    return acc / len(images)
