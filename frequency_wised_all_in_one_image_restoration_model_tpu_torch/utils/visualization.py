"""Visualization utilities (capability match for utils/visualization_utils.py):
the port's own copy of the JAX package's ``utils/visualization.py`` (numpy
and, inside the plotting functions, matplotlib).

Covers: image grids (:16-59), train.log loss-curve parsing + plotting
(:62-111 — the regex log-format contract is honored by utils/logging.py),
generic curve/scatter plots (:114-145, 187-217), rgb2gray (:148-155), and the
FFT ring-energy histogram ``get_frequency_distribution`` (:158-184) — the
reference computes the histogram with O(H·W·bands) Python loops; here it is
one vectorized masked sum using the same static ring masks as the model ops.

Note the reference's ring geometry here differs from the model op: the
histogram normalizes radius by ``center[0]`` (half-width), not the corner
distance (:169) — replicated.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

_COLORS = ["r", "b", "g", "k", "y", "c", "m"]


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def make_image_grid(images: Sequence[np.ndarray], nrow: int = 8,
                    padding: int = 2) -> np.ndarray:
    """Concatenate HWC float images into one grid image (torchvision
    make_grid equivalent, channels-last)."""
    imgs = [i if i.ndim == 3 else i[:, :, None] for i in images]
    cmax = max(i.shape[2] for i in imgs)
    imgs = [np.repeat(i, cmax // i.shape[2], axis=2) for i in imgs]
    h, w, c = imgs[0].shape
    ncol = min(nrow, len(imgs))
    nrows = (len(imgs) + ncol - 1) // ncol
    grid = np.zeros((nrows * (h + padding) + padding,
                     ncol * (w + padding) + padding, c), imgs[0].dtype)
    for idx, img in enumerate(imgs):
        r, col = divmod(idx, ncol)
        y0 = padding + r * (h + padding)
        x0 = padding + col * (w + padding)
        grid[y0:y0 + h, x0:x0 + w] = img
    return grid


def plot_image_grid(images, nrow: int = 8, padding: int = 2,
                    title: Optional[str] = None,
                    save_path: Optional[str] = None) -> np.ndarray:
    grid = make_image_grid(images, nrow, padding)
    plt = _plt()
    plt.figure(figsize=(len(images) + 1, 3))
    plt.imshow(grid if grid.shape[2] == 3 else grid[:, :, 0],
               cmap=None if grid.shape[2] == 3 else "gray")
    if title:
        plt.title(title)
    if save_path:
        plt.savefig(save_path, dpi=100)
    plt.close()
    return grid


def parse_train_log(path: str) -> Tuple[List[float], List[float], int]:
    """Parse train.log into (contrast_loss, l1_loss, first_joint_epoch) with
    the reference's exact split semantics (visualization_utils.py:72-82)."""
    with open(os.path.join(path, "train.log")) as f:
        lines = f.readlines()
    contrast, l1 = [], []
    first = -1
    for idx, line in enumerate(lines):
        strings = re.split(r"[:\s]", line.strip())
        if len(strings) < 9:
            l1.append(0.0)
            contrast.append(float(strings[6]))
        else:
            if first == -1:
                first = idx
            l1.append(float(strings[6]))
            contrast.append(float(strings[8]))
    return contrast, l1, first


def plot_loss_curve(path: str, num_epochs: Optional[int] = None,
                    ylim=((0, 4), (0, 0.05)),
                    save_path: Optional[str] = None) -> str:
    contrast, l1, first = parse_train_log(path)
    if num_epochs is None:
        num_epochs = len(contrast)
    plt = _plt()
    fig, ax1 = plt.subplots(figsize=(20, 6))
    ax1.set_xlim(0, num_epochs)
    ax1.set_xlabel("Epochs")
    ax1.set_ylim(*ylim[0])
    ax1.set_ylabel("Contrast Loss")
    ax1.plot(range(num_epochs), contrast[:num_epochs], color=_COLORS[0],
             label="Contrast Loss", linewidth=4)
    ax2 = ax1.twinx()
    ax2.set_ylim(*ylim[1])
    ax2.set_ylabel("L1 Loss")
    start = max(first, 0)
    ax2.plot(range(start, num_epochs), l1[start:num_epochs], color=_COLORS[1],
             label="L1 Loss", linewidth=4)
    fig.legend(loc="upper right", bbox_to_anchor=(1, 1),
               bbox_transform=ax1.transAxes)
    plt.grid()
    if save_path is None:
        save_path = os.path.join(path, "loss_curve.png")
    plt.savefig(save_path)
    plt.close()
    return save_path


def plot_curve(f: Sequence[Sequence[float]], x_range=None, labels=None,
               xlabel=None, ylabel=None, ylim=(0, 40), figsize=(7, 6),
               scale="linear", save_path=None):
    plt = _plt()
    fig, ax = plt.subplots(figsize=figsize)
    plt.yscale(scale)
    if x_range is None:
        x_range = (0, len(f[0]))
    ax.set_xlim(0, x_range[1])
    if ylim is not None:
        ax.set_ylim(*ylim)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    for idx, series in enumerate(f):
        kw = {"label": labels[idx]} if labels else {}
        ax.plot(range(*x_range), series, color=_COLORS[idx % len(_COLORS)],
                linewidth=4, **kw)
    if labels:
        plt.legend(loc="lower right")
    plt.grid()
    if save_path:
        plt.savefig(save_path)
    plt.close()


def plot_scatter(x, y, labels=None, xlabel=None, ylabel=None, title=None,
                 set_lim=True, xlim=(0, 40), ylim=(0, 40), figsize=(7, 7),
                 save_path=None):
    plt = _plt()
    fig, ax = plt.subplots(figsize=figsize)
    if set_lim:
        ax.set_xlim(*xlim)
        ax.set_ylim(*ylim)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    for idx in range(len(x)):
        kw = {"label": labels[idx]} if labels else {}
        ax.scatter(x[idx], y[idx], s=15, color=_COLORS[idx % len(_COLORS)], **kw)
    if title:
        plt.title(title)
    if labels:
        plt.legend(loc="upper right")
    plt.grid()
    if save_path:
        plt.savefig(save_path)
    plt.close()


def rgb2gray(rgb: np.ndarray) -> np.ndarray:
    """ITU-R 601 luma (visualization_utils.py:148-155)."""
    if rgb.shape[2] == 1:
        return rgb[:, :, 0]
    gray = (0.2989 * rgb[:, :, 0] + 0.5870 * rgb[:, :, 1]
            + 0.1140 * rgb[:, :, 2])
    return np.clip(gray, 0, 255)


def get_frequency_distribution(img: np.ndarray, size: float = 0.2,
                               norm: bool = True) -> np.ndarray:
    """FFT ring-energy histogram of a grayscale image.

    Same ring semantics as the reference (radius normalized by half-WIDTH,
    band edges ``<=..<`` except the last which is ``<=..<=``,
    visualization_utils.py:169-179), vectorized instead of the reference's
    per-pixel Python loops.
    """
    ft = np.abs(np.fft.fftshift(np.fft.fft2(img)))
    h, w = ft.shape
    cy, cx = int(h / 2), int(w / 2)
    ys = np.arange(h)[:, None]
    xs = np.arange(w)[None, :]
    dist = np.sqrt((xs - cx) ** 2 + (ys - cy) ** 2)
    diag = cx  # the reference normalizes by half-width, not the corner
    nb = int(1 / size)
    tot = np.zeros(nb)
    for idx, sz in enumerate(np.linspace(size, 1, nb)):
        lo = diag * (sz - size)
        hi = diag * sz
        if sz == 1:
            mask = (dist >= lo) & (dist <= hi)
        else:
            mask = (dist >= lo) & (dist < hi)
        tot[idx] = ft[mask].sum()
    if norm:
        tot = tot / tot.sum()
    return tot
