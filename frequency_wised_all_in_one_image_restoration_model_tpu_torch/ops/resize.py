"""MATLAB-faithful imresize (multi-kernel, antialiased): the port's own
copy of the JAX package's ``ops/resize.py`` (numpy only).

Capability match for reference ``utils/imresize.py:6-232`` (a numpy port of
MATLAB's imresize: cubic/lanczos2/lanczos3/box/linear kernels, kernel-width
scaling for antialiased downsampling, boundary reflection via index
mirroring, separable per-axis application). Dead code in the reference's
main path but part of its utils surface. Implemented from the MATLAB
algorithm definition — not translated from the reference file.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _cubic(x):
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return ((1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0) * ((1 < ax) & (ax <= 2)))


def _box(x):
    return ((-0.5 <= x) & (x < 0.5)).astype(np.float64)


def _linear(x):
    ax = np.abs(x)
    return (1 - ax) * (ax <= 1)


def _sinc(x):
    x = np.where(x == 0, 1e-32, x)
    return np.sin(np.pi * x) / (np.pi * x)


def _lanczos(x, taps):
    return _sinc(x) * _sinc(x / taps) * (np.abs(x) < taps)


_KERNELS = {
    "cubic": (_cubic, 4.0),
    "box": (_box, 1.0),
    "linear": (_linear, 2.0),
    "lanczos2": (lambda x: _lanczos(x, 2), 4.0),
    "lanczos3": (lambda x: _lanczos(x, 3), 6.0),
}


def _contributions(in_len: int, out_len: int, scale: float, kernel, kwidth,
                   antialiasing: bool):
    """Per-output-pixel source indices + weights (MATLAB `contributions`)."""
    if scale < 1 and antialiasing:
        kernel_fn = lambda x: scale * kernel(scale * x)
        kwidth = kwidth / scale
    else:
        kernel_fn = kernel
    # output coords (1-based MATLAB math)
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kwidth / 2)
    p = int(np.ceil(kwidth)) + 2
    indices = left[:, None] + np.arange(p)[None, :] - 1  # 0-based
    weights = kernel_fn(u[:, None] - indices - 1)
    weights = weights / np.sum(weights, axis=1, keepdims=True)
    # mirror out-of-range indices (MATLAB boundary reflection)
    aux = np.concatenate([np.arange(in_len), np.arange(in_len - 1, -1, -1)])
    indices = aux[np.mod(indices.astype(np.int64), len(aux))]
    # drop all-zero weight columns
    keep = np.nonzero(np.any(weights != 0, axis=0))[0]
    return indices[:, keep], weights[:, keep]


def imresize(img: np.ndarray, scale: Optional[float] = None,
             output_shape: Optional[Tuple[int, int]] = None,
             kernel: str = "cubic", antialiasing: bool = True) -> np.ndarray:
    """Resize HW or HWC image with MATLAB imresize semantics."""
    if kernel not in _KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")
    kfn, kwidth = _KERNELS[kernel]

    h, w = img.shape[:2]
    if output_shape is not None:
        out_h, out_w = output_shape
        scale_h, scale_w = out_h / h, out_w / w
    elif scale is not None:
        scale_h = scale_w = float(scale)
        out_h, out_w = int(np.ceil(h * scale_h)), int(np.ceil(w * scale_w))
    else:
        raise ValueError("need scale or output_shape")

    squeeze = img.ndim == 2
    arr = img[:, :, None].astype(np.float64) if squeeze else img.astype(np.float64)

    idx_h, w_h = _contributions(h, out_h, scale_h, kfn, kwidth, antialiasing)
    idx_w, w_w = _contributions(w, out_w, scale_w, kfn, kwidth, antialiasing)

    # rows: out[o, x, c] = sum_p w_h[o, p] * arr[idx_h[o, p], x, c]
    arr = (w_h[:, :, None, None] * arr[idx_h]).sum(1)
    # columns: out[y, o, c] = sum_p w_w[o, p] * arr[y, idx_w[o, p], c]
    arr = (w_w[None, :, :, None] * arr[:, idx_w]).sum(2)

    if img.dtype == np.uint8:
        arr = np.clip(np.rint(arr), 0, 255).astype(np.uint8)
    if squeeze:
        arr = arr[:, :, 0]
    return arr
