"""FFT frequency-band decomposition (the port of the JAX ``ops/frequency.py``).

The ring masks, the DC-point + closed-ring decomposition
``frequency_decompose_1`` that splits the encoder's input into L bands (and
the decoder's ``all_<N>_bands`` attention maps), the equal-width ring
decomposition ``frequency_decompose`` whose masked spectra the frequency-L1
loss compares (and which splits attention maps for the learnable ``lamb``),
and the mean / residual split ``frequency_decompose_dc``. Any leading
shape goes through: attention maps ``[B', h, n, nk]`` decompose over their
last two axes. The FFT runs in float32 /
complex64 whatever the model's compute dtype (a bf16 FFT is lossy).
"""

from __future__ import annotations

import functools
from typing import Union

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def ring_masks(h: int, w: int, num_bands: int, variant: str = "open") -> np.ndarray:
    """Concentric-ring masks over an fftshifted spectrum, float32
    ``[num_bands (+1 for 'dc'), h, w]``; a copy of the JAX package's numpy
    construction (reference frequency_decompose.py:17-26, 38-48, 80-87)."""
    # float32 throughout: the reference computes dist/radius in torch fp32,
    # and pixels sitting exactly on a band edge flip bands under fp64
    ys = np.arange(h, dtype=np.int64)[:, None]
    xs = np.arange(w, dtype=np.int64)[None, :]
    cx, cy = int(w / 2), int(h / 2)
    dist = np.sqrt(((xs - cx) ** 2 + (ys - cy) ** 2).astype(np.float32))
    max_radius = np.sqrt(np.float32(cx * cx + cy * cy))

    masks = []
    last = np.zeros((h, w), dtype=bool)
    if variant == "open":
        edges = np.linspace(1.0 / num_bands, 1.0, num_bands).astype(np.float32)
        for i, sz in enumerate(edges):
            radius = np.float32(max_radius * sz)
            cur = dist <= radius if i == num_bands - 1 else dist < radius
            masks.append(cur ^ last)
            last = cur
    elif variant == "dc":
        edges = np.linspace(0.0, 1.0, num_bands + 1).astype(np.float32)
        for sz in edges:
            cur = dist <= np.float32(max_radius * sz)
            masks.append(cur ^ last)
            last = cur
    else:
        raise ValueError(f"unknown ring-mask variant: {variant!r}")
    return np.stack(masks).astype(np.float32)


def frequency_decompose_1(x: torch.Tensor, num_rings: int) -> torch.Tensor:
    """DC point + closed rings ``0, (0,s], ..., (1-s,1]``: ``x [..., H, W]``
    real -> ``[num_rings + 1, ..., H, W]`` float32 spatial reconstructions.

    Order as the reference (frequency_decompose.py:70-107): fftshift(fft2),
    mask, ifftshift, ifft2, real part.
    """
    h, w = x.shape[-2], x.shape[-1]
    masks = torch.from_numpy(ring_masks(h, w, num_rings, "dc")).to(x.device)
    fx = torch.fft.fftshift(torch.fft.fft2(x.float()), dim=(-2, -1))
    bshape = (num_rings + 1,) + (1,) * (x.dim() - 2) + (h, w)
    banded = masks.reshape(bshape) * fx.unsqueeze(0)
    banded = torch.fft.ifftshift(banded, dim=(-2, -1))
    return torch.fft.ifft2(banded).real


def frequency_decompose(x: torch.Tensor, num_bands: int,
                        inverse: Union[bool, str] = True) -> torch.Tensor:
    """Equal-width rings ``[0,s) ... [1-s,1]``: ``x [..., H, W]`` real ->
    ``[num_bands, ..., H, W]`` float32 spatial reconstructions
    (``inverse=True``), the masked spectra with the fftshift removed,
    stacked as (real, imag) in a trailing axis (``inverse=False``; what the
    frequency-L1 loss consumes, reference frequency_decompose.py:28-68), or
    the shifted magnitude spectra (``inverse='visual'``, reference :55-56;
    what the attention-map band energy of ``analysis/msa_frequency.py``
    sums)."""
    h, w = x.shape[-2], x.shape[-1]
    masks = torch.from_numpy(ring_masks(h, w, num_bands, "open")).to(x.device)
    fx = torch.fft.fftshift(torch.fft.fft2(x.float()), dim=(-2, -1))
    bshape = (num_bands,) + (1,) * (x.dim() - 2) + (h, w)
    banded = masks.reshape(bshape) * fx.unsqueeze(0)
    if inverse == "visual":
        return banded.abs()
    banded = torch.fft.ifftshift(banded, dim=(-2, -1))
    if inverse is True:
        return torch.fft.ifft2(banded).real
    if inverse is False:
        return torch.stack((banded.real, banded.imag), dim=-1)
    raise ValueError(f"invalid inverse mode: {inverse!r}")


def frequency_decompose_dc(x: torch.Tensor) -> torch.Tensor:
    """Mean / residual split over the trailing two axes, no FFT (reference
    frequency_decompose.py:109-118): ``[2, ..., H, W]``, band 0 the
    broadcast spatial mean, band 1 the residual. The decoder's ``all_DC``
    and ``frequency_decompose_type DC`` split attention maps with it."""
    dc = x.mean(dim=(-2, -1), keepdim=True).expand_as(x)
    return torch.stack((dc, x - dc), dim=0)
