"""Tiled full-image restoration with overlap-average stitching (the port of
the JAX ``evaluation/tiling.py``; reference test.py:36-71).

Tiles at stride = patch size plus a final edge-aligned tile; the tiles go
through the eval forward in chunks; the stitch averages overlapping pixels.
As in the JAX package, the restored tiles are stitched (the reference
stitches its input tiles, test.py:67).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..models.airnet import ModelBundle, eval_forward


def tile_offsets(size: int, patch: int) -> List[int]:
    """Stride-``patch`` offsets plus a final edge-aligned one (test.py:48-49)."""
    if size < patch:
        raise ValueError(f"image side {size} smaller than patch {patch}")
    return list(range(0, size - patch, patch)) + [size - patch]


def bucket_size(n: int, bucket: int = 8) -> int:
    """Round a tile count up to a multiple of ``bucket``."""
    return ((n + bucket - 1) // bucket) * bucket


def extract_tiles(img: np.ndarray, patch: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """``img [H, W, C] -> (tiles [Npad, p, p, C], offsets [Npad, 2], n_real)``;
    the padding repeats tile 0 and gets zero stitch weight."""
    h, w = img.shape[:2]
    offs = [(hy, wx) for hy in tile_offsets(h, patch)
            for wx in tile_offsets(w, patch)]
    n = len(offs)
    npad = bucket_size(n)
    tiles = np.zeros((npad, patch, patch, img.shape[2]), img.dtype)
    offsets = np.zeros((npad, 2), np.int32)
    for i, (hy, wx) in enumerate(offs):
        tiles[i] = img[hy:hy + patch, wx:wx + patch]
        offsets[i] = (hy, wx)
    tiles[n:] = tiles[0]
    return tiles, offsets, n


def stitch_tiles(tiles: torch.Tensor, offsets: np.ndarray, n_real: int,
                 out_h: int, out_w: int) -> torch.Tensor:
    """Overlap-averaged stitch of ``tiles [N, p, p, C]`` at ``offsets
    [N, 2]``; tiles at index >= ``n_real`` contribute nothing.
    Returns ``[out_h, out_w, C]``."""
    _, p, _, c = tiles.shape
    acc = torch.zeros((out_h, out_w, c), dtype=tiles.dtype, device=tiles.device)
    weight = torch.zeros((out_h, out_w, 1), dtype=tiles.dtype,
                         device=tiles.device)
    for i in range(n_real):
        hy, wx = int(offsets[i, 0]), int(offsets[i, 1])
        acc[hy:hy + p, wx:wx + p] += tiles[i]
        weight[hy:hy + p, wx:wx + p] += 1.0
    return acc / weight.clamp_min(1e-8)


def restore_image(bundle: ModelBundle, img: np.ndarray, chunk: int = 32
                  ) -> torch.Tensor:
    """Restore a whole ``img [H, W, 3]`` (float, [0, 1]) with the bundle's
    eval forward: tile, run the real tiles in chunks of ``chunk``, stitch.
    Returns ``[H, W, 3]`` float32 on the bundle's device."""
    patch = bundle.cfg.patch_size
    tiles, offsets, n = extract_tiles(np.asarray(img, np.float32), patch)
    x = torch.from_numpy(tiles[:n]).to(bundle.device)
    out = torch.cat([eval_forward(bundle, x[i:i + chunk])
                     for i in range(0, n, chunk)])
    return stitch_tiles(out, offsets, n, img.shape[0], img.shape[1])
