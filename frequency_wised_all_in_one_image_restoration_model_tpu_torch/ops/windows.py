"""Window partition/reverse and the static attention masks and bias index
(the port of the JAX ``ops/windows.py``).

Masks and the relative-position index depend only on static shapes, so they
are cached numpy constants; the modules hold them as non-persistent buffers.
Layout: images ``[B, H, W, C]``, windows ``[B * nW, win, win, C]``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def window_partition(x: torch.Tensor, win: int) -> torch.Tensor:
    """``[B, H, W, C] -> [B * H/win * W/win, win, win, C]`` (reference
    encoder_Uformer.py:398-409)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // win, win, w // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win, win, c)


def window_reverse(windows: torch.Tensor, win: int, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`window_partition` (encoder_Uformer.py:411-420)."""
    c = windows.shape[-1]
    b = windows.shape[0] // (h * w // win // win)
    x = windows.reshape(b, h // win, w // win, win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


@functools.lru_cache(maxsize=32)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """``[wh*ww, wh*ww]`` int index into a ``(2wh-1)(2ww-1)`` bias table
    (encoder_Uformer.py:124-135)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1).astype(np.int64)


@functools.lru_cache(maxsize=64)
def shift_attn_mask(h: int, w: int, win: int, shift: int) -> np.ndarray:
    """Additive SW-MSA mask ``[nW, win*win, win*win]`` float32, 0 or -100
    (encoder_Uformer.py:613-631). -100, never -inf: it leaves e^-100 of
    probability mass in place, as the reference does."""
    img = np.zeros((h, w), dtype=np.float32)
    cnt = 0
    slices = (slice(0, -win), slice(-win, -shift), slice(-shift, None))
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(h // win, win, w // win, win).transpose(0, 2, 1, 3)
    wins = wins.reshape(-1, win * win)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, np.float32(-100.0), np.float32(0.0))


@functools.lru_cache(maxsize=8)
def band_mask(L: int, n_tokens: int, kind: str) -> np.ndarray:
    """Intra/inter frequency-band additive mask ``[L*n, L*n]`` float32:
    'intra' is 0 on the same-band diagonal blocks and -100 elsewhere,
    'inter' the complement (encoder_Uformer.py:246-254)."""
    if kind == "intra":
        blocks = np.where(np.eye(L, dtype=bool), 0.0, -100.0)
    elif kind == "inter":
        blocks = np.where(np.eye(L, dtype=bool), -100.0, 0.0)
    else:
        raise ValueError(f"band mask kind must be intra/inter, got {kind!r}")
    return np.kron(blocks, np.ones((n_tokens, n_tokens))).astype(np.float32)


def gather_relative_bias(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table [(2w-1)^2, h]`` gathered by ``index [n, n]`` -> ``[h, n, n]``
    (encoder_Uformer.py:158-160)."""
    n = index.shape[0]
    return table[index.reshape(-1)].reshape(n, n, -1).permute(2, 0, 1)
