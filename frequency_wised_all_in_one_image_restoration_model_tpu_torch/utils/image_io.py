"""Image I/O: float01 HWC <-> PNG, plus converters (a copy of the JAX
package's ``utils/image_io.py``: numpy and PIL only).

Covers the reference's live path ``save_image_tensor`` (utils/image_io.py:
157-161, used by test.py:78) and the pil/np converters around it
(utils/image_utils.py:255-303). Channels-last throughout.
"""

from __future__ import annotations

import os

import numpy as np


def float01_to_u8(img: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8, clipped (image_utils.py:287-303 semantics)."""
    return np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)


def save_image_float01(img_hwc: np.ndarray, path: str) -> None:
    """Save a float01 HWC image as PNG (reference save_image_tensor)."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = float01_to_u8(img_hwc)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    Image.fromarray(arr).save(path)


def load_image_rgb(path: str) -> np.ndarray:
    """PNG/JPEG -> uint8 HWC RGB (reference Image.open(...).convert('RGB'),
    dataset_utils.py:118)."""
    from PIL import Image

    return np.array(Image.open(path).convert("RGB"))
