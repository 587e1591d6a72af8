"""ctypes bindings of the repo's native image runtime
(``native/fairm_io.cpp``), a copy of the JAX package's ``data/native.py``.

Loads ``native/libfairm_io.so`` at the root of the checkout (building it on
first use where ``native/build.sh`` finds a C++ toolchain): PNG / JPEG
decode for the datasets, and the fused crop + augment and the noise
synthesis of the file-backed train loader. Every entry point has a numpy /
PIL form for a machine without the library. It is host-side image
preparation only: nothing of the model runs through it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = os.path.abspath(os.path.join(_NATIVE_DIR, "libfairm_io.so"))
    if not os.path.exists(so):
        build = os.path.abspath(os.path.join(_NATIVE_DIR, "build.sh"))
        if os.path.exists(build):
            try:
                subprocess.run(["sh", build], check=True,
                               capture_output=True, timeout=120)
            except Exception:
                return None
    if not os.path.exists(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None

    lib.fio_decode_rgb.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.fio_decode_rgb.restype = ctypes.c_int
    lib.fio_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.fio_crop_augment_f32.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    lib.fio_gaussian_noise_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_float, ctypes.c_uint64]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def decode_rgb(path: str) -> np.ndarray:
    """Decode PNG/JPEG to uint8 HWC RGB; native fast path, PIL fallback."""
    lib = _load()
    if lib is not None:
        out = ctypes.POINTER(ctypes.c_uint8)()
        h = ctypes.c_int()
        w = ctypes.c_int()
        rc = lib.fio_decode_rgb(path.encode(), ctypes.byref(out),
                                ctypes.byref(h), ctypes.byref(w))
        if rc == 0:
            n = h.value * w.value * 3
            arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
            lib.fio_free(out)
            return arr.reshape(h.value, w.value, 3)
    from ..utils.image_io import load_image_rgb
    return load_image_rgb(path)


def crop_augment_f32(img_u8: np.ndarray, iy: int, ix: int, size: int,
                     mode: int) -> np.ndarray:
    """Fused crop + dihedral + to-float01; matches
    augment.dihedral(img[iy:iy+size, ix:ix+size], mode) / 255."""
    lib = _load()
    if lib is None:
        from . import augment
        crop = img_u8[iy:iy + size, ix:ix + size]
        return np.ascontiguousarray(augment.dihedral(crop, mode)).astype(
            np.float32) / 255.0
    img_u8 = np.ascontiguousarray(img_u8)
    out = np.empty((size, size, 3), np.float32)
    lib.fio_crop_augment_f32(
        img_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        img_u8.shape[0], img_u8.shape[1], iy, ix, size, mode,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def gaussian_noise_u8(img_u8: np.ndarray, sigma: float,
                      seed: int) -> np.ndarray:
    """clip(img + N(0, sigma), 0, 255) as uint8 (reference
    dataset_utils.py:126 distribution; PRNG differs — documented)."""
    lib = _load()
    img_u8 = np.ascontiguousarray(img_u8)
    if lib is None:
        rng = np.random.default_rng(seed)
        return np.clip(img_u8.astype(np.float32)
                       + rng.standard_normal(img_u8.shape).astype(np.float32)
                       * sigma, 0, 255).astype(np.uint8)
    out = np.empty_like(img_u8)
    lib.fio_gaussian_noise_u8(
        img_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        img_u8.size, float(sigma), np.uint64(seed))
    return out
