"""ctypes binding of the repo's native image decoder (``native/fairm_io.cpp``),
the decode part of the JAX package's ``data/native.py``.

Loads ``native/libfairm_io.so`` at the root of the checkout (building it on
first use where ``native/build.sh`` finds a C++ toolchain) and decodes
PNG / JPEG files with it; without the library, PIL decodes. Both give the
same uint8 RGB array. It is host-side image decoding only: nothing of the
model runs through it. The fused crop-augment and noise entry points serve
the train loader and come with the training slice.
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
