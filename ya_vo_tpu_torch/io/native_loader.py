"""ctypes binding for the native C decoder (native/png_decoder.c).

Loads `native/libyavo_native.so` if built (`make -C native`); otherwise the
callers fall back to PIL. Build once per machine — the loader caches the
handle.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB = None
_TRIED = False


def _find_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(here, "native", "libyavo_native.so")
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.yavo_png_decode_gray.restype = ctypes.c_int
        lib.yavo_png_decode_gray.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


MAX_PIXELS = 4096 * 4096


def decode_png_gray(path: str) -> Optional[np.ndarray]:
    """Decode a PNG file to uint8 [H, W] grayscale via the native decoder.
    Returns None if the native library is unavailable or the file is an
    unsupported PNG flavor (caller falls back to PIL)."""
    lib = _find_lib()
    if lib is None:
        return None
    with open(path, "rb") as f:
        blob = f.read()
    data = np.frombuffer(blob, dtype=np.uint8)
    out = np.empty(MAX_PIXELS, dtype=np.uint8)
    w = ctypes.c_int32(0)
    h = ctypes.c_int32(0)
    rc = lib.yavo_png_decode_gray(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), data.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size,
        ctypes.byref(w), ctypes.byref(h),
    )
    if rc != 0:
        return None
    return out[: w.value * h.value].reshape(h.value, w.value).copy()


def available() -> bool:
    return _find_lib() is not None
