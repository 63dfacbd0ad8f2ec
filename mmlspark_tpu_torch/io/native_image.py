"""Host image transforms and decode through the port's native libraries.

The port's counterpart of the image half of
``mmlspark_tpu/native/loader.py``: ``resize_u8`` (the antialiased
triangle-filter resize of ``csrc/image.cpp``, bit for bit the JAX
package's uint8 host resize), ``unroll_chw`` (HWC uint8 -> flat CHW
float64) and ``decode_image`` (JPEG / PNG bytes -> RGB uint8 through
``csrc/imgcodec.cpp``, libjpeg and libpng). Each library is compiled by
the host C++ compiler into ``build/mmlspark_tpu_torch/`` at first use
(``_build.load``).

``resize_u8`` and ``unroll_chw`` raise if their library does not build:
the uint8 host resize has no other version in the port. The codecs are
one decoder among several (``io/image.decode_image`` tries them first,
then ``cv2``, then ``PIL``), so ``codec_available()`` says whether they
built on this machine.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from mmlspark_tpu_torch import _build

_BIND_LOCK = threading.Lock()
_BOUND: set = set()
_CODEC_ERROR: Optional[str] = None

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _image_lib() -> ctypes.CDLL:
    lib = _build.load("image")
    with _BIND_LOCK:
        if "image" not in _BOUND:
            lib.mml_resize_bilinear_u8.argtypes = [
                _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P,
                ctypes.c_int, ctypes.c_int]
            lib.mml_resize_bilinear_u8.restype = ctypes.c_int
            lib.mml_unroll_chw.argtypes = [
                _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_double)]
            lib.mml_unroll_chw.restype = ctypes.c_int
            _BOUND.add("image")
    return lib


def _codec_lib() -> ctypes.CDLL:
    lib = _build.load("imgcodec")
    with _BIND_LOCK:
        if "imgcodec" not in _BOUND:
            lib.mml_free.argtypes = [ctypes.c_void_p]
            lib.mml_free.restype = None
            lib.mml_decode_image.argtypes = [
                _U8P, ctypes.c_int, ctypes.POINTER(_U8P),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
            lib.mml_decode_image.restype = ctypes.c_int
            _BOUND.add("imgcodec")
    return lib


def codec_available() -> bool:
    """Whether the native codecs build and load here (tried once per
    process; ``codec_error()`` keeps the reason they did not)."""
    global _CODEC_ERROR
    if _CODEC_ERROR is None:
        try:
            _codec_lib()
            _CODEC_ERROR = ""
        except (RuntimeError, OSError) as e:
            _CODEC_ERROR = str(e) or type(e).__name__
    return _CODEC_ERROR == ""


def codec_error() -> str:
    """Why the native codecs are not available ("" when they are)."""
    codec_available()
    return _CODEC_ERROR or ""


def _hwc_u8(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or 0 in img.shape:
        raise ValueError(f"expected a non-empty HWC image, got shape "
                         f"{img.shape}")
    return img


def resize_u8(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """HWC uint8 -> (height, width, C) uint8, antialiased bilinear
    (``jax.image.resize(method='bilinear')``'s filter, rounded)."""
    img = _hwc_u8(img)
    if height <= 0 or width <= 0:
        raise ValueError(f"resize to {height} x {width}")
    h, w, c = img.shape
    dst = np.empty((height, width, c), np.uint8)
    rc = _image_lib().mml_resize_bilinear_u8(
        img.ctypes.data_as(_U8P), h, w, c, dst.ctypes.data_as(_U8P),
        int(height), int(width))
    if rc != 0:
        raise RuntimeError(f"mml_resize_bilinear_u8 returned {rc}")
    return dst


def unroll_chw(img: np.ndarray) -> np.ndarray:
    """HWC uint8 -> flat CHW float64 (``transpose(2, 0, 1).ravel()``)."""
    img = _hwc_u8(img)
    h, w, c = img.shape
    dst = np.empty(h * w * c, np.float64)
    rc = _image_lib().mml_unroll_chw(
        img.ctypes.data_as(_U8P), h, w, c,
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise RuntimeError(f"mml_unroll_chw returned {rc}")
    return dst


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """JPEG / PNG bytes -> RGB uint8 HWC array, or None if the bytes are
    neither or do not decode. Raises if the codecs do not build."""
    lib = _codec_lib()
    out = _U8P()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    rc = lib.mml_decode_image(buf, len(data), ctypes.byref(out),
                              ctypes.byref(h), ctypes.byref(w),
                              ctypes.byref(c))
    if rc != 0:
        return None
    n = h.value * w.value * c.value
    try:
        arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.mml_free(out)
    return arr.reshape(h.value, w.value, c.value)
