"""Host binning through the port's OpenMP library (``csrc/bins.cpp``).

The port's counterpart of the binning half of
``mmlspark_tpu/native/loader.py``: ``apply_bins`` (row-major int32) and
``apply_bins_t_u8`` (the fused bin + transpose + narrow into the
features-major uint8 layout the engine ships, over all features or a
feature range). The library is compiled by the host C++ compiler into
``build/mmlspark_tpu_torch/`` at first use (``_build.load("bins")``).

When a fit runs on the card, its host binning (dense float64 input,
streamed shards, the f32-unsafe fallback, validation rows) goes through
this library and nowhere else: if it does not build or bind, the fit
raises. ``BinMapper._numpy_bin_block`` is its plain version, which the
CPU fits use and which the library is held against bitwise. (The JAX
package treats its native library as an optional accelerator and falls
back to numpy without a word; the port does not copy that choice, so a
card fit never runs its host binning on a path nobody measured.)
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from mmlspark_tpu_torch import _build

_BOUND = False


def _lib() -> ctypes.CDLL:
    """The loaded library, its entry points typed once."""
    global _BOUND
    lib = _build.load("bins")
    if not _BOUND:
        dp = ctypes.POINTER(ctypes.c_double)
        lp = ctypes.POINTER(ctypes.c_long)
        lib.mml_bins_threads.restype = ctypes.c_int
        lib.mml_apply_bins.argtypes = [
            dp, ctypes.c_long, ctypes.c_int, dp, lp,
            ctypes.POINTER(ctypes.c_int32)]
        lib.mml_apply_bins.restype = ctypes.c_int
        lib.mml_apply_bins_t_u8_range.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, dp, lp,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.mml_apply_bins_t_u8_range.restype = ctypes.c_int
        _BOUND = True
    return lib


def threads() -> int:
    """OpenMP threads the library's parallel loops run on."""
    return int(_lib().mml_bins_threads())


def _flat_bounds(upper_bounds: List[np.ndarray]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Every feature's boundaries concatenated (float64) and the (F + 1)
    int64 offsets that delimit them."""
    lens = np.asarray([len(u) for u in upper_bounds], np.int64)
    offsets = np.zeros(len(upper_bounds) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    bounds = (np.concatenate([np.asarray(u, np.float64)
                              for u in upper_bounds])
              if offsets[-1] else np.zeros(1))
    return np.ascontiguousarray(bounds), offsets


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def apply_bins(X: np.ndarray, upper_bounds: List[np.ndarray]) -> np.ndarray:
    """Row-major (n, f) features -> row-major (n, f) int32 bins, the
    values widened to float64 first (``BinMapper.transform``)."""
    lib = _lib()
    X = np.ascontiguousarray(X, dtype=np.float64)
    n, f = X.shape
    bounds, offsets = _flat_bounds(upper_bounds)
    out = np.empty((n, f), np.int32)
    rc = lib.mml_apply_bins(_ptr(X, ctypes.c_double), n, f,
                            _ptr(bounds, ctypes.c_double),
                            _ptr(offsets, ctypes.c_long),
                            _ptr(out, ctypes.c_int32))
    if rc != 0:
        raise RuntimeError(f"mml_apply_bins returned {rc}")
    return out


def apply_bins_t_u8(X: np.ndarray, upper_bounds: List[np.ndarray],
                    feature_range: Optional[Tuple[int, int]] = None
                    ) -> np.ndarray:
    """Row-major (n, f) float32 / float64 features -> features-major
    (j1 - j0, n) uint8 bins of the features [j0, j1) (all by default).
    Every feature must have at most 256 bins."""
    if any(len(u) + 1 > 256 for u in upper_bounds):
        raise ValueError("apply_bins_t_u8 needs every feature to have at "
                         "most 256 bins; use apply_bins")
    lib = _lib()
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    X = np.ascontiguousarray(X)
    n, f = X.shape
    j0, j1 = (0, f) if feature_range is None else map(int, feature_range)
    if not 0 <= j0 < j1 <= f:
        raise ValueError(f"feature_range {feature_range} outside [0, {f})")
    bounds, offsets = _flat_bounds(upper_bounds)
    out = np.empty((j1 - j0, n), np.uint8)
    rc = lib.mml_apply_bins_t_u8_range(
        X.ctypes.data_as(ctypes.c_void_p), int(X.dtype == np.float32), n,
        f, j0, j1, _ptr(bounds, ctypes.c_double),
        _ptr(offsets, ctypes.c_long), _ptr(out, ctypes.c_uint8))
    if rc != 0:
        raise RuntimeError(f"mml_apply_bins_t_u8_range returned {rc}")
    return out
