"""Batch padding of the PyTorch port (the one piece of
``mmlspark_tpu/parallel/mesh.py`` it needs; meshes and sharding are not
ported yet)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pad_to_multiple(arr: np.ndarray, multiple: int,
                    axis: int = 0) -> Tuple[np.ndarray, int]:
    """Pad ``axis`` up to a multiple of ``multiple``. Returns (padded,
    original_length). Edge-pads, so padded rows are valid inputs (no
    NaN paths through normalization); an empty array pads with zeros."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, rem)
    mode = "edge" if n > 0 else "constant"
    return np.pad(arr, pad_width, mode=mode), n
