"""Synthetic dataset generation: the port's copy of
``mmlspark_tpu/testing/datagen.py`` (ref: core/test/datagen
GenerateDataset.scala:15).

Random schema-typed tables under constraints, for fuzz-style tests.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from mmlspark_tpu_torch.core import schema as S
from mmlspark_tpu_torch.core.table import DataTable


def generate_table(n_rows: int = 20,
                   spec: Optional[Dict[str, str]] = None,
                   seed: int = 0,
                   missing_fraction: float = 0.0) -> DataTable:
    """Generate a random table. ``spec`` maps column name -> tag
    (f32/f64/i32/i64/bool/str/vector). Default: a mixed-type table."""
    rng = np.random.default_rng(seed)
    if spec is None:
        spec = {"numbers": S.F64, "ints": S.I64, "flags": S.BOOL,
                "words": S.STRING}
    cols = {}
    for name, tag in spec.items():
        if tag in (S.F32, S.F64):
            arr = rng.normal(size=n_rows).astype(
                np.float32 if tag == S.F32 else np.float64)
            if missing_fraction > 0:
                mask = rng.random(n_rows) < missing_fraction
                arr = arr.astype(np.float64)
                arr[mask] = np.nan
            cols[name] = arr
        elif tag in (S.I8, S.I16, S.I32, S.I64):
            cols[name] = rng.integers(-100, 100, size=n_rows).astype(
                S.numpy_dtype_for(tag))
        elif tag == S.BOOL:
            cols[name] = rng.random(n_rows) < 0.5
        elif tag == S.STRING:
            words = ["alpha", "beta", "gamma", "delta", "epsilon"]
            cols[name] = [words[i] for i in rng.integers(0, len(words), n_rows)]
        elif tag == S.VECTOR:
            cols[name] = rng.normal(size=(n_rows, 4))
        else:
            raise ValueError(f"unsupported tag for datagen: {tag}")
    return DataTable(cols)


def generate_classification_table(n_rows: int = 200, n_features: int = 10,
                                  n_classes: int = 2, seed: int = 0,
                                  features_col: str = "features",
                                  label_col: str = "label") -> DataTable:
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=2.0, size=(n_classes, n_features))
    labels = rng.integers(0, n_classes, size=n_rows)
    feats = centers[labels] + rng.normal(size=(n_rows, n_features))
    return DataTable({features_col: feats.astype(np.float64),
                      label_col: labels.astype(np.int64)})


def generate_regression_table(n_rows: int = 200, n_features: int = 10,
                              seed: int = 0,
                              features_col: str = "features",
                              label_col: str = "label",
                              noise: float = 0.1) -> DataTable:
    rng = np.random.default_rng(seed)
    w = rng.normal(size=n_features)
    feats = rng.normal(size=(n_rows, n_features))
    y = feats @ w + noise * rng.normal(size=n_rows)
    return DataTable({features_col: feats.astype(np.float64),
                      label_col: y.astype(np.float64)})


def make_basic_table() -> DataTable:
    """ref: TestBase.makeBasicDF."""
    return DataTable({
        "numbers": np.array([0, 1, 2, 3], dtype=np.int64),
        "words": ["guitars", "drums", "bass", "keys"],
        "more": ["apples", "oranges", "bananas", "grapes"],
    })
