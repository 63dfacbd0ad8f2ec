"""Tolerant table equality: the port's copy of
``mmlspark_tpu/testing/equality.py`` (ref: TestBase.scala DataFrameEquality
:208-266)."""

from __future__ import annotations

from typing import Any

import numpy as np

from mmlspark_tpu_torch.core.table import DataTable


def values_equal(a: Any, b: Any, tol: float = 1e-6) -> bool:
    if a is None or b is None:
        return a is b
    if isinstance(a, (float, np.floating)) or isinstance(b, (float, np.floating)):
        try:
            a, b = float(a), float(b)
        except (TypeError, ValueError):
            return False
        if np.isnan(a) and np.isnan(b):
            return True
        return abs(a - b) <= tol * max(1.0, abs(a), abs(b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape:
            return False
        if a.dtype.kind in "fc" or b.dtype.kind in "fc":
            return bool(np.allclose(a, b, rtol=tol, atol=tol, equal_nan=True))
        return bool(np.array_equal(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return False
        return all(values_equal(a[k], b[k], tol) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return False
        return all(values_equal(x, y, tol) for x, y in zip(a, b))
    return a == b


def assert_table_equal(left: DataTable, right: DataTable,
                       tol: float = 1e-6, check_schema: bool = True,
                       ignore_order: bool = False) -> None:
    assert len(left) == len(right), \
        f"row counts differ: {len(left)} vs {len(right)}"
    assert left.column_names == right.column_names, \
        f"columns differ: {left.column_names} vs {right.column_names}"
    if check_schema:
        ltags = [f.tag for f in left.schema]
        rtags = [f.tag for f in right.schema]
        assert ltags == rtags, f"schema tags differ: {ltags} vs {rtags}"
    lrows = left.to_rows()
    rrows = right.to_rows()
    if ignore_order:
        key = lambda r: str(sorted((k, str(v)) for k, v in r.items()))
        lrows = sorted(lrows, key=key)
        rrows = sorted(rrows, key=key)
    for i, (lr, rr) in enumerate(zip(lrows, rrows)):
        for col in left.column_names:
            assert values_equal(lr[col], rr[col], tol), (
                f"row {i}, column {col!r}: {lr[col]!r} != {rr[col]!r}")


def tables_equal(left: DataTable, right: DataTable, tol: float = 1e-6,
                 ignore_order: bool = False) -> bool:
    try:
        assert_table_equal(left, right, tol, check_schema=False,
                           ignore_order=ignore_order)
        return True
    except AssertionError:
        return False
