"""Column UDF helpers (ref: src/udf/src/main/scala/udfs.scala:15-29): the
PyTorch port's copy of ``mmlspark_tpu/udfs.py``.

The reference ships two tiny Spark-SQL UDFs — ``to_vector`` (double array
-> dense Vector) and ``get_value_at`` (vector element extraction). Here
they are plain value functions suitable for ``UDFTransformer``'s ``udf``
param, plus eager table-level conveniences.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np


def to_vector(value: Any) -> np.ndarray:
    """array-like -> float64 vector (ref: udfs.scala to_vector)."""
    return np.asarray(value, dtype=np.float64)


def get_value_at(i: int) -> Callable[[Any], float]:
    """Vector element extractor for UDFTransformer
    (ref: udfs.scala get_value_at): ``get_value_at(2)`` maps a vector
    column to its third component."""
    def extract(vec: Any) -> float:
        return float(np.asarray(vec)[i])
    return extract


def table_to_vector(table, input_col: str, output_col: str):
    """Eager convenience: coerce an array-valued column to a vector
    column in one call."""
    vals = np.stack([to_vector(v) for v in table[input_col]])
    return table.with_column(output_col, vals)


def table_get_value_at(table, input_col: str, output_col: str, i: int):
    col = table[input_col]
    if isinstance(col, np.ndarray) and col.ndim == 2:
        vals = col[:, i].astype(np.float64)
    else:
        vals = np.asarray([get_value_at(i)(v) for v in col])
    return table.with_column(output_col, vals)
