"""Mini-batching stages: the port's copy of ``mmlspark_tpu/io/minibatch.py``.

Analog of the reference's minibatch layer
(ref: src/io/http/src/main/scala/MiniBatchTransformer.scala:30-169):
FixedMiniBatchTransformer groups every N rows into one row whose columns
hold lists; DynamicMiniBatchTransformer takes whatever is buffered (for
table-at-a-time execution: one batch per shard); FlattenBatch inverts.
``HasMiniBatcher`` lets stages embed a batching policy (ref: Batchers.scala).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from mmlspark_tpu_torch.core.params import IntParam, StageParam, range_domain
from mmlspark_tpu_torch.core.schema import Field, Schema, LIST
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.core.table import DataTable


def _batch_rows(table: DataTable, bounds: List[int]) -> DataTable:
    """Group row ranges into list-valued columns.

    Numpy columns batch as numpy SLICES (views — zero copy, zero
    per-element Python objects): this runs on the serving hot path, and
    the previous ``[v for v in col]`` boxed every cell of every batch
    into a Python float before the model immediately re-stacked them."""
    cols: Dict[str, List[Any]] = {n: [] for n in table.column_names}
    pairs = list(zip(bounds[:-1], bounds[1:]))
    for n in table.column_names:
        col = table[n]
        if isinstance(col, np.ndarray):
            cols[n] = [col[a:b] for a, b in pairs]
        else:
            cols[n] = [list(col[a:b]) for a, b in pairs]
    schema = Schema([Field(n, LIST) for n in table.column_names])
    return DataTable(cols, schema)


class FixedMiniBatchTransformer(Transformer):
    """ref: MiniBatchTransformer.scala:121 FixedMiniBatchTransformer."""

    batchSize = IntParam("rows per batch", default=10,
                         domain=range_domain(lo=1))
    maxBufferSize = IntParam("parity param (streaming buffer)",
                             default=2147483647)

    def transform(self, table: DataTable) -> DataTable:
        bs = self.get("batchSize")
        bounds = list(range(0, len(table), bs)) + [len(table)]
        if len(bounds) >= 2 and bounds[-2] == bounds[-1]:
            bounds.pop()
        return _batch_rows(table, bounds)

    def transform_schema(self, schema: Schema) -> Schema:
        return Schema([Field(n, LIST) for n in schema.names])


class DynamicMiniBatchTransformer(Transformer):
    """One batch per logical shard — the table-at-a-time analog of
    'take everything buffered' (ref: MiniBatchTransformer.scala:57)."""

    maxBatchSize = IntParam("cap on rows per batch", default=2147483647)

    def transform(self, table: DataTable) -> DataTable:
        cap = self.get("maxBatchSize")
        n = len(table)
        shards = max(table.num_shards, 1)
        per = min(cap, max(1, -(-n // shards))) if n else 1
        bounds = list(range(0, n, per)) + [n]
        if len(bounds) >= 2 and bounds[-2] == bounds[-1]:
            bounds.pop()
        return _batch_rows(table, bounds)

    def transform_schema(self, schema: Schema) -> Schema:
        return Schema([Field(n, LIST) for n in schema.names])


class TimeIntervalMiniBatchTransformer(Transformer):
    """Batch rows arriving within a time window
    (ref: MiniBatchTransformer.scala:91). For table-at-a-time execution
    all rows are 'already arrived': groups by a timestamp column when
    given, else one batch."""

    millisToWait = IntParam("window length in ms", default=1000)
    maxBatchSize = IntParam("cap on rows per batch", default=2147483647)

    from mmlspark_tpu_torch.core.params import ColParam as _CP
    timestampCol = _CP("optional epoch-millis column to window by",
                       default=None)

    def transform(self, table: DataTable) -> DataTable:
        ts_col = self.get_or_none("timestampCol")
        n = len(table)
        if ts_col is None or ts_col not in table:
            bounds = [0, n] if n else [0]
            return _batch_rows(table, bounds)
        if n == 0:
            return _batch_rows(table, [0])
        ts = np.asarray(table[ts_col], dtype=np.int64)
        order = np.argsort(ts, kind="stable")
        sorted_t = table._take_indices(order)
        ts = ts[order]
        window = self.get("millisToWait")
        cap = self.get("maxBatchSize")
        bounds = [0]
        start = 0
        for i in range(1, n):
            if ts[i] - ts[start] > window or i - start >= cap:
                bounds.append(i)
                start = i
        bounds.append(n)
        return _batch_rows(sorted_t, bounds)

    def transform_schema(self, schema: Schema) -> Schema:
        return Schema([Field(n, LIST) for n in schema.names])


class FlattenBatch(Transformer):
    """Invert mini-batching: explode parallel list columns
    (ref: MiniBatchTransformer.scala:169)."""

    def transform(self, table: DataTable) -> DataTable:
        rows: List[Dict[str, Any]] = []
        names = table.column_names
        for r in table.rows():
            lens = [len(r[n]) for n in names
                    if isinstance(r[n], (list, tuple, np.ndarray))]
            n_items = max(lens) if lens else 1
            for i in range(n_items):
                row = {}
                for n in names:
                    v = r[n]
                    if isinstance(v, (list, tuple, np.ndarray)):
                        row[n] = v[i] if i < len(v) else None
                    else:
                        # scalar alongside list columns (e.g. a per-batch
                        # error struct): broadcast, don't erase
                        row[n] = v
                rows.append(row)
        return DataTable.from_rows(rows, None if rows else table.schema)


class HasMiniBatcher:
    """Mixin: stages that embed a batching policy
    (ref: HasMiniBatcher trait)."""

    miniBatcher = StageParam("batching stage", default=None)

    def set_mini_batcher(self, b: Transformer):
        self.set("miniBatcher", b)
        return self

    def get_mini_batcher(self) -> Optional[Transformer]:
        return self.get_or_none("miniBatcher")
