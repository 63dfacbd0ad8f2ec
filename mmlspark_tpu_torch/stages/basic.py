"""The pipeline-stages utility set: the PyTorch port's copy of
``mmlspark_tpu/stages/basic.py``.

Stage-for-stage parity with the reference's pipeline-stages component
(ref: SURVEY.md §2; src/pipeline-stages/src/main/scala/*): Cacher,
ClassBalancer, DropColumns, Explode, Lambda, RenameColumn, Repartition,
SelectColumns, TextPreprocessor, Timer, UDFTransformer — each a small,
composable host table op. ``Timer``'s ``traceDir`` writes a
``torch.profiler`` trace of the wrapped stage
(``utils/profiling.maybe_trace``) where the JAX package writes a
``jax.profiler`` one. DropColumns, SelectColumns and RenameColumn
declare their column flow for the liveness pass of ``core/fusion.py``;
the other stages declare none, which disables pruning across them.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.core.params import (
    BoolParam, DictParam, HasInputCol, HasOutputCol, IntParam,
    ListParam, StageParam, StringParam, UDFParam,
)
from mmlspark_tpu_torch.core.schema import Field, Schema, F64, STRING
from mmlspark_tpu_torch.core.stage import Estimator, Model, Transformer
from mmlspark_tpu_torch.core.table import DataTable

log = get_logger("stages")


class Cacher(Transformer):
    """Materialize/cache the table (ref: Cacher.scala). DataTables are
    eagerly host-resident so this is the identity; kept for pipeline
    parity and as a marker stage."""

    disable = BoolParam("disable caching", default=False)

    def transform(self, table: DataTable) -> DataTable:
        if self.get("disable"):
            return table
        return table.cache()


class DropColumns(Transformer):
    """ref: DropColumns.scala"""

    cols = ListParam("columns to drop", default=None)

    def set_cols(self, v): self.set("cols", list(v)); return self

    def transform(self, table: DataTable) -> DataTable:
        return table.drop(*(self.get("cols") or []))

    def transform_schema(self, schema: Schema) -> Schema:
        return schema.drop(*(self.get("cols") or []))

    def reads_columns(self, schema):
        return []

    def writes_columns(self, schema):
        return []

    def removes_columns(self, schema):
        return list(self.get("cols") or [])

class SelectColumns(Transformer):
    """ref: SelectColumns.scala"""

    cols = ListParam("columns to keep", default=None)

    def set_cols(self, v): self.set("cols", list(v)); return self

    def transform(self, table: DataTable) -> DataTable:
        return table.select(*(self.get("cols") or []))

    def transform_schema(self, schema: Schema) -> Schema:
        return schema.select(*(self.get("cols") or []))

    def reads_columns(self, schema):
        return list(self.get("cols") or [])

    def writes_columns(self, schema):
        return []

    def removes_columns(self, schema):
        keep = set(self.get("cols") or [])
        return [n for n in schema.names if n not in keep]

class RenameColumn(Transformer, HasInputCol, HasOutputCol):
    """ref: RenameColumn.scala"""

    def transform(self, table: DataTable) -> DataTable:
        return table.rename({self.get_input_col(): self.get_output_col()})

    def transform_schema(self, schema: Schema) -> Schema:
        return schema.rename({self.get_input_col(): self.get_output_col()})

    def reads_columns(self, schema):
        return [self.get_input_col()]

    def writes_columns(self, schema):
        return [self.get_output_col()]

    def removes_columns(self, schema):
        return [self.get_input_col()]

class Repartition(Transformer):
    """Set the logical shard count used for distributed feeding
    (ref: Repartition.scala — df.repartition/coalesce)."""

    n = IntParam("number of shards", default=1)

    def transform(self, table: DataTable) -> DataTable:
        return table.repartition(self.get("n"))


class Explode(Transformer, HasInputCol, HasOutputCol):
    """Explode a list column into one row per element
    (ref: Explode.scala)."""

    def transform(self, table: DataTable) -> DataTable:
        in_col = self.get_input_col()
        out_col = self.get_output_col()
        rows = []
        for r in table.rows():
            vals = r[in_col]
            if vals is None:
                continue
            for v in vals:
                nr = dict(r)
                nr[out_col] = v
                rows.append(nr)
        if out_col != in_col:
            names = table.column_names + [out_col]
        else:
            names = table.column_names
        out_rows = [{n: r.get(n) for n in names} for r in rows]
        if not out_rows:
            # keep the schema even when nothing survives explosion
            from mmlspark_tpu_torch.core.schema import OBJECT
            schema = table.schema
            if out_col != in_col:
                schema = schema.add(Field(out_col, OBJECT))
            return DataTable.from_rows([], schema)
        return DataTable.from_rows(out_rows)


class Lambda(Transformer):
    """Arbitrary table->table function as a stage
    (ref: Lambda.scala:21)."""

    transformFunc = UDFParam("table -> table function", default=None)
    transformSchemaFunc = UDFParam("schema -> schema function", default=None)

    @staticmethod
    def apply(fn: Callable[[DataTable], DataTable]) -> "Lambda":
        return Lambda(transformFunc=fn)

    def transform(self, table: DataTable) -> DataTable:
        fn = self.get("transformFunc")
        if fn is None:
            raise ValueError("transformFunc is not set")
        return fn(table)

    def transform_schema(self, schema: Schema) -> Schema:
        fn = self.get_or_none("transformSchemaFunc")
        return fn(schema) if fn is not None else schema


class UDFTransformer(Transformer, HasInputCol, HasOutputCol):
    """Apply a per-value (or per-row-dict) function to produce a new
    column (ref: UDFTransformer.scala:21)."""

    udf = UDFParam("value -> value function", default=None)
    inputCols = ListParam("multiple input columns (row-dict mode)",
                          default=None)

    def transform(self, table: DataTable) -> DataTable:
        fn = self.get("udf")
        if fn is None:
            raise ValueError("udf is not set")
        in_cols = self.get_or_none("inputCols")
        if in_cols:
            out = [fn(*(row[c] for c in in_cols)) for row in table.rows()]
        else:
            out = [fn(v) for v in table[self.get_input_col()]]
        return table.with_column(self.get_output_col(), out)


class ClassBalancer(Estimator, HasInputCol, HasOutputCol):
    """Compute inverse-frequency weights for a label column
    (ref: ClassBalancer.scala: weight = maxCount/count per level)."""

    broadcastJoin = BoolParam("unused; parity param", default=False)

    def __init__(self, **kw):
        kw.setdefault("outputCol", "weight")
        super().__init__(**kw)

    def fit(self, table: DataTable) -> "ClassBalancerModel":
        col = table[self.get_input_col()]
        vals, counts = np.unique(np.asarray(col), return_counts=True)
        weights = counts.max() / counts
        mapping = {v.item() if hasattr(v, "item") else v: float(w)
                   for v, w in zip(vals, weights)}
        return ClassBalancerModel(weights=mapping).set(
            "inputCol", self.get_input_col()).set(
            "outputCol", self.get_output_col())


class ClassBalancerModel(Model, HasInputCol, HasOutputCol):
    weights = DictParam("label value -> weight", default=None)

    def transform(self, table: DataTable) -> DataTable:
        mapping = self.get("weights") or {}
        col = table[self.get_input_col()]
        out = np.asarray([mapping.get(
            v.item() if hasattr(v, "item") else v, 1.0) for v in col])
        return table.with_column(self.get_output_col(), out,
                                 Field(self.get_output_col(), F64))

    def transform_schema(self, schema: Schema) -> Schema:
        return schema.add_or_replace(Field(self.get_output_col(), F64))


class TextPreprocessor(Transformer, HasInputCol, HasOutputCol):
    """Trie-based find/replace normalization over a string column
    (ref: TextPreprocessor.scala — longest-match substring replace)."""

    map = DictParam("substring -> replacement", default=None)
    normFunc = StringParam("pre-normalization: lower|upper|none",
                           default="none")

    def transform(self, table: DataTable) -> DataTable:
        mapping = self.get("map") or {}
        norm = self.get("normFunc")
        # longest-first matching reproduces trie longest-match semantics
        keys = sorted(mapping, key=len, reverse=True)

        def clean(s: Optional[str]) -> Optional[str]:
            if s is None:
                return None
            if norm == "lower":
                s = s.lower()
            elif norm == "upper":
                s = s.upper()
            out = []
            i = 0
            while i < len(s):
                for k in keys:
                    if k and s.startswith(k, i):
                        out.append(mapping[k])
                        i += len(k)
                        break
                else:
                    out.append(s[i])
                    i += 1
            return "".join(out)

        vals = [clean(v) for v in table[self.get_input_col()]]
        return table.with_column(self.get_output_col(), vals,
                                 Field(self.get_output_col(), STRING))


class Timer(Estimator):
    """Wrap a stage, log fit/transform wall-clock
    (ref: Timer.scala:54). An Estimator so Pipeline.fit() fits the
    wrapped estimator exactly once; the resulting TimerModel carries the
    fitted model to scoring time."""

    stage = StageParam("the wrapped stage", default=None)
    logToScala = BoolParam("log through framework logger", default=True)
    traceDir = StringParam(
        "emit a torch.profiler trace of the wrapped stage here "
        "(SURVEY §5: the profiler upgrade over wall-clock logging)",
        default="")

    def fit(self, table: DataTable) -> "TimerModel":
        from mmlspark_tpu_torch.utils.profiling import maybe_trace
        inner = self.get("stage")
        if isinstance(inner, Estimator):
            t0 = time.time()
            with maybe_trace(self.get("traceDir")):
                fitted = inner.fit(table)
            self._log(f"fit of {type(inner).__name__} took "
                      f"{time.time()-t0:.3f}s")
        else:
            fitted = inner
        return TimerModel(stage=fitted, logToScala=self.get("logToScala"),
                          traceDir=self.get("traceDir"))

    def transform(self, table: DataTable) -> DataTable:
        """Convenience for wrapping a pure Transformer outside a
        pipeline."""
        return self.fit(table).transform(table)

    def _log(self, msg: str) -> None:
        if self.get("logToScala"):
            log.info(msg)

    def transform_schema(self, schema: Schema) -> Schema:
        return self.get("stage").transform_schema(schema)


class TimerModel(Model):
    stage = StageParam("the fitted wrapped stage", default=None)
    logToScala = BoolParam("log through framework logger", default=True)
    traceDir = StringParam("emit a torch.profiler trace here",
                           default="")

    def transform(self, table: DataTable) -> DataTable:
        from mmlspark_tpu_torch.utils.profiling import maybe_trace
        inner = self.get("stage")
        t0 = time.time()
        with maybe_trace(self.get("traceDir")):
            out = inner.transform(table)
        if self.get("logToScala"):
            log.info(f"transform of {type(inner).__name__} took "
                     f"{time.time()-t0:.3f}s")
        return out

    def transform_schema(self, schema: Schema) -> Schema:
        return self.get("stage").transform_schema(schema)


class CheckpointData(Transformer):
    """Persist the table to host memory (and optionally disk)
    (ref: checkpoint-data/.../CheckpointData.scala:47)."""

    diskIncluded = BoolParam("also spill to disk", default=False)
    removeCheckpoint = BoolParam("unpersist instead", default=False)
    checkpointDir = StringParam("disk spill directory", default="")

    def transform(self, table: DataTable) -> DataTable:
        if self.get("removeCheckpoint"):
            return table
        if self.get("diskIncluded") and self.get("checkpointDir"):
            import os
            path = os.path.join(self.get("checkpointDir"),
                                f"checkpoint_{self.uid}")
            table.save(path)
        return table.cache()
