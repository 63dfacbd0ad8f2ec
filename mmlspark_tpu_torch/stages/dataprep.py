"""Data-preparation stages: the PyTorch port's copy of
``mmlspark_tpu/stages/dataprep.py`` (host numpy, bitwise equal to it).

Parity set (ref: SURVEY.md §2 "Misc data ops"): ValueIndexer /
ValueIndexerModel (typed distinct-values dictionary → categorical
metadata, ref: src/value-indexer/.../ValueIndexer.scala:54),
CleanMissingData (mean/median/custom impute, ref:
src/clean-missing-data/.../CleanMissingData.scala:46), DataConversion
(column casts, ref: src/data-conversion/.../DataConversion.scala:23),
SummarizeData (ref: src/summarize-data/.../SummarizeData.scala:98),
PartitionSample (ref: src/partition-sample/.../PartitionSample.scala:24),
EnsembleByKey (ref: src/ensemble/.../EnsembleByKey.scala:21),
MultiColumnAdapter (ref: src/multi-column-adapter/.../MultiColumnAdapter.scala:17),
FastVectorAssembler and StandardScaler.

The reference's streamed fits over a ``ChunkedTable`` (ValueIndexer,
StandardScaler, SummarizeData's one-pass summary, the scaler's lazy
map) raise here (``io.ooc.refuse_chunked``, ROADMAP.md 'Out-of-core
ingest'); ``_StreamingMoments``, that summary's mergeable accumulator,
is kept and held to the JAX package's. The fused ``device_op`` hooks
and column-flow declarations belong to 'Device pipeline and serving
compilation'.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from mmlspark_tpu_torch.core.params import (
    BoolParam, ColParam, DictParam, EnumParam, FloatParam, HasInputCol,
    HasOutputCol, IntParam, ListParam, StageParam, StringParam,
)
from mmlspark_tpu_torch.core.schema import (
    Field, Schema, BOOL, F32, F64, I32, I64, STRING, VECTOR,
)
from mmlspark_tpu_torch.core.stage import Estimator, Model, Transformer
from mmlspark_tpu_torch.core.table import DataTable, features_matrix
from mmlspark_tpu_torch.io.ooc import refuse_chunked
from mmlspark_tpu_torch.stages.text import string_codes


class ValueIndexer(Estimator, HasInputCol, HasOutputCol):
    """Build a typed distinct-values dictionary and index the column to
    categorical codes, recording levels in column metadata
    (ref: ValueIndexer.scala:54; Categoricals.scala metadata)."""

    def fit(self, table: DataTable) -> "ValueIndexerModel":
        refuse_chunked(table, "ValueIndexer.fit")
        levels = table.distinct_values(self.get_input_col())
        # nulls are not levels (ref: ValueIndexer verifies non-null)
        levels = [v for v in levels if v is not None]
        try:
            levels = sorted(levels)
        except TypeError:
            pass
        levels = [v.item() if hasattr(v, "item") else v for v in levels]
        return (ValueIndexerModel(levels=levels)
                .set("inputCol", self.get_input_col())
                .set("outputCol", self.get_output_col()))


class ValueIndexerModel(Model, HasInputCol, HasOutputCol):
    levels = ListParam("ordered category levels", default=None)

    def transform(self, table: DataTable) -> DataTable:
        levels = self.get("levels") or []
        col = table[self.get_input_col()]
        # columnar: one dict probe per DISTINCT value (arrow dictionary
        # encode for strings; the np/dict fallbacks keep exact parity —
        # np scalars hash/compare equal to their .item() values, so the
        # old per-row .item() normalization is preserved)
        out = string_codes(col, levels).astype(np.float64)
        f = Field(self.get_output_col(), F64,
                  {"categorical": True, "levels": levels})
        return table.with_column(self.get_output_col(), out, f)

    def transform_schema(self, schema: Schema) -> Schema:
        levels = self.get("levels") or []
        return schema.add_or_replace(Field(
            self.get_output_col(), F64,
            {"categorical": True, "levels": levels}))

    def unindex(self, table: DataTable, col: Optional[str] = None,
                out_col: Optional[str] = None) -> DataTable:
        """Codes -> original values (IndexToValue analog)."""
        levels = self.get("levels") or []
        col = col or self.get_output_col()
        out_col = out_col or self.get_input_col()
        vals = unindex_codes(table[col], levels)
        return table.with_column(out_col, vals)


def unindex_codes(codes, levels: List[Any]) -> List[Any]:
    """Vectorized codes -> original level values (out-of-range/-1 ->
    None), one levels-table gather instead of a per-row lookup."""
    arr = np.asarray(codes).astype(np.int64)
    lut = np.empty(len(levels) + 1, dtype=object)
    lut[:len(levels)] = levels
    lut[len(levels)] = None
    ok = (arr >= 0) & (arr < len(levels))
    return lut[np.where(ok, arr, len(levels))].tolist()


class CleanMissingData(Estimator):
    """Impute missing values: mean/median/custom
    (ref: CleanMissingData.scala:46)."""

    inputCols = ListParam("columns to clean", default=None)
    outputCols = ListParam("output columns", default=None)
    cleaningMode = EnumParam(["Mean", "Median", "Custom"],
                             "imputation mode", default="Mean")
    customValue = FloatParam("custom fill value", default=0.0)

    def fit(self, table: DataTable) -> "CleanMissingDataModel":
        in_cols = self.get("inputCols") or []
        out_cols = self.get("outputCols") or in_cols
        mode = self.get("cleaningMode")
        fills: Dict[str, float] = {}
        for c in in_cols:
            col = np.asarray(table[c], dtype=np.float64)
            finite = col[np.isfinite(col)]
            if mode == "Mean":
                fills[c] = float(finite.mean()) if finite.size else 0.0
            elif mode == "Median":
                fills[c] = float(np.median(finite)) if finite.size else 0.0
            else:
                fills[c] = self.get("customValue")
        return CleanMissingDataModel(
            inputCols=list(in_cols), outputCols=list(out_cols),
            fillValues=fills)


class CleanMissingDataModel(Model):
    inputCols = ListParam("columns to clean", default=None)
    outputCols = ListParam("output columns", default=None)
    fillValues = DictParam("column -> fill value", default=None)

    def transform(self, table: DataTable) -> DataTable:
        fills = self.get("fillValues") or {}
        out = table
        for c, oc in zip(self.get("inputCols") or [],
                         self.get("outputCols") or []):
            col = np.asarray(table[c], dtype=np.float64)
            filled = np.where(np.isfinite(col), col, fills.get(c, 0.0))
            out = out.with_column(oc, filled, Field(oc, F64))
        return out

    def transform_schema(self, schema: Schema) -> Schema:
        for oc in self.get("outputCols") or []:
            schema = schema.add_or_replace(Field(oc, F64))
        return schema


_CAST_TABLE = {
    "boolean": (bool, BOOL), "byte": (np.int8, I32),
    "short": (np.int16, I32), "integer": (np.int32, I32),
    "long": (np.int64, I64), "float": (np.float32, F32),
    "double": (np.float64, F64), "string": (str, STRING),
}


class DataConversion(Transformer):
    """Cast columns between types; date reformat
    (ref: DataConversion.scala:23-150)."""

    cols = ListParam("columns to convert", default=None)
    convertTo = StringParam("target type", default="double")
    dateTimeFormat = StringParam("strftime format for date conversion",
                                 default="%Y-%m-%d %H:%M:%S")

    def transform(self, table: DataTable) -> DataTable:
        target = self.get("convertTo")
        out = table
        for c in self.get("cols") or []:
            col = table[c]
            if target == "date":
                import datetime
                fmt = self.get("dateTimeFormat")
                vals = [None if v is None else
                        datetime.datetime.strptime(str(v), fmt)
                        for v in col]
                out = out.with_column(c, vals)
                continue
            if target == "toCategorical":
                model = ValueIndexer(inputCol=c, outputCol=c).fit(out)
                out = model.transform(out)
                continue
            if target == "clearCategorical":
                f = out.schema[c]
                meta = {k: v for k, v in f.meta.items()
                        if k not in ("categorical", "levels")}
                out = out.with_field(Field(c, f.tag, meta, f.fields))
                continue
            py_t, tag = _CAST_TABLE[target]
            if target == "string":
                vals = [None if v is None else str(v) for v in col]
                out = out.with_column(c, vals, Field(c, STRING))
            else:
                arr = np.asarray(col).astype(py_t)
                out = out.with_column(c, arr, Field(c, tag))
        return out


class SummarizeData(Transformer):
    """Summary statistics table: counts / basic / sample / percentiles
    (ref: SummarizeData.scala:98)."""

    counts = BoolParam("include counts", default=True)
    basic = BoolParam("include basic stats", default=True)
    sample = BoolParam("include sample stats", default=True)
    percentiles = BoolParam("include percentiles", default=True)
    errorThreshold = FloatParam("percentile error (parity param)",
                                default=0.0)

    def transform_schema(self, schema: Schema) -> Schema:
        fields = [Field("Feature", STRING)]
        if self.get("counts"):
            fields += [Field(n, F64) for n in
                       ("Count", "Unique_Value_Count",
                        "Missing_Value_Count")]
        return Schema(fields)

    # distinct-count cap for the chunked path: past this the streaming
    # union stops and Unique_Value_Count reports NaN instead of
    # materializing an unbounded value set on the host
    _CHUNKED_UNIQUE_CAP = 1_000_000

    def transform(self, table: DataTable) -> DataTable:
        refuse_chunked(table, "SummarizeData.transform")
        rows: List[Dict[str, Any]] = []
        for name in table.column_names:
            col = table[name]
            row: Dict[str, Any] = {"Feature": name}
            is_num = isinstance(col, np.ndarray) and col.ndim == 1 \
                and np.issubdtype(col.dtype, np.number)
            n = len(table)
            if self.get("counts"):
                if is_num:
                    missing = int(np.sum(~np.isfinite(
                        col.astype(np.float64))))
                else:
                    missing = sum(1 for v in col if v is None)
                try:
                    unique = float(len(table.distinct_values(name)))
                except TypeError:  # unhashable (list/struct) values
                    unique = float("nan")
                row.update(Count=float(n),
                           Unique_Value_Count=unique,
                           Missing_Value_Count=float(missing))
            if is_num:
                x = col.astype(np.float64)
                x = x[np.isfinite(x)]
                if self.get("basic") and x.size:
                    row.update(Max=float(x.max()), Min=float(x.min()),
                               Mean=float(x.mean()),
                               Range=float(x.max() - x.min()))
                if self.get("sample") and x.size > 1:
                    row.update(Sample_Variance=float(x.var(ddof=1)),
                               Sample_Standard_Deviation=float(
                                   x.std(ddof=1)),
                               Sample_Skewness=float(_skew(x)),
                               Sample_Kurtosis=float(_kurt(x)))
                if self.get("percentiles") and x.size:
                    for q, label in ((0.5, "Median"), (0.25, "P25"),
                                     (0.75, "P75"), (0.05, "P5"),
                                     (0.95, "P95")):
                        row[label] = float(np.quantile(x, q))
            rows.append(row)
        return DataTable.from_rows(rows)

class _StreamingMoments:
    """Mergeable count/mean/M2..M4 + min/max over finite values —
    chunk-wise central-moment combine (Pébay, SAND2008-6212), the
    streaming backbone of ``SummarizeData``'s chunked path."""

    def __init__(self):
        self.n = 0
        self._mean = 0.0
        self._m2 = self._m3 = self._m4 = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def update(self, x: np.ndarray) -> None:
        nb = int(x.size)
        if nb == 0:
            return
        mb = float(x.mean())
        d = x - mb
        m2b = float((d ** 2).sum())
        m3b = float((d ** 3).sum())
        m4b = float((d ** 4).sum())
        self.min = min(self.min, float(x.min()))
        self.max = max(self.max, float(x.max()))
        na, ma = self.n, self._mean
        if na == 0:
            self.n, self._mean = nb, mb
            self._m2, self._m3, self._m4 = m2b, m3b, m4b
            return
        n = na + nb
        delta = mb - ma
        self._mean = ma + delta * nb / n
        m2a, m3a, m4a = self._m2, self._m3, self._m4
        self._m2 = m2a + m2b + delta ** 2 * na * nb / n
        self._m3 = (m3a + m3b
                    + delta ** 3 * na * nb * (na - nb) / n ** 2
                    + 3.0 * delta * (na * m2b - nb * m2a) / n)
        self._m4 = (m4a + m4b
                    + delta ** 4 * na * nb
                    * (na * na - na * nb + nb * nb) / n ** 3
                    + 6.0 * delta ** 2
                    * (na * na * m2b + nb * nb * m2a) / n ** 2
                    + 4.0 * delta * (na * m3b - nb * m3a) / n)
        self.n = n

    @property
    def mean(self) -> float:
        return self._mean

    @property
    def variance(self) -> float:
        """Sample variance (ddof=1)."""
        return self._m2 / (self.n - 1) if self.n > 1 else 0.0

    @property
    def std(self) -> float:
        return float(np.sqrt(self.variance))

    @property
    def skewness(self) -> float:
        s = self.std
        return float((self._m3 / self.n) / (s ** 3 + 1e-300))

    @property
    def kurtosis(self) -> float:
        s = self.std
        return float((self._m4 / self.n) / (s ** 4 + 1e-300) - 3.0)


def _skew(x: np.ndarray) -> float:
    m = x.mean()
    s = x.std(ddof=1)
    return float(((x - m) ** 3).mean() / (s ** 3 + 1e-300))


def _kurt(x: np.ndarray) -> float:
    m = x.mean()
    s = x.std(ddof=1)
    return float(((x - m) ** 4).mean() / (s ** 4 + 1e-300) - 3.0)


class PartitionSample(Transformer):
    """head / random sample / assign-to-partitions
    (ref: PartitionSample.scala:24-127)."""

    mode = EnumParam(["Head", "RandomSample", "AssignToPartition"],
                     "sampling mode", default="RandomSample")
    count = IntParam("head count", default=1000)
    percent = FloatParam("sample fraction", default=0.1)
    rs_seed = IntParam("seed", default=0)
    numParts = IntParam("partitions for assignment", default=2)
    newColName = ColParam("partition-id column", default="Partition")

    def transform(self, table: DataTable) -> DataTable:
        mode = self.get("mode")
        if mode == "Head":
            return table.take(self.get("count"))
        if mode == "RandomSample":
            return table.sample(self.get("percent"), seed=self.get("rs_seed"))
        rng = np.random.default_rng(self.get("rs_seed"))
        parts = rng.integers(0, self.get("numParts"), size=len(table))
        return table.with_column(self.get("newColName"),
                                 parts.astype(np.int64))


class EnsembleByKey(Transformer):
    """Group by key column(s), average vector/scalar column(s)
    (ref: EnsembleByKey.scala:21)."""

    keys = ListParam("grouping key columns", default=None)
    cols = ListParam("columns to average", default=None)
    colNames = ListParam("output names (default <col>_avg)", default=None)
    strategy = EnumParam(["mean"], "ensemble strategy", default="mean")
    collapseGroup = BoolParam("one row per group", default=True)
    vectorDims = DictParam("parity param; unused", default=None)

    def transform_schema(self, schema: Schema) -> Schema:
        keys = self.get("keys") or []
        cols = self.get("cols") or []
        names = self.get("colNames") or [f"{c}_avg" for c in cols]
        # averaging always yields f64 scalars; vectors stay vectors
        avg_fields = [Field(n, VECTOR if schema[c].tag == VECTOR else F64)
                      for n, c in zip(names, cols)]
        if self.get("collapseGroup"):
            return Schema([schema[k] for k in keys] + avg_fields)
        out = schema
        for f in avg_fields:
            out = out.add_or_replace(f)
        return out

    def transform(self, table: DataTable) -> DataTable:
        keys = self.get("keys") or []
        cols = self.get("cols") or []
        names = self.get("colNames") or [f"{c}_avg" for c in cols]
        groups: Dict[Any, List[int]] = {}
        for i, r in enumerate(table.rows()):
            k = tuple(r[k2] for k2 in keys)
            groups.setdefault(k, []).append(i)
        out_rows = []
        for k, idxs in groups.items():
            row = {kc: kv for kc, kv in zip(keys, k)}
            for c, nm in zip(cols, names):
                col = table[c]
                vals = [np.asarray(col[i], dtype=np.float64) for i in idxs]
                row[nm] = np.mean(np.stack(vals), axis=0) \
                    if vals[0].ndim else float(np.mean(vals))
            out_rows.append(row)
        result = DataTable.from_rows(out_rows)
        if not self.get("collapseGroup"):
            # broadcast group values back onto original rows
            key_to_row = {tuple(r[k] for k in keys): r
                          for r in result.rows()}
            merged = []
            for r in table.rows():
                k = tuple(r[k2] for k2 in keys)
                nr = dict(r)
                for c, nm in zip(cols, names):
                    nr[nm] = key_to_row[k][nm]
                merged.append(nr)
            return DataTable.from_rows(merged)
        return result


class MultiColumnAdapter(Estimator):
    """Apply a unary stage to each of N columns
    (ref: MultiColumnAdapter.scala:17). fit() fits one copy of the base
    stage per column and returns a model holding the fitted copies, so
    estimator state (e.g. ValueIndexer levels) comes from the training
    table, never the scoring table."""

    baseStage = StageParam("the unary stage to replicate", default=None)
    inputCols = ListParam("input columns", default=None)
    outputCols = ListParam("output columns", default=None)

    def fit(self, table: DataTable) -> "MultiColumnAdapterModel":
        base = self.get("baseStage")
        fitted: List[Any] = []
        for ic, oc in zip(self.get("inputCols") or [],
                          self.get("outputCols") or []):
            stage = base.copy()
            stage.uid = f"{base.uid}_{ic}"
            stage.set("inputCol", ic).set("outputCol", oc)
            if isinstance(stage, Estimator):
                stage = stage.fit(table)
            fitted.append(stage)
        return MultiColumnAdapterModel(stages=fitted)

    def transform(self, table: DataTable) -> DataTable:
        """Convenience for pure-Transformer base stages."""
        base = self.get("baseStage")
        if isinstance(base, Estimator):
            raise TypeError(
                "baseStage is an Estimator; call fit() first so per-column "
                "state is learned from the training table")
        return self.fit(table).transform(table)


class MultiColumnAdapterModel(Model):
    from mmlspark_tpu_torch.core.params import ComplexParam as _CxP
    stages = _CxP("fitted per-column stages", default=None)

    def transform(self, table: DataTable) -> DataTable:
        out = table
        for stage in self.get("stages") or []:
            out = stage.transform(out)
        return out

    def transform_schema(self, schema: Schema) -> Schema:
        for stage in self.get("stages") or []:
            schema = stage.transform_schema(schema)
        return schema


class FastVectorAssembler(Transformer, HasOutputCol):
    """Assemble numeric/vector columns into one vector column without a
    metadata walk (ref: src/core/spark/.../FastVectorAssembler.scala:23).

    Scalars contribute one slot, array/vector columns contribute their
    width; output is float32 (the device-boundary dtype). Null/NaN
    handling matches the reference's assembler: NaNs pass through."""

    inputCols = ListParam("columns to assemble", default=None)

    def __init__(self, **kw):
        kw.setdefault("outputCol", "features")
        super().__init__(**kw)

    def transform(self, table: DataTable) -> DataTable:
        cols = self.get("inputCols")
        if not cols:
            raise ValueError("inputCols is not set")
        parts = []
        for c in cols:
            v = table[c]
            arr = (v if isinstance(v, np.ndarray)
                   else np.asarray([np.asarray(x, dtype=np.float64)
                                    for x in v]))
            if arr.ndim == 1:
                arr = arr[:, None]
            parts.append(arr.astype(np.float32))
        out = np.concatenate(parts, axis=1)
        return table.with_column(self.get_output_col(), out,
                                 Field(self.get_output_col(), VECTOR))

    def transform_schema(self, schema: Schema) -> Schema:
        for c in self.get("inputCols") or []:
            schema.require(c)
        return schema.add_or_replace(Field(self.get_output_col(), VECTOR))

class StandardScaler(Estimator, HasInputCol, HasOutputCol):
    """Standardize a vector (or scalar numeric) column to zero mean /
    unit variance with fit-time statistics — the explicit pipeline-stage
    form of the ``_Standardizer`` every linear model folds into its fit
    (SparkML StandardScaler parity). Near-constant features keep unit
    scale (the 1e-12 floor), so standardization never divides by ~0.

    The fitted model computes in float32 (the device-boundary dtype) on
    BOTH the host and the fused path, so fused and staged outputs are
    bit-identical for this stage."""

    # redeclared with REAL defaults so the generated API docs match
    # behavior (the mixin defaults of "input"/"output" never apply)
    inputCol = ColParam("column to standardize", default="features")
    outputCol = ColParam(
        "output column; when not set, the input column is standardized "
        "in place", default="features")
    withMean = BoolParam("center to zero mean", default=True)
    withStd = BoolParam("scale to unit variance", default=True)

    def _on_param_change(self, name: str) -> None:
        # in-place default: while the user has never named outputCol
        # explicitly, it FOLLOWS inputCol (standardize in place) —
        # constructor kwargs and later .set() calls behave identically
        # (the param doc's contract). Direct map write: the triggering
        # set() already bumped the epoch.
        if name == "outputCol":
            self._auto_output = False
        elif name == "inputCol" and (
                "outputCol" not in self._paramMap
                or getattr(self, "_auto_output", False)):
            self._paramMap["outputCol"] = self.get("inputCol")
            self._auto_output = True

    def fit(self, table: DataTable) -> "StandardScalerModel":
        refuse_chunked(table, "StandardScaler.fit")
        col = table[self.get_input_col()]
        if isinstance(col, np.ndarray) and col.ndim == 1:
            X = np.asarray(col, dtype=np.float64)[:, None]
            scalar = True
        else:
            X = features_matrix(table, self.get_input_col())
            scalar = False
        mu = X.mean(axis=0)
        sd = X.std(axis=0)
        sd = np.where(sd < 1e-12, 1.0, sd)
        if not self.get("withMean"):
            mu = np.zeros_like(mu)
        if not self.get("withStd"):
            sd = np.ones_like(sd)
        model = StandardScalerModel(
            mu=mu.astype(np.float32), sd=sd.astype(np.float32),
            scalarInput=scalar)
        model.set("inputCol", self.get_input_col())
        model.set("outputCol", self.get_output_col())
        return model

class StandardScalerModel(Model, HasInputCol, HasOutputCol):
    from mmlspark_tpu_torch.core.params import PyTreeParam as _PT
    inputCol = ColParam("column to standardize", default="features")
    outputCol = ColParam("output column (fit copies the estimator's "
                         "setting)", default="features")
    mu = _PT("fit-time per-feature means (float32)", default=None)
    sd = _PT("fit-time per-feature stds (float32, 1.0 floor)",
             default=None)
    scalarInput = BoolParam("input was a scalar numeric column",
                            default=False)

    def _load(self, table: DataTable) -> np.ndarray:
        col = table[self.get_input_col()]
        if isinstance(col, np.ndarray):
            return np.asarray(col, dtype=np.float32)
        return np.stack([np.asarray(v, dtype=np.float32) for v in col])

    def transform(self, table: DataTable) -> DataTable:
        refuse_chunked(table, "StandardScalerModel.transform")
        x = self._load(table)
        mu = np.asarray(self.get("mu"), np.float32)
        sd = np.asarray(self.get("sd"), np.float32)
        if x.ndim == 1:
            out = (x - mu[0]) / sd[0]
            field = Field(self.get_output_col(), F32)
        else:
            out = (x - mu) / sd
            field = Field(self.get_output_col(), VECTOR)
        return table.with_column(self.get_output_col(), out, field)

    def transform_schema(self, schema: Schema) -> Schema:
        f = schema[self.get_input_col()]
        tag = VECTOR if f.tag == VECTOR else F32
        return schema.add_or_replace(Field(self.get_output_col(), tag))
