"""Auto-featurization: per-type column pipelines → one features vector.

The PyTorch port's copy of ``mmlspark_tpu/automl/featurize.py``: host
numpy, bitwise equal to it.

Analog of the reference's featurize component
(ref: src/featurize/src/main/scala/Featurize.scala:24-96,
AssembleFeatures.scala:92-303): numeric columns are imputed and passed
through, string/categorical columns are indexed (one-hot optionally),
token-list columns are hash-vectorized, vector columns concatenate
as-is, and everything is assembled into a single dense ``features``
column (FastVectorAssembler analog — the assembled matrix is exactly the
(N, D) array device stages consume, so assembly is one np.concatenate,
no metadata walk; ref: src/core/spark/.../FastVectorAssembler.scala:23).

Every per-column kernel is COLUMNAR: token hashing runs through the
vectorized distinct-token kernels in ``stages/text`` (each distinct
token hashes once, counts scatter in one key sort), string
index/one-hot map through a unique-value LUT instead of a per-row dict
probe, and fit's level scan uses np.unique. The pre-vectorization
per-row loops survive as ``_build_parts_rowloop`` — the bit-parity
oracle the tests and ``chip_smoke.py``'s AutoML phase measure against.

A ``ChunkedTable`` given to ``Featurize.fit`` or
``FeaturizeModel.transform`` raises (ROADMAP.md, 'Out-of-core ingest');
the reference's ``core/trace`` spans and fused ``device_op`` are not
ported ('Device pipeline and serving compilation'). The
``featurize_fit`` / ``featurize_transform`` histograms are observed.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from mmlspark_tpu_torch.core import metrics as MC
from mmlspark_tpu_torch.core.params import (
    BoolParam, ColParam, IntParam, ListParam,
)
from mmlspark_tpu_torch.core.schema import (
    Field, Schema, BOOL, F32, F64, I8, I16, I32, I64, LIST, STRING, VECTOR,
)
from mmlspark_tpu_torch.core.stage import Estimator, Model
from mmlspark_tpu_torch.core.sparse import CSRMatrix
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.io.ooc import refuse_chunked
from mmlspark_tpu_torch.stages.text import (
    _hash_counts, _stable_hash, hash_counts_csr,
    hash_counts_dense, string_codes as _string_codes,
)

_NUMERIC_TAGS = {F32, F64, I8, I16, I32, I64, BOOL}


def _column_spec(c: str, f: Field, *, one_hot: bool, hash_width: int,
                 sparse: bool, mean: float,
                 levels: Optional[List[Any]]) -> Optional[Dict[str, Any]]:
    """THE per-column spec switch, shared by the in-memory and
    streaming fits — only where ``mean``/``levels`` come from differs
    between them, so the two paths cannot drift. Returns None for
    unsupported tags (struct/bytes/object), which both fits skip like
    the reference drops unsupported columns."""
    if f.tag in _NUMERIC_TAGS:
        if f.meta.get("categorical") and one_hot:
            n = len(f.meta.get("levels") or [])
            return {"col": c, "kind": "onehot", "size": n}
        return {"col": c, "kind": "numeric", "fill": mean}
    if f.tag == STRING:
        if one_hot:
            return {"col": c, "kind": "string_onehot", "levels": levels}
        return {"col": c, "kind": "string_index", "levels": levels}
    if f.tag == LIST:
        return {"col": c, "kind": "hash", "size": hash_width,
                "sparse": sparse}
    if f.tag == VECTOR:
        return {"col": c, "kind": "vector"}
    return None


def _distinct_levels(col) -> List[Any]:
    """Non-None distinct values of a string column, sorted when
    comparable — the vectorized fit-side level scan. String columns with
    no Nones take the C-speed np.unique path; anything else falls back
    to the original first-seen dict + try-sorted discipline (identical
    output: sorted distinct when sortable, first-seen order when not)."""
    vals = col if isinstance(col, list) else list(col)
    try:
        arr = np.asarray(vals)
    except Exception:  # noqa: BLE001 — fall through to the dict scan
        arr = None
    if arr is not None and arr.dtype.kind in ("U", "S"):
        return list(np.unique(arr).tolist())
    seen: Dict[Any, None] = {}
    for v in vals:
        if v is not None:
            seen.setdefault(v, None)
    levels = list(seen.keys())
    try:
        levels = sorted(levels)
    except TypeError:
        pass
    return levels


class Featurize(Estimator):
    """Auto-featurize selected columns into a single vector column
    (ref: Featurize.scala:24; defaults :13-19 — oneHot off, 262144
    hashing features for text)."""

    featureColumns = ListParam("input columns (None = all but output)",
                               default=None)
    outputCol = ColParam("assembled features column", default="features")
    oneHotEncodeCategoricals = BoolParam("one-hot index columns",
                                         default=False)
    # The reference defaults to 262144 (Featurize.scala:13-19) and keeps
    # hashing-TF output *sparse*. Dense mode lowers the default to 2^12
    # (dense 2^18 is ~2 MB/row); sparse=True restores the reference
    # behavior: CSR assembly at the full 262144 width, never densified.
    numberOfFeatures = IntParam("hash width for token columns",
                                default=1 << 12)
    sparse = BoolParam(
        "assemble a CSR sparse features column (hash width defaults to "
        "the reference's 262144 when unset; ref: Featurize.scala:13-19)",
        default=False)
    allowImages = BoolParam("parity param (image passthrough)",
                            default=False)

    def _hash_width(self) -> int:
        if self.get("sparse") and "numberOfFeatures" not in self._paramMap:
            return 1 << 18    # the reference's sparse default
        return self.get("numberOfFeatures")

    def fit(self, table: DataTable) -> "FeaturizeModel":
        refuse_chunked(table, "Featurize.fit")
        t0 = time.perf_counter()
        cols = self.get_or_none("featureColumns")
        if cols is None:
            cols = [c for c in table.column_names
                    if c != self.get("outputCol")]
        specs: List[Dict[str, Any]] = []
        for c in cols:
            f = table.schema[c]
            mean = 0.0
            levels: Optional[List[Any]] = None
            if f.tag in _NUMERIC_TAGS:
                col = np.asarray(table[c], dtype=np.float64)
                finite = col[np.isfinite(col)]
                mean = float(finite.mean()) if finite.size else 0.0
            elif f.tag == STRING:
                levels = _distinct_levels(table[c])
            spec = _column_spec(
                c, f, one_hot=self.get("oneHotEncodeCategoricals"),
                hash_width=self._hash_width(),
                sparse=self.get("sparse"), mean=mean, levels=levels)
            if spec is not None:
                specs.append(spec)
        MC.automl_histograms()["featurize_fit"].observe(
            (time.perf_counter() - t0) * 1e3)
        return FeaturizeModel(specs=specs,
                              outputCol=self.get("outputCol"))

def _spec_width(spec: Dict[str, Any], table: DataTable) -> int:
    """Output width of one spec's block in the assembled matrix."""
    kind = spec["kind"]
    if kind in ("numeric", "string_index"):
        return 1
    if kind in ("onehot", "hash"):
        return spec["size"]
    if kind == "string_onehot":
        return len(spec["levels"])
    if kind == "vector":
        col = table[spec["col"]]
        if isinstance(col, np.ndarray) and col.ndim == 2:
            return col.shape[1]
        return int(np.asarray(col[0], dtype=np.float32).shape[0]) \
            if len(col) else 0
    raise ValueError(f"unknown featurize spec kind {kind!r}")


def _fill_part(spec: Dict[str, Any], table: DataTable,
               view: np.ndarray) -> None:
    """One spec -> its (N, w) float32 slice of the assembled matrix,
    written IN PLACE (``view`` is a column slice of the final array, so
    dense assembly needs no per-part temporaries and no concat copy)."""
    c = spec["col"]
    kind = spec["kind"]
    n = len(table)
    if kind == "numeric":
        col = np.asarray(table[c], dtype=np.float32)
        view[:, 0] = np.where(np.isfinite(col), col,
                              np.float32(spec["fill"]))
    elif kind == "onehot":
        col = np.asarray(table[c], dtype=np.int64)
        size = spec["size"]
        view[:] = 0.0
        ok = (col >= 0) & (col < size)
        view[np.arange(n)[ok], col[ok]] = 1.0
    elif kind == "string_index":
        codes = _string_codes(table[c], spec["levels"])
        view[:, 0] = codes.astype(np.float32)
    elif kind == "string_onehot":
        codes = _string_codes(table[c], spec["levels"])
        view[:] = 0.0
        ok = codes >= 0
        view[np.nonzero(ok)[0], codes[ok]] = 1.0
    elif kind == "hash":
        # float32 counts: TF counts are small integers, exact in f32
        hash_counts_dense(table[c], spec["size"], binary=False, out=view)
    elif kind == "vector":
        col = table[c]
        if isinstance(col, np.ndarray) and col.ndim == 2:
            view[:] = col
        elif len(col):
            view[:] = np.stack(
                [np.asarray(v, dtype=np.float32) for v in col])
    else:
        raise ValueError(f"unknown featurize spec kind {kind!r}")


def _build_part(spec: Dict[str, Any], table: DataTable):
    """One spec -> one standalone columnar block (the mixed
    sparse/dense assembly path; dense-only assembly fills slices of
    the final matrix directly instead)."""
    if spec["kind"] == "hash" and spec.get("sparse"):
        # reference behavior: 262144-wide hashed text stays a
        # SparseVector end to end (Featurize.scala:13-19) — here a
        # CSR block that never densifies
        return hash_counts_csr(table[spec["col"]], spec["size"],
                               binary=False)
    out = np.empty((len(table), _spec_width(spec, table)), np.float32)
    _fill_part(spec, table, out)
    return out


def _build_parts_rowloop(specs, table: DataTable) -> List[Any]:
    """The pre-vectorization per-row loops, verbatim — the bit-parity
    ORACLE for the columnar kernels (pinned by tests) and the baseline
    ``profile_automl.py`` measures the columnar path against. Not on
    any hot path."""
    parts: List[Any] = []
    n = len(table)
    for spec in specs or []:
        c = spec["col"]
        kind = spec["kind"]
        if kind == "numeric":
            col = np.asarray(table[c], dtype=np.float32)
            col = np.where(np.isfinite(col), col, np.float32(spec["fill"]))
            parts.append(col[:, None])
        elif kind == "onehot":
            col = np.asarray(table[c], dtype=np.int64)
            size = spec["size"]
            oh = np.zeros((n, size), dtype=np.float32)
            ok = (col >= 0) & (col < size)
            oh[np.arange(n)[ok], col[ok]] = 1.0
            parts.append(oh)
        elif kind == "string_index":
            index = {v: i for i, v in enumerate(spec["levels"])}
            col = np.asarray([index.get(v, -1) for v in table[c]],
                             dtype=np.float32)
            parts.append(col[:, None])
        elif kind == "string_onehot":
            index = {v: i for i, v in enumerate(spec["levels"])}
            size = len(spec["levels"])
            oh = np.zeros((n, size), dtype=np.float32)
            for i, v in enumerate(table[c]):
                j = index.get(v)
                if j is not None:
                    oh[i, j] = 1.0
            parts.append(oh)
        elif kind == "hash":
            m = spec["size"]
            if spec.get("sparse"):
                parts.append(CSRMatrix.from_rows(
                    (_hash_counts(toks, m, False)
                     for toks in table[c]), num_cols=m))
                continue
            mat = np.zeros((n, m), dtype=np.float32)
            for i, toks in enumerate(table[c]):
                for t in toks or []:
                    mat[i, _stable_hash(str(t)) % m] += 1.0
            parts.append(mat)
        elif kind == "vector":
            col = table[c]
            if isinstance(col, np.ndarray) and col.ndim == 2:
                parts.append(np.asarray(col, dtype=np.float32))
            else:
                parts.append(np.stack(
                    [np.asarray(v, dtype=np.float32) for v in col]))
    return parts


def _assemble(parts: List[Any], output_col: str, table: DataTable
              ) -> DataTable:
    if not parts:
        raise ValueError("no featurizable columns found")
    from mmlspark_tpu_torch.core.sparse import hstack
    if any(isinstance(p, CSRMatrix) for p in parts):
        feats: Any = hstack(parts)
        field = Field(output_col, VECTOR, {"sparse": True})
    else:
        feats = np.concatenate(parts, axis=1)
        field = Field(output_col, VECTOR)
    return table.with_column(output_col, feats, field)


class FeaturizeModel(Model):
    specs = ListParam("per-column featurization specs", default=None)
    outputCol = ColParam("assembled features column", default="features")

    def transform(self, table: DataTable) -> DataTable:
        # all parts float32: device stages consume f32/bf16 anyway, and a
        # single float64 part would upcast the whole concatenate (doubling
        # the wide hashed block's footprint)
        refuse_chunked(table, "FeaturizeModel.transform")
        t0 = time.perf_counter()
        specs = self.get("specs") or []
        if any(s["kind"] == "hash" and s.get("sparse") for s in specs):
            parts = [_build_part(spec, table) for spec in specs]
            out = _assemble(parts, self.get("outputCol"), table)
        else:
            # all-dense: preallocate the final (N, D) matrix once and
            # let every kernel write its column slice in place — no
            # per-part temporaries, no concatenate copy. WIDE blocks
            # fill first (their bulk writes absorb the first-touch page
            # faults at sequential speed); consecutive NARROW specs
            # batch through one compact temp so the matrix sees one
            # strided pass instead of a cache-hostile 4-bytes-per-row
            # pass per column.
            if not specs:
                raise ValueError("no featurizable columns found")
            widths = [_spec_width(s, table) for s in specs]
            offs = np.concatenate([[0], np.cumsum(widths)])
            feats = np.empty((len(table), int(offs[-1])), np.float32)
            narrow = 8
            for i, spec in enumerate(specs):
                if widths[i] > narrow:
                    _fill_part(spec, table,
                               feats[:, offs[i]:offs[i + 1]])
            i = 0
            while i < len(specs):
                if widths[i] > narrow:
                    i += 1
                    continue
                j = i
                while j < len(specs) and widths[j] <= narrow:
                    j += 1
                tmp = np.empty((len(table), int(offs[j] - offs[i])),
                               np.float32)
                for k in range(i, j):
                    a = int(offs[k] - offs[i])
                    _fill_part(specs[k], table,
                               tmp[:, a:a + widths[k]])
                feats[:, offs[i]:offs[j]] = tmp
                i = j
            out_col = self.get("outputCol")
            out = table.with_column(out_col, feats,
                                    Field(out_col, VECTOR))
        MC.automl_histograms()["featurize_transform"].observe(
            (time.perf_counter() - t0) * 1e3)
        return out

    def transform_rowloop(self, table: DataTable) -> DataTable:
        """Transform via the retained per-row reference loops — the
        parity/bench baseline; see ``_build_parts_rowloop``."""
        parts = _build_parts_rowloop(self.get("specs"), table)
        return _assemble(parts, self.get("outputCol"), table)

    def transform_schema(self, schema: Schema) -> Schema:
        sparse = any(s.get("sparse") and s.get("kind") == "hash"
                     for s in (self.get("specs") or []))
        meta = {"sparse": True} if sparse else {}
        return schema.add_or_replace(
            Field(self.get("outputCol"), VECTOR, meta))


class AssembleFeatures(Estimator):
    """Column assembler sharing FeaturizeModel's machinery
    (ref: AssembleFeatures.scala:92 — the lower-level stage Featurize
    drives; exposed for parity)."""

    columnsToFeaturize = ListParam("columns to assemble", default=None)
    featuresCol = ColParam("output features column", default="features")
    oneHotEncodeCategoricals = BoolParam("one-hot categoricals",
                                         default=False)
    numberOfFeatures = IntParam("hash width for token columns",
                                default=1 << 12)  # see Featurize note

    def fit(self, table: DataTable) -> FeaturizeModel:
        feat = Featurize(
            featureColumns=self.get_or_none("columnsToFeaturize"),
            outputCol=self.get("featuresCol"),
            oneHotEncodeCategoricals=self.get("oneHotEncodeCategoricals"),
            numberOfFeatures=self.get("numberOfFeatures"))
        return feat.fit(table)
