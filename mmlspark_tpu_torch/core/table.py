"""DataTable — the columnar table every stage consumes and produces.

The port's own copy of ``mmlspark_tpu/core/table.py``: an immutable,
host-resident, columnar batch of rows. Scalar columns are numpy arrays;
vector columns are 2-D numpy arrays (or lists of 1-D arrays when ragged);
complex values are struct columns (lists of dicts) described by
``Schema`` fields. Stages move the columns they compute on to a torch
device themselves.

A vector column may be sparse: a ``core.sparse.CSRMatrix`` is kept as
it is (schema meta ``{"sparse": True}``), sliced, taken and concatenated
without densifying, and saved in the JAX package's on-disk format, so
either package loads the other's sparse tables.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Union

import numpy as np

from mmlspark_tpu_torch.core import schema as S
from mmlspark_tpu_torch.core.schema import Field, Schema
from mmlspark_tpu_torch.core.serialize import portable_dumps, restricted_loads
from mmlspark_tpu_torch.core.sparse import CSRMatrix, vstack

ColumnData = Union[np.ndarray, List[Any]]


def _is_sequence(x) -> bool:
    return isinstance(x, (list, tuple, np.ndarray))


def _infer_field(name: str, data: ColumnData) -> Field:
    """Infer a Field from column data."""
    if isinstance(data, CSRMatrix):
        # sparse vector column (the SparseVector analog): stays sparse
        return Field(name, S.VECTOR, {"sparse": True})
    if isinstance(data, np.ndarray):
        if data.ndim == 1:
            return Field(name, S.tag_for_numpy(data.dtype))
        if data.ndim == 2:
            return Field(name, S.VECTOR)
        return Field(name, S.TENSOR)
    # list column: inspect the first non-None element
    first = next((x for x in data if x is not None), None)
    if first is None:
        return Field(name, S.OBJECT)
    if isinstance(first, bool):
        return Field(name, S.BOOL)
    if isinstance(first, (int, np.integer)):
        return Field(name, S.I64)
    if isinstance(first, (float, np.floating)):
        return Field(name, S.F64)
    if isinstance(first, str):
        return Field(name, S.STRING)
    if isinstance(first, (bytes, bytearray)):
        return Field(name, S.BYTES)
    if isinstance(first, dict):
        kind = None
        if set(first) >= {"height", "width", "data"}:
            kind = "image"
        elif set(first) == {"path", "bytes"}:
            kind = "binary_file"
        meta = {"struct_kind": kind} if kind else {}
        fields = [_infer_field(k, [first[k]]) for k in first]
        return Field(name, S.STRUCT, meta, fields)
    if isinstance(first, np.ndarray):
        if first.ndim == 1:
            return Field(name, S.VECTOR)
        return Field(name, S.TENSOR)
    if _is_sequence(first):
        return Field(name, S.LIST)
    return Field(name, S.OBJECT)


def _normalize_column(data: Any, n_rows: Optional[int]) -> ColumnData:
    """Coerce input to a canonical column representation."""
    if isinstance(data, CSRMatrix):
        return data   # first-class sparse column, never densified
    if isinstance(data, np.ndarray):
        return data
    if isinstance(data, (list, tuple)):
        data = list(data)
        if not data:
            return np.asarray(data)
        first = next((x for x in data if x is not None), None)
        if isinstance(first, (bool, np.bool_)) and all(
                isinstance(x, (bool, np.bool_)) for x in data):
            return np.asarray(data, dtype=bool)
        if isinstance(first, (int, np.integer)) and all(
                isinstance(x, (int, np.integer)) and not isinstance(x, bool)
                for x in data):
            return np.asarray(data, dtype=np.int64)
        if isinstance(first, (float, np.floating)) and all(
                isinstance(x, (int, float, np.integer, np.floating))
                and not isinstance(x, bool) for x in data):
            return np.asarray(data, dtype=np.float64)
        if isinstance(first, np.ndarray) and first.ndim == 1:
            # vector column: densify if rectangular
            if all(isinstance(x, np.ndarray) and x.shape == first.shape
                   for x in data):
                return np.stack([np.asarray(x) for x in data])
            return [np.asarray(x) for x in data]
        return data
    # scalar broadcast
    if n_rows is None:
        raise ValueError("cannot broadcast scalar column without row count")
    if isinstance(data, str):
        return [data] * n_rows
    return np.full(n_rows, data)


def features_matrix(table: "DataTable", col: str) -> np.ndarray:
    """Vector column -> dense (N, F) float64 matrix (the shared coercion
    every model stage uses to feed features to the device). Sparse
    columns densify here and only here, as in the JAX package; the GBDT
    stages read the ``CSRMatrix`` through ``table.column`` instead."""
    c = table.column(col)
    if isinstance(c, CSRMatrix):
        return c.toarray().astype(np.float64)
    if isinstance(c, np.ndarray) and c.ndim == 2:
        return np.asarray(c, dtype=np.float64)
    return np.stack([np.asarray(v, dtype=np.float64) for v in c])


class DataTable:
    """Immutable columnar table."""

    def __init__(self, columns: Mapping[str, Any],
                 schema: Optional[Schema] = None,
                 num_shards: int = 1):
        n_rows: Optional[int] = None
        norm: Dict[str, ColumnData] = {}
        for name, data in columns.items():
            col = _normalize_column(data, n_rows)
            norm[name] = col
            m = len(col)
            if n_rows is None:
                n_rows = m
            elif m != n_rows:
                raise ValueError(
                    f"column {name!r} has {m} rows; expected {n_rows}")
        self._columns = norm
        self._n_rows = n_rows or 0
        self.num_shards = max(1, int(num_shards))
        if schema is None:
            schema = Schema([_infer_field(n, c) for n, c in norm.items()])
        else:
            if list(schema.names) != list(norm.keys()):
                raise ValueError(
                    f"schema names {schema.names} != columns {list(norm)}")
        self._schema = schema

    # -- construction -----------------------------------------------------

    @staticmethod
    def from_rows(rows: Sequence[Mapping[str, Any]],
                  schema: Optional[Schema] = None) -> "DataTable":
        if not rows:
            names = schema.names if schema else []
            return DataTable({n: [] for n in names}, schema)
        if schema is not None:
            names = schema.names
        else:
            # union of keys across all rows, in first-seen order
            seen: Dict[str, None] = {}
            for r in rows:
                for k in r:
                    seen.setdefault(k, None)
            names = list(seen)
        cols = {n: [r.get(n) for r in rows] for n in names}
        return DataTable(cols, schema)

    @staticmethod
    def concat(tables: Sequence["DataTable"]) -> "DataTable":
        tables = [t for t in tables if t is not None]
        if not tables:
            return DataTable({})
        base = tables[0]
        if len(tables) == 1:
            return base
        for i, t in enumerate(tables[1:], start=1):
            if t.column_names != base.column_names:
                raise ValueError(
                    f"concat: table {i} columns {t.column_names} != "
                    f"table 0 columns {base.column_names}")
        cols: Dict[str, ColumnData] = {}
        for name in base.column_names:
            parts = [t._columns[name] for t in tables]
            if any(isinstance(p, CSRMatrix) for p in parts):
                # mixed sparse / dense parts: dense blocks become CSR so
                # the result stays sparse (and keeps the schema's flag)
                cols[name] = vstack([
                    p if isinstance(p, CSRMatrix)
                    else CSRMatrix.from_dense(np.asarray(p, np.float32))
                    for p in parts])
                continue
            if all(isinstance(p, np.ndarray) for p in parts):
                try:
                    cols[name] = np.concatenate(parts, axis=0)
                    continue
                except ValueError:
                    pass
            merged: List[Any] = []
            for p in parts:
                merged.extend(list(p))
            cols[name] = merged
        return DataTable(cols, base.schema, num_shards=base.num_shards)

    # -- basic accessors --------------------------------------------------

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def column_names(self) -> List[str]:
        return list(self._columns.keys())

    def __len__(self) -> int:
        return self._n_rows

    @property
    def num_rows(self) -> int:
        return self._n_rows

    def column(self, name: str) -> ColumnData:
        if name not in self._columns:
            raise KeyError(
                f"column {name!r} not found; have {self.column_names}")
        return self._columns[name]

    def __getitem__(self, name: str) -> ColumnData:
        return self.column(name)

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def field(self, name: str) -> Field:
        return self._schema[name]

    def row(self, i: int) -> Dict[str, Any]:
        return {n: c[i] for n, c in self._columns.items()}

    def rows(self) -> Iterator[Dict[str, Any]]:
        for i in range(self._n_rows):
            yield self.row(i)

    def to_rows(self) -> List[Dict[str, Any]]:
        return list(self.rows())

    # -- transformations --------------------------------------------------

    def with_column(self, name: str, data: Any,
                    field: Optional[Field] = None) -> "DataTable":
        col = _normalize_column(data, self._n_rows)
        cols = dict(self._columns)
        existed = name in cols
        cols[name] = col
        if field is None:
            field = _infer_field(name, col)
        elif field.name != name:
            field = Field(name, field.tag, field.meta, field.fields)
        schema = (self._schema.replace(field) if existed
                  else self._schema.add(field))
        return DataTable(cols, schema, num_shards=self.num_shards)

    def with_field_meta(self, name: str, **meta) -> "DataTable":
        f = self._schema[name].with_meta(**meta)
        return DataTable(self._columns, self._schema.replace(f),
                         num_shards=self.num_shards)

    def with_field(self, field: Field) -> "DataTable":
        """Replace the schema Field for an existing column (data unchanged)."""
        return DataTable(self._columns, self._schema.replace(field),
                         num_shards=self.num_shards)

    def drop(self, *names: str) -> "DataTable":
        drop = set(names)
        cols = {n: c for n, c in self._columns.items() if n not in drop}
        return DataTable(cols, self._schema.drop(*names),
                         num_shards=self.num_shards)

    def select(self, *names: str) -> "DataTable":
        cols = {n: self.column(n) for n in names}
        return DataTable(cols, self._schema.select(*names),
                         num_shards=self.num_shards)

    def rename(self, mapping: Dict[str, str]) -> "DataTable":
        cols = {mapping.get(n, n): c for n, c in self._columns.items()}
        return DataTable(cols, self._schema.rename(mapping),
                         num_shards=self.num_shards)

    def _take_indices(self, idx) -> "DataTable":
        cols: Dict[str, ColumnData] = {}
        for n, c in self._columns.items():
            if isinstance(c, CSRMatrix):
                cols[n] = c.take(np.asarray(idx))
            elif isinstance(c, np.ndarray):
                cols[n] = c[idx]
            else:
                cols[n] = [c[i] for i in idx]
        return DataTable(cols, self._schema, num_shards=self.num_shards)

    def filter(self, mask: Union[np.ndarray, Callable[[Dict[str, Any]], bool]]
               ) -> "DataTable":
        if callable(mask):
            mask = np.asarray([bool(mask(r)) for r in self.rows()])
        mask = np.asarray(mask, dtype=bool)
        return self._take_indices(np.nonzero(mask)[0])

    def take(self, n: int) -> "DataTable":
        return self._take_indices(np.arange(min(n, self._n_rows)))

    def head(self, n: int = 5) -> List[Dict[str, Any]]:
        return self.take(n).to_rows()

    def slice(self, start: int, stop: int) -> "DataTable":
        start, stop, _ = slice(start, stop).indices(self._n_rows)
        return self._take_indices(np.arange(start, stop))

    def shuffle(self, seed: int = 0) -> "DataTable":
        """Rows in the order of ``default_rng(seed).permutation``: the
        JAX package's draw, so seeded CV folds hold the same rows."""
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self._n_rows)
        return self._take_indices(idx)

    def sample(self, fraction: float, seed: int = 0) -> "DataTable":
        rng = np.random.default_rng(seed)
        mask = rng.random(self._n_rows) < fraction
        return self.filter(mask)

    def sort_by(self, name: str, ascending: bool = True) -> "DataTable":
        col = self._columns[name]
        if not isinstance(col, np.ndarray):
            order = np.asarray(sorted(range(len(col)), key=lambda i: col[i]))
        else:
            order = np.argsort(col, kind="stable")
        if not ascending:
            order = order[::-1]
        return self._take_indices(order)

    def map_rows(self, fn: Callable[[Dict[str, Any]], Dict[str, Any]],
                 schema: Optional[Schema] = None) -> "DataTable":
        return DataTable.from_rows([fn(r) for r in self.rows()], schema)

    def append_rows(self, rows: Sequence[Mapping[str, Any]]) -> "DataTable":
        return DataTable.concat([self, DataTable.from_rows(rows, self._schema)])

    # -- partitioning ------------------------------------------------------

    def repartition(self, n: int) -> "DataTable":
        """Set the logical shard count (the Repartition stage's
        analog of ``df.repartition``)."""
        return DataTable(self._columns, self._schema, num_shards=n)

    def shards(self, n: Optional[int] = None) -> List["DataTable"]:
        """Split row-wise into n roughly-equal shards."""
        n = n or self.num_shards
        if n <= 1:
            return [self]
        bounds = np.linspace(0, self._n_rows, n + 1).astype(int)
        return [self.slice(int(a), int(b))
                for a, b in zip(bounds[:-1], bounds[1:])]

    def batches(self, batch_size: int) -> Iterator["DataTable"]:
        for start in range(0, self._n_rows, batch_size):
            yield self.slice(start, start + batch_size)

    # -- misc --------------------------------------------------------------

    def cache(self) -> "DataTable":
        """No-op: DataTables are host-resident eagerly. Kept for the
        Cacher / CheckpointData stages."""
        return self

    def distinct_values(self, name: str) -> List[Any]:
        col = self._columns[name]
        if isinstance(col, np.ndarray) and col.ndim == 1:
            return list(np.unique(col))
        seen: Dict[Any, None] = {}
        for v in col:
            seen.setdefault(v, None)
        return list(seen.keys())

    def __repr__(self):
        return (f"DataTable[{self._n_rows} rows x {len(self._columns)} cols: "
                f"{', '.join(f'{f.name}:{f.tag}' for f in self._schema)}]")

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        """Save to a directory (npz for array columns, pickle for the
        rest), in the JAX package's layout: either package loads it. A
        sparse column is pickled under the JAX package's class name
        (``serialize.portable_dumps``), as that package writes it."""
        os.makedirs(path, exist_ok=True)
        arrays = {}
        objects = {}
        for n, c in self._columns.items():
            if isinstance(c, np.ndarray) and c.dtype != object:
                arrays[n] = c
            elif isinstance(c, CSRMatrix):
                objects[n] = c   # list(c) would densify it
            else:
                objects[n] = list(c)
        np.savez(os.path.join(path, "columns.npz"), **arrays)
        with open(os.path.join(path, "objects.pkl"), "wb") as f:
            f.write(portable_dumps(objects))
        with open(os.path.join(path, "schema.json"), "w") as f:
            json.dump({"schema": self._schema.to_json(),
                       "order": self.column_names,
                       "num_shards": self.num_shards}, f)

    @staticmethod
    def load(path: str) -> "DataTable":
        """Load a saved table; its object columns unpickle through
        ``serialize.restricted_loads`` (no JAX-package classes; a JAX
        package ``CSRMatrix`` loads as the port's)."""
        with open(os.path.join(path, "schema.json")) as f:
            meta = json.load(f)
        npz = np.load(os.path.join(path, "columns.npz"), allow_pickle=False)
        with open(os.path.join(path, "objects.pkl"), "rb") as f:
            objects = restricted_loads(f.read())
        cols: Dict[str, ColumnData] = {}
        for n in meta["order"]:
            cols[n] = npz[n] if n in npz.files else objects[n]
        return DataTable(cols, Schema.from_json(meta["schema"]),
                         num_shards=meta.get("num_shards", 1))
