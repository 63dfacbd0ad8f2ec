"""CSR sparse matrices: the sparse feature path of the PyTorch port.

The port's own copy of ``mmlspark_tpu/core/sparse.py``, the same class
with the same arrays (``data`` float32, ``indices`` int32, ``indptr``
int64), so a DataTable column of either package saves and loads in the
other's format. A row-major CSR container that never materializes the
(N, D) dense matrix:

- GBDT binning reads per-column nonzeros through a one-shot CSC view
  (:meth:`csc`); bins come out dense int (the engine's device layout)
  without a dense FLOAT matrix ever existing.
- :meth:`padded_batch` gives fixed-shape (B, max_nnz) index / value
  blocks for gather-accumulate products.

Plain numpy arrays; ``from_scipy`` / ``to_scipy`` when scipy is present.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class CSRMatrix:
    """Compressed sparse rows: ``data``/``indices`` per nonzero,
    ``indptr`` (N+1) row offsets, ``shape`` (N, D)."""

    def __init__(self, data: np.ndarray, indices: np.ndarray,
                 indptr: np.ndarray, shape: Tuple[int, int]):
        self.data = np.asarray(data, dtype=np.float32)
        self.indices = np.asarray(indices, dtype=np.int32)
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.shape = (int(shape[0]), int(shape[1]))
        if len(self.indptr) != self.shape[0] + 1:
            raise ValueError(
                f"indptr length {len(self.indptr)} != rows+1 "
                f"({self.shape[0] + 1})")
        if len(self.data) != len(self.indices):
            raise ValueError("data and indices length mismatch")

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_rows(rows: Iterable[Dict[int, float]],
                  num_cols: int) -> "CSRMatrix":
        """Build from an iterable of {col: value} dicts."""
        indptr = [0]
        idx: List[int] = []
        val: List[float] = []
        for r in rows:
            for c in sorted(r):
                idx.append(c)
                val.append(r[c])
            indptr.append(len(idx))
        return CSRMatrix(np.asarray(val, np.float32),
                         np.asarray(idx, np.int32),
                         np.asarray(indptr, np.int64),
                         (len(indptr) - 1, num_cols))

    @staticmethod
    def from_dense(x: np.ndarray) -> "CSRMatrix":
        x = np.asarray(x)
        n, d = x.shape
        mask = x != 0
        counts = mask.sum(axis=1)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        rows, cols = np.nonzero(mask)
        return CSRMatrix(x[rows, cols].astype(np.float32),
                         cols.astype(np.int32), indptr, (n, d))

    @staticmethod
    def from_scipy(m) -> "CSRMatrix":
        m = m.tocsr()
        return CSRMatrix(m.data, m.indices, m.indptr, m.shape)

    # -- basics -------------------------------------------------------------

    @property
    def nnz(self) -> int:
        return int(len(self.data))

    def __len__(self) -> int:
        return self.shape[0]

    def __repr__(self) -> str:
        return (f"CSRMatrix(shape={self.shape}, nnz={self.nnz}, "
                f"density={self.nnz / max(1, self.shape[0] * self.shape[1]):.2e})")

    def __getitem__(self, key):
        """int -> dense 1-D row; slice/array -> row-sliced CSRMatrix."""
        if isinstance(key, (int, np.integer)):
            i = int(key)
            if i < 0:
                i += self.shape[0]
            out = np.zeros(self.shape[1], np.float32)
            lo, hi = self.indptr[i], self.indptr[i + 1]
            out[self.indices[lo:hi]] = self.data[lo:hi]
            return out
        if isinstance(key, slice):
            start, stop, step = key.indices(self.shape[0])
            if step != 1:
                key = np.arange(start, stop, step)
            else:
                return self._row_range(start, stop)
        return self.take(np.asarray(key))

    def _row_range(self, start: int, stop: int) -> "CSRMatrix":
        lo, hi = self.indptr[start], self.indptr[stop]
        return CSRMatrix(self.data[lo:hi], self.indices[lo:hi],
                         self.indptr[start:stop + 1] - lo,
                         (stop - start, self.shape[1]))

    def take(self, rows: np.ndarray) -> "CSRMatrix":
        """Arbitrary row selection (shuffles, CV folds, bagging).
        Fully vectorized — O(selected nnz) in C, no per-row Python."""
        rows = np.asarray(rows)
        if rows.dtype == bool:
            rows = np.flatnonzero(rows)
        counts = (self.indptr[rows + 1] - self.indptr[rows])
        indptr = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        nnz = int(indptr[-1])
        # gather index = row start repeated + within-row offset
        gather = (np.repeat(self.indptr[rows], counts)
                  + np.arange(nnz) - np.repeat(indptr[:-1], counts))
        return CSRMatrix(self.data[gather], self.indices[gather],
                         indptr, (len(rows), self.shape[1]))

    def toarray(self) -> np.ndarray:
        """Dense (N, D) — for small N/D only; the whole point of this
        class is that large pipelines never call this. Vectorized
        scatter (np.add.at sums duplicate coordinates like scipy)."""
        out = np.zeros(self.shape, np.float32)
        rows = np.repeat(np.arange(self.shape[0]),
                         np.diff(self.indptr).astype(np.int64))
        np.add.at(out, (rows, self.indices), self.data)
        return out

    def to_scipy(self):
        from scipy.sparse import csr_matrix
        return csr_matrix((self.data, self.indices, self.indptr),
                          shape=self.shape)

    # -- transforms ---------------------------------------------------------

    def csc(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One-shot CSC view: (col_indptr (D+1), row_indices, values) —
        counting sort over columns, O(nnz). Feeds per-feature binning."""
        d = self.shape[1]
        counts = np.bincount(self.indices, minlength=d)
        col_ptr = np.zeros(d + 1, np.int64)
        np.cumsum(counts, out=col_ptr[1:])
        # a stable sort by column; 16-bit keys (d <= 65536) let numpy
        # radix-sort them, the same order as the int32 keys' merge sort
        keys = self.indices.astype(np.uint16) if d <= 1 << 16 \
            else self.indices
        order = np.argsort(keys, kind="stable")
        row_of_nnz = np.repeat(
            np.arange(self.shape[0]),
            np.diff(self.indptr).astype(np.int64))
        return col_ptr, row_of_nnz[order].astype(np.int32), self.data[order]

    def hstack(self, others: Sequence[Any]) -> "CSRMatrix":
        """Column-concatenate with CSRMatrix / dense-2D blocks."""
        return hstack([self] + list(others))

    def padded_batch(self, start: int, stop: int, max_nnz: int,
                     allow_truncate: bool = False
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Rows [start, stop) as fixed-shape (B, max_nnz) ``indices`` /
        ``values`` with zero-padding (value 0 contributes nothing to a
        gather-accumulate) — the fixed-shape feed of a gather-accumulate
        product. Rows with more than ``max_nnz`` nonzeros raise
        unless ``allow_truncate`` (then the first ``max_nnz`` are kept —
        silent feature loss otherwise; callers pick max_nnz from
        :meth:`max_row_nnz`)."""
        b = stop - start
        idx = np.zeros((b, max_nnz), np.int32)
        val = np.zeros((b, max_nnz), np.float32)
        row_nnz = np.diff(self.indptr[start:stop + 1])
        if not allow_truncate and row_nnz.size and row_nnz.max() > max_nnz:
            raise ValueError(
                f"padded_batch(max_nnz={max_nnz}) would silently drop "
                f"{int(np.maximum(row_nnz - max_nnz, 0).sum())} nonzeros "
                f"(densest row has {int(row_nnz.max())}); raise max_nnz "
                f"(see max_row_nnz()) or pass allow_truncate=True")
        counts = np.minimum(row_nnz, max_nnz).astype(np.int64)
        nnz = int(counts.sum())
        within = (np.arange(nnz)
                  - np.repeat(np.cumsum(counts) - counts, counts))
        gather = np.repeat(self.indptr[start:stop], counts) + within
        out_pos = np.repeat(np.arange(b) * max_nnz, counts) + within
        idx.ravel()[out_pos] = self.indices[gather]
        val.ravel()[out_pos] = self.data[gather]
        return idx, val, counts.astype(np.int32)

    def max_row_nnz(self) -> int:
        if self.shape[0] == 0:
            return 0
        return int(np.max(np.diff(self.indptr)))


def vstack(blocks: Sequence["CSRMatrix"]) -> CSRMatrix:
    """Row-concatenate CSRMatrix blocks (table concat / shard merge)."""
    if not blocks:
        return CSRMatrix(np.zeros(0, np.float32), np.zeros(0, np.int32),
                         np.zeros(1, np.int64), (0, 0))
    d = blocks[0].shape[1]
    for b in blocks:
        if b.shape[1] != d:
            raise ValueError(
                f"vstack column mismatch: {b.shape[1]} vs {d}")
    data = np.concatenate([b.data for b in blocks])
    indices = np.concatenate([b.indices for b in blocks])
    ptrs = [blocks[0].indptr]
    off = blocks[0].indptr[-1]
    for b in blocks[1:]:
        ptrs.append(b.indptr[1:] + off)
        off += b.indptr[-1]
    return CSRMatrix(data, indices, np.concatenate(ptrs),
                     (sum(b.shape[0] for b in blocks), d))


def hstack(blocks: Sequence[Any]) -> CSRMatrix:
    """Column-concatenate CSRMatrix and dense (N, k) / (N,) blocks into
    one CSRMatrix — the sparse FastVectorAssembler
    (ref: src/core/spark/.../FastVectorAssembler.scala:23, kept sparse
    like the reference's assembled SparseVectors)."""
    mats: List[CSRMatrix] = []
    n: Optional[int] = None
    for b in blocks:
        if not isinstance(b, CSRMatrix):
            arr = np.asarray(b, np.float32)
            if arr.ndim == 1:
                arr = arr[:, None]
            b = CSRMatrix.from_dense(arr)
        if n is None:
            n = b.shape[0]
        elif b.shape[0] != n:
            raise ValueError(
                f"hstack row mismatch: {b.shape[0]} vs {n}")
        mats.append(b)
    assert n is not None
    offsets = np.cumsum([0] + [m.shape[1] for m in mats])
    total_cols = int(offsets[-1])
    # per-row interleave of every block's nonzeros
    counts = sum(np.diff(m.indptr).astype(np.int64) for m in mats)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    data = np.empty(nnz, np.float32)
    indices = np.empty(nnz, np.int32)
    cursor = indptr[:-1].copy()
    for off, m in zip(offsets, mats):
        lens = np.diff(m.indptr).astype(np.int64)
        # target positions: this block's per-row cursor + offset within
        # the row's span (vectorized; no per-row Python)
        tgt = (np.repeat(cursor, lens) + np.arange(m.nnz)
               - np.repeat(m.indptr[:-1].astype(np.int64), lens))
        data[tgt] = m.data
        indices[tgt] = m.indices + np.int32(off)
        cursor += lens
    return CSRMatrix(data, indices, indptr, (n, total_cols))
