"""Quantile feature binning.

Port of ``mmlspark_tpu/gbdt/binning.py``: continuous features are
discretized into at most ``max_bin`` equal-frequency bins (LightGBM's
BinMapper discipline); the binned matrix is what the histogram kernel
consumes on the device.

Boundary FITTING is host numpy, one sort-based pass over a bounded
sample — the same arithmetic as the JAX package, so bins are bit-equal.
APPLYING the bins has two paths:

- device (``bucketize_fm_device``): raw float32 features on the device,
  one batched ``torch.searchsorted`` against the padded ``(F, B)``
  bounds matrix. Eligible when the cuts were snapped to float32
  (``f32_cuts_exact``), where the f32 compare equals the f64 one for
  every row by construction.
- host (``transform*``): on the card's fits (``native=True``) the
  port's OpenMP library (``native_bins``, built from ``csrc/bins.cpp``),
  which raises rather than fall back; otherwise the vectorized numpy
  path (``_numpy_bin_block``, the library's plain version), fanned over
  feature blocks on a thread pool (numpy's searchsorted releases the
  GIL). CSR input bins from its nonzeros alone (``transform_sparse``).

Fits: ``fit`` (dense, a bounded row sample), ``fit_sparse`` (CSR, the
implicit zeros counted analytically) and ``fit_streaming`` (one pass of
mergeable quantile sketches over a chunk stream, ``gbdt/sketch.py``).
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
from typing import List, Optional

import numpy as np
import torch

# host binning parallelism: engage the pool only when the block is big
# enough that thread handoff is noise (cells = rows * features)
_POOL_MIN_CELLS = 2_000_000
_pool_lock = threading.Lock()
_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None


def _bin_pool() -> concurrent.futures.ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=max(1, min(8, os.cpu_count() or 1)),
                thread_name_prefix="mml-bin")
        return _pool


def _reset_pool_after_fork() -> None:
    """A forked child inherits the executor object but not its worker
    threads; drop the reference so the child builds a fresh pool."""
    global _pool
    _pool = None


if hasattr(os, "register_at_fork"):   # POSIX only
    os.register_at_fork(after_in_child=_reset_pool_after_fork)


def _chunk_matrix(chunk) -> np.ndarray:
    """Coerce one stream element to a raw (N, F) feature block: ndarray
    passes through, ``(X, y[, w])`` shard tuples take X, and DataTables
    densify their features column through ``features_matrix`` (one chunk
    at a time, never the whole table)."""
    if isinstance(chunk, np.ndarray):
        X = chunk
    elif isinstance(chunk, (tuple, list)):
        X = np.asarray(chunk[0])
    else:
        from mmlspark_tpu_torch.core.table import DataTable, features_matrix
        if isinstance(chunk, DataTable):
            X = features_matrix(chunk, "features")
        else:
            X = np.asarray(chunk)
    if X.ndim != 2:
        raise ValueError(f"chunk must be 2-D (N, F); got shape {X.shape}")
    return X


def _fanout_feature_blocks(run, j0: int, j1: int, n_rows: int) -> None:
    """Fan ``run(a, b)`` (features [a, b), disjoint writes) over the
    shared thread pool; serial when the block is small."""
    span = j1 - j0
    workers = (min(os.cpu_count() or 1, 8, span)
               if n_rows * span >= _POOL_MIN_CELLS else 1)
    workers = max(1, min(workers, span))
    if workers > 1:
        step = -(-span // workers)
        futs = [_bin_pool().submit(run, a, min(a + step, j1))
                for a in range(j0, j1, step)]
        for fut in futs:
            fut.result()   # propagate the first worker exception
    else:
        run(j0, j1)


class BinMapper:
    """Per-feature quantile bin boundaries.

    ``upper_bounds[f]`` holds ascending split values; value ``v`` maps to
    bin ``searchsorted(upper_bounds[f], v, side='left')``. NaNs map to bin
    0 (treated as smallest).
    """

    def __init__(self, upper_bounds: List[np.ndarray], max_bin: int,
                 f32_values_safe: bool = False,
                 f32_cuts_exact: bool = False):
        self.upper_bounds = [np.asarray(u, dtype=np.float64)
                             for u in upper_bounds]
        self.max_bin = int(max_bin)
        # computed at fit time from TRUE data gaps (see _feature_bounds)
        self.f32_values_safe = bool(f32_values_safe)
        # True only when cuts were SNAPPED to f32-representable values
        # for f32 input (_snap_cuts_f32): the device-binning gate
        self.f32_cuts_exact = bool(f32_cuts_exact)
        # measured rank-error certificate of a sketch fit (fit_streaming);
        # 0.0 = exact fit
        self.sketch_eps = 0.0

    @property
    def num_features(self) -> int:
        return len(self.upper_bounds)

    @property
    def num_bins(self) -> np.ndarray:
        """Actual bin count per feature (<= max_bin)."""
        return np.asarray([len(u) + 1 for u in self.upper_bounds])

    @staticmethod
    def fit(X: np.ndarray, max_bin: int = 255,
            sample_cnt: int = 200_000, seed: int = 2) -> "BinMapper":
        # sample BEFORE the f64 conversion (exact per value)
        X_full = np.asarray(X)
        n, f = X_full.shape
        # float32 input: cuts snap DOWN to float32 (see _snap_cuts_f32),
        # so f32 binning is bit-exact by construction
        f32_exact = X_full.dtype == np.float32
        sampled_idx = None
        if n > sample_cnt:
            rng = np.random.default_rng(seed)
            sampled_idx = rng.choice(n, size=sample_cnt, replace=False)
            X = np.asarray(X_full[sampled_idx], dtype=np.float64)
        else:
            X = np.asarray(X_full, dtype=np.float64)
        results = [_feature_bounds(X[:, j], max_bin, f32_exact)
                   for j in range(f)]
        bounds = [b for b, _ in results]
        safe = all(ok for _, ok in results)
        if safe and not f32_exact and sampled_idx is not None:
            # the gap-based safety is certified on the SAMPLE only:
            # spot-check a holdout of unsampled rows in f32 vs f64
            rest = _holdout_rows(n, sampled_idx, rng)
            hold = X_full[rest]
            safe = _holdout_f32_agrees(
                bounds, ((j, hold[:, j]) for j in range(f)))
        return BinMapper(bounds, max_bin, f32_values_safe=safe,
                         f32_cuts_exact=f32_exact)

    @staticmethod
    def fit_streaming(chunks, max_bin: int = 255,
                      b: int = 512) -> "BinMapper":
        """Fit bin boundaries in one bounded-memory pass over a chunk
        stream (the out-of-core analog of ``fit``, which must see the
        whole (N, F) matrix). ``chunks`` yields (N, F) arrays, ``(X,
        y[, w])`` shard tuples or DataTables (``_chunk_matrix``). Each
        feature feeds a mergeable ``QuantileSketch``; the cuts are
        bitwise ``fit``'s on the same rows while no sketch has compacted,
        and otherwise within 2 x ``sketch_eps`` (the measured rank-error
        certificate, kept on the mapper) of their equal-frequency
        targets. An all-float32 stream gets f32-snapped cuts, so the
        device binning stays eligible; any float64 chunk keeps f64
        cuts."""
        from mmlspark_tpu_torch.gbdt.sketch import QuantileSketch
        f32_exact = True
        sketches: List[QuantileSketch] = []
        seen = False
        for chunk in chunks:
            X = _chunk_matrix(chunk)
            if not sketches:
                sketches = [QuantileSketch(b=b) for _ in range(X.shape[1])]
            elif X.shape[1] != len(sketches):
                raise ValueError(f"chunk has {X.shape[1]} features; "
                                 f"expected {len(sketches)}")
            seen = True
            f32_exact = f32_exact and X.dtype == np.float32
            for j, sk in enumerate(sketches):
                sk.update(X[:, j])
        if not seen:
            raise ValueError("empty chunk stream")
        bounds: List[np.ndarray] = []
        for sk in sketches:
            cut = sk.cuts(max_bin)
            bounds.append(_snap_cuts_f32(cut)
                          if f32_exact and len(cut) else cut)
        mapper = BinMapper(bounds, max_bin, f32_values_safe=f32_exact,
                           f32_cuts_exact=f32_exact)
        mapper.sketch_eps = max((sk.eps() for sk in sketches), default=0.0)
        return mapper

    @staticmethod
    def fit_sparse(csr, max_bin: int = 255, sample_cnt: int = 200_000,
                   seed: int = 2) -> "BinMapper":
        """Fit boundaries straight from a ``CSRMatrix``: each feature's
        nonzeros come from a one-shot CSC view and its implicit zeros
        join the value counts analytically, so no dense float matrix
        exists (the ``LGBM_DatasetCreateFromCSR`` analog). The same
        row sample and f32 discipline as ``fit``: float32 nonzeros get
        f32-snapped cuts; otherwise the gap check runs on the sample and
        a holdout of unsampled rows is spot-checked."""
        full = csr
        f32_exact = np.asarray(csr.data).dtype == np.float32
        n_full = csr.shape[0]
        n = n_full
        sampled_idx = None
        if n > sample_cnt:
            rng = np.random.default_rng(seed)
            sampled_idx = rng.choice(n, size=sample_cnt, replace=False)
            csr = csr.take(sampled_idx)
            n = sample_cnt
        col_ptr, _, vals = csr.csc()
        bounds: List[np.ndarray] = []
        safe = True
        for j in range(csr.shape[1]):
            v = vals[col_ptr[j]:col_ptr[j + 1]]
            v = v[np.isfinite(v)]
            distinct, counts = np.unique(v, return_counts=True)
            counts = counts.astype(np.int64)
            zeros = n - (int(col_ptr[j + 1]) - int(col_ptr[j]))
            if zeros > 0:
                pos = int(np.searchsorted(distinct, 0.0))
                if pos < len(distinct) and distinct[pos] == 0.0:
                    counts[pos] += zeros
                else:
                    distinct = np.insert(distinct, pos, 0.0)
                    counts = np.insert(counts, pos, zeros)
            b, ok = _bounds_from_counts(np.asarray(distinct, np.float64),
                                        counts, max_bin, f32_exact)
            bounds.append(b)
            safe = safe and ok
        if safe and not f32_exact and sampled_idx is not None:
            rest = _holdout_rows(n_full, sampled_idx, rng)
            hold_ptr, _, hold_vals = full.take(rest).csc()
            safe = _holdout_f32_agrees(
                bounds, ((j, hold_vals[hold_ptr[j]:hold_ptr[j + 1]])
                         for j in range(csr.shape[1])))
        return BinMapper(bounds, max_bin, f32_values_safe=safe,
                         f32_cuts_exact=f32_exact)

    def transform_sparse(self, csr, dtype=np.int32) -> np.ndarray:
        """``CSRMatrix`` -> FEATURES-MAJOR (F, N) bins without a dense
        float matrix: every row starts in its feature's zero bin, then
        only the nonzeros are binned by searchsorted. Feature blocks fan
        out over the shared thread pool (disjoint ``out`` rows).
        ``dtype``: int32 as in the JAX package, or ``np.uint8`` when
        every feature has at most 256 bins (the layout shipped to the
        card, a quarter of the bytes; the values are the same)."""
        n, f = csr.shape
        if np.dtype(dtype) == np.uint8 and int(self.num_bins.max(
                initial=1)) > 256:
            raise ValueError("uint8 bins need every feature to have at "
                             "most 256 bins")
        out = np.empty((f, n), dtype)
        col_ptr, rows, vals = csr.csc()

        def run(a: int, b_: int) -> None:
            for j in range(a, b_):
                ub = self.upper_bounds[j]
                out[j, :] = np.searchsorted(ub, 0.0, side="left")
                lo, hi = int(col_ptr[j]), int(col_ptr[j + 1])
                if hi > lo:
                    b = np.searchsorted(ub, vals[lo:hi], side="left"
                                        ).astype(np.int32)
                    b[np.isnan(vals[lo:hi])] = 0
                    out[j, rows[lo:hi]] = b

        _fanout_feature_blocks(run, 0, f, n)
        return out

    def _numpy_bin_block(self, X: np.ndarray, j0: int, j1: int,
                         out: Optional[np.ndarray] = None) -> np.ndarray:
        """Features [j0, j1) -> features-major (j1-j0, N) int32, each
        column widened to f64 before the boundary compare. ``out``: an
        optional (j1-j0, N) int target written in place (a transposed
        view lets transform() fill its row-major output directly)."""
        n = X.shape[0]
        if out is None:
            out = np.empty((j1 - j0, n), np.int32)

        def run(a: int, b: int) -> None:
            for j in range(a, b):
                col = np.asarray(X[:, j], dtype=np.float64)
                binned = np.searchsorted(self.upper_bounds[j], col,
                                         side="left").astype(np.int32)
                binned[np.isnan(col)] = 0
                out[j - j0] = binned

        _fanout_feature_blocks(run, j0, j1, n)
        return out

    def _u8_ok(self) -> bool:
        return int(self.num_bins.max(initial=1)) <= 256

    def transform(self, X: np.ndarray, native: bool = False) -> np.ndarray:
        """Raw features -> int32 bin indices, shape (N, F); through the
        OpenMP library with ``native`` (it raises if that fails)."""
        X = np.asarray(X, dtype=np.float64)
        if native:
            from mmlspark_tpu_torch.gbdt import native_bins
            return native_bins.apply_bins(X, self.upper_bounds)
        out = np.empty(X.shape, np.int32)
        self._numpy_bin_block(X, 0, self.num_features, out=out.T)
        return out

    def transform_fm(self, X: np.ndarray, native: bool = False
                     ) -> np.ndarray:
        """Raw features -> FEATURES-MAJOR (F, N) bins, the engine's
        device layout: int32, or with ``native`` the library's fused
        bin + transpose + narrow into uint8 when every feature has at
        most 256 bins (the same values). f32 input widens per value to
        f64 before the compare, so results equal the f64 path bit for
        bit."""
        return self.transform_fm_range(X, 0, self.num_features, native)

    def transform_fm_range(self, X: np.ndarray, j0: int, j1: int,
                           native: bool = False) -> np.ndarray:
        """Features [j0, j1) straight into the (j1 - j0, N) features-major
        layout (``transform_fm`` of a feature block)."""
        X = np.asarray(X)
        if not native:
            return self._numpy_bin_block(X, j0, j1)
        from mmlspark_tpu_torch.gbdt import native_bins
        if self._u8_ok():
            return native_bins.apply_bins_t_u8(X, self.upper_bounds,
                                               feature_range=(j0, j1))
        return np.ascontiguousarray(native_bins.apply_bins(
            X, self.upper_bounds)[:, j0:j1].T)

    def bounds_matrix(self, dtype=np.float32) -> np.ndarray:
        """Dense (F, B_max) ascending bounds, short features padded with
        +inf — the device-binning lookup table. Every finite value
        inserts before the +inf tail and +inf itself at the first pad
        slot, i.e. at len(upper_bounds[f]), matching the host path."""
        width = max([len(u) for u in self.upper_bounds] + [1])
        out = np.full((self.num_features, width), np.inf, dtype=dtype)
        for j, u in enumerate(self.upper_bounds):
            if len(u):
                out[j, :len(u)] = u.astype(dtype)
        return out

    def to_json(self) -> dict:
        return {"max_bin": self.max_bin,
                "f32_values_safe": self.f32_values_safe,
                "f32_cuts_exact": self.f32_cuts_exact,
                "sketch_eps": self.sketch_eps,
                "upper_bounds": [u.tolist() for u in self.upper_bounds]}

    @staticmethod
    def from_json(d: dict) -> "BinMapper":
        m = BinMapper([np.asarray(u) for u in d["upper_bounds"]],
                      d["max_bin"],
                      f32_values_safe=d.get("f32_values_safe", False),
                      f32_cuts_exact=d.get("f32_cuts_exact", False))
        m.sketch_eps = float(d.get("sketch_eps", 0.0))
        return m

    def bin_threshold_value(self, feature: int, bin_idx: int) -> float:
        """The raw-value threshold for 'go left if bin <= bin_idx':
        the upper boundary of that bin, +inf at or past the feature's
        top bin (every value goes left there during binned training)."""
        ub = self.upper_bounds[feature]
        if len(ub) == 0 or int(bin_idx) >= len(ub):
            return np.inf
        return float(ub[int(bin_idx)])

    def f32_safe(self) -> bool:
        """True when binning / threshold comparison can run in float32
        without changing assignments (the fit's ``f32_values_safe``)."""
        return self.f32_values_safe

    def threshold_matrix(self, num_bins: int) -> np.ndarray:
        """(F, num_bins) raw-value threshold of 'go left if bin <= b' for
        every (feature, bin) pair: the upper boundary of bin b, +inf at or
        past the top bin. One gather converts a forest's bin thresholds
        to raw-value thresholds."""
        out = np.full((self.num_features, num_bins), np.inf)
        for j, ub in enumerate(self.upper_bounds):
            k = min(len(ub), num_bins)
            out[j, :k] = ub[:k]
        return out


# ---------------------------------------------------------------------------
# on-device binning
# ---------------------------------------------------------------------------


def bucketize_fm_device(raw_fn: torch.Tensor,
                        bounds: torch.Tensor) -> torch.Tensor:
    """On-device bin assignment. ``raw_fn`` is the raw float32 feature
    matrix FEATURES-MAJOR (F, N) on the device, ``bounds`` the device
    copy of ``BinMapper.bounds_matrix()``. Returns (F, N) int32 bins,
    bit-identical to ``BinMapper.transform_fm(X)`` whenever
    ``mapper.f32_cuts_exact`` holds. NaN -> bin 0 like the host path;
    ±inf need no special case (the +inf pad places +inf at len(ub)).

    (The JAX function takes the row-major (N, F) matrix and transposes
    inside the jitted program; here the caller hands over the
    features-major layout, since ``searchsorted`` batches over leading
    dimensions.)"""
    b = torch.searchsorted(bounds.contiguous(), raw_fn.contiguous(),
                           right=False, out_int32=True)
    return torch.where(torch.isnan(raw_fn), torch.zeros_like(b), b)


def _holdout_rows(n: int, sampled_idx: np.ndarray, rng) -> np.ndarray:
    """Up to 50k row indices that the fit sample did NOT cover."""
    mask = np.ones(n, dtype=bool)
    mask[sampled_idx] = False
    rest = np.flatnonzero(mask)
    if len(rest) > 50_000:
        rest = rng.choice(rest, size=50_000, replace=False)
    return rest


def _holdout_f32_agrees(bounds, feature_values) -> bool:
    """True when every holdout value bins identically under f64 and f32
    boundaries (NaN excluded — it maps to bin 0 in either dtype)."""
    for j, col in feature_values:
        ub = bounds[j]
        if not len(ub):
            continue
        v = np.asarray(col)
        v = v[~np.isnan(v)]
        b64 = np.searchsorted(ub, v, side="left")
        b32 = np.searchsorted(ub.astype(np.float32),
                              v.astype(np.float32), side="left")
        if not np.array_equal(b64, b32):
            return False
    return True


_EPS32 = float(np.finfo(np.float32).eps)


def _cut_f32_ok(lo: float, hi: float) -> bool:
    """A boundary at (lo+hi)/2 separates lo from hi under f32 compares
    iff the half-gap dominates the f32 rounding band at that magnitude."""
    return (hi - lo) / 2.0 > 8.0 * _EPS32 * max(abs(lo), abs(hi))


def _feature_bounds(col: np.ndarray, max_bin: int,
                    f32_exact: bool = False):
    """Equal-frequency boundaries for one feature column: (bounds,
    f32_ok)."""
    col = col[np.isfinite(col)]
    if col.size == 0:
        return np.empty(0), True
    distinct, counts = np.unique(col, return_counts=True)
    return _bounds_from_counts(distinct, counts, max_bin, f32_exact)


def _snap_cuts_f32(bounds: np.ndarray) -> np.ndarray:
    """Snap each cut DOWN to the largest float32 value <= the f64 cut:
    for a float32 value v, v <= s <=> v <= c, so f32 binning against the
    snapped cuts equals f64 binning against the original cuts."""
    b64 = np.asarray(bounds, np.float64)
    s32 = b64.astype(np.float32)
    over = s32.astype(np.float64) > b64
    s32 = np.where(over, np.nextafter(s32, np.float32(-np.inf)), s32)
    return s32.astype(np.float64)


def _bounds_from_counts(distinct: np.ndarray, counts: np.ndarray,
                        max_bin: int, f32_exact: bool = False):
    """Equal-frequency cuts from a (sorted distinct values, counts)
    histogram."""
    if len(distinct) <= 1:
        return np.empty(0), True
    if len(distinct) <= max_bin:
        # one bin per distinct value; boundaries at midpoints
        mid = (distinct[:-1] + distinct[1:]) / 2.0
        if f32_exact:
            return _snap_cuts_f32(mid), True
        ok = all(_cut_f32_ok(a, b)
                 for a, b in zip(distinct[:-1], distinct[1:]))
        return mid, ok
    # equal-frequency: cut where the cumulative count fills a bin's quota
    cum = np.cumsum(counts)
    per_bin = cum[-1] / max_bin
    bounds = []
    ok = True
    last = len(distinct) - 1
    target = per_bin
    while len(bounds) < max_bin - 1:
        i = int(np.searchsorted(cum, target, side="left"))
        if i >= last:
            break
        bounds.append((distinct[i] + distinct[i + 1]) / 2.0)
        ok = ok and (f32_exact
                     or _cut_f32_ok(distinct[i], distinct[i + 1]))
        target = cum[i] + per_bin
    if f32_exact:
        return _snap_cuts_f32(np.asarray(bounds)), True
    return np.asarray(bounds), ok
