"""Mergeable quantile sketch — the out-of-core analog of
``BinMapper.fit``'s sort-based quantile pass.

The PyTorch port's own copy of ``mmlspark_tpu/gbdt/sketch.py`` (host
numpy; the same arithmetic, so summaries, certificates, cuts and wire
vectors are bitwise the JAX package's on the same input).

The construction is the deterministic mergeable summary of Greenwald &
Khanna (SIGMOD'01) in the form XGBoost's weighted quantile sketch uses
(Chen & Guestrin, KDD'16 §3.3 + appendix): a summary is a sorted list of
values, each carrying RIGOROUS lower/upper bounds on its rank in the
data seen so far. Three operations:

- ``update(values)``  — absorb a block of raw values (one chunk's
  column). Non-finite values are DROPPED exactly like
  ``BinMapper.fit``'s ``col[np.isfinite(col)]`` (NaN and ±inf never
  influence cut placement; at transform time NaN still routes to bin 0
  and ±inf to the edge bins — that path is untouched).
- ``merge(other)``    — combine two sketches built over disjoint data
  (other chunks, other hosts). Rank bounds ADD, so correctness is by
  construction and merge order only moves results within the bound.
- ``cuts(max_bin)``   — equal-frequency cut values mirroring
  ``binning._bounds_from_counts``'s walk; bit-identical to it while the
  sketch is still exact (no compaction happened).

Error accounting is a measured CERTIFICATE, not a trusted constant:
every entry's rank interval ``[rmin, rmax]`` is maintained rigorously
through exact summarization (width 0), merging (widths add), and
pruning (surviving entries keep their intervals), so ``eps()`` — the
worst-case normalized rank error of answering any quantile query from
the current summary — is computed from the intervals actually present.
With prune width ``b`` the certificate lands near the textbook
``(1 + merge_depth) / (2b)``; tests and ``BinMapper.fit_streaming``
assert against the certificate itself.

Memory: one sketch holds O(b · log(n/b)) entries (a logarithmic
compactor cascade, KLL-style scheduling of GK-style summaries), a few
hundred KB per feature at 100M rows with the default ``b=512``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class _Summary:
    """Sorted values + rigorous rank-interval bounds.

    ``lmin/lmax`` bound L(v) = #elements strictly below v;
    ``rmin/rmax`` bound R(v) = #elements ≤ v; ``w`` is the total count
    the summary covers. An exact summary has lmin==lmax, rmin==rmax.
    """

    __slots__ = ("v", "lmin", "lmax", "rmin", "rmax", "w")

    def __init__(self, v, lmin, lmax, rmin, rmax, w):
        self.v = v
        self.lmin = lmin
        self.lmax = lmax
        self.rmin = rmin
        self.rmax = rmax
        self.w = float(w)

    def __len__(self) -> int:
        return len(self.v)


def _exact_summary(values: np.ndarray) -> _Summary:
    """Width-0 summary of a raw finite-value block (np.unique pass)."""
    distinct, counts = np.unique(values, return_counts=True)
    cum = np.cumsum(counts, dtype=np.float64)
    below = cum - counts
    return _Summary(distinct.astype(np.float64), below, below.copy(),
                    cum, cum.copy(), cum[-1] if len(cum) else 0.0)


def _bounds_at(s: _Summary, vm: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Evaluate s's rank bounds at every value of ``vm``.

    Members keep their stored intervals. For a non-member v with
    predecessor p and successor q in s: every element ≤ p is < v and
    every element ≤ v is < q, so
    ``L(v), R(v) ∈ [rmin(p), lmax(q)]`` (0 / w at the ends). Merging
    two EXACT summaries therefore stays exact: with no elements strictly
    between p and q, rmin(p) == lmax(q).
    """
    n = len(s.v)
    if n == 0:
        z = np.zeros(len(vm))
        return z, z.copy(), z.copy(), z.copy()
    idx = np.searchsorted(s.v, vm, side="left")
    member = (idx < n) & (s.v[np.minimum(idx, n - 1)] == vm)
    pred = np.clip(idx - 1, 0, n - 1)
    succ = np.minimum(idx, n - 1)
    lo = np.where(idx > 0, s.rmin[pred], 0.0)
    hi = np.where(idx < n, s.lmax[succ], s.w)
    i = np.minimum(idx, n - 1)
    l_lo = np.where(member, s.lmin[i], lo)
    l_hi = np.where(member, s.lmax[i], hi)
    r_lo = np.where(member, s.rmin[i], lo)
    r_hi = np.where(member, s.rmax[i], hi)
    return l_lo, l_hi, r_lo, r_hi


def _merge(a: _Summary, b: _Summary) -> _Summary:
    """Summary of the union of the two underlying datasets: evaluate
    both summaries' bounds at the merged value set and ADD them."""
    if len(a) == 0:
        return b
    if len(b) == 0:
        return a
    vm = np.union1d(a.v, b.v)
    al_lo, al_hi, ar_lo, ar_hi = _bounds_at(a, vm)
    bl_lo, bl_hi, br_lo, br_hi = _bounds_at(b, vm)
    return _Summary(vm, al_lo + bl_lo, al_hi + bl_hi,
                    ar_lo + br_lo, ar_hi + br_hi, a.w + b.w)


def _prune(s: _Summary, b: int) -> _Summary:
    """Keep ~b+1 entries covering evenly spaced target ranks (plus both
    extremes — cut placement needs the true min/max neighborhoods).
    Survivors keep their ORIGINAL intervals, so bounds stay rigorous;
    the certificate absorbs the coarser coverage."""
    n = len(s.v)
    if n <= b + 1:
        return s
    mid = (s.rmin + s.rmax) * 0.5
    targets = s.w * np.arange(1, b) / b
    idx = np.searchsorted(mid, targets, side="left")
    idx = np.clip(idx, 1, n - 1)
    # the entry just below may sit closer to the target rank
    closer = (np.abs(mid[idx - 1] - targets)
              <= np.abs(mid[np.minimum(idx, n - 1)] - targets))
    idx = np.where(closer, idx - 1, idx)
    keep = np.unique(np.concatenate([[0], idx, [n - 1]]))
    return _Summary(s.v[keep], s.lmin[keep], s.lmax[keep],
                    s.rmin[keep], s.rmax[keep], s.w)


def _certificate(s: _Summary) -> float:
    """Worst-case normalized rank error of answering ANY rank query
    with the best entry of ``s``: returning entry i for target r costs
    at most max(rmax_i - r, r - rmin_i); maximizing the best choice
    over r lands either between two entries (half the uncovered span)
    or at the extremes."""
    n = len(s.v)
    if n == 0 or s.w <= 0:
        return 0.0
    worst = max(float(s.rmax[0]), float(s.w - s.rmin[-1]))
    if n > 1:
        worst = max(worst, float(np.max(s.rmax[1:] - s.rmin[:-1])) / 2.0)
    return worst / s.w


class QuantileSketch:
    """One feature's mergeable quantile summary (module docstring).

    ``b`` is the compaction width (error ~ merge_depth / 2b);
    ``buffer_rows`` is how many raw values buffer before a compaction
    pass — both bound host memory, neither changes correctness (the
    certificate reflects whatever happened).
    """

    def __init__(self, b: int = 512, buffer_rows: int = 131072):
        if b < 8:
            raise ValueError(f"sketch width b={b} is too small (>=8)")
        self.b = int(b)
        self.buffer_rows = int(buffer_rows)
        self._pending: List[np.ndarray] = []
        self._pending_n = 0
        self._levels: List[Optional[_Summary]] = []
        self._final: Optional[_Summary] = None
        self.count = 0        # finite values absorbed
        self.dropped = 0      # NaN/±inf dropped (BinMapper.fit parity)
        self.exact = True     # False after the first compaction

    # -- building ----------------------------------------------------------

    def update(self, values) -> "QuantileSketch":
        """Absorb a block of raw values (any shape; flattened).
        Non-finite values are dropped, exactly like ``BinMapper.fit``."""
        v = np.asarray(values, dtype=np.float64).ravel()
        finite = v[np.isfinite(v)]
        self.dropped += int(v.size - finite.size)
        if finite.size == 0:
            return self
        self.count += int(finite.size)
        # boolean indexing copied: no reference into the caller's chunk
        self._pending.append(finite)
        self._pending_n += int(finite.size)
        self._final = None
        if self._pending_n >= self.buffer_rows:
            self._flush()
        return self

    def _flush(self) -> None:
        if self._pending_n == 0:
            return
        vals = (self._pending[0] if len(self._pending) == 1
                else np.concatenate(self._pending))  # ooc:materialize-ok (bounded pending buffer)
        self._pending, self._pending_n = [], 0
        self._carry(_exact_summary(vals), 0)

    def _carry(self, s: _Summary, level: int) -> None:
        if len(s) > self.b + 1:
            s = _prune(s, self.b)
            self.exact = False
        while len(self._levels) <= level:
            self._levels.append(None)
        while self._levels[level] is not None:
            s = _merge(self._levels[level], s)
            self._levels[level] = None
            if len(s) > self.b + 1:
                s = _prune(s, self.b)
                self.exact = False
            level += 1
            if len(self._levels) <= level:
                self._levels.append(None)
        self._levels[level] = s
        self._final = None

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` (built over DIFFERENT data) into self.
        Deterministic; results depend on merge order only within the
        certificate bound."""
        other._flush()
        self._flush()
        for level, s in enumerate(other._levels):
            if s is not None:
                self._carry(s, level)
        self.count += other.count
        self.dropped += other.dropped
        self.exact = self.exact and other.exact
        self._final = None
        return self

    # -- reading -----------------------------------------------------------

    def summary(self) -> _Summary:
        """All levels + pending merged WITHOUT pruning (size is
        O(b·levels) — the read-side summary quantile queries run on)."""
        if self._final is None:
            acc: Optional[_Summary] = None
            if self._pending_n:
                vals = (self._pending[0] if len(self._pending) == 1
                        else np.concatenate(self._pending))  # ooc:materialize-ok (bounded pending buffer)
                acc = _exact_summary(vals)
            for s in self._levels:
                if s is not None:
                    acc = s if acc is None else _merge(acc, s)
            self._final = acc if acc is not None else _Summary(
                np.empty(0), np.empty(0), np.empty(0),
                np.empty(0), np.empty(0), 0.0)
        return self._final

    def eps(self) -> float:
        """Normalized rank-error CERTIFICATE of this sketch (0.0 while
        exact — no compaction has happened). Any quantile answered from
        the summary is within ``eps() * count`` ranks of the truth; the
        certificate is measured from the maintained intervals, so it
        already covers every merge/prune that actually occurred."""
        if self.exact:
            return 0.0
        return _certificate(self.summary())

    def query(self, q: float) -> float:
        """Value whose rank is within ``eps()*count`` of quantile ``q``
        (the entry whose rank-interval midpoint lands closest) — the
        percentiles of ``SummarizeData``'s chunked path."""
        s = self.summary()
        if len(s) == 0:
            return float("nan")
        r = float(np.clip(q, 0.0, 1.0)) * s.w
        mid = (s.rmin + s.rmax) * 0.5
        return float(s.v[int(np.argmin(np.abs(mid - r)))])

    @property
    def min(self) -> float:
        s = self.summary()
        return float(s.v[0]) if len(s) else float("nan")

    @property
    def max(self) -> float:
        s = self.summary()
        return float(s.v[-1]) if len(s) else float("nan")

    def cuts(self, max_bin: int) -> np.ndarray:
        """Equal-frequency cut values, mirroring
        ``binning._bounds_from_counts``: while the sketch is EXACT this
        routes through that very function (bit-identical to a one-shot
        ``BinMapper.fit`` over the same rows, f32 snapping aside);
        otherwise the same quota walk runs on estimated cumulative
        counts, placing each cut at the midpoint of the neighboring
        summary values. A cut spans the GAP containing its target, so
        its true rank sits within ``2·eps()·count`` of the target
        (rank interval of the gap's two endpoints) — the bound
        ``BinMapper.fit_streaming`` documents and the tests pin."""
        s = self.summary()
        if len(s) <= 1:
            return np.empty(0)
        if self.exact:
            from mmlspark_tpu_torch.gbdt.binning import _bounds_from_counts
            counts = np.diff(np.concatenate([[0.0], s.rmin]))
            b, _ = _bounds_from_counts(s.v, counts, max_bin)
            return np.asarray(b)
        # approximate summary: one INDEPENDENT target rank per cut
        # (k·W/max_bin), each cut at the midpoint of the summary gap
        # containing its target — every cut's rank error is bounded by
        # the certificate alone (an accumulating walk would compound
        # per-entry overshoot across a pruned summary's coarse spacing)
        mid = (s.rmin + s.rmax) * 0.5
        targets = s.w * np.arange(1, max_bin) / max_bin
        idx = np.clip(np.searchsorted(mid, targets, side="left"),
                      1, len(s) - 1)
        cuts = (s.v[idx - 1] + s.v[idx]) / 2.0
        # heavy duplicates map several targets into one gap; keep cuts
        # strictly increasing like the exact walk (fewer bins, same
        # assignment semantics)
        keep = np.concatenate([[True], cuts[1:] > cuts[:-1]])
        return cuts[keep]

    # -- wire format ---------------------------------------------------------

    def to_wire(self, width: int) -> np.ndarray:
        """Fixed-shape float64 vector for collective transports
        (sketch agreement across processes): the summary PRUNED to ``width``
        entries, packed as [m, count, dropped, exact, v…, lmin…, lmax…,
        rmin…, rmax…, w] with NaN padding. f64 end to end — rank bounds
        and cut values must not round on the wire."""
        s = _prune(self.summary(), max(8, int(width) - 1))
        if len(s) > width:
            raise AssertionError("prune exceeded wire width")
        m = len(s)
        out = np.full(4 + 5 * width + 1, np.nan)
        out[0] = m
        out[1] = self.count
        out[2] = self.dropped
        out[3] = float(self.exact and m == len(self.summary()))
        for k, arr in enumerate((s.v, s.lmin, s.lmax, s.rmin, s.rmax)):
            out[4 + k * width:4 + k * width + m] = arr
        out[-1] = s.w
        return out

    @staticmethod
    def from_wire(vec: np.ndarray, b: int = 512) -> "QuantileSketch":
        vec = np.asarray(vec, np.float64).ravel()
        width = (len(vec) - 5) // 5
        m = int(vec[0])
        sk = QuantileSketch(b=b)
        if m > 0:
            cols = [vec[4 + k * width:4 + k * width + m]
                    for k in range(5)]
            sk._levels = [_Summary(*cols, float(vec[-1]))]
        sk.count = int(vec[1])
        sk.dropped = int(vec[2])
        sk.exact = bool(vec[3])
        return sk

