"""Serving-path metrics of the PyTorch port: the part of
``mmlspark_tpu/core/metrics.py`` that the model stages and the serving
engine read — latency histograms (mergeable, snapshot for exporters),
the windowed counter, the process-wide warmup and ingress histograms,
and the feature ``DriftMonitor``. The reference's ``LabelledHistograms``
and ``WindowedHistogram`` serve Prometheus ``/metrics`` and the SLO
monitor, and its GBDT / AutoML / fusion / out-of-core / control-loop
phase families belong to modules the port has not reached yet
(ROADMAP.md)."""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

# log-spaced upper bounds (1-2-5 decades): resolution tracks magnitude,
# so the same 18 buckets cover a 50 us pad and a 5 s cold start
_DEFAULT_BOUNDS = (0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
                   100.0, 200.0, 500.0, 1000.0, 2000.0, 5000.0, 10000.0,
                   math.inf)


def percentile_from_counts(bounds: Sequence[float],
                           counts: Sequence[int], count: int,
                           mx: float, q: float) -> float:
    """q-th percentile from one consistent (bounds, counts) snapshot:
    linear interpolation inside the containing bucket, never reporting
    above the observed max."""
    if count == 0:
        return 0.0
    rank = q / 100.0 * count
    seen = 0
    for i, c in enumerate(counts):
        if seen + c >= rank and c > 0:
            lo = 0.0 if i == 0 else bounds[i - 1]
            hi = mx if math.isinf(bounds[i]) else bounds[i]
            frac = (rank - seen) / c
            est = lo + (max(hi, lo) - lo) * min(max(frac, 0.0), 1.0)
            return min(est, mx)
        seen += c
    return mx


class LatencyHistogram:
    """Fixed-bucket latency histogram: lock-guarded counters, ``observe``
    O(#buckets) with no allocation. Percentiles interpolate within the
    containing bucket (exact count, approximate value)."""

    def __init__(self, unit: str = "ms",
                 bounds: Sequence[float] = _DEFAULT_BOUNDS):
        self.unit = unit
        self.bounds = tuple(bounds)
        if self.bounds[-1] != math.inf:
            self.bounds = self.bounds + (math.inf,)
        self._counts = [0] * len(self.bounds)
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        i = 0
        while self.bounds[i] < v:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v > self._max:
                self._max = v

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold another histogram's counts into this one (fleet-wide
        aggregation). Bucket layouts must match."""
        if other.bounds != self.bounds:
            raise ValueError("histogram bucket layouts differ")
        with other._lock:
            counts = list(other._counts)
            count, total, mx = other._count, other._sum, other._max
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._count += count
            self._sum += total
            self._max = max(self._max, mx)
        return self

    @staticmethod
    def merged(hists: Sequence["LatencyHistogram"]) -> "LatencyHistogram":
        out = LatencyHistogram(unit=hists[0].unit if hists else "ms")
        for h in hists:
            out.merge(h)
        return out

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100])."""
        with self._lock:
            counts = list(self._counts)
            count, mx = self._count, self._max
        return percentile_from_counts(self.bounds, counts, count, mx, q)

    def summary(self) -> Dict[str, float]:
        # one snapshot under the lock: every field describes one instant
        with self._lock:
            counts = list(self._counts)
            count, total, mx = self._count, self._sum, self._max
        if count == 0:
            return {"count": 0}

        def pct(q):
            return round(percentile_from_counts(self.bounds, counts, count,
                                                mx, q), 3)
        return {"count": count, "mean": round(total / count, 3),
                "p50": pct(50), "p90": pct(90), "p99": pct(99),
                "max": round(mx, 3), "sum": round(total, 3)}

    def snapshot(self) -> Dict[str, object]:
        """Raw buckets for exporters (one consistent view: the bucket
        counts, total count, and sum are read under a single lock so
        sum(counts) == count always holds — the Prometheus renderer
        depends on it for monotone cumulative buckets)."""
        with self._lock:
            counts = list(self._counts)
            count, total, mx = self._count, self._sum, self._max
        return {"unit": self.unit, "bounds": list(self.bounds),
                "counts": counts, "count": count, "sum": total,
                "max": mx}

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * len(self.bounds)
            self._count = 0
            self._sum = 0.0
            self._max = 0.0


def histogram_set(*names: str) -> Dict[str, LatencyHistogram]:
    """A named family of histograms."""
    return {n: LatencyHistogram() for n in names}


# ---------------------------------------------------------------------------
# windowed (sliding-window) counter — the serving engine's drain rate
# behind a live Retry-After
# ---------------------------------------------------------------------------

# Cumulative counters answer "since process start"; a drain-rate
# estimate needs "over the last N seconds". The counter ring-buffers
# TIME buckets: each slot covers ``bucket_s`` seconds of wall clock and
# carries the epoch (bucket index since clock zero) it was last written
# for, so rotation is lazy — a slot is zeroed exactly once, by the
# first writer (or reader) that touches it in a new epoch, under the
# same lock every mutation takes: one short critical section, no
# allocation, O(1) per inc; window reads sum only ceil(window/bucket_s)
# slots.


class WindowedCounter:
    """A counter readable over sliding time windows.

    ``inc`` lands in the current time bucket; ``total(window_s)`` sums
    the buckets covering the trailing window (partial current bucket
    included — the standard streaming approximation: the window edge is
    quantized to ``bucket_s``). ``cumulative`` stays monotone for
    Prometheus counters. Thread-safe; buckets expire exactly once
    (epoch-tagged slots, rotation under the lock)."""

    __slots__ = ("bucket_s", "n_slots", "cumulative", "_counts",
                 "_epochs", "_lock", "_clock")

    def __init__(self, bucket_s: float = 1.0, horizon_s: float = 3660.0,
                 clock=time.monotonic):
        self.bucket_s = float(bucket_s)
        if self.bucket_s <= 0:
            raise ValueError("bucket_s must be positive")
        self.n_slots = max(2, int(math.ceil(horizon_s / self.bucket_s)) + 1)
        self.cumulative = 0.0
        self._counts = [0.0] * self.n_slots
        self._epochs = [-1] * self.n_slots
        self._lock = threading.Lock()
        self._clock = clock

    def _epoch(self, now: Optional[float]) -> int:
        return int((self._clock() if now is None else now)
                   // self.bucket_s)

    def inc(self, n: float = 1.0, now: Optional[float] = None) -> None:
        epoch = self._epoch(now)
        slot = epoch % self.n_slots
        with self._lock:
            if self._epochs[slot] != epoch:
                # lazy rotation: this slot last held a bucket a full
                # horizon ago — zero it exactly once for the new epoch
                self._counts[slot] = 0.0
                self._epochs[slot] = epoch
            self._counts[slot] += n
            self.cumulative += n

    def total(self, window_s: float, now: Optional[float] = None) -> float:
        """Sum over the trailing ``window_s`` (quantized to buckets)."""
        epoch = self._epoch(now)
        k = min(self.n_slots,
                max(1, int(math.ceil(window_s / self.bucket_s))))
        lo = epoch - k + 1
        with self._lock:
            return sum(self._counts[e % self.n_slots]
                       for e in range(lo, epoch + 1)
                       if self._epochs[e % self.n_slots] == e)

    def rate(self, window_s: float, now: Optional[float] = None) -> float:
        """Per-second rate over the trailing window."""
        return self.total(window_s, now) / max(window_s, 1e-9)

    def series(self, window_s: float, now: Optional[float] = None
               ) -> List[Tuple[float, float]]:
        """Per-bucket ``(bucket_start_s, value)`` pairs over the
        trailing window, oldest first (the flight recorder's
        machine-readable time series; empty buckets report 0)."""
        epoch = self._epoch(now)
        k = min(self.n_slots,
                max(1, int(math.ceil(window_s / self.bucket_s))))
        lo = epoch - k + 1
        with self._lock:
            return [(e * self.bucket_s,
                     self._counts[e % self.n_slots]
                     if self._epochs[e % self.n_slots] == e else 0.0)
                    for e in range(lo, epoch + 1)]


# ---------------------------------------------------------------------------
# serving warmup histogram
# ---------------------------------------------------------------------------

# per-bucket wall milliseconds of every serving-model warmup in this
# process (core/warmup.py — the one bucket loop behind TPUModel.warmup):
# log2(batchSize) + 1 samples per cold model.
_WARMUP_HISTS: Dict[str, LatencyHistogram] = histogram_set(
    "model_warmup_ms")


def warmup_histograms() -> Dict[str, LatencyHistogram]:
    """The process-wide serving-warmup histogram family."""
    return _WARMUP_HISTS


# ---------------------------------------------------------------------------
# out-of-core ingest phase histograms (io/ooc.py)
# ---------------------------------------------------------------------------

# per-chunk wall milliseconds of chunked ingest: decode (the source read
# — .npy slice, Arrow IPC batch, generator build — on the prefetch
# worker) and wait (how long the consumer blocked on the prefetch queue;
# near zero when ingest hides behind the consumer's work). The JAX
# package's two other phases, prepare and dispatch, belong to its fused
# chunked transform, which the port does not have yet.
OOC_PHASES = ("decode", "wait")
_OOC_HISTS: Dict[str, LatencyHistogram] = histogram_set(*OOC_PHASES)


def ooc_histograms() -> Dict[str, LatencyHistogram]:
    """The process-wide out-of-core ingest phase histogram family."""
    return _OOC_HISTS


# ---------------------------------------------------------------------------
# serving-ingress phase histograms (columnar ingress — io/columnar.py)
# ---------------------------------------------------------------------------

# per-batch wall milliseconds of the serving ingress path: negotiate
# (per-request Content-Type codec pick), assemble (column concatenation
# + batch table build — no row dicts on the columnar path), pad (copy
# into the reused per-bucket staging buffers). Decode is tracked
# separately per codec via ``ingress_decode_histogram``, so the
# columnar-vs-JSON host cost reads from one snapshot.
INGRESS_PHASES = ("negotiate", "assemble", "pad")
_INGRESS_HISTS: Dict[str, LatencyHistogram] = histogram_set(
    *INGRESS_PHASES)
_INGRESS_DECODE: Dict[str, LatencyHistogram] = {}
_INGRESS_DECODE_LOCK = threading.Lock()


def ingress_histograms() -> Dict[str, LatencyHistogram]:
    """The process-wide serving-ingress phase histogram family
    (negotiate/assemble/pad; decode is per-codec — see
    ``ingress_decode_histograms``)."""
    return _INGRESS_HISTS


def ingress_decode_histogram(codec: str) -> LatencyHistogram:
    """The decode histogram for one codec (``json``/``msgpack``/
    ``arrow``), created on first use."""
    hist = _INGRESS_DECODE.get(codec)
    if hist is None:
        with _INGRESS_DECODE_LOCK:
            hist = _INGRESS_DECODE.get(codec)
            if hist is None:
                hist = _INGRESS_DECODE[codec] = LatencyHistogram()
    return hist


def ingress_decode_histograms() -> Dict[str, LatencyHistogram]:
    """Snapshot of the per-codec decode histograms seen so far."""
    with _INGRESS_DECODE_LOCK:
        return dict(_INGRESS_DECODE)


# ---------------------------------------------------------------------------
# feature-drift counters (serving-time vs fit-time statistics)
# ---------------------------------------------------------------------------


class DriftMonitor:
    """Running per-feature statistics of served traffic vs fit-time stats.

    Holds the fit-time reference (per-feature mean/var) and accumulates
    a running count/mean/M2 (Chan et al. parallel-Welford merge, one
    vectorized update per batch) plus per-feature null (NaN/inf) counts
    over everything ``observe``d. ``summary()`` reports the deltas the
    lifecycle layer watches: max |mean shift| in reference-sigma units,
    max var ratio, and the null rate — the serving-side analog of the
    reference's verifyResult data-validation gate, exported through
    ``engine.metrics()``/``/healthz`` so a canary that *works* but sees
    a shifted feature distribution is visible before it breaches.

    Thread-safe: serving batcher threads observe concurrently.
    """

    def __init__(self, ref_mean, ref_var, feature_names=None):
        import numpy as np
        self.ref_mean = np.asarray(ref_mean, dtype=np.float64).ravel()
        # (near-)constant fit-time features get unit variance for the
        # delta denominators (the _Standardizer discipline): a true
        # sigma of ~0 would turn float32 round-trip noise into a
        # million-sigma "drift" and pin worst_feature forever
        ref_var = np.asarray(ref_var, dtype=np.float64).ravel()
        self.ref_var = np.where(ref_var < 1e-24, 1.0, ref_var)
        if self.ref_mean.shape != self.ref_var.shape:
            raise ValueError("ref_mean and ref_var shapes differ")
        self.feature_names = list(feature_names) if feature_names else None
        d = self.ref_mean.shape[0]
        self._n = 0                      # finite observations per feature
        self._mean = np.zeros(d)
        self._m2 = np.zeros(d)
        self._nulls = np.zeros(d, dtype=np.int64)
        self._rows = 0
        self._lock = threading.Lock()

    @classmethod
    def from_matrix(cls, X, feature_names=None) -> "DriftMonitor":
        """Reference stats from the fit-time feature matrix."""
        import numpy as np
        X = np.asarray(X, dtype=np.float64)
        finite = np.isfinite(X)
        n = np.maximum(finite.sum(axis=0), 1)
        mean = np.where(finite, X, 0.0).sum(axis=0) / n
        var = np.where(finite, (X - mean) ** 2, 0.0).sum(axis=0) / n
        return cls(mean, var, feature_names=feature_names)

    def observe(self, X) -> None:
        """Fold one (N, D) served batch into the running statistics."""
        import numpy as np
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X[None, :]
        if X.shape[0] == 0:
            return
        finite = np.isfinite(X)
        nb = finite.sum(axis=0)
        safe = np.maximum(nb, 1)
        mean_b = np.where(finite, X, 0.0).sum(axis=0) / safe
        m2_b = np.where(finite, (X - mean_b) ** 2, 0.0).sum(axis=0)
        with self._lock:
            self._rows += X.shape[0]
            self._nulls += (X.shape[0] - nb)
            # parallel-Welford merge of (nb, mean_b, m2_b) into the
            # running (n, mean, m2) — per-feature counts stay scalar
            # here because observe() masks non-finite values per column
            n_new = self._n + nb
            delta = mean_b - self._mean
            safe_new = np.maximum(n_new, 1)
            self._mean = self._mean + delta * (nb / safe_new)
            self._m2 = (self._m2 + m2_b
                        + delta ** 2 * (self._n * nb / safe_new))
            self._n = n_new

    def summary(self) -> Dict[str, object]:
        """Compact drift verdict: aggregates over features (the wide
        per-feature arrays stay behind ``snapshot()``)."""
        import numpy as np
        with self._lock:
            n, mean, m2 = np.asarray(self._n), self._mean.copy(), \
                self._m2.copy()
            nulls, rows = self._nulls.copy(), self._rows
        if rows == 0:
            return {"rows": 0}
        seen = np.asarray(n) > 0
        sigma = np.sqrt(self.ref_var)
        mean_delta = np.where(seen, (mean - self.ref_mean) / sigma, 0.0)
        var = np.where(np.asarray(n) > 1, m2 / np.maximum(n, 1), 0.0)
        var_ratio = np.where(np.asarray(n) > 1, var / self.ref_var, 1.0)
        null_rate = float(nulls.sum()) / (rows * len(self.ref_mean))
        worst = int(np.abs(mean_delta).argmax())
        out: Dict[str, object] = {
            "rows": int(rows),
            "max_abs_mean_delta_sigma": round(
                float(np.abs(mean_delta).max()), 4),
            "max_var_ratio": round(float(var_ratio.max()), 4),
            "null_rate": round(null_rate, 6),
            "worst_feature": (self.feature_names[worst]
                              if self.feature_names else worst),
        }
        return out

    def snapshot(self) -> Dict[str, object]:
        """Full per-feature arrays for exporters/tests."""
        import numpy as np
        with self._lock:
            n = np.asarray(self._n).copy()
            mean, m2 = self._mean.copy(), self._m2.copy()
            nulls, rows = self._nulls.copy(), self._rows
        var = np.where(n > 1, m2 / np.maximum(n, 1), 0.0)
        return {"rows": int(rows), "count": n, "mean": mean, "var": var,
                "nulls": nulls, "ref_mean": self.ref_mean.copy(),
                "ref_var": self.ref_var.copy()}

    def reset(self) -> None:
        import numpy as np
        with self._lock:
            d = self.ref_mean.shape[0]
            self._n = 0
            self._mean = np.zeros(d)
            self._m2 = np.zeros(d)
            self._nulls = np.zeros(d, dtype=np.int64)
            self._rows = 0
