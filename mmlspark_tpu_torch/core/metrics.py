"""Serving-path latency histograms of the PyTorch port (the part of
``mmlspark_tpu/core/metrics.py`` that ``TPUModel`` needs)."""

from __future__ import annotations

import math
import threading
from typing import Dict, Sequence

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

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * len(self.bounds)
            self._count = 0
            self._sum = 0.0
            self._max = 0.0


def histogram_set(*names: str) -> Dict[str, LatencyHistogram]:
    """A named family of histograms."""
    return {n: LatencyHistogram() for n in names}
