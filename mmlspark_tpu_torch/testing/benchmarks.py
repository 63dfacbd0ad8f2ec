"""Accuracy-benchmark regression harness: the port's copy of
``mmlspark_tpu/testing/benchmarks.py``.

ref: src/core/test/benchmarks/src/main/scala/Benchmarks.scala:15-60 —
named metric values are compared against a checked-in CSV at a given
decimal precision; on mismatch the test fails and writes the newly
observed values next to the expected file for easy promotion.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Tuple


class BenchmarkComparer:
    def __init__(self, csv_path: str, precision: int = 1):
        self.csv_path = csv_path
        self.precision = precision
        self._observed: List[Tuple[str, float]] = []

    def expected(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if not os.path.exists(self.csv_path):
            return out
        with open(self.csv_path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                out[row[0]] = float(row[1])
        return out

    def record(self, name: str, value: float) -> None:
        self._observed.append((name, float(value)))

    def verify(self) -> None:
        exp = self.expected()
        tol = 10.0 ** (-self.precision)
        errors = []
        for name, value in self._observed:
            if name not in exp:
                errors.append(f"metric {name!r} missing from {self.csv_path}")
            elif abs(value - exp[name]) > tol:
                errors.append(
                    f"metric {name!r}: observed {value:.6f} vs expected "
                    f"{exp[name]:.6f} (tol {tol})")
        if errors:
            observed_path = self.csv_path + ".observed"
            with open(observed_path, "w", newline="") as f:
                w = csv.writer(f)
                for name, value in self._observed:
                    w.writerow([name, f"{value:.6f}"])
            raise AssertionError(
                "benchmark regression:\n  " + "\n  ".join(errors) +
                f"\nobserved values written to {observed_path}")
