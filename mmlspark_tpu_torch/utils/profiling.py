"""Profiler hooks of the PyTorch port (see ``mmlspark_tpu/utils/profiling.py``).

``maybe_trace(dir)`` records ``torch.profiler`` (CPU and, on a card,
CUDA activity) around a block and writes a chrome trace into ``dir``;
``annotate(name)`` names a range on that timeline
(``torch.profiler.record_function``); ``trace_files(dir)`` lists what
``maybe_trace`` wrote. ``device_memory_stats()`` reads the card's
allocator counters under the JAX package's key names (``bytes_in_use``,
``peak_bytes_in_use``, ``bytes_limit``), so the ``device_memory_*``
gauges keep their names; ``mesh_memory_stats()`` sums them over the
process's cards (one here) and ``MemorySampler`` samples them on a
daemon thread. A CPU caller, or a process that has not initialised
CUDA, gets None: a ``/metrics`` scrape must not be what creates a CUDA
context.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import os
import threading
import time
from typing import Iterator, List, Optional

import torch


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """Profile the block with ``torch.profiler`` and write
    ``<trace_dir>/trace_<ns>.json`` (chrome format) when a directory is
    given, else a no-op — callers wrap unconditionally and the param
    decides."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"trace_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str, enabled: bool = True) -> Iterator[None]:
    """A named ``torch.profiler.record_function`` range around the block
    when ``enabled`` (else a no-op), so a profile's rows line up with the
    framework's phases."""
    if not enabled:
        yield
        return
    with torch.profiler.record_function(str(name)):
        yield


def trace_files(trace_dir: str) -> List[str]:
    """The chrome traces a ``maybe_trace`` run wrote (tests / tools)."""
    return sorted(glob.glob(os.path.join(trace_dir, "**", "trace_*.json"),
                            recursive=True))


def device_memory_stats(device=None) -> Optional[dict]:
    """The card's allocator counters as ``bytes_in_use``,
    ``peak_bytes_in_use`` and ``bytes_limit`` (the keys of the JAX
    package's ``memory_stats()``), or None for a CPU device, without a
    card, or before this process has initialised CUDA."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return None
    try:
        stats = torch.cuda.memory_stats(dev)
        limit = torch.cuda.get_device_properties(dev).total_memory
    except Exception:  # noqa: BLE001 — no stats: no sample
        return None
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(limit)}


def mesh_memory_stats() -> Optional[dict]:
    """Memory stats summed across every card of the process:
    ``bytes_in_use`` / ``bytes_limit`` / ``peak_bytes_in_use`` sum;
    ``per_device`` keeps each card's ``bytes_in_use``. The same safety
    contract as ``device_memory_stats`` (None without a sample)."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    total: dict = {}
    per_device: dict = {}
    for i in range(torch.cuda.device_count()):
        stats = device_memory_stats(i)
        if not stats:
            continue
        for key in ("bytes_in_use", "bytes_limit", "peak_bytes_in_use"):
            total[key] = total.get(key, 0) + int(stats[key])
        per_device[f"cuda:{i}"] = int(stats["bytes_in_use"])
    if not total:
        return None
    total["devices"] = len(per_device)
    total["per_device"] = per_device
    return total


class MemorySampler:
    """Background device-memory sampler: a daemon thread snapshots
    ``device_memory_stats`` every ``interval_s`` into a bounded ring, so
    a run's framework spans can be read against the card's memory curve
    (``TPULearner(memoryStatsEvery=...)`` uses the inline per-step
    variant; this is the wall-clock variant for serving)."""

    def __init__(self, interval_s: float = 1.0, capacity: int = 512,
                 device=None):
        self.interval_s = float(interval_s)
        self.device = device
        self.samples: "collections.deque" = collections.deque(
            maxlen=int(capacity))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MemorySampler":
        if self._thread is not None:
            return self

        def run():
            while not self._stop.wait(self.interval_s):
                stats = device_memory_stats(self.device)
                if stats is not None:
                    stats["t"] = time.time()
                    self.samples.append(stats)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="mem-sampler")
        self._thread.start()
        return self

    def stop(self) -> List[dict]:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s + 1)
            self._thread = None
        return list(self.samples)
