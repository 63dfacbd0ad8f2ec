"""Profiler hooks of the PyTorch port (see ``mmlspark_tpu/utils/profiling.py``).

``maybe_trace(dir)`` records ``torch.profiler`` (CPU and, on a card,
CUDA activity) around a block and writes a chrome trace into ``dir``;
``annotate(name)`` names a range on that timeline
(``torch.profiler.record_function``); ``device_memory_stats()`` reads
the card's allocator counters under the JAX package's key names.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

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


def device_memory_stats(device=None) -> Optional[dict]:
    """The card's allocator counters as ``bytes_in_use``,
    ``peak_bytes_in_use`` and ``bytes_limit`` (the keys of the JAX
    package's ``memory_stats()``), or None without a card."""
    if not torch.cuda.is_available():
        return None
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(torch.cuda.get_device_properties(dev)
                               .total_memory)}
