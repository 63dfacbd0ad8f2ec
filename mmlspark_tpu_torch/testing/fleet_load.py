"""A fleet client in a spawned process, for load drills against engines
that serve in the calling process.

Clients that share the engines' interpreter lock distort every rate, so
``FleetLoad`` starts one spawned process (JAX blocked there; it imports
the port's fleet client and never touches CUDA) that keeps
``ServingFleet.connect(addresses, ...)`` clients and runs commands sent
from the parent:

- ``run(indices, n_threads, **connect_kw)`` POSTs ``{"features":
  rows[i]}`` for every ``i`` in ``indices`` from ``n_threads`` threads
  through one connected fleet per distinct ``connect_kw`` (an
  ``addresses`` entry there overrides the addresses the client was
  started with), and returns one record per request, ``(i, reply or
  None, t_sent, t_answered, error or None)`` on ``time.monotonic()``
  (system-wide on Linux, so comparable with the parent's clock), with
  the client's counters and breaker states. ``start_run`` / ``finish`` split it so the parent can
  act mid-load; ``progress`` counts answered requests meanwhile.
- ``traced_post(row, **connect_kw)`` POSTs one row under a client trace
  and returns its trace id and the client's Chrome trace export.

    load = FleetLoad(addresses, rows)
    load.start_run(range(4000), 16)
    ...                       # swap, kill, while the load runs
    records, stats = load.finish()
    load.close()
"""

from __future__ import annotations

import multiprocessing
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _client_main(addresses, rows, cmd_q, out_q, progress) -> None:
    sys.modules["jax"] = None
    import json
    from mmlspark_tpu_torch.core.trace import Tracer, to_chrome_trace
    from mmlspark_tpu_torch.serving.fleet import ServingFleet
    fleets: Dict[Tuple, Any] = {}

    def fleet_for(kw: Dict[str, Any]):
        kw = dict(kw)
        addrs = kw.pop("addresses", None) or addresses
        key = (tuple(addrs), tuple(sorted(kw.items())))
        if key not in fleets:
            fleets[key] = ServingFleet.connect(
                addrs, tracer=Tracer(enabled=True), **kw)
        return fleets[key]

    while True:
        cmd = cmd_q.get()
        if cmd is None:
            return
        kind, payload, kw = cmd
        fleet = fleet_for(kw)
        if kind == "traced_post":
            reply = fleet.post({"features": rows[payload]}, timeout=30)
            trace = [t for t in fleet.tracer.buffer.traces()
                     if t.root.name == "fleet.post"][-1]
            out_q.put((reply, trace.trace_id,
                       json.dumps(to_chrome_trace(
                           fleet.tracer.buffer.traces(),
                           process_name="fleet client"))))
            continue
        indices, n_threads, timeout = payload
        records: List[Any] = [None] * len(indices)
        cursor = iter(range(len(indices)))
        lock = threading.Lock()

        def client():
            while True:
                with lock:
                    k = next(cursor, None)
                if k is None:
                    return
                i = indices[k]
                t0 = time.monotonic()
                try:
                    reply = fleet.post({"features": rows[i]},
                                       timeout=timeout)
                    err = None
                except Exception as e:  # noqa: BLE001 — availability
                    reply, err = None, f"{type(e).__name__}: {e}"
                records[k] = (i, reply, t0, time.monotonic(), err)
                with progress.get_lock():
                    progress.value += 1

        threads = [threading.Thread(target=client)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = {"transport_errors": fleet.transport_errors,
                 "hedged_requests": fleet.hedged_requests,
                 "breakers": [b.state for b in fleet.breakers],
                 "breakers_opened": [b.times_opened
                                     for b in fleet.breakers]}
        out_q.put((records, stats))


class FleetLoad:
    """The parent's handle on the spawned client (module docstring).
    ``rows`` are the feature rows (lists of floats) requests carry."""

    def __init__(self, addresses: Sequence[str], rows):
        ctx = multiprocessing.get_context("spawn")
        self._cmd_q = ctx.Queue()
        self._out_q = ctx.Queue()
        self.progress = ctx.Value("l", 0)
        self._proc = ctx.Process(
            target=_client_main,
            args=(list(addresses), [list(map(float, r)) for r in rows],
                  self._cmd_q, self._out_q, self.progress), daemon=True)
        self._proc.start()

    def start_run(self, indices, n_threads: int, timeout: float = 10.0,
                  **connect_kw) -> None:
        with self.progress.get_lock():
            self.progress.value = 0
        self._cmd_q.put(("run", (list(indices), int(n_threads),
                                 float(timeout)), connect_kw))

    def wait_progress(self, n: int, timeout_s: float = 60.0) -> int:
        """Block until ``n`` requests of the running load are answered
        (or ``timeout_s``); returns the count reached."""
        deadline = time.monotonic() + timeout_s
        while self.progress.value < n and time.monotonic() < deadline:
            time.sleep(0.005)
        return self.progress.value

    def finish(self, timeout_s: float = 600.0
               ) -> Tuple[List[Any], Dict[str, Any]]:
        return self._out_q.get(timeout=timeout_s)

    def run(self, indices, n_threads: int, timeout: float = 10.0,
            **connect_kw) -> Tuple[List[Any], Dict[str, Any]]:
        self.start_run(indices, n_threads, timeout, **connect_kw)
        return self.finish()

    def traced_post(self, row: int, **connect_kw
                    ) -> Tuple[Any, str, str]:
        self._cmd_q.put(("traced_post", int(row), connect_kw))
        return self._out_q.get(timeout=120.0)

    def close(self) -> Optional[int]:
        """Stop the client process; returns its exit code."""
        self._cmd_q.put(None)
        self._proc.join(timeout=30)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join()
        return self._proc.exitcode
