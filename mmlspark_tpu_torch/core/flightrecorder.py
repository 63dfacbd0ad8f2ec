"""Always-on black-box flight recorder, bounded and self-dumping: the
port's copy of ``mmlspark_tpu/core/flightrecorder.py``.

When a chaos drill fails or a canary rolls back, the evidence — the
offending traces, the log lines around the decision, the windowed
metric series that crossed the threshold — is usually gone by the time
anyone looks: rings rotate, the process restarts, the scrape interval
missed the spike. This module is the serving plane's cockpit recorder:
a bounded, always-on collector that can snapshot everything it holds
into ONE self-contained JSON bundle, automatically, at the moment
something goes wrong.

What a bundle carries:

- **traces**: the tail-sampled trace buffer (protected ring included —
  the error/slow traces ARE the offenders) as Chrome trace-event JSON,
  Perfetto-loadable straight out of the bundle;
- **logs**: the last N ``mmlspark_tpu_torch.*`` log records (captured by a
  bounded ring handler attached at recorder construction — records are
  formatted at capture time, trace-correlated via the active span);
- **slo**: each attached SLO monitor's status (active alerts, windowed
  burn/error rates) plus its machine-readable recent time series;
- **events**: the last N lifecycle/zoo/alert events (SwapEvent /
  ZooEvent / AlertEvent — the registry timeline);
- **stats**: whatever stats sources were attached (engine metrics,
  fleet counters).

Auto-capture: ``trigger(reason)`` is RATE-LIMITED (one bundle per
``min_interval_s``; later triggers within the window are counted, not
captured) and keeps the last ``bundle_capacity`` bundles in memory. The
port's serving engine triggers on SLO alert fire, and
``CircuitBreaker.on_open`` can carry ``trigger`` (the reference also
triggers on swap rollback, which waits for the model lifecycle);
``/debug/bundle?confirm=1`` serves a fresh dump on demand. Everything is
bounded — an always-on recorder must never be the memory leak it exists
to debug.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from mmlspark_tpu_torch.core.logging_utils import get_logger

log = get_logger("flightrecorder")

_ROOT_LOGGER = "mmlspark_tpu_torch"


class _RingLogHandler(logging.Handler):
    """Bounded in-memory log capture. Records are rendered to plain
    dicts at emit time (message formatted, trace id resolved from the
    active span) so the ring holds no references to live args."""

    def __init__(self, capacity: int = 512):
        super().__init__(level=logging.DEBUG)
        self.ring: "deque[Dict[str, Any]]" = deque(
            maxlen=max(16, int(capacity)))

    def emit(self, record: logging.LogRecord) -> None:
        try:
            entry: Dict[str, Any] = {
                "ts": round(record.created, 6),
                "level": record.levelname,
                "logger": record.name,
                "msg": record.getMessage(),
            }
            try:
                from mmlspark_tpu_torch.core.trace import current_span
                span = current_span()
            except Exception:  # noqa: BLE001 — capture must never raise
                span = None
            if span is not None:
                entry["trace_id"] = span.trace_id
            if record.exc_info and record.exc_info[0] is not None:
                entry["exc"] = repr(record.exc_info[1])
            self.ring.append(entry)
        except Exception:  # noqa: BLE001 — the logging contract
            pass

    def snapshot(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        records = list(self.ring)
        if limit is not None and limit >= 0:
            records = records[-int(limit):] if limit > 0 else []
        return records


def _event_dict(event: Any) -> Dict[str, Any]:
    """A JSON-safe view of one timeline event (SwapEvent / ZooEvent /
    AlertEvent — duck-typed: public attrs + the repr)."""
    out: Dict[str, Any] = {"type": type(event).__name__,
                           "repr": repr(event)}
    for key in ("kind", "at", "from_version", "to_version", "reason",
                "model", "version", "alert_name", "slo", "rule",
                "burn_short", "burn_long"):
        val = getattr(event, key, None)
        if val is not None:
            out[key] = val
    # decision evidence rides along: SwapEvent carries the canary
    # numbers, the control-plane events (serving/controlplane.py) carry
    # the gate verdict — a quarantine bundle must be self-explanatory
    stats = getattr(event, "stats", None)
    if isinstance(stats, dict) and stats:
        out["stats"] = stats
    return out


class FlightRecorder:
    """The bounded black box (see module docstring).

    Sources attach by key so an engine can detach its hooks on
    ``stop()`` without disturbing other engines sharing the process
    recorder. All attach/detach is thread-safe; ``dump_bundle`` reads
    every source defensively (a sick source contributes an error
    string, never takes the dump down)."""

    def __init__(self, log_capacity: int = 512,
                 trace_limit: int = 64,
                 event_limit: int = 64,
                 bundle_capacity: int = 4,
                 min_interval_s: float = 30.0,
                 capture_logs: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        self.trace_limit = int(trace_limit)
        self.event_limit = int(event_limit)
        self.min_interval_s = float(min_interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._tracers: Dict[str, Any] = {}
        self._tracer_labels: Dict[str, Optional[str]] = {}
        self._slos: Dict[str, Any] = {}
        self._event_sources: Dict[str, Callable[[], List[Any]]] = {}
        self._stats_sources: Dict[str, Callable[[], Any]] = {}
        self.bundles: "deque[Dict[str, Any]]" = deque(
            maxlen=max(1, int(bundle_capacity)))
        self.triggers_seen = 0
        self.triggers_captured = 0
        self.triggers_rate_limited = 0
        self._last_capture = -float("inf")
        self._log_handler: Optional[_RingLogHandler] = None
        if capture_logs:
            self._log_handler = _RingLogHandler(log_capacity)
            logging.getLogger(_ROOT_LOGGER).addHandler(self._log_handler)

    # -- source wiring ------------------------------------------------------

    def attach_tracer(self, tracer: Any,
                      label: Optional[str] = None,
                      key: Optional[str] = None) -> None:
        """Attach under ``key`` (default: the tracer's identity) so a
        stopping engine can ``detach`` exactly its own attachment —
        engines SHARING one tracer attach it under their own keys, and
        the merged-export dedup collapses the duplicate spans."""
        if tracer is None:
            return
        key = key if key is not None else f"tracer:{id(tracer)}"
        with self._lock:
            self._tracers[key] = tracer
            self._tracer_labels[key] = label

    def attach_slo(self, key: str, monitor: Any) -> None:
        if monitor is None:
            return
        with self._lock:
            self._slos[str(key)] = monitor

    def add_event_source(self, key: str,
                         fn: Callable[[], List[Any]]) -> None:
        """``fn`` returns the (already-bounded) event list — e.g.
        ``lambda: engine.swap_events`` or ``lambda: zoo.events``."""
        with self._lock:
            self._event_sources[str(key)] = fn

    def add_stats_source(self, key: str, fn: Callable[[], Any]) -> None:
        with self._lock:
            self._stats_sources[str(key)] = fn

    def detach(self, key_prefix: str) -> None:
        """Drop every keyed source — tracers included — matching the
        prefix (an engine detaches ``engine@<addr>`` on stop, so a
        process-wide recorder never keeps a stopped engine reachable
        through stale closures). A key matches only exactly or at a
        ``:`` segment boundary: address strings can be prefixes of
        each other (``...:1890`` vs ``...:18900``) and stopping one
        engine must never strip a still-running one."""
        with self._lock:
            for table in (self._slos, self._event_sources,
                          self._stats_sources, self._tracers,
                          self._tracer_labels):
                for key in [k for k in table
                            if k == key_prefix
                            or k.startswith(key_prefix + ":")]:
                    table.pop(key, None)

    # -- capture ------------------------------------------------------------

    def dump_bundle(self, reason: str = "manual",
                    trace_limit: Optional[int] = None,
                    ) -> Dict[str, Any]:
        """One self-contained JSON-safe bundle of everything held."""
        from mmlspark_tpu_torch.core.trace import (
            merge_chrome_traces, to_chrome_trace,
        )
        limit = self.trace_limit if trace_limit is None \
            else int(trace_limit)
        with self._lock:
            tracers = [(t, self._tracer_labels.get(tid))
                       for tid, t in self._tracers.items()]
            slos = dict(self._slos)
            event_sources = dict(self._event_sources)
            stats_sources = dict(self._stats_sources)
        exports = []
        for tracer, label in tracers:
            try:
                exports.append(to_chrome_trace(
                    tracer.buffer.traces(limit), process_name=label))
            except Exception as e:  # noqa: BLE001 — partial bundle
                exports.append({"traceEvents": [],
                                "otherData": {"error": str(e)}})
        traces = (exports[0] if len(exports) == 1
                  else merge_chrome_traces(*exports))
        slo_out: Dict[str, Any] = {}
        for key, monitor in slos.items():
            try:
                slo_out[key] = {"status": monitor.status(),
                                "series": monitor.series()}
            except Exception as e:  # noqa: BLE001 — partial bundle
                slo_out[key] = {"error": str(e)}
        events: Dict[str, Any] = {}
        for key, fn in event_sources.items():
            try:
                events[key] = [_event_dict(e)
                               for e in list(fn())[-self.event_limit:]]
            except Exception as e:  # noqa: BLE001 — partial bundle
                events[key] = [{"error": str(e)}]
        stats: Dict[str, Any] = {}
        for key, fn in stats_sources.items():
            try:
                stats[key] = fn()
            except Exception as e:  # noqa: BLE001 — partial bundle
                stats[key] = {"error": str(e)}
        return {
            "bundle_version": 1,
            "reason": str(reason),
            "generated_at_unix_s": round(time.time(), 3),
            "traces": traces,
            "logs": (self._log_handler.snapshot()
                     if self._log_handler is not None else []),
            "slo": slo_out,
            "events": events,
            "stats": stats,
            "recorder": self.stats(),
        }

    def trigger(self, reason: str) -> Optional[threading.Thread]:
        """Auto-capture a bundle, rate-limited: at most one capture per
        ``min_interval_s`` (a breach storm must not turn the recorder
        into the load). The capture itself runs on a spawned DAEMON
        thread: triggers fire from latency-critical places — a breaker
        tripping inside a client request, the SLO tick on the serving
        batcher — and serializing the whole black box there would add
        the dump's wall time to exactly the request that just caught
        the failure. Returns the capture thread (join it to wait), or
        None when rate-limit-suppressed."""
        now = self._clock()
        with self._lock:
            self.triggers_seen += 1
            if now - self._last_capture < self.min_interval_s:
                self.triggers_rate_limited += 1
                return None
            self._last_capture = now
            self.triggers_captured += 1

        def capture():
            try:
                bundle = self.dump_bundle(reason=reason)
            except Exception as e:  # noqa: BLE001 — the recorder must
                # never take the triggering path (SLO eval, breaker
                # trip, swap rollback) down with it
                log.error("flight-recorder capture failed (%s): %s",
                          reason, e)
                return
            self.bundles.append(bundle)
            log.warning("flight-recorder bundle captured (%s): %d "
                        "trace events, %d log records", reason,
                        len(bundle["traces"].get("traceEvents", [])),
                        len(bundle["logs"]))

        t = threading.Thread(target=capture, daemon=True,
                             name="flightrecorder-capture")
        t.start()
        return t

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "bundles_held": len(self.bundles),
                "triggers_seen": self.triggers_seen,
                "triggers_captured": self.triggers_captured,
                "triggers_rate_limited": self.triggers_rate_limited,
                "tracers": len(self._tracers),
                "slos": list(self._slos),
                "event_sources": list(self._event_sources),
                "log_records": (len(self._log_handler.ring)
                                if self._log_handler is not None else 0),
            }

    def close(self) -> None:
        """Detach the log handler (tests / embedders replacing the
        process recorder)."""
        if self._log_handler is not None:
            logging.getLogger(_ROOT_LOGGER).removeHandler(
                self._log_handler)
            self._log_handler = None


# ---------------------------------------------------------------------------
# process-global recorder
# ---------------------------------------------------------------------------

_global_recorder: Optional[FlightRecorder] = None
_global_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    """The process-wide always-on recorder (default-constructed serving
    engines attach to it, so one bundle tells the whole process's
    story)."""
    global _global_recorder
    if _global_recorder is None:
        with _global_lock:
            if _global_recorder is None:
                _global_recorder = FlightRecorder()
    return _global_recorder


def set_recorder(recorder: Optional[FlightRecorder]) -> None:
    """Swap the process-wide recorder (tests / embedders). The old
    recorder's log handler is detached."""
    global _global_recorder
    with _global_lock:
        if _global_recorder is not None and \
                _global_recorder is not recorder:
            _global_recorder.close()
        _global_recorder = recorder
