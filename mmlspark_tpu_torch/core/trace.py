"""Request-scoped tracing: the port's copy of ``mmlspark_tpu/core/trace.py``.

trace_id/span_id spans, a tail-sampled ring buffer and the Chrome
trace-event export, on the host clock and independent of the device:

- a **Trace** is one causal unit (one HTTP request, one ``train()``)
  identified by a ``trace_id`` propagated end to end (HTTP ingress
  honors an incoming ``traceparent`` or ``X-Trace-Id`` header);
- a **Span** is one named interval inside a trace (``queue_wait``,
  ``decode``, ``device``, ``respond``; ``bin``/``boost_chunk``; ...)
  on the process-wide ``perf_counter`` clock, carrying attributes
  (model_version, rows, bucket, jit_cache_miss, ...);
- a micro-batch **joins** N request traces: the one device span is
  SHARED by every member trace and ``links`` back to each request's
  root span, so one device execution explains N requests;
- completed traces land in a bounded ring buffer with **tail
  sampling**: error traces and the slowest-percentile traces are
  always kept on a protected ring, the rest ride the main ring (and an
  optional ``sample_rate`` head-discards bulk traffic);
- the buffer exports **Chrome trace-event JSON** (one ``"X"`` complete
  event per span), viewable in Perfetto / chrome://tracing, served on
  ``/debug/traces``.

Spans are host intervals. CUDA work is asynchronous, so a span around a
launch ends when the launch is queued, not when the card finishes it;
the callers keep the reference's points of measurement and add no
synchronisation for a span's sake. A ``torch.profiler`` chrome trace
has its own time base: put the two on one timeline by a marker taken
on both clocks (``epoch_unix_s`` and ``_T0`` anchor this side) before
``merge_chrome_traces``.

Cross-process propagation: ``Tracer.inject(span)`` emits a
``traceparent``-style header (``00-<trace_id>-<span_id>-<flags>``) plus
the legacy ``X-Trace-Id`` alias, and ``Tracer.extract(headers)`` parses
either back into a ``TraceContext``; an ingress that extracts a context
continues the caller's trace as a child of the remote span.
``use_span``/``current_span`` hold the active span in a ``contextvars``
context, so the JSON log formatter (``core.logging_utils``) stamps
``trace_id`` on every record emitted inside a span.

Stdlib only, thread-safe, cheap enough for the per-request hot path:
ids come from a process prefix + an atomic counter, and the
tail-sampling threshold is recomputed every few dozen adds.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import random
import secrets
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

# monotonic epoch for exported timestamps: spans record perf_counter
# values; Chrome events export microseconds relative to this anchor so
# every span in a process shares one timeline
_T0 = time.perf_counter()
_T0_WALL = time.time()


def _now() -> float:
    return time.perf_counter()


# ---------------------------------------------------------------------------
# cross-process context propagation
# ---------------------------------------------------------------------------

# HTTP statuses that are EXPECTED back-pressure, not failures: load
# shedding (503) and tenant quotas (429). Traces for these mark
# shed=true instead of error so an overload can never flood the
# protected tail ring — the ONE definition both the serving ingress
# and the fleet client's root/leg verdicts classify against.
SHED_STATUSES = frozenset({429, 503})

# the propagation header (traceparent-style: version-traceid-spanid-flags)
TRACEPARENT_HEADER = "traceparent"
# legacy alias: carries the trace id only (no parent span), so old
# clients keep stitching by id while new ones parent
LEGACY_TRACE_HEADER = "X-Trace-Id"


class TraceContext:
    """An extracted remote trace context: the id to continue, the
    remote parent span to hang the local root under, and the sampled
    flag the caller advertised."""

    __slots__ = ("trace_id", "parent_id", "sampled")

    def __init__(self, trace_id: str, parent_id: Optional[str] = None,
                 sampled: bool = True):
        self.trace_id = str(trace_id)[:64]
        self.parent_id = (str(parent_id)[:64] if parent_id else None)
        self.sampled = bool(sampled)

    def __repr__(self) -> str:
        return (f"TraceContext({self.trace_id}, parent={self.parent_id},"
                f" sampled={self.sampled})")


def format_traceparent(trace_id: str, span_id: str,
                       sampled: bool = True) -> str:
    """``00-<trace_id>-<span_id>-<flags>``. Our span ids are hex (no
    dashes); trace ids may carry dashes when a legacy client supplied
    one — the parser tolerates that (span id and flags are the LAST two
    fields)."""
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def parse_traceparent(value: Any) -> Optional[TraceContext]:
    """Parse a traceparent-style header; None on anything malformed
    (the caller then falls back to the legacy header / a fresh root).
    Tolerant of dashes inside the trace-id field: the span id (ours:
    hex, dash-free) and flags are anchored from the right."""
    if not value:
        return None
    parts = str(value).strip().split("-")
    if len(parts) < 4:
        return None
    version, flags = parts[0], parts[-1]
    span_id = parts[-2]
    trace_id = "-".join(parts[1:-2])
    if len(version) != 2 or not _is_hex(version):
        return None
    if not trace_id or len(trace_id) > 64 or set(trace_id) == {"0"}:
        return None
    if not span_id or len(span_id) > 64 or not _is_hex(span_id):
        return None
    if len(flags) != 2 or not _is_hex(flags):
        return None
    sampled = bool(int(flags, 16) & 0x01)
    return TraceContext(trace_id, span_id, sampled)


def _is_hex(s: str) -> bool:
    try:
        int(s, 16)
    except ValueError:
        return False
    return True


def header_get(headers: Any, name: str) -> Optional[str]:
    """Case-insensitive header lookup over a dict OR an
    ``email.message``-style object (http.server's ``self.headers``)."""
    if headers is None:
        return None
    get = getattr(headers, "get", None)
    if get is not None:
        val = get(name)
        if val is not None:
            return val
    try:
        items = headers.items()
    except Exception:  # noqa: BLE001 — not a mapping
        return None
    low = name.lower()
    for k, v in items:
        if str(k).lower() == low:
            return v
    return None


def extract_context(headers: Any) -> Optional[TraceContext]:
    """The ingress side of propagation: ``traceparent`` wins; the
    legacy ``X-Trace-Id`` supplies an id-only context (same trace,
    fresh local root, kept as the alias)."""
    ctx = parse_traceparent(header_get(headers, TRACEPARENT_HEADER))
    if ctx is not None:
        return ctx
    legacy = header_get(headers, LEGACY_TRACE_HEADER)
    if legacy:
        return TraceContext(legacy)
    return None


# ---------------------------------------------------------------------------
# spans and traces
# ---------------------------------------------------------------------------


class Span:
    """One named interval in a trace. Mutated by at most one thread at
    a time in practice (the thread driving that pipeline stage);
    attribute stores are GIL-atomic, and readers (exporters) tolerate a
    span that is still open."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start",
                 "end", "attrs", "links", "status", "tid")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None,
                 start: Optional[float] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = _now() if start is None else float(start)
        self.end: Optional[float] = None
        self.attrs: Dict[str, Any] = {}
        # (trace_id, span_id) refs this span JOINS (batch-join): the one
        # micro-batch device span links every request span it serves
        self.links: List[Tuple[str, str]] = []
        self.status: str = "ok"
        self.tid = threading.get_ident()

    def set(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def link(self, trace_id: str, span_id: str) -> "Span":
        self.links.append((trace_id, span_id))
        return self

    def finish(self, end: Optional[float] = None) -> "Span":
        if self.end is None:
            self.end = _now() if end is None else float(end)
        return self

    def error(self, reason: Any = None) -> "Span":
        self.status = "error"
        if reason is not None:
            self.attrs["error"] = str(reason)
        return self

    @property
    def duration_ms(self) -> float:
        end = self.end if self.end is not None else self.start
        return max(0.0, (end - self.start) * 1e3)

    def to_event(self) -> Dict[str, Any]:
        """One Chrome trace-event ``"X"`` (complete) record, timestamps
        in microseconds on the process-relative timeline."""
        args: Dict[str, Any] = {"trace_id": self.trace_id,
                                "span_id": self.span_id}
        if self.parent_id:
            args["parent_id"] = self.parent_id
        if self.status != "ok":
            args["status"] = self.status
        if self.end is None:
            args["unfinished"] = True
        args.update(self.attrs)
        if self.links:
            args["links"] = [f"{t}/{s}" for t, s in self.links]
        return {
            "name": self.name,
            "cat": "mmlspark_tpu",
            "ph": "X",
            "ts": round((self.start - _T0) * 1e6, 3),
            "dur": round(self.duration_ms * 1e3, 3),
            "pid": os.getpid(),
            "tid": self.tid,
            "args": args,
        }

    def __repr__(self) -> str:  # debugging aid
        state = "open" if self.end is None else f"{self.duration_ms:.3f}ms"
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"id={self.span_id}, {state})")


class Trace:
    """One causal unit: a root span plus every span recorded under the
    same trace_id (including SHARED batch-join spans that also belong
    to sibling traces). Thread-safe add — batcher, worker, and handler
    threads all contribute spans."""

    __slots__ = ("trace_id", "root", "_spans", "_lock", "_finished")

    def __init__(self, trace_id: str, root: Span):
        self.trace_id = trace_id
        self.root = root
        self._spans: List[Span] = []
        self._lock = threading.Lock()
        self._finished = False

    def add(self, span: Span) -> Span:
        with self._lock:
            self._spans.append(span)
        return span

    def spans(self) -> List[Span]:
        with self._lock:
            return [self.root] + list(self._spans)

    @property
    def duration_ms(self) -> float:
        return self.root.duration_ms

    @property
    def is_error(self) -> bool:
        return self.status != "ok"

    @property
    def status(self) -> str:
        return self.root.status

    def __repr__(self) -> str:
        return (f"Trace({self.trace_id}, {self.root.name!r}, "
                f"{len(self.spans())} spans, {self.duration_ms:.3f}ms)")


# ---------------------------------------------------------------------------
# bounded ring buffer with tail sampling
# ---------------------------------------------------------------------------


class TraceBuffer:
    """Bounded store of completed traces.

    Two rings: the main ring holds recent traffic (head-sampled by
    ``sample_rate``), the protected ring holds traces tail sampling
    must never lose — errors, and anything slower than the rolling
    ``slow_percentile`` of recent durations. The threshold is
    recomputed every ``_RECALC`` adds, not per add, so the hot path
    pays an append and a compare."""

    _RECALC = 32

    def __init__(self, capacity: int = 256, protected: int = 0,
                 slow_percentile: float = 90.0, sample_rate: float = 1.0):
        capacity = max(1, int(capacity))
        self.capacity = capacity
        self.slow_percentile = float(slow_percentile)
        self.sample_rate = float(sample_rate)
        self._ring: "deque[Trace]" = deque(maxlen=capacity)
        self._protected: "deque[Trace]" = deque(
            maxlen=max(8, int(protected) or capacity // 4))
        self._durations: "deque[float]" = deque(maxlen=512)
        self._slow_threshold = float("inf")
        self._lock = threading.Lock()
        self.traces_added = 0
        self.traces_errors = 0
        self.traces_slow = 0
        self.traces_discarded = 0   # head-sampled away (sample_rate < 1)

    def add(self, trace: Trace) -> None:
        dur = trace.duration_ms
        err = trace.is_error
        with self._lock:
            self.traces_added += 1
            self._durations.append(dur)
            if self.traces_added % self._RECALC == 0:
                self._slow_threshold = self._percentile_locked()
            # STRICTLY greater: under a uniform duration distribution
            # the percentile value equals every sample, and >= would
            # flood the protected ring (evicting the error traces it
            # exists to keep)
            slow = dur > self._slow_threshold
            if err or slow:
                # tail sampling: errors and the slow tail always kept
                if err:
                    self.traces_errors += 1
                if slow:
                    self.traces_slow += 1
                self._protected.append(trace)
                return
            if self.sample_rate < 1.0 and \
                    random.random() >= self.sample_rate:
                self.traces_discarded += 1
                return
            self._ring.append(trace)

    def _percentile_locked(self) -> float:
        if len(self._durations) < self._RECALC:
            return float("inf")
        ordered = sorted(self._durations)
        idx = min(len(ordered) - 1,
                  int(self.slow_percentile / 100.0 * len(ordered)))
        return ordered[idx]

    def traces(self, limit: Optional[int] = None) -> List[Trace]:
        """Buffered traces, oldest first, protected + main merged
        (deduped — an error trace lives only on the protected ring)."""
        with self._lock:
            merged = list(self._protected) + list(self._ring)
        seen: set = set()
        out: List[Trace] = []
        for t in sorted(merged, key=lambda t: t.root.start):
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        if limit is not None and limit >= 0:
            # explicit empty for limit=0 (out[-0:] is the WHOLE list)
            out = out[-int(limit):] if limit > 0 else []
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._protected.clear()
            self._durations.clear()
            self._slow_threshold = float("inf")

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "buffered": len(self._ring) + len(self._protected),
                "protected": len(self._protected),
                "added": self.traces_added,
                "errors_kept": self.traces_errors,
                "slow_kept": self.traces_slow,
                "discarded": self.traces_discarded,
                "slow_threshold_ms": (
                    None if self._slow_threshold == float("inf")
                    else round(self._slow_threshold, 3)),
            }


# ---------------------------------------------------------------------------
# Chrome trace-event export
# ---------------------------------------------------------------------------


def to_chrome_trace(traces: Sequence[Trace],
                    process_name: Optional[str] = None) -> Dict[str, Any]:
    """Chrome trace-event JSON (the perfetto/chrome://tracing format):
    one complete ("X") event per span. Batch-join spans shared by N
    traces export ONCE (deduped by span_id) — their ``links`` arg names
    every request span they serve.

    ``process_name`` emits a ``process_name`` metadata ("M") event so
    Perfetto labels this process's track (e.g.
    ``engine http://127.0.0.1:18701 pid=4242``) — essential once
    exports from several engine processes are merged into one timeline
    (``merge_chrome_traces``)."""
    events: List[Dict[str, Any]] = []
    seen: set = set()
    for tr in traces:
        for span in tr.spans():
            if span.span_id in seen:
                continue
            seen.add(span.span_id)
            events.append(span.to_event())
    if process_name is not None and events:
        # label this process's track — but only when there is a track:
        # an empty export (tracing off) stays empty
        events.insert(0, {
            "name": "process_name", "ph": "M", "pid": os.getpid(),
            "tid": 0, "args": {"name": str(process_name)},
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "clock": "perf_counter, us since process trace epoch",
            "epoch_unix_s": round(_T0_WALL, 3),
            "pid": os.getpid(),
            "traces": len(traces),
        },
    }


def merge_chrome_traces(*payloads: Dict[str, Any]) -> Dict[str, Any]:
    """Merge several processes' Chrome exports into ONE payload: the
    cross-process reassembly step. Span ("X") events dedup by
    (pid, span_id) — the fleet client and an engine may both have
    buffered a shared trace — and ``process_name`` metadata dedups per
    pid, so Perfetto shows one labeled track group per process.

    Timestamps stay process-relative (each process's trace epoch is its
    own perf_counter zero); every export carries ``epoch_unix_s`` in
    ``otherData.epochs`` so tooling can re-anchor exactly. For the
    human reading a fan-out this is fine: parenting/links carry the
    causality, and legs within one process are exact."""
    events: List[Dict[str, Any]] = []
    seen_spans: set = set()
    seen_meta: set = set()
    epochs: Dict[str, Any] = {}
    for payload in payloads:
        if not payload:
            continue
        other = payload.get("otherData") or {}
        pid = other.get("pid")
        if pid is not None and "epoch_unix_s" in other:
            epochs[str(pid)] = other["epoch_unix_s"]
        for ev in payload.get("traceEvents", ()):
            if ev.get("ph") == "M":
                key = (ev.get("pid"), ev.get("name"),
                       str(ev.get("args")))
                if key in seen_meta:
                    continue
                seen_meta.add(key)
            else:
                args = ev.get("args") or {}
                key = (ev.get("pid"), args.get("span_id"))
                if key[1] is not None and key in seen_spans:
                    continue
                seen_spans.add(key)
            events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "clock": "perf_counter, us since each process's trace epoch",
            "epochs": epochs,
            "merged_from": len(payloads),
        },
    }


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------


class Tracer:
    """Factory for traces/spans + the buffer completed traces land in.

    ``enabled=False`` (or config ``trace.enabled`` false) turns the
    whole layer off; callers on the hot path guard with
    ``tracer.enabled`` / a ``None`` tracer so the disabled cost is one
    attribute check per request."""

    def __init__(self, enabled: Optional[bool] = None,
                 buffer: Optional[TraceBuffer] = None,
                 capacity: Optional[int] = None,
                 slow_percentile: Optional[float] = None,
                 sample_rate: Optional[float] = None):
        from mmlspark_tpu_torch.core import config
        if enabled is None:
            enabled = bool(config.get("trace.enabled", True))
        self.enabled = bool(enabled)
        if buffer is None:
            buffer = TraceBuffer(
                capacity=int(capacity if capacity is not None
                             else config.get("trace.capacity", 256)),
                slow_percentile=float(
                    slow_percentile if slow_percentile is not None
                    else config.get("trace.slow_percentile", 90.0)),
                sample_rate=float(
                    sample_rate if sample_rate is not None
                    else config.get("trace.sample_rate", 1.0)))
        self.buffer = buffer
        # ids: random process prefix + atomic counter — unique per
        # process (the routing scope) without a per-span urandom
        # syscall (the uuid4-was-2%-of-wall lesson from serving ids)
        self._prefix = secrets.token_hex(4)
        self._ids = itertools.count(1)

    def _next_id(self) -> str:
        return f"{self._prefix}{next(self._ids):08x}"

    # -- trace/span construction -------------------------------------------

    def new_trace(self, name: str,
                  trace_id: Optional[str] = None,
                  start: Optional[float] = None,
                  parent_id: Optional[str] = None) -> Trace:
        """A fresh trace with a started root span. ``trace_id`` honors
        an incoming propagation header (clamped to something sane);
        ``parent_id`` makes the root a CHILD of a remote span — the
        cross-process continuation: a serving ingress that extracted a
        ``TraceContext`` passes both, so its whole span tree hangs
        under the caller's client span instead of starting a second
        root in the same trace."""
        if trace_id:
            trace_id = str(trace_id)[:64]
        else:
            trace_id = self._next_id()
        root = Span(name, trace_id, self._next_id(),
                    parent_id=(str(parent_id)[:64] if parent_id
                               else None),
                    start=start)
        return Trace(trace_id, root)

    def continue_trace(self, name: str, ctx: Optional[TraceContext],
                       start: Optional[float] = None) -> Trace:
        """``new_trace`` from an extracted remote context (None context
        = fresh root — the no-propagation fallback in one call)."""
        if ctx is None:
            return self.new_trace(name, start=start)
        return self.new_trace(name, trace_id=ctx.trace_id, start=start,
                              parent_id=ctx.parent_id)

    # -- cross-process propagation ------------------------------------------

    def inject(self, span: Optional[Span]) -> Dict[str, str]:
        """The headers one outbound leg must carry so the remote
        process continues THIS span's trace as a child: the
        traceparent-style header plus the legacy ``X-Trace-Id`` alias
        (old engines stitch by id; new ones parent properly)."""
        if span is None:
            return {}
        return {
            TRACEPARENT_HEADER: format_traceparent(
                span.trace_id, span.span_id, sampled=self.enabled),
            LEGACY_TRACE_HEADER: span.trace_id,
        }

    @staticmethod
    def extract(headers: Any) -> Optional[TraceContext]:
        """Parse an incoming propagation context (``extract_context``
        as a method, for symmetry with ``inject``)."""
        return extract_context(headers)

    def start_span(self, name: str, trace: Trace,
                   parent: Optional[Span] = None,
                   start: Optional[float] = None) -> Span:
        parent = parent if parent is not None else trace.root
        span = Span(name, trace.trace_id, self._next_id(),
                    parent_id=parent.span_id if parent else None,
                    start=start)
        trace.add(span)
        return span

    def finish(self, trace: Trace, end: Optional[float] = None) -> None:
        """Finish the root (if still open) and buffer the trace —
        idempotent, so the single finalization point can sit on a path
        that multiple exits share."""
        if trace._finished:
            return
        trace._finished = True
        trace.root.finish(end)
        self.buffer.add(trace)

    def emit(self, name: str, start: float, end: Optional[float] = None,
             attrs: Optional[Dict[str, Any]] = None,
             trace: Optional[Trace] = None,
             parent: Optional[Span] = None) -> Optional[Span]:
        """Retroactive one-shot span from explicit timestamps: phase
        marks (GBDT bin/ship, AutoML featurize) become spans without
        restructuring the timed code. With ``trace`` the span lands
        there; without, it becomes a single-span trace of its own."""
        if not self.enabled:
            return None
        if trace is not None:
            span = self.start_span(name, trace, parent=parent,
                                   start=start)
            span.attrs.update(attrs or {})
            span.finish(end)
            return span
        tr = self.new_trace(name, start=start)
        tr.root.attrs.update(attrs or {})
        self.finish(tr, end)
        return tr.root

    @contextlib.contextmanager
    def trace_block(self, name: str,
                    attrs: Optional[Dict[str, Any]] = None,
                    ) -> Iterator[Optional[Trace]]:
        """Trace one code block (training-side convenience): yields the
        Trace (or None when disabled), finishes + buffers on exit, and
        holds the root as the current span for log correlation."""
        if not self.enabled:
            yield None
            return
        tr = self.new_trace(name)
        tr.root.attrs.update(attrs or {})
        try:
            with use_span(tr.root):
                yield tr
        except BaseException as e:
            tr.root.error(e)
            raise
        finally:
            self.finish(tr)


# ---------------------------------------------------------------------------
# current-span context (log correlation)
# ---------------------------------------------------------------------------

_current_span: "contextvars.ContextVar[Optional[Span]]" = \
    contextvars.ContextVar("mmlspark_tpu_torch_current_span", default=None)


def current_span() -> Optional[Span]:
    """The span active in this context, if any — the JSON log formatter
    reads it to stamp trace_id/model_version on records."""
    return _current_span.get()


@contextlib.contextmanager
def use_span(span: Optional[Span]) -> Iterator[Optional[Span]]:
    token = _current_span.set(span)
    try:
        yield span
    finally:
        _current_span.reset(token)


# ---------------------------------------------------------------------------
# process-global tracer
# ---------------------------------------------------------------------------

_global_tracer: Optional[Tracer] = None
_global_lock = threading.Lock()


def get_tracer() -> Tracer:
    """The process-wide tracer (training phases and default-constructed
    serving engines share it, so one buffer answers for the process)."""
    global _global_tracer
    if _global_tracer is None:
        with _global_lock:
            if _global_tracer is None:
                _global_tracer = Tracer()
    return _global_tracer


def set_tracer(tracer: Optional[Tracer]) -> None:
    """Swap the process-wide tracer (tests / embedders)."""
    global _global_tracer
    with _global_lock:
        _global_tracer = tracer
