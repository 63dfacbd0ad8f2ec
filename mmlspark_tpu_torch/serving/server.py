"""Serving engine: HTTP source/sink with reply-by-uuid routing.

The port's copy of ``mmlspark_tpu/serving/server.py`` (ref:
src/io/http/src/main/scala/HTTPSource.scala:48-178 single-node
source/sink; DistributedHTTPSource.scala:33-472 per-executor
JVMSharedServer with batch-indexed request routing and reply-by-uuid).

Design: each serving host runs one threaded HTTP server. Accepted
requests park their connection and enqueue (uuid, request-struct); the
serving engine drains the queue into DataTable micro-batches, runs the
user pipeline (whose heavy stages run on the card), and the sink answers
each row back through the SAME host's held connection — the
reply-routing invariant of the reference.

What the port keeps, as the reference has it: the adaptive
micro-batcher, the ``prepare_batch`` / ``execute_prepared`` split,
in-flight gating, per-row poison isolation, ``error_col``, codec
rejects, the supervisor, parked-table shedding with a live
``Retry-After``, ``/healthz`` and ``metrics()``, and the telemetry the
reference turns on by default:

- **Request tracing** (``core/trace.py``): each request's root span is
  continued from its ``traceparent`` (or ``X-Trace-Id``) header and
  answered with ``X-Trace-Id``; the batcher adds ``queue_wait`` per
  request and one shared ``decode`` span per batch, the worker one
  shared ``device`` span that links every request root it served, then
  a ``respond`` span per request. ``tracing`` overrides config
  ``trace.enabled``; ``tracer`` defaults to the process-wide one;
  ``tracing=False`` turns it off (the hot path then pays one attribute
  check). Spans are host intervals: the ``device`` span ends when the
  pipeline returns, which for the port's scorers is after the result
  has come back to the host.
- **The SLO monitor** (``core/slo.py``): one sample per answered
  request at the HTTP handler, a rate-gated burn-rate evaluation on the
  batcher tick, the status on ``/healthz`` and ``metrics()`` under
  ``slo``. ``slo=False`` turns it off; an ``SLOMonitor`` may be shared.
- **The flight recorder** (``core/flightrecorder.py``): the
  process-wide recorder by default; an SLO alert triggers a bundle, and
  ``stop()`` removes exactly the hooks this engine installed.
  ``flight_recorder=False`` turns it off.
- ``GET /metrics`` (Prometheus text, ``core/prometheus.py``),
  ``/debug/traces`` (chrome trace JSON, ``?limit=``) and
  ``/debug/bundle`` (``?confirm=1``) answer 200.

The versioned model lifecycle (``serving/lifecycle.py``) runs on the
engine as the reference runs it: every micro-batch carries the
``PipelineHandle`` it was built with, ``swap()`` warms the incoming
pipeline off the hot path, canaries a fraction of live batches through
it (a failing canary batch is re-executed whole on the stable handle),
cuts over with one attribute store and drains the old handle's
in-flight count. ``swap_state``, ``swaps_completed`` and
``swaps_rolled_back`` ride ``/healthz``, ``metrics()`` and ``/metrics``.
The embedder calls ``HTTPSource.get_batch`` / ``get_batch_adaptive`` and
``ServingEngine.process_one_batch``, and the chaos hook
``ServingEngine.kill``, are the reference's.

The multi-model plane is the reference's too. With a model zoo
(``zoo=``, ``serving/zoo.py``) the batcher is continuous and
model-routed: every drained request is routed by its ``X-Model`` header
(or ``/models/<name@version>`` path, or ``?model=`` query), checked by
the admission controller (``admission=``, ``serving/admission.py``:
tenant quotas answer 429, priority tiers shed 503, both with the live
``Retry-After``) and mapped through the variant selector's cached route
table (``variants=``, ``serving/variants.py``) into a per-model pending
group; groups dispatch oldest-first within priority as in-flight tokens
free, a batch never mixes models, and every reply echoes ``X-Model``.
Requests for a model that is still activating park until the zoo's
loader thread has it resident (or ``activation_timeout_s`` passes). The
batcher's rate-gated control tick runs ``zoo.enforce`` and
``variants.tick``; per-model latency feeds the zoo, the selector and the
SLO monitor's per-model streams, and the monitor's alert events land on
the zoo's timeline. ``metrics()`` carries ``zoo``, ``admission``,
``variants`` and ``rejections``; ``/metrics`` their families.

A ``ContinuousTrainer`` (``serving/controlplane.py``) attaches itself as
``engine.controlplane``: its status rides ``/healthz``'s
``controlplane`` field (a circuit-open or dead trainer degrades the
status but the reply stays 200) and its families render on
``/metrics``. A columnar request of Content-Type
``application/x-shm-columns`` carries only a control message that
points into a client's shared-memory ring (``io/shm.py``); one that
cannot attach (stale generation, dead segment) answers 400 for itself
alone, and the decode path unlinks segments whose owner process died.

- The handler sets ``TCP_NODELAY``: a reply's body no longer waits for
  the client's delayed ACK of its headers (same bytes, sooner).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import queue
import secrets
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.io.http import HTTPSchema, _jsonable as _to_jsonable

log = get_logger("serving")

def _request_id_factory():
    """Unique request ids without a per-request os.urandom syscall: one
    random process prefix + an atomic counter. Uniqueness holds per
    process, which is the reply-routing scope; the prefix keeps ids
    unguessable and distinct across engine restarts."""
    prefix = secrets.token_hex(8)
    counter = itertools.count()
    return lambda: f"{prefix}-{next(counter)}"


class SharedVariable:
    """Process-wide lazily-initialized shared value
    (ref: io/http SharedVariable.scala double-checked lazy singleton)."""

    def __init__(self, factory: Callable[[], Any]):
        self._factory = factory
        self._value = None
        self._have = False
        self._lock = threading.Lock()

    def get(self) -> Any:
        if not self._have:
            with self._lock:
                if not self._have:
                    self._value = self._factory()
                    self._have = True
        return self._value


class SharedSingleton:
    """Keyed process-wide singletons (ref: SharedSingleton.scala)."""

    _instances: Dict[str, Any] = {}
    _lock = threading.Lock()

    @classmethod
    def get_or_create(cls, key: str, factory: Callable[[], Any]) -> Any:
        with cls._lock:
            if key not in cls._instances:
                cls._instances[key] = factory()
            return cls._instances[key]


class _ParkedRequest:
    """A request whose connection is held open until respond()."""

    def __init__(self, rid: str, request_struct: Dict[str, Any]):
        self.id = rid
        self.request = request_struct
        self._event = threading.Event()
        self.response: Optional[Dict[str, Any]] = None
        # stamped at enqueue / at leaving the queue; their difference
        # is the queue-wait histogram sample (dequeue stamps are set by
        # drain_parked/top_up, the two exits from the source queue)
        self.enqueued_at: float = 0.0
        self.dequeued_at: float = 0.0
        # the request's Trace (core.trace) when the engine traces; the
        # handler thread is the single finalization point (success,
        # shed, timeout, client-gone — every exit buffers the trace)
        self.trace = None

    def respond(self, response: Dict[str, Any]) -> None:
        self.response = response
        self._event.set()

    def wait(self, timeout: float) -> Optional[Dict[str, Any]]:
        if self._event.wait(timeout):
            return self.response
        return None


class HTTPSource:
    """One host's HTTP server + request queue
    (ref: HTTPSource.scala:48-138; JVMSharedServer
    DistributedHTTPSource.scala:96-246 incl. port scanning and
    requestsSeen/Accepted counters). ``port=0`` asks the OS for a free
    port; ``address`` carries the bound one."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8899,
                 api_path: str = "/", max_queue: int = 10_000,
                 reply_timeout: float = 60.0, port_scan: int = 20,
                 max_parked: Optional[int] = None,
                 retry_after_s: int = 1):
        self.api_path = api_path
        self.queue: "queue.Queue[_ParkedRequest]" = queue.Queue(max_queue)
        self.requests_seen = 0
        self.requests_accepted = 0
        self.requests_answered = 0
        self.requests_rejected = 0
        # the parked-request table is BOUNDED: a stalled engine must shed
        # load with 503 + Retry-After, not hold thousands of connections
        # hostage until reply_timeout. Default bound = the queue bound.
        self.max_parked = max_parked if max_parked is not None else max_queue
        self.retry_after_s = max(1, int(retry_after_s))
        # closed sources must tell persistent (keep-alive) connections
        # to go away instead of parking requests into a dead engine
        self._closed = False
        # set by ServingEngine.start(): () -> bool engine liveness, and
        # () -> dict of latency-histogram summaries; /healthz folds both
        self.health_probe: Optional[Callable[[], bool]] = None
        self.metrics_probe: Optional[Callable[[], Dict[str, Any]]] = None
        # set by ServingEngine.start(): the engine's Tracer (ingress
        # creates each request's trace, honoring traceparent /
        # X-Trace-Id), the /debug/traces exporter, the /metrics
        # Prometheus renderer, the windowed SLO monitor (one sample per
        # answered request, status folded into /healthz) and the
        # flight-recorder bundle probe behind /debug/bundle
        self.tracer = None
        self.trace_probe: Optional[Callable[..., Dict[str, Any]]] = None
        self.prom_probe: Optional[Callable[[], str]] = None
        self.slo = None
        self.bundle_probe: Optional[Callable[..., Dict[str, Any]]] = None
        # set by ContinuousTrainer.start(): () -> control-loop status
        # dict (serving/controlplane.py); a degraded loop (circuit open
        # or dead trainer thread) degrades /healthz but stays HTTP 200
        # — training death must never take serving down
        self.controlplane_probe: Optional[
            Callable[[], Dict[str, Any]]] = None
        self._pending: Dict[str, _ParkedRequest] = {}
        self._lock = threading.Lock()
        self._new_rid = _request_id_factory()
        source = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: a client reuses its connection across
            # requests, so the per-request TCP handshake + server thread
            # spawn disappear from the hot path. Every reply path below
            # sends Content-Length, which 1.1 persistence requires.
            protocol_version = "HTTP/1.1"
            # idle persistent connections fold after this many seconds
            timeout = 20
            # a reply goes out as two sends (headers, then body); with
            # Nagle's algorithm on, the body waits for the client's
            # delayed ACK of the headers (up to 40 ms on Linux).
            # TCP_NODELAY sends it at once (the reference leaves Nagle
            # on; the bytes on the wire are the same)
            disable_nagle_algorithm = True

            def _send_json(self, code: int, payload: Dict[str, Any],
                           headers: Optional[Dict[str, str]] = None):
                body = json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _shed(self, reason: str):
                with source._lock:
                    source.requests_rejected += 1
                self._send_json(
                    503, {"error": reason,
                          "retry_after": source.retry_after_s},
                    {"Retry-After": str(source.retry_after_s)})

            def _send_text(self, code: int, text: str,
                           content_type: str = "text/plain"):
                body = text.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _query_limit(self):
                """``?limit=`` parsed strictly: (ok, value). A
                non-integer or negative limit is the CALLER's mistake
                and answers 400, not a full-buffer dump or a 500."""
                query = urllib.parse.parse_qs(
                    urllib.parse.urlsplit(self.path).query,
                    keep_blank_values=True)
                vals = query.get("limit")
                if vals is None:
                    return True, None
                try:
                    limit = int(vals[0])
                except (TypeError, ValueError):
                    return False, None
                if limit < 0:
                    return False, None
                return True, limit

            def _query_flag(self, name: str) -> bool:
                query = urllib.parse.parse_qs(
                    urllib.parse.urlsplit(self.path).query)
                vals = query.get(name)
                return bool(vals) and vals[0] not in ("0", "false", "")

            def _debug_json(self, probe, what: str,
                            needs_confirm: bool = False):
                """/debug/traces and /debug/bundle: strict ``?limit=``,
                and the bundle (multi-MB on a busy engine) only with
                ``?confirm=1``."""
                if probe is None:
                    self.send_error(404, f"no engine attached ({what})")
                    return
                ok, limit = self._query_limit()
                if not ok:
                    self._send_json(400, {
                        "error": "limit must be a non-negative integer"})
                    return
                if needs_confirm and not self._query_flag("confirm"):
                    self._send_json(400, {
                        "error": "bundle dumps are large; re-request"
                                 " with ?confirm=1"})
                    return
                try:
                    payload = probe(limit)
                except Exception as e:  # noqa: BLE001
                    self.send_error(500, f"{what} export: {e}")
                    return
                self._send_json(200, payload)

            def do_GET(self):  # noqa: N802 (http.server API)
                path_only = self.path.split("?", 1)[0].rstrip("/")
                if path_only == "/metrics":
                    if source.prom_probe is None:
                        self.send_error(
                            404, "no engine attached (metrics)")
                        return
                    try:
                        text = source.prom_probe()
                    except Exception as e:  # noqa: BLE001
                        self.send_error(500, f"metrics render: {e}")
                        return
                    from mmlspark_tpu_torch.core.prometheus import \
                        PROM_CONTENT_TYPE
                    self._send_text(200, text, PROM_CONTENT_TYPE)
                    return
                if path_only == "/debug/traces":
                    self._debug_json(source.trace_probe, "trace")
                    return
                if path_only == "/debug/bundle":
                    self._debug_json(source.bundle_probe, "bundle",
                                     needs_confirm=True)
                    return
                if path_only != "/healthz":
                    self.send_error(404, f"unknown path {path_only}")
                    return
                healthy = True
                if source.health_probe is not None:
                    try:
                        healthy = bool(source.health_probe())
                    except Exception:  # noqa: BLE001 — probe crash = sick
                        healthy = False
                metrics: Optional[Dict[str, Any]] = None
                if source.metrics_probe is not None:
                    try:  # outside source._lock — the probe takes its own
                        metrics = source.metrics_probe()
                    except Exception:  # noqa: BLE001 — stats stay partial
                        metrics = {"error": "metrics probe failed"}
                slo_status: Optional[Dict[str, Any]] = None
                if source.slo is not None:
                    try:
                        # a scrape-driven evaluation (tightly gated) so
                        # alert state is fresh even on an idle engine
                        source.slo.evaluate(min_interval_s=0.2)
                        slo_status = source.slo.status()
                    except Exception:  # noqa: BLE001 — stats stay partial
                        slo_status = {"error": "slo probe failed"}
                cp_status: Optional[Dict[str, Any]] = None
                if source.controlplane_probe is not None:
                    try:
                        cp_status = source.controlplane_probe()
                    except Exception:  # noqa: BLE001 — stats stay
                        cp_status = {"error": "controlplane probe "
                                              "failed",
                                     "degraded": True}
                # DEGRADED: alive and serving, but an SLO is burning or
                # the continuous-training loop is unhealthy (circuit
                # open / trainer thread dead — frozen-model serving) —
                # stays HTTP 200 (a degraded engine must keep taking
                # traffic; pulling it from the LB would turn a burn
                # into an outage) with the machine-readable verdict
                status = "ok" if healthy else "unhealthy"
                if healthy and slo_status is not None and \
                        slo_status.get("degraded"):
                    status = "degraded"
                if healthy and cp_status is not None and \
                        cp_status.get("degraded"):
                    status = "degraded"
                with source._lock:
                    stats = {
                        "status": status,
                        "seen": source.requests_seen,
                        "accepted": source.requests_accepted,
                        "answered": source.requests_answered,
                        "rejected": source.requests_rejected,
                        "parked": len(source._pending),
                        "queue_depth": source.queue.qsize(),
                    }
                if metrics is not None:
                    stats["metrics"] = metrics
                if slo_status is not None:
                    stats["slo"] = slo_status
                if cp_status is not None:
                    stats["controlplane"] = cp_status
                self._send_json(200 if healthy else 503, stats)

            def do_POST(self):  # noqa: N802 (http.server API)
                if source._closed:
                    # drain persistent connections of a closed source:
                    # shed with an EXPLICIT Connection: close so the
                    # client reconnects to whatever replaced us
                    with source._lock:
                        source.requests_rejected += 1
                    self._send_json(
                        503, {"error": "source closed", "retry_after": 1},
                        {"Retry-After": "1", "Connection": "close"})
                    return
                with source._lock:
                    source.requests_seen += 1
                t_req = time.perf_counter()
                path_only = self.path.split("?", 1)[0]
                if source.api_path not in ("/", "") and \
                        path_only.rstrip("/") != source.api_path.rstrip("/"):
                    self.send_error(404, f"unknown path {path_only}")
                    return
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else b""
                req = HTTPSchema.request(
                    self.path, "POST", body,
                    {k: v for k, v in self.headers.items()})
                parked = _ParkedRequest(source._new_rid(), req)
                tracer = source.tracer
                if tracer is not None and tracer.enabled:
                    # request-scoped trace: root span from ingress. A
                    # traceparent header (or the legacy X-Trace-Id
                    # alias) CONTINUES the caller's trace as a child of
                    # the remote client span. This handler is the
                    # single finalization point — every exit below
                    # buffers it.
                    ctx = tracer.extract(self.headers)
                    parked.trace = tracer.continue_trace("request", ctx)
                    parked.trace.root.set("path", self.path)
                    if ctx is not None and ctx.parent_id:
                        parked.trace.root.set("remote_parent", True)

                def _finalize(code: int) -> None:
                    # every exit records exactly one SLO sample: the
                    # caller-observed verdict (5xx = unavailability,
                    # shed 503s included) and wall latency
                    if source.slo is not None:
                        try:
                            source.slo.record(
                                code < 500,
                                (time.perf_counter() - t_req) * 1e3)
                        except Exception:  # noqa: BLE001 — best-effort
                            pass
                    tr = parked.trace
                    if tr is None:
                        return
                    from mmlspark_tpu_torch.core.trace import \
                        SHED_STATUSES
                    tr.root.set("http_status", code)
                    if code in SHED_STATUSES:
                        # load shedding is EXPECTED back-pressure, not
                        # a failure: error-marking it would let an
                        # overload flood the protected tail ring
                        tr.root.set("shed", True)
                    elif code >= 500:
                        tr.root.error()
                    tracer.finish(tr)

                with source._lock:
                    if len(source._pending) >= source.max_parked:
                        shed = True
                    else:
                        source._pending[parked.id] = parked
                        shed = False
                if shed:
                    self._shed("parked-request table full")
                    _finalize(503)
                    return
                parked.enqueued_at = time.perf_counter()
                try:
                    source.queue.put_nowait(parked)
                    with source._lock:
                        source.requests_accepted += 1
                except queue.Full:
                    with source._lock:
                        source._pending.pop(parked.id, None)
                    self._shed("queue full")
                    _finalize(503)
                    return
                resp = parked.wait(reply_timeout)
                with source._lock:
                    source._pending.pop(parked.id, None)
                try:
                    if resp is None:
                        self.send_error(504, "serving timeout")
                        _finalize(504)
                        return
                    code = resp["statusLine"]["statusCode"]
                    entity = resp.get("entity") or b""
                    if isinstance(entity, str):
                        entity = entity.encode("utf-8")
                    self.send_response(code)
                    # framing/hop-by-hop headers are computed by this
                    # server; forwarding pipeline-supplied ones would
                    # duplicate/conflict
                    _framing = {"content-length", "transfer-encoding",
                                "connection"}
                    sent_trace_id = False
                    for k, v in (resp.get("headers") or {}).items():
                        if k.lower() not in _framing:
                            if k.lower() == "x-trace-id":
                                sent_trace_id = True
                            self.send_header(k, v)
                    if parked.trace is not None and not sent_trace_id:
                        self.send_header("X-Trace-Id",
                                         parked.trace.trace_id)
                    self.send_header("Content-Length", str(len(entity)))
                    self.end_headers()
                    self.wfile.write(entity)
                except OSError:
                    # client gave up (timeout/disconnect) before the
                    # reply flushed: fold the connection quietly
                    if parked.trace is not None:
                        parked.trace.root.set("client_disconnected", True)
                    _finalize(499)
                    self.close_connection = True
                    return
                # trace and SLO sample first: a caller that polls
                # requests_answered then finds this request's telemetry
                _finalize(code)
                with source._lock:
                    source.requests_answered += 1

            def log_message(self, *a):  # silence default stderr logging
                pass

        class Server(ThreadingHTTPServer):
            request_queue_size = 128  # listen backlog for bursty clients
            daemon_threads = True

        last_err: Optional[Exception] = None
        for p in range(port, port + port_scan):
            try:
                self.server = Server((host, p), Handler)
                # read the BOUND port back from the socket: port=0 asks
                # the OS for an ephemeral port
                self.port = self.server.server_address[1]
                break
            except OSError as e:  # port taken — scan upward (ref :234)
                last_err = e
        else:
            raise OSError(f"no free port in [{port}, {port+port_scan}): "
                          f"{last_err}")
        self.address = f"http://{host}:{self.port}"
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()
        log.info("serving source listening on %s", self.address)

    def get_batch(self, max_rows: int = 64,
                  wait_s: float = 0.05) -> Tuple[DataTable, List[str]]:
        """Drain up to max_rows parked requests into a table
        (ref: HTTPSource.getBatch). Fixed-window poll — kept for the
        synchronous ``process_one_batch`` API; the engine's hot path is
        ``drain_parked``."""
        parked: List[_ParkedRequest] = []
        deadline = time.time() + wait_s
        while len(parked) < max_rows:
            remaining = deadline - time.time()
            if remaining <= 0 and parked:
                break
            try:
                parked.append(self.queue.get(
                    timeout=max(remaining, 0.001)))
            except queue.Empty:
                break
        if not parked:
            return DataTable({"id": [], "request": []}), []
        return (DataTable({"id": [p.id for p in parked],
                           "request": [p.request for p in parked]}),
                [p.id for p in parked])

    def drain_parked(self, max_rows: int, max_wait_s: float,
                     poll_s: float = 0.05) -> List[_ParkedRequest]:
        """Adaptive micro-batch drain (Clipper-style bounded queueing
        delay): block until the FIRST request arrives (bounded by
        ``poll_s`` so a stopping engine stays responsive), then flush as
        soon as EITHER ``max_rows`` rows are collected OR ``max_wait_s``
        has elapsed since that first request was picked up."""
        try:
            first = self.queue.get(timeout=poll_s)
        except queue.Empty:
            return []
        first.dequeued_at = time.perf_counter()
        parked: List[_ParkedRequest] = [first]
        deadline = first.dequeued_at + max_wait_s
        while len(parked) < max_rows:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                p = self.queue.get(timeout=remaining)
            except queue.Empty:
                break
            p.dequeued_at = time.perf_counter()
            parked.append(p)
        return parked

    def top_up(self, parked: List[_ParkedRequest],
               max_rows: int) -> bool:
        """Absorb whatever is ALREADY queued into a pending batch, up to
        ``max_rows`` — no waiting. Called by the batcher while it waits
        for an in-flight token: rows that arrived meanwhile ride along
        at zero added latency instead of forming a tiny trailing batch.
        Returns True when anything was taken."""
        took = False
        while len(parked) < max_rows:
            try:
                p = self.queue.get_nowait()
            except queue.Empty:
                break
            p.dequeued_at = time.perf_counter()
            parked.append(p)
            took = True
        return took

    def get_batch_adaptive(
            self, max_rows: int, max_wait_s: float,
            poll_s: float = 0.05,
    ) -> Tuple[DataTable, List[str], List[float]]:
        """``drain_parked`` packaged as (table, ids, queue-waits) for
        embedders that want the adaptive policy without managing parked
        requests themselves."""
        parked = self.drain_parked(max_rows, max_wait_s, poll_s)
        if not parked:
            return DataTable({"id": [], "request": []}), [], []
        return (DataTable({"id": [p.id for p in parked],
                           "request": [p.request for p in parked]}),
                [p.id for p in parked],
                [max(0.0, p.dequeued_at - p.enqueued_at)
                 for p in parked])

    def respond(self, rid: str, response: Dict[str, Any]) -> bool:
        """Reply through the held connection (ref:
        DistributedHTTPSource.scala:188 server.respond(batch, uuid, …))."""
        with self._lock:
            parked = self._pending.get(rid)
        if parked is None:
            return False
        parked.respond(response)
        return True

    def close(self) -> None:
        self._closed = True      # persistent connections shed + fold
        self.server.shutdown()
        self.server.server_close()


class _NoDefaultPipeline:
    """Placeholder active pipeline of a zoo-only engine (no default
    model): reaching it means a request bypassed the model-routing
    reject, which is a bug — fail loudly."""

    def transform(self, table):
        raise RuntimeError("engine has no default pipeline; requests "
                           "must name a model (X-Model header or "
                           "/models/<name@version> path)")


class PipelineHandle:
    """One immutable (pipeline, version) binding plus its in-flight
    batch count — the unit of the zero-downtime swap protocol. Every
    dispatched micro-batch carries the handle it was BUILT with, so a
    batch is always decoded, executed, retried, and answered by exactly
    one model version (the no-mixed-version-batch invariant), and a
    version's outstanding count reaching zero is the drain signal.

    ``controller`` and ``rescue_to`` are set only on canary handles by
    the lifecycle layer: canary batch outcomes feed the controller's
    breach detector, and a failing canary batch re-executes on
    ``rescue_to`` (the stable handle) so clients never eat a canary's
    faults.

    ``model_name``/``model_key`` are set only on zoo handles
    (serving/zoo.py): a model-routed batch carries the model identity
    through decode/execute/reply, so device spans and reply headers
    can audit exactly which ``name@version`` served each row."""

    __slots__ = ("pipeline", "version", "precision", "aot", "prepare",
                 "execute", "is_canary", "controller", "rescue_to",
                 "model_name", "model_key", "_outstanding", "_lock")

    def __init__(self, pipeline: Transformer, version: str,
                 is_canary: bool = False):
        from mmlspark_tpu_torch.core.quantize import stage_precision
        self.pipeline = pipeline
        self.version = str(version)
        # serving-precision + AOT labels, captured ONCE at handle build
        # (json_scoring_pipeline forwards them from the model): every
        # healthz/metrics/swap-audit surface reads the handle
        self.precision = stage_precision(pipeline)
        self.aot = bool(getattr(pipeline, "aot", False))
        # optional two-stage split (duck-typed; absent on plain stages)
        self.prepare = getattr(pipeline, "prepare_batch", None)
        self.execute = getattr(pipeline, "execute_prepared", None)
        self.is_canary = bool(is_canary)
        self.controller = None
        self.rescue_to: Optional["PipelineHandle"] = None
        self.model_name: Optional[str] = None
        self.model_key: Optional[str] = None
        self._outstanding = 0
        self._lock = threading.Lock()

    def acquire(self) -> None:
        with self._lock:
            self._outstanding += 1

    def release(self) -> None:
        with self._lock:
            self._outstanding -= 1

    @property
    def outstanding(self) -> int:
        with self._lock:
            return self._outstanding


class _BatchTraceCtx:
    """Per-micro-batch tracing context, riding the dispatch item from
    the batcher to the worker (and through per-row retries) so every
    stage lands spans on the right request traces.

    Batch-join semantics: ``batch_span`` creates ONE span that is
    shared by every member trace and ``links`` each request's root
    span — one decode/device span explains all N rows it served."""

    __slots__ = ("tracer", "traces", "by_rid", "primary", "roots",
                 "dispatched_at")

    def __init__(self, tracer, parked: List[_ParkedRequest]):
        self.tracer = tracer
        self.traces = []
        self.by_rid: Dict[str, Any] = {}
        self.roots = []
        # stamped when the batcher hands the item to the dispatch
        # queue; the FIRST device span starts here so the worker-wake
        # handoff is attributed instead of falling between spans
        self.dispatched_at: Optional[float] = None
        for p in parked:
            if p.trace is not None:
                self.traces.append(p.trace)
                self.by_rid[p.id] = p.trace
                self.roots.append(p.trace.root)
        self.primary = self.traces[0] if self.traces else None

    def batch_span(self, name: str, start: Optional[float] = None):
        if self.primary is None:
            return None
        span = self.tracer.start_span(name, self.primary,
                                      parent=self.primary.root,
                                      start=start)
        for root in self.roots:
            span.link(root.trace_id, root.span_id)
        for tr in self.traces[1:]:
            tr.add(span)
        return span

    def request_span(self, rid: str, name: str,
                     start: Optional[float] = None):
        tr = self.by_rid.get(rid)
        if tr is None:
            return None
        return self.tracer.start_span(name, tr, start=start)


class _PendingGroup:
    """One model's batch-in-formation on the continuous batcher:
    admitted requests accumulating toward ``batch_size`` rows or
    ``max_wait_ms`` age, whichever first. Groups form and dispatch
    independently per model — the continuous-batching unit."""

    __slots__ = ("reqs", "prio", "first_at")

    def __init__(self, prio: int, first_at: float):
        self.reqs: List[_ParkedRequest] = []
        self.prio = prio
        self.first_at = first_at


class ServingEngine:
    """The streaming loop: source → adaptive micro-batcher → user
    pipeline → sink (the structured-streaming query of ref:
    ServingImplicits.scala:10-50
    ``readStream.server()…writeStream.server()``).

    Request→device path (the serving hot path):

    1. **Adaptive micro-batcher** — one batcher thread drains the
       source queue, flushing a batch as soon as ``batch_size`` rows
       are collected OR ``max_wait_ms`` has elapsed since the batch's
       first request (bounded queueing delay; Clipper, NSDI'17).
    2. **Two-stage pipeline** — when the pipeline exposes the
       duck-typed ``prepare_batch``/``execute_prepared`` split (see
       ``json_scoring_pipeline``), the batcher ALSO runs the host
       decode stage before handing the batch to a worker through the
       dispatch queue, so the next batch's host work overlaps the
       current batch's device execution even at ``workers=1``.
    3. **Workers** — N threads pop prepared batches and drive the
       device + reply flush; ``workers > 1`` additionally overlaps one
       batch's device round trip with another's reply flush. CONTRACT:
       pipeline.transform must be thread-safe under workers > 1
       (TPUModel and the GBDT models are).

    The whole path is instrumented with latency histograms
    (queue-wait / decode / pipeline / respond, plus the model's own
    pad / device split) exported through ``metrics()``, /healthz and
    /metrics, with request traces, the SLO monitor and the flight
    recorder on by default (module docstring).
    """

    def __init__(self, source: HTTPSource,
                 pipeline: Optional[Transformer] = None,
                 reply_col: str = "reply", id_col: str = "id",
                 batch_size: int = 64,
                 content_type: str = "application/json",
                 error_col: str = "error", workers: int = 1,
                 max_wait_ms: float = 5.0, pipeline_depth: int = 2,
                 version: str = "v0", tracer=None,
                 tracing: Optional[bool] = None,
                 zoo=None, admission=None,
                 activation_timeout_s: float = 30.0,
                 zoo_enforce_interval_s: float = 1.0,
                 slo=None, flight_recorder=None,
                 slo_eval_interval_s: float = 0.25,
                 variants=None,
                 retry_after_max_s: float = 30.0):
        from mmlspark_tpu_torch.core import trace as trace_mod
        from mmlspark_tpu_torch.core.metrics import WindowedCounter, \
            histogram_set
        self.source = source
        # multi-model plane (serving/zoo.py + serving/admission.py):
        # with a zoo, requests carrying model=name@version route to
        # lazily-activated zoo handles; ``pipeline`` stays the default
        # for unkeyed requests (None = unkeyed requests answer 400)
        if pipeline is None and zoo is None:
            raise ValueError("ServingEngine needs a pipeline, a zoo, "
                             "or both")
        self.zoo = zoo
        self.admission = admission
        self.activation_timeout_s = float(activation_timeout_s)
        self._zoo_enforce_interval_s = float(zoo_enforce_interval_s)
        self._default_ok = pipeline is not None
        if pipeline is None:
            pipeline = _NoDefaultPipeline()
        # batcher-thread-only state: requests parked on a model that is
        # still activating (flushed by _poll_awaiting; bounded by the
        # source's parked-request table like every parked request)
        self._awaiting: Dict[str, List[_ParkedRequest]] = {}
        self._awaiting_since: Dict[str, float] = {}
        # SLO-adaptive variant routing (serving/variants.py): resolved
        # model keys pass through the selector's cached route table at
        # ingest; the selector's DECISION pass runs only on the
        # rate-gated batcher tick (enforced by check_adaptive_serving)
        self.variants = variants
        # continuous batcher state (batcher thread only): per-model
        # groups forming toward batch_size/max_wait_ms, plus the ready
        # lane of already-acquired chunks (cold-activation flushes)
        # waiting for an in-flight token. A slow model's group waiting
        # for a token never blocks another model's dispatch.
        self._pending: Dict[Optional[str], _PendingGroup] = {}
        self._ready: List[List[Any]] = []   # [prio, first_at, handle, reqs]
        # admission/routing rejections by reason (under _stats_lock):
        # quota, priority, no_model, unknown_model, load_failed,
        # activation_timeout, routing_error
        self.rejections: Dict[str, int] = {}
        # request tracing: ``tracing`` overrides config
        # ``trace.enabled``; the tracer (and so the completed-trace
        # buffer) defaults to the process-wide one, so training spans
        # land beside serving spans. ``self.tracer is None`` == tracing
        # off — the hot path pays one attribute check.
        if tracing is None:
            from mmlspark_tpu_torch.core import config as _config
            tracing = bool(_config.get("trace.enabled", True))
        self.tracer = (tracer if tracer is not None
                       else trace_mod.get_tracer()) if tracing else None
        if self.tracer is not None and not self.tracer.enabled:
            self.tracer = None
        # windowed SLO engine (core/slo.py): on by default. ``slo=False``
        # disables; pass an SLOMonitor to share/customize objectives.
        if slo is None:
            from mmlspark_tpu_torch.core.slo import SLOMonitor
            slo = SLOMonitor()
        elif slo is False:
            slo = None
        self.slo = slo
        self._slo_eval_interval_s = float(slo_eval_interval_s)
        # flight recorder (core/flightrecorder.py): the process-wide
        # recorder by default, so one bundle tells the whole process's
        # story. ``False`` disables.
        if flight_recorder is None:
            from mmlspark_tpu_torch.core.flightrecorder import get_recorder
            flight_recorder = get_recorder()
        elif flight_recorder is False:
            flight_recorder = None
        self.flight_recorder = flight_recorder
        # hooks THIS engine installs on the monitor are remembered so
        # stop() can uninstall exactly them: a shared SLOMonitor reused
        # by a later engine must not keep routing bundles to a stopped
        # engine's recorder
        self._slo_hooks_installed: List[str] = []
        if self.slo is not None and self.flight_recorder is not None \
                and self.slo.on_fire is None:
            # SLO breach => auto-captured post-mortem bundle
            # (rate-limited inside the recorder)
            rec = self.flight_recorder
            self.slo.on_fire = (
                lambda alert: rec.trigger(f"slo_breach:{alert.name}"))
            self._slo_hooks_installed.append("on_fire")
        if self.slo is not None and zoo is not None \
                and self.slo.record_event is None:
            # alert transitions land on the registry event timeline
            # next to SwapEvent/ZooEvent
            self.slo.record_event = zoo.record_event
            self._slo_hooks_installed.append("record_event")
        # dynamic Retry-After: shed replies quote the live backlog /
        # drain-rate estimate instead of a constant, clamped to
        # [1, retry_after_max_s]
        self.retry_after_max_s = max(1, int(retry_after_max_s))
        self._retry_after_s = self.source.retry_after_s
        self._drained_rows = WindowedCounter(bucket_s=1.0,
                                             horizon_s=120.0)
        self._retry_tick = 0.0
        # versioned pipeline binding: batches carry the handle they
        # were built with
        self._active = PipelineHandle(pipeline, version)
        self.reply_col = reply_col
        self.id_col = id_col
        self.batch_size = batch_size
        self.content_type = content_type
        self.error_col = error_col
        self.workers = max(1, int(workers))
        # batching policy: flush on batch_size rows OR max_wait_ms
        # elapsed since the batch's first request, whichever first
        self.max_wait_ms = float(max_wait_ms)
        # in-flight gating: at most workers + (pipeline_depth - 1)
        # batches past the batcher at once — every worker busy plus a
        # bounded run-ahead of prepared batches. While no token is
        # free (device saturated) the batcher keeps ABSORBING queued
        # requests into the pending batch, so occupancy rises exactly
        # when the device is the bottleneck.
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._inflight = threading.Semaphore(
            self.workers + self.pipeline_depth - 1)
        self._dispatch_q: "queue.Queue[Tuple]" = queue.Queue()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._batcher: Optional[threading.Thread] = None
        self._threads_lock = threading.Lock()
        self._supervisor: Optional[threading.Thread] = None
        self.batches_processed = 0
        self.workers_restarted = 0
        self._stats_lock = threading.Lock()
        self._killed = threading.Event()     # chaos kill: no restart
        # model lifecycle (serving/lifecycle.py): one swap at a time;
        # every writer of swap_state / the swap counters / _active holds
        # _stats_lock, so _lifecycle_snapshot reads them together
        self._swap_lock = threading.Lock()
        self._swap_ctl = None                # canary phase only
        self.swap_state = "idle"
        self.swaps_completed = 0
        self.swaps_rolled_back = 0
        self.swap_events: List[Any] = []
        self.hists = histogram_set("queue_wait_ms", "decode_ms",
                                   "pipeline_ms", "respond_ms",
                                   "batch_rows")

    # -- versioned pipeline access ------------------------------------------

    @property
    def pipeline(self) -> Transformer:
        """The currently-active pipeline."""
        return self._active.pipeline

    @pipeline.setter
    def pipeline(self, pipeline: Transformer) -> None:
        # raw override (tests / embeddings): rebind the active handle in
        # place, keeping the version tag
        with self._stats_lock:
            self._active = PipelineHandle(pipeline, self._active.version)

    @property
    def model_version(self) -> str:
        return self._active.version

    def _route(self) -> PipelineHandle:
        """Pick the handle for the NEXT micro-batch: the active version,
        except during a canary phase when the swap controller diverts
        its configured fraction of batches to the incoming version."""
        active = self._active
        swap_ctl = self._swap_ctl
        if swap_ctl is not None:
            try:
                return swap_ctl.route(active)
            except Exception:  # noqa: BLE001 — a sick controller must
                return active  # never take the serving path down
        return active

    def swap(self, pipeline: Transformer, version: str,
             warmup_example: Any = None, policy: Any = None):
        """Zero-downtime model swap: warm the incoming pipeline off the
        hot path, canary a fraction of live traffic through it, promote
        on a clean window or auto-roll-back on an error/latency breach.
        Blocks until the swap completes or rolls back; returns a
        ``SwapResult`` (see serving/lifecycle.py)."""
        from mmlspark_tpu_torch.serving.lifecycle import execute_swap
        return execute_swap(self, pipeline, version,
                            warmup_example=warmup_example, policy=policy)

    def _respond_ok(self, rid: str, rep: Any,
                    handle: Optional[PipelineHandle] = None) -> None:
        body = rep if isinstance(rep, (bytes, str)) \
            else json.dumps(_to_jsonable(rep))
        headers = {"Content-Type": self.content_type}
        if handle is not None and handle.model_key is not None:
            # model-routed replies echo the serving identity so a
            # client can audit that no reply ever crossed models
            headers["X-Model"] = handle.model_key
        self.source.respond(rid, HTTPSchema.response(
            200, "OK", body if isinstance(body, bytes)
            else body.encode("utf-8"), headers))

    def _finish_request_trace(self, tctx: Optional[_BatchTraceCtx],
                              rid: str, t_answer: float,
                              error: bool = False) -> None:
        """Trace bookkeeping for one reply, BEFORE the respond() event
        fires: a ``respond`` span covering wait-for-my-turn in the
        answer loop + this row's flush, then the root closes at
        reply-enqueue. All trace writes happen before the handler
        thread (which buffers the finished trace) can wake."""
        if tctx is None:
            return
        span = tctx.request_span(rid, "respond", start=t_answer)
        if span is None:
            return
        if error:
            span.error()
        span.finish()
        root = tctx.by_rid[rid].root
        if error:
            root.error()
        root.finish()

    def _answer_output(self, out: DataTable, ids: List[str],
                       tctx: Optional[_BatchTraceCtx] = None,
                       handle: Optional[PipelineHandle] = None) -> None:
        """Answer one transformed batch, splitting per-row errors: a
        non-null ``error_col`` value means that row failed and gets a
        500 while its batchmates still get their 200s
        (ref: SimpleHTTPTransformer.scala:104-150 error-split pipeline)."""
        t_answer = time.perf_counter()
        replies = out[self.reply_col]
        out_ids = out[self.id_col]
        errors = (out[self.error_col]
                  if self.error_col in out.column_names else None)
        # per-row 500s echo the model identity too: a client auditing
        # routing must be able to attribute EVERY reply, not just 200s
        err_headers = ({"X-Model": handle.model_key}
                       if handle is not None
                       and handle.model_key is not None else None)
        answered = set()
        for i, (rid, rep) in enumerate(zip(out_ids, replies)):
            err = errors[i] if errors is not None else None
            if err is not None and err == err:  # non-null, non-NaN
                self._finish_request_trace(tctx, rid, t_answer,
                                           error=True)
                self.source.respond(rid, HTTPSchema.response(
                    500, f"row error: {err}", None, err_headers))
            else:
                self._finish_request_trace(tctx, rid, t_answer)
                self._respond_ok(rid, rep, handle)
            answered.add(rid)
        for rid in ids:
            if rid not in answered:
                self._finish_request_trace(tctx, rid, t_answer,
                                           error=True)
                self.source.respond(rid, HTTPSchema.response(
                    500, "row dropped by pipeline", None, err_headers))

    def process_one_batch(self, wait_s: float = 0.05) -> int:
        """Synchronous one-shot drain (fixed poll window) — kept for
        embedding/tests; a started engine runs the adaptive
        batcher/worker pipeline instead."""
        table, ids = self.source.get_batch(self.batch_size, wait_s)
        if not ids:
            return 0
        self._execute_batch(table, ids, None, self._active)
        return len(ids)

    def _device_span(self, tctx: Optional[_BatchTraceCtx],
                     handle: PipelineHandle, rows: int):
        """The batch-join device span: ONE span shared by every request
        trace in the micro-batch, linking their root spans and carrying
        the model version, rows, bucket and first-run flag. Returns
        (span, miss_probe, misses_before)."""
        if tctx is None or tctx.primary is None:
            return None, None, None
        start = tctx.dispatched_at     # consumed once: a per-row retry
        tctx.dispatched_at = None      # re-run starts its span at now
        ds = tctx.batch_span("device", start=start)
        ds.set("model_version", handle.version)
        if handle.model_key is not None:
            ds.set("model", handle.model_key)
        ds.set("rows", rows)
        if handle.is_canary:
            ds.set("canary", True)
        state = self.swap_state
        if state != "idle":
            ds.set("swap_state", state)
        bucket_for = getattr(handle.pipeline, "bucket_for", None)
        if callable(bucket_for):
            try:
                ds.set("bucket", int(bucket_for(rows)))
            except Exception:  # noqa: BLE001 — annotation only
                pass
        miss_fn = getattr(handle.pipeline, "jit_cache_miss_count", None)
        miss0 = None
        if callable(miss_fn):
            try:
                miss0 = int(miss_fn())
            except Exception:  # noqa: BLE001 — annotation only
                miss_fn = None
        return ds, miss_fn, miss0

    def _execute_batch(self, table: DataTable, ids: List[str],
                       prepped: Any,
                       handle: Optional[PipelineHandle] = None,
                       tctx: Optional[_BatchTraceCtx] = None) -> None:
        """Stage 2 of the pipeline: device execution + reply flush for
        one micro-batch (``prepped`` carries stage 1's decode output
        when the pipeline supports the split). The whole batch runs on
        ``handle``'s pipeline version — retries and canary rescues
        included — so no reply batch ever mixes model versions. The
        ``device`` span is the active span while the pipeline runs, so
        its log lines carry the trace id."""
        from mmlspark_tpu_torch.core.trace import use_span
        if handle is None:
            handle = self._active
        # canary handles carry their controller; stable batches report
        # to whatever swap is in flight (the latency-delta baseline)
        ctl = handle.controller if handle.controller is not None \
            else self._swap_ctl
        ds, miss_fn, miss0 = self._device_span(tctx, handle, len(ids))
        span_ctx = use_span(ds) if ds is not None \
            else contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with span_ctx:
                if prepped is not None and handle.execute is not None:
                    out = handle.execute(table, prepped)
                else:
                    out = handle.pipeline.transform(table)
        except Exception as e:  # noqa: BLE001 — isolate the poison row(s)
            if ds is not None:
                ds.error(e).finish()
            if handle.is_canary and handle.rescue_to is not None:
                # a canary batch's faults are the SWAP's problem, not
                # the clients': record the strike and re-execute the
                # whole batch on the stable version (fresh decode — the
                # prepped payload may be the poisoned stage's output)
                log.warning("canary batch failed (%s); rescuing on %s",
                            e, handle.rescue_to.version)
                if ctl is not None:
                    ctl.observe(handle, ok=False, latency_ms=(
                        time.perf_counter() - t0) * 1e3, error=e)
                self._run_rescued(table, ids, handle.rescue_to, tctx)
                return
            log.warning("serving batch failed (%s); retrying per-row", e)
            if self.slo is not None and handle.model_key is not None:
                # per-model SLO stream (batch granularity): the failed
                # batch is this model's bad event even though per-row
                # retries may still answer some rows
                self.slo.record(False,
                                (time.perf_counter() - t0) * 1e3,
                                model=handle.model_key,
                                include_engine=False)
            self._process_rows_individually(table, ids, handle, tctx)
            with self._stats_lock:
                self.batches_processed += 1
            return
        dt_ms = (time.perf_counter() - t0) * 1e3
        if ds is not None:
            if miss_fn is not None:
                try:
                    ds.set("jit_cache_miss", bool(miss_fn() - miss0))
                except Exception:  # noqa: BLE001 — annotation only
                    pass
            ds.finish()
        if ctl is not None:
            # the controller discards row_errors for stable handles, so
            # only canary batches pay the error-column scan
            row_errors = (self._count_row_errors(out)
                          if handle.is_canary else 0)
            if (row_errors > 0 and handle.is_canary
                    and handle.rescue_to is not None):
                # row-level canary errors must not leak to clients
                # either: strike the canary, answer from stable. The
                # engine histogram is observed by the rescue run only —
                # one client batch, one pipeline_ms sample.
                ctl.observe(handle, ok=True, latency_ms=dt_ms,
                            row_errors=row_errors)
                self._run_rescued(table, ids, handle.rescue_to, tctx)
                return
            ctl.observe(handle, ok=True, latency_ms=dt_ms,
                        row_errors=row_errors)
        self.hists["pipeline_ms"].observe(dt_ms)
        if self.zoo is not None and handle.model_name is not None:
            # per-model latency (cardinality-capped — serving/zoo.py)
            self.zoo.observe_latency(handle.model_name, dt_ms)
        if self.slo is not None and handle.model_key is not None:
            # per-model SLO stream (engine-level totals come from the
            # HTTP handler; include_engine=False avoids double count)
            self.slo.record(True, dt_ms, model=handle.model_key,
                            include_engine=False)
        if self.variants is not None and handle.model_key is not None:
            # the selector's windowed latency/cost profile feed (O(1)
            # counter writes; decisions happen on the batcher tick)
            self.variants.observe(handle.model_key, dt_ms, len(ids))
        t1 = time.perf_counter()
        try:
            self._answer_output(out, ids, tctx, handle)
        except Exception as e:  # noqa: BLE001 — e.g. missing reply column
            log.warning("answering batch failed (%s); sending 500s", e)
            for rid in ids:
                self.source.respond(rid, HTTPSchema.response(
                    500, f"reply error: {e}", None))
        self.hists["respond_ms"].observe(
            (time.perf_counter() - t1) * 1e3)
        with self._stats_lock:
            self.batches_processed += 1

    def _run_rescued(self, table: DataTable, ids: List[str],
                     rescue: PipelineHandle,
                     tctx: Optional[_BatchTraceCtx] = None) -> None:
        """Re-execute a failed canary batch on the stable handle,
        COUNTED as in-flight on it: the swap's drain phase polls the
        old handle's outstanding count, so an untracked rescue could
        let the drain complete while this batch still runs on the old
        version. The trace context rides along — a rescued trace shows
        two device spans (the failed canary's and the stable rerun's)."""
        rescue.acquire()
        try:
            self._execute_batch(table, ids, None, rescue, tctx)
        finally:
            rescue.release()

    def _count_row_errors(self, out: DataTable) -> int:
        """Non-null error_col rows in a transformed batch (the canary
        controller counts them against the incoming version)."""
        if self.error_col not in out.column_names:
            return 0
        errs = out[self.error_col]
        return sum(1 for e in errs if e is not None and e == e)

    def _process_rows_individually(self, table: DataTable,
                                   ids: List[str],
                                   handle: Optional[PipelineHandle] = None,
                                   tctx: Optional[_BatchTraceCtx] = None,
                                   ) -> None:
        """Batch-failure fallback: run each row alone so one poison
        request cannot 500 its batchmates (the per-row half of the
        reference's error isolation, SimpleHTTPTransformer.scala:104-150).
        Each retried row gets its OWN device span (retry=true) on its
        trace — the poison row's trace shows the failed batch span AND
        its lone-row verdict."""
        if handle is None:
            handle = self._active
        requests = table["request"]
        for rid, req in zip(ids, requests):
            row = DataTable({"id": [rid], "request": [req]})
            span = tctx.request_span(rid, "device") if tctx is not None \
                else None
            if span is not None:
                span.set("model_version", handle.version)
                span.set("rows", 1)
                span.set("retry", True)
            try:
                out = handle.pipeline.transform(row)
                if span is not None:
                    span.finish()
                self._answer_output(out, [rid], tctx, handle)
            except Exception as e:  # noqa: BLE001
                if span is not None:
                    span.error(e).finish()
                self.source.respond(rid, HTTPSchema.response(
                    500, f"pipeline error: {e}", None))

    def _build_item(self, parked: List[_ParkedRequest],
                    handle: PipelineHandle) -> Optional[Tuple]:
        """Assemble + (optionally) decode one collected batch: the host
        half of the two-stage pipeline, run on the batcher thread.
        Tracing: each member request gets a ``queue_wait`` span
        (ingress enqueue → batch assembly, covering both the source
        queue AND the adaptive collect window) and the batch gets a
        shared ``decode`` span; both ride the returned item so the
        worker's device/respond spans land on the same traces."""
        table = DataTable({"id": [p.id for p in parked],
                           "request": [p.request for p in parked]})
        ids = [p.id for p in parked]
        tctx: Optional[_BatchTraceCtx] = None
        if self.tracer is not None:
            ctx = _BatchTraceCtx(self.tracer, parked)
            if ctx.primary is not None:
                tctx = ctx
                t_build = time.perf_counter()
                for p in parked:
                    if p.trace is not None:
                        self.tracer.start_span(
                            "queue_wait", p.trace,
                            start=p.enqueued_at).finish(t_build)
        prepped = None
        if handle.prepare is not None and handle.execute is not None:
            t0 = time.perf_counter()
            dspan = tctx.batch_span("decode", start=t0) \
                if tctx is not None else None
            if dspan is not None:
                dspan.set("rows", len(ids))
            try:
                prepped = handle.prepare(table)
                if dspan is not None:
                    codecs = getattr(prepped, "codecs", None)
                    if codecs:
                        dspan.set("codec", ",".join(sorted(codecs)))
                    dspan.finish()
                self.hists["decode_ms"].observe(
                    (time.perf_counter() - t0) * 1e3)
            except Exception as e:  # noqa: BLE001 — poison rows can die
                # in decode too: hand the batch over un-prepared so the
                # worker's per-row retry isolates the offender
                if dspan is not None:
                    dspan.error(e).finish()
                prepped = None
        # per-request codec rejects (columnar ingress, io/columnar.py):
        # a malformed or schema-mismatched body 400s exactly ITS
        # request — its trace finalizes as an error — while batch-mates
        # proceed to dispatch
        rejects = getattr(prepped, "rejects", None)
        if rejects:
            table, ids, tctx = self._apply_rejects(parked, table, ids,
                                                   rejects, tctx)
            if not ids:
                return None   # nothing survived decode — no dispatch
        if tctx is not None:
            tctx.dispatched_at = time.perf_counter()
        return table, ids, prepped, handle, tctx

    def _apply_rejects(self, parked: List[_ParkedRequest],
                       table: DataTable, ids: List[str],
                       rejects: Dict[str, str], tctx):
        """Answer 400 for every codec-rejected request (finalizing its
        trace with error=true) and return the filtered (table, ids,
        trace-context) the surviving batch dispatches with."""
        kept: List[_ParkedRequest] = []
        for p in parked:
            msg = rejects.get(p.id)
            if msg is None:
                kept.append(p)
                continue
            if p.trace is not None:
                p.trace.root.set("codec_error", msg)
                p.trace.root.error()
            self.source.respond(p.id, HTTPSchema.response(
                400, "bad request",
                json.dumps({"error": msg}).encode("utf-8"),
                {"Content-Type": "application/json"}))
        keep_idx = [i for i, rid in enumerate(ids) if rid not in rejects]
        ids = [ids[i] for i in keep_idx]
        table = table._take_indices(np.asarray(keep_idx, dtype=np.int64))
        new_tctx = None
        if self.tracer is not None and kept:
            ctx = _BatchTraceCtx(self.tracer, kept)
            if ctx.primary is not None:
                new_tctx = ctx
        return table, ids, new_tctx

    def _batcher_loop(self):
        """Stage 1 of the pipeline: adaptive collect + (optional) host
        decode, feeding the dispatch queue. While a worker drives the
        device for batch N, this thread is already collecting and
        decoding batch N+1. While no in-flight token is free (workers
        saturated), the pending batch keeps absorbing newly-queued
        requests up to batch_size, so batches grow toward full
        occupancy exactly when the device is the bottleneck.

        With a model zoo attached the plane is CONTINUOUS and
        MODEL-ROUTED (Orca-style iteration-level scheduling, OSDI'22,
        at micro-batch granularity): every loop turn drains whatever is
        queued RIGHT NOW into per-model pending groups (admission +
        variant routing at ingest), then ``_pump`` dispatches every
        group that is ready (full or aged past ``max_wait_ms``) for
        which an in-flight token is free — non-blocking, oldest-first
        within priority. A slow model's group waiting on a token never
        blocks another model's admission or dispatch, and newly parked
        requests join their model's next dispatch slot the moment a
        pipeline-depth token frees. Batches never mix models, and cold
        models activate on the zoo's loader thread while their requests
        park in ``_awaiting``."""
        while not self._stop.is_set():
            busy = bool(self._pending) or bool(self._ready) \
                or bool(self._awaiting)
            try:
                if self.zoo is not None and busy:
                    # continuous mode: absorb what is already queued
                    # (bounded poll so pending work keeps pumping),
                    # never block batch-formation on a full drain
                    parked = self.source.drain_parked(
                        self.batch_size, 0.0, poll_s=0.002)
                    if parked:
                        self.source.top_up(parked, self.batch_size)
                else:
                    parked = self.source.drain_parked(
                        self.batch_size, self.max_wait_ms / 1e3)
            except Exception as e:  # noqa: BLE001 — keep collecting
                log.error("serving batcher error (continuing): %s", e)
                time.sleep(0.005)
                continue
            if self.slo is not None:
                # burn-rate evaluation tick: the batcher is the one
                # thread that is always awake (drain polls 50 ms even
                # idle), so alerts fire DURING a burn and resolve
                # after recovery without waiting for a scrape
                try:
                    self.slo.evaluate(
                        min_interval_s=self._slo_eval_interval_s)
                except Exception as e:  # noqa: BLE001 — keep serving
                    log.error("slo evaluate failed (continuing): %s", e)
            self._update_retry_after()
            if self.zoo is None:
                if parked:
                    self._dispatch_parked(parked)
                continue
            try:
                self._ingest(parked)
            except Exception as e:  # noqa: BLE001 — keep collecting
                # per-request rejects answer inside _ingest; a fault
                # here strands at most this drain's unrouted requests
                # on their reply timeout — the loop must keep serving
                log.error("request ingest failed (continuing): %s", e)
            try:
                now = time.perf_counter()
                for handle, chunk, prio in self._poll_awaiting():
                    # cold-activation flushes arrive pre-acquired and
                    # chunked; they queue in the ready lane stamped
                    # with their oldest member's dequeue time so the
                    # oldest-first pump ranks them fairly
                    self._ready.append(
                        [prio, min((p.dequeued_at for p in chunk),
                                   default=now), handle, chunk])
            except Exception as e:  # noqa: BLE001 — keep collecting
                log.error("awaiting poll failed (continuing): %s", e)
            try:
                # LRU eviction under memory pressure, rate-gated: the
                # batcher is the one thread that is always awake while
                # traffic flows (the loader also enforces after loads)
                self.zoo.enforce(
                    min_interval_s=self._zoo_enforce_interval_s)
            except Exception as e:  # noqa: BLE001 — eviction is
                # best-effort here; the loader's post-load enforce
                # and the next tick retry
                log.error("zoo enforce failed (continuing): %s", e)
            if self.variants is not None:
                # the variant plane's DECISION tick (rate-gated
                # inside the selector): profiles + burn alerts +
                # queue pressure in, a fresh cached route table out.
                # This is the ONLY place selection runs — never in
                # the HTTP handler (check_adaptive_serving).
                try:
                    self.variants.tick(pressure=self._pressure())
                except Exception as e:  # noqa: BLE001 — routing
                    # falls back to the last cached table
                    log.error("variant tick failed (continuing): %s",
                              e)
            try:
                self._pump()
            except Exception as e:  # noqa: BLE001 — keep collecting
                log.error("dispatch pump failed (continuing): %s", e)

    def _ingest(self, parked: List[_ParkedRequest]) -> None:
        """Admission-check + model-route newly drained requests into
        their per-model pending groups (batcher thread only). Routing
        happens BEFORE admission so unroutable requests answer 400/404
        without spending quota tokens; the variant selector's cached
        route table is applied here, once per request, as a dict
        lookup. Groups hold a zoo waiter for their key so a model with
        admitted-but-undispatched demand is never an eviction victim."""
        if not parked:
            return
        from mmlspark_tpu_torch.serving.admission import request_identity
        from mmlspark_tpu_torch.serving.zoo import model_key_of
        # one pressure sample per drained batch: the batcher is the
        # only consumer of both queues, so it cannot meaningfully
        # change within one ingest pass — no per-request qsize()
        pressure = self._pressure() if self.admission is not None else 0
        now = time.perf_counter()
        for p in parked:
            key = model_key_of(p.request)
            if key is None and not self._default_ok:
                self._reject_parked(
                    p, 400, "no_model",
                    "no model specified: set X-Model or POST "
                    "/models/<name@version>")
                continue
            if key is not None:
                # resolving here also merges bare-name and
                # name@latest requests into ONE dispatch group
                resolved = self.zoo.resolve(key)
                if resolved is None:
                    self._reject_parked(
                        p, 404, "unknown_model",
                        f"unknown model {key!r}; registered: "
                        f"{self.zoo.names_preview()}")
                    continue
                key = resolved
                if self.variants is not None:
                    # cached table read (O(1)); the reply's X-Model
                    # echoes the variant that actually served
                    key = self.variants.route(key)
            tenant, priority = request_identity(p.request)
            if self.admission is not None:
                verdict = self.admission.decide(tenant, priority,
                                                pressure)
                if verdict == "quota":
                    self._reject_parked(
                        p, 429, "quota",
                        f"tenant {tenant!r} over quota",
                        {"Retry-After": self._retry_header()})
                    continue
                if verdict == "priority":
                    self._reject_parked(
                        p, 503, "priority",
                        f"shed: engine saturated (priority {priority})",
                        {"Retry-After": self._retry_header()})
                    continue
            grp = self._pending.get(key)
            if grp is None:
                grp = _PendingGroup(priority, now)
                self._pending[key] = grp
                if key is not None:
                    # parked demand must survive until dispatch (the
                    # _awaiting discipline): without the hold, demand
                    # > capacity livelocks on load/evict/reload
                    self.zoo.add_waiter(key)
            grp.reqs.append(p)
            grp.prio = min(grp.prio, priority)

    def _drop_pending(self, key: Optional[str]) -> None:
        """Forget one pending group and release its zoo waiter hold."""
        self._pending.pop(key, None)
        if key is not None:
            self.zoo.remove_waiter(key)

    def _pump(self) -> None:
        """Dispatch every READY unit an in-flight token can cover,
        oldest-first within priority (batcher thread only). Units are
        ready-lane chunks (always dispatchable: handle in hand) and
        pending groups that are full or older than ``max_wait_ms``.
        The token acquire is NON-blocking: when the device is
        saturated the pump returns and groups keep absorbing arrivals
        — back-pressure becomes batch occupancy, exactly like the old
        top-up loop, but per model. Oldest-first ordering is the
        fairness bound: a continuously-fed hot model re-forms its
        group with a FRESH first_at after every dispatch, so a colder
        group's older timestamp wins the next free token — no group
        waits more than one token-release cycle behind hot traffic."""
        max_wait_s = self.max_wait_ms / 1e3
        while not self._stop.is_set():
            now = time.perf_counter()
            pick_ready = -1
            pick_key: Optional[str] = None
            best: Optional[Tuple[int, float]] = None
            for i, entry in enumerate(self._ready):
                rank = (entry[0], entry[1])
                if best is None or rank < best:
                    best, pick_ready, pick_key = rank, i, None
            for key, grp in self._pending.items():
                if len(grp.reqs) < self.batch_size \
                        and now - grp.first_at < max_wait_s:
                    continue        # still forming
                rank = (grp.prio, grp.first_at)
                if best is None or rank < best:
                    best, pick_ready, pick_key = rank, -1, key
            if best is None:
                return              # nothing ready
            if not self._inflight.acquire(blocking=False):
                return              # saturated: groups keep absorbing
            if pick_ready >= 0:
                entry = self._ready.pop(pick_ready)
                self._dispatch_now(entry[3], entry[2])
                continue
            grp = self._pending[pick_key]
            if pick_key is None:
                # default-pipeline group: version routing + handle
                # acquisition happen inside _dispatch_now
                chunk = grp.reqs[:self.batch_size]
                del grp.reqs[:self.batch_size]
                if grp.reqs:
                    grp.first_at = grp.reqs[0].dequeued_at
                else:
                    self._drop_pending(None)
                self._dispatch_now(chunk, None)
                continue
            try:
                handle, state, msg = self.zoo.acquire(pick_key)
            except Exception as e:  # noqa: BLE001 — e.g. the loader
                # thread failing to spawn; this group answers alone,
                # other groups (and the batcher) keep going
                self._inflight.release()
                for p in grp.reqs:
                    self._reject_parked(
                        p, 500, "routing_error",
                        f"model routing error for {pick_key!r}: {e}")
                self._drop_pending(pick_key)
                continue
            if state == "resident":
                chunk = grp.reqs[:self.batch_size]
                del grp.reqs[:self.batch_size]
                if grp.reqs:
                    grp.first_at = grp.reqs[0].dequeued_at
                else:
                    self._drop_pending(pick_key)
                self._dispatch_now(chunk, handle)
                continue
            self._inflight.release()    # no dispatch on this path
            if state == "loading":
                # hand the whole group to the awaiting table (its own
                # waiter hold + activation timeout); drop ours AFTER
                # so the model is never transiently waiter-free
                self._enqueue_awaiting(pick_key, grp.reqs)
                self._pending.pop(pick_key, None)
                self.zoo.remove_waiter(pick_key)
            elif state == "failed":
                for p in grp.reqs:
                    self._reject_parked(
                        p, 503, "load_failed",
                        f"model {pick_key!r} failed to load: {msg}",
                        {"Retry-After": self._retry_header(floor=5)})
                self._drop_pending(pick_key)
            else:   # unknown (e.g. deregistered while pending)
                for p in grp.reqs:
                    self._reject_parked(p, 404, "unknown_model", msg)
                self._drop_pending(pick_key)

    def _dispatch_now(self, parked: List[_ParkedRequest],
                      handle: Optional[PipelineHandle]) -> None:
        """Assemble + dispatch ONE micro-batch whose in-flight token is
        ALREADY held (the pump acquired it non-blocking). ``handle`` is
        None for the default (single-model) path — version routing and
        acquisition happen here — or a zoo handle that arrives ALREADY
        acquired (zoo.acquire bumps outstanding under the registry
        lock, atomically with the eviction scan)."""
        # token ownership transfers to the worker ONLY on a
        # successful put; any other exit (assembly failure, a
        # respond() error, a BaseException killing this thread)
        # must give it back, or each incident would permanently
        # shrink the engine's dispatch budget
        handed_off = False
        try:
            if handle is None:
                # version routing happens HERE, once per batch: the
                # handle rides with the item so decode, execution,
                # retries, and replies all use one model version.
                # acquire() BEFORE any other work, then re-check the
                # active handle: a cutover landing between route and
                # acquire would otherwise let the swap's drain poll
                # read outstanding==0 while this batch is still headed
                # for the old version.
                handle = self._route()
                handle.acquire()
                if not handle.is_canary and handle is not self._active:
                    handle.release()
                    handle = self._active   # stale route: follow cutover
                    handle.acquire()
            try:
                item = self._build_item(parked, handle)
            except Exception as e:  # noqa: BLE001
                log.error("batch assembly failed (%s); "
                          "dropping to 500s", e)
                for p in parked:
                    self.source.respond(p.id, HTTPSchema.response(
                        500, f"batch assembly error: {e}", None))
                return
            if item is None:
                # every request in the batch was codec-rejected
                # (each already answered 400); nothing to dispatch
                return
            self._dispatch_q.put(item)   # unbounded: tokens bound it
            handed_off = True
        finally:
            if not handed_off:
                # both the in-flight token AND the version handle
                # must come back on any non-dispatch exit
                if handle is not None:
                    handle.release()
                self._inflight.release()
        self._drained_rows.inc(len(parked))
        for p in parked:
            # dequeue stamp, not dispatch time: queue_wait must not
            # absorb the token wait or the decode stage (decode_ms
            # measures that) — the breakdown stays additive
            self.hists["queue_wait_ms"].observe(
                max(0.0, p.dequeued_at - p.enqueued_at) * 1e3)
        self.hists["batch_rows"].observe(float(len(parked)))

    def _dispatch_parked(self, parked: List[_ParkedRequest],
                         handle: Optional[PipelineHandle] = None) -> None:
        """Token-gate + assemble + dispatch ONE micro-batch (the
        single-model path; zoo engines go through the continuous
        ``_pump``). Waits for an in-flight token, topping the pending
        batch up from the queue meanwhile: back-pressure converts
        directly into batch occupancy instead of tiny trailing
        batches."""
        granted = False
        while not self._stop.is_set():
            if self._inflight.acquire(timeout=0.005):
                granted = True
                break
            if self.zoo is None and len(parked) < self.batch_size:
                try:
                    self.source.top_up(parked, self.batch_size)
                except Exception:  # noqa: BLE001 — source closing
                    pass
        if not granted:              # stopping — parked requests will
            if handle is not None:   # run out their reply timeout, but
                handle.release()     # the zoo handle must drain
            return
        self._dispatch_now(parked, handle)

    # -- model routing + admission (zoo engines; batcher thread only) -------

    def _pressure(self) -> int:
        """The admission layer's saturation signal: prepared batches
        queued behind busy workers PLUS requests backed up in the
        source queue PLUS the continuous batcher's admitted-but-
        undispatched backlog (pending groups + the ready lane). The
        dispatch queue alone is bounded by the in-flight token count
        (workers + pipeline_depth - 1, typically 2-3), which would
        leave the default tier limits unreachable; and the continuous
        batcher drains the source queue eagerly, so WITHOUT the
        pending/ready terms overload would hide in groups the old
        queue-depth signal never saw."""
        pressure = self._dispatch_q.qsize()
        try:
            pressure += self.source.queue.qsize()
        except Exception:  # noqa: BLE001 — source closing
            pass
        pressure += sum(len(g.reqs) for g in self._pending.values())
        pressure += sum(len(entry[3]) for entry in self._ready)
        return pressure

    def _retry_header(self, floor: int = 1) -> str:
        """The current drain-estimate Retry-After (seconds, as the
        header string) for shed replies; ``floor`` lifts paths with a
        known longer horizon (e.g. a failed load's retry window)."""
        return str(max(int(floor), self._retry_after_s))

    def _update_retry_after(self, now: Optional[float] = None) -> None:
        """Re-derive Retry-After from the live backlog / windowed
        drain rate (rate-gated; batcher thread). Shed replies then
        tell backoff-honoring clients when capacity should actually
        exist — backlog/rate seconds, clamped to [1,
        retry_after_max_s] — instead of a constant 1 s that invites
        an immediate re-stampede under a deep queue."""
        t = time.monotonic() if now is None else now
        if t - self._retry_tick < 0.5:
            return
        self._retry_tick = t
        backlog = self._pressure()
        if backlog <= 0:
            est = 1.0
        else:
            rate = self._drained_rows.rate(10.0)    # rows/s
            est = (backlog / rate) if rate > 0 \
                else float(self.retry_after_max_s)
        self._retry_after_s = int(
            min(max(1.0, math.ceil(est)), self.retry_after_max_s))
        # the HTTP handler's 503-shed path reads the source attribute
        self.source.retry_after_s = self._retry_after_s

    def _reject_parked(self, p: _ParkedRequest, code: int, reason: str,
                       message: str,
                       headers: Optional[Dict[str, str]] = None) -> None:
        """Answer one request rejected by admission/model routing,
        counting it by reason (``serving_admission_rejected_total``)."""
        with self._stats_lock:
            self.rejections[reason] = self.rejections.get(reason, 0) + 1
        if p.trace is not None:
            p.trace.root.set("rejected", reason)
        self.source.respond(p.id, HTTPSchema.response(
            code, message,
            json.dumps({"error": message}).encode("utf-8"),
            {"Content-Type": "application/json", **(headers or {})}))

    def _enqueue_awaiting(self, key: str,
                          group: List[_ParkedRequest]) -> None:
        lst = self._awaiting.setdefault(key, [])
        if not lst:
            self._awaiting_since[key] = time.monotonic()
            # register the parked demand with the zoo: an awaited
            # model must survive from activation to our flush poll,
            # or demand > capacity livelocks (load, evict before the
            # flush, reload, starve — see ModelZoo.add_waiter)
            self.zoo.add_waiter(key)
        lst.extend(group)

    def _drop_awaiting(self, key: str) -> None:
        """Forget a parked key (flushed or rejected) and release its
        zoo waiter hold so the model becomes evictable again."""
        self._awaiting.pop(key, None)
        self._awaiting_since.pop(key, None)
        self.zoo.remove_waiter(key)

    def _poll_awaiting(self) -> List[Tuple]:
        """Flush requests parked on cold models: activated models come
        back as dispatch groups (chunked to ``batch_size`` — every
        chunk gets its own acquired handle), failed/overdue activations
        answer 503."""
        if not self._awaiting:
            return []
        from mmlspark_tpu_torch.serving.admission import request_identity
        out: List[Tuple] = []
        now = time.monotonic()
        for key in list(self._awaiting):
            try:
                handle, state, msg = self.zoo.acquire(key)
            except Exception as e:  # noqa: BLE001 — transient zoo
                # fault: the requests STAY parked (no handle leaked,
                # nothing unanswered) and the activation timeout still
                # bounds their wait
                log.error("zoo acquire failed for %s (still parked):"
                          " %s", key, e)
                continue
            group = self._awaiting[key]
            if state == "loading":
                if now - self._awaiting_since[key] \
                        <= self.activation_timeout_s:
                    continue            # keep waiting
                for p in group:
                    self._reject_parked(
                        p, 503, "activation_timeout",
                        f"model {key!r} still activating after "
                        f"{self.activation_timeout_s:.0f}s",
                        {"Retry-After": self._retry_header()})
            elif state == "resident":
                prio = min(request_identity(p.request)[1]
                           for p in group)
                chunks = [group[i:i + self.batch_size]
                          for i in range(0, len(group), self.batch_size)]
                out.append((handle, chunks[0], prio))
                for i in range(1, len(chunks)):
                    try:
                        h2, st2, _ = self.zoo.acquire(key)
                    except Exception:  # noqa: BLE001 — re-park
                        st2 = None
                    if st2 == "resident":
                        out.append((h2, chunks[i], prio))
                    else:   # can't happen while chunk 0 holds the
                        #     handle outstanding; guard anyway —
                        #     re-park this AND every later chunk
                        self._awaiting[key] = [
                            p for c in chunks[i:] for p in c]
                        self._awaiting_since[key] = now
                        break
                else:
                    self._drop_awaiting(key)
                continue
            else:   # failed / unknown (e.g. deregistered mid-wait)
                for p in group:
                    self._reject_parked(
                        p, 503, "load_failed",
                        f"model {key!r} failed to activate: {msg}",
                        {"Retry-After": self._retry_header(floor=5)})
            self._drop_awaiting(key)
        return out

    # -- threads ------------------------------------------------------------

    def _worker_loop(self):
        while not self._stop.is_set():
            try:
                item = self._dispatch_q.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                self._execute_batch(*item)
            except Exception as e:  # noqa: BLE001 — keep serving
                log.error("serving loop error (continuing): %s", e)
            finally:
                # token back even when the thread is dying (SystemExit
                # passes through): a leaked token would shrink the
                # engine's in-flight budget forever — and the version
                # handle must drain even on a crashed batch, or a swap
                # would wait on its outstanding count forever
                item[3].release()
                self._inflight.release()

    def _spawn_worker(self) -> threading.Thread:
        t = threading.Thread(target=self._worker_loop, daemon=True)
        t.start()
        return t

    def _spawn_batcher(self) -> threading.Thread:
        t = threading.Thread(target=self._batcher_loop, daemon=True)
        t.start()
        return t

    def _supervise(self, interval: float = 0.1):
        """Liveness watchdog: a worker or batcher thread that dies (a
        BaseException like SystemExit escaping the loop's Exception
        guard) is detected and respawned, so one crashed thread can't
        silently halve — or zero — the engine's throughput. Chaos kills
        (``kill()``) and normal ``stop()`` suppress restarts."""
        while not self._stop.wait(interval):
            with self._threads_lock:
                for i, t in enumerate(self._threads):
                    if t.is_alive() or self._stop.is_set():
                        continue
                    log.error("serving worker died; restarting")
                    self._threads[i] = self._spawn_worker()
                    with self._stats_lock:
                        self.workers_restarted += 1
                if (self._batcher is not None
                        and not self._batcher.is_alive()
                        and not self._stop.is_set()):
                    log.error("serving batcher died; restarting")
                    self._batcher = self._spawn_batcher()
                    with self._stats_lock:
                        self.workers_restarted += 1

    def is_alive(self) -> bool:
        """Engine liveness for /healthz: not killed or stopped, batcher
        running (when started), and at least one worker thread running."""
        if self._killed.is_set() or self._stop.is_set():
            return False
        with self._threads_lock:
            workers_ok = any(t.is_alive() for t in self._threads)
            batcher_ok = (self._batcher is None
                          or self._batcher.is_alive())
        return workers_ok and batcher_ok

    def _lifecycle_snapshot(self) -> Tuple[PipelineHandle, Dict[str, Any]]:
        """ONE consistent (handle, swap_state, counters) snapshot under
        ``_stats_lock`` — the lock every lifecycle writer (cutover,
        state transitions, counter bumps — see serving/lifecycle.py)
        holds. Read piecemeal, a scrape racing ``swap()`` could see the
        NEW version with the OLD swaps_completed count, or
        ``swap_state == idle`` with the not-yet-cut-over pipeline."""
        with self._stats_lock:
            active = self._active
            return active, {
                "batches_processed": self.batches_processed,
                "workers_restarted": self.workers_restarted,
                "model_version": active.version,
                "precision": active.precision,
                "aot": active.aot,
                "swap_state": self.swap_state,
                "swaps_completed": self.swaps_completed,
                "swaps_rolled_back": self.swaps_rolled_back,
            }

    def metrics(self) -> Dict[str, Any]:
        """Hot-path latency breakdown: engine histograms (queue wait,
        decode, pipeline, respond, batch occupancy) plus whatever the
        pipeline exposes through a duck-typed ``metrics`` hook
        (TPUModel adds its pad/device/readback split and the first-run
        shape counter). Exported on /healthz."""
        active, out = self._lifecycle_snapshot()
        out.update({k: h.summary() for k, h in self.hists.items()})
        with self._stats_lock:
            if self.rejections:
                out["rejections"] = dict(self.rejections)
        if self.zoo is not None:
            try:
                out["zoo"] = self.zoo.stats()
            except Exception:  # noqa: BLE001 — stats stay partial
                pass
        if self.admission is not None:
            try:
                out["admission"] = self.admission.stats()
            except Exception:  # noqa: BLE001 — stats stay partial
                pass
        swap_ctl = self._swap_ctl
        if swap_ctl is not None:
            try:
                out["swap"] = swap_ctl.stats()
            except Exception:  # noqa: BLE001 — stats stay partial
                pass
        if self.slo is not None:
            try:
                out["slo"] = self.slo.status()
            except Exception:  # noqa: BLE001 — stats stay partial
                pass
        if self.variants is not None:
            # /healthz carries the currently-routed variant + last
            # step-down reason per logical model (a degrade-to-int8 is
            # operator-visible)
            try:
                out["variants"] = self.variants.status()
            except Exception:  # noqa: BLE001 — stats stay partial
                pass
        out["retry_after_s"] = self._retry_after_s
        stage = getattr(active.pipeline, "metrics", None)
        if callable(stage):
            try:
                out["pipeline_stage"] = stage()
            except Exception:  # noqa: BLE001 — stats stay partial
                pass
        return out

    def metrics_text(self) -> str:
        """Prometheus text exposition (format 0.0.4) of everything the
        engine knows: source/engine counters, the per-stage latency
        histograms with exact buckets, the model version as an
        ``_info`` series, the pipeline's histograms and first-run shape
        counter, the SLO families, and the process-wide GBDT / AutoML /
        fusion / ooc phase, trace-buffer and card-memory families.
        With a zoo, admission or variant selector attached, their
        families too. Served on ``/metrics``."""
        from mmlspark_tpu_torch.core.prometheus import (
            PromRenderer, pipeline_families, process_families,
            slo_families, variant_families, zoo_families,
        )
        r = PromRenderer()
        src = self.source
        with src._lock:
            seen, accepted = src.requests_seen, src.requests_accepted
            answered, rejected = src.requests_answered, \
                src.requests_rejected
            parked = len(src._pending)
        r.counter("serving_requests_seen_total",
                  "requests hitting the HTTP source", seen)
        r.counter("serving_requests_accepted_total",
                  "requests parked + enqueued", accepted)
        r.counter("serving_requests_answered_total",
                  "requests answered through the held connection",
                  answered)
        r.counter("serving_requests_rejected_total",
                  "requests shed with 503 + Retry-After", rejected)
        r.gauge("serving_parked_requests",
                "connections currently held open", parked)
        r.gauge("serving_queue_depth", "source queue depth",
                src.queue.qsize())
        active, snap = self._lifecycle_snapshot()
        r.counter("serving_batches_processed_total",
                  "micro-batches executed", snap["batches_processed"])
        r.counter("serving_workers_restarted_total",
                  "worker/batcher threads respawned by the supervisor",
                  snap["workers_restarted"])
        r.counter("serving_swaps_completed_total",
                  "model swaps promoted + cut over",
                  snap["swaps_completed"])
        r.counter("serving_swaps_rolled_back_total",
                  "model swaps rolled back", snap["swaps_rolled_back"])
        r.info("serving_model_info",
               "active model version, precision, aot, swap state (labels)",
               {"version": snap["model_version"],
                "precision": snap["precision"],
                "aot": "true" if snap["aot"] else "false",
                "swap_state": snap["swap_state"]})
        for name, hist in self.hists.items():
            r.histogram(f"serving_{name}",
                        "engine hot-path stage distribution", hist)
        ctl = self._swap_ctl
        if ctl is not None:
            try:
                stats = ctl.stats()
                r.gauge("serving_canary_batches",
                        "canary batch outcomes for the swap in flight",
                        stats["canary_ok"], {"outcome": "ok"})
                r.sample("serving_canary_batches",
                         stats["canary_failed"], {"outcome": "failed"})
            except Exception:  # noqa: BLE001 — stats stay partial
                pass
        with self._stats_lock:
            rejections = dict(self.rejections)
        for reason in sorted(rejections):
            r.counter("serving_admission_rejected_total",
                      "requests rejected by admission/model routing "
                      "(quota, priority, no_model, unknown_model, "
                      "load_failed, activation_timeout, routing_error)",
                      rejections[reason], {"reason": reason})
        if self.admission is not None:
            try:
                r.counter("serving_admission_admitted_total",
                          "requests admitted by the admission layer",
                          self.admission.stats()["admitted"])
            except Exception:  # noqa: BLE001 — stats stay partial
                pass
        if self.zoo is not None:
            try:
                zoo_families(r, self.zoo)
            except Exception:  # noqa: BLE001 — stats stay partial
                pass
        if self.slo is not None:
            try:
                slo_families(r, self.slo)
            except Exception:  # noqa: BLE001 — stats stay partial
                pass
        if self.variants is not None:
            try:
                variant_families(r, self.variants)
            except Exception:  # noqa: BLE001 — stats stay partial
                pass
        r.gauge("serving_retry_after_s",
                "live drain-estimate Retry-After quoted on sheds",
                self._retry_after_s)
        cp = self.__dict__.get("controlplane")
        if cp is not None:
            from mmlspark_tpu_torch.core.prometheus import (
                controlplane_families,
            )
            try:
                controlplane_families(r, cp)
            except Exception:  # noqa: BLE001 — stats stay partial
                pass
        pipeline_families(r, active.pipeline)
        process_families(r, tracer=self.tracer)
        return r.render()

    # -- trace export -------------------------------------------------------

    def traces(self, limit: Optional[int] = None) -> List[Any]:
        """Completed (tail-sampled) traces from this engine's buffer,
        oldest first."""
        if self.tracer is None:
            return []
        return self.tracer.buffer.traces(limit)

    def export_traces(self, limit: Optional[int] = None) -> Dict[str, Any]:
        """The buffer as Chrome trace-event JSON (the /debug/traces
        payload — save it and open in Perfetto), with a
        ``process_name`` event naming this engine + pid."""
        from mmlspark_tpu_torch.core.trace import to_chrome_trace
        return to_chrome_trace(
            self.traces(limit),
            process_name=f"engine {self.source.address} "
                         f"pid={os.getpid()}")

    def _recorder_key(self) -> str:
        return f"engine@{self.source.address}"

    def start(self) -> "ServingEngine":
        with self._threads_lock:
            self._batcher = self._spawn_batcher()
            self._threads = [self._spawn_worker()
                             for _ in range(self.workers)]
        self._supervisor = threading.Thread(target=self._supervise,
                                            daemon=True)
        self._supervisor.start()
        self.source.health_probe = self.is_alive
        self.source.metrics_probe = self.metrics
        self.source.tracer = self.tracer
        self.source.trace_probe = self.export_traces
        self.source.prom_probe = self.metrics_text
        self.source.slo = self.slo
        rec = self.flight_recorder
        if rec is not None:
            # the black box sees this engine's traces, SLO state, the
            # lifecycle event timeline and a metrics snapshot; keys
            # carry the address so stop() can detach cleanly
            key = self._recorder_key()
            rec.attach_tracer(
                self.tracer,
                label=f"engine {self.source.address} pid={os.getpid()}",
                key=f"{key}:tracer")
            if self.slo is not None:
                rec.attach_slo(key, self.slo)
            rec.add_event_source(f"{key}:swap_events",
                                 lambda: self.swap_events)
            if self.zoo is not None:
                # keyed per engine (a shared zoo re-attaches under each
                # engine's key) so stop()'s prefix detach releases it
                rec.add_event_source(f"{key}:registry_events",
                                     lambda: self.zoo.events)
            rec.add_stats_source(key, self.metrics)
            self.source.bundle_probe = (
                lambda limit=None: rec.dump_bundle(
                    reason="http_request", trace_limit=limit))
        return self

    def kill(self, close_source: bool = True) -> None:
        """Chaos hook: simulate a crashed engine — workers exit and are
        NOT restarted. ``close_source=True`` also drops the listener
        (clients see connection-refused, the crashed-process shape);
        ``close_source=False`` keeps accepting but never replies (the
        stalled-engine shape: parked requests run out their timeout)."""
        self._killed.set()
        self._stop.set()
        if close_source:
            self.source.close()

    def stop(self) -> None:
        self._stop.set()
        if self.flight_recorder is not None:
            # drop this engine's recorder hooks (a process recorder
            # outlives engines; stale closures would leak them)
            self.flight_recorder.detach(self._recorder_key())
        if self.slo is not None:
            # uninstall exactly the monitor hooks THIS engine wired: a
            # shared monitor handed to a later engine must re-wire to
            # that engine's recorder, not keep ours
            for hook in self._slo_hooks_installed:
                setattr(self.slo, hook, None)
            self._slo_hooks_installed = []
        if self._supervisor is not None:
            self._supervisor.join(timeout=5)
        with self._threads_lock:
            threads = list(self._threads)
            if self._batcher is not None:
                threads.append(self._batcher)
        for t in threads:
            t.join(timeout=5)
        if self.zoo is not None:
            # release this engine's parked-demand holds: a shared zoo
            # must not carry dead engines' waiters (they would exempt
            # models from eviction forever)
            for key in list(self._awaiting):
                self.zoo.remove_waiter(key)
            self._awaiting.clear()
            self._awaiting_since.clear()
            # same for the continuous batcher's pending groups, and
            # the ready lane's acquired-but-undispatched handles (the
            # batcher thread is joined above — no races): an
            # unreleased handle would pin its model's outstanding
            # count above zero forever
            for key in list(self._pending):
                if key is not None:
                    self.zoo.remove_waiter(key)
            self._pending.clear()
            for entry in self._ready:
                if entry[2] is not None:
                    entry[2].release()
            self._ready.clear()
        try:
            self.source.close()
        except Exception:  # noqa: BLE001 — already closed by kill()
            pass


def serve_model(pipeline: Optional[Transformer] = None,
                host: str = "127.0.0.1",
                port: int = 8899, batch_size: int = 64,
                reply_col: str = "reply",
                workers: int = 1, max_wait_ms: float = 5.0,
                pipeline_depth: int = 2,
                version: str = "v0", tracer=None,
                tracing: Optional[bool] = None,
                zoo=None, admission=None,
                slo=None, flight_recorder=None,
                slo_eval_interval_s: float = 0.25,
                variants=None) -> ServingEngine:
    """One-call serving: the ``.server()`` DSL analog
    (ref: ServingImplicits.scala:10-50). Batches flush on
    ``batch_size`` rows or ``max_wait_ms`` elapsed, whichever first;
    the batcher thread decodes the next batch while a worker drives the
    device for the current one. ``workers`` > 1 additionally overlaps
    device round-trips; the pipeline's ``transform`` must then be
    thread-safe. ``port=0`` binds a free port (``engine.source.address``).
    Tracing, the SLO monitor and the flight recorder are on unless
    ``tracing=False`` / ``slo=False`` / ``flight_recorder=False``.
    ``zoo`` / ``admission`` / ``variants`` attach the multi-model plane
    (``pipeline`` may then be None: every request names its model)."""
    source = HTTPSource(host=host, port=port)
    try:
        engine = ServingEngine(source, pipeline, reply_col=reply_col,
                               batch_size=batch_size, workers=workers,
                               max_wait_ms=max_wait_ms,
                               pipeline_depth=pipeline_depth,
                               version=version, tracer=tracer,
                               tracing=tracing, zoo=zoo,
                               admission=admission, slo=slo,
                               flight_recorder=flight_recorder,
                               slo_eval_interval_s=slo_eval_interval_s,
                               variants=variants)
    except BaseException:
        source.close()       # a refused option must not leak a listener
        raise
    return engine.start()
