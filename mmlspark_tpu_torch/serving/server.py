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
``Retry-After``, ``/healthz`` and ``metrics()``.

Where the port differs (the reference's default path reaches modules
the port has not ported yet):

- **Request tracing, the SLO monitor and the flight recorder default to
  off.** Passing ``tracer=``, ``tracing=True``, an ``slo`` monitor or a
  ``flight_recorder`` raises ``NotImplementedError`` naming ROADMAP item
  14 ('Device pipeline and serving compilation', which holds
  ``core/trace.py``) or 15 ('The rest of the serving plane'); so do
  ``zoo=``, ``admission=``, ``variants=`` and ``swap()`` (the reference
  runs admission decisions only in a zoo engine's model-routing
  batcher). ``GET /metrics`` (Prometheus),
  ``/debug/traces`` and ``/debug/bundle`` answer 501 with the same kind
  of message.
- Replies do not change. Only the telemetry sections of ``/healthz`` and
  ``metrics()`` are missing (``slo``, ``controlplane``, ``zoo``,
  ``admission``, ``swap``, ``variants`` and the swap counters).
- ``HTTPSource`` drains only through ``drain_parked`` (the engine's
  path); the reference's ``get_batch`` / ``get_batch_adaptive`` and
  ``ServingEngine.process_one_batch`` embedder calls and the chaos hook
  ``ServingEngine.kill`` are not copied.
- The handler sets ``TCP_NODELAY``: a reply's body no longer waits for
  the client's delayed ACK of its headers (same bytes, sooner).
"""

from __future__ import annotations

import itertools
import json
import math
import queue
import secrets
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.io.http import HTTPSchema, _jsonable as _to_jsonable

log = get_logger("serving")

_TRACING = "Device pipeline and serving compilation"
_SERVING_PLANE = "The rest of the serving plane"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md, "
                               f"'{item}'")


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

    def respond(self, response: Dict[str, Any]) -> None:
        self.response = response
        self._event.set()

    def wait(self, timeout: float) -> Optional[Dict[str, Any]]:
        if self._event.wait(timeout):
            return self.response
        return None


# GET paths of the reference whose providers are not ported: 501 + item
_UNPORTED_GETS = {
    "/metrics": ("the Prometheus exposition", _SERVING_PLANE),
    "/debug/traces": ("request tracing", _TRACING),
    "/debug/bundle": ("the flight recorder", _SERVING_PLANE),
}


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

            def do_GET(self):  # noqa: N802 (http.server API)
                path_only = self.path.split("?", 1)[0].rstrip("/")
                if path_only in _UNPORTED_GETS:
                    what, item = _UNPORTED_GETS[path_only]
                    self._send_json(
                        501, {"error": str(_not_ported(what, item))})
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
                with source._lock:
                    stats = {
                        "status": "ok" if healthy else "unhealthy",
                        "seen": source.requests_seen,
                        "accepted": source.requests_accepted,
                        "answered": source.requests_answered,
                        "rejected": source.requests_rejected,
                        "parked": len(source._pending),
                        "queue_depth": source.queue.qsize(),
                    }
                if metrics is not None:
                    stats["metrics"] = metrics
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
                with source._lock:
                    if len(source._pending) >= source.max_parked:
                        shed = True
                    else:
                        source._pending[parked.id] = parked
                        shed = False
                if shed:
                    self._shed("parked-request table full")
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
                    return
                resp = parked.wait(reply_timeout)
                with source._lock:
                    source._pending.pop(parked.id, None)
                try:
                    if resp is None:
                        self.send_error(504, "serving timeout")
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
                    for k, v in (resp.get("headers") or {}).items():
                        if k.lower() not in _framing:
                            self.send_header(k, v)
                    self.send_header("Content-Length", str(len(entity)))
                    self.end_headers()
                    self.wfile.write(entity)
                except OSError:
                    # client gave up (timeout/disconnect) before the
                    # reply flushed: fold the connection quietly
                    self.close_connection = True
                    return
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


class PipelineHandle:
    """One immutable (pipeline, version) binding. Every dispatched
    micro-batch carries the handle it was BUILT with, so a batch is
    decoded, executed, retried and answered by exactly one model
    version. (The reference's in-flight count, canary and zoo fields
    serve ``swap()`` and the model zoo, which the port has not ported.)"""

    __slots__ = ("pipeline", "version", "precision", "aot", "prepare",
                 "execute")

    def __init__(self, pipeline: Transformer, version: str):
        from mmlspark_tpu_torch.core.quantize import stage_precision
        self.pipeline = pipeline
        self.version = str(version)
        # serving-precision + AOT labels, captured ONCE at handle build
        # (json_scoring_pipeline forwards them from the model)
        self.precision = stage_precision(pipeline)
        self.aot = bool(getattr(pipeline, "aot", False))
        # optional two-stage split (duck-typed; absent on plain stages)
        self.prepare = getattr(pipeline, "prepare_batch", None)
        self.execute = getattr(pipeline, "execute_prepared", None)


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
    pad / device split) exported through ``metrics()`` and /healthz.
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
                 slo=None, flight_recorder=None,
                 variants=None,
                 retry_after_max_s: float = 30.0):
        from mmlspark_tpu_torch.core.metrics import WindowedCounter, \
            histogram_set
        if tracer is not None or tracing:
            raise _not_ported("request tracing (tracer=, tracing=True)",
                              _TRACING)
        if slo not in (None, False):
            raise _not_ported("the SLO monitor (slo=)", _SERVING_PLANE)
        if flight_recorder not in (None, False):
            raise _not_ported("the flight recorder (flight_recorder=)",
                              _SERVING_PLANE)
        if zoo is not None:
            raise _not_ported("the model zoo (zoo=)", _SERVING_PLANE)
        if admission is not None:
            raise _not_ported("admission control (admission=)",
                              _SERVING_PLANE)
        if variants is not None:
            raise _not_ported("variant routing (variants=)",
                              _SERVING_PLANE)
        if pipeline is None:
            raise ValueError("ServingEngine needs a pipeline")
        self.source = source
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

    def swap(self, pipeline: Transformer, version: str,
             warmup_example: Any = None, policy: Any = None):
        raise _not_ported("zero-downtime model swap (swap)",
                          _SERVING_PLANE)

    def _respond_ok(self, rid: str, rep: Any) -> None:
        body = rep if isinstance(rep, (bytes, str)) \
            else json.dumps(_to_jsonable(rep))
        headers = {"Content-Type": self.content_type}
        self.source.respond(rid, HTTPSchema.response(
            200, "OK", body if isinstance(body, bytes)
            else body.encode("utf-8"), headers))

    def _answer_output(self, out: DataTable, ids: List[str]) -> None:
        """Answer one transformed batch, splitting per-row errors: a
        non-null ``error_col`` value means that row failed and gets a
        500 while its batchmates still get their 200s
        (ref: SimpleHTTPTransformer.scala:104-150 error-split pipeline)."""
        replies = out[self.reply_col]
        out_ids = out[self.id_col]
        errors = (out[self.error_col]
                  if self.error_col in out.column_names else None)
        answered = set()
        for i, (rid, rep) in enumerate(zip(out_ids, replies)):
            err = errors[i] if errors is not None else None
            if err is not None and err == err:  # non-null, non-NaN
                self.source.respond(rid, HTTPSchema.response(
                    500, f"row error: {err}", None))
            else:
                self._respond_ok(rid, rep)
            answered.add(rid)
        for rid in ids:
            if rid not in answered:
                self.source.respond(rid, HTTPSchema.response(
                    500, "row dropped by pipeline", None))

    def _execute_batch(self, table: DataTable, ids: List[str],
                       prepped: Any,
                       handle: Optional[PipelineHandle] = None) -> None:
        """Stage 2 of the pipeline: device execution + reply flush for
        one micro-batch (``prepped`` carries stage 1's decode output
        when the pipeline supports the split). The whole batch runs on
        ``handle``'s pipeline version, retries included."""
        if handle is None:
            handle = self._active
        t0 = time.perf_counter()
        try:
            if prepped is not None and handle.execute is not None:
                out = handle.execute(table, prepped)
            else:
                out = handle.pipeline.transform(table)
        except Exception as e:  # noqa: BLE001 — isolate the poison row(s)
            log.warning("serving batch failed (%s); retrying per-row", e)
            self._process_rows_individually(table, ids, handle)
            with self._stats_lock:
                self.batches_processed += 1
            return
        self.hists["pipeline_ms"].observe((time.perf_counter() - t0) * 1e3)
        t1 = time.perf_counter()
        try:
            self._answer_output(out, ids)
        except Exception as e:  # noqa: BLE001 — e.g. missing reply column
            log.warning("answering batch failed (%s); sending 500s", e)
            for rid in ids:
                self.source.respond(rid, HTTPSchema.response(
                    500, f"reply error: {e}", None))
        self.hists["respond_ms"].observe(
            (time.perf_counter() - t1) * 1e3)
        with self._stats_lock:
            self.batches_processed += 1

    def _process_rows_individually(self, table: DataTable,
                                   ids: List[str],
                                   handle: Optional[PipelineHandle] = None,
                                   ) -> None:
        """Batch-failure fallback: run each row alone so one poison
        request cannot 500 its batchmates (the per-row half of the
        reference's error isolation, SimpleHTTPTransformer.scala:104-150)."""
        if handle is None:
            handle = self._active
        requests = table["request"]
        for rid, req in zip(ids, requests):
            row = DataTable({"id": [rid], "request": [req]})
            try:
                out = handle.pipeline.transform(row)
                self._answer_output(out, [rid])
            except Exception as e:  # noqa: BLE001
                self.source.respond(rid, HTTPSchema.response(
                    500, f"pipeline error: {e}", None))

    def _build_item(self, parked: List[_ParkedRequest],
                    handle: PipelineHandle) -> Optional[Tuple]:
        """Assemble + (optionally) decode one collected batch: the host
        half of the two-stage pipeline, run on the batcher thread."""
        table = DataTable({"id": [p.id for p in parked],
                           "request": [p.request for p in parked]})
        ids = [p.id for p in parked]
        prepped = None
        if handle.prepare is not None and handle.execute is not None:
            t0 = time.perf_counter()
            try:
                prepped = handle.prepare(table)
                self.hists["decode_ms"].observe(
                    (time.perf_counter() - t0) * 1e3)
            except Exception:  # noqa: BLE001 — poison rows can die
                # in decode too: hand the batch over un-prepared so the
                # worker's per-row retry isolates the offender
                prepped = None
        # per-request codec rejects (columnar ingress, io/columnar.py):
        # a malformed or schema-mismatched body 400s exactly ITS
        # request while batch-mates proceed to dispatch
        rejects = getattr(prepped, "rejects", None)
        if rejects:
            table, ids = self._apply_rejects(parked, table, ids, rejects)
            if not ids:
                return None   # nothing survived decode — no dispatch
        return table, ids, prepped, handle

    def _apply_rejects(self, parked: List[_ParkedRequest],
                       table: DataTable, ids: List[str],
                       rejects: Dict[str, str]):
        """Answer 400 for every codec-rejected request and return the
        filtered (table, ids) the surviving batch dispatches with."""
        for p in parked:
            msg = rejects.get(p.id)
            if msg is None:
                continue
            self.source.respond(p.id, HTTPSchema.response(
                400, "bad request",
                json.dumps({"error": msg}).encode("utf-8"),
                {"Content-Type": "application/json"}))
        keep_idx = [i for i, rid in enumerate(ids) if rid not in rejects]
        ids = [ids[i] for i in keep_idx]
        table = table._take_indices(np.asarray(keep_idx, dtype=np.int64))
        return table, ids

    def _batcher_loop(self):
        """Stage 1 of the pipeline: adaptive collect + (optional) host
        decode, feeding the dispatch queue. While a worker drives the
        device for batch N, this thread is already collecting and
        decoding batch N+1. While no in-flight token is free (workers
        saturated), the pending batch keeps absorbing newly-queued
        requests up to batch_size, so batches grow toward full
        occupancy exactly when the device is the bottleneck."""
        while not self._stop.is_set():
            try:
                parked = self.source.drain_parked(
                    self.batch_size, self.max_wait_ms / 1e3)
            except Exception as e:  # noqa: BLE001 — keep collecting
                log.error("serving batcher error (continuing): %s", e)
                time.sleep(0.005)
                continue
            self._update_retry_after()
            if parked:
                self._dispatch_parked(parked)

    def _dispatch_now(self, parked: List[_ParkedRequest]) -> None:
        """Assemble + dispatch ONE micro-batch whose in-flight token is
        ALREADY held."""
        # token ownership transfers to the worker ONLY on a successful
        # put; any other exit must give it back, or each incident would
        # permanently shrink the engine's dispatch budget
        handed_off = False
        handle = self._active
        try:
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
                self._inflight.release()
        self._drained_rows.inc(len(parked))
        for p in parked:
            # dequeue stamp, not dispatch time: queue_wait must not
            # absorb the token wait or the decode stage (decode_ms
            # measures that) — the breakdown stays additive
            self.hists["queue_wait_ms"].observe(
                max(0.0, p.dequeued_at - p.enqueued_at) * 1e3)
        self.hists["batch_rows"].observe(float(len(parked)))

    def _dispatch_parked(self, parked: List[_ParkedRequest]) -> None:
        """Token-gate + assemble + dispatch ONE micro-batch. Waits for an
        in-flight token, topping the pending batch up from the queue
        meanwhile: back-pressure converts directly into batch occupancy
        instead of tiny trailing batches."""
        while not self._stop.is_set():
            if self._inflight.acquire(timeout=0.005):
                self._dispatch_now(parked)
                return
            if len(parked) < self.batch_size:
                try:
                    self.source.top_up(parked, self.batch_size)
                except Exception:  # noqa: BLE001 — source closing
                    pass
        # stopping: parked requests run out their reply timeout

    # -- shedding -----------------------------------------------------------

    def _pressure(self) -> int:
        """Saturation signal: prepared batches queued behind busy
        workers PLUS requests backed up in the source queue."""
        pressure = self._dispatch_q.qsize()
        try:
            pressure += self.source.queue.qsize()
        except Exception:  # noqa: BLE001 — source closing
            pass
        return pressure

    def _update_retry_after(self, now: Optional[float] = None) -> None:
        """Re-derive Retry-After from the live backlog / windowed
        drain rate (rate-gated; batcher thread). Shed replies then
        tell backoff-honoring clients when capacity should actually
        exist — backlog/rate seconds, clamped to [1,
        retry_after_max_s] — instead of a constant 1 s."""
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
                # engine's in-flight budget forever
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
        silently halve — or zero — the engine's throughput. ``stop()``
        suppresses restarts."""
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
        """Engine liveness for /healthz: not stopped, batcher running
        (when started), and at least one worker thread running."""
        if self._stop.is_set():
            return False
        with self._threads_lock:
            workers_ok = any(t.is_alive() for t in self._threads)
            batcher_ok = (self._batcher is None
                          or self._batcher.is_alive())
        return workers_ok and batcher_ok

    def _lifecycle_snapshot(self) -> Tuple[PipelineHandle, Dict[str, Any]]:
        """ONE consistent (handle, counters) snapshot under
        ``_stats_lock``."""
        with self._stats_lock:
            active = self._active
            return active, {
                "batches_processed": self.batches_processed,
                "workers_restarted": self.workers_restarted,
                "model_version": active.version,
                "precision": active.precision,
                "aot": active.aot,
            }

    def metrics(self) -> Dict[str, Any]:
        """Hot-path latency breakdown: engine histograms (queue wait,
        decode, pipeline, respond, batch occupancy) plus whatever the
        pipeline exposes through a duck-typed ``metrics`` hook
        (TPUModel adds its pad/device/readback split and the first-run
        shape counter). Exported on /healthz."""
        active, out = self._lifecycle_snapshot()
        out.update({k: h.summary() for k, h in self.hists.items()})
        out["retry_after_s"] = self._retry_after_s
        stage = getattr(active.pipeline, "metrics", None)
        if callable(stage):
            try:
                out["pipeline_stage"] = stage()
            except Exception:  # noqa: BLE001 — stats stay partial
                pass
        return out

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
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout=5)
        with self._threads_lock:
            threads = list(self._threads)
            if self._batcher is not None:
                threads.append(self._batcher)
        for t in threads:
            t.join(timeout=5)
        self.source.close()


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
                variants=None) -> ServingEngine:
    """One-call serving: the ``.server()`` DSL analog
    (ref: ServingImplicits.scala:10-50). Batches flush on
    ``batch_size`` rows or ``max_wait_ms`` elapsed, whichever first;
    the batcher thread decodes the next batch while a worker drives the
    device for the current one. ``workers`` > 1 additionally overlaps
    device round-trips; the pipeline's ``transform`` must then be
    thread-safe. ``port=0`` binds a free port (``engine.source.address``)."""
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
                               variants=variants)
    except BaseException:
        source.close()       # a refused option must not leak a listener
        raise
    return engine.start()
