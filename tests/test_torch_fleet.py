"""PyTorch port: the fleet client (``serving/fleet.py::ServingFleet``)
and ``PartitionConsolidator``, against the JAX package, on the CPU.

The fleet scenarios of ``tests/test_http_serving.py`` (round robin, the
consolidator), ``tests/test_trace_propagation.py``'s
``TestClientLegSpans`` and ``test_cross_process_retry_hedge_one_trace``
(port engines in subprocesses, JAX blocked there) and
``tests/test_observability.py``'s ``test_fleet_metrics_text_grammar``
(through the port's ``testing/metrics_check.py``) run over port engines
bound on free ports; counters are polled, since an engine counts a
reply after writing it. Held against the JAX package:
``PartitionConsolidator(hostCount=2, hostIndex=i)`` keeps the same rows
(equal). A stub host that answers 429 stands in for a tenant's quota
here; the reference's quota-429 scenario over a zoo with admission
control runs in ``tests/test_torch_admission.py``. Also the retry-loop guard of
``tests/test_resilience.py`` over the port's package.
"""

import http.server
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.error

import numpy as np
import pytest

from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.serving.fleet import PartitionConsolidator as JConsolidator

from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.core.trace import (
    Tracer, merge_chrome_traces, to_chrome_trace, use_span,
)
from mmlspark_tpu_torch.serving import (
    PartitionConsolidator, ServingFleet, ServingUnavailable, serve_model,
)
from mmlspark_tpu_torch.stages.basic import Lambda
from mmlspark_tpu_torch.testing import metrics_check
from mmlspark_tpu_torch.utils.resilience import CircuitBreaker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _poll(fn, want, timeout=5.0):
    deadline = time.monotonic() + timeout
    got = fn()
    while got != want and time.monotonic() < deadline:
        time.sleep(0.01)
        got = fn()
    return got


def _echo():
    def handle(table):
        return table.with_column("reply", [
            {"echo": json.loads(r["entity"].decode())["x"]}
            for r in table["request"]])
    return Lambda.apply(handle)


def _sleepy_scorer():
    def handle(table):
        rows = [json.loads(r["entity"].decode())
                for r in table["request"]]
        out = []
        for r in rows:
            if r.get("sleep"):
                time.sleep(float(r["sleep"]))
            out.append({"y": r["x"] * 2})
        return table.with_column("reply", out)
    return Lambda.apply(handle)


def _fleet(pipeline, **kw):
    kw.setdefault("flight_recorder", False)
    return ServingFleet(pipeline, base_port=0, **kw)


# ---------------------------------------------------------------------------
# test_http_serving.py's fleet scenarios
# ---------------------------------------------------------------------------


def test_serving_fleet_round_robin():
    fleet = _fleet(_echo(), n_engines=3, batch_size=4)
    try:
        assert len(set(fleet.addresses)) == 3
        results = [fleet.post({"x": i})["echo"] for i in range(9)]
        assert results == list(range(9))
        assert _poll(lambda: fleet.counters()["answered"], 9) == 9
        # round-robin really spread the load
        per_engine = _poll(lambda: [e.source.requests_answered
                                    for e in fleet.engines], [3, 3, 3])
        assert per_engine == [3, 3, 3], per_engine
        agg = fleet.metrics()["aggregate"]
        assert agg["model_versions"] == ["v0"] * 3
        assert agg["swap_states"] == ["idle"] * 3
        health = fleet.health()
        assert [h["reachable"] for h in health] == [True] * 3
        assert {h["status"] for h in health} == {"ok"}
    finally:
        fleet.stop_all()


def test_partition_consolidator_matches_jax():
    x = np.arange(10.0)
    t, jt = DataTable({"x": x}), JTable({"x": x})
    # single host: pass-through, one logical partition
    out = PartitionConsolidator().transform(t.repartition(4))
    assert len(out) == 10 and out.num_shards == 1
    for count in (2, 3):
        parts = []
        for i in range(count):
            a = PartitionConsolidator(hostCount=count,
                                      hostIndex=i).transform(t)
            b = JConsolidator(hostCount=count, hostIndex=i).transform(jt)
            assert list(a["x"]) == list(b["x"])
            assert a.num_shards == 1
            parts += list(a["x"])
        assert parts == list(map(float, range(10)))
    with pytest.raises(ValueError, match="out of range"):
        PartitionConsolidator(hostCount=2, hostIndex=2).transform(t)


def test_partition_consolidator_reads_an_initialized_group(monkeypatch):
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    t = DataTable({"x": np.arange(10.0)})
    assert list(PartitionConsolidator().transform(t)["x"]) == \
        [5.0, 6.0, 7.0, 8.0, 9.0]


def test_unported_surfaces_name_their_items():
    """The host transports and the multi-model plane's membership
    surface are ported: ``post_columns`` against a JSON-only engine falls
    down its ladder to per-row JSON (and counts its rows as demand), the
    demand signal counts posts, membership moves only on a connected
    fleet (as in the reference), attach_placement returns its
    controller, and ``connect`` takes ``shm_transport``."""
    fleet = _fleet(_echo(), n_engines=1, batch_size=4)
    try:
        assert fleet.demand_rate() == 0.0
        fleet.post({"x": 1})
        assert fleet.demand_rate(10.0) > 0.0
        out = fleet.post_columns({"x": np.arange(3.0)})
        assert out == {"echo": [0.0, 1.0, 2.0]}
        assert fleet._columnar_ok is False
        for call in (lambda: fleet.add_engine("http://127.0.0.1:1"),
                     lambda: fleet.remove_engine("http://127.0.0.1:1")):
            with pytest.raises(RuntimeError, match="in-process fleets"):
                call()
        ctl = fleet.attach_placement()
        assert fleet.placement is ctl and ctl.n_engines == 1
    finally:
        fleet.stop_all()
    client = ServingFleet.connect(["http://127.0.0.1:1"],
                                  shm_transport=True)
    assert client.shm_transport is True and client._shm_ring is None
    client.stop_all()


def test_connect_waits_for_a_late_engine_and_fails_over():
    """``connect(wait_ready_s=...)`` probes each address until it
    listens; a dead address then fails over onto the live one, and
    all-dead raises the typed error with the attempt log."""
    port = _free_port()
    late = {}

    def start_late():
        time.sleep(0.3)
        late["engine"] = serve_model(_echo(), port=port, batch_size=4,
                                     flight_recorder=False)
    t = threading.Thread(target=start_late)
    t.start()
    dead = f"http://127.0.0.1:{_free_port()}"
    try:
        fleet = ServingFleet.connect(
            [f"http://127.0.0.1:{port}", dead], wait_ready_s=1.5,
            failure_threshold=1, breaker_cooldown=30.0)
        t.join()
        for i in range(4):
            assert fleet.post({"x": i}, timeout=5)["echo"] == i
        assert fleet.breakers[1].state == CircuitBreaker.OPEN
        assert fleet.transport_errors >= 1
        late["engine"].kill()
        with pytest.raises(ServingUnavailable) as ei:
            fleet.post({"x": 9}, timeout=2)
        assert all("address" in a and "error" in a
                   for a in ei.value.attempts)
    finally:
        t.join()
        if "engine" in late:
            late["engine"].stop()


# ---------------------------------------------------------------------------
# client trace legs (test_trace_propagation.py)
# ---------------------------------------------------------------------------


class TestClientLegSpans:
    def test_embedder_span_continues_into_fleet_post(self):
        tracer = Tracer(enabled=True)
        fleet = _fleet(_sleepy_scorer(), n_engines=1, batch_size=4,
                       tracer=tracer, slo=False)
        try:
            outer = tracer.new_trace("embedder.op")
            with use_span(outer.root):
                fleet.post({"x": 1}, timeout=10)
            tracer.finish(outer)
            posts = [t for t in tracer.buffer.traces()
                     if t.root.name == "fleet.post"]
            assert posts
            assert posts[-1].trace_id == outer.trace_id
            assert posts[-1].root.parent_id == outer.root.span_id
        finally:
            fleet.stop_all()

    def test_hedged_legs_share_trace_and_loser_cancelled(self):
        """ALL legs of one logical fleet.post share one trace id; the
        losing hedge leg is ``cancelled=true``, NOT ``error``."""
        tracer = Tracer(enabled=True)
        fleet = _fleet(_sleepy_scorer(), n_engines=2, batch_size=4,
                       tracer=tracer, hedge_percentile=50,
                       hedge_min_s=0.05, slo=False)
        try:
            for i in range(20):       # establish the hedge threshold
                fleet.post({"x": i}, timeout=10)
            hedges0 = fleet.hedged_requests
            body = fleet.post({"x": 3, "sleep": 0.6}, timeout=15)
            assert body == {"y": 6}
            assert fleet.hedged_requests == hedges0 + 1

            def hedged():
                posts = [t for t in tracer.buffer.traces()
                         if t.root.name == "fleet.post"]
                return [t for t in posts
                        if len([s for s in t.spans()
                                if s.name == "client.post"]) >= 2]
            assert _poll(lambda: bool(hedged()), True)
            tr = hedged()[-1]
            legs = [s for s in tr.spans() if s.name == "client.post"]
            assert len(legs) == 2
            assert {s.trace_id for s in legs} == {tr.trace_id}
            assert {s.parent_id for s in legs} == {tr.root.span_id}
            winners = [s for s in legs if not s.attrs.get("cancelled")]
            losers = [s for s in legs if s.attrs.get("cancelled")]
            assert len(winners) == 1 and len(losers) == 1
            assert losers[0].status != "error"
            assert losers[0].attrs["cancelled"] is True
            # server-side request traces CONTINUE the same trace id,
            # parented on the client legs (the losing leg's server
            # trace lands once its 0.6 s batch finishes)
            leg_ids = {s.span_id for s in legs}

            def server():
                return [t for t in tracer.buffer.traces()
                        if t.root.name == "request"
                        and t.trace_id == tr.trace_id]
            assert _poll(lambda: len(server()) >= 2, True)
            for st in server():
                assert st.root.parent_id in leg_ids
                assert st.root.attrs.get("remote_parent") is True
        finally:
            fleet.stop_all()

    def test_429_is_shed_not_error_on_client_trace(self):
        """A quota-style 429 surfaces to the caller unchanged (no
        failover: a tenant's quota is fleet-wide), and the client's
        fleet.post root is shed=true, not error."""
        class Quota(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 (http.server API)
                self.rfile.read(int(self.headers["Content-Length"]))
                body = b'{"error": "quota"}'
                self.send_response(429)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Retry-After", "1")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass
        server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Quota)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        engine = serve_model(_echo(), port=0, flight_recorder=False)
        tracer = Tracer(enabled=True)
        try:
            fleet = ServingFleet.connect(
                [f"http://127.0.0.1:{server.server_address[1]}",
                 engine.source.address], tracer=tracer)
            with pytest.raises(urllib.error.HTTPError) as exc:
                fleet.post({"x": 2}, timeout=10)
            assert exc.value.code == 429
            posts = [t for t in tracer.buffer.traces()
                     if t.root.name == "fleet.post"
                     and t.root.attrs.get("http_status") == 429]
            assert posts, "429 fleet.post trace not buffered"
            assert posts[-1].root.attrs.get("shed") is True
            assert not posts[-1].is_error
            legs = [s for s in posts[-1].spans() if s.name == "client.post"]
            assert len(legs) == 1 and legs[0].attrs.get("shed") is True
            assert fleet.breakers[0].state == CircuitBreaker.CLOSED
        finally:
            server.shutdown()
            server.server_close()
            engine.stop()

    def test_failover_legs_share_trace_id(self):
        """A leg that fails at transport level and the replica that
        rescues it are siblings in ONE trace."""
        engine = serve_model(_sleepy_scorer(), port=0, batch_size=4,
                             tracing=False, slo=False,
                             flight_recorder=False)
        dead = f"http://127.0.0.1:{_free_port()}"
        tracer = Tracer(enabled=True)
        fleet = ServingFleet.connect(
            [dead, engine.source.address], tracer=tracer,
            failure_threshold=1000)   # dead stays in rotation
        try:
            for _ in range(4):
                assert fleet.post({"x": 5}, timeout=10) == {"y": 10}
            posts = [t for t in tracer.buffer.traces()
                     if t.root.name == "fleet.post"]
            multi = [t for t in posts
                     if len([s for s in t.spans()
                             if s.name == "client.post"]) == 2]
            assert multi, "no failover post captured"
            legs = [s for s in multi[-1].spans()
                    if s.name == "client.post"]
            assert {s.trace_id for s in legs} == {multi[-1].trace_id}
            assert sorted(s.status for s in legs) == ["error", "ok"]
            assert multi[-1].root.attrs.get("failovers") == 1
        finally:
            fleet.stop_all()
            engine.stop()


def test_cross_process_retry_hedge_one_trace(tmp_path):
    """One logical ``fleet.post`` traversing a transport-level retry
    (dead address) AND a hedge across TWO port engine processes
    reassembles into ONE trace, proven from the engines' exported
    buffers merged with the client's."""
    worker = os.path.join(os.path.dirname(__file__),
                          "torch_traced_worker.py")
    procs, addrs, pids, dumps = [], {}, {}, {}
    try:
        for wid in range(2):
            dump = str(tmp_path / f"worker{wid}.json")
            p = subprocess.Popen(
                [sys.executable, worker, str(_free_port()), str(wid),
                 dump],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
            procs.append(p)
        for wid, p in enumerate(procs):
            line = p.stdout.readline().strip()   # blocks until READY
            tag, wid_s, addr, pid_s = line.split()
            assert tag == "READY" and int(wid_s) == wid, line
            addrs[wid], pids[wid] = addr, int(pid_s)
            dumps[wid] = str(tmp_path / f"worker{wid}.json")

        dead = f"http://127.0.0.1:{_free_port()}"
        tracer = Tracer(enabled=True)
        fleet = ServingFleet.connect(
            [dead, addrs[0], addrs[1]], tracer=tracer,
            failure_threshold=1000,   # the dead leg stays in rotation
            hedge_percentile=50, hedge_min_s=0.05)
        for i in range(20):
            assert fleet.post({"x": i}, timeout=15)["echo"] == i
        target = None
        for i in range(9):
            hedges0 = fleet.hedged_requests
            fleet.post({"x": 100 + i, "stall_worker": 0,
                        "stall_s": 0.8}, timeout=20)
            if fleet.hedged_requests == hedges0:
                continue
            for t in tracer.buffer.traces():
                if t.root.name != "fleet.post":
                    continue
                legs = [s for s in t.spans() if s.name == "client.post"]
                if len(legs) >= 3:    # dead + stalled + hedge
                    target = t
                    break
            if target is not None:
                break
        assert target is not None, \
            "no post traversed retry + hedge (3 client legs)"
        legs = [s for s in target.spans() if s.name == "client.post"]
        assert {s.trace_id for s in legs} == {target.trace_id}
        assert {s.parent_id for s in legs} == {target.root.span_id}
        assert [s for s in legs if s.status == "error"]
        assert [s for s in legs if s.attrs.get("cancelled")]

        time.sleep(1.2)   # the stalled worker finishes the lost leg
        for _ in range(2):
            try:
                fleet.post({"__shutdown__": True}, timeout=15)
            except Exception:  # noqa: BLE001 — both may be down already
                pass
        for wid, p in enumerate(procs):
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, \
                f"worker {wid} rc={p.returncode}\n{err}"
            assert f"DUMPED {wid}" in out, out

        exports = [json.load(open(dumps[wid])) for wid in (0, 1)]
        client_export = to_chrome_trace(
            tracer.buffer.traces(),
            process_name=f"fleet client pid={os.getpid()}")
        merged = merge_chrome_traces(client_export, *exports)
        tid = target.trace_id
        events = [e for e in merged["traceEvents"]
                  if e.get("ph") == "X"
                  and e.get("args", {}).get("trace_id") == tid]
        ev_pids = {e["pid"] for e in events}
        assert {pids[0], pids[1], os.getpid()} <= ev_pids
        metas = {e["pid"]: e["args"]["name"]
                 for e in merged["traceEvents"]
                 if e.get("ph") == "M" and e["name"] == "process_name"}
        assert "engine" in metas[pids[0]] and "engine" in metas[pids[1]]
        leg_ids = {s.span_id for s in legs}
        server_roots = [e for e in events if e["name"] == "request"
                        and e["pid"] in (pids[0], pids[1])]
        assert len(server_roots) >= 2
        for ev in server_roots:
            assert ev["args"].get("parent_id") in leg_ids
        json.dumps(merged)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


# ---------------------------------------------------------------------------
# exposition (test_observability.py) and the breaker's recorder hook
# ---------------------------------------------------------------------------


def _split_scorer():
    def decode(table):
        return [json.loads(r["entity"].decode())["x"]
                for r in table["request"]]

    def execute(table, xs):
        return table.with_column("reply", [{"y": v * 2} for v in xs])

    lam = Lambda.apply(lambda t: execute(t, decode(t)))
    lam.prepare_batch = decode
    lam.execute_prepared = execute
    lam.jit_cache_miss_count = lambda: 0
    lam.bucket_for = lambda rows: 8
    return lam


def test_fleet_metrics_text_grammar():
    tracer = Tracer(enabled=True)
    fleet = _fleet(_split_scorer(), n_engines=2, batch_size=8,
                   tracer=tracer)
    try:
        for i in range(6):
            fleet.post({"x": i})
        _poll(lambda: fleet.counters()["answered"], 6)
        text = fleet.metrics_text()
    finally:
        fleet.stop_all()
    assert metrics_check.audit_text(text, "fleet.metrics_text()") == []
    samples = [re.match(r'([A-Za-z_:][A-Za-z0-9_:]*)(\{.*\})? (\S+)$',
                        line).groups()
               for line in text.splitlines()
               if line and not line.startswith("#")]
    names = {n for n, _l, _v in samples}
    for required in ("serving_fleet_transport_errors_total",
                     "serving_fleet_hedged_requests_total",
                     "serving_swaps_completed_total",
                     "serving_model_info", "serving_pipeline_ms_bucket",
                     "serving_slo_burn_rate"):
        assert required in names, required
    engines = {re.search(r'engine="(\d+)"', l).group(1)
               for n, l, _v in samples
               if n == "serving_requests_answered_total"}
    assert engines == {"0", "1"}
    # fleet traces: the shared tracer saw both engines' traffic
    assert len(fleet.traces()["traceEvents"]) > 0
    assert metrics_check.audit_file(
        os.path.join(ROOT, "mmlspark_tpu_torch/serving/fleet.py")) == []


def test_breaker_opening_triggers_the_flight_recorder():
    from mmlspark_tpu_torch.core.flightrecorder import FlightRecorder
    rec = FlightRecorder(min_interval_s=0.0, capture_logs=False)
    fleet = ServingFleet(_echo(), n_engines=2, base_port=0, batch_size=4,
                         failure_threshold=1, breaker_cooldown=30.0,
                         flight_recorder=rec)
    try:
        assert fleet.post({"x": 1})["echo"] == 1
        fleet.kill_engine(1)
        for i in range(4):
            assert fleet.post({"x": i})["echo"] == i
        assert fleet.breakers[1].state == CircuitBreaker.OPEN

        def reasons():
            return [b["reason"] for b in list(rec.bundles)]
        assert _poll(lambda: any(r.startswith("circuit_open:engine1@")
                                 for r in reasons()), True), reasons()
    finally:
        fleet.stop_all()
        rec.close()


# ---------------------------------------------------------------------------
# the retry-loop guard (test_resilience.py), over the port
# ---------------------------------------------------------------------------


def test_no_ad_hoc_retry_loops_outside_resilience():
    """A sleep() within a few lines of a retry/attempt loop header
    anywhere in the port outside utils/resilience.py is an ad-hoc retry
    implementation — the fleet's retries and failover go through
    RetryPolicy / CircuitBreaker instead."""
    root = os.path.join(ROOT, "mmlspark_tpu_torch")
    loop_re = re.compile(r"^\s*(for|while)\b.*(attempt|retr|backoff)",
                         re.IGNORECASE)
    sleep_re = re.compile(r"\bsleep\(")
    offenders = []
    scanned = 0
    for dirpath, _, files in os.walk(root):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, root)
            if rel == os.path.join("utils", "resilience.py"):
                continue
            scanned += 1
            with open(path, encoding="utf-8") as f:
                lines = f.readlines()
            for i, line in enumerate(lines):
                if loop_re.search(line):
                    window = "".join(lines[i:i + 10])
                    if sleep_re.search(window):
                        offenders.append(f"{rel}:{i + 1}")
    assert scanned > 50
    assert not offenders, (
        "ad-hoc sleep-loop retry outside utils/resilience.py "
        f"(use RetryPolicy): {offenders}")


# ---------------------------------------------------------------------------
# the spawned load client (testing/fleet_load.py)
# ---------------------------------------------------------------------------


def test_fleet_load_client_process():
    """The spawned client drives a fleet through ``connect``: one record
    per request on the shared monotonic clock, its counters, a traced
    post whose trace id the engine's request span continues, and a clean
    exit."""
    from mmlspark_tpu_torch.testing.fleet_load import FleetLoad

    def score(table):
        return table.with_column("reply", [
            {"s": float(sum(json.loads(r["entity"].decode())["features"]))}
            for r in table["request"]])
    tracer = Tracer(enabled=True)
    fleet = _fleet(Lambda.apply(score), n_engines=2, batch_size=8,
                   tracer=tracer)
    rows = np.arange(40.0).reshape(10, 4)
    load = FleetLoad(fleet.addresses, rows)
    try:
        t0 = time.monotonic()
        records, stats = load.run(list(range(10)) * 5, 4)
        assert len(records) == 50 and load.progress.value == 50
        for i, reply, ts, te, err in records:
            assert err is None and reply == {"s": float(rows[i].sum())}
            assert t0 <= ts <= te <= time.monotonic()
        assert stats["transport_errors"] == 0
        assert stats["breakers"] == ["closed", "closed"]
        reply, trace_id, client_json = load.traced_post(3)
        assert reply == {"s": float(rows[3].sum())}
        client = json.loads(client_json)
        assert any(e.get("args", {}).get("trace_id") == trace_id
                   for e in client["traceEvents"])
        assert _poll(lambda: any(t.trace_id == trace_id
                                 for t in tracer.buffer.traces()), True)
        # another address set rides the same process
        records, _ = load.run([0, 1], 1, addresses=fleet.addresses[:1])
        assert [r[1] for r in records] == [{"s": 6.0}, {"s": 22.0}]
    finally:
        assert load.close() == 0
        fleet.stop_all()
