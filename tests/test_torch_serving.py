"""PyTorch port: the HTTP serving engine, its scorers and the CLI.

The ``TestServing`` / ``TestAdaptiveBatcher`` scenarios of
tests/test_http_serving.py that the serving slice covers, driven through
the port's engine on the CPU (``device="cpu"``, ``port=0``), plus:
one seeded GBDT model saved by the JAX package and served by both
packages' engines with the same JSON rows (equal replies); MCOL frames
crossing the packages; ``RetryPolicy``'s schedule against the
reference's under one seeded ``random.Random``; and ``cli score`` /
``cli serve``. Counters that a reply's handler bumps after writing it
are polled, never read once. Every engine is stopped in ``finally`` and
every client call has a timeout.
"""

import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import jax

from mmlspark_tpu.core.metrics import DriftMonitor as JDriftMonitor
from mmlspark_tpu.core.metrics import WindowedCounter as JWindowedCounter
from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.gbdt.estimators import TPUBoostClassifier as JClassifier
from mmlspark_tpu.io import columnar as jcol
from mmlspark_tpu.models.networks import build_network as jbuild
from mmlspark_tpu.serving.fleet import (
    json_row_scoring_pipeline as jrow_pipeline,
    json_scoring_pipeline as jscoring_pipeline,
)
from mmlspark_tpu.serving.server import serve_model as jserve_model
from mmlspark_tpu.utils import resilience as jres
from mmlspark_tpu.utils.resilience import RetryPolicy as JRetryPolicy

import mmlspark_tpu_torch as mtt
from mmlspark_tpu_torch import convert
from mmlspark_tpu_torch.core.metrics import DriftMonitor, WindowedCounter
from mmlspark_tpu_torch.io import columnar as tcol
from mmlspark_tpu_torch.serving import (
    HTTPSource, SharedSingleton, SharedVariable, json_row_scoring_pipeline,
    json_scoring_pipeline, serve_model,
)
from mmlspark_tpu_torch.stages.basic import Lambda
from mmlspark_tpu_torch.utils import resilience as tres
from mmlspark_tpu_torch.utils.resilience import RetryPolicy

REPO = Path(__file__).resolve().parent.parent


def _post(addr, payload, timeout=20, headers=None):
    body = payload if isinstance(payload, bytes) else \
        json.dumps(payload).encode()
    req = urllib.request.Request(
        addr, data=body,
        headers=headers or {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _poll(fn, want, timeout=10.0):
    """Poll ``fn()`` until it equals ``want``; the handler counts a reply
    only after writing it, so a client can see the reply first."""
    deadline = time.monotonic() + timeout
    got = fn()
    while got != want and time.monotonic() < deadline:
        time.sleep(0.01)
        got = fn()
    return got


def _run_clients(n, fn):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)


def _echo(table):
    return table.with_column("reply", [
        {"doubled": json.loads(r["entity"].decode())["x"] * 2}
        for r in table["request"]])


def _poisonable(table):
    replies = []
    for req in table["request"]:
        body = json.loads(req["entity"].decode())
        if body.get("boom"):
            raise RuntimeError("poison row")
        replies.append({"ok": body["x"]})
    return table.with_column("reply", replies)


@pytest.fixture(scope="module")
def echo_server():
    engine = serve_model(Lambda.apply(_echo), port=0, batch_size=8)
    yield engine
    engine.stop()


# ---------------------------------------------------------------------------
# TestServing scenarios
# ---------------------------------------------------------------------------


def test_single_request(echo_server):
    assert _post(echo_server.source.address, {"x": 21}) == \
        (200, {"doubled": 42})


def test_concurrent_requests_route_correctly(echo_server):
    results = {}

    def client(i):
        results[i] = _post(echo_server.source.address,
                           {"x": i})[1]["doubled"]

    _run_clients(24, client)
    assert results == {i: 2 * i for i in range(24)}


def test_counters_are_polled(echo_server):
    src = echo_server.source
    before = src.requests_answered
    _post(src.address, {"x": 1})
    assert _poll(lambda: src.requests_answered, before + 1) == before + 1
    assert src.requests_seen >= src.requests_accepted >= before + 1


def test_pipeline_error_returns_500():
    def boom(table):
        raise RuntimeError("kaboom")
    engine = serve_model(Lambda.apply(boom), port=0, batch_size=4)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(engine.source.address, {"x": 1})
        assert ei.value.code == 500
    finally:
        engine.stop()


@pytest.mark.parametrize("workers,n,poison", [
    (1, 6, {3}), (3, 24, set(range(0, 24, 4)))])
def test_poison_rows_isolated_from_batch(workers, n, poison):
    engine = serve_model(Lambda.apply(_poisonable), port=0,
                         batch_size=4 if workers > 1 else 8,
                         workers=workers)
    try:
        results = {}

        def client(i):
            payload = {"boom": True, "x": i} if i in poison else {"x": i}
            try:
                results[i] = _post(engine.source.address, payload)[1]
            except urllib.error.HTTPError as e:
                results[i] = e.code

        _run_clients(n, client)
        for i in range(n):
            assert results[i] == (500 if i in poison else {"ok": i}), \
                (i, results[i])
    finally:
        engine.stop()


def test_healthz_and_unported_endpoints(echo_server):
    addr = echo_server.source.address
    status, body = _get(f"{addr}/healthz")
    assert status == 200 and body["status"] == "ok"
    for key in ("seen", "accepted", "answered", "rejected", "parked",
                "queue_depth"):
        assert key in body, body
    m = body["metrics"]
    assert m["model_version"] == "v0"
    # telemetry is on by default: the SLO monitor's section is in
    # metrics() and /healthz, and so are the lifecycle fields; the
    # unported planes' sections are not
    assert m["swap_state"] == "idle" and m["swaps_completed"] == 0
    assert m["swaps_rolled_back"] == 0
    assert not {"admission", "zoo"} & set(m), m
    assert m["slo"]["objectives"] and body["slo"]["degraded"] is False
    assert m["precision"] == "f32" and m["retry_after_s"] >= 1
    with urllib.request.urlopen(addr + "/metrics", timeout=10) as r:
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/plain")
        assert "serving_slo_burn_rate" in r.read().decode()
    for path in ("/debug/traces", "/debug/bundle?confirm=1"):
        status, payload = _get(addr + path)
        assert status == 200
        assert "traceEvents" in (payload if path == "/debug/traces"
                                 else payload["traces"])
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"{addr}/other", timeout=10)
    assert ei.value.code == 404
    assert _post(addr, {"x": 2})[1] == {"doubled": 4}


def test_error_col_splits_rows():
    def handle(table):
        replies, errors = [], []
        for req in table["request"]:
            x = json.loads(req["entity"].decode())["x"]
            replies.append(None if x < 0 else {"ok": x})
            errors.append(f"negative x {x}" if x < 0 else None)
        return (table.with_column("reply", replies)
                .with_column("error", errors))

    engine = serve_model(Lambda.apply(handle), port=0, batch_size=8)
    try:
        assert _post(engine.source.address, {"x": 5})[1] == {"ok": 5}
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(engine.source.address, {"x": -1})
        assert ei.value.code == 500
    finally:
        engine.stop()


def test_parked_table_sheds_with_retry_after():
    gate = threading.Event()

    def stall(table):
        gate.wait(20)
        return _echo(table)

    src = HTTPSource(port=0, max_parked=1)
    from mmlspark_tpu_torch.serving.server import ServingEngine
    engine = ServingEngine(src, Lambda.apply(stall), batch_size=1).start()
    try:
        first = {}
        t = threading.Thread(target=lambda: first.setdefault(
            "r", _post(src.address, {"x": 3})))
        t.start()
        assert _poll(lambda: len(src._pending), 1) == 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(src.address, {"x": 4})
        assert ei.value.code == 503
        assert int(ei.value.headers["Retry-After"]) >= 1
        gate.set()
        t.join(timeout=20)
        assert first["r"] == (200, {"doubled": 6})
        assert _poll(lambda: src.requests_rejected, 1) == 1
    finally:
        gate.set()
        engine.stop()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_supervisor_restarts_a_dead_worker():
    engine = serve_model(Lambda.apply(_echo), port=0, batch_size=4)
    try:
        def die(*a, **k):
            raise SystemExit("worker killed")
        orig = engine._execute_batch
        engine._execute_batch = die
        # the dying worker never answers its batch: the client times out
        with pytest.raises(OSError):
            _post(engine.source.address, {"x": 1}, timeout=1)
        engine._execute_batch = orig
        assert _poll(lambda: engine.workers_restarted >= 1, True)
        assert _post(engine.source.address, {"x": 5})[1] == \
            {"doubled": 10}
        assert engine.is_alive()
    finally:
        engine.stop()


def test_replies_are_sent_without_nagle_delay(echo_server):
    """Headers and body leave in two sends; with Nagle's algorithm on,
    the body waits for the client's delayed ACK. The port's handler
    sets TCP_NODELAY on every connection it accepts."""
    import socket
    handler = echo_server.source.server.RequestHandlerClass
    assert handler.disable_nagle_algorithm is True
    seen = []
    orig = handler.setup

    def setup(self):
        orig(self)
        seen.append(self.connection.getsockopt(socket.IPPROTO_TCP,
                                               socket.TCP_NODELAY))

    handler.setup = setup
    try:
        assert _post(echo_server.source.address, {"x": 3})[1] == \
            {"doubled": 6}
    finally:
        handler.setup = orig
    assert seen and all(seen)


def test_shared_variable_and_singleton():
    calls = []
    sv = SharedVariable(lambda: calls.append(1) or "v")
    assert sv.get() == "v" and sv.get() == "v" and calls == [1]
    a = SharedSingleton.get_or_create("torch-serving-test", object)
    assert SharedSingleton.get_or_create("torch-serving-test", object) is a


@pytest.mark.parametrize("kw,item", [
    ({"tracing": True}, None),
    ({"tracer": "tracer"}, None),
    ({"slo": "slo"}, None),
    ({"flight_recorder": "recorder"}, None),
    ({"zoo": object()}, "The multi-model plane"),
    ({"admission": object()}, "The multi-model plane"),
    ({"variants": object()}, "The multi-model plane"),
])
def test_unported_serving_options_raise(kw, item):
    """The telemetry options are ported and in force; so are the
    multi-model plane's (``item`` names their ROADMAP item): a zoo, an
    admission controller or a variant selector attached to an engine
    serves model-routed requests."""
    if item is not None:
        from mmlspark_tpu_torch.serving import (
            AdmissionController, ModelZoo, VariantSelector,
        )
        zoo = ModelZoo(memory_probe=None, device="cpu")
        zoo.register_factory("m", "v1", lambda: Lambda.apply(_echo))
        given = {"zoo": zoo, "admission": AdmissionController(),
                 "variants": VariantSelector(zoo)}
        kw = {k: given[k] for k in kw}
        kw.setdefault("zoo", zoo)
        engine = serve_model(Lambda.apply(_echo), port=0, **kw)
        try:
            assert _post(engine.source.address, {"x": 4},
                         headers={"X-Model": "m"})[1] == {"doubled": 8}
            metrics = engine.metrics()
            assert "zoo" in metrics
            assert ("admission" in metrics) == ("admission" in kw)
            assert ("variants" in metrics) == ("variants" in kw)
        finally:
            engine.stop()
            zoo.close()
        return
    from mmlspark_tpu_torch.core.flightrecorder import FlightRecorder
    from mmlspark_tpu_torch.core.slo import SLOMonitor
    from mmlspark_tpu_torch.core.trace import Tracer, get_tracer
    given = {"tracer": Tracer(enabled=True), "slo": SLOMonitor(),
             "recorder": FlightRecorder(min_interval_s=0.0)}
    kw = {k: given.get(v, v) for k, v in kw.items()}
    engine = serve_model(Lambda.apply(_echo), port=0, **kw)
    try:
        assert _post(engine.source.address, {"x": 4})[1] == {"doubled": 8}
        want_tracer = kw.get("tracer", get_tracer())
        assert engine.tracer is want_tracer
        assert _poll(lambda: any(t.root.name == "request"
                                 for t in want_tracer.buffer.traces()),
                     True)
        if "slo" in kw:
            assert engine.slo is kw["slo"]
            assert _poll(lambda: kw["slo"].requests(60.0), 1.0) == 1.0
        if "flight_recorder" in kw:
            rec = kw["flight_recorder"]
            assert engine.flight_recorder is rec
            assert engine.slo.on_fire is not None
            assert rec.stats()["tracers"] == 1
    finally:
        engine.stop()
        if "flight_recorder" in kw:
            kw["flight_recorder"].close()


def test_swap_and_fused_scoring_raise(echo_server):
    """``swap()`` is ported (serving/lifecycle.py): a plain stage swaps
    in through a direct cutover, and a fused pipeline scorer, whose
    warmup needs an example, rolls back without one
    (tests/test_torch_lifecycle.py holds the protocol itself, fused
    swaps included). A zoo-only engine (no default pipeline) serves
    model-routed requests and answers an unkeyed one 400."""
    from mmlspark_tpu_torch.serving import CanaryPolicy
    engine = serve_model(Lambda.apply(_echo), port=0, batch_size=8,
                         version="v0", flight_recorder=False)
    try:
        res = engine.swap(Lambda.apply(_echo), "v1",
                          policy=CanaryPolicy(fraction=0.0))
        assert res.completed and engine.model_version == "v1"
        scorer = json_scoring_pipeline(
            mtt.PipelineModel(stages=[]).fused(device="cpu"))
        assert scorer.scorer.reply_col == "prediction"
        res = engine.swap(scorer, "v2", policy=CanaryPolicy(fraction=0.0))
        assert res.rolled_back and "requires an example" in res.reason
        assert engine.model_version == "v1"
        assert engine.swaps_completed == 1
        assert engine.swaps_rolled_back == 1
    finally:
        engine.stop()
    from mmlspark_tpu_torch.serving import ModelZoo
    zoo = ModelZoo(memory_probe=None, device="cpu")
    zoo.register_factory("m", "v1", lambda: Lambda.apply(_echo))
    engine = serve_model(None, port=0, zoo=zoo, flight_recorder=False)
    try:
        assert _post(engine.source.address, {"x": 2},
                     headers={"X-Model": "m"})[1] == {"doubled": 4}
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(engine.source.address, {"x": 2})
        assert err.value.code == 400
    finally:
        engine.stop()
        zoo.close()


# ---------------------------------------------------------------------------
# TestHTTPClient / TestMiniBatch scenarios
# ---------------------------------------------------------------------------


def test_http_client_stages_against_the_engine(echo_server):
    from mmlspark_tpu_torch.io.http import (
        CustomInputParser, CustomOutputParser, HTTPSchema, HTTPTransformer,
        SimpleHTTPTransformer)
    from mmlspark_tpu_torch.io.minibatch import FixedMiniBatchTransformer
    addr = echo_server.source.address
    reqs = [HTTPSchema.request(addr, "POST", json.dumps({"x": v}).encode(),
                               {"Content-Type": "application/json"})
            for v in (3, 4)]
    out = HTTPTransformer(inputCol="req", outputCol="resp", concurrency=2
                          ).transform(mtt.DataTable({"req": reqs}))
    assert [json.loads(r["entity"]) for r in out["resp"]] == \
        [{"doubled": 6}, {"doubled": 8}]
    out = SimpleHTTPTransformer(inputCol="x", outputCol="parsed", url=addr
                                ).transform(mtt.DataTable(
                                    {"x": [{"x": 1}, {"x": 2}]}))
    assert list(out["parsed"]) == [{"doubled": 2}, {"doubled": 4}]
    assert all(e is None for e in out["HTTPTransformer_errors"])
    inp = CustomInputParser(udf=lambda v: HTTPSchema.request(
        addr, "POST", json.dumps({"x": v}).encode()))
    outp = CustomOutputParser(
        udf=lambda r: json.loads(r["entity"])["doubled"])
    out = SimpleHTTPTransformer(inputCol="x", outputCol="y",
                                inputParser=inp, outputParser=outp
                                ).transform(mtt.DataTable({"x": [7.0]}))
    assert out["y"][0] == 14.0
    # a dead port: the basic handler turns it into a status-0 row, and
    # a mini-batched SimpleHTTPTransformer keeps the batch's error on
    # every flattened row
    dead = "http://127.0.0.1:1/none"
    out = HTTPTransformer(inputCol="req", outputCol="resp",
                          handlingStrategy="basic").transform(
        mtt.DataTable({"req": [HTTPSchema.request(dead, "POST", b"{}")]}))
    assert out["resp"][0]["statusLine"]["statusCode"] == 0
    sh = SimpleHTTPTransformer(inputCol="x", outputCol="parsed",
                               timeout=2.0, url=dead)
    sh.set_mini_batcher(FixedMiniBatchTransformer(batchSize=2))
    out = sh.transform(mtt.DataTable({"x": [{"x": 1}, {"x": 2}]}))
    assert len(out) == 2
    assert all(e is not None for e in out["HTTPTransformer_errors"])


def test_minibatch_stages_match_reference():
    from mmlspark_tpu.io import minibatch as jmb
    from mmlspark_tpu_torch.io import minibatch as tmb
    cols = {"ts": np.asarray([0, 10, 2000, 2010, 9000]),
            "v": np.arange(5).astype(float),
            "s": [f"r{i}" for i in range(5)]}
    for name, kw in (("FixedMiniBatchTransformer", {"batchSize": 2}),
                     ("DynamicMiniBatchTransformer", {}),
                     ("TimeIntervalMiniBatchTransformer",
                      {"millisToWait": 500, "timestampCol": "ts"})):
        got = getattr(tmb, name)(**kw).transform(
            mtt.DataTable(cols, num_shards=2))
        want = getattr(jmb, name)(**kw).transform(
            JTable(cols, num_shards=2))
        assert [len(b) for b in got["v"]] == [len(b) for b in want["v"]]
        flat = tmb.FlattenBatch().transform(got)
        assert list(flat["s"]) == list(
            jmb.FlattenBatch().transform(want)["s"])
    flat = tmb.FlattenBatch().transform(mtt.DataTable(
        {"vals": [[1.0, 2.0], [3.0]], "err": ["batch0_err", None]}))
    assert list(flat["err"]) == ["batch0_err", "batch0_err", None]


def test_api_path_routing():
    src = HTTPSource(port=0, api_path="/score")
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"{src.address}/other", {"x": 1})
        assert ei.value.code == 404
    finally:
        src.close()


# ---------------------------------------------------------------------------
# TestAdaptiveBatcher scenarios
# ---------------------------------------------------------------------------


def test_deadline_triggered_flush():
    engine = serve_model(Lambda.apply(_echo), port=0, batch_size=64,
                         max_wait_ms=30.0)
    try:
        t0 = time.perf_counter()
        assert _post(engine.source.address, {"x": 7}) == \
            (200, {"doubled": 14})
        assert time.perf_counter() - t0 < 5.0
        assert engine.batches_processed >= 1
        assert engine.hists["batch_rows"].summary()["max"] == 1.0
    finally:
        engine.stop()


def test_max_batch_triggered_flush():
    engine = serve_model(Lambda.apply(_echo), port=0, batch_size=4,
                         max_wait_ms=10_000.0)
    try:
        results = {}

        def client(i):
            results[i] = _post(engine.source.address, {"x": i})[1]

        t0 = time.perf_counter()
        _run_clients(4, client)
        assert results == {i: {"doubled": 2 * i} for i in range(4)}
        # a deadline-only flush would have taken >= 10 s
        assert time.perf_counter() - t0 < 5.0
    finally:
        engine.stop()


MLP_SPEC = {"type": "mlp", "features": [16], "num_classes": 5}


def test_pad_and_mask_with_mlp_tpumodel():
    """N concurrent requests with distinct payloads each get their own
    model output (the JAX module's argmax on the same weights), exactly
    N replies exist, and warmup covers every bucket once."""
    dim = 8
    variables = jbuild(MLP_SPEC).init(jax.random.key(0),
                                      np.zeros((1, dim), np.float32))
    module = convert.module_from_flax(MLP_SPEC, variables, device="cpu")
    model = mtt.TPUModel.from_module(module, device="cpu",
                                     inputCol="features",
                                     outputCol="scores", batchSize=64)
    feats = np.random.default_rng(3).normal(size=(5, dim)).astype(
        np.float32)
    expected = np.asarray(jbuild(MLP_SPEC).apply(variables, feats)
                          ).argmax(-1)
    scorer = json_scoring_pipeline(model)
    assert scorer.warmup({"features": feats}) == len(model.bucket_sizes())
    assert scorer.warmup({"features": feats}) == 0
    assert scorer.jit_cache_miss_count() == len(model.bucket_sizes())
    engine = serve_model(scorer, port=0, batch_size=64, max_wait_ms=50.0)
    try:
        results = {}

        def client(i):
            results[i] = _post(engine.source.address,
                               {"features": feats[i].tolist()}
                               )[1]["prediction"]

        _run_clients(5, client)
        assert results == {i: int(expected[i]) for i in range(5)}
        assert _poll(lambda: engine.source.requests_answered, 5) == 5
        stage = _get(f"{engine.source.address}/healthz")[1][
            "metrics"]["pipeline_stage"]
        assert stage["jit_cache_misses"] == len(model.bucket_sizes())
        assert set(model.histograms()) == {"pad_ms", "device_ms",
                                           "readback_ms"}
    finally:
        engine.stop()


def test_first_run_shape_counter_holds_under_concurrent_transforms():
    """Many threads transforming at once, with a short switch interval:
    each distinct bucket counts once (a lost or doubled update to the
    shape set would break the equality)."""
    net = mtt.build_network({"type": "mlp", "features": [8],
                             "num_classes": 3, "in_features": 4},
                            device="cpu", seed=1)
    model = mtt.TPUModel.from_module(net, device="cpu", inputCol="x",
                                     outputCol="y", batchSize=64)
    x = np.random.default_rng(2).normal(size=(64, 4)).astype(np.float32)
    sizes = [1, 9, 17, 33, 64, 5, 12, 30]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run_clients(32, lambda i: model.transform(
            mtt.DataTable({"x": x[:sizes[i % len(sizes)]]})))
    finally:
        sys.setswitchinterval(old)
    want = {model.bucket_for(n) for n in sizes}
    assert model.jit_cache_misses == len(want) == 4


def test_split_pipeline_decode_runs_on_batcher():
    calls = []

    def decode(table):
        calls.append(len(table))
        return [json.loads(r["entity"].decode())["x"]
                for r in table["request"]]

    def execute(table, xs):
        return table.with_column("reply",
                                 [{"doubled": 2 * x} for x in xs])

    lam = Lambda.apply(lambda table: execute(table, decode(table)))
    lam.prepare_batch = decode
    lam.execute_prepared = execute
    engine = serve_model(lam, port=0, batch_size=8, max_wait_ms=5.0)
    try:
        assert _post(engine.source.address, {"x": 4})[1] == {"doubled": 8}
        assert engine.hists["decode_ms"].summary()["count"] >= 1
        assert calls
    finally:
        engine.stop()


def test_drain_parked_embedder_flushes_on_rows_and_on_deadline():
    """``HTTPSource`` without an engine: ``drain_parked`` returns at
    ``max_rows`` or once ``max_wait_s`` has passed since the first
    request, stamps each request's dequeue time, and ``respond`` answers
    through the held connection."""
    src = HTTPSource(port=0)
    try:
        results = {}

        def client(i):
            results[i] = _post(src.address, {"x": i})[1]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(5)]
        for t in threads:
            t.start()
        _poll(lambda: src.queue.qsize(), 5)
        sizes = []
        deadline = time.monotonic() + 10
        while sum(sizes) < 5 and time.monotonic() < deadline:
            parked = src.drain_parked(max_rows=3, max_wait_s=0.05)
            sizes.append(len(parked))
            for p in parked:
                assert p.dequeued_at >= p.enqueued_at
                x = json.loads(p.request["entity"].decode())["x"]
                src.respond(p.id, {"statusLine": {"statusCode": 200},
                                   "entity": json.dumps({"x": x}).encode()})
        for t in threads:
            t.join(timeout=10)
        assert sizes == [3, 2]
        assert results == {i: {"x": i} for i in range(5)}
        assert src.drain_parked(3, 0.01, poll_s=0.01) == []
    finally:
        src.close()


# ---------------------------------------------------------------------------
# the two packages' engines on one GBDT model
# ---------------------------------------------------------------------------


def _higgs_shape(n=3000, seed=7):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 28)).astype(np.float32)
    logit = (X[:, 0] + 0.6 * X[:, 1] * X[:, 2]
             + 0.4 * np.sin(2 * X[:, 3]) - 0.3 * X[:, 4] ** 2 + 0.3)
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return X[:2400], y[:2400], X[2400:], y[2400:]


@pytest.fixture(scope="module")
def saved_jax_gbdt(tmp_path_factory):
    Xtr, ytr, Xte, _ = _higgs_shape()
    path = str(tmp_path_factory.mktemp("gbdt") / "jax_model")
    JClassifier(numIterations=6, numLeaves=15, maxBin=63).fit(
        JTable({"features": Xtr, "label": ytr})).save(path)
    return path, Xte[:40]


def _serve_rows(engine, rows, n_threads=8):
    results = {}

    def client(i):
        for j in range(i, len(rows), n_threads):
            results[j] = _post(engine.source.address, rows[j])[1]

    _run_clients(n_threads, client)
    assert _poll(lambda: engine.source.requests_answered,
                 len(rows)) == len(rows)
    return [results[j] for j in range(len(rows))]


def test_jax_saved_gbdt_serves_equal_replies_in_both_engines(
        saved_jax_gbdt):
    from mmlspark_tpu.core.serialize import load_stage as jload
    path, X = saved_jax_gbdt
    jm = jload(path)
    tm = mtt.load_stage(path)
    tm.set("device", "cpu")
    rows = [{"features": x.tolist()} for x in X]
    replies = {}
    for name, serve, score, row_score, model in (
            ("jax", jserve_model, jscoring_pipeline, jrow_pipeline, jm),
            ("port", serve_model, json_scoring_pipeline,
             json_row_scoring_pipeline, tm)):
        out = {}
        for key, scorer in (
                ("prediction", score(model)),
                ("rawPrediction", row_score(model,
                                            reply_col="rawPrediction")),
                ("probability", row_score(model,
                                          reply_col="probability"))):
            engine = serve(scorer, port=0, batch_size=16, workers=2,
                           max_wait_ms=5.0)
            try:
                out[key] = _serve_rows(engine, rows)
            finally:
                engine.stop()
        replies[name] = out
    jr, tr = replies["jax"], replies["port"]
    assert tr["prediction"] == jr["prediction"]
    assert tr["rawPrediction"] == jr["rawPrediction"]       # bitwise
    np.testing.assert_allclose(np.asarray(tr["probability"]),
                               np.asarray(jr["probability"]),
                               rtol=0, atol=2.5e-7)
    # and the port's replies are its own transform, value for value
    direct = tm.transform(mtt.DataTable({"features": X}))
    assert [r["prediction"] for r in tr["prediction"]] == \
        direct["prediction"].astype(int).tolist()
    assert tr["rawPrediction"] == direct["rawPrediction"].tolist()


# ---------------------------------------------------------------------------
# columnar ingress, routing keys, drift, retries
# ---------------------------------------------------------------------------


def _frame_columns(rng):
    return {"features": rng.normal(size=(6, 4)).astype(np.float32),
            "ids": np.arange(6, dtype=np.int64),
            "name": ["a", None, "ccc", "", "é", "f"],
            "toks": [["x", "y"], [], ["z"], ["a", "b", "c"], ["q"], []]}


@pytest.mark.parametrize("json_header", [False, True])
@pytest.mark.parametrize("enc,dec", [(jcol, tcol), (tcol, jcol)])
def test_mcol_frames_cross_packages(monkeypatch, enc, dec, json_header):
    if json_header:
        # the card machine has no msgpack: no side may need it
        monkeypatch.setattr(jcol, "_msgpack", lambda: None)
        monkeypatch.setitem(sys.modules, "msgpack", None)
    cols = _frame_columns(np.random.default_rng(4))
    body, ct = enc.encode_columns(cols)
    # the port always writes a JSON header; the JAX package writes
    # msgpack when it has it, and the port reads it with its own codec
    assert body[4] == (0 if json_header or enc is tcol else 1)
    assert dec.negotiate({"content-type": ct}) == "msgpack"
    batch = dec.decode_columnar("msgpack", body)
    assert batch.n_rows == 6
    np.testing.assert_array_equal(batch.columns["features"],
                                  cols["features"])
    np.testing.assert_array_equal(batch.columns["ids"], cols["ids"])
    assert batch.columns["name"] == cols["name"]
    assert batch.columns["toks"] == cols["toks"]


def test_shm_codec_raises_and_columnar_request_is_served():
    # the shm codec is ported: a body that is no control message fails
    # to decode, and the engine answers 400 for it alone
    with pytest.raises(tcol.CodecError, match="malformed shm control"):
        tcol.decode_columnar("shm", b"x")
    Xtr, ytr, Xte, _ = _higgs_shape()
    model = mtt.TPUBoostClassifier(numIterations=3, numLeaves=7,
                                   device="cpu").fit(
        mtt.DataTable({"features": Xtr, "label": ytr}))
    want = model.transform(mtt.DataTable({"features": Xte[:5]}))[
        "prediction"].astype(int).tolist()
    engine = serve_model(json_scoring_pipeline(model), port=0,
                         batch_size=8)
    try:
        body, ct = jcol.encode_columns({"features": Xte[:5]})
        assert _post(engine.source.address, body,
                     headers={"Content-Type": ct}) == \
            (200, {"prediction": want})
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(engine.source.address, b"MCOL-not-a-frame",
                  headers={"Content-Type": ct})
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(engine.source.address, b"x",
                  headers={"Content-Type": "application/x-shm-columns"})
        assert ei.value.code == 400
    finally:
        engine.stop()


def test_drift_monitor_matches_reference():
    rng = np.random.default_rng(6)
    ref_x = rng.normal(size=(200, 5))
    ours, theirs = (DriftMonitor.from_matrix(ref_x),
                    JDriftMonitor.from_matrix(ref_x))
    for _ in range(3):
        batch = rng.normal(loc=0.3, size=(17, 5))
        batch[0, 2] = np.nan
        ours.observe(batch)
        theirs.observe(batch)
    assert ours.summary() == theirs.summary()


@pytest.mark.parametrize("kw", [
    {"max_attempts": 6, "base_delay": 0.1, "multiplier": 3.0,
     "max_delay": 2.0},
    {"schedule": [0.1, 0.5, 1.0]},
    {"max_attempts": 4, "jitter": "none"},
])
def test_retry_policy_schedule_matches_reference(kw):
    ours = RetryPolicy(rng=random.Random(11), **kw)
    theirs = JRetryPolicy(rng=random.Random(11), **kw)
    assert ours.max_attempts == theirs.max_attempts
    assert [ours.backoff(i) for i in range(8)] == \
        [theirs.backoff(i) for i in range(8)]


def _retry_trace(mod, failures, budget_s):
    """Run ``mod.RetryPolicy.call`` on a fake clock: ``fn`` fails
    ``failures`` times, then succeeds. Returns (outcome, sleeps)."""
    clock = [0.0]
    sleeps = []
    calls = [0]

    def fn():
        calls[0] += 1
        clock[0] += 0.05
        if calls[0] <= failures:
            raise ConnectionError(f"down {calls[0]}")
        return calls[0]

    def sleep(s):
        sleeps.append(s)
        clock[0] += s

    policy = mod.RetryPolicy(max_attempts=5, base_delay=0.2,
                             multiplier=2.0, rng=random.Random(3))
    deadline = mod.Deadline.after(budget_s, clock=lambda: clock[0])
    try:
        outcome = ("ok", policy.call(fn, deadline=deadline, sleep=sleep))
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        outcome = (type(e).__name__, str(e))
    return outcome, sleeps


@pytest.mark.parametrize("failures,budget_s", [
    (2, 10.0),     # recovers inside the budget
    (9, 10.0),     # runs out of attempts
    (9, 0.5),      # the deadline cuts the backoff short
])
def test_retry_policy_call_under_a_deadline_matches_reference(
        failures, budget_s):
    assert _retry_trace(tres, failures, budget_s) == \
        _retry_trace(jres, failures, budget_s)


def test_windowed_counter_matches_reference():
    ours = WindowedCounter(bucket_s=1.0, horizon_s=10.0)
    theirs = JWindowedCounter(bucket_s=1.0, horizon_s=10.0)
    for now, n in ((100.2, 3), (100.7, 1), (102.1, 5), (106.9, 2),
                   (113.5, 4)):
        ours.inc(n, now=now)
        theirs.inc(n, now=now)
        for window in (1.0, 3.0, 10.0):
            assert ours.total(window, now=now) == \
                theirs.total(window, now=now)
            assert ours.rate(window, now=now) == \
                theirs.rate(window, now=now)
        assert ours.series(5.0, now=now) == theirs.series(5.0, now=now)
    assert ours.cumulative == theirs.cumulative == 15


# ---------------------------------------------------------------------------
# the import rule and the CLI
# ---------------------------------------------------------------------------


# the CLI as ``python -m mmlspark_tpu_torch.cli``, in a process where jax
# and the JAX package cannot be imported (and are checked absent at exit)
_CLI = """
import atexit, runpy, sys
sys.modules["jax"] = None
sys.modules["mmlspark_tpu"] = None

def _no_jax():
    bad = [k for k, v in sys.modules.items() if v is not None
           and k.split(".")[0] in ("jax", "jaxlib", "flax", "mmlspark_tpu")]
    if bad:
        print("imported", bad, file=sys.stderr)
        sys.stderr.flush()
        import os
        os._exit(3)

atexit.register(_no_jax)
sys.argv = ["mmlspark_tpu_torch.cli"] + sys.argv[1:]
runpy.run_module("mmlspark_tpu_torch.cli", run_name="__main__")
"""


def test_cli_score_and_serve_on_a_saved_model(saved_jax_gbdt, tmp_path):
    path, X = saved_jax_gbdt
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    data = str(tmp_path / "rows.npz")
    np.savez(data, features=X)
    out = str(tmp_path / "scored")
    r = subprocess.run(
        [sys.executable, "-c", _CLI, "score",
         "--model", path, "--data", data, "--out", out, "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=str(REPO),
        timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    model = mtt.load_stage(path)
    model.set("device", "cpu")
    want = model.transform(mtt.DataTable({"features": X}))
    got = mtt.DataTable.load(out)
    np.testing.assert_array_equal(got["rawPrediction"],
                                  want["rawPrediction"])

    proc = subprocess.Popen(
        [sys.executable, "-c", _CLI, "serve",
         "--model", path, "--port", "0", "--device", "cpu",
         "--reply-col", "prediction"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env, cwd=str(REPO))
    try:
        line = proc.stdout.readline()
        addr = line.split(" on ")[1].split()[0]
        assert addr.startswith("http://127.0.0.1:")
        for i in range(3):
            assert _post(addr, {"features": X[i].tolist()}) == \
                (200, want["prediction"][i])
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
    assert proc.returncode == 0
