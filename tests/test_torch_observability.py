"""PyTorch port: the Prometheus renderer (``core/prometheus.py``), the
serving engine's traces, metrics and bundle, trace-correlated logs, the
metrics primitives under threads, the profiling helpers, and the spans
of the GBDT, learner, AutoML and fused paths, against the JAX package,
on the CPU.

The scenarios of tests/test_observability.py run through both packages
where they need no engine, and on the port's engine (``port=0``, plain
``Lambda`` pipelines) where they do; the reference engine serves the
same requests beside it for the structural comparisons. Held exactly
equal across the packages on the same inputs:
- the renderer's text for the same calls and histogram states, and the
  escaping helpers;
- ``process_families``' samples for the same registry state, family by
  family (the port renders every reference family but the ingress ones,
  which wait for the host transports; the HELP texts of
  ``gbdt_comm_bytes_total`` and ``serving_model_warmup_ms`` say what the
  port measures);
- a request trace's span names and its device span's links and
  attributes; the training spans' names, structure and attributes (the
  port's ``gbdt.train`` has no ``first_iter`` / ``bin_device`` phase,
  and its fused segment span adds ``jit_cache_miss``);
- the JSON log formatter's output.
Timing values (span durations, latency buckets) are only checked for
shape and grammar. ``TestSwapMetricsConsistency`` waits for ``swap()``
and the zoo and fleet expositions for their planes (ROADMAP.md, 'The
rest of the serving plane').
"""

import json
import logging
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from mmlspark_tpu.core import logging_utils as JLU
from mmlspark_tpu.core import metrics as JM
from mmlspark_tpu.core import prometheus as JP
from mmlspark_tpu.core import trace as JT
from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.serving.server import serve_model as jserve_model
from mmlspark_tpu.stages.basic import Lambda as JLambda
from mmlspark_tpu.utils import async_utils as JAU

from mmlspark_tpu_torch.core import logging_utils as PLU
from mmlspark_tpu_torch.core import metrics as PM
from mmlspark_tpu_torch.core import prometheus as PP
from mmlspark_tpu_torch.core import trace as PT
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.serving import serve_model
from mmlspark_tpu_torch.stages.basic import Lambda
from mmlspark_tpu_torch.testing import metrics_check as CHK
from mmlspark_tpu_torch.utils import async_utils as PAU
from mmlspark_tpu_torch.utils import profiling

from test_observability import validate_prom_text

# families whose HELP text says what the port measures
PORT_HELP = {"gbdt_comm_bytes_total", "serving_model_warmup_ms"}


def _families(text):
    """family -> (help, type, [sample lines]) of one exposition."""
    out = {}
    cur = None
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name, help_ = line[7:].split(" ", 1)
            out[name] = [help_, None, []]
            cur = name
        elif line.startswith("# TYPE "):
            out[line.split(" ")[2]][1] = line.split(" ")[3]
        elif line:
            out[cur][2].append(line)
    return out


# ---------------------------------------------------------------------------
# the renderer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value", [
    0, 1, -3, 2.5, 1e15, 1e16, 1e-7, float("inf"), float("-inf"),
    float("nan"), True, False, 3.0, np.float32(0.1), np.int64(7)])
def test_format_value_equal_across_packages(value):
    assert PP.format_value(value) == JP.format_value(value)


@pytest.mark.parametrize("raw", [
    "ok_name", "9lives", "a-b.c", "", "x y", "ns:metric", 'q"\\\n'])
def test_escaping_helpers_equal_across_packages(raw):
    assert PP.sanitize_name(raw) == JP.sanitize_name(raw)
    assert PP.escape_label_value(raw) == JP.escape_label_value(raw)
    assert PP.escape_help(raw) == JP.escape_help(raw)


def _render(P, M):
    r = P.PromRenderer()
    hist = M.LatencyHistogram()
    for v in (0.04, 0.6, 3.0, 3.0, 1e9, 17.25, 0.1):
        hist.observe(v)
    r.counter("req_total", "requests\nseen", 12, {"engine": "0"})
    r.counter("req_total", "ignored second help", 3, {"engine": "1"})
    r.gauge("depth", "queue depth", 2.5)
    r.sample("depth", 7, {"shard": 'a"b'})
    r.info("weird_info", "escaping check",
           {"v": 'a"b\\c\nd', "ok": "plain", "bad-key": 1})
    r.histogram("lat_ms", "check", hist, {"phase": "x"})
    r.histogram("lat_ms", "check", {"bounds": [1.0, float("inf")],
                                    "counts": [2, 1], "count": 3,
                                    "sum": 4.5}, {"phase": "y"})
    r.gauge("bad name!", "sanitized", 1)
    return r.render()


def test_renderer_text_equal_across_packages():
    text = _render(PP, PM)
    assert text == _render(JP, JM)
    validate_prom_text(text)
    assert CHK.audit_text(text.replace("weird_info", "weird")) == []


class TestRenderer:
    @pytest.mark.parametrize("P", [PP, JP], ids=["torch", "jax"])
    def test_label_escaping(self, P):
        r = P.PromRenderer()
        r.info("weird_info", "escaping check",
               {"v": 'a"b\\c\nd', "ok": "plain"})
        _, samples = validate_prom_text(r.render())
        assert samples[0][1]["v"] == 'a"b\\c\nd'

    @pytest.mark.parametrize("P,M", [(PP, PM), (JP, JM)],
                             ids=["torch", "jax"])
    def test_histogram_rendering_exact(self, P, M):
        hist = M.LatencyHistogram()
        for v in (0.04, 0.6, 3.0, 3.0, 1e9):
            hist.observe(v)
        r = P.PromRenderer()
        r.histogram("lat_ms", "check", hist)
        _, samples = validate_prom_text(r.render())
        buckets = [(l["le"], v) for n, l, v in samples
                   if n == "lat_ms_bucket"]
        assert buckets[0] == ("0.05", 1) and buckets[-1] == ("+Inf", 5)
        assert next(v for n, _l, v in samples if n == "lat_ms_count") == 5
        assert next(v for n, _l, v in samples if n == "lat_ms_sum") == \
            pytest.approx(0.04 + 0.6 + 6.0 + 1e9)


def test_process_families_equal_across_packages(monkeypatch):
    """The same registry state — every process-wide phase family (the
    serving ingress phases and their per-codec decode included) fed the
    same observations, a tracer of the same history — renders the same
    samples in both packages, family by family."""
    texts = {}
    for name, (P, M, T) in {"torch": (PP, PM, PT),
                            "jax": (JP, JM, JT)}.items():
        monkeypatch.setattr(M, "_INGRESS_DECODE", {})
        for codec in ("json", "msgpack", "shm"):
            M.ingress_decode_histogram(codec)
        fams = [M.gbdt_train_histograms(), M.gbdt_hist_histograms(),
                M.automl_histograms(), M.pipeline_histograms(),
                M.ooc_histograms(), M.warmup_histograms(),
                M.ingress_histograms(), M.ingress_decode_histograms()]
        for fam in fams:
            for h in fam.values():
                h.reset()
        M.gbdt_comm_reset()
        for k, fam in enumerate(fams):
            for j, h in enumerate(sorted(fam)):
                for v in (0.07 * (k + 1), 3.0 + j, 250.0 * k):
                    fam[h].observe(v)
        M.gbdt_comm_add("psum", 4096.0)
        tracer = T.Tracer(enabled=True, buffer=T.TraceBuffer(capacity=8))
        for i in range(40):
            tr = tracer.new_trace("t", start=0.0)
            if i % 9 == 0:
                tr.root.error()
            tracer.finish(tr, end=(1 + i % 5) / 1e3)
        r = P.PromRenderer()
        P.process_families(r, tracer=tracer)
        texts[name] = _families(r.render())
    got, want = texts["torch"], texts["jax"]
    assert set(got) == set(want) - {
        n for n in want if n.startswith("device_memory_")}
    for fam, (help_, kind, lines) in got.items():
        assert (kind, lines) == tuple(want[fam][1:]), fam
        if fam not in PORT_HELP:
            assert help_ == want[fam][0], fam
    text = "\n".join(f"# HELP {f} {h}\n# TYPE {f} {k}\n" + "\n".join(s)
                     for f, (h, k, s) in got.items()) + "\n"
    validate_prom_text(text)
    assert CHK.audit_text(text) == []


# ---------------------------------------------------------------------------
# end-to-end serving traces on the port's engine
# ---------------------------------------------------------------------------


def _scoring_pipeline(L, sleep_s=0.002, logger=None):
    """A split-pipeline echo scorer: decode parses JSON on the batcher
    thread, execute 'scores' on the worker (shaped like
    json_scoring_pipeline), so the queue_wait / decode / device /
    respond chain is exercised."""
    def decode(table):
        return [json.loads(r["entity"].decode())["x"]
                for r in table["request"]]

    def execute(table, xs):
        time.sleep(sleep_s)
        if logger is not None:
            logger.info("scored %d rows", len(xs))
        return table.with_column("reply", [{"y": v * 2} for v in xs])

    lam = L.apply(lambda t: execute(t, decode(t)))
    lam.prepare_batch = decode
    lam.execute_prepared = execute
    lam.jit_cache_miss_count = lambda: 0
    lam.bucket_for = lambda rows: 8
    return lam


def _post(addr, payload, headers=None, timeout=10):
    req = urllib.request.Request(
        addr, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read()), dict(r.headers)


def _spray(engine, n=16):
    threads = [threading.Thread(target=_post, args=(
        engine.source.address, {"x": i})) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def _wait_traces(tracer, n, timeout=10.0):
    """The handler buffers a trace just after replying: wait for it."""
    deadline = time.monotonic() + timeout
    while tracer.buffer.stats()["added"] < n and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    return tracer.buffer.stats()["added"]


def _union_coverage(trace):
    root = trace.root
    ivs = sorted((max(s.start, root.start), min(s.end, root.end))
                 for s in trace.spans()
                 if s is not root and s.end is not None)
    covered, cur_a, cur_b = 0.0, None, None
    for a, b in ivs:
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                covered += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        covered += cur_b - cur_a
    dur = root.end - root.start
    return covered / dur if dur > 0 else 0.0


@pytest.fixture()
def traced_engine():
    tracer = PT.Tracer(enabled=True)
    engine = serve_model(_scoring_pipeline(Lambda), port=0, batch_size=8,
                         max_wait_ms=20.0, tracer=tracer, version="v3",
                         flight_recorder=False)
    yield engine, tracer
    engine.stop()


class TestServingTracing:
    def test_trace_id_propagation(self, traced_engine):
        engine, tracer = traced_engine
        status, body, headers = _post(engine.source.address, {"x": 21},
                                      headers={"X-Trace-Id": "prop-1"})
        assert status == 200 and body == {"y": 42}
        assert headers.get("X-Trace-Id") == "prop-1"
        _, _, h2 = _post(engine.source.address, {"x": 1}, headers={
            "traceparent": "00-cafe01-beef02-01"})
        assert h2["X-Trace-Id"] == "cafe01"
        _, _, h3 = _post(engine.source.address, {"x": 1})
        assert h3.get("X-Trace-Id")
        _wait_traces(tracer, 3)
        by_id = {t.trace_id: t for t in tracer.buffer.traces()}
        assert by_id["prop-1"].root.parent_id is None
        assert by_id["cafe01"].root.parent_id == "beef02"
        assert by_id["cafe01"].root.attrs["remote_parent"] is True
        assert by_id["cafe01"].root.attrs["http_status"] == 200

    def test_span_chain_covers_request_wall(self, traced_engine):
        engine, tracer = traced_engine
        _spray(engine, 16)
        _wait_traces(tracer, 16)
        traces = [t for t in tracer.buffer.traces()
                  if t.root.name == "request" and not t.is_error]
        assert len(traces) >= 16
        for tr in traces:
            names = {s.name for s in tr.spans()}
            assert {"queue_wait", "decode", "device", "respond"} <= names
            cov = _union_coverage(tr)
            assert cov >= 0.90, (cov, [(s.name, round(s.duration_ms, 3))
                                       for s in tr.spans()])

    def test_batch_join_span_shared_with_version(self, traced_engine):
        engine, tracer = traced_engine
        _spray(engine, 16)
        _wait_traces(tracer, 16)
        by_device = {}
        for tr in tracer.buffer.traces():
            for s in tr.spans():
                if s.name == "device":
                    by_device.setdefault(s.span_id, []).append(tr)
                    assert s.attrs["model_version"] == "v3"
                    assert s.attrs["bucket"] == 8
                    assert s.attrs["jit_cache_miss"] is False
        multi = {sid: trs for sid, trs in by_device.items()
                 if len(trs) > 1}
        assert multi, "no multi-request micro-batch formed"
        for sid, trs in multi.items():
            span = next(s for s in trs[0].spans() if s.span_id == sid)
            assert span.attrs["rows"] == len(trs) == len(span.links)
            assert {s for _, s in span.links} == \
                {t.root.span_id for t in trs}

    def test_error_trace_kept_and_marked(self, traced_engine):
        engine, tracer = traced_engine
        engine.pipeline = Lambda.apply(lambda t: (_ for _ in ()).throw(
            RuntimeError("kaboom")))
        with pytest.raises(urllib.error.HTTPError):
            _post(engine.source.address, {"x": 1})
        _wait_traces(tracer, 1)
        errs = [t for t in tracer.buffer.traces() if t.is_error]
        assert errs and errs[-1].root.attrs["http_status"] >= 500
        names = [s.name for s in errs[-1].spans()]
        # the failed batch span and the lone-row retry, both on the trace
        assert names.count("device") == 2
        retry = [s for s in errs[-1].spans() if s.attrs.get("retry")]
        assert retry and retry[0].status == "error"

    def test_debug_traces_endpoint(self, traced_engine):
        engine, tracer = traced_engine
        _spray(engine, 8)
        _wait_traces(tracer, 8)
        payload = json.loads(urllib.request.urlopen(
            engine.source.address + "/debug/traces", timeout=5).read())
        assert payload["displayTimeUnit"] == "ms"
        assert payload["traceEvents"][0]["args"]["name"].startswith(
            "engine http://")
        limited = json.loads(urllib.request.urlopen(
            engine.source.address + "/debug/traces?limit=2",
            timeout=5).read())
        roots = [e for e in limited["traceEvents"]
                 if e["name"] == "request"]
        assert 0 < len(roots) <= 2

    def test_tracing_disabled_is_silent(self):
        engine = serve_model(_scoring_pipeline(Lambda), port=0,
                             batch_size=8, tracing=False)
        try:
            status, body, headers = _post(engine.source.address, {"x": 2})
            assert status == 200 and body == {"y": 4}
            assert "X-Trace-Id" not in headers
            assert engine.traces() == []
            payload = json.loads(urllib.request.urlopen(
                engine.source.address + "/debug/traces", timeout=5).read())
            assert payload["traceEvents"] == []
        finally:
            engine.stop()

    def test_config_switch_turns_tracing_off(self, monkeypatch):
        """``trace.enabled`` false turns the engine's tracing off unless
        ``tracing=True`` overrides it."""
        from mmlspark_tpu_torch.core import config
        process_tracer = PT.get_tracer()     # made while the key is true
        assert process_tracer.enabled
        monkeypatch.setitem(config._overrides, "trace.enabled", False)
        engine = serve_model(_scoring_pipeline(Lambda), port=0)
        try:
            assert engine.tracer is None
        finally:
            engine.stop()
        engine = serve_model(_scoring_pipeline(Lambda), port=0,
                             tracing=True)
        try:
            assert engine.tracer is process_tracer
        finally:
            engine.stop()

    def test_log_line_inside_request_carries_trace_id(self):
        """A log line the pipeline emits while serving carries the
        trace id of the device span it ran under (the JSON formatter)."""
        logger = PLU.get_logger("serving.test")
        records = []

        class Keep(logging.Handler):
            def emit(self, record):
                records.append(PLU.JsonFormatter().format(record))

        h = Keep()
        logger.addHandler(h)
        tracer = PT.Tracer(enabled=True)
        engine = serve_model(_scoring_pipeline(Lambda, logger=logger),
                             port=0, tracer=tracer, flight_recorder=False)
        try:
            _post(engine.source.address, {"x": 5},
                  headers={"traceparent": "00-logtrace-0abc-01"})
            _wait_traces(tracer, 1)
        finally:
            engine.stop()
            logger.removeHandler(h)
        line = json.loads(records[-1])
        assert line["msg"] == "scored 1 rows"
        assert line["trace_id"] == "logtrace"
        assert line["model_version"] == "v0"
        device = next(s for t in tracer.buffer.traces() for s in t.spans()
                      if s.name == "device")
        assert line["span_id"] == device.span_id


def test_request_trace_structure_equal_across_packages():
    """One request through each package's engine: the same span names
    under the root, the device span's attribute keys and links, the
    same reply header and root attributes."""
    seen = {}
    for name, (serve, L, T) in {
            "torch": (serve_model, Lambda, PT),
            "jax": (jserve_model, JLambda, JT)}.items():
        tracer = T.Tracer(enabled=True)
        engine = serve(_scoring_pipeline(L), port=0, batch_size=8,
                       tracer=tracer, version="v7", flight_recorder=False)
        try:
            _, body, headers = _post(engine.source.address, {"x": 3},
                                     headers={"traceparent":
                                              "00-same1-0f0f-01"})
            _wait_traces(tracer, 1)
        finally:
            engine.stop()
        tr = tracer.buffer.traces()[-1]
        dev = next(s for s in tr.spans() if s.name == "device")
        seen[name] = (body, headers["X-Trace-Id"], tr.trace_id,
                      tr.root.parent_id, sorted(tr.root.attrs),
                      [s.name for s in tr.spans()], sorted(dev.attrs),
                      len(dev.links), dev.attrs["rows"],
                      {s.name: s.parent_id == tr.root.span_id
                       for s in tr.spans()[1:]})
    assert seen["torch"] == seen["jax"]


# ---------------------------------------------------------------------------
# the Prometheus exposition of the port's engine
# ---------------------------------------------------------------------------


class TestMetricsExposition:
    def test_engine_metrics_endpoint_grammar(self, traced_engine):
        engine, _tracer = traced_engine
        for _ in range(4):
            _post(engine.source.address, {"x": 5})
        PM.gbdt_train_histograms()["bin"].observe(3.0)
        PM.automl_histograms()["tune_trials"].observe(8.0)
        raw = urllib.request.urlopen(engine.source.address + "/metrics",
                                     timeout=5)
        assert raw.headers.get("Content-Type", "").startswith(
            "text/plain; version=0.0.4")
        text = raw.read().decode()
        types, samples = validate_prom_text(text)
        assert CHK.audit_text(text) == []
        names = {n for n, _l, _v in samples}
        for required in (
                "serving_requests_answered_total",
                "serving_batches_processed_total", "serving_model_info",
                "serving_queue_wait_ms_bucket", "serving_pipeline_ms_bucket",
                "serving_jit_cache_misses_total", "serving_slo_burn_rate",
                "gbdt_train_phase_ms_bucket", "automl_phase_ms_bucket",
                "pipeline_fusion_phase_ms_bucket", "trace_buffer_traces",
                "gbdt_comm_bytes_total"):
            assert required in names, required
        assert types["serving_queue_wait_ms"] == "histogram"
        info = next(l for n, l, _v in samples if n == "serving_model_info")
        assert info["version"] == "v3" and info["swap_state"] == "idle"
        added = next(v for n, _l, v in samples
                     if n == "trace_traces_added_total")
        assert added > 0
        # no CUDA context in this process: no device_memory_* gauges
        assert not any(n.startswith("device_memory_") for n in names)

    def test_families_equal_to_the_reference_engines(self):
        """The port's engine renders every family the reference engine
        does (the card's memory families need a CUDA context)."""
        fams = {}
        for name, (serve, L, T) in {
                "torch": (serve_model, Lambda, PT),
                "jax": (jserve_model, JLambda, JT)}.items():
            engine = serve(_scoring_pipeline(L), port=0,
                           tracer=T.Tracer(enabled=True),
                           flight_recorder=False)
            try:
                _post(engine.source.address, {"x": 1})
                text = urllib.request.urlopen(
                    engine.source.address + "/metrics",
                    timeout=5).read().decode()
            finally:
                engine.stop()
            fams[name] = _families(text)
        missing = set(fams["jax"]) - set(fams["torch"])
        assert missing <= {
            n for n in fams["jax"] if n.startswith("device_memory_")}
        assert set(fams["torch"]) <= set(fams["jax"])
        for fam, (help_, kind, _) in fams["torch"].items():
            assert kind == fams["jax"][fam][1], fam
            if fam not in PORT_HELP | {"serving_jit_cache_misses_total"}:
                assert help_ == fams["jax"][fam][0], fam


# ---------------------------------------------------------------------------
# structured logging
# ---------------------------------------------------------------------------


def _record(name, level, msg, args=(), exc=None):
    return logging.LogRecord(name, level, __file__, 1, msg, args, exc)


def _strip_time(line):
    out = json.loads(line)
    out.pop("ts")
    out.pop("time")
    return out


class TestStructuredLogging:
    def test_json_formatter_plain_record_equal(self):
        rec = _record("mmlspark_tpu.serving", logging.WARNING,
                      "shed %d rows", (7,))
        got = PLU.JsonFormatter().format(rec)
        assert _strip_time(got) == _strip_time(JLU.JsonFormatter().format(
            rec))
        out = json.loads(got)
        assert out["msg"] == "shed 7 rows" and "\n" not in got
        assert "trace_id" not in out

    def test_json_formatter_carries_trace_and_version_equal(self):
        outs = {}
        for name, (LU, T) in {"torch": (PLU, PT), "jax": (JLU, JT)}.items():
            tracer = T.Tracer(enabled=True)
            tr = tracer.new_trace("request", trace_id="log-corr-1")
            span = T.Span("device", tr.trace_id, "sp-1",
                          parent_id=tr.root.span_id)
            span.set("model_version", "v12")
            rec = _record("x.serving", logging.INFO, "batch ok")
            with T.use_span(span):
                outs[name] = _strip_time(LU.JsonFormatter().format(rec))
        assert outs["torch"] == outs["jax"]
        assert outs["torch"]["trace_id"] == "log-corr-1"
        assert outs["torch"]["span_id"] == "sp-1"
        assert outs["torch"]["model_version"] == "v12"

    def test_json_formatter_exception_one_line(self):
        try:
            raise ValueError("inner")
        except ValueError:
            rec = _record("mmlspark_tpu_torch", logging.ERROR, "failed",
                          exc=sys.exc_info())
        line = PLU.JsonFormatter().format(rec)
        assert "\n" not in line and "inner" in json.loads(line)["exc"]

    def test_log_format_config_switch(self):
        from mmlspark_tpu_torch.core import config
        root = logging.getLogger("mmlspark_tpu_torch")
        foreign = logging.StreamHandler()
        fmt = logging.Formatter("APP %(message)s")
        foreign.setFormatter(fmt)
        root.addHandler(foreign)
        config.set_config("log_format", "json")
        try:
            PLU.configure(force=True)
            owned = [h for h in root.handlers
                     if getattr(h, "_mmlspark_tpu_torch_owned", False)]
            assert owned and all(isinstance(h.formatter, PLU.JsonFormatter)
                                 for h in owned)
            assert foreign.formatter is fmt
        finally:
            root.removeHandler(foreign)
            config.set_config("log_format", "text")
            PLU.configure(force=True)


# ---------------------------------------------------------------------------
# metrics primitives under threads
# ---------------------------------------------------------------------------


class TestMetricsThreadSafety:
    @pytest.mark.parametrize("M", [PM, JM], ids=["torch", "jax"])
    def test_labelled_histograms_hard_cap(self, M):
        fam = M.LabelledHistograms(cap=4)

        def work(t):
            for i in range(300):
                fam.observe(f"m{(i + t) % 40}", float(i % 17))

        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        snap = fam.snapshot()
        assert len(snap) == 5 and "_other" in snap
        assert sum(h.snapshot()["count"] for h in snap.values()) == 2400

    def test_labelled_histograms_equal_across_packages(self):
        out = {}
        for name, M in {"torch": PM, "jax": JM}.items():
            fam = M.LabelledHistograms(cap=3)
            for i in range(200):
                fam.observe(f"m{(i * 7) % 11}", float((i * 13) % 97))
            out[name] = {k: h.snapshot() for k, h in fam.snapshot().items()}
        assert out["torch"] == out["jax"]

    def test_histogram_concurrent_observe_no_lost_updates(self):
        hist = PM.LatencyHistogram()

        def work(seed):
            for i in range(4000):
                hist.observe(float((i + seed) % 97))

        threads = [threading.Thread(target=work, args=(s,))
                   for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        snap = hist.snapshot()
        assert snap["count"] == sum(snap["counts"]) == 32000
        assert snap["sum"] == sum(float((i + s) % 97) for s in range(8)
                                  for i in range(4000))


# ---------------------------------------------------------------------------
# profiling helpers and async helpers
# ---------------------------------------------------------------------------


def test_profiling_on_the_cpu(tmp_path):
    """A CPU caller gets None, as the JAX package's does; the sampler
    collects nothing; trace_files lists what maybe_trace wrote."""
    assert profiling.device_memory_stats() is None
    assert profiling.device_memory_stats("cpu") is None
    assert profiling.mesh_memory_stats() is None
    sampler = profiling.MemorySampler(interval_s=0.01).start()
    time.sleep(0.05)
    assert sampler.stop() == []
    with profiling.maybe_trace(str(tmp_path)):
        sum(range(1000))
    files = profiling.trace_files(str(tmp_path))
    assert len(files) == 1 and files[0].endswith(".json")


def test_async_helpers_equal_across_packages():
    items = list(range(25))
    for conc in (1, 3, 8):
        assert list(PAU.buffered_map(lambda x: x * x, items, conc)) == \
            list(JAU.buffered_map(lambda x: x * x, items, conc))
    for AU in (PAU, JAU):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("again")
            return "ok"

        retried = []
        assert AU.retry_with_backoff(
            flaky, retries=3, initial_delay=0.0, exceptions=OSError,
            on_retry=lambda e, i: retried.append(i)) == "ok"
        assert retried == [0, 1]
        with pytest.raises(KeyError):
            AU.retry_with_backoff(lambda: {}["k"], retries=3,
                                  initial_delay=0.0, exceptions=OSError)


# ---------------------------------------------------------------------------
# training-side traces against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture()
def own_tracers():
    """Both packages' process tracers swapped for fresh ones (the
    process-wide buffers are shared by every test of a worker)."""
    old = (PT.get_tracer(), JT.get_tracer())
    mine = (PT.Tracer(enabled=True), JT.Tracer(enabled=True))
    PT.set_tracer(mine[0])
    JT.set_tracer(mine[1])
    yield mine
    PT.set_tracer(old[0])
    JT.set_tracer(old[1])


def _only(tracer, root):
    found = [t for t in tracer.buffer.traces() if t.root.name == root]
    assert len(found) == 1, [t.root.name for t in tracer.buffer.traces()]
    return found[0]


def test_gbdt_train_trace_against_jax(own_tracers):
    from mmlspark_tpu.core.metrics import GBDT_TRAIN_PHASES
    from mmlspark_tpu.gbdt.booster import train as jtrain
    from mmlspark_tpu_torch.gbdt.booster import train
    ptr, jtr = own_tracers
    rng = np.random.default_rng(0)
    X = rng.normal(size=(400, 5)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float64)
    params = {"objective": "binary", "num_iterations": 3, "num_leaves": 7,
              "max_bin": 15}
    before = {k: h.snapshot()["count"]
              for k, h in PM.gbdt_train_histograms().items()}
    booster = train(params, X, y, device="cpu")
    jtrain(params, X, y)
    got, want = _only(ptr, "gbdt.train"), _only(jtr, "gbdt.train")
    assert sorted(got.root.attrs) == sorted(want.root.attrs) == \
        ["bin_path", "boost_chunks", "trees"]
    assert got.root.attrs["trees"] == want.root.attrs["trees"] == 3
    assert got.root.attrs["bin_path"] == booster.train_info["bin_path"]
    names = [s.name for s in got.spans()[1:]]
    assert set(names) <= set(GBDT_TRAIN_PHASES)
    assert {"bin", "fetch"} <= set(names) & {s.name for s in want.spans()}
    assert [n for n in names if n != "boost_chunk"] == \
        ["bin", "ship", "boost", "fetch"]
    chunks = [s for s in got.spans() if s.name == "boost_chunk"]
    assert len(chunks) == got.root.attrs["boost_chunks"] == 3
    assert [c.attrs for c in chunks] == [
        {"it0": i, "length": 1} for i in range(3)]
    boost = next(s for s in got.spans() if s.name == "boost")
    assert all(boost.start <= c.start and c.end <= boost.end
               for c in chunks)
    after = {k: h.snapshot()["count"]
             for k, h in PM.gbdt_train_histograms().items()}
    assert {k: after[k] - before[k] for k in after} == {
        "bin": 1, "ship": 1, "bin_device": 0, "first_iter": 0,
        "boost": 1, "boost_chunk": 3, "fetch": 1}


def test_automl_featurize_spans_against_jax(own_tracers):
    from mmlspark_tpu.automl.featurize import Featurize as JFeaturize
    from mmlspark_tpu_torch.automl.featurize import Featurize
    from mmlspark_tpu_torch.io.ooc import ChunkedTable
    ptr, jtr = own_tracers
    rng = np.random.default_rng(0)
    cols = {"a": rng.normal(size=200),
            "color": [f"c{i % 3}" for i in range(200)]}
    spans = {}
    for name, (F, T, tracer) in {
            "torch": (Featurize, DataTable, ptr),
            "jax": (JFeaturize, JTable, jtr)}.items():
        table = T(cols)
        F(featureColumns=["a", "color"]).fit(table).transform(table)
        spans[name] = [(t.root.name, t.root.attrs)
                       for t in tracer.buffer.traces()]
    assert spans["torch"] == spans["jax"] == [
        ("automl.featurize_fit", {"columns": 2, "specs": 2}),
        ("automl.featurize_transform", {"rows": 200, "specs": 2})]
    Featurize(featureColumns=["a", "color"]).fit(
        ChunkedTable.from_table(DataTable(cols), chunk_rows=64))
    assert ptr.buffer.traces()[-1].root.attrs == \
        {"columns": 2, "specs": 2, "chunks": 4}


def test_tune_trace_against_jax(own_tracers):
    from mmlspark_tpu import automl as JA
    from mmlspark_tpu.models import linear as JL
    import mmlspark_tpu_torch.automl as PA
    from mmlspark_tpu_torch.models import linear as PL
    ptr, jtr = own_tracers
    rng = np.random.default_rng(3)
    X = rng.normal(size=(300, 6)).astype(np.float32)
    cols = {"features": X, "label": (X[:, 0] > 0).astype(np.float64)}
    out = {}
    for name, (A, L, T, tracer, kw) in {
            "torch": (PA, PL, DataTable, ptr, {"device": "cpu"}),
            "jax": (JA, JL, JTable, jtr, {})}.items():
        space = (A.HyperparamBuilder().add_hyperparam(
            "regParam", A.DiscreteHyperParam([1e-4, 1e-2])).build())
        A.TuneHyperparameters(
            models=[L.TPULogisticRegression(maxIter=10, **kw)],
            paramSpace=A.GridSpace(space), evaluationMetric="accuracy",
            numFolds=2, seed=0).fit(T(cols))
        tr = _only(tracer, "automl.tune")
        out[name] = (tr.root.attrs, [(s.name, s.attrs, s.parent_id ==
                                      tr.root.span_id)
                                     for s in tr.spans()[1:]])
    assert out["torch"] == out["jax"]
    assert [n for n, _, _ in out["torch"][1]] == [
        "tune_fold_build", "tune_trials", "tune_refit"]


def test_learner_fit_trace_against_jax(own_tracers):
    from mmlspark_tpu.models.learner import TPULearner as JLearner
    from mmlspark_tpu_torch.models.learner import TPULearner
    ptr, jtr = own_tracers
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = rng.integers(0, 2, 64).astype(np.int64)
    spec = {"type": "mlp", "features": [8], "num_classes": 2}
    kw = dict(networkSpec=spec, epochs=1, batchSize=32, logEvery=1000,
              computeDtype="float32", memoryStatsEvery=1,
              traceAnnotations=True)
    learner = TPULearner(device="cpu", **kw)
    learner.fit(DataTable({"features": x, "label": y}))
    JLearner(**kw).fit(JTable({"features": x, "label": y}))
    out = {}
    for name, tracer in (("torch", ptr), ("jax", jtr)):
        tr = _only(tracer, "learner.fit")
        out[name] = (sorted(tr.root.attrs), tr.root.attrs["steps"],
                     tr.root.attrs["feed"],
                     [s.name for s in tr.spans()[1:]],
                     [sorted(s.attrs) for s in tr.spans()[1:]])
    assert out["torch"] == out["jax"]
    assert out["torch"][3] == ["learner.step", "learner.step"]
    # no memory samples on the CPU, in either package
    assert learner.memory_samples == []


def test_learner_step_spans_capped(own_tracers):
    from mmlspark_tpu_torch.models.learner import TPULearner
    ptr, _ = own_tracers
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2100, 4)).astype(np.float32)
    y = rng.integers(0, 2, 2100).astype(np.int64)
    TPULearner(networkSpec={"type": "mlp", "features": [4],
                            "num_classes": 2}, epochs=1, batchSize=1,
               logEvery=10000, computeDtype="float32", device="cpu",
               dataFeed="device").fit(DataTable({"features": x, "label": y}))
    tr = _only(ptr, "learner.fit")
    assert len(tr.spans()) == 1 + 2048
    assert tr.root.attrs["steps"] == 2100
    assert tr.root.attrs["feed"] == "device"


def test_fused_segment_span_against_jax(own_tracers, tmp_path):
    from mmlspark_tpu.automl.featurize import Featurize as JFeaturize
    from mmlspark_tpu.core.stage import PipelineModel as JPipelineModel
    from mmlspark_tpu_torch.core.stage import PipelineModel, load_stage
    ptr, jtr = own_tracers
    rng = np.random.default_rng(2)
    cols = {"num1": rng.normal(size=120),
            "cat": [f"l{int(i)}" for i in rng.integers(0, 5, 120)]}
    jfm = JFeaturize(featureColumns=["num1", "cat"],
                     numberOfFeatures=16).fit(JTable(cols))
    jfm.save(str(tmp_path / "fm"))
    fused = PipelineModel(stages=[load_stage(str(tmp_path / "fm"))]).fused(
        device="cpu")
    jfused = JPipelineModel(stages=[jfm]).fused()
    for _ in range(2):
        fused.transform(DataTable(cols))
        jfused.transform(JTable(cols))
    got = [t.root for t in ptr.buffer.traces()
           if t.root.name == "pipeline.fused_segment"]
    want = [t.root for t in jtr.buffer.traces()
            if t.root.name == "pipeline.fused_segment"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        extra = dict(g.attrs)
        miss = extra.pop("jit_cache_miss")
        assert extra == w.attrs
    assert [g.attrs["jit_cache_miss"] for g in got] == [True, False]
    assert got[0].attrs["rows"] == 120
