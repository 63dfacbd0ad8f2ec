"""PyTorch port: request tracing (``core/trace.py``) against the JAX
package, on the CPU.

The single-process half of tests/test_trace_propagation.py
(``TestTraceparent``, ``TestChromeMerge``) and the span-model,
tail-sampled buffer and Chrome-export scenarios of
tests/test_observability.py run through both packages (the ``pkg``
fixture), and these are held exactly equal across the two on the same
inputs:
- ``parse_traceparent`` / ``extract_context`` over one header list,
  the malformed headers included (trace id, parent id, sampled flag, or
  None);
- ``format_traceparent`` and ``Tracer.inject``'s headers for the same
  span;
- ``to_chrome_trace`` / ``merge_chrome_traces`` of the same spans
  (same ids, timestamps and attributes), with both modules' trace epoch
  set to the same instant: the whole payload, events and names;
- the buffer's statistics after the same trace sequence.
The fleet-leg and cross-process cases (``TestClientLegSpans``,
``test_cross_process_retry_hedge_one_trace``) wait for the client fleet
(ROADMAP.md, 'The rest of the serving plane').
"""

import json
import os
import time

import pytest

from mmlspark_tpu.core import trace as JT

from mmlspark_tpu_torch.core import trace as PT

PKGS = {"jax": JT, "torch": PT}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


HEADERS = [
    "00-abcd1234-ef567890-01",
    "00-abcd1234-ef567890-00",
    "00-my-trace-1-abc123-01",            # a legacy id with dashes
    "00-" + "a" * 64 + "-b1-01",
    "  00-abc-def-03  ",                  # padded, extra flag bits
    "ff-abc-def-01",
    None, "", "garbage", "00-onlythree-01",
    "zz-abc-def-01",                      # non-hex version
    "00-abc-nothex!-01",                  # non-hex span id
    "00-abc-def-zz",                      # non-hex flags
    "00-" + "x" * 70 + "-def-01",         # oversized trace id
    "00-0000-def-01",                     # all-zero trace id
    "000-abc-def-01", "00-abc-def-001", "00--def-01",
    "00-abc-" + "d" * 65 + "-01",
]


def _ctx(c):
    return None if c is None else (c.trace_id, c.parent_id, c.sampled)


# ---------------------------------------------------------------------------
# header format (TestTraceparent)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("header", HEADERS)
def test_parse_traceparent_equal_across_packages(header):
    assert _ctx(PT.parse_traceparent(header)) == \
        _ctx(JT.parse_traceparent(header))


@pytest.mark.parametrize("headers", [
    {"Traceparent": "00-tid1-def1-01", "X-Trace-Id": "legacy-id"},
    {"traceparent": "garbage", "x-trace-id": "legacy-id"},
    {"x-trace-id": "legacy-id"},
    {"X-TRACE-ID": "x" * 80},
    {}, None, [("traceparent", "00-a1-b2-01")],
])
def test_extract_context_equal_across_packages(headers):
    class Items:
        """an ``email.message``-style object: .items() only"""

        def __init__(self, pairs):
            self.pairs = pairs

        def items(self):
            return list(self.pairs)

    h = Items(headers) if isinstance(headers, list) else headers
    assert _ctx(PT.extract_context(h)) == _ctx(JT.extract_context(h))
    assert PT.header_get(h, "TRACEPARENT") == \
        JT.header_get(h, "TRACEPARENT")


@pytest.mark.parametrize("sampled", [True, False])
def test_format_traceparent_equal_across_packages(sampled):
    for tid, sid in (("abcd1234", "ef567890"), ("my-trace-1", "abc123")):
        assert PT.format_traceparent(tid, sid, sampled) == \
            JT.format_traceparent(tid, sid, sampled)


class TestTraceparent:
    def test_format_parse_round_trip(self, pkg):
        hdr = pkg.format_traceparent("abcd1234", "ef567890")
        assert hdr == "00-abcd1234-ef567890-01"
        ctx = pkg.parse_traceparent(hdr)
        assert ctx.trace_id == "abcd1234"
        assert ctx.parent_id == "ef567890"
        assert ctx.sampled is True
        assert pkg.parse_traceparent(pkg.format_traceparent(
            "ab", "cd", sampled=False)).sampled is False

    def test_legacy_trace_id_with_dashes_survives(self, pkg):
        ctx = pkg.parse_traceparent(
            pkg.format_traceparent("my-trace-1", "abc123"))
        assert ctx.trace_id == "my-trace-1"
        assert ctx.parent_id == "abc123"

    def test_extract_precedence_and_legacy_alias(self, pkg):
        ctx = pkg.extract_context({"Traceparent": "00-tid1-def1-01",
                                   "X-Trace-Id": "legacy-id"})
        assert ctx.trace_id == "tid1" and ctx.parent_id == "def1"
        ctx = pkg.extract_context({"x-trace-id": "legacy-id"})
        assert ctx.trace_id == "legacy-id" and ctx.parent_id is None
        assert pkg.extract_context({}) is None
        assert pkg.extract_context(None) is None

    def test_tracer_inject_extract_round_trip(self, pkg):
        tracer = pkg.Tracer(enabled=True)
        tr = tracer.new_trace("fleet.post")
        leg = tracer.start_span("client.post", tr)
        headers = tracer.inject(leg)
        ctx = pkg.Tracer.extract(headers)
        assert ctx.trace_id == tr.trace_id
        assert ctx.parent_id == leg.span_id
        assert headers["X-Trace-Id"] == tr.trace_id
        assert tracer.inject(None) == {}

    def test_continue_trace_parents_root(self, pkg):
        tracer = pkg.Tracer(enabled=True)
        tr = tracer.continue_trace("request",
                                   pkg.TraceContext("tidX", "cafe01"))
        assert tr.trace_id == "tidX"
        assert tr.root.parent_id == "cafe01"
        assert tracer.continue_trace("request", None).root.parent_id \
            is None


def test_inject_headers_equal_across_packages():
    """The same span injects the same headers in both packages, and a
    disabled tracer advertises sampled=0 in both."""
    for enabled in (True, False):
        got = PT.Tracer(enabled=enabled).inject(
            PT.Span("leg", "tid-1", "0a0b"))
        want = JT.Tracer(enabled=enabled).inject(
            JT.Span("leg", "tid-1", "0a0b"))
        assert got == want


# ---------------------------------------------------------------------------
# span model (TestSpanModel)
# ---------------------------------------------------------------------------


class TestSpanModel:
    def test_ids_unique_and_trace_assembly(self, pkg):
        tracer = pkg.Tracer(enabled=True)
        tr = tracer.new_trace("request")
        s1 = tracer.start_span("queue_wait", tr)
        s2 = tracer.start_span("device", tr)
        assert len({tr.root.span_id, s1.span_id, s2.span_id}) == 3
        assert s1.trace_id == tr.trace_id
        assert s1.parent_id == tr.root.span_id
        assert [s.name for s in tr.spans()] == \
            ["request", "queue_wait", "device"]

    def test_incoming_trace_id_honored_and_clamped(self, pkg):
        tracer = pkg.Tracer(enabled=True)
        assert tracer.new_trace("r", trace_id="abc-123").trace_id \
            == "abc-123"
        assert len(tracer.new_trace("r", trace_id="x" * 500).trace_id) \
            == 64

    def test_finish_idempotent_and_duration(self, pkg):
        tracer = pkg.Tracer(enabled=True)
        tr = tracer.new_trace("op", start=100.0)
        tr.root.finish(100.25)
        tr.root.finish(999.0)
        assert tr.duration_ms == pytest.approx(250.0)
        tracer.finish(tr)
        tracer.finish(tr)
        assert tracer.buffer.stats()["added"] == 1

    def test_error_and_links(self, pkg):
        tracer = pkg.Tracer(enabled=True)
        span = tracer.start_span("device", tracer.new_trace("request"))
        span.link("t1", "s1").link("t2", "s2")
        span.error("boom").finish()
        assert span.status == "error"
        assert span.attrs["error"] == "boom"
        assert span.links == [("t1", "s1"), ("t2", "s2")]

    def test_current_span_context(self, pkg):
        tr = pkg.Tracer(enabled=True).new_trace("op")
        assert pkg.current_span() is None
        with pkg.use_span(tr.root):
            assert pkg.current_span() is tr.root
        assert pkg.current_span() is None

    def test_emit_retroactive_span(self, pkg):
        tracer = pkg.Tracer(enabled=True)
        tr = tracer.new_trace("gbdt.train")
        span = tracer.emit("bin", 10.0, 10.5, trace=tr, attrs={"rows": 7})
        assert span.duration_ms == pytest.approx(500.0)
        assert span.attrs["rows"] == 7
        tracer.emit("automl.featurize_fit", time.perf_counter() - 0.01)
        assert tracer.buffer.stats()["added"] == 1

    def test_disabled_tracer_emits_nothing(self, pkg):
        tracer = pkg.Tracer(enabled=False)
        assert tracer.emit("x", 0.0) is None
        with tracer.trace_block("y") as tr:
            assert tr is None
        assert tracer.buffer.stats()["added"] == 0

    def test_trace_block_marks_errors_and_holds_current_span(self, pkg):
        tracer = pkg.Tracer(enabled=True)
        with pytest.raises(ValueError):
            with tracer.trace_block("fit", attrs={"k": 1}) as tr:
                assert pkg.current_span() is tr.root
                raise ValueError("bad")
        kept = tracer.buffer.traces()
        assert kept[-1].is_error and kept[-1].root.attrs["k"] == 1
        assert "bad" in kept[-1].root.attrs["error"]

    def test_process_tracer_get_and_set(self, pkg):
        old = pkg.get_tracer()
        mine = pkg.Tracer(enabled=True)
        pkg.set_tracer(mine)
        try:
            assert pkg.get_tracer() is mine
        finally:
            pkg.set_tracer(old)
        assert pkg.get_tracer() is old


# ---------------------------------------------------------------------------
# tail-sampled buffer (TestTraceBuffer)
# ---------------------------------------------------------------------------


def _mk(tracer, dur_ms, error=False):
    tr = tracer.new_trace("t", start=0.0)
    if error:
        tr.root.error()
    tracer.finish(tr, end=dur_ms / 1e3)
    return tr


class TestTraceBuffer:
    def test_capacity_bound(self, pkg):
        tracer = pkg.Tracer(enabled=True,
                            buffer=pkg.TraceBuffer(capacity=32))
        for _ in range(300):
            _mk(tracer, 1.0)
        stats = tracer.buffer.stats()
        assert stats["added"] == 300
        assert stats["buffered"] <= 32 + 8

    def test_error_traces_survive_eviction(self, pkg):
        tracer = pkg.Tracer(enabled=True,
                            buffer=pkg.TraceBuffer(capacity=16))
        err = _mk(tracer, 1.0, error=True)
        for _ in range(200):
            _mk(tracer, 1.0)
        assert any(t is err for t in tracer.buffer.traces())
        assert tracer.buffer.stats()["errors_kept"] == 1

    def test_slow_tail_kept(self, pkg):
        tracer = pkg.Tracer(enabled=True, buffer=pkg.TraceBuffer(
            capacity=16, slow_percentile=90.0))
        for _ in range(64):
            _mk(tracer, 1.0)
        slow = _mk(tracer, 500.0)
        for _ in range(100):
            _mk(tracer, 1.0)
        assert any(t is slow for t in tracer.buffer.traces())
        assert tracer.buffer.stats()["slow_kept"] >= 1

    def test_limit_and_clear(self, pkg):
        tracer = pkg.Tracer(enabled=True,
                            buffer=pkg.TraceBuffer(capacity=64))
        for _ in range(10):
            _mk(tracer, 1.0)
        assert len(tracer.buffer.traces(limit=3)) == 3
        assert tracer.buffer.traces(limit=0) == []
        tracer.buffer.clear()
        assert tracer.buffer.traces() == []


def test_buffer_stats_equal_across_packages():
    """The same trace sequence (durations cycling 1-40 ms, every 17th an
    error, a 500 ms outlier every 50) leaves the same statistics and
    keeps the same traces, in order, in both packages' buffers."""
    kept = {}
    for name, mod in PKGS.items():
        tracer = mod.Tracer(enabled=True, buffer=mod.TraceBuffer(
            capacity=24, slow_percentile=90.0))
        order = []
        for i in range(400):
            dur = 500.0 if i % 50 == 49 else float(1 + i % 40)
            tr = _mk(tracer, dur, error=(i % 17 == 0))
            tr.root.set("i", i)
        for t in tracer.buffer.traces():
            order.append(t.root.attrs["i"])
        kept[name] = (tracer.buffer.stats(), order)
    assert kept["torch"] == kept["jax"]


# ---------------------------------------------------------------------------
# Chrome export and merge (TestChromeExport, TestChromeMerge)
# ---------------------------------------------------------------------------


class TestChromeExport:
    def test_export_structure_and_json_round_trip(self, pkg):
        tracer = pkg.Tracer(enabled=True)
        tr = tracer.new_trace("request")
        tracer.start_span("device", tr).set("rows", 4).finish()
        tracer.finish(tr)
        loaded = json.loads(json.dumps(pkg.to_chrome_trace(
            tracer.buffer.traces())))
        assert loaded["displayTimeUnit"] == "ms"
        assert len(loaded["traceEvents"]) == 2
        for ev in loaded["traceEvents"]:
            assert ev["ph"] == "X" and ev["name"]
            assert ev["ts"] >= 0 and ev["dur"] >= 0
            assert isinstance(ev["pid"], int)
            assert isinstance(ev["tid"], int)
            assert "trace_id" in ev["args"]

    def test_shared_batch_span_deduped(self, pkg):
        tracer = pkg.Tracer(enabled=True)
        tr1 = tracer.new_trace("request")
        tr2 = tracer.new_trace("request")
        shared = tracer.start_span("device", tr1)
        shared.link(tr1.trace_id, tr1.root.span_id)
        shared.link(tr2.trace_id, tr2.root.span_id)
        tr2.add(shared)
        shared.finish()
        tracer.finish(tr1)
        tracer.finish(tr2)
        events = pkg.to_chrome_trace(tracer.buffer.traces())["traceEvents"]
        device = [e for e in events if e["name"] == "device"]
        assert len(device) == 1
        assert len(device[0]["args"]["links"]) == 2


class TestChromeMerge:
    def test_process_name_metadata(self, pkg):
        tracer = pkg.Tracer(enabled=True)
        tracer.finish(tracer.new_trace("request"))
        payload = pkg.to_chrome_trace(tracer.buffer.traces(),
                                      process_name="engine X pid=1")
        metas = [e for e in payload["traceEvents"] if e["ph"] == "M"]
        assert metas and metas[0]["name"] == "process_name"
        assert metas[0]["args"]["name"] == "engine X pid=1"
        assert payload["otherData"]["pid"] == os.getpid()
        # an empty export stays empty (tracing off)
        assert pkg.to_chrome_trace([], process_name="x")["traceEvents"] \
            == []

    def test_merge_dedups_spans_and_keeps_processes(self, pkg):
        tracer = pkg.Tracer(enabled=True)
        tracer.finish(tracer.new_trace("request"))
        a = pkg.to_chrome_trace(tracer.buffer.traces(), process_name="A")
        b = pkg.to_chrome_trace(tracer.buffer.traces(), process_name="B")
        for ev in b["traceEvents"]:
            ev["pid"] = 99999
        b["otherData"]["pid"] = 99999
        merged = pkg.merge_chrome_traces(a, b)
        assert len([e for e in merged["traceEvents"]
                    if e["ph"] == "X"]) == 2
        merged2 = pkg.merge_chrome_traces(a, a)
        assert len([e for e in merged2["traceEvents"]
                    if e["ph"] == "X"]) == 1
        assert len([e for e in merged["traceEvents"]
                    if e["ph"] == "M"]) == 2
        assert str(os.getpid()) in merged["otherData"]["epochs"]


def _fixed_traces(mod):
    """Two request traces built from explicit ids and times: a root with
    a remote parent, an errored span, a shared device span linking both
    roots, an unfinished span."""
    r1 = mod.Span("request", "t1", "r1", parent_id="remote", start=10.0)
    r1.set("path", "/").set("http_status", 200)
    tr1 = mod.Trace("t1", r1)
    r2 = mod.Span("request", "t2", "r2", start=10.001)
    tr2 = mod.Trace("t2", r2)
    for tr, root, sid in ((tr1, r1, "q1"), (tr2, r2, "q2")):
        q = mod.Span("queue_wait", tr.trace_id, sid, parent_id=root.span_id,
                     start=root.start)
        q.finish(root.start + 0.002)
        tr.add(q)
    dev = mod.Span("device", "t1", "d1", parent_id="r1", start=10.003)
    dev.link("t1", "r1").link("t2", "r2")
    dev.set("model_version", "v3").set("rows", 2).finish(10.0041)
    tr1.add(dev)
    tr2.add(dev)
    bad = mod.Span("respond", "t2", "e2", parent_id="r2", start=10.005)
    bad.error(RuntimeError("boom")).finish(10.006)
    tr2.add(bad)
    tr2.add(mod.Span("respond", "t2", "u2", parent_id="r2", start=10.007))
    r1.finish(10.0061)
    r2.finish(10.0071)
    return [tr1, tr2]


def test_chrome_export_equal_across_packages(monkeypatch):
    """The same spans export to the same Chrome payload — every event,
    name, timestamp, duration and argument — once both modules' trace
    epochs sit at the same instant; and their merge is equal too."""
    for mod in PKGS.values():
        monkeypatch.setattr(mod, "_T0", 9.0)
        monkeypatch.setattr(mod, "_T0_WALL", 1700000000.0)
    for name in (None, "engine http://x pid=1"):
        got = PT.to_chrome_trace(_fixed_traces(PT), process_name=name)
        want = JT.to_chrome_trace(_fixed_traces(JT), process_name=name)
        assert got == want
    got = PT.merge_chrome_traces(
        PT.to_chrome_trace(_fixed_traces(PT), process_name="A"), {},
        PT.to_chrome_trace(_fixed_traces(PT)[1:], process_name="A"))
    want = JT.merge_chrome_traces(
        JT.to_chrome_trace(_fixed_traces(JT), process_name="A"), {},
        JT.to_chrome_trace(_fixed_traces(JT)[1:], process_name="A"))
    assert got == want
    assert [e["name"] for e in got["traceEvents"]] == [
        "process_name", "request", "queue_wait", "device", "request",
        "queue_wait", "respond", "respond"]
