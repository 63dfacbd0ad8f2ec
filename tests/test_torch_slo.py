"""PyTorch port: the SLO monitor (``core/slo.py``), the windowed
primitives, the flight recorder (``core/flightrecorder.py``), the
circuit breaker and the port's metrics audit, against the JAX package,
on the CPU.

The scenarios of tests/test_slo.py run through both packages (the
``pkg`` fixture) on the same inputs and the same injected clock, and
these are held exactly equal across the two:
- the monitor's ``status()``, ``series()``, fired alerts and alert log
  for one sample sequence (alert times come from the wall clock and are
  left out);
- the rendered ``serving_slo_*`` families (``test_torch_observability``
  holds the rest of the exposition);
- ``CircuitBreaker``'s state after every step of one outcome sequence;
and the windowed histogram's percentiles within the reference test's
own bounds. The engine scenarios (recorder hooks, debug endpoints, the
error-spike acceptance) run on the port's engine with ``device``-free
``Lambda`` pipelines; their SLO windows move on an injected clock, not
on sleeps. The reference's ``tools/check_metrics.py`` cases run against
the port's own audit, ``mmlspark_tpu_torch.testing.metrics_check``.
"""

import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from mmlspark_tpu.core import flightrecorder as JFR
from mmlspark_tpu.core import metrics as JM
from mmlspark_tpu.core import prometheus as JP
from mmlspark_tpu.core import slo as JS
from mmlspark_tpu.core import trace as JT
from mmlspark_tpu.utils import resilience as JR

from mmlspark_tpu_torch.core import flightrecorder as PFR
from mmlspark_tpu_torch.core import metrics as PM
from mmlspark_tpu_torch.core import prometheus as PP
from mmlspark_tpu_torch.core import slo as PS
from mmlspark_tpu_torch.core import trace as PT
from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.serving import serve_model
from mmlspark_tpu_torch.stages.basic import Lambda
from mmlspark_tpu_torch.testing import metrics_check as CHK
from mmlspark_tpu_torch.utils import resilience as PR

from test_observability import validate_prom_text

PKGS = {
    "jax": types.SimpleNamespace(M=JM, S=JS, FR=JFR, T=JT, R=JR, P=JP),
    "torch": types.SimpleNamespace(M=PM, S=PS, FR=PFR, T=PT, R=PR, P=PP),
}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


class _FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ---------------------------------------------------------------------------
# windowed primitives
# ---------------------------------------------------------------------------


class TestWindowedCounter:
    def test_windowed_totals(self, pkg):
        clock = _FakeClock(100.0)
        c = pkg.M.WindowedCounter(bucket_s=1.0, horizon_s=10.0,
                                  clock=clock)
        c.inc(2)
        clock.advance(3)
        c.inc(5)
        assert c.total(1) == 5
        assert c.total(10) == 7
        assert c.cumulative == 7
        clock.advance(8)
        assert c.total(10) == 5
        assert c.rate(10) == pytest.approx(0.5)
        assert c.cumulative == 7

    def test_bucket_expires_exactly_once_on_wrap(self, pkg):
        clock = _FakeClock(0.0)
        c = pkg.M.WindowedCounter(bucket_s=1.0, horizon_s=4.0, clock=clock)
        c.inc(3)
        clock.advance(c.n_slots * 1.0)
        c.inc(1)
        assert c.total(1) == 1
        assert c.cumulative == 4

    def test_series_oldest_first_with_gaps(self, pkg):
        clock = _FakeClock(50.0)
        c = pkg.M.WindowedCounter(bucket_s=1.0, horizon_s=10.0,
                                  clock=clock)
        c.inc(1)
        clock.advance(2)
        c.inc(4)
        series = c.series(4)
        assert [v for _, v in series] == [0.0, 1.0, 0.0, 4.0]
        assert series[0][0] < series[-1][0]

    def test_hammer_no_lost_updates_under_rotation(self, pkg):
        c = pkg.M.WindowedCounter(bucket_s=0.002, horizon_s=60.0)

        def work():
            for _ in range(2000):
                c.inc()

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert c.cumulative == 16000
        assert c.total(60.0) == 16000


class TestWindowedHistogram:
    def test_windowed_snapshot_and_percentile(self, pkg):
        clock = _FakeClock(100.0)
        h = pkg.M.WindowedHistogram(bucket_s=1.0, horizon_s=20.0,
                                    clock=clock)
        h.observe(10.0)
        clock.advance(5)
        for _ in range(99):
            h.observe(1.0)
        h.observe(400.0)
        snap = h.snapshot(3)
        assert snap["count"] == 100
        assert snap["max"] == 400.0
        assert h.percentile(50, 3) <= 2.0
        assert h.percentile(99.9, 3) >= 100.0
        assert h.snapshot(20)["count"] == 101
        assert sum(snap["counts"]) == snap["count"]
        assert len(snap["bounds"]) == len(snap["counts"])

    def test_bucket_expires_exactly_once_on_wrap(self, pkg):
        clock = _FakeClock(0.0)
        h = pkg.M.WindowedHistogram(bucket_s=1.0, horizon_s=3.0,
                                    clock=clock)
        h.observe(5.0)
        clock.advance(h.n_slots * 1.0)
        h.observe(7.0)
        snap = h.snapshot(1)
        assert snap["count"] == 1 and snap["sum"] == 7.0

    def test_hammer_no_lost_updates(self, pkg):
        """8 writers through a real clock with 2 ms buckets (rotations
        mid-run) beside a reader checking each merged snapshot. The
        reader reads a 0.2 s window and yields between reads: a reader
        merging the whole 60 s ring back to back holds the lock so long
        that the writers starve, and once the run outlasts the horizon
        its first observations age out of the final count."""
        h = pkg.M.WindowedHistogram(bucket_s=0.002, horizon_s=60.0)
        stop = threading.Event()
        bad = []

        def reader():
            while not stop.is_set():
                snap = h.snapshot(0.2)
                if sum(snap["counts"]) != snap["count"]:
                    bad.append(snap)
                time.sleep(0.001)

        rt = threading.Thread(target=reader)
        rt.start()

        def work(seed):
            for i in range(1500):
                h.observe(float((i + seed) % 13))

        threads = [threading.Thread(target=work, args=(s,))
                   for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stop.set()
        rt.join()
        assert not bad
        snap = h.snapshot(60.0)
        assert snap["count"] == 12000
        assert snap["sum"] == sum(float((i + s) % 13) for s in range(8)
                                  for i in range(1500))


def test_windowed_histogram_equal_across_packages():
    """One observation sequence over a moving injected clock: the same
    merged snapshot in every window, and percentiles equal (the
    reference test's bounds hold for both)."""
    snaps = {}
    for name, p in PKGS.items():
        clock = _FakeClock(200.0)
        h = p.M.WindowedHistogram(bucket_s=1.0, horizon_s=30.0,
                                  clock=clock)
        out = []
        for i in range(600):
            h.observe(float((i * 37) % 900) / 7.0)
            if i % 40 == 39:
                clock.advance(1.5)
            if i % 100 == 99:
                out.append([h.snapshot(w) for w in (2, 10, 30)])
                out.append([h.percentile(q, w) for q in (50, 90, 99, 99.9)
                            for w in (2, 10, 30)])
        snaps[name] = out
    assert snaps["torch"] == snaps["jax"]


# ---------------------------------------------------------------------------
# burn-rate math (golden values)
# ---------------------------------------------------------------------------


def _monitor(p, clock, min_events=4, label_cap=16):
    return p.S.SLOMonitor(
        slos=[p.S.SLO("availability", target=0.999)],
        rules=[p.S.BurnRateRule("fast_burn", 60.0, 10.0, 14.4,
                                min_events=min_events),
               p.S.BurnRateRule("slow_burn", 60.0, 30.0, 6.0,
                                min_events=min_events)],
        windows=(10.0, 60.0), label_cap=label_cap,
        bucket_s=1.0, hist_bucket_s=1.0, horizon_s=120.0, clock=clock)


class TestBurnRateGolden:
    def test_fast_burn_fires_at_14_4x(self, pkg):
        clock = _FakeClock()
        mon = _monitor(pkg, clock)
        for i in range(1000):
            mon.record(i % 50 != 0, 10.0)
            if i % 125 == 124:
                clock.advance(1)
        fired = mon.evaluate()
        alert = next(a for a in fired
                     if a.name == "availability:fast_burn")
        assert alert.burn_short == pytest.approx(20.0, rel=0.05)
        assert alert.burn_long == pytest.approx(20.0, rel=0.05)
        assert mon.degraded

    def test_quiet_on_slow_noise(self, pkg):
        clock = _FakeClock()
        mon = _monitor(pkg, clock)
        for i in range(2000):
            mon.record(i % 200 != 0, 10.0)
            if i % 250 == 249:
                clock.advance(1)
        assert mon.evaluate() == []
        assert not mon.degraded
        assert mon.burn_rate(mon.slos[0], 10.0) == pytest.approx(
            5.0, rel=0.1)

    def test_min_events_guard(self, pkg):
        mon = _monitor(pkg, _FakeClock(), min_events=4)
        mon.record(False, 10.0)
        mon.record(True, 10.0)
        assert mon.evaluate() == []
        assert mon.burn_rate(mon.slos[0], 10.0) > 100

    def test_resolves_when_window_drains(self, pkg):
        clock = _FakeClock()
        mon = _monitor(pkg, clock)
        events = []
        mon.record_event = events.append
        for i in range(200):
            mon.record(i % 10 != 0, 10.0)
        assert mon.evaluate()
        assert mon.degraded
        clock.advance(11)
        for _ in range(50):
            mon.record(True, 10.0)
        mon.evaluate()
        assert not any(a.name == "availability:fast_burn"
                       for a in mon.alerts.active())
        kinds = [e.kind for e in events if isinstance(e, pkg.S.AlertEvent)]
        assert "alert_fired" in kinds and "alert_resolved" in kinds
        stats = mon.alerts.stats()
        assert stats["fired_total"] >= 1 and stats["resolved_total"] >= 1

    def test_no_refire_while_active(self, pkg):
        mon = _monitor(pkg, _FakeClock())
        for i in range(200):
            mon.record(i % 5 != 0, 10.0)
        assert mon.evaluate()
        fired_total = mon.alerts.stats()["fired_total"]
        for i in range(100):
            mon.record(i % 5 != 0, 10.0)
        assert mon.evaluate() == []
        assert mon.alerts.stats()["fired_total"] == fired_total

    def test_latency_slo_slow_requests_spend_budget(self, pkg):
        mon = pkg.S.SLOMonitor(
            slos=[pkg.S.SLO("latency_p99", "latency", target=0.99,
                            latency_threshold_ms=100.0)],
            rules=[pkg.S.BurnRateRule("fast_burn", 60.0, 10.0, 14.4,
                                      min_events=4)],
            windows=(10.0, 60.0), bucket_s=1.0, hist_bucket_s=1.0,
            horizon_s=120.0, clock=_FakeClock())
        for i in range(500):
            mon.record(True, 500.0 if i % 5 == 0 else 10.0)
        fired = mon.evaluate()
        assert [a.name for a in fired] == ["latency_p99:fast_burn"]
        assert fired[0].burn_short == pytest.approx(20.0, rel=0.05)

    def test_per_model_streams_capped_and_alert_named(self, pkg):
        mon = _monitor(pkg, _FakeClock(), label_cap=2)
        for m in ("m0", "m1", "m2", "m3"):
            for i in range(100):
                mon.record(not (m == "m1" and i % 5 == 0), 10.0,
                           model=m, include_engine=False)
        labels = mon.model_labels()
        assert len(labels) <= 3 and "_other" in labels
        assert any(a.name == "availability:fast_burn:m1"
                   for a in mon.evaluate())
        assert mon.error_rate(60.0) == 0.0

    def test_default_rules_are_the_workbook_pair(self, pkg):
        rules = {r.name: r for r in pkg.S.default_rules()}
        assert rules["fast_burn"].factor == 14.4
        assert rules["fast_burn"].short_window_s == 300.0
        assert rules["slow_burn"].factor == 6.0

    def test_horizon_clamp_copies_rules_not_mutates(self, pkg):
        rule = pkg.S.BurnRateRule("slow_burn", 21600.0, 1800.0, 6.0)
        mon = pkg.S.SLOMonitor(rules=[rule], horizon_s=3600.0)
        assert mon.rules[0].long_window_s == 3600.0
        assert rule.long_window_s == 21600.0
        mon2 = pkg.S.SLOMonitor(rules=[rule], horizon_s=None)
        assert mon2.horizon_s == 21600.0
        assert mon2.rules[0].long_window_s == 21600.0

    def test_bad_declarations_raise(self, pkg):
        with pytest.raises(ValueError):
            pkg.S.SLO("x", kind="throughput")
        with pytest.raises(ValueError):
            pkg.S.SLO("x", target=1.0)
        with pytest.raises(ValueError):
            pkg.S.SLO("x", kind="latency")
        with pytest.raises(ValueError):
            pkg.S.BurnRateRule("r", long_window_s=10.0,
                               short_window_s=20.0)


def _drive(p, log):
    """One sample sequence with per-model streams, a latency SLO, a burn,
    its recovery and a second burn, on one injected clock; returns
    everything observable (alert wall times left out)."""
    clock = _FakeClock(5000.0)
    mon = p.S.SLOMonitor(
        slos=[p.S.SLO("availability", target=0.99),
              p.S.SLO("latency_p99", "latency", target=0.95,
                      latency_threshold_ms=50.0)],
        rules=[p.S.BurnRateRule("fast_burn", 60.0, 10.0, 14.4,
                                min_events=3),
               p.S.BurnRateRule("slow_burn", 120.0, 30.0, 6.0,
                                min_events=3)],
        windows=(10.0, 60.0, 120.0), label_cap=2, bucket_s=1.0,
        hist_bucket_s=2.0, horizon_s=180.0, clock=clock)
    mon.on_fire = lambda a: log.append(("fire", a.name))
    mon.on_resolve = lambda a: log.append(("resolve", a.name))
    out = []

    def view():
        st = mon.status()
        for a in st["active_alerts"]:
            a.pop("fired_at")
            a.pop("resolved_at")
        hist = [(a.name, a.active, round(a.burn_short, 9),
                 round(a.burn_long, 9), a.details)
                for a in mon.alerts.history()]
        return st, mon.series(), hist, sorted(mon.model_labels())

    for phase, (n, bad_every, slow_every, dt) in enumerate(
            ((300, 0, 0, 0.25), (120, 2, 4, 0.1), (400, 0, 0, 0.2),
             (100, 2, 2, 0.05))):
        for i in range(n):
            ok = not (bad_every and i % bad_every == 0)
            lat = 120.0 if slow_every and i % slow_every == 0 else 8.0 + i % 5
            mon.record(ok, lat)
            mon.record(ok, lat, model=f"m{i % 4}", include_engine=False)
            clock.advance(dt)
            if i % 25 == 24:
                out.append([a.name for a in mon.evaluate()])
        out.append(view())
    return out


def test_slo_monitor_equal_across_packages():
    """The same samples on the same clock: statuses, series, the alerts
    each evaluation fired, the alert history and the hooks' calls are
    equal in both packages."""
    logs = {"jax": [], "torch": []}
    got = _drive(PKGS["torch"], logs["torch"])
    want = _drive(PKGS["jax"], logs["jax"])
    assert got == want
    assert logs["torch"] == logs["jax"]
    assert ("fire", "availability:fast_burn") in logs["torch"]
    assert any(kind == "resolve" for kind, _ in logs["torch"])


def test_slo_families_equal_across_packages():
    """The serving_slo_* families of the same monitor state render to
    the same text in both packages (no timing value enters them)."""
    texts = {}
    for name, p in PKGS.items():
        clock = _FakeClock(700.0)
        mon = _monitor(p, clock, label_cap=2)
        for i in range(400):
            mon.record(i % 7 != 0, float(i % 90), model=f"m{i % 3}")
            if i % 50 == 49:
                clock.advance(1.0)
        mon.evaluate()
        r = p.P.PromRenderer()
        p.P.slo_families(r, mon, {"engine": "0"})
        texts[name] = r.render()
    assert texts["torch"] == texts["jax"]
    types_, samples = validate_prom_text(texts["torch"])
    assert types_["serving_slo_burn_rate"] == "gauge"
    assert any(n == "serving_slo_alert_active" for n, _, _ in samples)
    assert CHK.audit_text(texts["torch"]) == []


# ---------------------------------------------------------------------------
# the circuit breaker
# ---------------------------------------------------------------------------


def _breaker_walk(p):
    clock = _FakeClock()
    b = p.R.CircuitBreaker(failure_threshold=3, failure_rate=0.5,
                           window=6, min_calls=4, cooldown=5.0,
                           half_open_max=1, clock=clock, name="e0")
    opened = []
    b.on_open = lambda br: opened.append(br.name)
    seq = []
    for step in ("s", "f", "s", "f", "f", "a", "t5", "a", "a", "f", "t6",
                 "a", "s", "f", "f", "f", "a", "t2", "r", "s", "f", "s",
                 "f", "f", "f"):
        if step == "s":
            b.record_success()
        elif step == "f":
            b.record_failure()
        elif step == "a":
            seq.append(("allow", b.allow()))
        elif step == "r":
            b.reset()
        else:
            clock.advance(float(step[1:]))
        snap = b.snapshot()
        seq.append((step, b.state, snap["consecutive_failures"],
                    round(snap["window_failure_rate"], 9),
                    snap["times_opened"], round(b.retry_after(), 9)))
    return seq, opened


def test_breaker_state_sequence_equal_across_packages():
    got, opened = _breaker_walk(PKGS["torch"])
    want, opened_j = _breaker_walk(PKGS["jax"])
    assert got == want and opened == opened_j
    states = {s[1] for s in got if len(s) > 2}
    assert states == {"closed", "open", "half_open"}


class TestCircuitBreaker:
    def test_on_open_fires_only_on_closed_to_open(self, pkg):
        opened = []
        clock = _FakeClock()
        b = pkg.R.CircuitBreaker(failure_threshold=1, cooldown=5.0,
                                 clock=clock)
        b.on_open = opened.append
        b.record_failure()
        assert len(opened) == 1
        clock.advance(6)
        assert b.allow()
        b.record_failure()
        assert b.state == pkg.R.CircuitBreaker.OPEN
        assert len(opened) == 1

    def test_call_gates_and_records(self, pkg):
        clock = _FakeClock()
        b = pkg.R.CircuitBreaker(failure_threshold=2, cooldown=1.0,
                                 clock=clock, name="x")

        def boom():
            raise OSError("down")

        for _ in range(2):
            with pytest.raises(OSError):
                b.call(boom)
        with pytest.raises(pkg.R.CircuitOpenError) as ei:
            b.call(lambda: 1)
        assert ei.value.name == "x" and ei.value.retry_after == 1.0
        clock.advance(1.0)
        assert b.call(lambda: 7) == 7
        assert b.state == "closed"

    def test_retry_policy_with_breaker(self, pkg):
        clock = _FakeClock()
        b = pkg.R.CircuitBreaker(failure_threshold=2, cooldown=10.0,
                                 clock=clock)
        calls = []

        def flaky():
            calls.append(1)
            raise ConnectionError("x")

        policy = pkg.R.RetryPolicy(max_attempts=5, base_delay=0.0,
                                   jitter="none")
        with pytest.raises(pkg.R.CircuitOpenError):
            policy.call(flaky, breaker=b, sleep=lambda s: None)
        assert len(calls) == 2      # the third attempt met an open circuit
        # a no_retry error is the backend answering: not a failure
        b2 = pkg.R.CircuitBreaker(failure_threshold=1, clock=clock)
        p2 = pkg.R.RetryPolicy(max_attempts=3, no_retry=(KeyError,))
        with pytest.raises(KeyError):
            p2.call(lambda: {}["k"], breaker=b2)
        assert b2.state == "closed"


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------


class TestFlightRecorder:
    def test_bundle_is_self_contained_and_json_safe(self, pkg):
        mon = _monitor(pkg, _FakeClock())
        mon.record(False, 50.0)
        tracer = pkg.T.Tracer(enabled=True)
        tr = tracer.new_trace("request")
        tr.root.error("boom")
        tracer.finish(tr)
        rec = pkg.FR.FlightRecorder(min_interval_s=0.0)
        try:
            rec.attach_tracer(tracer, label="engine test")
            rec.attach_slo("engine", mon)
            demo = type("DemoEvent", (), {
                "kind": "demo", "at": 1.0,
                "__repr__": lambda s: "DemoEvent(demo)"})()
            rec.add_event_source("events", lambda: [demo])
            rec.add_stats_source("engine", lambda: {"qps": 10})
            rec.add_stats_source("sick", lambda: 1 / 0)
            bundle = rec.dump_bundle("unit")
            text = json.dumps(bundle)
            assert "boom" in text
            assert bundle["slo"]["engine"]["status"]["degraded"] is False
            assert bundle["slo"]["engine"]["series"]["errors"]
            assert bundle["stats"]["engine"] == {"qps": 10}
            assert "error" in bundle["stats"]["sick"]
            assert bundle["events"]["events"][0]["kind"] == "demo"
            assert any(e.get("ph") == "M"
                       for e in bundle["traces"]["traceEvents"])
        finally:
            rec.close()

    def test_trigger_rate_limited_and_async(self, pkg):
        clock = _FakeClock()
        rec = pkg.FR.FlightRecorder(min_interval_s=30.0, clock=clock)
        try:
            t1 = rec.trigger("one")
            assert t1 is not None
            assert rec.trigger("two") is None
            clock.advance(31)
            t3 = rec.trigger("three")
            t1.join(timeout=10)
            t3.join(timeout=10)
            stats = rec.stats()
            assert (stats["triggers_seen"], stats["triggers_captured"],
                    stats["triggers_rate_limited"]) == (3, 2, 1)
            assert [b["reason"] for b in rec.bundles] == ["one", "three"]
        finally:
            rec.close()

    def test_log_ring_bounded_and_captured(self, pkg):
        rec = pkg.FR.FlightRecorder(min_interval_s=0.0, log_capacity=32)
        try:
            logger = (get_logger if pkg is PKGS["torch"] else
                      __import__("mmlspark_tpu.core.logging_utils",
                                 fromlist=["get_logger"]).get_logger)(
                "slo-test")
            tracer = pkg.T.Tracer(enabled=True)
            tr = tracer.new_trace("request", trace_id="ring-1")
            for i in range(100):
                if i == 99:
                    with pkg.T.use_span(tr.root):
                        logger.warning("chaos event %d", i)
                else:
                    logger.warning("chaos event %d", i)
            logs = rec.dump_bundle("logs")["logs"]
            msgs = [r["msg"] for r in logs]
            assert len(msgs) <= 32
            assert "chaos event 99" in msgs and "chaos event 0" not in msgs
            assert logs[-1]["trace_id"] == "ring-1"
        finally:
            rec.close()

    def test_detach_by_prefix(self, pkg):
        rec = pkg.FR.FlightRecorder(min_interval_s=0.0)
        try:
            rec.add_stats_source("engine@a", lambda: 1)
            rec.add_stats_source("engine@a:swap_events", lambda: 2)
            rec.add_stats_source("engine@b", lambda: 3)
            rec.add_stats_source("engine@http://h:1890", lambda: 4)
            rec.add_stats_source("engine@http://h:18900", lambda: 5)
            rec.detach("engine@a")
            rec.detach("engine@http://h:1890")
            assert sorted(rec.dump_bundle("x")["stats"]) == [
                "engine@b", "engine@http://h:18900"]
        finally:
            rec.close()

    def test_process_recorder_get_and_set(self, pkg):
        old = pkg.FR.get_recorder()
        mine = pkg.FR.FlightRecorder(capture_logs=False)
        pkg.FR.set_recorder(mine)
        try:
            assert pkg.FR.get_recorder() is mine
        finally:
            pkg.FR._global_recorder = old


def _echo(table):
    return table.with_column("reply", [b"ok" for _ in table["id"]])


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _post(addr, x, timeout=10):
    req = urllib.request.Request(
        addr, data=json.dumps({"x": x}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _wait(pred, timeout=10.0):
    """Wait for a capture THREAD (not a time window) to land."""
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


class TestEngineRecorderHooks:
    def test_shared_monitor_rewires_to_second_engines_recorder(self):
        clock = _FakeClock()
        mon = PS.SLOMonitor(
            slos=[PS.SLO("availability", target=0.999)],
            rules=[PS.BurnRateRule("fast_burn", 8.0, 2.0, 14.4,
                                   min_events=1)],
            windows=(2.0, 8.0), horizon_s=30.0, clock=clock)
        rec_a = PFR.FlightRecorder(min_interval_s=0.0)
        rec_b = PFR.FlightRecorder(min_interval_s=0.0)
        try:
            a = serve_model(Lambda.apply(_echo), port=0, batch_size=4,
                            tracing=False, slo=mon, flight_recorder=rec_a)
            assert mon.on_fire is not None
            a.stop()
            assert mon.on_fire is None
            b = serve_model(Lambda.apply(_echo), port=0, batch_size=4,
                            tracing=False, slo=mon, flight_recorder=rec_b)
            try:
                for _ in range(5):
                    mon.record(False, 10.0)
                mon.evaluate()
                assert _wait(lambda: len(rec_b.bundles) >= 1)
                assert rec_a.stats()["triggers_captured"] == 0
            finally:
                b.stop()
        finally:
            rec_a.close()
            rec_b.close()

    def test_engine_stop_releases_every_recorder_hook(self):
        rec = PFR.FlightRecorder(min_interval_s=0.0)
        try:
            engine = serve_model(Lambda.apply(_echo), port=0, batch_size=4,
                                 tracer=PT.Tracer(enabled=True),
                                 flight_recorder=rec)
            stats = rec.stats()
            assert stats["tracers"] == 1 and stats["slos"]
            engine.stop()
            stats = rec.stats()
            assert stats["tracers"] == 0 and stats["slos"] == []
            assert rec.dump_bundle("post-stop")["stats"] == {}
        finally:
            rec.close()

    def test_own_hook_kept_and_disabled_options(self):
        """A monitor whose on_fire the caller set keeps it (the engine
        installs and removes only its own hook); False turns each part
        off."""
        mine = PS.SLOMonitor()
        mine.on_fire = print
        engine = serve_model(Lambda.apply(_echo), port=0, slo=mine)
        engine.stop()
        assert mine.on_fire is print
        engine = serve_model(Lambda.apply(_echo), port=0, tracing=False,
                             slo=False, flight_recorder=False)
        try:
            assert (engine.tracer, engine.slo, engine.flight_recorder) == \
                (None, None, None)
            assert _post(engine.source.address, 1) == 200
            _, health = _get(engine.source.address + "/healthz")
            assert "slo" not in health and health["status"] == "ok"
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(engine.source.address + "/debug/bundle?confirm=1")
            assert ei.value.code == 404
        finally:
            engine.stop()


# ---------------------------------------------------------------------------
# the port's metrics audit (tools/check_metrics.py's cases)
# ---------------------------------------------------------------------------


class TestMetricsCheck:
    def test_shipped_expositions_clean(self):
        assert CHK.main() == 0

    @pytest.mark.parametrize("src,needle", [
        ('r.counter("requests_count", "help", 1)', "_total"),
        ('r.gauge("depth", "", 1)', "HELP"),
        ('r.histogram("latency", "help", h)', "unit suffix"),
        ('r.gauge("per_model_qps", "help", 1, {"model": m})',
         "CAPPED_FAMILIES"),
        ('r.counter(f"x_{n}_total", "help", 1)', "DYNAMIC_OK"),
        ('r.sample("never_declared", 1)', "does not continue"),
        ('r.gauge(name, "help", 1)', "not a (f-)string literal"),
    ])
    def test_catches(self, src, needle):
        assert any(needle in v.message for v in CHK.audit_source(src))

    def test_capped_family_passes(self):
        assert CHK.audit_source(
            'r.gauge("serving_slo_model_burn_rate", "help", 1, '
            '{"model": m})') == []

    @pytest.mark.parametrize("text,needle", [
        ("# HELP a_total x\n# TYPE a_total counter\na_total 1\na_total 2\n",
         "duplicate series"),
        ("# HELP a x\n# TYPE a gauge\nb 1\n", "no HELP/TYPE"),
        ("# HELP a \n# TYPE a gauge\na 1\n", "empty HELP"),
        ("# HELP a_total x\n# TYPE a_total gauge\na_total 1\n",
         "reserved suffix"),
        ("# HELP c x\n# TYPE c counter\nc 1\n", "_total"),
        ('# HELP g x\n# TYPE g gauge\ng{model="m"} 1\n', "CAPPED"),
        ("# HELP h_ms x\n# TYPE h_ms histogram\n"
         'h_ms_bucket{le="1"} 2\nh_ms_bucket{le="+Inf"} 1\nh_ms_count 1\n',
         "not monotone"),
        ("# HELP h_ms x\n# TYPE h_ms histogram\n"
         'h_ms_bucket{le="1"} 1\nh_ms_bucket{le="+Inf"} 2\nh_ms_count 3\n',
         "_count != +Inf"),
        ("# HELP g x\n# TYPE g gauge\ng{a=b} 1\n", "bad labels"),
        ("# HELP g x\n# TYPE g nonsense\n", "bad TYPE"),
    ])
    def test_text_audit_catches(self, text, needle):
        assert any(needle in v.message for v in CHK.audit_text(text))


# ---------------------------------------------------------------------------
# debug endpoints: strict query validation
# ---------------------------------------------------------------------------


class TestDebugEndpointValidation:
    @pytest.fixture()
    def engine(self):
        rec = PFR.FlightRecorder(min_interval_s=0.0)
        engine = serve_model(Lambda.apply(_echo), port=0, batch_size=4,
                             tracer=PT.Tracer(enabled=True),
                             flight_recorder=rec)
        yield engine
        engine.stop()
        rec.close()

    @pytest.mark.parametrize("query", ["limit=abc", "limit=-1",
                                       "limit=1.5", "limit="])
    def test_bad_limit_is_400_not_500(self, engine, query):
        for path in ("/debug/traces", "/debug/bundle"):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _get(f"{engine.source.address}{path}?{query}&confirm=1")
            assert exc.value.code == 400
            assert "limit" in json.loads(exc.value.read())["error"]

    def test_bundle_requires_confirm(self, engine):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(engine.source.address + "/debug/bundle")
        assert exc.value.code == 400
        assert "confirm" in json.loads(exc.value.read())["error"]
        status, bundle = _get(
            engine.source.address + "/debug/bundle?confirm=1&limit=5")
        assert status == 200 and bundle["bundle_version"] == 1
        assert "traces" in bundle and "slo" in bundle
        assert bundle["reason"] == "http_request"

    def test_good_limit_still_works(self, engine):
        for i in range(3):
            assert _post(engine.source.address, i) == 200
        status, payload = _get(
            engine.source.address + "/debug/traces?limit=2")
        assert status == 200
        roots = [e for e in payload["traceEvents"]
                 if e["name"] == "request"]
        assert 0 < len(roots) <= 2


# ---------------------------------------------------------------------------
# the end-to-end acceptance: an error spike on the port's engine
# ---------------------------------------------------------------------------


class TestChaosSLOEndToEnd:
    def test_error_spike_degrades_alerts_bundles_and_resolves(self):
        """An injected error spike flips /healthz to degraded with a
        named active alert, renders grammar-valid serving_slo_*
        families, auto-captures a bundle holding the error traces, the
        alert and the windowed series, and resolves after recovery. The
        monitor's windows move on an injected clock."""
        def bad(table):
            raise RuntimeError("injected chaos: engine poisoned")

        clock = _FakeClock()
        mon = PS.SLOMonitor(
            slos=[PS.SLO("availability", target=0.999)],
            rules=[PS.BurnRateRule("fast_burn", 8.0, 2.0, 14.4,
                                   min_events=3)],
            windows=(2.0, 8.0), bucket_s=0.25, hist_bucket_s=0.5,
            horizon_s=30.0, clock=clock)
        rec = PFR.FlightRecorder(min_interval_s=0.0)
        engine = serve_model(Lambda.apply(_echo), port=0, batch_size=4,
                             max_wait_ms=2.0,
                             tracer=PT.Tracer(enabled=True), slo=mon,
                             flight_recorder=rec, slo_eval_interval_s=0.1)
        addr = engine.source.address
        try:
            for i in range(20):
                assert _post(addr, i) == 200
            clock.advance(0.5)
            _, health = _get(addr + "/healthz")
            assert health["status"] == "ok"
            assert health["slo"]["degraded"] is False

            engine.pipeline = Lambda.apply(bad)
            for i in range(15):
                assert _post(addr, i) == 500
            # the engine records each sample after replying: wait for
            # the 35th, then move the clock past the evaluation gate
            assert _wait(lambda: mon.requests(8.0) == 35)
            clock.advance(0.5)
            _, health = _get(addr + "/healthz")
            assert health["status"] == "degraded", health
            alert = next(a for a in health["slo"]["active_alerts"]
                         if a["name"] == "availability:fast_burn")
            assert alert["burn_short"] > 14.4

            text = urllib.request.urlopen(addr + "/metrics",
                                          timeout=10).read().decode()
            _, samples = validate_prom_text(text)
            assert CHK.audit_text(text) == []
            names = {n for n, _l, _v in samples}
            for required in ("serving_slo_degraded",
                             "serving_slo_burn_rate",
                             "serving_slo_error_rate",
                             "serving_slo_latency_p99_ms",
                             "serving_slo_target",
                             "serving_slo_alert_active",
                             "serving_slo_alerts_fired_total"):
                assert required in names, required
            assert next(v for n, _l, v in samples
                        if n == "serving_slo_degraded") == 1

            assert _wait(lambda: len(rec.bundles) >= 1)
            bundle = rec.bundles[-1]
            assert bundle["reason"].startswith(
                "slo_breach:availability:fast_burn")
            assert any(e.get("args", {}).get("status") == "error"
                       for e in bundle["traces"]["traceEvents"])
            st = next(iter(bundle["slo"].values()))
            assert any(a["name"] == "availability:fast_burn"
                       for a in st["status"]["active_alerts"])
            assert sum(v for _, v in st["series"]["errors"]) >= 3
            json.dumps(bundle)

            engine.pipeline = Lambda.apply(_echo)
            clock.advance(3.0)            # the 2 s short window drains
            for i in range(10):
                assert _post(addr, i) == 200
            assert _wait(lambda: mon.requests(2.0) == 10)
            clock.advance(0.5)
            _, health = _get(addr + "/healthz")
            assert health["status"] == "ok", health
            assert health["slo"]["active_alerts"] == []
            assert health["slo"]["resolved_total"] >= 1
            assert any(not a.active for a in mon.alerts.history())
        finally:
            engine.stop()
            rec.close()
