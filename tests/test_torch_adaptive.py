"""PyTorch port: the SLO-adaptive serving plane (``mmlspark_tpu_torch/
serving/variants.py``, the engine's continuous batcher and
``serving/autoscale.py``) against the JAX package, on the CPU.

The non-slow scenarios of ``tests/test_adaptive.py`` run over port zoos
and engines (``port=0``): variant-ladder declaration and cached routing,
fidelity-floor degradation with hysteretic recovery, continuous-batcher
fairness (bounded wait behind a hot model, reply/model integrity under
concurrency), a swap under continuous load, the watermark autoscaler's
bounded scale rates and drain-before-retire discipline over a fake
fleet, and the ``check_adaptive_serving`` static audit, here
``mmlspark_tpu_torch.testing.fusion_check`` over the port's sources.
``TestDynamicRetryAfter`` lives in ``tests/test_torch_admission.py``.
The reference's wall-clock drills are ported ``slow``, as it marks
them: the SLO ramp over real HTTP and the autoscaler over real
processes (``tests/torch_serving_worker.py``, a port engine with JAX
blocked).

Held against the JAX package: for the same scripted ticks, pressures,
burn alerts and profile samples, the selector's event timeline
(kind, variant, reason), ``status()`` and route table; and for the same
demand trace, the autoscaler's decisions, events and ``stats()``
(equal).
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from mmlspark_tpu.serving.autoscale import \
    FleetAutoscaler as JFleetAutoscaler
from mmlspark_tpu.serving.variants import \
    VariantSelector as JVariantSelector
from mmlspark_tpu.serving.zoo import ModelZoo as JModelZoo
from mmlspark_tpu.stages.basic import Lambda as JLambda

from mmlspark_tpu_torch.serving import (
    FleetAutoscaler, HTTPSource, ModelZoo, ServingEngine, ServingFleet,
    VariantSelector,
)
from mmlspark_tpu_torch.stages.basic import Lambda
from mmlspark_tpu_torch.testing import fusion_check

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def echo_stage(tag, delay=0.0):
    """A serving stage that stamps its variant tag into every reply."""
    def handle(table):
        if delay:
            time.sleep(delay)
        replies = []
        for r in table["request"]:
            row = json.loads(r["entity"].decode()) if r.get("entity") \
                else {}
            replies.append({"served_by": tag, "x": row.get("x")})
        return table.with_column("reply", replies)
    return Lambda.apply(handle)


def post(addr, body, headers=None, path="/", timeout=30.0):
    """(status, parsed body, response headers) — HTTPError unwrapped."""
    req = urllib.request.Request(
        addr + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read())
        except Exception:  # noqa: BLE001
            body = {}
        return e.code, body, dict(e.headers)


def two_variant_zoo(slow=0.0, fast=0.0):
    """One logical model as a 2-rung ladder: full-fidelity ``clf`` and
    the cheap ``clf_int8`` tier."""
    zoo = ModelZoo(memory_probe=None, device="cpu")
    zoo.register_factory("clf", "v1",
                         lambda: echo_stage("clf", delay=slow),
                         metadata={"precision": "f32"})
    zoo.register_factory("clf_int8", "v1",
                         lambda: echo_stage("clf_int8", delay=fast),
                         metadata={"precision": "int8"})
    return zoo


class _FakeAlert:
    def __init__(self, rule, slo="latency_p99"):
        self.rule, self.slo = rule, slo


class _FakeMonitor:
    """Just the ``alerts.active()`` surface the selector reads."""

    def __init__(self):
        self.active_alerts = []
        self.alerts = self

    def active(self):
        return list(self.active_alerts)


# ---------------------------------------------------------------------------
# the variant selector (unit: now-controlled ticks, no HTTP)
# ---------------------------------------------------------------------------


class TestVariantSelector:
    def _selector(self, mon=None, **kw):
        zoo = two_variant_zoo()
        kw.setdefault("hold_s", 5.0)
        kw.setdefault("pressure_limit", 32)
        sel = VariantSelector(zoo, slo=mon, **kw)
        sel.declare("clf", ["clf", "clf_int8"], slo_ms=50.0,
                    costs={"clf": 1.0, "clf_int8": 0.25})
        return sel, zoo

    def test_declare_validates_and_routes_to_preferred(self):
        sel, zoo = self._selector()
        # bare logical name AND every rung key route to the active rung
        assert sel.route("clf") == "clf@v1"
        assert sel.route("clf@v1") == "clf@v1"
        assert sel.route("clf_int8@v1") == "clf@v1"
        assert sel.route("unrelated") == "unrelated"   # passthrough
        assert sel.route(None) is None
        with pytest.raises(ValueError):
            sel.declare("clf", ["clf"], slo_ms=50.0)   # dup ladder
        with pytest.raises(KeyError):
            sel.declare("other", ["ghost"], slo_ms=50.0)
        kinds = [e.kind for e in sel.events]
        assert kinds == ["declare"]
        zoo.close()

    def test_route_is_a_pure_cache_read(self):
        sel, zoo = self._selector()
        before = len(sel.events)
        for _ in range(100):
            sel.route("clf")
        assert len(sel.events) == before
        assert sel.stats()["selects"] == 0
        zoo.close()

    def test_pressure_opens_floor_and_picks_cheapest(self):
        sel, zoo = self._selector()
        assert sel.tick(pressure=64, now=10.0, min_interval_s=0.0)
        st = sel.status()["clf"]
        assert st["floor"] == 1 and st["active"] == "clf_int8@v1"
        assert st["last_step_down_reason"] == "queue_pressure"
        assert sel.route("clf") == "clf_int8@v1"
        kinds = [e.kind for e in sel.events]
        assert "step_down" in kinds and "select" in kinds
        # floor is bounded by the ladder: another degraded tick
        # cannot open a rung that does not exist
        sel.tick(pressure=64, now=11.0, min_interval_s=0.0)
        assert sel.status()["clf"]["floor"] == 1
        zoo.close()

    def test_fast_burn_steps_down_slow_burn_does_not(self):
        mon = _FakeMonitor()
        sel, zoo = self._selector(mon=mon)
        mon.active_alerts = [_FakeAlert("slow_burn")]
        sel.tick(pressure=0, now=10.0, min_interval_s=0.0)
        assert sel.status()["clf"]["floor"] == 0
        mon.active_alerts = [_FakeAlert("fast_burn")]
        sel.tick(pressure=0, now=11.0, min_interval_s=0.0)
        st = sel.status()["clf"]
        assert st["floor"] == 1
        assert st["last_step_down_reason"] == "fast_burn:latency_p99"
        zoo.close()

    def test_hysteretic_recovery_one_rung_per_hold(self):
        sel, zoo = self._selector(hold_s=5.0)
        sel.tick(pressure=64, now=10.0, min_interval_s=0.0)
        assert sel.status()["clf"]["floor"] == 1
        # clean air, but not for hold_s yet: floor stays open
        sel.tick(pressure=0, now=12.0, min_interval_s=0.0)
        assert sel.status()["clf"]["floor"] == 1
        sel.tick(pressure=0, now=17.5, min_interval_s=0.0)
        st = sel.status()["clf"]
        assert st["floor"] == 0 and st["active"] == "clf@v1"
        assert any(e.kind == "step_up" and e.reason == "recovered"
                   for e in sel.events)
        zoo.close()

    def test_slo_breaching_rung_skipped_on_profile(self):
        sel, zoo = self._selector()
        # profile rung 0 as breaching (p99 way over the 50ms SLO) and
        # rung 1 as meeting: once pressure opens the floor the choice
        # is SLO-driven, not just declared-cost-driven
        for _ in range(20):
            sel.observe("clf@v1", 200.0, rows=1)
            sel.observe("clf_int8@v1", 2.0, rows=1)
        sel.tick(pressure=64, now=100.0, min_interval_s=0.0)
        st = sel.status()["clf"]
        assert st["active"] == "clf_int8@v1"
        rungs = {v["variant"]: v for v in st["variants"]}
        assert rungs["clf@v1"]["p99_ms"] > 50.0
        assert rungs["clf@v1"]["cost_source"] == "declared"
        zoo.close()

    def test_measured_cost_source_without_declared(self):
        zoo = two_variant_zoo()
        sel = VariantSelector(zoo)
        sel.declare("clf", ["clf", "clf_int8"], slo_ms=50.0)
        rungs = {v["variant"]: v
                 for v in sel.status()["clf"]["variants"]}
        assert rungs["clf@v1"]["cost_source"] == "unprofiled"
        sel.observe("clf@v1", 8.0, rows=4)
        rungs = {v["variant"]: v
                 for v in sel.status()["clf"]["variants"]}
        assert rungs["clf@v1"]["cost_source"] == "measured"
        assert rungs["clf@v1"]["cost"] == pytest.approx(2.0)
        zoo.close()

    def test_tick_rate_gate(self):
        sel, zoo = self._selector(decide_interval_s=0.5)
        assert sel.tick(now=10.0)
        assert not sel.tick(now=10.2)     # gated
        assert sel.tick(now=10.6)
        zoo.close()


# ---------------------------------------------------------------------------
# dynamic Retry-After (unit over an unstarted engine)
# ---------------------------------------------------------------------------


class TestDynamicRetryAfter:
    @pytest.fixture
    def eng(self):
        source = HTTPSource(port=0)
        engine = ServingEngine(source, echo_stage("m"), tracing=False,
                               slo=False, retry_after_max_s=30)
        yield engine
        source.close()

    def test_estimate_backlog_over_drain_rate(self, eng):
        assert eng._retry_after_s == 1
        # 40 rows backed up, draining at ~8 rows/s -> ceil(5) = 5s
        eng._drained_rows.inc(80.0)        # 80 rows in the 10s window
        for i in range(40):
            eng.source.queue.put(object())
        eng._update_retry_after(now=100.0)
        assert eng._retry_after_s == 5
        assert eng.source.retry_after_s == 5
        assert eng._retry_header() == "5"
        assert eng._retry_header(floor=9) == "9"

    def test_no_drain_rate_quotes_the_cap(self, eng):
        eng.source.queue.put(object())
        eng._update_retry_after(now=100.0)
        assert eng._retry_after_s == 30

    def test_clamped_to_window_and_rate_gated(self, eng):
        eng._drained_rows.inc(1.0)         # 0.1 rows/s
        for i in range(900):
            eng.source.queue.put(object())
        eng._update_retry_after(now=100.0)
        assert eng._retry_after_s == 30    # 9000s clamps to the cap
        while not eng.source.queue.empty():
            eng.source.queue.get_nowait()
        eng._update_retry_after(now=100.2)   # inside the 0.5s gate
        assert eng._retry_after_s == 30
        eng._update_retry_after(now=100.8)
        assert eng._retry_after_s == 1


# ---------------------------------------------------------------------------
# continuous-batcher fairness (real HTTP)
# ---------------------------------------------------------------------------


@pytest.fixture
def adaptive_engine():
    zoo = two_variant_zoo()
    zoo.register_factory("hot", "v1",
                         lambda: echo_stage("hot", delay=0.03))
    sel = VariantSelector(zoo, decide_interval_s=0.05, hold_s=0.5,
                          pressure_limit=24)
    sel.declare("clf", ["clf", "clf_int8"], slo_ms=50.0,
                costs={"clf": 1.0, "clf_int8": 0.25})
    source = HTTPSource(port=0)
    engine = ServingEngine(source, zoo=zoo, variants=sel, batch_size=4,
                           max_wait_ms=2.0, tracing=False,
                           slo=False).start()
    yield engine, sel, zoo, source.address
    engine.stop()
    zoo.close()


class TestContinuousBatcherFairness:
    def test_reply_and_model_integrity_under_concurrency(
            self, adaptive_engine):
        engine, sel, zoo, addr = adaptive_engine
        results, lock = [], threading.Lock()

        def client(model, tid):
            for i in range(10):
                x = tid * 1000 + i
                code, body, headers = post(addr, {"x": x},
                                           {"X-Model": model})
                with lock:
                    results.append((model, x, code, body, headers))

        threads = [threading.Thread(target=client, args=(m, t))
                   for t, m in enumerate(["clf", "clf_int8", "hot"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(results) == 30
        for model, x, code, body, headers in results:
            assert code == 200
            assert body["x"] == x                  # reply is MINE
            served = headers.get("X-Model", "")
            if model == "hot":
                assert served == "hot@v1"
            else:
                # ladder members may be re-routed, but never off the
                # ladder — zero cross-model replies
                assert served in ("clf@v1", "clf_int8@v1"), served
                assert body["served_by"] in ("clf", "clf_int8")

    def test_bounded_wait_behind_hot_model(self, adaptive_engine):
        engine, sel, zoo, addr = adaptive_engine
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                post(addr, {"x": 0}, {"X-Model": "hot"})

        threads = [threading.Thread(target=hammer) for _ in range(3)]
        for t in threads:
            t.start()
        try:
            time.sleep(0.2)                     # hot stream saturates
            t0 = time.perf_counter()
            code, body, _ = post(addr, {"x": 7}, {"X-Model": "clf"})
            waited = time.perf_counter() - t0
            assert code == 200 and body["x"] == 7
            # continuous admission: the cold model's single request is
            # dispatched within a few slots, not after the hot stream
            assert waited < 3.0, f"starved for {waited:.2f}s"
        finally:
            stop.set()
            for t in threads:
                t.join()

    def test_healthz_exposes_variant_plane_and_retry_after(
            self, adaptive_engine):
        engine, sel, zoo, addr = adaptive_engine
        post(addr, {"x": 1}, {"X-Model": "clf"})
        with urllib.request.urlopen(addr + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        v = health["metrics"]["variants"]["clf"]
        assert v["active"] == "clf@v1" and v["rung"] == 0
        assert "last_step_down_reason" in v
        assert all("cost_source" in rung for rung in v["variants"])
        assert 1 <= health["metrics"]["retry_after_s"] <= 30
        text = engine.metrics_text()
        assert "serving_variant_rung" in text
        assert "serving_retry_after_s" in text


class TestSwapUnderContinuousLoad:
    def test_swap_drains_and_flips_under_load(self):
        from mmlspark_tpu_torch.serving.lifecycle import CanaryPolicy
        source = HTTPSource(port=0)
        engine = ServingEngine(source, echo_stage("v1"), batch_size=4,
                               max_wait_ms=2.0, tracing=False,
                               slo=False).start()
        stop = threading.Event()
        seen, lock = [], threading.Lock()

        def load():
            i = 0
            while not stop.is_set():
                code, body, _ = post(source.address, {"x": i})
                with lock:
                    seen.append((code, body))
                i += 1

        threads = [threading.Thread(target=load) for _ in range(2)]
        for t in threads:
            t.start()
        try:
            time.sleep(0.2)
            result = engine.swap(
                echo_stage("v2"), "v2",
                policy=CanaryPolicy(fraction=0.2, min_batches=4))
            assert result.completed, result
            time.sleep(0.3)
        finally:
            stop.set()
            for t in threads:
                t.join()
        engine.stop()
        assert len(seen) > 20
        tags = {body["served_by"] for code, body in seen if code == 200}
        # every reply came from a real version; post-swap traffic runs v2
        assert tags <= {"v1", "v2"} and "v2" in tags
        assert all(code == 200 for code, _ in seen)


# ---------------------------------------------------------------------------
# the fleet autoscaler (unit: fake fleet + fake spawner)
# ---------------------------------------------------------------------------


class _FakeFleet:
    def __init__(self, base=1):
        self.addresses = [f"http://127.0.0.1:{9}" for _ in range(base)]
        self.rate = 0.0
        self.autoscaler = None
        self.added, self.removed = [], []

    def demand_rate(self, window_s=30.0):
        return self.rate

    def add_engine(self, address, wait_ready_s=0.0):
        self.addresses.append(address)
        self.added.append(address)
        return len(self.addresses) - 1

    def remove_engine(self, address):
        if address not in self.addresses:
            raise ValueError(address)
        self.addresses.remove(address)
        self.removed.append(address)


class TestFleetAutoscaler:
    def _autoscaler(self, fleet=None, **kw):
        fleet = fleet or _FakeFleet()
        stopped = []
        n = [0]

        def spawner():
            n[0] += 1
            addr = f"http://127.0.0.1:{7000 + n[0]}"
            stopped.append([])
            idx = len(stopped) - 1
            return addr, (lambda: stopped[idx].append(addr))

        kw.setdefault("up_rate", 100.0)
        kw.setdefault("window_s", 2.0)
        auto = FleetAutoscaler(fleet, spawner, **kw)
        return auto, fleet, stopped

    def test_watermark_validation(self):
        fleet = _FakeFleet()
        with pytest.raises(ValueError):
            FleetAutoscaler(fleet, lambda: None, min_engines=0)
        with pytest.raises(ValueError):
            FleetAutoscaler(fleet, lambda: None, min_engines=3,
                            max_engines=2)
        with pytest.raises(ValueError):
            FleetAutoscaler(fleet, lambda: None, up_rate=10.0,
                            down_rate=10.0)

    def test_scale_up_bounded_by_cooldown_and_max(self):
        auto, fleet, _ = self._autoscaler(max_engines=3, cooldown_s=5.0)
        fleet.rate = 500.0
        assert auto.tick(now=100.0) == "scale_up"
        assert len(fleet.addresses) == 2
        assert auto.tick(now=101.0) is None       # cooldown
        assert auto.tick(now=106.0) == "scale_up"
        assert len(fleet.addresses) == 3
        assert auto.tick(now=120.0) is None       # at max_engines
        assert auto.stats()["scale_ups"] == 2
        kinds = [e.kind for e in auto.events]
        assert kinds == ["scale_up", "scale_up"]

    def test_scale_down_only_owned_through_drain(self):
        auto, fleet, stopped = self._autoscaler(
            max_engines=3, cooldown_s=0.0, down_cooldown_s=0.0,
            drain_timeout_s=1.0)
        fleet.rate = 500.0
        auto.tick(now=100.0)
        auto.tick(now=101.0)
        assert len(fleet.addresses) == 3
        fleet.rate = 1.0
        assert auto.tick(now=200.0) == "scale_down"
        # newest-first retire; rotation removal happened (drain path)
        assert fleet.removed == [fleet.added[-1]]
        assert stopped[1] == [fleet.added[-1]]    # its stopper ran
        assert auto.tick(now=300.0) == "scale_down"
        # only the baseline engine is left: NOT ours, never retired
        assert auto.tick(now=400.0) is None
        assert len(fleet.addresses) == 1
        assert auto.stats()["scale_downs"] == 2

    def test_never_below_min_engines(self):
        fleet = _FakeFleet(base=1)
        auto, fleet, _ = self._autoscaler(
            fleet=fleet, min_engines=1, cooldown_s=0.0,
            down_cooldown_s=0.0)
        fleet.rate = 0.0
        assert auto.tick(now=100.0) is None
        assert len(fleet.addresses) == 1

    def test_spawn_failure_keeps_width(self):
        fleet = _FakeFleet()

        def bad_spawner():
            raise RuntimeError("no capacity")

        auto = FleetAutoscaler(fleet, bad_spawner, up_rate=10.0)
        fleet.rate = 500.0
        assert auto.tick(now=100.0) is None
        assert len(fleet.addresses) == 1
        assert auto.stats()["spawn_failures"] == 1

    def test_join_failure_stops_orphan_process(self):
        class RejectingFleet(_FakeFleet):
            def add_engine(self, address, wait_ready_s=0.0):
                raise RuntimeError("probe timed out")

        auto, fleet, stopped = self._autoscaler(fleet=RejectingFleet())
        fleet.rate = 500.0
        assert auto.tick(now=100.0) is None
        assert stopped[0]           # the never-joined process was stopped
        assert auto.stats()["spawn_failures"] == 1

    def test_stats_render_as_prometheus_families(self):
        from mmlspark_tpu_torch.core.prometheus import (
            PromRenderer, autoscale_families,
        )
        auto, fleet, _ = self._autoscaler()
        r = PromRenderer()
        autoscale_families(r, auto)
        text = r.render()
        for family in ("serving_autoscale_engines",
                       "serving_autoscale_demand_rate",
                       "serving_autoscale_scale_ups_total",
                       "serving_autoscale_scale_downs_total"):
            assert family in text, family
        assert fleet.autoscaler is auto


# ---------------------------------------------------------------------------
# the static audit (check_adaptive_serving)
# ---------------------------------------------------------------------------


_GOOD_AUTOSCALE = (
    "class A:\n"
    "    def _drain_and_stop(self, addr):\n"
    "        self.fleet.remove_engine(addr)\n"
    "        self._stop_proc(addr)\n"
    "    def _stop_proc(self, p):\n"
    "        p.terminate()\n")

_GOOD_SERVER = (
    "class E:\n"
    "    def _batcher_loop(self):\n"
    "        self.variants.tick(pressure=0)\n"
    "    def _ingest(self, parked):\n"
    "        key = self.variants.route(key)\n"
    "    def _execute_batch(self):\n"
    "        self.variants.observe(k, ms, n)\n"
    "class Handler:\n"
    "    def do_POST(self):\n"
    "        pass\n")


class TestAdaptiveServingAudit:
    def test_shipped_sources_clean(self):
        mod = fusion_check
        assert mod.check_adaptive_serving() == []

    def test_good_shapes_pass(self):
        mod = fusion_check
        assert mod.check_adaptive_serving_source(
            _GOOD_SERVER, _GOOD_AUTOSCALE) == []

    def test_selection_in_http_handler_flagged(self):
        mod = fusion_check
        bad = _GOOD_SERVER.replace(
            "    def do_POST(self):\n        pass\n",
            "    def do_POST(self):\n"
            "        key = self.engine.variants.route(key)\n")
        v = mod.check_adaptive_serving_source(bad, _GOOD_AUTOSCALE)
        assert any("HTTP handler touches '.variants'" in m for m in v)

    def test_tick_off_the_batcher_thread_flagged(self):
        mod = fusion_check
        bad = _GOOD_SERVER + (
            "class F:\n"
            "    def _pump(self):\n"
            "        self.variants.tick(pressure=1)\n")
        v = mod.check_adaptive_serving_source(bad, _GOOD_AUTOSCALE)
        assert any("variants.tick called from '_pump'" in m for m in v)

    def test_scale_down_outside_drain_funnel_flagged(self):
        mod = fusion_check
        bad = _GOOD_AUTOSCALE + (
            "class B:\n"
            "    def tick(self):\n"
            "        self.fleet.remove_engine(a)\n"
            "        self.proc.kill()\n")
        v = mod.check_adaptive_serving_source(_GOOD_SERVER, bad)
        assert any("remove_engine called from 'tick'" in m for m in v)
        assert any("raw kill call from 'tick'" in m for m in v)


# ---------------------------------------------------------------------------
# the same scripted decisions through both packages
# ---------------------------------------------------------------------------


def _selector_trace(zoo_cls, sel_cls, lam, **zoo_kw):
    """One scripted run of the selector: declared and measured costs,
    queue pressure, slow and fast burns, clean air past hold_s."""
    zoo = zoo_cls(memory_probe=None, **zoo_kw)
    for name in ("clf", "clf_int8", "lm", "lm_int8"):
        zoo.register_factory(name, "v1", lambda: lam(lambda t: t),
                             metadata={"precision": "f32"})
    mon = _FakeMonitor()
    sel = sel_cls(zoo, slo=mon, hold_s=5.0, pressure_limit=32)
    try:
        sel.declare("clf", ["clf", "clf_int8"], slo_ms=50.0,
                    costs={"clf": 1.0, "clf_int8": 0.25})
        sel.declare("lm", ["lm", "lm_int8"], slo_ms=10.0)
        for _ in range(20):
            sel.observe("lm@v1", 200.0, rows=2)
            sel.observe("lm_int8@v1", 2.0, rows=2)
        steps = [(0, [], 10.0), (64, [], 11.0), (64, [], 12.0),
                 (0, ["slow_burn"], 13.0), (0, ["fast_burn"], 14.0),
                 (0, [], 15.0), (0, [], 18.0), (0, [], 21.0),
                 (0, [], 27.0)]
        routes = []
        for pressure, rules, now in steps:
            mon.active_alerts = [_FakeAlert(r) for r in rules]
            sel.tick(pressure=pressure, now=now, min_interval_s=0.0)
            routes.append((sel.route("clf"), sel.route("lm@v1")))
        timeline = [(e.kind, e.model, e.variant, e.reason)
                    for e in sel.events]
        return timeline, routes, sel.status(), sel.stats()
    finally:
        zoo.close()


def test_variant_decisions_match_the_jax_package():
    got = _selector_trace(ModelZoo, VariantSelector, Lambda.apply,
                          device="cpu")
    want = _selector_trace(JModelZoo, JVariantSelector, JLambda.apply)
    assert got == want
    kinds = [k for k, *_ in got[0]]
    assert "step_down" in kinds and "step_up" in kinds
    assert got[1][1] == ("clf_int8@v1", "lm_int8@v1")


def test_autoscaler_decisions_match_the_jax_package():
    def run(cls):
        fleet = _FakeFleet()
        n = [0]

        def spawner():
            n[0] += 1
            return f"http://127.0.0.1:{7000 + n[0]}", (lambda: None)

        auto = cls(fleet, spawner, max_engines=3, up_rate=100.0,
                   window_s=2.0, cooldown_s=5.0, down_cooldown_s=10.0,
                   drain_timeout_s=1.0)
        out = []
        for rate, now in ((500.0, 100.0), (500.0, 102.0),
                          (500.0, 106.0), (500.0, 120.0), (1.0, 125.0),
                          (1.0, 140.0), (1.0, 160.0), (1.0, 180.0),
                          (50.0, 200.0)):
            fleet.rate = rate
            out.append((auto.tick(now=now), list(fleet.addresses)))
        stats = auto.stats()
        return out, [(e.kind, e.address, e.reason) for e in auto.events], \
            {k: v for k, v in stats.items() if k != "demand_rate"}

    got = run(FleetAutoscaler)
    assert got == run(JFleetAutoscaler)
    assert [d for d, _ in got[0] if d] == ["scale_up", "scale_up",
                                          "scale_down", "scale_down"]


# ---------------------------------------------------------------------------
# chaos acceptance: SLO ramp -> step_down -> recovery (slow)
# ---------------------------------------------------------------------------


class _BucketStage:
    """An echo scorer with TPUModel-shaped pow-2 bucket accounting:
    ``jit_cache_misses`` counts distinct padded bucket sizes, with the
    serving buckets pre-warmed (the AOT/warmup contract) — so any
    batch the engine dispatches OUTSIDE the warmed pow-2 set counts
    as a steady-state recompile."""

    def __init__(self, tag, delay=0.0, max_bucket=8):
        self.tag, self.delay = tag, delay
        self.warmed = set()
        b = 1
        while b <= max_bucket:
            self.warmed.add(b)
            b *= 2
        self.jit_cache_misses = 0

    def transform(self, table):
        n = len(table["request"])
        bucket = 1
        while bucket < n:
            bucket *= 2
        if bucket not in self.warmed:
            self.jit_cache_misses += 1
            self.warmed.add(bucket)
        if self.delay:
            time.sleep(self.delay)
        replies = []
        for r in table["request"]:
            row = json.loads(r["entity"].decode()) if r.get("entity") \
                else {}
            replies.append({"served_by": self.tag, "x": row.get("x")})
        return table.with_column("reply", replies)


@pytest.mark.slow
class TestChaosAdaptiveServing:
    def test_ramp_step_down_availability_and_recovery(self):
        """The tentpole acceptance drill over REAL HTTP: a load ramp
        breaches the latency SLO -> fast burn -> the selector steps
        the ladder down to int8 (a VariantEvent on the timeline) while
        availability stays >= 99%, zero replies cross models, and
        neither variant sees an unwarmed pow-2 bucket; after the ramp
        stops, sustained clean air steps fidelity back up."""
        from mmlspark_tpu_torch.core.slo import BurnRateRule, SLO, SLOMonitor

        f32 = _BucketStage("clf", delay=0.08)
        int8 = _BucketStage("clf_int8", delay=0.002)
        zoo = ModelZoo(memory_probe=None, device="cpu")
        zoo.register_factory("clf", "v1", lambda: f32,
                             metadata={"precision": "f32"})
        zoo.register_factory("clf_int8", "v1", lambda: int8,
                             metadata={"precision": "int8"})
        mon = SLOMonitor(
            slos=[SLO("latency", "latency", target=0.99,
                      latency_threshold_ms=40.0)],
            rules=[BurnRateRule("fast_burn", 8.0, 2.0, 14.4,
                                min_events=5)],
            horizon_s=60.0)
        sel = VariantSelector(zoo, slo=mon, decide_interval_s=0.1,
                              hold_s=1.0, window_s=30.0,
                              pressure_limit=10_000)
        sel.declare("clf", ["clf", "clf_int8"], slo_ms=40.0,
                    costs={"clf": 1.0, "clf_int8": 0.25})
        source = HTTPSource(port=0)
        engine = ServingEngine(source, zoo=zoo, variants=sel,
                               batch_size=8, max_wait_ms=2.0,
                               tracing=False, slo=mon).start()
        addr = source.address
        results, lock = [], threading.Lock()
        stop = threading.Event()

        def client():
            i = 0
            while not stop.is_set():
                x = id(threading.current_thread()) % 10_000 + i * 10_000
                code, body, headers = post(addr, {"x": x},
                                           {"X-Model": "clf"})
                with lock:
                    results.append((x, code, body,
                                    headers.get("X-Model", "")))
                i += 1

        try:
            # steady state: preferred rung serves
            code, body, headers = post(addr, {"x": 1},
                                       {"X-Model": "clf"})
            assert code == 200 and headers["X-Model"] == "clf@v1"

            # the ramp: enough concurrency that every f32 reply
            # breaches the 40ms objective
            threads = [threading.Thread(target=client)
                       for _ in range(6)]
            for t in threads:
                t.start()
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                if any(e.kind == "step_down" for e in sel.events):
                    break
                time.sleep(0.1)
            assert any(e.kind == "step_down" and "fast_burn" in e.reason
                       for e in sel.events), \
                f"no step_down; events={sel.events} " \
                f"alerts={[a.name for a in mon.alerts.active()]}"
            # let the cheap tier serve for a bit under the same load
            time.sleep(1.5)
            stop.set()
            for t in threads:
                t.join()

            with lock:
                total = len(results)
                ok = sum(1 for _, code, _, _ in results if code == 200)
            assert total > 30
            assert ok / total >= 0.99, f"{ok}/{total}"
            for x, code, body, served in results:
                if code != 200:
                    continue
                assert body["x"] == x              # zero wrong replies
                assert served in ("clf@v1", "clf_int8@v1"), served
            assert sel.status()["clf"]["active"] == "clf_int8@v1"
            # zero steady-state recompiles: no batch ever left the
            # warmed pow-2 bucket set on either variant
            assert f32.jit_cache_misses == 0
            assert int8.jit_cache_misses == 0

            # recovery: clean air (fast int8 replies) resolves the
            # burn, and hold_s later the ladder steps back up
            deadline = time.monotonic() + 30.0
            stepped_up = False
            while time.monotonic() < deadline:
                code, _, _ = post(addr, {"x": 2}, {"X-Model": "clf"})
                assert code == 200
                if any(e.kind == "step_up" for e in sel.events):
                    stepped_up = True
                    break
                time.sleep(0.2)
            assert stepped_up, \
                f"no step_up; alerts=" \
                f"{[a.name for a in mon.alerts.active()]}"
            assert sel.status()["clf"]["active"] == "clf@v1"
            # the drill landed on the registry timeline
            kinds = [getattr(e, "kind", "") for e in zoo.events]
            assert "step_down" in kinds and "step_up" in kinds
        finally:
            stop.set()
            engine.stop()
            zoo.close()


# ---------------------------------------------------------------------------
# autoscaler over real OS processes (slow)
# ---------------------------------------------------------------------------


@pytest.mark.slow
class TestAutoscalerRealProcesses:
    def test_scale_up_serve_drain_retire(self):
        """The full loop with tests/torch_serving_worker.py engines: demand
        ramp spawns + probes + joins a second process, the fleet
        serves across both, demand decay retires it through the drain
        path, and the retired process actually exits."""
        worker = os.path.join(_REPO, "tests", "torch_serving_worker.py")
        procs = []

        def spawn_worker(wid, port):
            p = subprocess.Popen(
                [sys.executable, worker, str(port), str(wid)],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True)
            procs.append(p)
            line = p.stdout.readline().strip()
            tag, _, addr, _pid = line.split()
            assert tag == "READY", line
            return addr, p

        try:
            base_addr, base_proc = spawn_worker(0, 0)
            fleet = ServingFleet.connect([base_addr], wait_ready_s=30)
            wid = [0]

            def spawner():
                wid[0] += 1
                return spawn_worker(wid[0], 0)

            auto = FleetAutoscaler(
                fleet, spawner, min_engines=1, max_engines=2,
                up_rate=5.0, down_rate=2.0, window_s=2.0,
                cooldown_s=0.0, down_cooldown_s=0.0,
                startup_probe_s=30.0, drain_timeout_s=5.0)

            for i in range(40):
                assert fleet.post({"x": i})["echo"] == i
            assert fleet.demand_rate(2.0) > 5.0
            assert auto.tick() == "scale_up"
            assert len(fleet.addresses) == 2

            # both engines serve through the widened rotation
            for i in range(40, 60):
                assert fleet.post({"x": i})["echo"] == i

            time.sleep(2.5)                 # demand window decays
            assert fleet.demand_rate(2.0) < 2.0
            assert auto.tick() == "scale_down"
            assert len(fleet.addresses) == 1
            grown = procs[1]
            grown.wait(timeout=10)          # retired process exited
            assert grown.poll() is not None
            # the survivor still serves
            assert fleet.post({"x": 99})["echo"] == 99
            assert auto.stats()["scale_ups"] == 1
            assert auto.stats()["scale_downs"] == 1
            assert "serving_autoscale_engines" in fleet.metrics_text()
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
