"""PyTorch port: the fleet-wide placement plane (``mmlspark_tpu_torch/
serving/placement.py``) and the fleet's routing through it, against the
JAX package, on the CPU.

The scenarios of ``tests/test_placement.py`` run over port zoos and
in-process fleets (``base_port=0``): demand-driven replica counts,
residency-aware balanced packing, sticky assignments, the rebuild rate
limit, engine death, stale-route fallback, fleet-global eviction through
the zoo's invariants, and the placement events interleaved with the
zoo's on one timeline. The lazy-export check covers
``mmlspark_tpu_torch.serving``, the shm ring included.

Held against the JAX package: for the same demand and engine-liveness
script, the same plans, replica counts and (kind, model, reason,
engines) event sequence (equal).
"""

import json
import time

import pytest

from mmlspark_tpu.serving.placement import \
    PlacementController as JPlacementController

from mmlspark_tpu_torch.serving.placement import (
    PlacementController, PlacementEvent,
)
from mmlspark_tpu_torch.serving.zoo import RESIDENT, UNLOADED, ModelZoo
from mmlspark_tpu_torch.stages.basic import Lambda


def echo_stage(tag):
    def handle(table):
        replies = []
        for r in table["request"]:
            row = (json.loads(r["entity"].decode())
                   if r.get("entity") else {})
            replies.append({"served_by": tag, "x": row.get("x")})
        return table.with_column("reply", replies)
    return Lambda.apply(handle)


def fresh_zoo(n_models=4, **kw):
    kw.setdefault("memory_probe", None)
    zoo = ModelZoo(device="cpu", **kw)
    for i in range(n_models):
        zoo.register_factory(f"m{i}", "v1",
                             (lambda i=i: echo_stage(f"m{i}")))
    return zoo


class _Recorder:
    """A zoo stand-in: the event timeline plus residency-cost rows."""

    def __init__(self, costs=None):
        self.events = []
        self._costs = dict(costs or {})

    def record_event(self, event):
        self.events.append(event)

    def stats(self):
        rows = [{"model": k.partition("@")[0],
                 "version": k.partition("@")[2] or "v1",
                 "cost_bytes": v} for k, v in self._costs.items()]
        return {"models": rows}


def _drive(ctl, model, n):
    for _ in range(n):
        ctl.record_request(model)


class TestPlacementController:
    def test_hot_gets_replicas_cold_gets_one(self):
        ctl = PlacementController(None, n_engines=4, hot_share=0.5)
        _drive(ctl, "hot", 30)
        _drive(ctl, "cold", 1)
        ctl.rebuild(force=True)
        counts = ctl.replica_counts()
        assert counts["hot"] >= 2
        assert counts["cold"] == 1

    def test_every_demanded_model_stays_servable(self):
        ctl = PlacementController(None, n_engines=2)
        for m in ("a", "b", "c", "d"):
            _drive(ctl, m, 3)
        plan = ctl.rebuild(force=True)
        assert set(plan) == {"a", "b", "c", "d"}
        assert all(len(v) >= 1 for v in plan.values())
        assert all(0 <= i < 2 for v in plan.values() for i in v)

    def test_max_replicas_caps_hot_models(self):
        ctl = PlacementController(None, n_engines=4, max_replicas=1)
        _drive(ctl, "hot", 50)
        ctl.rebuild(force=True)
        assert ctl.replica_counts()["hot"] == 1

    def test_residency_aware_packing_spreads_cost(self):
        rec = _Recorder(costs={"a@v1": 100, "b@v1": 100})
        ctl = PlacementController(rec, n_engines=2, hot_share=0.9)
        _drive(ctl, "a", 5)
        _drive(ctl, "b", 5)
        plan = ctl.rebuild(force=True)
        # two equal-cost single-replica models land on DIFFERENT
        # engines (balanced packing), not both on engine 0
        assert plan["a"] != plan["b"]

    def test_assignments_are_sticky_across_rebuilds(self):
        rec = _Recorder()
        ctl = PlacementController(rec, n_engines=3)
        _drive(ctl, "a", 5)
        _drive(ctl, "b", 5)
        first = ctl.rebuild(force=True)
        n_events = len(rec.events)
        second = ctl.rebuild(force=True)
        assert second == first
        # no assign/unassign churn — only the rebuild summary lands
        new = rec.events[n_events:]
        assert [e.kind for e in new] == ["rebuild"]

    def test_rebuild_is_rate_limited(self):
        ctl = PlacementController(None, n_engines=2,
                                  rebuild_min_interval_s=600.0)
        _drive(ctl, "a", 3)
        ctl.rebuild(force=True)
        n = ctl.rebuilds
        _drive(ctl, "b", 30)
        plan = ctl.rebuild()               # inside the min interval
        assert ctl.rebuilds == n
        assert "b" not in plan             # the frozen plan, unchanged

    def test_mark_engine_dead_reassigns_immediately(self):
        ctl = PlacementController(None, n_engines=2, hot_share=0.1)
        _drive(ctl, "hot", 20)
        ctl.rebuild(force=True)
        assert ctl.replica_counts()["hot"] == 2
        ctl.mark_engine_dead(0)
        plan = ctl.assignments()
        assert 0 not in plan["hot"] and plan["hot"] == (1,)
        ctl.mark_engine_alive(0)
        assert ctl.rebuild(force=True)["hot"] == (0, 1)

    def test_stale_route_counted_for_unknown_model(self):
        ctl = PlacementController(None, n_engines=2)
        assert ctl.engines_for("never-seen") == []
        assert ctl.stale_routes == 1

    def test_timeline_events_carry_engine_deltas(self):
        rec = _Recorder()
        ctl = PlacementController(rec, n_engines=2, hot_share=0.1)
        _drive(ctl, "hot", 20)
        ctl.rebuild(force=True, reason="demand")
        kinds = [e.kind for e in rec.events]
        assert kinds == ["assign", "rebuild"]
        assign = rec.events[0]
        assert isinstance(assign, PlacementEvent)
        assert assign.model == "hot"
        assert assign.stats["engines"] == [0, 1]
        assert rec.events[1].stats["models"] == 1
        ctl.mark_engine_dead(1)
        unassigns = [e for e in rec.events if e.kind == "unassign"]
        assert unassigns and unassigns[0].stats["engines"] == [1]
        assert unassigns[0].reason == "engine1_dead"


class TestPlacementEviction:
    def test_evict_coldest_offers_coldest_first(self):
        zoo = fresh_zoo(n_models=3)
        ctl = PlacementController(zoo, n_engines=2)
        try:
            zoo.get("m0")
            zoo.get("m1")
            _drive(ctl, "m0", 30)
            _drive(ctl, "m1", 1)
            assert ctl.evict_coldest(keep=1) == "m1"
            assert zoo.lookup("m1@v1")[1] == UNLOADED
            assert zoo.lookup("m0@v1")[1] == RESIDENT
        finally:
            zoo.close()

    def test_zoo_invariants_arbitrate_every_offer(self):
        zoo = fresh_zoo(n_models=3)
        ctl = PlacementController(zoo, n_engines=2)
        try:
            zoo.get("m0")
            zoo.get("m1")
            _drive(ctl, "m0", 30)
            _drive(ctl, "m1", 1)
            # the coldest model has parked waiters somewhere in the
            # fleet: the zoo refuses; the NEXT coldest is offered, but
            # keep=1 protects the hottest — nothing is evicted
            zoo.add_waiter("m1")
            assert ctl.evict_coldest(keep=1) is None
            assert zoo.lookup("m1@v1")[1] == RESIDENT
            # outstanding batches refuse the same way
            zoo.remove_waiter("m1")
            handle, state, _ = zoo.acquire("m1")
            assert state == RESIDENT
            assert ctl.evict_coldest(keep=1) is None
            handle.release()
            assert ctl.evict_coldest(keep=1) == "m1"
        finally:
            zoo.close()

    def test_demand_for_unregistered_spec_is_skipped(self):
        zoo = fresh_zoo(n_models=1)
        ctl = PlacementController(zoo, n_engines=1)
        try:
            _drive(ctl, "ghost", 1)
            _drive(ctl, "m0", 5)
            assert ctl.evict_coldest(keep=1) is None
        finally:
            zoo.close()


class TestFleetPlacement:
    def _fleet(self, base_port, n_models=3, **kw):
        # base_port 0: the OS picks each engine's port
        from mmlspark_tpu_torch.serving.fleet import ServingFleet
        zoo = fresh_zoo(n_models=n_models)
        fleet = ServingFleet(n_engines=2, base_port=base_port, zoo=zoo,
                             tracing=False)
        ctl = fleet.attach_placement(**kw)
        return fleet, zoo, ctl

    def test_hot_cold_plan_with_one_activation(self):
        fleet, zoo, ctl = self._fleet(0, rebuild_min_interval_s=0.0)
        try:
            for i in range(20):
                assert fleet.post({"x": i},
                                  model="m0")["served_by"] == "m0"
            for i in range(2):
                assert fleet.post({"x": i},
                                  model="m1")["served_by"] == "m1"
            ctl.rebuild(force=True)
            counts = ctl.replica_counts()
            assert counts["m0"] == 2 and counts["m1"] == 1
            # the engines share ONE zoo: replicating m0 across both
            # engines never re-loaded it
            rows = {r["model"]: r for r in zoo.stats()["models"]}
            assert rows["m0"]["loads"] == 1
            text = fleet.metrics_text()
            assert "serving_placement_rebuilds_total" in text
            assert 'serving_placement_replicas{model="m0"} 2' in text
            assert "serving_placement_rebuild_ms_bucket" in text
        finally:
            fleet.stop_all()
            zoo.close()

    def test_stale_route_falls_back_and_lazily_activates(self):
        fleet, zoo, ctl = self._fleet(0,
                                      rebuild_min_interval_s=600.0)
        try:
            ctl.rebuild(force=True)        # empty plan, then frozen
            sr0 = ctl.stale_routes
            out = fleet.post({"x": 9}, model="m2")
            assert out["served_by"] == "m2"     # any engine + lazy load
            assert ctl.stale_routes > sr0
        finally:
            fleet.stop_all()
            zoo.close()

    def test_routes_prefer_assigned_engines(self):
        fleet, zoo, ctl = self._fleet(0,
                                      rebuild_min_interval_s=600.0)
        try:
            ctl.rebuild(force=True)
            with ctl._lock:
                ctl._assignments = {"m1": (1,)}
            seen0 = [e.source.requests_seen for e in fleet.engines]
            for i in range(6):
                assert fleet.post({"x": i},
                                  model="m1")["served_by"] == "m1"
            seen1 = [e.source.requests_seen for e in fleet.engines]
            assert seen1[1] - seen0[1] == 6
            assert seen1[0] - seen0[0] == 0
            # the engine dies (placement-plane view): the plan
            # reassigns and traffic follows without a config change
            ctl.mark_engine_dead(1)
            assert ctl.assignments()["m1"] == (0,)
            for i in range(3):
                assert fleet.post({"x": i},
                                  model="m1")["served_by"] == "m1"
            seen2 = [e.source.requests_seen for e in fleet.engines]
            assert seen2[0] - seen1[0] == 3
        finally:
            fleet.stop_all()
            zoo.close()

    def test_timeline_interleaves_zoo_and_placement_events(self):
        fleet, zoo, ctl = self._fleet(0, rebuild_min_interval_s=0.0)
        try:
            fleet.post({"x": 0}, model="m0")
            fleet.post({"x": 1}, model="m1")
            ctl.rebuild(force=True)
            classes = {type(e).__name__ for e in zoo.events}
            assert {"ZooEvent", "PlacementEvent"} <= classes
            stamps = [e.at for e in zoo.events]
            assert stamps == sorted(stamps)
        finally:
            fleet.stop_all()
            zoo.close()


class TestFabricLazyExports:
    def test_import_serving_does_not_load_the_fabric(self):
        """`import mmlspark_tpu_torch.serving` stays cheap: the placement
        plane, the variant selector, the autoscaler and the shm ring load
        only when an export is actually touched (PEP 562)."""
        import os
        import subprocess
        import sys
        lazy = ("placement", "variants", "autoscale")
        shm = "mmlspark_tpu_torch.io.shm"
        code = (
            "import sys\n"
            "sys.modules['jax'] = None\n"
            "import mmlspark_tpu_torch.serving as sv\n"
            f"lazy = {lazy!r}\n"
            "pkg = 'mmlspark_tpu_torch.serving.'\n"
            "assert not [m for m in lazy if pkg + m in sys.modules]\n"
            "ctl = sv.PlacementController(None, n_engines=2)\n"
            "assert 'mmlspark_tpu_torch.serving.placement' in sys.modules\n"
            "assert sv.VariantSelector.__name__ == 'VariantSelector'\n"
            "assert sv.AutoscaleEvent.__name__ == 'AutoscaleEvent'\n"
            "assert all(pkg + m in sys.modules for m in lazy)\n"
            f"assert {shm!r} not in sys.modules\n"
            "assert sv.ShmRing.__name__ == 'ShmRing'\n"
            f"assert {shm!r} in sys.modules\n"
            "print('LAZY_OK')\n"
        )
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        out = subprocess.run(
            [sys.executable, "-c", code], cwd=repo, text=True,
            capture_output=True, timeout=240)
        assert out.returncode == 0, out.stderr
        assert "LAZY_OK" in out.stdout


# ---------------------------------------------------------------------------
# the same demand script through both packages
# ---------------------------------------------------------------------------


def _placement_trace(cls):
    rec = _Recorder(costs={"a@v1": 300, "b@v1": 100, "c@v1": 100,
                           "d@v1": 50})
    ctl = cls(rec, n_engines=4, hot_share=0.4)
    plans = []
    for model, n in (("a", 40), ("b", 10), ("c", 3), ("d", 1)):
        _drive(ctl, model, n)
    plans.append(ctl.rebuild(force=True, reason="demand"))
    ctl.mark_engine_dead(2)
    plans.append(ctl.assignments())
    _drive(ctl, "b", 60)
    plans.append(ctl.rebuild(force=True, reason="demand"))
    ctl.mark_engine_alive(2)
    ctl.set_n_engines(5, reason="join")
    plans.append(ctl.assignments())
    ctl.set_n_engines(3, reason="leave")
    plans.append(ctl.assignments())
    events = [(e.kind, e.model, e.reason, e.stats.get("engines"),
               e.stats.get("replicas"), e.stats.get("models"))
              for e in rec.events]
    return plans, ctl.replica_counts(), events, ctl.engines_for("ghost")


def test_plans_match_the_jax_package():
    got = _placement_trace(PlacementController)
    assert got == _placement_trace(JPlacementController)
    plans = got[0]
    assert len(plans[0]["a"]) >= 2 and 2 not in plans[1]["a"]
    assert all(max(v) < 3 for v in plans[-1].values())
