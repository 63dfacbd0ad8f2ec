"""PyTorch port: the seeded chaos harness (``testing/chaos.py``) and the
fleet's availability under injected faults, against the JAX package, on
the CPU.

Every scenario of ``tests/test_chaos.py`` runs over port engines bound
on free ports (``base_port=0``), the swap drills included. Held against
the JAX package, bitwise: ``FaultInjector.decide`` over 10,000 keys for
each kind, and the set of rows a ``PoisonedModel`` over an injector
fails. ``test_swap_zero_steady_state_recompiles`` runs over the port's
``TPUModel`` MLP and its ``jit_cache_misses`` (first-run shapes).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.stages.basic import Lambda as JLambda
from mmlspark_tpu.testing.chaos import (
    ChaosError as JChaosError, FaultInjector as JFaultInjector,
    PoisonedModel as JPoisonedModel,
)

from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.io.http import HTTPSchema
from mmlspark_tpu_torch.serving import (
    CanaryPolicy, ServingFleet, ServingUnavailable,
)
from mmlspark_tpu_torch.serving.server import serve_model
from mmlspark_tpu_torch.stages.basic import Lambda
from mmlspark_tpu_torch.testing.chaos import (
    ChaosError, FaultInjector, PoisonedModel, StalledWarmupModel,
)
from mmlspark_tpu_torch.utils.resilience import CircuitBreaker


def echo_pipeline(version=None, lam=Lambda):
    def handle(table):
        reply = [{"echo": json.loads(r["entity"].decode())["x"]}
                 for r in table["request"]]
        if version is not None:
            for r in reply:
                r["v"] = version
        return table.with_column("reply", reply)
    return lam.apply(handle)


def _post(addr, payload, timeout=5.0):
    req = urllib.request.Request(
        addr, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _serve(pipeline, **kw):
    return serve_model(pipeline, port=0, flight_recorder=False, **kw)


def _fleet(pipeline, **kw):
    kw.setdefault("flight_recorder", False)
    return ServingFleet(pipeline, base_port=0, **kw)


# ---------------------------------------------------------------------------
# determinism, against the JAX package
# ---------------------------------------------------------------------------


class TestFaultInjectorDeterminism:
    def test_same_seed_same_decisions(self):
        a = FaultInjector(seed=42, error_rate=0.3, drop_rate=0.2)
        b = FaultInjector(seed=42, error_rate=0.3, drop_rate=0.2)
        keys = [json.dumps({"x": i}).encode() for i in range(200)]
        assert [a.decide("error", k) for k in keys] == \
               [b.decide("error", k) for k in keys]
        assert [a.decide("drop", k) for k in keys] == \
               [b.decide("drop", k) for k in keys]
        frac = sum(a.decide("error", k) for k in keys) / len(keys)
        assert 0.15 < frac < 0.45

    def test_different_seed_different_decisions(self):
        keys = [json.dumps({"x": i}).encode() for i in range(200)]
        a = FaultInjector(seed=1, error_rate=0.3)
        b = FaultInjector(seed=2, error_rate=0.3)
        assert [a.decide("error", k) for k in keys] != \
               [b.decide("error", k) for k in keys]

    def test_decisions_independent_of_batching(self):
        inj = FaultInjector(seed=7, error_rate=0.5)
        k = json.dumps({"x": 3}).encode()
        assert len({inj.decide("error", k) for _ in range(10)}) == 1

    @pytest.mark.parametrize("seed", [0, 17, 2**31 + 5])
    def test_decisions_bitwise_equal_to_jax(self, seed):
        rates = dict(error_rate=0.3, drop_rate=0.05, latency_rate=0.7,
                     latency_s=0.01)
        ours, ref = FaultInjector(seed, **rates), \
            JFaultInjector(seed, **rates)
        rng = np.random.default_rng(seed % 2**32)
        keys = [json.dumps({"x": i}).encode() for i in range(9000)]
        keys += [rng.bytes(int(n)) for n in rng.integers(0, 64, 1000)]
        for kind in ("error", "drop", "latency"):
            got = [ours.decide(kind, k) for k in keys]
            assert got == [ref.decide(kind, k) for k in keys], kind
            assert [ours._unit(kind, k) for k in keys[:500]] == \
                [ref._unit(kind, k) for k in keys[:500]]
        req = {"entity": "é str body"}
        assert ours.request_key(req) == ref.request_key(req)
        assert ours.request_key(None) == ref.request_key(None) == b""

    def test_poisoned_rows_equal_to_jax(self):
        """A PoisonedModel over a seeded injector fails the same rows in
        both packages (each row scored alone, as the engine's per-row
        retry does)."""
        failed = {}
        for name, (Inj, Poisoned, Table, Lam, Err) in {
                "torch": (FaultInjector, PoisonedModel, DataTable, Lambda,
                          ChaosError),
                "jax": (JFaultInjector, JPoisonedModel, JTable, JLambda,
                        JChaosError)}.items():
            model = Poisoned(Inj(seed=23, error_rate=0.25).wrap(
                echo_pipeline(lam=Lam)), fail_batches=0)
            rows = set()
            for i in range(400):
                table = Table({"id": [str(i)], "request": [
                    {"entity": json.dumps({"x": i}).encode()}]})
                try:
                    model.transform(table)
                except Err:
                    rows.add(i)
            failed[name] = rows
        assert failed["torch"] == failed["jax"]
        assert 60 < len(failed["torch"]) < 140


# ---------------------------------------------------------------------------
# injected faults on one engine
# ---------------------------------------------------------------------------


class TestInjectedFaults:
    def test_injected_errors_500_only_the_poisoned_rows(self):
        inj = FaultInjector(seed=11, error_rate=0.3)
        engine = _serve(inj.wrap(echo_pipeline()), batch_size=8)
        try:
            results = {}
            for i in range(20):
                try:
                    results[i] = _post(engine.source.address, {"x": i})[1]
                except urllib.error.HTTPError as e:
                    results[i] = e.code
            expect_poison = {
                i for i in range(20)
                if inj.decide("error", json.dumps({"x": i}).encode())}
            assert expect_poison and expect_poison != set(range(20))
            for i in range(20):
                if i in expect_poison:
                    assert results[i] == 500, (i, results[i])
                else:
                    assert results[i] == {"echo": i}, (i, results[i])
            assert inj.injected_errors > 0
        finally:
            engine.stop()

    def test_injected_drops_500_only_the_dropped_rows(self):
        inj = FaultInjector(seed=5, drop_rate=0.3)
        engine = _serve(inj.wrap(echo_pipeline()), batch_size=8)
        try:
            dropped, ok = 0, 0
            for i in range(20):
                expect_drop = inj.decide(
                    "drop", json.dumps({"x": i}).encode())
                try:
                    status, body = _post(engine.source.address, {"x": i})
                    assert not expect_drop and body == {"echo": i}
                    ok += 1
                except urllib.error.HTTPError as e:
                    assert expect_drop and e.code == 500
                    dropped += 1
            assert dropped > 0 and ok > 0
            assert inj.injected_drops == dropped
        finally:
            engine.stop()

    def test_injected_latency_slows_the_batch(self):
        inj = FaultInjector(seed=3, latency_s=0.3, latency_rate=1.0)
        engine = _serve(inj.wrap(echo_pipeline()), batch_size=8)
        try:
            t0 = time.perf_counter()
            status, body = _post(engine.source.address, {"x": 1})
            dt = time.perf_counter() - t0
            assert status == 200 and body == {"echo": 1}
            assert dt >= 0.3
            assert inj.injected_latency_rows >= 1
        finally:
            engine.stop()

    @pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_worker_kill_supervisor_restarts_and_recovers(self):
        inj = FaultInjector(seed=1)
        engine = _serve(inj.wrap(echo_pipeline()), batch_size=4)
        try:
            assert _post(engine.source.address, {"x": 0})[1] == {"echo": 0}
            inj.arm_worker_kill(1)
            # this request's worker dies mid-batch; the client times out
            with pytest.raises(Exception):
                _post(engine.source.address, {"x": 1}, timeout=1.0)
            deadline = time.time() + 5
            while engine.workers_restarted == 0 and time.time() < deadline:
                time.sleep(0.05)
            assert engine.workers_restarted >= 1
            assert engine.is_alive()
            assert _post(engine.source.address, {"x": 2})[1] == {"echo": 2}
            assert inj.worker_kills_fired == 1
            # the dead worker's batch gave its version handle back
            assert engine._active.outstanding == 0
        finally:
            engine.stop()

    def test_wrap_raises_chaos_error_for_poisoned_batch(self):
        inj = FaultInjector(seed=13, error_rate=1.0)
        wrapped = inj.wrap(echo_pipeline())
        table = DataTable({
            "id": ["a"],
            "request": [HTTPSchema.request("/", "POST", b'{"x": 1}')]})
        with pytest.raises(ChaosError):
            wrapped.transform(table)


# ---------------------------------------------------------------------------
# the fleet's availability
# ---------------------------------------------------------------------------


class TestFleetAvailability:
    def test_99pct_availability_with_engine_killed_mid_load(self):
        """1 of 3 engines hard-killed mid-load under concurrent clients:
        >=99% of all requests succeed via circuit-breaking failover."""
        fleet = _fleet(echo_pipeline(), n_engines=3, batch_size=8,
                       workers=1, failure_threshold=2,
                       breaker_cooldown=30.0)
        n_clients, per_client = 6, 30
        kill_after = 30
        results = {}
        completed = threading.Event()
        count_lock = threading.Lock()
        done_count = [0]

        def client(cid):
            for j in range(per_client):
                key = cid * per_client + j
                try:
                    body = fleet.post({"x": key}, timeout=5.0)
                    results[key] = (body == {"echo": key})
                except Exception:  # noqa: BLE001 — availability metric
                    results[key] = False
                with count_lock:
                    done_count[0] += 1
                    if done_count[0] >= kill_after:
                        completed.set()

        try:
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(n_clients)]
            for t in threads:
                t.start()
            assert completed.wait(timeout=30)
            FaultInjector.kill_engine(fleet, 1)     # mid-load crash
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        finally:
            fleet.stop_all()
        total = n_clients * per_client
        successes = sum(results.values())
        assert len(results) == total
        assert successes / total >= 0.99, (
            f"availability {successes}/{total} under 1-of-3 engine kill")
        assert fleet.breakers[1].state == CircuitBreaker.OPEN
        assert fleet.counters()["transport_errors"] >= 1

    def test_stalled_engine_bounded_timeout_waits(self):
        """A STALLED engine (accepts, never replies): the circuit opens
        after ``failure_threshold`` timeouts, and no request waits out
        the client timeout against it more than once."""
        client_timeout = 1.0
        fleet = _fleet(echo_pipeline(), n_engines=3, batch_size=8,
                       failure_threshold=2, breaker_cooldown=60.0)
        durations = []
        try:
            for i in range(5):
                assert fleet.post({"x": i})["echo"] == i
            FaultInjector.stall_engine(fleet, 0)
            for i in range(30):
                t0 = time.perf_counter()
                body = fleet.post({"x": 100 + i}, timeout=client_timeout)
                durations.append(time.perf_counter() - t0)
                assert body == {"echo": 100 + i}
        finally:
            fleet.stop_all()
        assert max(durations) < 2 * client_timeout
        slow = [d for d in durations if d > 0.9 * client_timeout]
        assert len(slow) <= 2, (
            f"{len(slow)} requests burned a timeout on the stalled "
            f"engine; circuit should have opened after 2")
        assert fleet.breakers[0].state == CircuitBreaker.OPEN

    def test_shedding_503_retry_after_then_recovery(self):
        """Overfill the bounded parked-request table: extra load is shed
        with 503 + Retry-After, and the engine serves normally once
        drained."""
        gate = threading.Event()

        def gated(table):
            gate.wait(10)
            return table.with_column(
                "reply", [{"ok": 1} for _ in table["request"]])

        fleet = _fleet(Lambda.apply(gated), n_engines=1, batch_size=1,
                       max_parked=3)
        addr = fleet.addresses[0]
        codes, retry_afters = [], []
        lock = threading.Lock()

        def raw_post():
            req = urllib.request.Request(
                addr, data=b'{"x": 0}',
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=15) as r:
                    with lock:
                        codes.append(r.status)
            except urllib.error.HTTPError as e:
                with lock:
                    codes.append(e.code)
                    retry_afters.append(e.headers.get("Retry-After"))

        try:
            threads = [threading.Thread(target=raw_post)
                       for _ in range(10)]
            for t in threads:
                t.start()
            deadline = time.time() + 5
            while time.time() < deadline and \
                    fleet.engines[0].source.requests_rejected == 0:
                time.sleep(0.02)
            gate.set()
            for t in threads:
                t.join(timeout=30)
            shed = [c for c in codes if c == 503]
            served = [c for c in codes if c == 200]
            assert shed, f"expected shedding, got {codes}"
            assert served, f"expected some service, got {codes}"
            assert all(ra is not None and int(ra) >= 1
                       for ra in retry_afters)
            assert fleet.counters()["rejected"] == len(shed)
            status, body = _post(addr, {"x": 1})
            assert status == 200 and body == {"ok": 1}
        finally:
            fleet.stop_all()

    def test_hedged_request_beats_slow_replica(self):
        """When one replica turns slow, a hedge fired after the observed
        latency percentile answers from a fast replica well before the
        slow one would."""
        inj = FaultInjector(seed=9, latency_s=1.5, latency_rate=1.0)
        fleet = _fleet(echo_pipeline(), n_engines=2, batch_size=8,
                       hedge_percentile=95, hedge_min_s=0.05)
        try:
            for i in range(20):
                assert fleet.post({"x": i})["echo"] == i
            fleet.engines[0].pipeline = inj.wrap(echo_pipeline())
            t_slow = []
            for i in range(6):
                t0 = time.perf_counter()
                assert fleet.post({"x": 100 + i}, timeout=10.0)[
                    "echo"] == 100 + i
                t_slow.append(time.perf_counter() - t0)
            assert fleet.hedged_requests >= 1
            assert max(t_slow) < 1.4, t_slow
        finally:
            fleet.stop_all()

    def test_all_engines_down_raises_typed_error(self):
        fleet = _fleet(echo_pipeline(), n_engines=2, batch_size=4,
                       failure_threshold=1, breaker_cooldown=30.0)
        try:
            assert fleet.post({"x": 1})["echo"] == 1
            FaultInjector.kill_engine(fleet, 0)
            FaultInjector.kill_engine(fleet, 1)
            with pytest.raises(ServingUnavailable) as ei:
                fleet.post({"x": 2}, timeout=2.0)
            assert len(ei.value.attempts) >= 1
            assert all("address" in a and "error" in a
                       for a in ei.value.attempts)
            t0 = time.perf_counter()
            with pytest.raises(ServingUnavailable):
                fleet.post({"x": 3}, timeout=2.0)
            assert time.perf_counter() - t0 < 2.0
            assert fleet.counters()["transport_errors"] >= 2
        finally:
            fleet.stop_all()


# ---------------------------------------------------------------------------
# the lifecycle drills
# ---------------------------------------------------------------------------


def _fleet_load(fleet, n_clients, per_client, results, timeout=5.0,
                until=None):
    """Spray the fleet from n_clients threads; record per-request
    (ok, version) into ``results``. Each client sends ``per_client``
    requests, and goes on until ``until`` is set when one is given (a
    swap must not run out of live batches for its canary because fast
    engines answered the whole load first). Returns the started
    threads."""
    def client(cid):
        j = 0
        while j < per_client or (until is not None and not until.is_set()):
            key = cid * 100_000 + j
            try:
                body = fleet.post({"x": key}, timeout=timeout)
                results[key] = (body.get("echo") == key, body.get("v"))
            except Exception:  # noqa: BLE001 — availability metric
                results[key] = (False, None)
            j += 1
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    return threads


class TestRollingSwapChaos:
    """A fleet under load completes a rolling swap with >=99%
    availability and never serves a mixed-version reply batch; a
    poisoned canary auto-rolls-back without breaching the error floor;
    a stalled warmup and an engine killed mid-swap roll back instead of
    wedging the rollout."""

    def test_rolling_swap_under_load_99pct_availability(self):
        fleet = _fleet(echo_pipeline("v1"), n_engines=3, batch_size=8,
                       workers=1, max_wait_ms=2.0, version="v1",
                       failure_threshold=3, breaker_cooldown=30.0)
        n_clients, per_client = 6, 40
        results = {}
        swapped = threading.Event()
        try:
            threads = _fleet_load(fleet, n_clients, per_client, results,
                                  until=swapped)
            time.sleep(0.2)
            report = fleet.rolling_swap(
                echo_pipeline("v2"), "v2",
                policy=CanaryPolicy(fraction=0.5, min_batches=3,
                                    decision_timeout_s=20))
            swapped.set()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert report["ok"], report
            assert report["completed"] == 3
            for e in fleet.engines:
                assert e.model_version == "v2"
                assert e.swap_state == "idle"
            assert fleet.post({"x": -1}) == {"echo": -1, "v": "v2"}
            c = fleet.counters()
            assert c["swaps_completed"] == 3
            assert c["swaps_rolled_back"] == 0
            agg = fleet.metrics()["aggregate"]
            assert agg["model_versions"] == ["v2", "v2", "v2"]
            assert agg["swaps_completed"] == 3
        finally:
            fleet.stop_all()
        total = len(results)
        ok = sum(v[0] for v in results.values())
        assert total >= n_clients * per_client
        assert ok / total >= 0.99, f"availability {ok}/{total}"
        assert {v for _, v in results.values() if v} <= {"v1", "v2"}

    def test_swap_zero_steady_state_recompiles(self):
        """After the incoming model's bucket warmup (inside the swap,
        off the hot path), serving across and beyond the swap meets no
        first-run shape on either model."""
        import torch
        from mmlspark_tpu_torch.models.networks import build_network
        from mmlspark_tpu_torch.models.tpu_model import TPUModel
        from mmlspark_tpu_torch.serving.fleet import json_scoring_pipeline

        x0 = np.zeros((1, 8), np.float32)

        def make_model(seed):
            torch.manual_seed(seed)
            module = build_network({"type": "mlp", "features": [16],
                                    "num_classes": 4, "in_features": 8},
                                   device="cpu")
            return TPUModel.from_module(module, device="cpu",
                                        inputCol="features",
                                        outputCol="scores", batchSize=16)

        m1, m2 = make_model(0), make_model(1)
        m1.warmup({"features": x0})
        fleet = _fleet(json_scoring_pipeline(m1), n_engines=2,
                       batch_size=16, max_wait_ms=2.0)
        payload = {"features": [0.1] * 8}
        results = {}
        try:
            for _ in range(8):
                assert "prediction" in fleet.post(payload)
            misses_v1 = m1.jit_cache_misses

            swapped = threading.Event()

            def client(cid):
                j = 0
                while j < 30 or not swapped.is_set():
                    try:
                        results[(cid, j)] = "prediction" in fleet.post(
                            payload, timeout=10)
                    except Exception:  # noqa: BLE001
                        results[(cid, j)] = False
                    j += 1
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(4)]
            for t in threads:
                t.start()
            report = fleet.rolling_swap(
                json_scoring_pipeline(m2), "v2",
                warmup_example={"features": x0},
                policy=CanaryPolicy(fraction=0.5, min_batches=2,
                                    decision_timeout_s=30))
            swapped.set()
            for t in threads:
                t.join(timeout=60)
            assert report["ok"], report
            misses_v2 = m2.jit_cache_misses
            for _ in range(8):
                assert "prediction" in fleet.post(payload)
            assert m1.jit_cache_misses == misses_v1, \
                "old model met a first-run shape during the swap"
            assert m2.jit_cache_misses == misses_v2, \
                "new model met a first-run shape after its warmup"
            assert misses_v2 > 0    # warmup really ran the buckets
        finally:
            fleet.stop_all()
        ok = sum(results.values())
        assert ok / len(results) >= 0.99

    def test_poisoned_canary_auto_rolls_back_under_error_floor(self):
        fleet = _fleet(echo_pipeline("v1"), n_engines=2, batch_size=8,
                       workers=1, max_wait_ms=2.0, version="v1")
        poisoned = PoisonedModel(echo_pipeline("v2"))
        n_clients, per_client = 4, 40
        results = {}
        swapped = threading.Event()
        try:
            threads = _fleet_load(fleet, n_clients, per_client, results,
                                  until=swapped)
            time.sleep(0.1)
            report = fleet.rolling_swap(
                poisoned, "v2",
                policy=CanaryPolicy(fraction=0.5, min_batches=4,
                                    consecutive_failures=3,
                                    decision_timeout_s=20))
            swapped.set()
            for t in threads:
                t.join(timeout=60)
            assert not report["ok"]
            assert report["rolled_back"] == 1
            assert report["completed"] == 0
            assert poisoned.batches_poisoned >= 1
            for e in fleet.engines:
                assert e.model_version == "v1"
            assert fleet.post({"x": -5}) == {"echo": -5, "v": "v1"}
            assert fleet.counters()["swaps_rolled_back"] == 1
        finally:
            fleet.stop_all()
        total = len(results)
        ok = sum(v[0] for v in results.values())
        assert total >= n_clients * per_client
        assert ok / total >= 0.99, f"error floor breached {ok}/{total}"
        assert {v for _, v in results.values() if v} == {"v1"}

    def test_poisoned_rollback_triggers_the_flight_recorder(self):
        from mmlspark_tpu_torch.core.flightrecorder import FlightRecorder
        rec = FlightRecorder(min_interval_s=0.0, capture_logs=False)
        engine = serve_model(echo_pipeline("v1"), port=0, batch_size=4,
                             version="v1", flight_recorder=rec)
        results = {}
        stop = threading.Event()

        def client():
            i = 0
            while not stop.is_set():
                try:
                    results[i] = _post(engine.source.address, {"x": i})[1]
                except Exception as e:  # noqa: BLE001
                    results[i] = e
                i += 1
        t = threading.Thread(target=client, daemon=True)
        try:
            t.start()
            res = engine.swap(PoisonedModel(echo_pipeline("v2")), "v2",
                              policy=CanaryPolicy(fraction=1.0,
                                                  min_batches=4,
                                                  decision_timeout_s=20))
            stop.set()
            t.join(timeout=10)
            assert res.rolled_back
            deadline = time.monotonic() + 5
            while not rec.bundles and time.monotonic() < deadline:
                time.sleep(0.02)
            reason = rec.bundles[-1]["reason"]
            assert reason.startswith("swap_rollback:v1->v2:breach:")
            events = rec.bundles[-1]["events"]
            assert any(e.get("kind") == "rolled_back"
                       for evs in events.values() for e in evs)
            assert all(r == {"echo": i, "v": "v1"}
                       for i, r in results.items())
        finally:
            stop.set()
            engine.stop()
            rec.close()

    def test_stalled_warmup_rolls_back_without_touching_traffic(self):
        fleet = _fleet(echo_pipeline("v1"), n_engines=2, batch_size=4,
                       version="v1")
        stalled = StalledWarmupModel(echo_pipeline("v2"), stall_s=60.0)
        results = {}
        try:
            threads = _fleet_load(fleet, 2, 20, results)
            t0 = time.perf_counter()
            report = fleet.rolling_swap(
                stalled, "v2",
                policy=CanaryPolicy(warmup_timeout_s=0.5,
                                    decision_timeout_s=5))
            dt = time.perf_counter() - t0
            for t in threads:
                t.join(timeout=30)
            assert not report["ok"]
            assert "warmup_timeout" in report["engines"][0]["reason"]
            assert stalled.warmup_started.is_set()
            assert dt < 10, f"stalled warmup wedged the rollout {dt:.1f}s"
            assert fleet.engines[0].model_version == "v1"
            assert fleet.post({"x": -7})["v"] == "v1"
        finally:
            fleet.stop_all()
        ok = sum(v[0] for v in results.values())
        assert ok / len(results) >= 0.99

    def test_engine_killed_mid_rolling_swap(self):
        """Hard-kill one engine while the rollout is in flight: the dead
        engine's swap resolves (skip or timeout-rollback, not a wedge)
        and the fleet keeps its availability floor via failover."""
        fleet = _fleet(echo_pipeline("v1"), n_engines=3, batch_size=8,
                       workers=1, max_wait_ms=2.0, version="v1",
                       failure_threshold=2, breaker_cooldown=30.0)
        n_clients, per_client = 6, 30
        results = {}
        swapped = threading.Event()
        try:
            threads = _fleet_load(fleet, n_clients, per_client, results,
                                  until=swapped)
            time.sleep(0.2)
            FaultInjector.kill_engine_after(fleet, 1, 0.15)
            t0 = time.perf_counter()
            report = fleet.rolling_swap(
                echo_pipeline("v2"), "v2",
                policy=CanaryPolicy(fraction=0.5, min_batches=3,
                                    decision_timeout_s=2.0),
                pressure_timeout_s=3.0)
            dt = time.perf_counter() - t0
            swapped.set()
            for t in threads:
                t.join(timeout=60)
            assert dt < 30, f"rollout wedged for {dt:.1f}s"
            assert report["completed"] >= 1, report
            outcomes = {e["outcome"] for e in report["engines"]}
            assert outcomes <= {"completed", "rolled_back",
                                "skipped_dead", "error"}
            for entry in report["engines"]:
                if entry["outcome"] == "completed":
                    assert fleet.engines[
                        entry["engine"]].model_version == "v2"
        finally:
            fleet.stop_all()
        total = len(results)
        ok = sum(v[0] for v in results.values())
        assert total >= n_clients * per_client
        assert ok / total >= 0.99, f"availability {ok}/{total}"
        assert {v for _, v in results.values() if v} <= {"v1", "v2"}


class TestAdaptiveBatcherChaos:
    def test_batcher_pipeline_survives_worker_kill_and_engine_kill(self):
        inj = FaultInjector(seed=7)
        fleet = _fleet(inj.wrap(echo_pipeline()), n_engines=2,
                       batch_size=4, workers=1, max_wait_ms=2.0,
                       failure_threshold=3, breaker_cooldown=30.0)
        results = {}
        stop_load = threading.Event()

        def client(cid, n=40):
            for j in range(n):
                key = cid * 1000 + j
                try:
                    body = fleet.post({"x": key}, timeout=5.0)
                    results[key] = (body == {"echo": key})
                except Exception:  # noqa: BLE001 — availability metric
                    results[key] = False
                if stop_load.is_set():
                    break
        try:
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(4)]
            for t in threads:
                t.start()
            # mid-load, by the replies counted rather than by the clock
            # (fast engines can answer all 160 requests in 0.3 s): kill
            # one worker thread, then hard-kill a whole engine
            deadline = time.monotonic() + 30
            while len(results) < 20 and time.monotonic() < deadline:
                time.sleep(0.001)
            inj.arm_worker_kill(1)
            while (inj.worker_kills_fired == 0 or len(results) < 60) \
                    and time.monotonic() < deadline:
                time.sleep(0.001)
            FaultInjector.kill_engine(fleet, 0)
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            survivor_alive = fleet.engines[1].is_alive()
        finally:
            stop_load.set()
            fleet.stop_all()
        total = len(results)
        ok = sum(results.values())
        assert total >= 140
        # the damage budget of test_chaos.py for two fault classes
        assert ok / total >= 0.90, f"availability {ok}/{total}"
        assert inj.worker_kills_fired == 1
        assert survivor_alive
