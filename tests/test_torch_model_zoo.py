"""PyTorch port: the multi-model serving plane's model zoo
(``mmlspark_tpu_torch/serving/zoo.py``) and the engine's continuous
model-routed batcher, against the JAX package, on the CPU.

The non-slow scenarios of ``tests/test_zoo.py`` run over port zoos and
engines (``port=0`` everywhere; ``TestAdmission`` lives in
``tests/test_torch_admission.py``): model-key routing, registry
lookup/list consistency under churn, lazy activation, LRU eviction under
the count / bytes / memory-probe budgets with its four safety rules (no
victim with outstanding batches, parked waiters, a pin, or that is the
sole or MRU resident), the load-failure cooldown, the routed engine's
400 / 404 / 500 / 503 answers, no mixed-model batch under concurrency,
a cold activation that blocks no resident model, the model-churn drill,
the AOT artifact store as the distribution format, and the warmup
example checks. The 256-model floor is ported ``slow``, as in the
reference.

Held against the JAX package, with tolerances stated:
- ``model_key_of``: the same key for the same request (equal);
- a scripted sequence of activations, enforcements, pins, waiters and
  manual evictions through both packages' zoos: the same audit timeline
  of (kind, model, version, reason) and the same ``stats()`` counts
  (equal);
- a small Transformer's flax weights carried into the port by
  ``convert.py``, exported as an AOT artifact in each package and
  activated through each package's zoo: the logits within the LM parity
  tests' f32 tolerance (rtol 1e-4, atol 5e-4), the port's replies equal
  to its own model's argmax.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mmlspark_tpu.serving.zoo import (
    ModelZoo as JModelZoo, model_key_of as jmodel_key_of,
)
from mmlspark_tpu.stages.basic import Lambda as JLambda

from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.core.warmup import (
    check_warmup_example, warn_warmup_example,
)
from mmlspark_tpu_torch.serving import (
    HTTPSource, ModelRegistry, ModelZoo, ServingEngine, ServingFleet,
)
from mmlspark_tpu_torch.serving.fleet import ServingUnavailable
from mmlspark_tpu_torch.serving.zoo import (
    FAILED, LOADING, RESIDENT, UNLOADED, model_key_of,
)
from mmlspark_tpu_torch.stages.basic import Lambda


def _handle(tag, delay=0.0, batch_log=None):
    def handle(table):
        if delay:
            time.sleep(delay)
        if batch_log is not None:
            batch_log.append((tag, len(table)))
        replies = []
        for r in table["request"]:
            row = json.loads(r["entity"].decode()) if r.get("entity") \
                else {}
            replies.append({"served_by": tag, "x": row.get("x")})
        return table.with_column("reply", replies)
    return handle


def echo_stage(tag, delay=0.0, batch_log=None):
    """A tiny serving stage that stamps its model tag into every reply
    (and optionally logs each batch it sees) — the instrument for the
    no-mixed-model and routing assertions."""
    return Lambda.apply(_handle(tag, delay, batch_log))


def fresh_zoo(n_models=4, max_resident=None, delay=0.0,
              batch_log=None, **kw):
    kw.setdefault("memory_probe", None)
    zoo = ModelZoo(max_resident=max_resident, **kw)
    for i in range(n_models):
        zoo.register_factory(
            f"m{i}", "v1",
            (lambda i=i: echo_stage(f"m{i}", delay=delay,
                                    batch_log=batch_log)))
    return zoo


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


@pytest.fixture
def jax_registry_kept():
    """The JAX package's stage registry as it was: its load_model
    registers the AOTTPUModel class it builds, which the reference's own
    codegen tests would then list (and fail to import) in this worker."""
    from mmlspark_tpu.core.stage import STAGE_REGISTRY
    before = dict(STAGE_REGISTRY)
    yield
    STAGE_REGISTRY.clear()
    STAGE_REGISTRY.update(before)


# ---------------------------------------------------------------------------
# request routing keys
# ---------------------------------------------------------------------------

_KEY_CASES = {
    "header_case_insensitive": ({"requestLine": {"uri": "/"},
                                 "headers": {"x-MoDeL": "m@v3"}}, "m@v3"),
    "url_path": ({"requestLine": {"uri": "/models/scorer@v2"},
                  "headers": {}}, "scorer@v2"),
    "url_path_urlencoded": ({"requestLine": {"uri": "/models/scorer%40v2"},
                             "headers": {}}, "scorer@v2"),
    "query_param": ({"requestLine": {"uri": "/?model=m1"}, "headers": {}},
                    "m1"),
    "header_wins_over_path": ({"requestLine": {"uri": "/models/b@v1"},
                               "headers": {"X-Model": "a@v1"}}, "a@v1"),
    "unkeyed": ({"requestLine": {"uri": "/"}, "headers": {}}, None),
}


class TestModelKeyOf:
    @pytest.mark.parametrize("case", sorted(_KEY_CASES))
    def test_model_key_of(self, case):
        req, want = _KEY_CASES[case]
        assert model_key_of(req) == want
        # the JAX package routes the same request to the same key
        assert jmodel_key_of(req) == want
        if case == "unkeyed":
            assert model_key_of(None) is None


# ---------------------------------------------------------------------------
# registry lookup/list consistency
# ---------------------------------------------------------------------------


class TestRegistryConsistency:
    def test_lookup_triple_and_list(self):
        reg = ModelRegistry()
        reg.register("v1", echo_stage("a"), metadata={"note": "n"})
        obj, state, meta = reg.lookup("v1")
        assert obj is not None and state == "registered"
        assert meta["note"] == "n" and meta["precision"] == "f32"
        rows = reg.list()
        assert rows[0]["version"] == "v1" and rows[0]["loaded"]
        with pytest.raises(KeyError):
            reg.lookup("nope")

    def test_base_registry_hammer(self):
        """lookup/list racing register must always see complete
        entries (metadata carries the auto precision/aot keys the
        moment the version is visible at all)."""
        reg = ModelRegistry()
        stop = threading.Event()
        errors = []

        def writer():
            for i in range(200):
                reg.register(f"v{i}", echo_stage(f"v{i}"))
            stop.set()

        def reader():
            while not stop.is_set():
                for row in reg.list():
                    if "precision" not in row["metadata"]:
                        errors.append(f"torn metadata: {row}")
                for v in reg.versions():
                    obj, state, meta = reg.lookup(v)
                    if obj is None or state != "registered" \
                            or "precision" not in meta:
                        errors.append(f"torn lookup: {v}")

        threads = [threading.Thread(target=reader) for _ in range(3)]
        threads.append(threading.Thread(target=writer))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors, errors[:3]
        assert len(reg.versions()) == 200

    def test_zoo_lookup_hammer_under_churn(self):
        """The zoo's (handle, state, metadata) triples stay consistent
        while models churn through load/evict: RESIDENT always comes
        with a live handle, every other state with none."""
        zoo = fresh_zoo(n_models=6, max_resident=2)
        stop = threading.Event()
        errors = []

        def churn():
            for i in range(60):
                zoo.get(f"m{i % 6}", timeout=30)
            stop.set()

        def reader():
            while not stop.is_set():
                for i in range(6):
                    handle, state, meta = zoo.lookup(f"m{i}@v1")
                    if state == RESIDENT:
                        if handle is None or handle.pipeline is None:
                            errors.append(f"resident without handle m{i}")
                    elif handle is not None:
                        errors.append(f"{state} with handle m{i}")
                for row in zoo.list():
                    if row["loaded"] != (row["state"] == RESIDENT):
                        errors.append(f"torn list row: {row}")

        threads = [threading.Thread(target=reader) for _ in range(3)]
        threads.append(threading.Thread(target=churn))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        try:
            assert not errors, errors[:3]
            assert zoo.evictions > 0          # churn actually churned
            assert zoo.evictions_with_outstanding == 0
        finally:
            zoo.close()


# ---------------------------------------------------------------------------
# the zoo cache itself
# ---------------------------------------------------------------------------


class TestModelZoo:
    def test_lazy_load_states_and_audit(self):
        zoo = fresh_zoo(n_models=2)
        try:
            assert zoo.lookup("m0@v1")[1] == UNLOADED
            stage = zoo.get("m0")
            assert stage is not None
            assert zoo.lookup("m0@v1")[1] == RESIDENT
            kinds = [e.kind for e in zoo.events]
            assert kinds.count("register") == 2
            assert kinds.count("activate") == 1
            ev = [e for e in zoo.events if e.kind == "activate"][0]
            assert ev.model == "m0" and "ms" in ev.stats
        finally:
            zoo.close()

    def test_unknown_and_bare_name_latest(self):
        zoo = fresh_zoo(n_models=1)
        zoo.register_factory("m0", "v2", lambda: echo_stage("m0v2"))
        try:
            assert zoo.resolve("m0") == "m0@v2"     # latest wins
            assert zoo.resolve("m0@v1") == "m0@v1"
            assert zoo.resolve("nope") is None
            with pytest.raises(KeyError):
                zoo.get("nope")
        finally:
            zoo.close()

    def test_lru_eviction_count_cap(self):
        zoo = fresh_zoo(n_models=4, max_resident=2)
        try:
            for i in range(3):
                zoo.get(f"m{i}")
            zoo.enforce()
            # m0 is the LRU victim; m1/m2 stay
            assert zoo.lookup("m0@v1")[1] == UNLOADED
            assert zoo.lookup("m1@v1")[1] == RESIDENT
            assert zoo.lookup("m2@v1")[1] == RESIDENT
            evs = [e for e in zoo.events if e.kind == "evict"]
            assert len(evs) == 1 and evs[0].model == "m0"
            assert evs[0].reason == "lru:count_cap"
            # an evicted model reloads on demand
            assert zoo.get("m0") is not None
            assert zoo.lookup("m0@v1")[1] == RESIDENT
        finally:
            zoo.close()

    def test_bytes_cap_eviction(self):
        zoo = ModelZoo(max_resident_bytes=250, memory_probe=None)
        for i in range(3):
            zoo.register_factory(f"m{i}", "v1",
                                 (lambda i=i: echo_stage(f"m{i}")),
                                 metadata={"cost_bytes": 100})
        try:
            zoo.get("m0"), zoo.get("m1")
            assert zoo.stats()["resident_bytes"] == 200
            zoo.get("m2")                     # 300 > 250: LRU evicts
            zoo.enforce()
            assert zoo.lookup("m0@v1")[1] == UNLOADED
            assert zoo.stats()["resident_bytes"] == 200
        finally:
            zoo.close()

    def test_memory_pressure_probe_eviction(self):
        pressure = {"on": False}

        def probe():
            if pressure["on"]:
                return {"bytes_in_use": 95, "bytes_limit": 100}
            return {"bytes_in_use": 10, "bytes_limit": 100}

        zoo = ModelZoo(memory_probe=probe, memory_headroom=0.9)
        for i in range(3):
            zoo.register_factory(f"m{i}", "v1",
                                 (lambda i=i: echo_stage(f"m{i}")))
        try:
            for i in range(3):
                zoo.get(f"m{i}")
            zoo.enforce()
            assert zoo.stats()["by_state"][RESIDENT] == 3   # no pressure
            pressure["on"] = True
            zoo.enforce()
            # sheds down to (but never below) ONE resident model
            assert zoo.stats()["by_state"][RESIDENT] == 1
            assert zoo.lookup("m2@v1")[1] == RESIDENT       # MRU kept
            reasons = {e.reason for e in zoo.events
                       if e.kind == "evict"}
            assert reasons == {"lru:memory_pressure"}
        finally:
            zoo.close()

    def test_eviction_never_hits_outstanding(self):
        zoo = fresh_zoo(n_models=2, max_resident=1)
        try:
            zoo.get("m0")
            handle, state, _ = zoo.acquire("m0")   # a batch in flight
            assert state == RESIDENT
            zoo.get("m1")                          # over the cap
            zoo.enforce()
            # m0 (LRU) has an outstanding batch and m1 is the MRU:
            # nothing is evictable
            assert zoo.lookup("m0@v1")[1] == RESIDENT
            handle.release()
            zoo.enforce()
            assert zoo.lookup("m0@v1")[1] == UNLOADED
            assert zoo.evictions_with_outstanding == 0
        finally:
            zoo.close()

    def test_eviction_never_hits_awaited_model(self):
        # a model with requests parked AWAITING its activation must not
        # be the LRU victim the instant it activates (the demand >
        # capacity load/evict livelock)
        zoo = fresh_zoo(n_models=3, max_resident=1)
        try:
            zoo.add_waiter("m0")   # a batcher parks BEFORE activation
            zoo.get("m0")
            zoo.get("m1")          # 2 residents > cap; m1's post-load
            zoo.enforce()          # enforce must spare awaited m0
            assert zoo.lookup("m0@v1")[1] == RESIDENT
            assert not zoo.evict("m0")     # manual evict refuses too
            zoo.remove_waiter("m0")
            zoo.enforce()
            assert zoo.lookup("m0@v1")[1] == UNLOADED
            assert zoo.evictions_with_outstanding == 0
        finally:
            zoo.close()

    def test_pin_exempts_from_eviction(self):
        zoo = fresh_zoo(n_models=3, max_resident=1)
        try:
            zoo.get("m0")
            zoo.pin("m0")
            zoo.get("m1")
            zoo.get("m2")
            zoo.enforce()
            assert zoo.lookup("m0@v1")[1] == RESIDENT
            assert not zoo.evict("m0")    # manual evict refuses too
            zoo.pin("m0", pinned=False)
            assert zoo.evict("m0")
        finally:
            zoo.close()

    def test_memory_probe_none_disables_live_signal(self):
        # memory_probe=None must mean the live signal is OFF, not the
        # default probe
        zoo = ModelZoo(memory_probe=None)
        try:
            assert zoo.memory_probe is None
        finally:
            zoo.close()
        zoo2 = ModelZoo()          # default: the live probe is wired
        try:
            from mmlspark_tpu_torch.utils.profiling import \
                mesh_memory_stats
            assert zoo2.memory_probe is mesh_memory_stats
            # no CUDA context on the CPU: no sample, no pressure
            assert zoo2.memory_probe() is None
        finally:
            zoo2.close()

    def test_event_log_bounded_under_churn(self):
        zoo = fresh_zoo(n_models=2, max_resident=1)
        zoo.events_cap = 16
        try:
            for _ in range(30):
                zoo.get("m0")
                zoo.enforce()
                zoo.get("m1")
                zoo.enforce()
            assert len(zoo.events) <= 16
            assert zoo.events[-1].kind in ("activate", "evict")
        finally:
            zoo.close()

    def test_scan_orders_versions_naturally(self, tmp_path):
        # lexicographic os.listdir order would register v9 AFTER v12,
        # so bare-name latest would serve v9
        for v in ("v1", "v9", "v10", "v12"):
            d = tmp_path / "m" / v
            d.mkdir(parents=True)
            (d / "manifest.json").write_text(
                '{"kind": "model", "precision": "f32", "buckets": [8]}')
        zoo = ModelZoo(artifact_root=str(tmp_path), memory_probe=None,
                       device="cpu")
        try:
            assert zoo.resolve("m") == "m@v12"
        finally:
            zoo.close()

    def test_lost_load_requeued_by_watchdog(self):
        # an entry stuck LOADING (a queued load lost) recovers: the
        # watchdog in acquire requeues overdue loads
        zoo = fresh_zoo(n_models=1)
        try:
            with zoo._lock:
                e = zoo._entries["m0@v1"]
                e.state = LOADING          # simulate the lost load
                e.loading_since = time.monotonic() - 999
            assert zoo.get("m0", timeout=10) is not None
        finally:
            zoo.close()

    def test_single_oversized_model_never_self_evicts(self):
        zoo = ModelZoo(max_resident_bytes=100, memory_probe=None)
        zoo.register_factory("big", "v1", lambda: echo_stage("big"),
                             metadata={"cost_bytes": 500})
        try:
            assert zoo.get("big", timeout=10) is not None
            for _ in range(3):
                zoo.enforce()
            assert zoo.lookup("big@v1")[1] == RESIDENT
            assert zoo.evictions == 0
            assert zoo.activations == 1
        finally:
            zoo.close()

    def test_load_failure_cooldown_and_retry(self):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("weights corrupt")
            return echo_stage("ok")

        zoo = ModelZoo(memory_probe=None, failure_cooldown_s=0.1)
        zoo.register_factory("m", "v1", flaky)
        try:
            with pytest.raises(RuntimeError, match="weights corrupt"):
                zoo.get("m", timeout=10)
            assert zoo.lookup("m@v1")[1] == FAILED
            assert zoo.load_failures == 1
            assert [e.kind for e in zoo.events].count("load_failed") == 1
            time.sleep(0.15)                  # cooldown over: retried
            assert zoo.get("m", timeout=10) is not None
            assert zoo.lookup("m@v1")[1] == RESIDENT
        finally:
            zoo.close()

    def test_unload_hook_runs_on_eviction(self):
        """An evicted stage's ``unload`` runs (after the registry lock is
        released); its ``resident_bytes`` is the measured cost."""
        unloaded = []

        def factory(tag):
            stage = echo_stage(tag)
            stage.resident_bytes = lambda: 4096
            stage.unload = lambda: unloaded.append(tag)
            return stage

        zoo = ModelZoo(max_resident=1, memory_probe=None, device="cpu")
        for tag in ("a", "b"):
            zoo.register_factory(tag, "v1", lambda tag=tag: factory(tag))
        try:
            zoo.get("a")
            st = zoo.entry_status("a")
            assert st["cost_bytes"] == 4096
            assert st["cost_source"] == "device"
            zoo.get("b")
            zoo.enforce()
            assert unloaded == ["a"]
            assert zoo.stats()["resident_bytes"] == 4096
        finally:
            zoo.close()


# ---------------------------------------------------------------------------
# the same scripted churn through both packages' zoos
# ---------------------------------------------------------------------------


def _script(zoo_cls, lam, probe_state, **kw):
    """One scripted sequence of activations, enforcements, a pin, a
    waiter and manual evictions; returns the audit timeline and the
    stats counts."""
    def probe():
        return ({"bytes_in_use": 95, "bytes_limit": 100}
                if probe_state["on"] else
                {"bytes_in_use": 10, "bytes_limit": 100})

    zoo = zoo_cls(memory_probe=probe, memory_headroom=0.9, **kw)
    for i in range(5):
        zoo.register_factory(f"m{i}", "v1",
                             (lambda i=i: lam(_handle(f"m{i}"))),
                             metadata={"cost_bytes": 100})
    zoo.register_factory("m0", "v2", lambda: lam(_handle("m0v2")),
                         metadata={"cost_bytes": 100})
    try:
        probe_state["on"] = False
        # activations (and each one's post-load enforce) run in order on
        # the loader thread; close() joins it, so every later eviction
        # is this thread's and the timeline's order is fixed
        for spec in ("m0@v1", "m1", "m2", "m3", "m0"):
            zoo.get(spec, timeout=10)
        zoo.close()
        zoo.pin("m2")
        zoo.add_waiter("m3")
        probe_state["on"] = True
        zoo.enforce()
        zoo.remove_waiter("m3")
        zoo.enforce()
        refused = zoo.evict("m2")
        zoo.pin("m2", pinned=False)
        took = zoo.evict("m2")
        timeline = [(e.kind, e.model, e.version, e.reason)
                    for e in zoo.events]
        st = zoo.stats()
        counts = {k: st[k] for k in ("registered", "by_state",
                                     "resident_bytes", "activations",
                                     "evictions", "load_failures",
                                     "evictions_with_outstanding")}
        return timeline, counts, (refused, took)
    finally:
        zoo.close()


@pytest.mark.parametrize("budget", [{"max_resident": 3},
                                    {"max_resident_bytes": 350}],
                         ids=["count_cap", "bytes_cap"])
def test_zoo_timeline_matches_the_jax_package(budget):
    got = _script(ModelZoo, Lambda.apply, {"on": False}, device="cpu",
                  **budget)
    want = _script(JModelZoo, JLambda.apply, {"on": False}, **budget)
    assert got == want
    timeline = got[0]
    assert ("evict", "m3", "v1", "lru:memory_pressure") in timeline
    assert got[2] == (False, True)


# ---------------------------------------------------------------------------
# the model-routed engine
# ---------------------------------------------------------------------------


@pytest.fixture
def zoo_engine():
    zoo = fresh_zoo(n_models=4)
    source = HTTPSource(port=0)
    engine = ServingEngine(source, zoo=zoo, batch_size=8,
                           max_wait_ms=2.0, tracing=False).start()
    yield engine, zoo, source.address
    engine.stop()
    zoo.close()


class TestZooEngine:
    def test_routes_by_header_and_path(self, zoo_engine):
        engine, zoo, addr = zoo_engine
        code, body, headers = post(addr, {"x": 1}, {"X-Model": "m1"})
        assert code == 200 and body["served_by"] == "m1"
        assert headers.get("X-Model") == "m1@v1"
        code, body, headers = post(addr, {"x": 2}, path="/models/m2@v1")
        assert code == 200 and body["served_by"] == "m2"
        assert headers.get("X-Model") == "m2@v1"

    def test_unkeyed_400_unknown_404(self, zoo_engine):
        engine, zoo, addr = zoo_engine
        code, body, _ = post(addr, {"x": 1})
        assert code == 400 and "no model specified" in body["error"]
        code, body, _ = post(addr, {"x": 1}, {"X-Model": "ghost"})
        assert code == 404 and "unknown model" in body["error"]
        with engine._stats_lock:
            rej = dict(engine.rejections)
        assert rej == {"no_model": 1, "unknown_model": 1}
        text = engine.metrics_text()
        assert 'serving_admission_rejected_total{reason="no_model"} 1' \
            in text
        assert "serving_zoo_registered_models 4" in text

    def test_zoo_fault_rejects_group_alone(self, zoo_engine):
        # a zoo fault while acquiring ONE model's handle 500s that group
        # alone — other models keep serving, the batcher survives
        engine, zoo, addr = zoo_engine
        real = zoo.acquire

        def flaky(spec):
            if spec.startswith("m3"):
                raise RuntimeError("loader thread spawn failed")
            return real(spec)

        zoo.acquire = flaky
        try:
            code, body, _ = post(addr, {"x": 1}, {"X-Model": "m3"})
            assert code == 500 and "routing error" in body["error"]
            code, body, _ = post(addr, {"x": 2}, {"X-Model": "m1"})
            assert code == 200 and body["served_by"] == "m1"
            with engine._stats_lock:
                assert engine.rejections.get("routing_error") == 1
        finally:
            zoo.acquire = real

    def test_default_pipeline_serves_unkeyed(self):
        zoo = fresh_zoo(n_models=1)
        source = HTTPSource(port=0)
        engine = ServingEngine(source, echo_stage("default"), zoo=zoo,
                               tracing=False).start()
        try:
            code, body, headers = post(source.address, {"x": 1})
            assert code == 200 and body["served_by"] == "default"
            assert "X-Model" not in headers    # default path: no label
            code, body, _ = post(source.address, {"x": 1},
                                 {"X-Model": "m0"})
            assert code == 200 and body["served_by"] == "m0"
        finally:
            engine.stop()
            zoo.close()

    def test_no_mixed_model_batches_under_concurrency(self):
        batch_log = []
        zoo = fresh_zoo(n_models=4, batch_log=batch_log, delay=0.002)
        source = HTTPSource(port=0)
        engine = ServingEngine(source, zoo=zoo, batch_size=8,
                               max_wait_ms=4.0, workers=2,
                               tracing=False).start()
        results = []
        lock = threading.Lock()

        def client(tid):
            for i in range(10):
                model = f"m{(tid + i) % 4}"
                code, body, headers = post(source.address, {"x": i},
                                           {"X-Model": model})
                with lock:
                    results.append((model, code, body, headers))

        try:
            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert len(results) == 80
            for model, code, body, headers in results:
                assert code == 200
                # every reply's model/version matches its request, body
                # AND header
                assert body["served_by"] == model
                assert headers.get("X-Model") == f"{model}@v1"
            # batches really batched (not all 1-row) yet never mixed
            assert all(tag in (f"m{i}" for i in range(4))
                       for tag, _n in batch_log)
            assert any(n > 1 for _tag, n in batch_log)
        finally:
            engine.stop()
            zoo.close()

    def test_cold_activation_does_not_block_resident_models(self):
        zoo = ModelZoo(memory_probe=None)
        zoo.register_factory("fast", "v1", lambda: echo_stage("fast"))
        zoo.register_factory(
            "cold", "v1",
            lambda: (time.sleep(0.8), echo_stage("cold"))[1])
        source = HTTPSource(port=0)
        engine = ServingEngine(source, zoo=zoo, max_wait_ms=2.0,
                               tracing=False).start()
        try:
            assert post(source.address, {"x": 0},
                        {"X-Model": "fast"})[0] == 200
            cold_result = {}

            def cold_client():
                cold_result["r"] = post(source.address, {"x": 1},
                                        {"X-Model": "cold"},
                                        timeout=30)

            t = threading.Thread(target=cold_client)
            t.start()
            time.sleep(0.05)          # the cold activation is in flight
            lat = []
            for i in range(5):
                t0 = time.perf_counter()
                code, body, _ = post(source.address, {"x": i},
                                     {"X-Model": "fast"})
                lat.append(time.perf_counter() - t0)
                assert code == 200 and body["served_by"] == "fast"
            # resident traffic never waits behind the 0.8 s activation
            assert max(lat) < 0.5, lat
            t.join(timeout=30)
            code, body, _ = cold_result["r"]
            assert code == 200 and body["served_by"] == "cold"
        finally:
            engine.stop()
            zoo.close()

    def test_activation_timeout_sheds_503(self):
        zoo = ModelZoo(memory_probe=None)
        zoo.register_factory(
            "slow", "v1",
            lambda: (time.sleep(1.5), echo_stage("slow"))[1])
        source = HTTPSource(port=0)
        engine = ServingEngine(source, zoo=zoo, max_wait_ms=2.0,
                               activation_timeout_s=0.2,
                               tracing=False).start()
        try:
            code, body, headers = post(source.address, {"x": 1},
                                       {"X-Model": "slow"}, timeout=30)
            assert code == 503 and "activating" in body["error"]
            assert headers.get("Retry-After")
            # the activation itself completes in the background; a later
            # request is served
            zoo.get("slow", timeout=30)
            code, body, _ = post(source.address, {"x": 2},
                                 {"X-Model": "slow"})
            assert code == 200 and body["served_by"] == "slow"
        finally:
            engine.stop()
            zoo.close()

    def test_zoo_events_and_slo_alerts_share_the_timeline(self):
        """The engine wires its SLO monitor's ``record_event`` onto the
        zoo's timeline (and unwires it at stop); per-model SLO streams
        take the served batches."""
        from mmlspark_tpu_torch.core.slo import SLOMonitor
        zoo = fresh_zoo(n_models=2)
        mon = SLOMonitor()
        source = HTTPSource(port=0)
        engine = ServingEngine(source, zoo=zoo, slo=mon,
                               tracing=False, flight_recorder=False
                               ).start()
        try:
            assert mon.record_event == zoo.record_event
            for model in ("m0", "m1", "m0"):
                assert post(source.address, {"x": 1},
                            {"X-Model": model})[0] == 200
            assert mon.requests(60.0, model="m0@v1") >= 1
            assert mon.requests(60.0, model="m1@v1") >= 1
            assert "zoo" in engine.metrics()
        finally:
            engine.stop()
            zoo.close()
        assert mon.record_event is None


# ---------------------------------------------------------------------------
# the chaos drill: model churn under mixed-tenant load
# ---------------------------------------------------------------------------


class TestZooChurnDrill:
    def test_churn_mixed_tenants_availability_and_no_mixing(self):
        """Models churn in and out (cache 3 of 12) under mixed-tenant
        concurrent load: availability >= 99 %, every reply's model
        matches its request, and no eviction ever hits a model with
        outstanding batches."""
        zoo = fresh_zoo(n_models=12, max_resident=3, delay=0.001)
        fleet = ServingFleet(n_engines=2, base_port=0, zoo=zoo,
                             batch_size=8, max_wait_ms=2.0,
                             tracing=False)
        results = []
        lock = threading.Lock()
        rng = np.random.default_rng(7)
        picks = rng.integers(0, 12, size=240)

        def client(tid):
            tenant = "alpha" if tid % 2 == 0 else "beta"
            for i in range(30):
                model = f"m{picks[tid * 30 + i]}"
                try:
                    body = fleet.post({"x": i}, model=model,
                                      tenant=tenant, timeout=60)
                    with lock:
                        results.append((model, 200, body))
                except urllib.error.HTTPError as e:
                    with lock:
                        results.append((model, e.code, None))
                except ServingUnavailable:
                    with lock:
                        results.append((model, 503, None))

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(8)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert len(results) == 240
            ok = [r for r in results if r[1] == 200]
            availability = len(ok) / len(results)
            assert availability >= 0.99, (
                f"availability {availability:.3f}; "
                f"failures {[r for r in results if r[1] != 200][:5]}")
            for model, _code, body in ok:
                assert body["served_by"] == model, (model, body)
            assert zoo.evictions > 0
            assert zoo.evictions_with_outstanding == 0
            # the cache may briefly overshoot the cap while waiter /
            # outstanding protection covers just-activated models; once
            # traffic stops, enforce converges it back under the cap
            for _ in range(20):
                zoo.enforce()
                if zoo.stats()["by_state"].get(RESIDENT, 0) <= 3:
                    break
                time.sleep(0.05)
            assert zoo.stats()["by_state"].get(RESIDENT, 0) <= 3
        finally:
            fleet.stop_all()
            zoo.close()


# ---------------------------------------------------------------------------
# the AOT artifact store as the distribution format
# ---------------------------------------------------------------------------


class TestZooAOTArtifacts:
    def test_artifact_scan_activate_serve(self, tmp_path):
        """An AOT artifact directory (serving/aot.py) is the zoo's
        distribution format: scan() discovers it, the first request
        activates it through the AOT load path (no first-run shape at
        request time), the activation lands in the audit event, and the
        measured residency replaces the file-size estimate."""
        from mmlspark_tpu_torch.models.networks import build_network
        from mmlspark_tpu_torch.models.tpu_model import TPUModel
        from mmlspark_tpu_torch.serving.aot import export_model

        module = build_network({"type": "mlp", "features": [8],
                                "num_classes": 3, "in_features": 4},
                               device="cpu", seed=0)
        model = TPUModel.from_module(module, device="cpu",
                                     inputCol="features",
                                     outputCol="scores", batchSize=8)
        x0 = np.zeros((1, 4), np.float32)
        art_dir = tmp_path / "scorer" / "v1"
        export_model(model, {"features": x0}, str(art_dir), version="v1")

        zoo = ModelZoo(artifact_root=str(tmp_path), memory_probe=None,
                       device="cpu")
        try:
            assert zoo.resolve("scorer") == "scorer@v1"
            _handle_, state, meta = zoo.lookup("scorer@v1")
            assert state == UNLOADED and meta["aot"] is True
            assert meta["buckets"] == [8]
            assert zoo.stats()["models"][0]["cost_bytes"] > 0

            source = HTTPSource(port=0)
            engine = ServingEngine(source, zoo=zoo,
                                   tracing=False).start()
            try:
                code, body, headers = post(
                    source.address, {"features": [0.5, 0.1, 0.2, 0.9]},
                    {"X-Model": "scorer"}, timeout=120)
                assert code == 200 and "prediction" in body
                assert headers.get("X-Model") == "scorer@v1"
                acts = [e for e in zoo.events if e.kind == "activate"]
                assert len(acts) == 1 and acts[0].stats["aot"] is True
                assert acts[0].stats["ms"] > 0
                assert acts[0].stats["cost_source"] == "device"
                weights = sum(t.numel() * t.element_size()
                              for t in model.get("weights").values())
                assert zoo.entry_status("scorer")["cost_bytes"] == weights
                # steady state: more requests, no new first-run shape
                loaded = zoo.get("scorer")
                misses0 = loaded.jit_cache_miss_count()
                for i in range(4):
                    code, _b, _h = post(
                        source.address,
                        {"features": [0.1 * i] * 4},
                        {"X-Model": "scorer@v1"})
                    assert code == 200
                assert loaded.jit_cache_miss_count() == misses0
                # eviction drops the loaded model's weights and programs
                assert zoo.evict("scorer")
                assert loaded.model._aot_programs == {}
                assert loaded.model.resident_bytes() == 0
            finally:
                engine.stop()
        finally:
            zoo.close()

    def test_transformer_through_both_packages_zoos(self, tmp_path,
                                                    jax_registry_kept):
        """A small Transformer's flax weights carried into the port by
        convert.py; each package exports its own artifact and activates
        it through its own zoo: the logits agree within the LM parity
        tests' f32 tolerance, and the port's served replies are its
        activated model's argmax."""
        from mmlspark_tpu.core.table import DataTable as JTable
        from mmlspark_tpu.models.networks import build_network as jbuild
        from mmlspark_tpu.models.tpu_model import TPUModel as JTPUModel
        from mmlspark_tpu.serving import aot as jaot
        from mmlspark_tpu_torch import convert
        from mmlspark_tpu_torch.models.tpu_model import TPUModel
        from mmlspark_tpu_torch.serving import aot

        spec = {"type": "transformer", "vocab_size": 64, "dim": 32,
                "depth": 2, "heads": 4, "max_len": 512,
                "head_dtype": "float32"}
        toks = np.random.default_rng(5).integers(
            0, spec["vocab_size"], size=(6, 512)).astype(np.int32)
        variables = jbuild(spec).init(jax.random.key(1),
                                      jnp.asarray(toks[:1]))
        variables = jax.tree_util.tree_map(np.asarray, variables)
        jm = JTPUModel.from_flax(jbuild(spec), variables,
                                 inputCol="tokens", outputCol="logits",
                                 batchSize=8)
        jaot.export_model(jm, {"tokens": toks[:1]},
                          str(tmp_path / "jax" / "lm" / "v1"))
        pm = TPUModel.from_module(
            convert.module_from_flax(spec, variables, device="cpu"),
            device="cpu", inputCol="tokens", outputCol="logits",
            batchSize=8)
        aot.export_model(pm, {"tokens": toks[:1]},
                         str(tmp_path / "port" / "lm" / "v1"))

        jzoo = JModelZoo(artifact_root=str(tmp_path / "jax"),
                         memory_probe=None)
        zoo = ModelZoo(artifact_root=str(tmp_path / "port"),
                       memory_probe=None, device="cpu")
        try:
            want = np.asarray(jzoo.get("lm").model.transform(
                JTable({"tokens": toks}))["logits"])
            stage = zoo.get("lm")
            got = np.asarray(stage.model.transform(
                DataTable({"tokens": toks}))["logits"])
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-4)
            source = HTTPSource(port=0)
            engine = ServingEngine(source, zoo=zoo, tracing=False).start()
            try:
                for i in range(2):
                    code, body, headers = post(
                        source.address, {"tokens": toks[i].tolist()},
                        {"X-Model": "lm"}, timeout=120)
                    assert code == 200 and headers["X-Model"] == "lm@v1"
                    one = stage.model.transform(
                        DataTable({"tokens": toks[i:i + 1]}))["logits"]
                    assert body["prediction"] == one[0].argmax(-1).tolist()
            finally:
                engine.stop()
        finally:
            zoo.close()
            jzoo.close()


# ---------------------------------------------------------------------------
# warmup-example validation
# ---------------------------------------------------------------------------


class _DummyWarmupModel:
    """Pure-host stand-in exposing the warmup_transform contract."""

    jit_cache_misses = 0

    def bucket_sizes(self):
        return [4]

    def transform(self, table):
        return table


class TestWarmupExampleValidation:
    def test_all_none_column_flagged(self):
        table = DataTable({"a": [None], "b": [1.5]})
        msgs = check_warmup_example(table)
        assert len(msgs) == 1 and "'a'" in msgs[0]
        assert "OBJECT" in msgs[0] and "nan" in msgs[0].lower()

    def test_mixed_none_is_fine(self):
        # None mixed with real values infers the value dtype — only
        # ALL-None columns poison the warmed schema
        table = DataTable({"a": [None, 1.5], "b": ["x", None]})
        assert check_warmup_example(table) == []

    def test_live_column_mismatch_flagged(self):
        table = DataTable({"a": [1.0], "zz": [2.0]})
        msgs = check_warmup_example(table, live_columns=["a", "b"])
        assert len(msgs) == 2
        assert any("missing live request column(s) ['b']" in m
                   for m in msgs)
        assert any("['zz'] never seen" in m for m in msgs)

    def test_clean_example_silent(self):
        import warnings as W
        table = DataTable({"a": [1.0], "b": ["s"]})
        with W.catch_warnings():
            W.simplefilter("error")
            assert warn_warmup_example(
                table, live_columns=["a", "b"]) == []

    def test_warmup_transform_warns_at_warmup_time(self):
        from mmlspark_tpu_torch.core.warmup import warmup_transform
        with pytest.warns(RuntimeWarning, match="all-None"):
            warmup_transform(_DummyWarmupModel(),
                             {"a": [None], "b": [1.0]})


# ---------------------------------------------------------------------------
# the scale floor (slow, as in the reference)
# ---------------------------------------------------------------------------


@pytest.mark.slow
class TestZooFloor:
    def test_256_models_one_fleet_bounded_p99(self):
        """>= 256 distinct versioned models behind one fleet under mixed
        traffic: availability >= 99 %, bounded p99, evictions under a
        64-model cache with zero availability loss, no first-run shape
        on a resident TPUModel in steady state."""
        from mmlspark_tpu_torch.models.networks import build_network
        from mmlspark_tpu_torch.models.tpu_model import TPUModel
        from mmlspark_tpu_torch.serving.fleet import json_scoring_pipeline

        zoo = ModelZoo(max_resident=64, memory_probe=None,
                       label_cardinality_cap=64, device="cpu")
        n_models = 256
        for i in range(n_models):
            zoo.register_factory(f"m{i:03d}", f"v{i % 4}",
                                 (lambda i=i: echo_stage(f"m{i:03d}")))
        model = TPUModel.from_module(
            build_network({"type": "mlp", "features": [16],
                           "num_classes": 4, "in_features": 8},
                          device="cpu", seed=0),
            device="cpu", inputCol="features", outputCol="scores",
            batchSize=8)
        x0 = np.zeros((1, 8), np.float32)
        zoo.register_factory(
            "model", "v1", lambda: json_scoring_pipeline(model),
            metadata={"warmup_example": {"features": x0}})
        zoo.pin("model")       # resident model: no first run in traffic
        zoo.get("model", timeout=120)
        misses_warm = int(model.jit_cache_misses)

        fleet = ServingFleet(n_engines=2, base_port=0, zoo=zoo,
                             batch_size=8, max_wait_ms=2.0,
                             tracing=False)
        results = []
        lock = threading.Lock()
        rng = np.random.default_rng(3)
        picks = rng.integers(0, n_models, size=960)

        def client(tid):
            tenant = f"t{tid % 3}"
            for i in range(60):
                idx = picks[tid * 60 + i]
                if i % 10 == 5:
                    model_key, payload = "model", {"features": [0.1] * 8}
                else:
                    model_key = f"m{idx:03d}"
                    payload = {"x": int(idx)}
                t0 = time.perf_counter()
                try:
                    body = fleet.post(payload, model=model_key,
                                      tenant=tenant, timeout=120)
                    with lock:
                        results.append((model_key, 200, body,
                                        time.perf_counter() - t0))
                except urllib.error.HTTPError as e:
                    with lock:
                        results.append((model_key, e.code, None,
                                        time.perf_counter() - t0))
                except ServingUnavailable:
                    with lock:
                        results.append((model_key, 503, None,
                                        time.perf_counter() - t0))

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(16)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            assert len(results) == 960
            ok = [r for r in results if r[1] == 200]
            assert len(ok) / len(results) >= 0.99
            distinct = {m for m, c, _b, _l in ok if m.startswith("m")}
            assert len(distinct) >= 200
            for model_key, _c, body, _l in ok:
                if model_key == "model":
                    assert "prediction" in body
                else:
                    assert body["served_by"] == model_key
            lat = sorted(r[3] for r in ok)
            assert lat[int(0.99 * len(lat))] < 30.0
            assert zoo.evictions > 0
            assert zoo.evictions_with_outstanding == 0
            assert int(model.jit_cache_misses) == misses_warm
        finally:
            fleet.stop_all()
            zoo.close()
