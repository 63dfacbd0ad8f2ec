"""PyTorch port: the versioned model lifecycle (``serving/lifecycle.py``
and ``ServingEngine.swap``) against the JAX package, on the CPU.

The scenarios of ``tests/test_lifecycle.py`` (``TestModelRegistry``,
``TestEngineSwap``), ``tests/test_observability.py``'s
``TestSwapMetricsConsistency`` and ``tests/test_fusion.py``'s
``test_swap_fused_pipeline_zero_recompiles`` run over port engines
(``port=0``; counters polled, not read right after a reply). Held
against the JAX package, with tolerances stated:
- ``ModelRegistry``: the same ``list()`` / ``latest()`` / ``previous()``
  for the same registrations (equal);
- ``SwapController``: the same routing picks, decision string and
  ``stats()`` for the same scripted ``observe`` sequence (equal);
- a forest trained by the JAX package on a HIGGS-shaped table, carried
  into the port through its model string (and its ``BinMapper``'s
  JSON), refreshed by ``boost_more(5)`` in each package and swapped
  into a port engine under load: every reply equals the port's own
  transform of the version that served it (bitwise; a one-row batch
  walks its trees in another summation order than a many-row one, in
  both packages, so a reply served alone equals the one-row
  transform), the refreshed
  forest's tree structure equals the JAX package's (bitwise), and each
  reply after cutover equals the JAX package's transform of the
  refreshed forest within rtol 1e-6 at ``hist_bits=16`` and 1e-5 in
  f32. Leaf values are not bitwise across packages even at 16 bits:
  the quantization steps are float32 sums of |g| and |h|, which torch
  and XLA add in different orders (one ulp; ``gbdt/tree.py``
  ``quant_scales``).
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.gbdt.booster import train as jtrain
from mmlspark_tpu.gbdt.estimators import TPUBoostRegressionModel as JReg
from mmlspark_tpu.serving.lifecycle import (
    CanaryPolicy as JCanaryPolicy, ModelRegistry as JModelRegistry,
    SwapController as JSwapController,
)
from mmlspark_tpu.serving.server import PipelineHandle as JHandle

from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.gbdt.binning import BinMapper
from mmlspark_tpu_torch.gbdt.booster import Booster
from mmlspark_tpu_torch.gbdt.estimators import TPUBoostRegressionModel
from mmlspark_tpu_torch.serving import (
    CanaryPolicy, ModelRegistry, SwapInProgress, json_scoring_pipeline,
    serve_model,
)
from mmlspark_tpu_torch.serving.lifecycle import SwapController
from mmlspark_tpu_torch.serving.server import PipelineHandle
from mmlspark_tpu_torch.stages.basic import Lambda


def versioned_pipeline(version):
    """Echo pipeline that stamps its version into every reply — the
    instrument for no-mixed-version and cutover assertions."""
    def handle(table):
        return table.with_column("reply", [
            {"echo": json.loads(r["entity"].decode())["x"], "v": version}
            for r in table["request"]])
    return Lambda.apply(handle)


def _post(addr, payload, timeout=5.0):
    req = urllib.request.Request(
        addr, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _poll(fn, want, timeout=5.0):
    deadline = time.monotonic() + timeout
    got = fn()
    while got != want and time.monotonic() < deadline:
        time.sleep(0.01)
        got = fn()
    return got


def _serve(pipeline, **kw):
    return serve_model(pipeline, port=0, batch_size=4,
                       flight_recorder=False, **kw)


class _Load:
    """Background request stream against one engine; collects
    (status, version) per reply."""

    def __init__(self, addr, n_threads=2):
        self.addr = addr
        self.results = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, args=(i,),
                                          daemon=True)
                         for i in range(n_threads)]

    def _run(self, tid):
        i = 0
        while not self._stop.is_set():
            try:
                status, body = _post(self.addr,
                                     {"x": tid * 100000 + i}, timeout=5)
                out = (status, body.get("v"))
            except Exception as e:  # noqa: BLE001 — availability metric
                out = (0, f"{type(e).__name__}")
            with self._lock:
                self.results.append(out)
            i += 1

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


class TestModelRegistry:
    def test_register_get_order(self):
        reg = ModelRegistry()
        reg.register("v1", "model-one", metadata={"auc": 0.9})
        reg.register("v2", "model-two")
        assert reg.get("v1") == "model-one"
        assert reg.versions() == ["v1", "v2"]
        assert reg.latest() == "v2"
        assert reg.previous("v2") == "v1"
        assert reg.previous("v1") is None
        assert reg.metadata("v1") == {"auc": 0.9, "precision": "f32",
                                      "aot": False}

    def test_duplicate_and_unknown_version(self):
        reg = ModelRegistry()
        reg.register("v1", object())
        with pytest.raises(ValueError, match="already registered"):
            reg.register("v1", object())
        with pytest.raises(KeyError, match="unknown model version"):
            reg.get("nope")
        with pytest.raises(KeyError, match="registry is empty"):
            ModelRegistry().latest()

    def test_list_latest_previous_match_jax(self):
        regs = {"torch": ModelRegistry(), "jax": JModelRegistry()}
        for reg in regs.values():
            reg.register("v1", "model-one", metadata={"auc": 0.9})
            reg.register("v2", "model-two", metadata={"aot": True})
            reg.register("v3", "model-three",
                         metadata={"precision": "int8"})
        t, j = regs["torch"], regs["jax"]
        assert t.list() == j.list()
        assert t.latest() == j.latest() == "v3"
        for v in ("v1", "v2", "v3"):
            assert t.previous(v) == j.previous(v)
            assert t.lookup(v) == j.lookup(v)
        assert t.previous("nope") is j.previous("nope") is None


# ---------------------------------------------------------------------------
# the canary controller against the JAX package's
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _controllers(**policy):
    """(port controller, JAX controller) over the same policy, each
    breaker on its own injected clock."""
    out = []
    for Handle, Policy, Ctl in ((PipelineHandle, CanaryPolicy,
                                 SwapController),
                                (JHandle, JCanaryPolicy, JSwapController)):
        stable = Handle("stable-pipe", "v1")
        canary = Handle("canary-pipe", "v2", is_canary=True)
        ctl = Ctl(stable, canary, Policy(**policy))
        ctl.breaker._clock = _Clock()
        out.append(ctl)
    return out


# (policy, script): each step is (canary?, ok, latency_ms, row_errors)
_SCRIPTS = {
    "promote": (dict(fraction=0.5, min_batches=4),
                [(True, True, 1.0, 0)] * 6),
    "consecutive": (dict(fraction=0.5, min_batches=8,
                         consecutive_failures=3),
                    [(True, True, 1.0, 0), (True, False, 2.0, 0),
                     (True, False, 2.0, 0), (True, False, 3.0, 0),
                     (True, True, 1.0, 0)]),
    "window_rate": (dict(fraction=0.25, min_batches=20,
                         consecutive_failures=10, error_rate=0.3,
                         min_calls=5, window=10),
                    [(True, True, 1.0, 0), (True, True, 1.0, 2),
                     (True, True, 1.0, 0), (True, False, 1.5, 0),
                     (True, True, 1.0, 0), (True, True, 1.0, 1),
                     (True, True, 1.0, 0)]),
    "latency": (dict(fraction=0.5, min_batches=3, latency_ratio=2.0),
                [(False, True, 1.0, 0)] * 4 + [(True, True, 5.0, 0)] * 4),
    "stable_only": (dict(fraction=0.5, min_batches=3),
                    [(False, True, 1.0, 0)] * 5),
}


@pytest.mark.parametrize("case", sorted(_SCRIPTS))
def test_controller_decisions_and_stats_match_jax(case):
    policy, script = _SCRIPTS[case]
    ctls = _controllers(**policy)
    for ctl in ctls:
        for canary, ok, lat, row_errors in script:
            handle = ctl.canary if canary else ctl.stable
            ctl.observe(handle, ok, lat, row_errors=row_errors,
                        error=None if ok else RuntimeError("boom"))
    port, ref = ctls
    assert port.decision == ref.decision
    if case == "stable_only":
        # no canary evidence: the decision is the timeout breach
        assert port.wait_decision(0.01) == ref.wait_decision(0.01)
        assert port.decision.startswith("breach:decision_timeout")
    assert port.stats() == ref.stats()
    if case == "promote":
        assert port.decision == "promote"
    elif case != "stable_only":
        assert port.decision.startswith("breach:")


@pytest.mark.parametrize("fraction", [0.0, 0.1, 0.25, 0.7, 1.0])
def test_controller_routing_matches_jax(fraction):
    picks = []
    for ctl in _controllers(fraction=fraction):
        active = ctl.stable
        picks.append([ctl.route(active) is ctl.canary
                      for _ in range(200)])
    assert picks[0] == picks[1]
    # the error-diffusion accumulator: the share is the fraction, up
    # to the one pick a float accumulator may still owe
    assert abs(sum(picks[0]) - 200 * fraction) <= 1


# ---------------------------------------------------------------------------
# the engine's swap
# ---------------------------------------------------------------------------


class TestEngineSwap:
    def test_swap_completes_under_load_no_mixed_replies(self):
        engine = _serve(versioned_pipeline("v1"), version="v1")
        try:
            with _Load(engine.source.address) as load:
                time.sleep(0.1)
                res = engine.swap(
                    versioned_pipeline("v2"), "v2",
                    policy=CanaryPolicy(fraction=0.5, min_batches=3,
                                        decision_timeout_s=20))
                assert res.completed, res.reason
                # post-cutover replies are all v2
                s, body = _post(engine.source.address, {"x": -1})
                assert s == 200 and body["v"] == "v2"
            statuses = [s for s, _ in load.results]
            versions = {v for s, v in load.results if s == 200}
            assert statuses and all(s == 200 for s in statuses)
            assert versions <= {"v1", "v2"}
            assert engine.model_version == "v2"
            assert engine.swap_state == "idle"
            assert engine.swaps_completed == 1
            assert engine.swaps_rolled_back == 0
            assert engine.swap_events[-1].kind == "completed"
            assert engine.swap_events[-1].stats["canary_ok"] >= 3
        finally:
            engine.stop()

    def test_swap_warms_up_before_cutover(self):
        warmed = threading.Event()
        pipe = versioned_pipeline("v2")
        seen_version = []

        def warmup(example):
            seen_version.append(engine.model_version)
            warmed.set()
            return 0
        pipe.warmup = warmup
        engine = _serve(versioned_pipeline("v1"), version="v1")
        try:
            res = engine.swap(pipe, "v2", warmup_example={"x": [0]},
                              policy=CanaryPolicy(fraction=0.0))
            assert res.completed
            assert warmed.is_set() and seen_version == ["v1"]
            assert engine.model_version == "v2"
        finally:
            engine.stop()

    def test_warmup_failure_rolls_back(self):
        pipe = versioned_pipeline("v2")

        def warmup(example):
            raise RuntimeError("compile exploded")
        pipe.warmup = warmup
        engine = _serve(versioned_pipeline("v1"), version="v1")
        try:
            res = engine.swap(pipe, "v2", warmup_example={"x": [0]})
            assert res.rolled_back
            assert "warmup_failed" in res.reason
            assert engine.model_version == "v1"
            assert engine.swap_state == "rolled_back"
            assert engine.swaps_rolled_back == 1
            # still serving on the old version
            assert _post(engine.source.address, {"x": 5})[1]["v"] == "v1"
        finally:
            engine.stop()

    def test_warmup_requiring_example_without_one_rolls_back(self):
        pipe = versioned_pipeline("v2")
        pipe.warmup = lambda example: 0
        engine = _serve(versioned_pipeline("v1"), version="v1")
        try:
            res = engine.swap(pipe, "v2")   # no warmup_example
            assert res.rolled_back
            assert "requires an example" in res.reason
        finally:
            engine.stop()

    def test_decision_timeout_rolls_back_without_traffic(self):
        # no load -> the canary never sees a batch -> the safe default
        # is rollback, not a promote on zero evidence
        engine = _serve(versioned_pipeline("v1"), version="v1")
        try:
            res = engine.swap(
                versioned_pipeline("v2"), "v2",
                policy=CanaryPolicy(fraction=0.5, min_batches=2,
                                    decision_timeout_s=0.5))
            assert res.rolled_back
            assert res.reason.startswith("breach:decision_timeout")
            assert "canary_ok=0/2 needed" in res.reason
            assert engine.model_version == "v1"
        finally:
            engine.stop()

    def test_second_swap_while_swapping_raises(self):
        engine = _serve(versioned_pipeline("v1"), version="v1")
        try:
            started = threading.Event()
            outcome = {}

            def slow_swap():
                pipe = versioned_pipeline("v2")

                def warmup(example):
                    started.set()
                    time.sleep(1.0)
                    return 0
                pipe.warmup = warmup
                outcome["res"] = engine.swap(
                    pipe, "v2", warmup_example={"x": [0]},
                    policy=CanaryPolicy(fraction=0.0))
            t = threading.Thread(target=slow_swap, daemon=True)
            t.start()
            assert started.wait(5)
            assert engine.swap_state == "warming"
            with pytest.raises(SwapInProgress):
                engine.swap(versioned_pipeline("v3"), "v3")
            t.join(timeout=10)
            assert outcome["res"].completed
        finally:
            engine.stop()

    def test_registry_records_swap_events(self):
        from mmlspark_tpu_torch.serving.lifecycle import execute_swap
        reg = ModelRegistry()
        reg.register("v1", versioned_pipeline("v1"))
        reg.register("v2", versioned_pipeline("v2"))
        engine = _serve(reg.get("v1"), version="v1")
        try:
            res = execute_swap(engine, reg.get("v2"), "v2",
                               policy=CanaryPolicy(fraction=0.0),
                               registry=reg)
            assert res.completed
            assert [e.kind for e in reg.events] == ["completed"]
            assert reg.events[0].to_version == "v2"
            assert reg.events[0].from_version == "v1"
        finally:
            engine.stop()

    def test_healthz_and_metrics_report_lifecycle_fields(self):
        engine = _serve(versioned_pipeline("v1"), version="v1")
        try:
            assert _post(engine.source.address, {"x": 1})[0] == 200
            with urllib.request.urlopen(
                    engine.source.address + "/healthz", timeout=5) as r:
                stats = json.loads(r.read())
            m = stats["metrics"]
            assert m["model_version"] == "v1"
            assert m["swap_state"] == "idle"
            assert m["swaps_completed"] == 0
            assert m["swaps_rolled_back"] == 0
            engine.swap(versioned_pipeline("v2"), "v2",
                        policy=CanaryPolicy(fraction=0.0))
            text = urllib.request.urlopen(
                engine.source.address + "/metrics",
                timeout=5).read().decode()
            assert "serving_swaps_completed_total 1" in text
            assert "serving_swaps_rolled_back_total 0" in text
            assert 'version="v2"' in text and 'swap_state="idle"' in text
        finally:
            engine.stop()

    def test_canary_batches_family_and_rescue_keep_clients_whole(self):
        """A canary whose batches fail is struck and rescued on the
        stable handle: no client sees the fault, the canary gauge shows
        the failed batches while the swap is in flight, and the stable
        handle's in-flight count drains to zero."""
        def poisoned(table):
            raise RuntimeError("poisoned canary")
        engine = _serve(versioned_pipeline("v1"), version="v1")
        texts = []
        try:
            with _Load(engine.source.address) as load:
                stop = threading.Event()

                def scrape():
                    while not stop.is_set():
                        texts.append(engine.metrics_text())
                        time.sleep(0.01)
                t = threading.Thread(target=scrape, daemon=True)
                t.start()
                res = engine.swap(
                    Lambda.apply(poisoned), "v2",
                    policy=CanaryPolicy(fraction=0.5, min_batches=50,
                                        consecutive_failures=3,
                                        decision_timeout_s=20))
                stop.set()
                t.join(timeout=5)
            assert res.rolled_back and res.reason.startswith(
                "breach:error_rate")
            assert res.event.stats["canary_failed"] >= 3
            assert {s for s, _ in load.results} == {200}
            assert {v for _, v in load.results} == {"v1"}
            assert _poll(lambda: engine._active.outstanding, 0) == 0
        finally:
            engine.stop()
        assert any('serving_canary_batches{outcome="failed"}' in x
                   for x in texts)

    def test_embedder_calls(self):
        """``HTTPSource.get_batch`` / ``get_batch_adaptive`` and
        ``ServingEngine.process_one_batch`` on an engine whose loop is
        not started (the embedder drives the batches itself)."""
        from mmlspark_tpu_torch.serving.server import HTTPSource, \
            ServingEngine
        source = HTTPSource(port=0)
        engine = ServingEngine(source, versioned_pipeline("v1"),
                               batch_size=4, flight_recorder=False,
                               tracing=False, slo=False)
        try:
            table, ids = source.get_batch(4, 0.01)
            assert ids == [] and len(table) == 0
            replies = {}

            def client(i):
                replies[i] = _post(source.address, {"x": i})[1]
            ts = [threading.Thread(target=client, args=(i,))
                  for i in range(3)]
            for t in ts:
                t.start()
            n = 0
            deadline = time.monotonic() + 10
            while n < 3 and time.monotonic() < deadline:
                n += engine.process_one_batch(wait_s=0.05)
            for t in ts:
                t.join(timeout=10)
            assert n == 3
            assert replies == {i: {"echo": i, "v": "v1"} for i in range(3)}
            got = {}

            def client2():
                got["r"] = _post(source.address, {"x": 9})[1]
            t = threading.Thread(target=client2)
            t.start()
            table, ids, waits = [], [], []
            deadline = time.monotonic() + 10
            while not ids and time.monotonic() < deadline:
                table, ids, waits = source.get_batch_adaptive(4, 0.01)
            assert len(ids) == 1 and len(waits) == 1 and waits[0] >= 0
            engine._execute_batch(table, ids, None)
            t.join(timeout=10)
            assert got["r"] == {"echo": 9, "v": "v1"}
        finally:
            engine.stop()

    def test_kill_stops_without_restart(self):
        engine = _serve(versioned_pipeline("v1"), version="v1")
        try:
            assert _post(engine.source.address, {"x": 1})[0] == 200
            engine.kill(close_source=True)
            assert not engine.is_alive()
            time.sleep(0.3)
            assert engine.workers_restarted == 0
            res = engine.swap(versioned_pipeline("v2"), "v2")
            assert res.rolled_back and res.reason == "engine_dead"
        finally:
            engine.stop()


# ---------------------------------------------------------------------------
# consistent snapshots under a swap loop (test_observability.py)
# ---------------------------------------------------------------------------


class TestSwapMetricsConsistency:
    def test_snapshot_never_tears_under_swap_loop(self):
        """In every metrics() snapshot taken while swaps cut over, the
        (model_version, swap_state, swaps_completed) triple is
        consistent: version vK with state idle implies exactly K
        completed swaps; draining implies K-1."""
        def echo(table):
            return table.with_column("reply", [b"ok" for _ in table["id"]])

        engine = serve_model(Lambda.apply(echo), port=0, batch_size=4,
                             tracing=False, version="v0",
                             flight_recorder=False)
        violations = []
        stop = threading.Event()

        def poll():
            while not stop.is_set():
                m = engine.metrics()
                state = m["swap_state"]
                k = int(m["model_version"][1:])
                done = m["swaps_completed"]
                if state in ("idle", "warming", "canary") and done != k:
                    violations.append((state, k, done))
                elif state == "draining" and done != k - 1:
                    violations.append((state, k, done))

        pollers = [threading.Thread(target=poll) for _ in range(3)]
        for t in pollers:
            t.start()
        try:
            policy = CanaryPolicy(fraction=0.0, drain_timeout_s=1.0)
            for i in range(1, 120):
                res = engine.swap(Lambda.apply(echo), f"v{i}",
                                  policy=policy)
                assert res.completed, res
        finally:
            stop.set()
            for t in pollers:
                t.join()
            engine.stop()
        assert not violations, \
            f"{len(violations)} torn snapshots, e.g. {violations[:5]}"


# ---------------------------------------------------------------------------
# a fused pipeline swapped in (test_fusion.py)
# ---------------------------------------------------------------------------


def _raw_table(n, seed):
    rng = np.random.default_rng(seed)
    num2 = rng.normal(size=n)
    num2[rng.random(n) < 0.15] = np.nan
    return {
        "num1": rng.normal(size=n),
        "num2": num2,
        "icol": rng.integers(-5, 5, n),
        "cat": [f"lvl{int(i)}" for i in rng.integers(0, 12, n)],
        "toks": [[f"w{int(t)}" for t in rng.integers(0, 40, 5)]
                 for _ in range(n)],
        "label": (rng.random(n) > 0.5).astype(float),
    }


def _fit_logistic_pipeline(cols):
    from mmlspark_tpu_torch.automl.featurize import Featurize
    from mmlspark_tpu_torch.core.stage import Pipeline
    from mmlspark_tpu_torch.models.linear import TPULogisticRegression
    from mmlspark_tpu_torch.stages.dataprep import StandardScaler
    return Pipeline(stages=[
        Featurize(featureColumns=["num1", "num2", "icol", "cat", "toks"],
                  numberOfFeatures=32),
        StandardScaler(inputCol="features", outputCol="features"),
        TPULogisticRegression(featuresCol="features", labelCol="label",
                              maxIter=10, device="cpu"),
    ]).fit(DataTable(cols))


def test_swap_fused_pipeline_zero_recompiles():
    """The incoming fused pipeline warms every bucket off the hot path
    (exactly one first run per bucket), and steady-state traffic never
    meets a first-run shape — through and after the cutover."""
    s1 = json_scoring_pipeline(
        _fit_logistic_pipeline(_raw_table(200, 41)).fused(
            device="cpu", batch_size=32))
    s2 = json_scoring_pipeline(
        _fit_logistic_pipeline(_raw_table(200, 42)).fused(
            device="cpu", batch_size=32))
    example = {"num1": [0.1], "num2": [1.0], "icol": [2],
               "cat": ["lvl3"], "toks": [["w1", "w2"]]}
    s1.warmup(example)
    engine = serve_model(s1, port=0, batch_size=32, workers=2,
                         version="v1", flight_recorder=False)
    payload = {"num1": 0.4, "num2": 0.2, "icol": 1, "cat": "lvl7",
               "toks": ["w3"]}
    try:
        for _ in range(4):
            _post(engine.source.address, payload)
        m1 = s1.jit_cache_miss_count()
        stop = threading.Event()

        def pump():
            while not stop.is_set():
                try:
                    _post(engine.source.address, payload, timeout=5)
                except Exception:  # noqa: BLE001 — load only
                    pass

        pumps = [threading.Thread(target=pump, daemon=True)
                 for _ in range(3)]
        for t in pumps:
            t.start()
        try:
            res = engine.swap(
                s2, "v2", warmup_example=example,
                policy=CanaryPolicy(fraction=0.5, min_batches=2,
                                    decision_timeout_s=20))
        finally:
            stop.set()
            for t in pumps:
                t.join(timeout=5)
        assert res.completed, res.reason
        warm = len(s2.scorer.fused.bucket_sizes())
        m2_after_swap = s2.jit_cache_miss_count()
        assert m2_after_swap == warm, \
            "swap warmup did not cover every bucket exactly once"
        for _ in range(6):
            assert "prediction" in _post(engine.source.address, payload)[1]
        assert s2.jit_cache_miss_count() == m2_after_swap
        assert s1.jit_cache_miss_count() == m1
    finally:
        engine.stop()


# ---------------------------------------------------------------------------
# a refreshed forest swapped in under load
# ---------------------------------------------------------------------------


def _higgs_shape(n=5600, seed=7):
    """The HIGGS-shaped fixture of tests/test_gbdt_dist_quant.py."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 28)).astype(np.float32)
    logit = (X[:, 0] + 0.6 * X[:, 1] * X[:, 2]
             + 0.4 * np.sin(2 * X[:, 3]) - 0.3 * X[:, 4] ** 2 + 0.3)
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return X, y


STRUCT_KEYS = ("feature", "bin_threshold", "threshold", "left", "right",
               "is_leaf", "count")


@pytest.mark.parametrize("hist_bits,rtol", [(16, 1e-6), (None, 1e-5)])
def test_boost_more_refresh_swapped_in_under_load(hist_bits, rtol):
    X, y = _higgs_shape()
    X1, y1, X2, y2 = X[:3000], y[:3000], X[3000:5000], y[3000:5000]
    Xh = X[5000:5200]
    kw = {"objective": "regression", "num_iterations": 5,
          "num_leaves": 15, "max_bin": 63}
    if hist_bits:
        kw["hist_bits"] = hist_bits
    jb1 = jtrain(kw, X1, y1)
    jb2 = jb1.boost_more(5, X2, y2)
    # carried across: the model string, and the fit-time binning that
    # boost_more on fresh rows bins them with
    tb1 = Booster.from_string(jb1.model_to_string(), device="cpu")
    tb1.bin_mapper = BinMapper.from_json(jb1.bin_mapper.to_json())
    tb2 = tb1.boost_more(5, X2, y2)
    assert tb2.num_trees == jb2.num_trees == 10
    for k in STRUCT_KEYS:
        np.testing.assert_array_equal(tb2.trees[k], jb2.trees[k],
                                      err_msg=k)
    v1 = TPUBoostRegressionModel(modelString=jb1.model_to_string(),
                                 device="cpu")
    v2 = TPUBoostRegressionModel(modelString=tb2.model_to_string(),
                                 device="cpu")

    def score(model, X):
        return np.asarray(model.transform(DataTable(
            {"features": X}))["prediction"])
    want = {"v1": score(v1, Xh), "v2": score(v2, Xh)}
    # a one-row walk sums its trees in another order than a many-row
    # walk (both packages): a reply served in a batch of one equals the
    # one-row transform, any other reply the many-row one
    alone = {name: np.array([score(m, Xh[i:i + 1])[0]
                             for i in range(len(Xh))])
             for name, m in (("v1", v1), ("v2", v2))}
    jwant = {"v1": np.asarray(JReg(modelString=jb1.model_to_string())
                              .transform(JTable({"features": Xh}))
                              ["prediction"]),
             "v2": np.asarray(JReg(modelString=jb2.model_to_string())
                              .transform(JTable({"features": Xh}))
                              ["prediction"])}
    # v1 crossed bitwise (the f32 forest walk); v2 to the stated rtol
    np.testing.assert_array_equal(want["v1"], jwant["v1"])
    np.testing.assert_allclose(want["v2"], jwant["v2"], rtol=rtol)
    assert not np.array_equal(want["v1"], want["v2"])

    engine = serve_model(json_scoring_pipeline(v1), port=0, batch_size=16,
                         workers=2, version="v1", flight_recorder=False)
    results = []
    lock = threading.Lock()
    stop = threading.Event()

    def client(tid):
        i = tid
        while not stop.is_set():
            row = i % len(Xh)
            t0 = time.monotonic()
            try:
                _, body = _post(engine.source.address,
                                {"features": Xh[row].tolist()})
                got = body["prediction"]
            except Exception as e:  # noqa: BLE001 — availability
                got = e
            with lock:
                results.append((row, got, t0, time.monotonic()))
            i += 4

    threads = [threading.Thread(target=client, args=(t,), daemon=True)
               for t in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.3)
        t_swap0 = time.monotonic()
        res = engine.swap(json_scoring_pipeline(v2), "v2",
                          warmup_example={"features": Xh[:1]},
                          policy=CanaryPolicy(fraction=0.5, min_batches=3,
                                              decision_timeout_s=20))
        t_swap1 = time.monotonic()
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        engine.stop()
    assert res.completed, res.reason
    assert not [r for r in results if isinstance(r[1], Exception)]
    before = after = 0
    for row, got, t0, t1 in results:
        # every reply is one version's transform of its row, bitwise
        assert got in (want["v1"][row], want["v2"][row],
                       alone["v1"][row], alone["v2"][row]), (row, got)
        if t1 < t_swap0:
            before += 1
            assert got in (want["v1"][row], alone["v1"][row])
        elif t0 > t_swap1:
            after += 1
            assert got in (want["v2"][row], alone["v2"][row])
            np.testing.assert_allclose(got, jwant["v2"][row], rtol=rtol)
    assert before > 0 and after > 0
