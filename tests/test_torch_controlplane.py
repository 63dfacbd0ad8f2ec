"""PyTorch port: the continuous-training control plane
(``serving/controlplane.py``), its replay window
(``io/ooc.py::ReplayWindow``), the drift and control-loop Prometheus
families and the control-loop audit, against the JAX package, on the
CPU.

Held against the JAX package: the same appends give bitwise-equal
snapshots, evictions, stats and ``tail`` in both windows; a forest
carried across by its model string gives the same ``_shadow_and_gate``
verdict in both packages on the same shadow rows (rtol 1e-6); the same
``DriftMonitor`` renders the same drift families, and a trainer's status
the same control-plane families. The reference's loop drills
(``tests/test_controlplane.py``) run over port engines on free ports
with a GBDT refit (``Booster.boost_more`` over the window, the slice's
refit): the drift -> promote loop, label-flip and NaN refits
quarantined, the refit circuit, trainer death, ``state_dict`` /
``load_state`` recovery and a kill mid-cutover. Cycles are started with
``trigger_now`` where the drill allows and waited on by polling with
deadlines.
"""

import json
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

from mmlspark_tpu.core.metrics import DriftMonitor as JDriftMonitor
from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.io.ooc import ReplayWindow as JReplayWindow

from mmlspark_tpu_torch.core.metrics import DriftMonitor
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.gbdt.estimators import (
    TPUBoostClassificationModel, TPUBoostClassifier,
)
from mmlspark_tpu_torch.io.ooc import ReplayWindow
from mmlspark_tpu_torch.serving import (
    CanaryPolicy, ContinuousTrainer, GatePolicy, ModelRegistry,
    RefitPolicy, ServingFleet, TriggerPolicy, json_scoring_pipeline,
    serve_model,
)
from mmlspark_tpu_torch.stages.basic import Lambda
from mmlspark_tpu_torch.testing import fusion_check

D = 6
NAMES = [f"f{i}" for i in range(D)]


def _blobs(n=600, d=D, seed=7, shift=0.0):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) + shift).astype(np.float32)
    w = np.linspace(1.0, -1.0, d)
    y = (X @ w > shift * w.sum()).astype(np.float64)
    return X, y


def _post(addr, payload, timeout=10.0):
    req = urllib.request.Request(
        addr, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(addr, path, timeout=10.0):
    with urllib.request.urlopen(addr + path, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _wait(pred, timeout=30.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def _ended(tr, timeout=60.0):
    """Wait until the trainer's timeline ends a cycle: its counters move
    before its last event and its quarantine evidence land."""
    def ended():
        last = tr.history[-1] if tr.history else None
        if last is None or last.kind not in (
                "promoted", "quarantined", "refit_failed", "circuit_open"):
            return False
        return last.kind != "quarantined" or last.version in tr.quarantined
    return _wait(ended, timeout=timeout)


def _model(booster):
    m = TPUBoostClassificationModel(
        modelString=booster.model_to_string(), numClasses=2, device="cpu")
    m._booster = booster
    return m


def _serve_forest():
    """A fitted forest behind HTTP with its fit-time drift monitor."""
    X, y = _blobs()
    base = TPUBoostClassifier(numIterations=5, numLeaves=7, maxBin=63,
                              device="cpu").fit(
        DataTable({"features": X, "label": y}))
    dm = DriftMonitor.from_matrix(X, feature_names=NAMES)
    engine = serve_model(json_scoring_pipeline(base, drift_monitor=dm),
                         port=0, batch_size=16, workers=2, version="base")
    return engine, (X, y)


def _window_xy(window):
    tab = window.materialize()
    return (np.asarray(tab["features"], np.float32),
            np.asarray(tab["label"], np.float64))


def _boost_refit(rounds=2, flip=False):
    """The slice's refit hook: boost_more over the replay window from
    the active forest (a fresh fit on flipped labels with ``flip``), a
    fresh drift monitor from the window, rewrapped for serving."""
    def refit(window, active):
        X, y = _window_xy(window)
        if flip:
            m = TPUBoostClassifier(numIterations=10, numLeaves=7,
                                   maxBin=63, device="cpu").fit(
                DataTable({"features": X, "label": 1.0 - y}))
        else:
            b = active.model.get_booster().boost_more(rounds, X, y)
            m = _model(b)
        return json_scoring_pipeline(
            m, drift_monitor=DriftMonitor.from_matrix(
                X, feature_names=NAMES))
    return refit


def _trainer(engine, refit, **kw):
    kw.setdefault("triggers", TriggerPolicy(
        max_mean_delta_sigma=2.0, min_window_rows=64, cooldown_s=0.3,
        watch_slo_alerts=False))
    kw.setdefault("gate", GatePolicy(shadow_rows=256, min_rows=32))
    kw.setdefault("canary", CanaryPolicy(
        fraction=0.5, min_batches=3, decision_timeout_s=20))
    kw.setdefault("warmup_example", {"features": [0.0] * D})
    kw.setdefault("poll_interval_s", 0.02)
    return ContinuousTrainer(engine, refit, **kw)


class _Traffic:
    """Background (shifted) traffic against one engine."""

    def __init__(self, addr, shift=3.0, n_threads=2):
        self.addr, self.shift = addr, shift
        self.ok = self.errors = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, args=(i,),
                                          daemon=True)
                         for i in range(n_threads)]

    def _run(self, tid):
        rng = np.random.default_rng(1000 + tid)
        while not self._stop.is_set():
            x = rng.normal(size=D) + self.shift
            try:
                status, _ = _post(self.addr, {"features": list(x)})
                with self._lock:
                    self.ok += status == 200
            except Exception:  # noqa: BLE001 — availability
                with self._lock:
                    self.errors += 1
            time.sleep(0.002)

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)


# ---------------------------------------------------------------------------
# the replay window, against the reference's
# ---------------------------------------------------------------------------


def _chunk(value, rows=17, table=DataTable):
    return table({"features": np.full((rows, D), float(value)),
                  "label": np.full(rows, float(value))})


class TestReplayWindow:
    @pytest.mark.parametrize("max_rows,sizes", [
        (50, [17] * 10),
        (10, [64]),
        (1000, [10, 0, 33, 7, 1]),
        (100, [30, 45, 5, 60, 2, 41]),
    ])
    def test_appends_match_reference_bitwise(self, max_rows, sizes):
        rng = np.random.default_rng(max_rows)
        win, jwin = ReplayWindow(max_rows=max_rows), \
            JReplayWindow(max_rows=max_rows)
        for n in sizes:
            X = rng.normal(size=(n, D)).astype(np.float32)
            y = rng.integers(0, 2, n).astype(np.float64)
            win.append({"features": X, "label": y})
            jwin.append({"features": X, "label": y})
        assert win.stats() == jwin.stats()
        assert win.rows == jwin.rows
        snap, jsnap = win.snapshot(), jwin.snapshot()
        assert snap.num_rows == jsnap.num_rows
        got = list(snap.chunks(prefetch_depth=0))
        want = list(jsnap.chunks(prefetch_depth=0))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for c in ("features", "label"):
                assert np.asarray(g[c]).tobytes() == \
                    np.asarray(w[c]).tobytes()
        for k in (1, 25, 60, 10_000):
            got = [np.asarray(t["label"]).tobytes() for t in win.tail(k)]
            want = [np.asarray(t["label"]).tobytes()
                    for t in jwin.tail(k)]
            assert got == want

    def test_bounded_eviction_keeps_newest(self):
        win = ReplayWindow(max_rows=50)
        for i in range(10):
            win.append(_chunk(i))
        assert win.rows <= 50 and win.appended_rows == 170
        assert win.evicted_chunks > 0
        tab = win.snapshot().materialize()
        assert set(np.asarray(tab["label"])) == {8.0, 9.0}

    def test_single_oversized_chunk_is_kept(self):
        win = ReplayWindow(max_rows=10)
        win.append(_chunk(1, rows=64))
        assert win.rows == 64

    def test_snapshot_is_immutable_and_replayable(self):
        win = ReplayWindow(max_rows=1000)
        win.append(_chunk(1))
        win.append(_chunk(2))
        snap = win.snapshot()
        win.append(_chunk(3))
        for _ in range(2):
            tab = snap.materialize()
            assert len(tab) == 34
            assert set(np.asarray(tab["label"])) == {1.0, 2.0}

    def test_tail_returns_newest_rows_in_order(self):
        win = ReplayWindow(max_rows=1000)
        for i in range(5):
            win.append(_chunk(i, rows=10))
        assert [float(t["label"][0]) for t in win.tail(25)] == [3.0, 4.0]
        assert win.tail(1)[0]["label"][0] == 4.0
        win.clear()
        assert win.rows == 0 and win.tail(10) == []

    def test_concurrent_append_replay_never_torn(self):
        win = ReplayWindow(max_rows=400)
        stop = threading.Event()
        tears, bounds = [], []

        def writer():
            i = 0
            while not stop.is_set():
                win.append(_chunk(i % 97, rows=23))
                i += 1

        def reader():
            while not stop.is_set():
                total = 0
                for chunk in win.snapshot().chunks(prefetch_depth=0):
                    col = np.asarray(chunk["label"])
                    if len(np.unique(col)) > 1:
                        tears.append(col)
                    total += len(col)
                bounds.append(total)
                for t in win.tail(100):
                    col = np.asarray(t["label"])
                    if len(np.unique(col)) > 1:
                        tears.append(col)

        threads = [threading.Thread(target=writer)] + [
            threading.Thread(target=reader) for _ in range(3)]
        for t in threads:
            t.start()
        assert _wait(lambda: win.evicted_chunks > 50 and len(bounds) > 20,
                     timeout=20)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        assert not tears, f"torn chunk observed: {tears[:1]}"
        assert bounds and max(bounds) <= 400 + 23


# ---------------------------------------------------------------------------
# the gate verdict, both packages on the same shadow rows
# ---------------------------------------------------------------------------


def _gate_verdicts(model_strings, rows, labels, gate_kw):
    """``_shadow_and_gate`` of candidate vs baseline forests (model
    strings), in the port and in the JAX package, on the same window."""
    from mmlspark_tpu.gbdt.estimators import (
        TPUBoostClassificationModel as JModel,
    )
    from mmlspark_tpu.serving import (
        ContinuousTrainer as JTrainer, GatePolicy as JGate,
        json_scoring_pipeline as j_pipeline,
    )
    eng = types.SimpleNamespace(tracer=None)
    ours = ContinuousTrainer(eng, lambda w, a: None,
                             gate=GatePolicy(**gate_kw))
    theirs = JTrainer(eng, lambda w, a: None, gate=JGate(**gate_kw))
    for lo in range(0, len(rows), 100):
        chunk = {"features": rows[lo:lo + 100],
                 "label": labels[lo:lo + 100]}
        ours.ingest(chunk)
        theirs.ingest(chunk)
    cand, base = model_strings
    v = ours._shadow_and_gate(
        json_scoring_pipeline(TPUBoostClassificationModel(
            modelString=cand, numClasses=2, device="cpu")),
        json_scoring_pipeline(TPUBoostClassificationModel(
            modelString=base, numClasses=2, device="cpu")), "ct-1")
    jv = theirs._shadow_and_gate(
        j_pipeline(JModel(modelString=cand, numClasses=2)),
        j_pipeline(JModel(modelString=base, numClasses=2)), "ct-1")
    return v, jv


def _assert_verdicts_match(v, jv):
    assert sorted(v) == sorted(jv)
    for k, want in jv.items():
        got = v[k]
        if isinstance(want, float) and not isinstance(want, bool):
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), k
        else:
            assert got == want, k


class TestGateParity:
    @pytest.fixture(scope="class")
    def forests(self):
        X, y = _blobs(n=800, seed=3)
        t = DataTable({"features": X, "label": y})
        base = TPUBoostClassifier(numIterations=5, numLeaves=7, maxBin=63,
                                  device="cpu").fit(t)
        b = base.get_booster()
        Xs, ys = _blobs(n=400, seed=5, shift=0.5)
        cand = b.boost_more(3, Xs, ys)
        flip = TPUBoostClassifier(numIterations=8, numLeaves=7, maxBin=63,
                                  device="cpu").fit(
            DataTable({"features": Xs, "label": 1.0 - ys}))
        return (b.model_to_string(), cand.model_to_string(),
                flip.get_booster().model_to_string(), Xs, ys)

    @pytest.mark.parametrize("case", ["pass", "flip", "thin", "divergent"])
    def test_same_verdict_as_reference(self, forests, case):
        base, cand, flip, Xs, ys = forests
        gate = {"shadow_rows": 256, "min_rows": 32}
        pair = (cand, base)
        if case == "flip":
            pair = (flip, base)
        elif case == "thin":
            gate["min_rows"] = 1000
        elif case == "divergent":
            gate["max_divergence"] = 0.0
        v, jv = _gate_verdicts(pair, Xs, ys, gate)
        _assert_verdicts_match(v, jv)
        assert v["shadow_rows"] == 200     # the newest whole chunks
        want_reason = {"pass": "gate:pass", "flip": "gate:quality_delta",
                       "thin": "gate:thin_evidence",
                       "divergent": "gate:divergence"}[case]
        if case == "divergent" and v["divergence"] == 0.0:
            want_reason = "gate:pass"
        assert v["reason"].startswith(want_reason), v

    def test_regression_labels_same_verdict(self, forests):
        base, cand, _, Xs, ys = forests
        yr = ys + 0.25 * Xs[:, 0]
        v, jv = _gate_verdicts((cand, base), Xs, yr,
                               {"shadow_rows": 300, "min_rows": 32})
        assert v["classification"] is False
        _assert_verdicts_match(v, jv)


# ---------------------------------------------------------------------------
# the loop and its failure paths, over port engines
# ---------------------------------------------------------------------------


class TestContinuousLoop:
    def test_drift_refit_canary_cutover(self):
        """Shifted traffic trips the drift trigger; the boost_more refit
        runs on the trainer thread, passes the gate and the canary, and
        cuts over; the timeline holds every decision in order."""
        engine, (X, y) = _serve_forest()
        registry = ModelRegistry()
        tr = _trainer(engine, _boost_refit(), registry=registry)
        threads = []
        real = tr._run_refit

        def spy(snapshot, active):
            threads.append(threading.current_thread().name)
            return real(snapshot, active)

        tr._run_refit = spy
        try:
            tr.start()
            with _Traffic(engine.source.address, shift=3.0) as load:
                Xs, ys = _blobs(n=400, seed=11, shift=3.0)
                for lo in range(0, 400, 50):
                    tr.ingest(DataTable({"features": Xs[lo:lo + 50],
                                         "label": ys[lo:lo + 50]}))
                assert _ended(tr) and tr.promotions == 1, \
                    (tr.status(), tr.history)
                assert engine.model_version == "ct-1"
                assert load.errors == 0
                # the promoted pipeline's fresh monitor needs rows before
                # its per-feature series render
                assert _wait(lambda: "serving_drift_score{" in
                             engine.metrics_text(), timeout=20)
            assert threads == ["controlplane-trainer"]
            assert tr.cycles == 1, tr.status()
            kinds = [(type(e).__name__, e.kind) for e in registry.events]
            expected = [("RetrainEvent", "loop_started"),
                        ("RetrainEvent", "triggered"),
                        ("RetrainEvent", "refit_ok"),
                        ("ShadowEvent", "shadow_pass"),
                        ("PromoteEvent", "promote_started"),
                        ("SwapEvent", "completed"),
                        ("PromoteEvent", "promoted")]
            it = iter(kinds)
            assert all(k in it for k in expected), (expected, kinds)
            ats = [e.at for e in registry.events]
            assert ats == sorted(ats)
            trig = next(e for e in registry.events
                        if e.kind == "triggered")
            assert trig.reason.startswith("drift:") and ">=" in trig.reason
            text = engine.metrics_text()
            assert "serving_controlplane_promotions_total 1" in text
            assert "serving_controlplane_phase_ms" in text
            status, health = _get(engine.source.address, "/healthz")
            assert status == 200 and health["status"] == "ok"
            assert health["controlplane"]["promotions"] == 1
            # the candidate's forest is the direct boost_more of the
            # base over the same window
            active = engine._active.pipeline.model.get_booster()
            assert active.num_trees == 5 + 2
        finally:
            tr.stop()
            engine.stop()
        assert registry.events[-1].kind == "loop_stopped"

    def test_trainer_refit_bitwise_direct_boost_more(self):
        """The refit the trainer thread runs is bitwise the same
        boost_more run on the calling thread over the same snapshot."""
        engine, (X, y) = _serve_forest()
        base = engine._active.pipeline.model.get_booster()
        tr = _trainer(engine, _boost_refit(rounds=3),
                      gate=GatePolicy(shadow_rows=256, min_rows=32,
                                      min_quality_delta=-1.0,
                                      max_divergence=1.0))
        Xs, ys = _blobs(n=300, seed=29, shift=0.3)
        tr.ingest(DataTable({"features": Xs, "label": ys}))
        snap = tr.window.snapshot()
        try:
            tr.start()
            tr.trigger_now("bitwise-drill")
            with _Traffic(engine.source.address, shift=0.0):
                assert _ended(tr), tr.status()
            assert tr.promotions == 1, tr.history
            got = engine._active.pipeline.model.get_booster()
            Xw, yw = _window_xy(snap)
            want = base.boost_more(3, Xw, yw)
            assert got.model_to_string() == want.model_to_string()
        finally:
            tr.stop()
            engine.stop()

    def test_label_flip_refit_quarantined(self):
        engine, _ = _serve_forest()
        registry = ModelRegistry()
        tr = _trainer(engine, _boost_refit(flip=True), registry=registry)
        try:
            tr.start()
            Xs, ys = _blobs(n=300, seed=13)
            tr.ingest(DataTable({"features": Xs, "label": ys}))
            tr.trigger_now("poison-drill")
            assert _ended(tr) and tr.quarantines == 1, tr.status()
            assert tr.promotions == 0
            assert engine.model_version == "base"
            q = tr.quarantined["ct-1"]
            assert q["verdict"]["pass"] is False
            assert q["verdict"]["reason"].startswith("gate:quality_delta")
            assert q["verdict"]["quality_candidate"] < \
                q["verdict"]["quality_baseline"]
            bundle = q["bundle"]
            assert bundle is not None
            assert bundle["reason"].startswith("quarantine:ct-1:gate")
            recorded = [ev for evs in bundle["events"].values()
                        for ev in evs if ev.get("kind") == "quarantined"]
            assert recorded and \
                recorded[0]["stats"]["quality_delta"] < -0.02
            kinds = [e.kind for e in registry.events]
            assert kinds.index("shadow_fail") < kinds.index("quarantined")
            assert "promoted" not in kinds
        finally:
            tr.stop()
            engine.stop()

    def test_nan_refit_quarantined(self):
        engine, _ = _serve_forest()

        class _NaNModel:
            def predict(self, X):
                return np.full(len(X), np.nan)

        tr = _trainer(engine, lambda w, a: types.SimpleNamespace(
            model=_NaNModel()))
        try:
            tr.start()
            Xs, ys = _blobs(n=200, seed=17)
            tr.ingest(DataTable({"features": Xs, "label": ys}))
            tr.trigger_now("nan-drill")
            assert _ended(tr) and tr.quarantines == 1, tr.status()
            verdict = tr.quarantined["ct-1"]["verdict"]
            assert verdict["reason"].startswith("gate:nan_rate")
            assert verdict["nan_rate"] == 1.0
            assert engine.model_version == "base"
        finally:
            tr.stop()
            engine.stop()

    def test_refit_failures_open_circuit_serving_frozen(self):
        engine, (X, y) = _serve_forest()
        attempts = []

        def broken(window, active):
            attempts.append(1)
            raise RuntimeError("the hist kernel did not launch")

        tr = _trainer(engine, broken, refit_policy=RefitPolicy(
            max_attempts=2, backoff_s=0.01, circuit_after=2,
            circuit_reset_s=120.0))
        try:
            tr.start()
            Xs, ys = _blobs(n=200, seed=19)
            tr.ingest(DataTable({"features": Xs, "label": ys}))
            tr.trigger_now("fail-1")
            assert _wait(lambda: tr.refit_failures >= 1, timeout=30)
            tr.trigger_now("fail-2")
            assert _wait(lambda: tr.circuit_open, timeout=30), tr.status()
            assert len(attempts) == 4
            st = tr.status()
            assert st["state"] == "degraded" and st["degraded"]
            status, body = _post(engine.source.address,
                                 {"features": X[0].tolist()})
            assert status == 200 and "prediction" in body
            hstatus, health = _get(engine.source.address, "/healthz")
            assert hstatus == 200 and health["status"] == "degraded"
            assert health["controlplane"]["circuit_open"]
            assert engine.model_version == "base"
            kinds = [e.kind for e in tr.history]
            assert "circuit_open" in kinds
            assert kinds.count("refit_failed") == 2
            fail = next(e for e in tr.history if e.kind == "refit_failed")
            assert "did not launch" in fail.reason
            text = engine.metrics_text()
            assert "serving_controlplane_degraded 1" in text
            assert "serving_controlplane_circuit_open 1" in text
        finally:
            tr.stop()
            engine.stop()

    def test_trainer_death_isolation(self):
        engine, (X, y) = _serve_forest()
        tr = _trainer(engine, _boost_refit())
        try:
            tr.start()
            assert _wait(lambda: tr.status()["trainer_alive"], timeout=10)
            tr.kill_trainer()
            assert _wait(lambda: not tr.status()["trainer_alive"],
                         timeout=10)
            assert tr.status()["degraded"]
            t0 = time.perf_counter()
            for i in range(20):
                status, body = _post(engine.source.address,
                                     {"features": X[i].tolist()})
                assert status == 200 and "prediction" in body
            assert time.perf_counter() - t0 < 10
            hstatus, health = _get(engine.source.address, "/healthz")
            assert hstatus == 200 and health["status"] == "degraded"
            assert health["controlplane"]["trainer_alive"] is False
        finally:
            tr.stop()
            engine.stop()

    def test_kill_mid_cutover_fleet_stays_available(self):
        """An engine killed mid-canary: the fleet fails over (>= 99 %),
        every reply correct, and the cycle ends quarantined with the
        swap evidence, never a phantom promote."""
        def versioned(version):
            def handle(table):
                return table.with_column("reply", [
                    {"echo": json.loads(r["entity"].decode())["x"],
                     "v": version} for r in table["request"]])
            return Lambda.apply(handle)

        fleet = ServingFleet(versioned("v1"), n_engines=2, base_port=0,
                             batch_size=4, workers=1, max_wait_ms=2.0,
                             failure_threshold=3, breaker_cooldown=30.0)
        registry = ModelRegistry()
        engine = fleet.engines[0]
        tr = _trainer(engine, lambda w, a: versioned("v2"),
                      registry=registry,
                      predict_fn=lambda pipe, Xm: np.zeros(len(Xm)),
                      canary=CanaryPolicy(fraction=0.5, min_batches=10_000,
                                          decision_timeout_s=3.0),
                      warmup_example=None)
        results = {}
        stop_load = threading.Event()

        def client(cid, n=300):
            for j in range(n):
                if stop_load.is_set():
                    return
                key = cid * 100000 + j
                try:
                    body = fleet.post({"x": key}, timeout=5.0)
                    results[key] = (body.get("echo") == key
                                    and body.get("v") in ("v1", "v2"))
                except Exception:  # noqa: BLE001 — availability
                    results[key] = False

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        try:
            tr.start()
            Xs, _ = _blobs(n=200, seed=23)
            tr.ingest(DataTable({"features": Xs, "label": np.zeros(200)}))
            for t in threads:
                t.start()
            tr.trigger_now("chaos-drill")
            assert _wait(lambda: engine.swap_state == "canary",
                         timeout=30), (engine.swap_state, tr.status())
            engine.kill()
            assert _ended(tr, timeout=30), tr.status()
            for t in threads:
                t.join(timeout=60)
        finally:
            stop_load.set()
            tr.stop()
            fleet.stop_all()
        total, ok = len(results), sum(results.values())
        assert total >= 600 and ok / total >= 0.99, (ok, total)
        assert tr.promotions == 0 and tr.quarantines == 1
        assert tr.quarantined["ct-1"]["verdict"]["reason"].startswith(
            "canary:")
        kinds = [(type(e).__name__, e.kind) for e in registry.events]
        expected = [("RetrainEvent", "triggered"),
                    ("RetrainEvent", "refit_ok"),
                    ("ShadowEvent", "shadow_pass"),
                    ("PromoteEvent", "promote_started"),
                    ("SwapEvent", "rolled_back"),
                    ("QuarantineEvent", "quarantined")]
        it = iter(kinds)
        assert all(k in it for k in expected), (expected, kinds)

    def test_idempotent_recovery_after_restart(self):
        engine, _ = _serve_forest()
        registry = ModelRegistry()
        registry.register("ct-3", object())
        tr1 = _trainer(engine, _boost_refit(), registry=registry)
        tr1.quarantined["ct-2"] = {
            "verdict": {"pass": False, "reason": "gate:nan_rate"},
            "bundle": None, "at": 0.0}
        tr1.quarantines = 1
        try:
            tr1.start()
            state = tr1.state_dict()
            tr1.stop()
            assert json.loads(json.dumps(state)) == state
            tr2 = _trainer(engine, _boost_refit(), registry=registry,
                           state=state)
            tr2._sync_version_counter()
            assert tr2._next_version() == "ct-4"
            assert tr2.quarantines == 1
            assert tr2.quarantined["ct-2"]["verdict"]["reason"] == \
                "gate:nan_rate"
            tr2.start()
            assert registry.versions().count("base") == 1
            tr2.stop()
        finally:
            engine.stop()


# ---------------------------------------------------------------------------
# the exposition, against the reference's renderer
# ---------------------------------------------------------------------------


def _render(fn, *args, jax_side=False):
    if jax_side:
        from mmlspark_tpu.core.prometheus import PromRenderer as R
    else:
        from mmlspark_tpu_torch.core.prometheus import PromRenderer as R
    r = R()
    fn(r, *args)
    return r.render()


class TestDriftExposition:
    @pytest.mark.parametrize("d,shift_col", [(25, 3), (4, 0)])
    def test_drift_families_match_reference(self, d, shift_col):
        from mmlspark_tpu.core.prometheus import drift_families as jdf
        from mmlspark_tpu_torch.core.prometheus import (
            DRIFT_FEATURE_CAP, drift_families,
        )
        names = [f"f{i}" for i in range(d)]
        rng = np.random.default_rng(d)
        ref = rng.normal(size=(500, d))
        X = rng.normal(size=(200, d))
        X[:, shift_col] += 5.0
        mon = DriftMonitor.from_matrix(ref, feature_names=names)
        jmon = JDriftMonitor.from_matrix(ref, feature_names=names)
        empty = _render(drift_families, mon, {"model": "m"})
        assert empty == _render(jdf, jmon, {"model": "m"}, jax_side=True)
        assert "serving_drift_score" not in empty
        mon.observe(X)
        jmon.observe(X)
        text = _render(drift_families, mon)
        assert text == _render(jdf, jmon, jax_side=True)
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("serving_drift_score{")]
        assert len(lines) == min(d, DRIFT_FEATURE_CAP) + (
            d > DRIFT_FEATURE_CAP)
        top = [ln for ln in lines if f'feature="f{shift_col}"' in ln]
        assert top and float(top[0].split()[-1]) > 4.0

    def test_controlplane_families_match_reference(self):
        from mmlspark_tpu.core.prometheus import (
            controlplane_families as jcf,
        )
        from mmlspark_tpu_torch.core.prometheus import controlplane_families
        fake = types.SimpleNamespace(status=lambda: {
            "state": "idle", "degraded": False, "circuit_open": False,
            "cycles": 3, "refits": 2, "refit_failures": 1,
            "promotions": 2, "quarantines": 1, "last_trigger": "drift:x",
            "window": {"rows": 128}})
        text = _render(controlplane_families, fake)
        jtext = _render(jcf, fake, jax_side=True)

        def gauges(t):   # the phase histograms are process-wide samples
            return [ln for ln in t.splitlines()
                    if "serving_controlplane_phase_ms" not in ln]

        assert gauges(text) == gauges(jtext)
        assert "serving_controlplane_promotions_total 2" in text
        assert 'state="idle"' in text
        assert "serving_controlplane_phase_ms" in text

    def test_engine_exposition_passes_the_audit(self):
        from mmlspark_tpu_torch.testing import metrics_check
        engine, (X, y) = _serve_forest()
        tr = _trainer(engine, _boost_refit())
        try:
            tr.start()
            for i in range(8):
                _post(engine.source.address, {"features": X[i].tolist()})
            text = engine.metrics_text()
            assert "serving_drift_rows" in text
            assert "serving_controlplane_cycles_total" in text
            assert 'serving_ingress_phase_ms_bucket{phase="decode"' in text
            assert metrics_check.audit_text(text) == []
        finally:
            tr.stop()
            engine.stop()


# ---------------------------------------------------------------------------
# the control-loop audit
# ---------------------------------------------------------------------------


_FUNNEL = ("class T:\n"
           "    def _transition(self, s, e):\n"
           "        self.state = s\n"
           "        self._record(e)\n"
           "    def _record(self, e):\n"
           "        self.registry.record_event(e)\n")


class TestControlLoopAudit:
    def test_shipped_control_loop_clean(self):
        assert fusion_check.check_control_loop() == []

    def test_state_write_outside_funnel_flagged(self):
        bad = _FUNNEL + ("    def handle(self):\n"
                         "        self.state = 'degraded'\n")
        v = fusion_check.check_control_loop_source(bad, name="bad")
        assert len(v) == 1 and "'handle'" in v[0] and "_transition" in v[0]

    def test_refit_call_outside_trainer_thread_flagged(self):
        bad = _FUNNEL + ("    def _batcher_helper(self):\n"
                         "        return self.booster.boost_more(5)\n"
                         "    def _cycle(self):\n"
                         "        return self.refit(self.win, self.a)\n")
        v = fusion_check.check_control_loop_source(bad, name="bad")
        assert len(v) == 1 and "boost_more" in v[0]
        assert "_batcher_helper" in v[0]

    def test_unrecorded_transition_flagged(self):
        bad = ("class T:\n"
               "    def _transition(self, s, e):\n"
               "        self.state = s\n"
               "    def _record(self, e):\n"
               "        self.registry.record_event(e)\n")
        v = fusion_check.check_control_loop_source(bad, name="bad")
        assert len(v) == 1 and "timeline" in v[0]

    def test_recorder_without_registry_flagged(self):
        bad = ("class T:\n"
               "    def _transition(self, s, e):\n"
               "        self.state = s\n"
               "        self._record(e)\n"
               "    def _record(self, e):\n"
               "        self.history.append(e)\n")
        v = fusion_check.check_control_loop_source(bad, name="bad")
        assert len(v) == 1 and "record_event" in v[0]

    def test_fusion_check_main_reports_every_audit(self, capsys):
        assert fusion_check.main() == 0
        out = capsys.readouterr().out
        assert "ingress kernels" in out and "shm hot paths" in out
        assert "control loop" in out and "0 violations" in out
