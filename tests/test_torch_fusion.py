"""PyTorch port: whole-pipeline fusion (``core/fusion.py``), the stages'
device ops, the fused scorer and the port's static checks, against the
JAX package, on the CPU.

The scenarios of ``tests/test_fusion.py`` (``TestFusedParity``,
``TestColumnPruning``, ``TestDeviceTable``, ``TestFusedServing``,
``TestFusedScorerEdges``) run through both packages: each pipeline is
fitted in the JAX package and carried into the port with ``load_stage``
(a ``Lambda`` is rebuilt around the same function), and the port fuses
it on the CPU (``device="cpu"``). Tolerances, stated:
- fused vs ``transform_staged`` within the port: bitwise;
- Featurize's assembled features: bitwise to the JAX package's fused
  output and to the port's host transform;
- the forest walk (f32 routing): raw scores bitwise to the JAX
  package's fused output and the port's host transform;
- a logistic head: probabilities within rtol 1e-5 / atol 1e-6 of the
  JAX package's fused ones; predictions equal except on rows whose
  top-two probability margin is under 1e-5 (counted, and at most 1 %);
- column pruning changes no output (bitwise).
The JAX package's ``test_swap_fused_pipeline_zero_recompiles`` runs in
``tests/test_torch_lifecycle.py``.
"""

import inspect
import json
import textwrap
import urllib.request

import numpy as np
import pytest

from mmlspark_tpu.automl.featurize import Featurize as JFeaturize
from mmlspark_tpu.core import fusion as JFZ
from mmlspark_tpu.core.stage import Pipeline as JPipeline
from mmlspark_tpu.core.stage import PipelineModel as JPipelineModel
from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.gbdt.estimators import TPUBoostClassifier as JGBC
from mmlspark_tpu.models.linear import (
    TPULinearRegression as JLinR, TPULogisticRegression as JLogR,
)
from mmlspark_tpu.models.tpu_model import TPUModel as JTPUModel
from mmlspark_tpu.stages import basic as JB
from mmlspark_tpu.stages import dataprep as JD

from mmlspark_tpu_torch.core import fusion as FZ
from mmlspark_tpu_torch.core.metrics import DriftMonitor
from mmlspark_tpu_torch.core.stage import (
    PipelineModel, Transformer, load_stage,
)
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.models.linear import TPULogisticRegression
from mmlspark_tpu_torch.models.tpu_model import TPUModel
from mmlspark_tpu_torch.serving.fleet import json_scoring_pipeline
from mmlspark_tpu_torch.serving.server import serve_model
from mmlspark_tpu_torch.stages import basic as PB
from mmlspark_tpu_torch.testing import fusion_check as CHK

FEATURE_COLS = ["num1", "num2", "icol", "cat", "toks"]
PROB_RTOL, PROB_ATOL, TIE = 1e-5, 1e-6, 1e-5


def _raw_cols(n=300, seed=0, unseen=False):
    """Raw rows: numerics (one with NaN / inf), a 12-level string, token
    lists, an int column — the serving-shaped input mix."""
    rng = np.random.default_rng(seed)
    num2 = rng.normal(size=n)
    num2[rng.random(n) < 0.15] = np.nan
    num2[rng.random(n) < 0.03] = np.inf
    cats = [f"lvl{int(i)}" for i in rng.integers(0, 12, n)]
    if unseen:
        cats[0] = "NEVER_SEEN"
        cats[1] = None
    return {
        "num1": rng.normal(size=n),
        "num2": num2,
        "icol": rng.integers(-5, 5, n),
        "cat": cats,
        "toks": [[f"w{int(t)}" for t in rng.integers(0, 40, 5)]
                 for _ in range(n)],
        "label": (rng.random(n) > 0.5).astype(float),
    }


def _tables(**kw):
    cols = _raw_cols(**kw)
    return JTable(cols), DataTable(cols)


def _carry(stages, tmp_path):
    """JAX fitted stages -> port stages: saved by the JAX package and
    loaded by the port (a Lambda is rebuilt around its function); GBDT
    models score on the CPU."""
    out = []
    for i, st in enumerate(stages):
        if isinstance(st, JB.Lambda):
            out.append(PB.Lambda(transformFunc=st.get("transformFunc")))
            continue
        path = str(tmp_path / f"stage{i}")
        st.save(path)
        port = load_stage(path)
        if any(p.name == "device" for p in type(port).params()):
            port.set("device", "cpu")
        out.append(port)
    return PipelineModel(stages=out)


def _fit_logistic(jt, one_hot=False, max_iter=25):
    return JPipeline(stages=[
        JFeaturize(featureColumns=FEATURE_COLS, numberOfFeatures=32,
                   oneHotEncodeCategoricals=one_hot),
        JD.StandardScaler(inputCol="features", outputCol="features"),
        JLogR(featuresCol="features", labelCol="label", maxIter=max_iter),
    ]).fit(jt)


def _fused(pm, **kw):
    return pm.fused(device="cpu", **kw)


def _assert_equal(a, b, cols):
    for c in cols:
        x, y = np.asarray(a[c]), np.asarray(b[c])
        assert x.dtype == y.dtype, f"{c}: {x.dtype} != {y.dtype}"
        assert np.array_equal(x, y, equal_nan=True), \
            f"column {c} differs (max|d|={np.nanmax(np.abs(x - y))})"


def _assert_logistic_rule(port, ref):
    """Probabilities within rtol 1e-5 / atol 1e-6; predictions equal but
    on near ties (top-two margin under 1e-5), which are counted."""
    pp, rp = np.asarray(port["probability"]), np.asarray(ref["probability"])
    np.testing.assert_allclose(pp, rp, rtol=PROB_RTOL, atol=PROB_ATOL)
    top2 = np.sort(rp, axis=1)[:, -2:]
    near = (top2[:, 1] - top2[:, 0]) < TIE
    diff = np.asarray(port["prediction"]) != np.asarray(ref["prediction"])
    assert not (diff & ~near).any(), "a prediction differs off a near tie"
    assert near.sum() <= max(1, len(rp) // 100), near.sum()
    return int(near.sum())


# ---------------------------------------------------------------------------
# fused vs staged vs the JAX package
# ---------------------------------------------------------------------------


class TestFusedParity:
    @pytest.mark.parametrize("one_hot", [False, True],
                             ids=["indexed", "onehot"])
    def test_featurize_fused_bitwise_jax_and_host(self, tmp_path, one_hot):
        """Featurize's parts are exact in f32: the port's fused output
        equals the JAX package's fused one and the host transform bit
        for bit — NaN / inf imputation, unseen + None levels, ints."""
        jt, _ = _tables(seed=1)
        jfm = JFeaturize(featureColumns=FEATURE_COLS, numberOfFeatures=32,
                         oneHotEncodeCategoricals=one_hot).fit(jt)
        pm = _carry([jfm], tmp_path)
        js, ps = _tables(n=150, seed=2, unseen=True)
        fused = _fused(pm)
        got = fused.transform(ps)
        assert fused.plan_for(ps.schema).describe() == "[FeaturizeModel]"
        _assert_equal(got, pm.transform(ps), ["features"])
        _assert_equal(got, JPipelineModel(stages=[jfm]).fused().transform(
            js), ["features"])

    def test_logistic_pipeline_fused_vs_staged_and_jax(self, tmp_path):
        """The acceptance invariant: the fused segment == the same ops
        run stage-at-a-time, bitwise; against the JAX package's fused
        program, the logistic rule."""
        jt, _ = _tables(seed=5)
        jpm = _fit_logistic(jt)
        pm = _carry(jpm.get_stages(), tmp_path)
        js, ps = _tables(n=200, seed=6, unseen=True)
        fused = _fused(pm)
        out_f = fused.transform(ps)
        out_s = fused.transform_staged(ps)
        _assert_equal(out_f, out_s, ["features", "rawPrediction",
                                     "probability", "prediction"])
        plan = fused.plan_for(ps.schema)
        fused.transform(ps)
        assert plan.last_roundtrips == 1
        fused.transform_staged(ps)
        assert plan.last_roundtrips == 3      # one per stage
        ref = jpm.fused().transform(js)
        _assert_equal(out_f, ref, ["features"])
        _assert_logistic_rule(out_f, ref)

    def test_logistic_pipeline_fused_vs_host(self, tmp_path):
        """vs the f64 host path: features bitwise, predictions equal but
        on near ties, probabilities to f32 rounding, the same dtypes."""
        jt, _ = _tables(seed=7)
        pm = _carry(_fit_logistic(jt).get_stages(), tmp_path)
        _, ps = _tables(n=200, seed=8, unseen=True)
        host = pm.transform(ps)
        out = _fused(pm).transform(ps)
        _assert_equal(host, out, ["features"])
        _assert_logistic_rule(out, host)
        assert out.schema["prediction"].tag == host.schema["prediction"].tag
        assert np.asarray(out["probability"]).dtype == np.float64

    def test_linear_regression_pipeline(self, tmp_path):
        jt, _ = _tables(seed=9)
        jpm = JPipeline(stages=[
            JFeaturize(featureColumns=["num1", "num2", "icol"],
                       numberOfFeatures=8),
            JLinR(featuresCol="features", labelCol="label", maxIter=25),
        ]).fit(jt)
        pm = _carry(jpm.get_stages(), tmp_path)
        js, ps = _tables(n=120, seed=10)
        fused = _fused(pm)
        out_f = fused.transform(ps)
        _assert_equal(out_f, fused.transform_staged(ps),
                      ["features", "prediction"])
        ref = np.asarray(jpm.fused().transform(js)["prediction"])
        got = np.asarray(out_f["prediction"])
        np.testing.assert_allclose(got, ref, rtol=PROB_RTOL,
                                   atol=PROB_ATOL * np.abs(ref).max())
        np.testing.assert_allclose(
            np.asarray(pm.transform(ps)["prediction"]), got, atol=1e-4)

    def test_gbdt_pipeline_fused_forest_walk(self, tmp_path):
        """The forest walk in f32 routing: raw scores bitwise to the
        JAX package's fused program and to the port's host walk."""
        jt, _ = _tables(seed=11)
        jpm = JPipeline(stages=[
            JFeaturize(featureColumns=["num1", "num2", "icol"],
                       numberOfFeatures=8),
            JGBC(featuresCol="features", labelCol="label",
                 numIterations=8, numLeaves=7, minDataInLeaf=4),
        ]).fit(jt)
        pm = _carry(jpm.get_stages(), tmp_path)
        js, ps = _tables(n=150, seed=12)
        fused = _fused(pm)
        plan = fused.plan_for(ps.schema)
        assert len(plan.segments) == 1, plan.describe()
        out_f = fused.transform(ps)
        cols = ["rawPrediction", "probability", "prediction"]
        _assert_equal(out_f, fused.transform_staged(ps), cols)
        ref = jpm.fused().transform(js)
        _assert_equal(out_f, ref, ["rawPrediction", "prediction"])
        np.testing.assert_allclose(np.asarray(out_f["probability"]),
                                   np.asarray(ref["probability"]),
                                   rtol=PROB_RTOL, atol=PROB_ATOL)
        host = pm.transform(ps)
        _assert_equal(out_f, host, ["rawPrediction", "prediction"])

    def test_value_indexer_assembler_tpu_model_segment(self, tmp_path):
        """ValueIndexer (host Feed) -> assembler -> TPUModel forward in
        ONE segment."""
        jt, pt = _tables(seed=13)
        jvi = JD.ValueIndexer(inputCol="cat", outputCol="cat_ix").fit(jt)
        W = np.asarray([[1.0, -1.0], [0.5, 0.25]], np.float32)
        jtm = JTPUModel.from_fn(
            lambda w, ins: list(ins.values())[0] @ w["W"],
            {"W": W}, inputCol="fv", outputCol="scores")
        jpm = JPipelineModel(stages=[
            jvi, JD.FastVectorAssembler(inputCols=["num1", "cat_ix"],
                                        outputCol="fv"), jtm])
        pm = _carry(jpm.get_stages()[:2], tmp_path)
        tm = TPUModel.from_fn(
            lambda w, ins: list(ins.values())[0] @ w["W"],
            {"W": W}, inputCol="fv", outputCol="scores")
        pm = PipelineModel(stages=pm.get_stages() + [tm])
        fused = _fused(pm)
        plan = fused.plan_for(pt.schema)
        assert len(plan.segments) == 1, plan.describe()
        out_f = fused.transform(pt)
        _assert_equal(out_f, fused.transform_staged(pt),
                      ["cat_ix", "fv", "scores"])
        ref = jpm.fused().transform(jt)
        _assert_equal(out_f, ref, ["cat_ix", "fv"])
        np.testing.assert_allclose(np.asarray(out_f["scores"]),
                                   np.asarray(ref["scores"]), rtol=1e-6)

    def test_clean_missing_fuses(self, tmp_path):
        jt, pt = _tables(seed=14)
        jpm = JPipeline(stages=[
            JD.CleanMissingData(inputCols=["num2"], outputCols=["num2c"],
                                cleaningMode="Mean"),
            JD.FastVectorAssembler(inputCols=["num1", "num2c"],
                                   outputCol="fv"),
            JD.StandardScaler(inputCol="fv", outputCol="fv"),
        ]).fit(jt)
        pm = _carry(jpm.get_stages(), tmp_path)
        fused = _fused(pm)
        assert len(fused.plan_for(pt.schema).segments) == 1
        out_f = fused.transform(pt)
        _assert_equal(out_f, fused.transform_staged(pt), ["num2c", "fv"])
        _assert_equal(out_f, jpm.fused().transform(jt), ["num2c", "fv"])
        np.testing.assert_allclose(np.asarray(pm.transform(pt)["fv"]),
                                   np.asarray(out_f["fv"]), atol=1e-6)

    def test_host_only_stage_breaks_segment_but_output_matches(
            self, tmp_path):
        """A Lambda between device stages forces a host hop; outputs
        still match the host path and the JAX package, bitwise."""
        jt, pt = _tables(seed=15)

        def bump(t):
            return t.with_column(
                "num1b", np.asarray(t["num1"], np.float64) + 1.0)

        jpm = JPipeline(stages=[
            JB.Lambda(transformFunc=bump),
            JFeaturize(featureColumns=["num1b", "num2"],
                       numberOfFeatures=8),
            JD.StandardScaler(inputCol="features", outputCol="features"),
        ]).fit(jt)
        pm = _carry(jpm.get_stages(), tmp_path)
        fused = _fused(pm)
        assert fused.plan_for(pt.schema).describe() == \
            jpm.fused().plan_for(jt.schema).describe()
        out_f = fused.transform(pt)
        _assert_equal(pm.transform(pt), out_f, ["features"])
        _assert_equal(jpm.fused().transform(jt), out_f, ["features"])

    def test_stage_on_another_device_raises(self, tmp_path):
        """The plan never moves a stage silently: a stage whose own
        ``device`` names another device than the plan's raises."""
        jt, pt = _tables(seed=16)
        tm = TPUModel.from_fn(lambda w, ins: list(ins.values())[0],
                              {}, inputCol="num1", outputCol="out",
                              device="cuda:0")
        with pytest.raises(ValueError, match="device"):
            _fused(PipelineModel(stages=[tm])).transform(pt)
        tm.set("device", "cpu")
        out = _fused(PipelineModel(stages=[tm])).transform(pt)
        np.testing.assert_array_equal(
            out["out"], np.asarray(pt["num1"], np.float32))

    def test_failing_device_op_is_not_sent_to_the_host(self):
        """No fallback: a device op that raises fails the plan; the
        stage does not quietly run its host ``transform``."""
        _, pt = _tables(n=40, seed=17)
        spy = _SpyStage()

        def broken(schema):
            raise RuntimeError("device op broke")

        spy.device_op = broken
        with pytest.raises(RuntimeError, match="device op broke"):
            _fused(PipelineModel(stages=[spy])).transform(pt)
        assert spy.seen_columns is None


# ---------------------------------------------------------------------------
# column liveness + pruning
# ---------------------------------------------------------------------------


class _SpyStage(Transformer):
    """Records the columns it receives; declares its column flow so
    pruning may act across it."""

    def _post_init(self):
        self.seen_columns = None

    def transform(self, table):
        self.seen_columns = list(table.column_names)
        return table

    def reads_columns(self, schema):
        return ["features"]

    def writes_columns(self, schema):
        return []


class TestColumnPruning:
    def test_liveness_matches_jax(self, tmp_path):
        jt, pt = _tables(n=40)
        jfm = JFeaturize(featureColumns=FEATURE_COLS,
                         numberOfFeatures=8).fit(jt)
        jmodel = JLogR(featuresCol="features", labelCol="label",
                       maxIter=2).fit(jfm.transform(jt))
        jstages = [jfm, jmodel, JB.SelectColumns(cols=["prediction"])]
        pstages = _carry(jstages, tmp_path).get_stages()
        got = FZ.column_liveness(pstages, pt.schema)
        assert got == JFZ.column_liveness(jstages, jt.schema)
        assert "toks" not in got[1] and "features" in got[1]
        assert got[2] == {"prediction"}
        assert FZ.column_liveness(pstages, pt.schema, final_needed=set()) \
            == JFZ.column_liveness(jstages, jt.schema, final_needed=set())

    def test_transform_prunes_dead_intermediates_with_parity(self,
                                                             tmp_path):
        jt, pt = _tables(n=80, seed=20)
        jfm = JFeaturize(featureColumns=FEATURE_COLS,
                         numberOfFeatures=8).fit(jt)
        jlr = JLogR(featuresCol="features", labelCol="label",
                    maxIter=5).fit(jfm.transform(jt))
        fm, lr = _carry([jfm, jlr], tmp_path).get_stages()
        spy = _SpyStage()
        pm = PipelineModel(stages=[
            fm, lr, spy, PB.SelectColumns(cols=["prediction",
                                                "probability"])])
        out = pm.transform(pt)
        assert out.column_names == ["prediction", "probability"]
        assert "toks" not in spy.seen_columns
        assert "cat" not in spy.seen_columns
        assert "features" in spy.seen_columns
        ref = pt
        for st in pm.get_stages():
            ref = st.transform(ref)
        _assert_equal(ref, out, ["prediction", "probability"])

    def test_unknown_stage_disables_pruning(self):
        _, pt = _tables(n=40, seed=21)
        picked = {}

        def adds_col(t):
            return t.with_column("invented",
                                 np.arange(len(t), dtype=np.float64))

        def check(t):
            picked["cols"] = list(t.column_names)
            return t

        pm = PipelineModel(stages=[
            PB.Lambda(transformFunc=adds_col),
            PB.Lambda(transformFunc=check),
            PB.DropColumns(cols=["num1"])])
        out = pm.transform(pt)
        assert "invented" in picked["cols"]
        assert "invented" in out.column_names

    def test_fit_with_unknown_tail_keeps_estimator_outputs(self):
        from mmlspark_tpu_torch.automl.featurize import Featurize
        from mmlspark_tpu_torch.core.stage import Pipeline
        _, pt = _tables(n=60, seed=24)
        seen = {}

        def probe(t):
            seen["cols"] = list(t.column_names)
            assert "features" in t.column_names
            return t

        pm = Pipeline(stages=[
            Featurize(featureColumns=["num1", "num2"], numberOfFeatures=4),
            PB.DropColumns(cols=["icol"]),
            PB.Lambda(transformFunc=probe),
            PB.DropColumns(cols=["label"]),
        ]).fit(pt)
        assert "features" in seen["cols"]
        assert "features" in pm.transform(pt).column_names

    def test_fit_prunes_but_models_identical(self):
        from mmlspark_tpu_torch.automl.featurize import Featurize
        from mmlspark_tpu_torch.core.stage import Pipeline
        _, pt = _tables(n=120, seed=22)
        pipe = Pipeline(stages=[
            Featurize(featureColumns=FEATURE_COLS, numberOfFeatures=8),
            TPULogisticRegression(featuresCol="features", labelCol="label",
                                  maxIter=5, device="cpu")])
        pm = pipe.fit(pt)
        _, scoring = _tables(n=50, seed=23)
        out = pm.transform(scoring)
        fm = pipe.get_stages()[0].fit(pt)
        lr = pipe.get_stages()[1].fit(fm.transform(pt))
        ref = lr.transform(fm.transform(scoring))
        _assert_equal(ref, out, ["features", "prediction", "probability"])


# ---------------------------------------------------------------------------
# DeviceTable
# ---------------------------------------------------------------------------


class TestDeviceTable:
    def _pm(self, tmp_path, seed):
        jt, pt = _tables(n=60, seed=seed)
        return _carry(_fit_logistic(jt).get_stages(), tmp_path), pt

    def test_columns_ship_once_across_transforms(self, tmp_path):
        pm, pt = self._pm(tmp_path, 30)
        fused = _fused(pm)
        fused.transform(pt)
        plan = fused.plan_for(pt.schema)
        ships1 = plan.device_table.stats()["column_ships"]
        fused.transform(pt)
        stats = plan.device_table.stats()
        assert stats["column_ships"] == ships1, \
            "same table re-shipped columns"
        assert stats["column_hits"] > 0
        assert fused.resident_bytes() > 0

    def test_consts_invalidate_on_stage_mutation(self, tmp_path):
        pm, pt = self._pm(tmp_path, 31)
        fused = _fused(pm)
        out1 = fused.transform(pt)
        scaler_model, lr_model = pm.get_stages()[1], pm.get_stages()[2]
        plan = fused.plan_for(pt.schema)
        w = {k: np.array(v) for k, v in lr_model.get("weights").items()}
        w["b"][1] += 5.0   # shift ONE class bias -> probabilities move
        lr_model.set("weights", w)
        ep_before = FZ.stage_epoch(scaler_model)
        out2 = fused.transform(pt)
        assert not np.allclose(np.asarray(out1["probability"]),
                               np.asarray(out2["probability"]))
        np.testing.assert_array_equal(pm.transform(pt)["prediction"],
                                      out2["prediction"])
        assert FZ.stage_epoch(lr_model) > 0
        assert FZ.stage_epoch(scaler_model) == ep_before
        # the epoch keys the plan: the stale plan (and its device
        # state) is gone, its first-run count retired, not lost
        assert fused.plan_for(pt.schema) is not plan
        assert fused.jit_cache_misses == 2

    def test_zero_steady_state_recompiles(self, tmp_path):
        pm, pt = self._pm(tmp_path, 32)
        fused = _fused(pm)
        fused.transform(pt)
        misses = fused.jit_cache_misses
        assert misses == 1
        for _ in range(3):
            fused.transform(pt)
        assert fused.jit_cache_misses == misses
        small = pt.slice(0, 32)
        fused.transform(small)
        assert fused.jit_cache_misses == misses + 1
        fused.transform(small)
        assert fused.jit_cache_misses == misses + 1

    def test_quantize_returns_int8_pipeline(self, tmp_path):
        pm, pt = self._pm(tmp_path, 33)
        fused = _fused(pm)
        q = fused.quantize(pt.slice(0, 40))
        assert q.precision == "int8" and fused.precision == "f32"
        out_q = q.transform(pt)
        out = fused.transform(pt)
        _assert_equal(out_q, q.transform_staged(pt),
                      ["probability", "prediction"])
        agree = float((np.asarray(out_q["prediction"])
                       == np.asarray(out["prediction"])).mean())
        assert agree >= 0.9, agree

    def test_waiting_parts_raise_naming_their_item(self, tmp_path):
        pm, pt = self._pm(tmp_path, 34)
        fused = _fused(pm)
        with pytest.raises(NotImplementedError, match="Device pipeline"):
            fused.shard(None)
        with pytest.raises(NotImplementedError, match="Device pipeline"):
            FZ.SegmentSharding(None)
        seg = fused.plan_for(pt.schema).segments[0]
        with pytest.raises(NotImplementedError, match="Device pipeline"):
            seg.install_aot({})
        assert fused.aot is False


# ---------------------------------------------------------------------------
# serving integration
# ---------------------------------------------------------------------------


def _post(address, payload, timeout=15):
    req = urllib.request.Request(
        address, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _req_table(payloads):
    reqs = [{"entity": json.dumps(p).encode()} for p in payloads]
    return DataTable({"id": [str(i) for i in range(len(reqs))],
                      "request": reqs})


EXAMPLE = {"num1": [0.1], "num2": [1.0], "icol": [2], "cat": ["lvl3"],
           "toks": [["w1", "w2"]]}


class TestFusedServing:
    def test_pipeline_scoring_end_to_end(self, tmp_path):
        jt, _ = _tables(n=200, seed=40)
        jpm = _fit_logistic(jt)
        pm = _carry(jpm.get_stages(), tmp_path)
        scorer = json_scoring_pipeline(_fused(pm, batch_size=32))
        compiles = scorer.warmup(EXAMPLE)
        assert compiles == len(scorer.scorer.fused.bucket_sizes())
        assert scorer.warmup(EXAMPLE) == 0   # idempotent: fully warm
        m0 = scorer.jit_cache_miss_count()
        rt0 = scorer.scorer.device_roundtrips
        b0 = scorer.scorer.batches_scored
        engine = serve_model(scorer, port=0, batch_size=32, workers=2)
        try:
            payload = {"num1": 0.4, "num2": float("nan"), "icol": 1,
                       "cat": "lvl7", "toks": ["w3", "w9"]}
            replies = [_post(engine.source.address, payload)
                       for _ in range(6)]
            assert all("prediction" in r for r in replies)
            row = {k: [v] for k, v in payload.items()}
            expect = float(np.asarray(_fused(pm).transform(
                DataTable(row))["prediction"])[0])
            assert all(float(r["prediction"]) == expect for r in replies)
            jexpect = float(np.asarray(jpm.fused().transform(
                JTable(row))["prediction"])[0])
            assert expect == jexpect
        finally:
            engine.stop()
        assert scorer.jit_cache_miss_count() == m0, \
            "steady-state serving met a first-run shape"
        trips = scorer.scorer.device_roundtrips - rt0
        assert trips == scorer.scorer.batches_scored - b0 > 0

    def test_pipeline_model_is_fused_on_the_card_by_default(self):
        pm = PipelineModel(stages=[])
        try:
            import torch
            has_card = torch.cuda.is_available()
        except ImportError:
            has_card = False
        if has_card:
            assert json_scoring_pipeline(pm).scorer.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                json_scoring_pipeline(pm)


class TestFusedScorerEdges:
    def test_host_only_pipeline_single_run(self):
        calls = {"n": 0}

        def score(t):
            calls["n"] += 1
            return t.with_column(
                "prediction", np.asarray(t["x"], np.float64) * 2.0)

        pm = PipelineModel(stages=[PB.Lambda(transformFunc=score)])
        scorer = json_scoring_pipeline(_fused(pm, batch_size=16))
        out = scorer.scorer.transform(_req_table([{"x": 3.0}]))
        assert out["reply"][0] == {"prediction": 6}
        assert calls["n"] == 1, "host-only pipeline ran twice per batch"

    def test_late_json_key_is_not_dropped(self, tmp_path):
        jt, _ = _tables(n=100, seed=50)
        jpm = JPipeline(stages=[
            JD.CleanMissingData(inputCols=["num2"], outputCols=["num2"]),
            JD.FastVectorAssembler(inputCols=["num1", "num2"],
                                   outputCol="fv"),
            JLinR(featuresCol="fv", labelCol="label", maxIter=5),
        ]).fit(jt)
        pm = _carry(jpm.get_stages(), tmp_path)
        sc = json_scoring_pipeline(_fused(pm, batch_size=16)).scorer
        with pytest.raises(Exception):
            sc.transform(_req_table([{"num1": 1.0}]))
        o1 = sc.transform(_req_table([{"num1": 1.0, "num2": 0.0}]))
        o2 = sc.transform(_req_table([{"num1": 1.0, "num2": 9.0}]))
        assert o1["reply"][0]["prediction"] != \
            o2["reply"][0]["prediction"], \
            "late-appearing JSON key was silently dropped"

    def test_multi_segment_tail_zero_steady_state_recompiles(self,
                                                            tmp_path):
        jt, _ = _tables(n=150, seed=51)

        def rename(t):
            return t.with_column(
                "fx", np.asarray(t["features"], np.float32))

        jpm = JPipeline(stages=[
            JFeaturize(featureColumns=["num1", "num2"],
                       numberOfFeatures=8),
            JB.Lambda(transformFunc=rename),
            JD.StandardScaler(inputCol="fx", outputCol="fx"),
            JLogR(featuresCol="fx", labelCol="label", maxIter=5),
        ]).fit(jt)
        pm = _carry(jpm.get_stages(), tmp_path)
        scorer = json_scoring_pipeline(_fused(pm, batch_size=16))
        sc = scorer.scorer
        scorer.warmup({"num1": [0.1], "num2": [0.2]})
        m0 = scorer.jit_cache_miss_count()
        for size in (1, 3, 5, 7, 2, 6):
            rows = [{"num1": 0.1 * i, "num2": 0.2} for i in range(size)]
            out = sc.transform(_req_table(rows))
            assert len(out["reply"]) == size
            want = _fused(pm).transform(DataTable(
                {"num1": [r["num1"] for r in rows],
                 "num2": [r["num2"] for r in rows]}))["prediction"]
            assert [r["prediction"] for r in out["reply"]] == \
                [int(v) for v in want]
        assert scorer.jit_cache_miss_count() == m0, \
            "ragged batch sizes met first-run shapes in a tail segment"

    def test_vector_reply_column(self, tmp_path):
        jt, _ = _tables(n=100, seed=52)
        pm = _carry(_fit_logistic(jt).get_stages(), tmp_path)
        scorer = json_scoring_pipeline(_fused(pm, batch_size=16),
                                       reply_col="probability",
                                       reply_field="probs")
        row = {"num1": 0.3, "num2": 0.1, "icol": 1, "cat": "lvl2",
               "toks": ["w1"]}
        out = scorer.scorer.transform(_req_table([row]))
        probs = out["reply"][0]["probs"]
        assert isinstance(probs, list) and len(probs) == 2
        assert abs(sum(probs) - 1.0) < 1e-5
        want = _fused(pm).transform(
            DataTable({k: [v] for k, v in row.items()}))["probability"][0]
        assert probs == [float(x) for x in want]

    def test_drift_monitor_rejected_for_pipelines(self, tmp_path):
        jt, _ = _tables(n=60, seed=53)
        pm = _carry(_fit_logistic(jt).get_stages(), tmp_path)
        dm = DriftMonitor(np.zeros(3), np.ones(3))
        with pytest.raises(ValueError, match="drift_monitor"):
            json_scoring_pipeline(_fused(pm), drift_monitor=dm)
        with pytest.raises(ValueError, match="drift_monitor"):
            json_scoring_pipeline(pm, drift_monitor=dm)


# ---------------------------------------------------------------------------
# the port's static checks (testing/fusion_check.py)
# ---------------------------------------------------------------------------


def _bad_item(consts, env):
    x = env["a"]
    return {"out": x + x.sum().item()}


def _bad_cpu(consts, env):
    return {"out": env["a"].cpu() + consts["b"]}


def _bad_branch(consts, env):
    y = env["a"] * 2
    if y.max() > 0:
        return {"out": y}
    return {"out": float(consts["b"]) + y}


def _bad_numpy(consts, env):
    return {"out": np.asarray(env["a"]) + 1}


def _ok_kernel(consts, env):
    x = env["a"]
    n = x.shape[0]
    if n > 8 and x.ndim == 2:
        x = x[:8]
    return {"out": x + consts["b"][0], "n": int(len(x))}


def _check(fn):
    lines, first = inspect.getsourcelines(fn)
    return CHK.check_op_source(fn.__name__,
                               textwrap.dedent("".join(lines)), first,
                               lines)


class TestStaticChecks:
    def test_shipped_device_ops_are_clean(self):
        n = CHK.register_representative_pipelines()
        n += CHK.register_known_callees()
        assert n >= 15, "every fusable stage family and the callees"
        assert CHK.check_registered_kernels() == []

    @pytest.mark.parametrize("fn,what", [
        (_bad_item, ".item"), (_bad_cpu, ".cpu"),
        (_bad_branch, "branch on a tensor"), (_bad_numpy, "np.asarray"),
    ], ids=["item", "cpu", "branch", "numpy"])
    def test_planted_host_sync_is_caught(self, fn, what):
        got = "\n".join(_check(fn))
        assert what in got, got
        if fn is _bad_branch:
            assert "float()" in got, got

    def test_metadata_reads_are_not_flagged(self):
        assert _check(_ok_kernel) == []
