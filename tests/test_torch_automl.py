"""PyTorch port: the AutoML layer (``automl/{featurize,statistics,train,
tuning}.py``) against the JAX package, on the CPU.

The scenarios of ``tests/test_automl.py`` run through both packages on
the same seeded inputs, plus the cross-package save / load of the
fitted AutoML models and ``examples/106_quantile_regression.py``'s flow
through the port. Tolerances, stated:
- host stages bitwise: the featurized matrices (pyarrow and numpy
  hashing paths alike, and ``transform_rowloop``), the Featurize specs,
  label levels, ``ComputeModelStatistics`` rows (ROC and AUC with ties
  included), the search spaces' draws;
- linear weights: rtol 1e-4 / atol 1e-5 of their largest magnitude
  (``tests/test_torch_linear.py``'s rule), selections (``bestParams``)
  equal to the JAX package's on its own fixtures;
- GBDT-backed ``TrainClassifier``: ROADMAP.md §3's forest rule (every
  tree's structure equal, tree 0's thresholds and counts bitwise, leaf
  values to rtol 1e-5), since the features reaching both are bitwise
  equal;
- within the port, batched CV scores equal serial ones at atol 1e-12,
  as ``tests/test_automl.py`` holds the JAX package's vmap path.
The JAX package counts jit traces of its batched trials
(``trial_trace_counts``); the port traces nothing, so its counterpart
of ``test_zero_retrace_on_repeated_sweeps`` holds the dispatch count
constant across repeated sweeps instead.
"""

import itertools
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mmlspark_tpu import automl as JA
from mmlspark_tpu.core import metrics as JMC
from mmlspark_tpu.core.stage import load_stage as jload_stage
from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.gbdt import TPUBoostClassifier as JGBC
from mmlspark_tpu.gbdt import TPUBoostRegressor as JGBR
from mmlspark_tpu.models import linear as JL

import mmlspark_tpu_torch.automl as PA
from mmlspark_tpu_torch.core import metrics as PMC
from mmlspark_tpu_torch.core.metrics import automl_histograms
from mmlspark_tpu_torch.core.sparse import CSRMatrix
from mmlspark_tpu_torch.core.stage import load_stage as pload_stage
from mmlspark_tpu_torch.core.table import DataTable as PTable
from mmlspark_tpu_torch.gbdt import TPUBoostClassifier as PGBC
from mmlspark_tpu_torch.gbdt import TPUBoostRegressor as PGBR
from mmlspark_tpu_torch.io.ooc import ChunkedTable
from mmlspark_tpu_torch.models import linear as PL

REPO = Path(__file__).resolve().parents[1]
STRUCTURE = ("feature", "bin_threshold", "left", "right", "is_leaf")


def _assert_forest_rule(tb, jb):
    """ROADMAP.md §3's rule for forests grown from the same inputs."""
    assert tb.num_trees == jb.num_trees
    for k in STRUCTURE:
        np.testing.assert_array_equal(tb.trees[k], jb.trees[k], err_msg=k)
    for k in ("threshold", "count"):
        np.testing.assert_array_equal(tb.trees[k][0], jb.trees[k][0],
                                      err_msg=f"tree 0 {k}")
    np.testing.assert_allclose(tb.trees["value"], jb.trees["value"],
                               rtol=1e-5, atol=1e-7)


def _assert_weights_close(p, j, keys):
    scale = max(float(np.abs(np.asarray(j[k])).max()) for k in keys)
    for k in keys:
        np.testing.assert_allclose(p[k], j[k], rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=k)


def _same_array(p, j):
    if isinstance(j, np.ndarray):
        assert isinstance(p, np.ndarray) and p.dtype == j.dtype
        np.testing.assert_array_equal(p, j)
    else:
        assert isinstance(p, CSRMatrix) and p.shape == j.shape
        for k in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(getattr(p, k), getattr(j, k))


def mixed_cols():
    rng = np.random.default_rng(0)
    n = 200
    x1 = rng.normal(size=n)
    x1[:5] = np.nan
    color = [["red", "green", "blue"][i % 3] for i in range(n)]
    y = (np.nan_to_num(x1) + (np.arange(n) % 3 == 0) > 0.3).astype(float)
    return {"x1": x1, "color": color,
            "label": ["pos" if v else "neg" for v in y]}, y


def adversarial_cols(n=400, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    x[rng.random(n) < 0.1] = np.nan
    x[rng.random(n) < 0.02] = np.inf
    x[rng.random(n) < 0.02] = -np.inf
    levels = ["alpha", "beta", "gamma", "delta"]
    color = [levels[i] if i < len(levels) else None
             for i in rng.integers(0, 6, n)]
    words = [f"tok{i:02d}" for i in range(40)]
    toks = []
    for ln in rng.integers(0, 7, n):
        row = [words[j] for j in rng.integers(0, 40, ln)]
        row += row[:2]
        toks.append(row if ln else [])
    toks[0] = None
    toks[1] = [1, 2, 1]
    return {"x": x, "color": color, "toks": toks,
            "v": rng.normal(size=(n, 2)).astype(np.float32),
            "i": rng.integers(0, 3, n).astype(np.int64)}


def class_cols(n=600, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    return {"features": X,
            "label": (X[:, 0] + X[:, 1] > 0).astype(np.float64)}


def lr_space(pkg):
    return (pkg.HyperparamBuilder()
            .add_hyperparam("stepSize", pkg.RangeHyperParam(0.05, 1.0,
                                                            log=True))
            .add_hyperparam("regParam", pkg.RangeHyperParam(1e-5, 1e-2,
                                                            log=True))
            .build())


# ---------------------------------------------------------------------------
# Featurize
# ---------------------------------------------------------------------------

FEATURIZE = {
    "mixed": (lambda: mixed_cols()[0], dict(featureColumns=["x1", "color"])),
    "one_hot": (lambda: mixed_cols()[0],
                dict(featureColumns=["x1", "color"],
                     oneHotEncodeCategoricals=True)),
    "tokens": (lambda: {"toks": [["a", "b"], ["b"]], "label": [0.0, 1.0]},
               dict(featureColumns=["toks"], numberOfFeatures=16)),
    "vector": (lambda: {"v": np.eye(3), "x": [1.0, 2.0, 3.0]},
               dict(featureColumns=["v", "x"])),
    "adversarial": (adversarial_cols,
                    dict(featureColumns=["x", "color", "toks", "v", "i"],
                         numberOfFeatures=32)),
    "adversarial_one_hot": (lambda: adversarial_cols(seed=4),
                            dict(featureColumns=["x", "color", "toks"],
                                 numberOfFeatures=32,
                                 oneHotEncodeCategoricals=True)),
    "sparse": (lambda: adversarial_cols(seed=6),
               dict(featureColumns=["x", "color", "toks"], sparse=True)),
    "sparse_narrow": (lambda: adversarial_cols(seed=7),
                      dict(featureColumns=["toks"], numberOfFeatures=64,
                           sparse=True)),
    "all_columns": (lambda: adversarial_cols(seed=8),
                    dict(numberOfFeatures=8)),
}


@pytest.mark.parametrize("arrow", [True, False], ids=["pyarrow", "numpy"])
@pytest.mark.parametrize("name", sorted(FEATURIZE))
def test_featurize_matches_jax_and_the_rowloop(name, arrow, monkeypatch):
    make, kw = FEATURIZE[name]
    cols = make()
    jm = JA.Featurize(**kw).fit(JTable(cols))
    ref = jm.transform(JTable(cols))["features"]
    if not arrow:
        monkeypatch.setitem(sys.modules, "pyarrow", None)
    pm = PA.Featurize(**kw).fit(PTable(cols))
    assert pm.get("specs") == jm.get("specs")
    out = pm.transform(PTable(cols))
    _same_array(out["features"], ref)
    _same_array(pm.transform_rowloop(PTable(cols))["features"], ref)
    assert out.schema["features"].meta == \
        jm.transform(JTable(cols)).schema["features"].meta


def test_featurize_reference_shapes_hold_in_the_port():
    cols, _ = mixed_cols()
    f = PA.Featurize(featureColumns=["x1", "color"]).fit(
        PTable(cols)).transform(PTable(cols))["features"]
    assert f.shape == (200, 2) and np.isfinite(f).all()
    f = PA.Featurize(featureColumns=["toks"], numberOfFeatures=16).fit(
        PTable({"toks": [["a", "b"], ["b"]]})).transform(
        PTable({"toks": [["a", "b"], ["b"]]}))["features"]
    assert f.shape == (2, 16) and f[0].sum() == 2.0
    sparse = PA.Featurize(featureColumns=["toks"], sparse=True).fit(
        PTable({"toks": [["a"], ["b"]]})).transform(
        PTable({"toks": [["a"], ["b"]]}))["features"]
    assert isinstance(sparse, CSRMatrix) and sparse.shape == (2, 1 << 18)


def test_featurize_unseen_levels_at_transform_match_jax():
    cols = adversarial_cols(seed=5)
    head = {c: (v[:50] if not isinstance(v, np.ndarray) else v[:50])
            for c, v in cols.items()}
    for onehot in (False, True):
        kw = dict(featureColumns=["x", "color", "toks"],
                  numberOfFeatures=16, oneHotEncodeCategoricals=onehot)
        pm = PA.Featurize(**kw).fit(PTable(head))
        jm = JA.Featurize(**kw).fit(JTable(head))
        _same_array(pm.transform(PTable(cols))["features"],
                    jm.transform(JTable(cols))["features"])


def test_fit_levels_match_distinct_values():
    cols = adversarial_cols(seed=7)
    spec = PA.Featurize(featureColumns=["color"]).fit(
        PTable(cols)).get("specs")[0]
    assert spec["levels"] == sorted(v for v in set(cols["color"])
                                    if v is not None)


def test_assemble_features_matches_jax():
    cols = adversarial_cols(seed=9)
    kw = dict(columnsToFeaturize=["x", "toks"], featuresCol="f",
              numberOfFeatures=8)
    p = PA.AssembleFeatures(**kw).fit(PTable(cols)).transform(PTable(cols))
    j = JA.AssembleFeatures(**kw).fit(JTable(cols)).transform(JTable(cols))
    _same_array(p["f"], j["f"])


def test_featurize_observes_its_histograms():
    hists = automl_histograms()
    before = (hists["featurize_fit"].summary()["count"],
              hists["featurize_transform"].summary()["count"])
    cols = adversarial_cols()
    PA.Featurize(featureColumns=["x"]).fit(PTable(cols)).transform(
        PTable(cols))
    assert hists["featurize_fit"].summary()["count"] == before[0] + 1
    assert hists["featurize_transform"].summary()["count"] == before[1] + 1


def test_featurize_on_chunked_tables_raises():
    """A ChunkedTable raised here until 'Out-of-core ingest' was ported:
    Featurize now fits it in one streamed pass and its model maps it
    chunk by chunk, equal to the in-memory fit and transform."""
    x = np.arange(10.0)
    x[3] = np.nan
    t = PTable({"x": x})
    chunked = ChunkedTable.from_table(t, chunk_rows=4)
    streamed = PA.Featurize(featureColumns=["x"]).fit(chunked)
    model = PA.Featurize(featureColumns=["x"]).fit(t)
    assert streamed.get("specs") == model.get("specs")
    np.testing.assert_array_equal(
        model.transform(chunked).materialize()["features"],
        model.transform(t)["features"])


# ---------------------------------------------------------------------------
# TrainClassifier / TrainRegressor
# ---------------------------------------------------------------------------

def test_train_classifier_gbdt_string_labels_match_jax():
    """The reference's scenario (200 rows, x1 and a 3-level color): its
    pure late leaves split at gains of ~1e-5 in both packages, ties that
    f32 rounding breaks either way (ROADMAP.md §3), so trees are held on
    the fixture below and the predictions here."""
    cols, y = mixed_cols()
    kw = dict(numIterations=15, minDataInLeaf=5)
    pm = PA.TrainClassifier(labelCol="label",
                            model=PGBC(device="cpu", **kw)).fit(PTable(cols))
    jm = JA.TrainClassifier(labelCol="label", model=JGBC(**kw)).fit(
        JTable(cols))
    assert pm.get("levels") == jm.get("levels") == ["neg", "pos"]
    assert pm.get("featurizer").get("specs") == \
        jm.get("featurizer").get("specs")
    out = pm.transform(PTable(cols))
    pl, jl = list(out["scored_labels"]), list(
        jm.transform(JTable(cols))["scored_labels"])
    assert np.mean([a == b for a, b in zip(pl, jl)]) >= 0.99
    assert "TrainClassifier_features" not in out.column_names
    acc = np.mean([(s == "pos") == bool(v) for s, v in zip(pl, y)])
    assert acc > 0.95


def higgs_cols(n=3000, seed=7):
    """tests/test_gbdt_dist_quant.py's HIGGS-shaped generator as table
    columns (8 of the 28 features, a 4-level string of feature 5's
    quartile) with a string label."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 28)).astype(np.float32)
    logit = (X[:, 0] + 0.6 * X[:, 1] * X[:, 2]
             + 0.4 * np.sin(2 * X[:, 3]) - 0.3 * X[:, 4] ** 2 + 0.3
             + 0.5 * X[:, 5])
    y = logit + rng.normal(scale=0.5, size=n) > 0
    cols = {f"f{i}": X[:, i] for i in range(8) if i != 5}
    cols["grp"] = [["q0", "q1", "q2", "q3"][k] for k in
                   np.searchsorted(np.quantile(X[:, 5], [.25, .5, .75]),
                                   X[:, 5])]
    cols["label"] = np.where(y, "s", "b").tolist()
    return cols


def test_train_classifier_gbdt_follows_the_forest_rule():
    cols = higgs_cols()
    kw = dict(numIterations=5, numLeaves=15)
    pm = PA.TrainClassifier(labelCol="label", numFeatures=16,
                            model=PGBC(device="cpu", **kw)).fit(PTable(cols))
    jm = JA.TrainClassifier(labelCol="label", numFeatures=16,
                            model=JGBC(**kw)).fit(JTable(cols))
    assert pm.get("levels") == jm.get("levels") == ["b", "s"]
    _assert_forest_rule(pm.get("innerModel").get_booster(),
                        jm.get("innerModel").get_booster())
    p = pm.transform(PTable(cols))
    j = jm.transform(JTable(cols))
    np.testing.assert_allclose(p["probability"], j["probability"],
                               rtol=1e-5, atol=1e-6)
    assert list(p["scored_labels"]) == list(j["scored_labels"])


def test_train_classifier_device_reaches_the_default_gbdt():
    tc = PA.TrainClassifier(labelCol="label", device="cpu")
    m = tc._get_model()
    assert isinstance(m, PGBC) and m.get("device") == "cpu"
    assert PA.TrainClassifier()._get_model().get("device") == "cuda"
    own = PGBC(device="cpu")
    assert PA.TrainClassifier(model=own)._get_model() is own
    assert PA.TrainRegressor(device="cpu")._get_model().get("device") == "cpu"


def test_train_classifier_default_raises_without_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cols, _ = mixed_cols()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PA.TrainClassifier(labelCol="label").fit(PTable(cols))


def test_train_classifier_default_gbdt_on_the_cpu():
    cols, y = mixed_cols()
    out = PA.TrainClassifier(labelCol="label", device="cpu").fit(
        PTable(cols)).transform(PTable(cols))
    assert set(out["scored_labels"]) <= {"pos", "neg"}


@pytest.mark.parametrize("sparse_table", [False, True],
                         ids=["dense", "numeric_labels"])
def test_train_classifier_logistic_backend_matches_jax(sparse_table):
    cols, y = mixed_cols()
    if sparse_table:      # numeric 0/1 labels: no reindexing
        cols = dict(cols, label=y)
    pm = PA.TrainClassifier(labelCol="label", model=PL.TPULogisticRegression(
        device="cpu")).fit(PTable(cols))
    jm = JA.TrainClassifier(labelCol="label",
                            model=JL.TPULogisticRegression()).fit(
        JTable(cols))
    assert pm.get("levels") == jm.get("levels")
    _assert_weights_close(pm.get("innerModel").get("weights"),
                          jm.get("innerModel").get("weights"), ("W", "b"))
    pl = list(pm.transform(PTable(cols))["scored_labels"])
    jl = list(jm.transform(JTable(cols))["scored_labels"])
    assert np.mean([a == b for a, b in zip(pl, jl)]) >= 0.999
    ok = [(s == "pos") == bool(v) if isinstance(s, str) else s == v
          for s, v in zip(pl, y)]
    assert np.mean(ok) > 0.8


def test_train_regressor_matches_jax():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(300, 3))
    y = X @ np.asarray([1.0, -2.0, 0.5]) + 0.1 * rng.normal(size=300)
    cols = {"f0": X[:, 0], "f1": X[:, 1], "f2": X[:, 2], "label": y}
    kw = dict(numIterations=20, minDataInLeaf=5)
    pm = PA.TrainRegressor(labelCol="label", model=PGBR(device="cpu", **kw)
                           ).fit(PTable(cols))
    jm = JA.TrainRegressor(labelCol="label", model=JGBR(**kw)).fit(
        JTable(cols))
    # tree 0 by the rule; two later splits of this 300-row forest (trees
    # 13 and 17) pick another bin of the same feature at a gain ~1e-6
    # apart, with equal node counts (ROADMAP.md §3's near ties), so the
    # forest is held by its predictions
    tb, jb = (m.get("innerModel").get_booster() for m in (pm, jm))
    for k in STRUCTURE + ("threshold", "count"):
        np.testing.assert_array_equal(tb.trees[k][0], jb.trees[k][0],
                                      err_msg=k)
    pred = pm.transform(PTable(cols))["prediction"]
    np.testing.assert_allclose(pred, jm.transform(JTable(cols))["prediction"],
                               rtol=1e-5, atol=1e-5)
    assert 1 - ((pred - y) ** 2).mean() / y.var() > 0.8


def test_train_regressor_linear_backend_matches_jax():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(200, 2))
    y = X @ np.asarray([2.0, -1.0])
    cols = {"f0": X[:, 0], "f1": X[:, 1], "label": y}
    pm = PA.TrainRegressor(labelCol="label", model=PL.TPULinearRegression(
        device="cpu")).fit(PTable(cols))
    jm = JA.TrainRegressor(labelCol="label",
                           model=JL.TPULinearRegression()).fit(JTable(cols))
    _assert_weights_close(pm.get("innerModel").get("weights"),
                          jm.get("innerModel").get("weights"), ("w", "b"))
    pred = pm.transform(PTable(cols))["prediction"]
    assert 1 - ((pred - y) ** 2).mean() / y.var() > 0.95


def _fitted(pkg_name, backend):
    cols, _ = mixed_cols()
    if pkg_name == "jax":
        model = (JGBC(numIterations=5, minDataInLeaf=5) if backend == "gbdt"
                 else JL.TPULogisticRegression(maxIter=50))
        return JA.TrainClassifier(labelCol="label", model=model).fit(
            JTable(cols)), cols
    model = (PGBC(numIterations=5, minDataInLeaf=5, device="cpu")
             if backend == "gbdt"
             else PL.TPULogisticRegression(maxIter=50, device="cpu"))
    return PA.TrainClassifier(labelCol="label", model=model).fit(
        PTable(cols)), cols


@pytest.mark.parametrize("backend", ["gbdt", "logistic"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_trained_classifier_crosses_packages(tmp_path, direction, backend):
    path = str(tmp_path / "tc")
    if direction == "jax_to_port":
        src, cols = _fitted("jax", backend)
        src.save(path)
        loaded = pload_stage(path)
        assert isinstance(loaded, PA.TrainedClassifierModel)
        if backend == "gbdt":
            loaded.get("innerModel").set("device", "cpu")
        got, ref = loaded.transform(PTable(cols)), src.transform(JTable(cols))
    else:
        src, cols = _fitted("port", backend)
        src.save(path)
        loaded = jload_stage(path)
        assert isinstance(loaded, JA.TrainedClassifierModel)
        got, ref = loaded.transform(JTable(cols)), src.transform(PTable(cols))
    assert list(got["scored_labels"]) == list(ref["scored_labels"])
    np.testing.assert_allclose(got["probability"], ref["probability"],
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# ComputeModelStatistics / ComputePerInstanceStatistics
# ---------------------------------------------------------------------------

def scored_binary(n=200, seed=0, ties=False):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) > 0.5).astype(float)
    p = np.clip(y * 0.8 + rng.random(n) * 0.3, 0, 1)
    if ties:
        p = np.round(p, 1)
    return {"label": y, "prediction": (p > 0.5).astype(float),
            "probability": np.stack([1 - p, p], axis=1)}


STATS = {
    "binary": (scored_binary, {}),
    "binary_ties": (lambda: scored_binary(seed=3, ties=True), {}),
    "binary_list_probs": (lambda: dict(scored_binary(seed=4), probability=[
        list(r) for r in scored_binary(seed=4)["probability"]]), {}),
    "regression": (lambda: {"label": np.asarray([1.0, 2.0, 3.0, 4.0]),
                            "prediction": np.asarray([1.1, 1.9, 3.1, 3.9])},
                   {"evaluationMetric": "regression"}),
    "auto_regression": (lambda: (lambda y: {"label": y, "prediction": y})(
        np.random.default_rng(0).normal(size=300)), {}),
    "phantom_classes": (lambda: {"label": [1.0, 1.0, 2.0, 2.0],
                                 "prediction": [1.0, 1.0, 2.0, 2.0]},
                        {"evaluationMetric": "classification"}),
    "multiclass": (lambda: (lambda r: {
        "label": r.integers(0, 4, 100).astype(float),
        "prediction": r.integers(0, 4, 100).astype(float)})(
        np.random.default_rng(2)), {"evaluationMetric": "all"}),
}


@pytest.mark.parametrize("name", sorted(STATS))
def test_model_statistics_match_jax(name):
    make, kw = STATS[name]
    cols = make()
    p = PA.ComputeModelStatistics(**kw).transform(PTable(cols)).row(0)
    j = JA.ComputeModelStatistics(**kw).transform(JTable(cols)).row(0)
    assert p.keys() == j.keys()
    for k in j:
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    if name == "phantom_classes":
        assert p[PMC.PRECISION] == p[PMC.RECALL] == 1.0


def test_reference_statistics_hold_in_the_port():
    row = PA.ComputeModelStatistics().transform(PTable(scored_binary())).row(0)
    assert 0.9 < row[PMC.ACCURACY] <= 1.0 and 0.9 < row[PMC.AUC] <= 1.0
    assert row[PMC.CONFUSION_MATRIX].shape == (2, 2)
    with pytest.raises(ValueError, match="negative"):
        PA.ComputeModelStatistics(evaluationMetric="classification") \
            .transform(PTable({"label": [-1.0, 1.0],
                               "prediction": [1.0, 1.0]}))


def test_roc_curve_ties_match_jax_and_do_not_depend_on_order():
    from mmlspark_tpu.automl.statistics import roc_curve as jroc
    from mmlspark_tpu_torch.automl.statistics import roc_curve as proc
    y = np.asarray([0.0, 1.0])
    s = np.asarray([0.5, 0.5])
    assert proc(y, s)[2] == proc(y[::-1].copy(), s[::-1].copy())[2] == 0.5
    rng = np.random.default_rng(6)
    y = (rng.random(500) < 0.4).astype(float)
    s = np.round(rng.random(500) * 0.5 + y * 0.3, 2)
    for a, b in zip(proc(y, s), jroc(y, s)):
        np.testing.assert_array_equal(a, b)
    perm = rng.permutation(500)
    assert proc(y[perm], s[perm])[2] == proc(y, s)[2]


def test_roc_table_and_per_instance_match_jax():
    cols = scored_binary()
    for n_bins in (10, 1000):
        p = PA.ComputeModelStatistics(numBins=n_bins).roc_table(PTable(cols))
        j = JA.ComputeModelStatistics(numBins=n_bins).roc_table(JTable(cols))
        for c in ("false_positive_rate", "true_positive_rate"):
            np.testing.assert_array_equal(p[c], j[c])
    assert p["false_positive_rate"][0] == 0.0
    assert p["true_positive_rate"][-1] == 1.0
    for mode, cc in (("auto", cols), ("regression", {
            "label": np.asarray([1.0, 2.0]),
            "prediction": np.asarray([1.5, 2.5])})):
        p = PA.ComputePerInstanceStatistics(evaluationMetric=mode).transform(
            PTable(cc))
        j = JA.ComputePerInstanceStatistics(evaluationMetric=mode).transform(
            JTable(cc))
        for c in j.column_names:
            np.testing.assert_array_equal(p[c], j[c])
    np.testing.assert_allclose(p[PMC.L2_LOSS], [0.25, 0.25])


def test_metric_names_match_jax():
    for name in ("MSE", "RMSE", "R2", "MAE", "AUC", "ACCURACY", "PRECISION",
                 "RECALL", "F1", "CONFUSION_MATRIX", "L1_LOSS", "L2_LOSS",
                 "LOG_LOSS", "ALL_METRICS", "CLASSIFICATION_METRICS",
                 "REGRESSION_METRICS", "CLASSIFICATION_EVALUATION",
                 "REGRESSION_EVALUATION"):
        assert getattr(PMC, name) == getattr(JMC, name), name
    for m in JMC.CLASSIFICATION_METRICS + JMC.REGRESSION_METRICS + [
            JMC.CONFUSION_MATRIX, "nope"]:
        assert PMC.is_classification_metric(m) == \
            JMC.is_classification_metric(m)
        assert PMC.is_regression_metric(m) == JMC.is_regression_metric(m)


# ---------------------------------------------------------------------------
# TuneHyperparameters (test_automl.py's TestBatchedTrials and TestTuning)
# ---------------------------------------------------------------------------

def _ptuner(mode, models=None, space=None, runs=8, folds=3, **kw):
    return PA.TuneHyperparameters(
        models=models or [PL.TPULogisticRegression(maxIter=30,
                                                   device="cpu")],
        paramSpace=PA.RandomSpace(space or lr_space(PA), seed=0),
        evaluationMetric=PMC.ACCURACY, numFolds=folds, numRuns=runs,
        seed=0, batchTrials=mode, **kw)


def _jtuner(mode, space=None, runs=8, folds=3):
    return JA.TuneHyperparameters(
        models=[JL.TPULogisticRegression(maxIter=30)],
        paramSpace=JA.RandomSpace(space or lr_space(JA), seed=0),
        evaluationMetric=JMC.ACCURACY, numFolds=folds, numRuns=runs,
        seed=0, batchTrials=mode)


def test_spaces_draw_the_jax_packages_maps():
    space = {"a": PA.DiscreteHyperParam([1, 2, 3]),
             "b": PA.RangeHyperParam(0.0, 1.0, n_grid=3),
             "c": PA.RangeHyperParam(2, 10),
             "d": PA.RangeHyperParam(1e-3, 1.0, log=True)}
    jspace = {"a": JA.DiscreteHyperParam([1, 2, 3]),
              "b": JA.RangeHyperParam(0.0, 1.0, n_grid=3),
              "c": JA.RangeHyperParam(2, 10),
              "d": JA.RangeHyperParam(1e-3, 1.0, log=True)}
    assert list(PA.GridSpace(space).param_maps()) == \
        list(JA.GridSpace(jspace).param_maps())
    assert len(list(PA.GridSpace(space).param_maps())) == 3 * 3 * 5 * 5
    assert list(itertools.islice(PA.RandomSpace(space, 4).param_maps(), 9)) \
        == list(itertools.islice(JA.RandomSpace(jspace, 4).param_maps(), 9))
    r = PA.RangeHyperParam(2, 10)
    assert isinstance(r.sample(np.random.default_rng(0)), int)
    assert all(isinstance(v, int) for v in r.grid())


def test_batched_matches_serial_and_the_jax_selection():
    t = class_cols()
    tv = _ptuner("auto").fit(PTable(t))
    ts = _ptuner("off").fit(PTable(t))
    jv = _jtuner("auto").fit(JTable(t))
    assert tv.search_info["path"] == "vmap"
    assert ts.search_info["path"] == "serial"
    assert tv.search_info["dispatches"] == 3
    assert tv.get("bestParams") == ts.get("bestParams") == \
        jv.get("bestParams")
    assert tv.get("bestMetric") == ts.get("bestMetric")
    np.testing.assert_allclose(tv.get("bestMetric"), jv.get("bestMetric"),
                               atol=1e-12)


@pytest.mark.parametrize("seed", [1, 2])
def test_batched_per_candidate_scores_match_serial(seed):
    t = PTable(class_cols(seed=seed))
    hv = _ptuner("auto").fit(t).get("history")
    hs = _ptuner("off").fit(t).get("history")
    assert [h["params"] for h in hv] == [h["params"] for h in hs]
    np.testing.assert_allclose([h["metric"] for h in hv],
                               [h["metric"] for h in hs], rtol=0, atol=1e-12)


def test_batched_linear_regression_family_matches_jax():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(500, 5)).astype(np.float32)
    y = (X @ np.asarray([1.0, -2.0, 0.5, 0.0, 3.0],
                        np.float32)).astype(np.float64)

    def tuner(pkg, est, mode):
        return pkg.TuneHyperparameters(
            models=[est], paramSpace=pkg.RandomSpace(lr_space(pkg), seed=0),
            evaluationMetric="rmse", numFolds=3, numRuns=6, seed=0,
            batchTrials=mode)
    tv = tuner(PA, PL.TPULinearRegression(maxIter=40, device="cpu"),
               "auto").fit(PTable({"features": X, "label": y}))
    ts = tuner(PA, PL.TPULinearRegression(maxIter=40, device="cpu"),
               "off").fit(PTable({"features": X, "label": y}))
    jv = tuner(JA, JL.TPULinearRegression(maxIter=40), "auto").fit(
        JTable({"features": X, "label": y}))
    assert tv.search_info["path"] == "vmap"
    assert tv.get("bestParams") == ts.get("bestParams") == \
        jv.get("bestParams")
    np.testing.assert_allclose(tv.get("bestMetric"), ts.get("bestMetric"),
                               rtol=1e-5)
    np.testing.assert_allclose(tv.get("bestMetric"), jv.get("bestMetric"),
                               rtol=1e-4)


def test_maxiter_groups_one_dispatch_each():
    space = dict(lr_space(PA))
    space["maxIter"] = PA.DiscreteHyperParam([10, 20])
    t = PTable(class_cols(seed=3))
    tv = _ptuner("auto", space=space).fit(t)
    ts = _ptuner("off", space=space).fit(t)
    assert tv.search_info["path"] == "vmap"
    assert tv.search_info["groups"] == 2
    assert tv.search_info["dispatches"] == 3 * 2
    assert tv.get("bestParams") == ts.get("bestParams")


def test_sparse_features_fall_back_to_serial():
    rng = np.random.default_rng(4)
    toks = [[f"w{j}" for j in rng.integers(0, 20, 5)] for _ in range(240)]
    y = np.asarray([float(len(set(r)) > 4) for r in toks])
    raw = PTable({"toks": toks, "label": y})
    t = PA.Featurize(featureColumns=["toks"], numberOfFeatures=64,
                     sparse=True).fit(raw).transform(raw)
    assert _ptuner("auto", runs=3).fit(t).search_info["path"] == "serial"


def test_mixed_devices_fall_back_to_serial():
    t = PTable(class_cols(seed=8))
    models = [PL.TPULogisticRegression(maxIter=10, device="cpu"),
              PL.TPULogisticRegression(maxIter=10, device="cuda:0")]
    from mmlspark_tpu_torch.automl.tuning import _batched_trials
    folds = [(t.slice(0, 400), t.slice(400, 600))]
    info = {}
    assert _batched_trials([(m, {}) for m in models], folds, "accuracy",
                           info) is None
    assert info == {}


def test_unbatchable_sweep_falls_back_with_warning():
    t = PTable(class_cols(seed=5))
    space = (PA.HyperparamBuilder()
             .add_hyperparam("numIterations", PA.DiscreteHyperParam([5, 10]))
             .build())
    tuner = PA.TuneHyperparameters(
        models=[PGBC(minDataInLeaf=5, device="cpu")],
        paramSpace=PA.GridSpace(space), evaluationMetric=PMC.ACCURACY,
        numFolds=2, seed=0, batchTrials="on")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("mmlspark_tpu_torch.automl.tuning")
    log.addHandler(handler)
    try:
        tuned = tuner.fit(t)
    finally:
        log.removeHandler(handler)
    assert tuned.search_info["path"] == "serial"
    assert any("cannot be batched" in r.getMessage() for r in records)


def test_batch_trials_off_never_batches():
    tuned = _ptuner("off", runs=2).fit(PTable(class_cols(seed=6)))
    assert tuned.search_info["path"] == "serial"
    assert tuned.search_info["dispatches"] == 0


def test_repeated_sweeps_dispatch_the_same_count():
    """The port's counterpart of ``test_zero_retrace_on_repeated_sweeps``:
    nothing is traced, and a repeated sweep at the same shapes makes the
    same number of batched calls with the same results."""
    t = PTable(class_cols(seed=7))
    first = _ptuner("auto", runs=4).fit(t)
    again = _ptuner("auto", runs=4).fit(t)
    assert first.search_info == again.search_info
    assert first.get("history") == again.get("history")


def test_tune_observes_its_histograms():
    hists = automl_histograms()
    names = ("tune_fold_build", "tune_trials", "tune_refit")
    before = [hists[n].summary()["count"] for n in names]
    _ptuner("auto", runs=2).fit(PTable(class_cols(seed=9)))
    assert [hists[n].summary()["count"] for n in names] == \
        [b + 1 for b in before]


def _gbdt_tune(parallelism, n=150):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, 3))
    t = PTable({"features": X,
                "label": (X[:, 0] + X[:, 1] > 0).astype(float)})
    space = (PA.HyperparamBuilder()
             .add_hyperparam("numIterations", PA.DiscreteHyperParam([3, 8]))
             .add_hyperparam("numLeaves", PA.DiscreteHyperParam([4, 8]))
             .build())
    return PA.TuneHyperparameters(
        models=[PGBC(minDataInLeaf=5, device="cpu")],
        paramSpace=PA.GridSpace(space), evaluationMetric=PMC.ACCURACY,
        numFolds=3, parallelism=parallelism).fit(t), t


def test_gbdt_tune_finds_a_reasonable_model_and_matches_jax():
    tuned, t = _gbdt_tune(2)
    assert tuned.get("bestMetric") > 0.8
    assert len(tuned.get("history")) == 4
    assert "prediction" in tuned.transform(t).column_names
    space = (JA.HyperparamBuilder()
             .add_hyperparam("numIterations", JA.DiscreteHyperParam([3, 8]))
             .add_hyperparam("numLeaves", JA.DiscreteHyperParam([4, 8]))
             .build())
    jt = JA.TuneHyperparameters(
        models=[JGBC(minDataInLeaf=5)], paramSpace=JA.GridSpace(space),
        evaluationMetric=JMC.ACCURACY, numFolds=3, parallelism=2).fit(
        JTable({"features": np.asarray(t["features"]),
                "label": np.asarray(t["label"])}))
    assert tuned.get("bestParams") == jt.get("bestParams")
    np.testing.assert_allclose([h["metric"] for h in tuned.get("history")],
                               [h["metric"] for h in jt.get("history")],
                               atol=1e-12)


def test_four_thread_gbdt_tune_equals_one_thread():
    (t4, _), (t1, _) = _gbdt_tune(4), _gbdt_tune(1)
    assert t4.get("history") == t1.get("history")
    assert t4.get("bestParams") == t1.get("bestParams")
    assert t4.get("bestMetric") == t1.get("bestMetric")


def test_gbdt_module_state_holds_under_threads(monkeypatch):
    """Fits in threads share the hist launch counts and the host binning
    library's one-time typing: 16 threads at a short switch interval
    lose no count, and every thread gets the library typed."""
    import threading
    from mmlspark_tpu_torch.gbdt import hist_kernels as HK
    from mmlspark_tpu_torch.gbdt import native_bins as NB
    HK.reset_launches()
    monkeypatch.setattr(NB, "_BOUND", False)
    old = sys.getswitchinterval()
    libs, errors = [], []

    def work():
        try:
            for _ in range(2000):
                HK._count_launch("_hist_kernel", "int8")
            lib = NB._lib()
            assert lib.mml_apply_bins.restype is not None
            libs.append(lib)
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(e)
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert HK.LAUNCHES["_hist_kernel"] == 16 * 2000
    assert HK.LAUNCHES_BY_TYPE["int8"] == 16 * 2000
    assert len(libs) == 16 and NB._BOUND
    HK.reset_launches()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_tuned_model_crosses_packages(tmp_path, direction):
    t = class_cols(seed=4)
    path = str(tmp_path / "tuned")
    if direction == "jax_to_port":
        src = _jtuner("auto", runs=3).fit(JTable(t))
        src.save(path)
        loaded = pload_stage(path)
        assert isinstance(loaded, PA.tuning.TuneHyperparametersModel)
        got, ref = loaded.transform(PTable(t)), src.transform(JTable(t))
    else:
        src = _ptuner("auto", runs=3).fit(PTable(t))
        src.save(path)
        loaded = jload_stage(path)
        got, ref = loaded.transform(JTable(t)), src.transform(PTable(t))
    assert loaded.get("bestParams") == src.get("bestParams")
    assert loaded.get("history") == src.get("history")
    for c in ("probability", "prediction"):
        np.testing.assert_array_equal(got[c], ref[c])


def test_find_best_model_matches_jax():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 3))
    y = (X[:, 0] > 0).astype(float)
    y_bad = np.random.default_rng(1).permutation(y)
    pt = PTable({"features": X, "label": y})
    good = PGBC(numIterations=30, minDataInLeaf=5, device="cpu").fit(pt)
    bad = PGBC(numIterations=5, minDataInLeaf=5, device="cpu").fit(
        PTable({"features": X, "label": y_bad}))
    best = PA.FindBestModel(models=[bad, good],
                            evaluationMetric=PMC.AUC).fit(pt)
    assert best.get("bestModel") is good
    assert len(best.get_evaluation_results()) == 2
    jt = JTable({"features": X, "label": y})
    jgood = JGBC(numIterations=30, minDataInLeaf=5).fit(jt)
    jbad = JGBC(numIterations=5, minDataInLeaf=5).fit(
        JTable({"features": X, "label": y_bad}))
    jbest = JA.FindBestModel(models=[jbad, jgood],
                             evaluationMetric=JMC.AUC).fit(jt)
    np.testing.assert_allclose(
        best.get_evaluation_results()[PMC.AUC],
        jbest.get_evaluation_results()[JMC.AUC], atol=1e-6)
    assert best.get("bestModelMetrics").column_names == \
        jbest.get("bestModelMetrics").column_names


# ---------------------------------------------------------------------------
# rules of the port, and example 106
# ---------------------------------------------------------------------------

def test_automl_imports_and_fits_with_jax_blocked():
    code = """
import sys
sys.modules["jax"] = None
sys.modules["mmlspark_tpu"] = None
import numpy as np
import mmlspark_tpu_torch.automl as A
import mmlspark_tpu_torch.stages, mmlspark_tpu_torch.udfs
import mmlspark_tpu_torch.plot
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.models.linear import TPULogisticRegression
rng = np.random.default_rng(0)
x = rng.normal(size=300)
t = DataTable({"x": x, "c": [["a", "b"][i % 2] for i in range(300)],
               "toks": [["u", "v"][: i % 3] for i in range(300)],
               "label": ["y" if v > 0 else "n" for v in x]})
m = A.TrainClassifier(labelCol="label", numFeatures=8,
                      device="cpu").fit(t)
assert (np.asarray(m.transform(t)["scored_labels"])
        == np.asarray(t["label"])).mean() > 0.9
m = A.TrainClassifier(labelCol="label", numFeatures=8,
                      model=TPULogisticRegression(device="cpu")).fit(t)
assert not any(k.split(".")[0] in ("jax", "mmlspark_tpu")
               for k, v in sys.modules.items() if v is not None)
print("OK")
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(REPO), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OK" in r.stdout


def test_example_106_quantile_regression_through_the_port():
    """``examples/106_quantile_regression.py``'s flow on the port: the
    0.9 quantile of sklearn's bundled diabetes progression, coverage
    within 0.85-0.95, the model-string round trip, and the JAX package
    reading the same model string to the same predictions."""
    datasets = pytest.importorskip("sklearn.datasets")
    from mmlspark_tpu.gbdt import Booster as JBooster
    from mmlspark_tpu_torch.gbdt import Booster
    X, y = datasets.load_diabetes(return_X_y=True)
    table = PTable({"features": X, "label": y})
    model = PGBR(objective="quantile", alpha=0.9, numIterations=100,
                 minDataInLeaf=10, device="cpu").fit(table)
    pred = model.transform(table)["prediction"]
    coverage = (y <= pred).mean()
    assert 0.85 < coverage < 0.95, coverage
    s = model.get_booster().model_to_string()
    reloaded = Booster.from_string(s, device="cpu")
    np.testing.assert_allclose(reloaded.predict(X), pred, atol=1e-6)
    np.testing.assert_allclose(JBooster.from_string(s).predict(X), pred,
                               atol=1e-5)
    imp = model.get_feature_importances("gain")
    assert imp.shape == (10,) and imp.max() > 0
