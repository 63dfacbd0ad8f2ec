"""PyTorch port: GBDT validation, early stopping, warm start and
``boost_more`` against the JAX package, on the CPU.

  - Early stopping: ``best_iteration`` and ``num_trees`` equal to the JAX
    package's, exactly, for early_stopping_round 3, 5 and 10 on the
    regression case of tests/test_gbdt.py:1185-1198 and the
    breast-cancer case of :302-309. The stop decision reads the losses
    every min(esr, 8) iterations, as the JAX engine's chunks do, so a run
    trains the same number of trees past its stop.
  - Warm start from a JAX-trained model string: the base forest carried
    bitwise, the new trees' structure bitwise and their values to rtol
    1e-5 on the HIGGS-shaped fixture (the JAX package's f32 arithmetic
    is XLA's; see test_torch_sampling.py); also with another
    ``num_leaves`` (``_pad_nodes``) and through the estimator's
    ``initModelString``. From an early-stopped base (breast cancer, as
    tests/test_gbdt.py:369): the base's best_iteration trees bitwise, the
    tree count and best_iteration exact.
  - ``boost_more``: retained continuation bitwise equal to one longer run
    (chained, with sampling and with hist_bits 16), single-use; fresh
    data against the frozen mapper equal to the JAX package's.

The breast-cancer fixture has near-tied splits (correlated features):
the last-bit differences of XLA's f32 sums flip some of them from the
first tree on, so on it only the counts, best_iteration and the AUC are
held, and tree structure is pinned on the HIGGS-shaped fixture.
"""

import numpy as np
import pytest

from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.gbdt.booster import train as jtrain
from mmlspark_tpu.gbdt.estimators import TPUBoostClassifier as JClassifier

import mmlspark_tpu_torch as mtt
from mmlspark_tpu_torch.gbdt import booster as booster_mod
from mmlspark_tpu_torch.gbdt.booster import Booster as TBooster
from mmlspark_tpu_torch.gbdt.booster import train as ttrain

ALL_KEYS = ("feature", "bin_threshold", "threshold", "left", "right",
            "value", "is_leaf", "gain", "count")
STRUCT_KEYS = ("feature", "bin_threshold", "left", "right", "is_leaf",
               "count")


@pytest.fixture(scope="module")
def breast_cancer():
    from sklearn.datasets import load_breast_cancer
    return load_breast_cancer(return_X_y=True)


def _split(y):
    idx = np.random.default_rng(0).permutation(len(y))
    return idx[:350], idx[350:]


def _same_forest(a, b, keys=ALL_KEYS):
    assert a.num_trees == b.num_trees
    for k in keys:
        np.testing.assert_array_equal(a.trees[k], b.trees[k], err_msg=k)
    np.testing.assert_array_equal(a.init_score, b.init_score)


def _auc(y, p):
    from sklearn.metrics import roc_auc_score
    return roc_auc_score(y, p)


def _higgs_shape(n=6000, seed=7):
    """The HIGGS-shaped fixture of tests/test_gbdt_dist_quant.py."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 28)).astype(np.float32)
    logit = (X[:, 0] + 0.6 * X[:, 1] * X[:, 2]
             + 0.4 * np.sin(2 * X[:, 3]) - 0.3 * X[:, 4] ** 2 + 0.3)
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def higgs():
    X, y = _higgs_shape()
    return X[:4096], y[:4096], X[4096:], y[4096:]


def _close_forest(port, ref, new_from=0, struct=True):
    """The JAX forest's trees before ``new_from`` bitwise; after it the
    structure bitwise and the values to rtol 1e-5 (``struct``)."""
    assert port.num_trees == ref.num_trees
    for k in ALL_KEYS:
        np.testing.assert_array_equal(port.trees[k][:new_from],
                                      ref.trees[k][:new_from], err_msg=k)
    np.testing.assert_array_equal(port.init_score, ref.init_score)
    if not struct:
        return
    for k in STRUCT_KEYS:
        np.testing.assert_array_equal(port.trees[k], ref.trees[k], err_msg=k)
    np.testing.assert_allclose(port.trees["value"], ref.trees["value"],
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# validation and early stopping
# ---------------------------------------------------------------------------


def _regression_case():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1500, 8))
    y = X[:, 0] * 2 + rng.normal(scale=0.3, size=1500)
    kw = {"objective": "regression", "num_iterations": 200,
          "num_leaves": 7, "learning_rate": 0.3, "min_data_in_leaf": 5}
    return kw, X[:1200], y[:1200], (X[1200:], y[1200:])


def _breast_case(bc):
    X, y = bc
    tr, te = _split(y)
    return ({"objective": "binary", "num_iterations": 500}, X[tr], y[tr],
            (X[te], y[te]))


@pytest.mark.parametrize("esr", [3, 5, 10])
@pytest.mark.parametrize("case", ["regression", "breast_cancer"])
def test_early_stopping_matches_jax(breast_cancer, case, esr):
    kw, X, y, valid = (_regression_case() if case == "regression"
                       else _breast_case(breast_cancer))
    kw = {**kw, "early_stopping_round": esr}
    jb = jtrain({**kw, "hist_method": "scatter"}, X, y, valid=valid)
    tb = ttrain(kw, X, y, valid=valid, device="cpu")
    assert 0 < tb.best_iteration < kw["num_iterations"]
    assert tb.best_iteration == jb.best_iteration
    assert tb.num_trees == jb.num_trees
    # the run stops once esr iterations passed the best, read at the
    # min(esr, 8) cadence: it trains fewer than that many more trees
    assert tb.best_iteration + esr <= tb.num_trees \
        < tb.best_iteration + esr + min(esr, 8)
    if case == "regression":
        for k in STRUCT_KEYS:
            np.testing.assert_array_equal(tb.trees[k], jb.trees[k],
                                          err_msg=k)
    else:
        Xv, yv = valid
        assert abs(_auc(yv, tb.predict(Xv)) - _auc(yv, jb.predict(Xv))) \
            < 0.005
    # scoring truncates at best_iteration
    np.testing.assert_array_equal(
        tb.raw_score(valid[0]), tb.raw_score(valid[0], tb.best_iteration))


def test_validation_without_early_stopping_is_ignored(breast_cancer):
    kw, X, y, valid = _breast_case(breast_cancer)
    kw = {**kw, "num_iterations": 4}
    a = ttrain(kw, X, y, valid=valid, device="cpu")
    b = ttrain(kw, X, y, device="cpu")
    _same_forest(a, b)
    assert a.best_iteration == -1


# ---------------------------------------------------------------------------
# warm start
# ---------------------------------------------------------------------------


def test_warm_start_matches_jax(higgs):
    X, y, Xte, _ = higgs
    kw = {"objective": "binary", "num_iterations": 6, "num_leaves": 15,
          "max_bin": 63}
    base = jtrain({**kw, "hist_method": "scatter"}, X, y).model_to_string()
    jr = jtrain({**kw, "hist_method": "scatter"}, X, y, init_model=base)
    tr = ttrain(kw, X, y, init_model=base, device="cpu")
    assert tr.num_trees == 12
    _close_forest(tr, jr, new_from=6)
    np.testing.assert_allclose(tr.predict(Xte), jr.predict(Xte), rtol=1e-5,
                               atol=1e-6)


def test_warm_start_different_num_leaves_matches_jax(higgs):
    # the continuation grows 31-leaf trees on 7-leaf ones: _pad_nodes
    X, y, _, _ = higgs
    base = jtrain({"objective": "binary", "num_iterations": 4,
                   "num_leaves": 7, "max_bin": 63,
                   "hist_method": "scatter"}, X, y)
    kw = {"objective": "binary", "num_iterations": 4, "num_leaves": 31,
          "max_bin": 63}
    jr = jtrain({**kw, "hist_method": "scatter"}, X, y,
                init_model=base.model_to_string())
    tr = ttrain(kw, X, y, init_model=base.model_to_string(), device="cpu")
    assert tr.num_trees == 8 and tr.trees["feature"].shape[1] == 61
    _close_forest(tr, jr, new_from=4)
    # the padded slots of the base trees are inert self-loop leaves
    assert tr.trees["is_leaf"][:4, 13:].all()
    np.testing.assert_array_equal(tr.trees["left"][:4, 13:],
                                  np.broadcast_to(np.arange(13, 61), (4, 48)))


def test_warm_start_from_early_stopped_base_matches_jax(breast_cancer):
    kw, X, y, valid = _breast_case(breast_cancer)
    base = jtrain({**kw, "num_iterations": 200, "early_stopping_round": 5,
                   "hist_method": "scatter"}, X, y, valid=valid)
    assert 0 < base.best_iteration < 200
    s = base.model_to_string()
    jr = jtrain({**kw, "num_iterations": 3, "hist_method": "scatter"}, X, y,
                init_model=s)
    tr = ttrain({**kw, "num_iterations": 3}, X, y, init_model=s,
                device="cpu")
    assert tr.num_trees == base.best_iteration + 3 == jr.num_trees
    _close_forest(tr, jr, new_from=base.best_iteration, struct=False)
    # and with early stopping on the continuation: best_iteration counts
    # the base's iterations too
    je = jtrain({**kw, "num_iterations": 40, "early_stopping_round": 3,
                 "hist_method": "scatter"}, X, y, valid=valid, init_model=s)
    te = ttrain({**kw, "num_iterations": 40, "early_stopping_round": 3}, X,
                y, valid=valid, init_model=s, device="cpu")
    assert te.best_iteration == je.best_iteration
    assert te.num_trees == je.num_trees


def test_estimator_init_model_string_matches_jax(higgs):
    X, y, _, _ = higgs
    kw = dict(numIterations=4, numLeaves=15, maxBin=63)
    m1 = JClassifier(histMethod="scatter", **kw).fit(
        JTable({"features": X, "label": y}))
    s = m1.get("modelString")
    jm = JClassifier(histMethod="scatter", initModelString=s, **kw).fit(
        JTable({"features": X, "label": y}))
    tm = mtt.TPUBoostClassifier(initModelString=s, device="cpu", **kw).fit(
        mtt.DataTable({"features": X, "label": y}))
    assert tm.get_booster().num_trees == 8
    _close_forest(tm.get_booster(), jm.get_booster(), new_from=4)


def test_warm_start_mismatches_raise(breast_cancer):
    X, y = breast_cancer
    reg = ttrain({"objective": "regression", "num_iterations": 2}, X, y,
                 device="cpu")
    with pytest.raises(ValueError, match="link spaces"):
        ttrain({"objective": "binary", "num_iterations": 2}, X, y,
               init_model=reg, device="cpu")
    binary = ttrain({"objective": "binary", "num_iterations": 2}, X, y,
                    device="cpu")
    with pytest.raises(ValueError, match="features"):
        ttrain({"objective": "binary", "num_iterations": 2}, X[:, :3], y,
               init_model=binary, device="cpu")
    with pytest.raises(ValueError, match="classes"):
        ttrain({"objective": "multiclass", "num_class": 3,
                "num_iterations": 2}, X[:150], np.arange(150) % 3,
               init_model=binary, device="cpu")


# ---------------------------------------------------------------------------
# boost_more
# ---------------------------------------------------------------------------

KW = {"objective": "binary", "num_iterations": 8, "num_leaves": 15,
      "max_bin": 31, "hist_method": "scatter", "seed": 3,
      "keep_training_data": True}


@pytest.mark.parametrize("extra", [
    {},
    {"bagging_fraction": 0.7, "bagging_freq": 1, "feature_fraction": 0.8},
    {"bagging_fraction": 0.7, "bagging_freq": 3, "feature_fraction": 0.8,
     "hist_bits": 16},
])
def test_retained_continuation_bit_identical(breast_cancer, extra):
    X, y = breast_cancer
    kw = {**KW, **extra}
    one_shot = ttrain({**kw, "num_iterations": 12}, X, y, device="cpu")
    grown = ttrain(kw, X, y, device="cpu").boost_more(4)
    _same_forest(one_shot, grown)
    assert grown.train_info["bin_path"] == "retained"
    assert grown.params["num_iterations"] == 12
    np.testing.assert_array_equal(grown.predict(X), one_shot.predict(X))


def test_chained_continuation_bit_identical_and_single_use(breast_cancer):
    X, y = breast_cancer
    one_shot = ttrain({**KW, "num_iterations": 20}, X, y, device="cpu")
    b = ttrain(KW, X, y, device="cpu")
    grown = b.boost_more(8).boost_more(4)
    _same_forest(one_shot, grown)
    with pytest.raises(ValueError, match="already consumed"):
        b.boost_more(1)   # the oldest state is single-use


def test_retained_state_requires_opt_in(breast_cancer, monkeypatch):
    X, y = breast_cancer
    b = ttrain({"objective": "binary", "num_iterations": 4}, X, y,
               device="cpu")
    with pytest.raises(ValueError, match="keep_training_data"):
        b.boost_more(2)
    with pytest.raises(ValueError, match="positive"):
        b.boost_more(0)
    tr, te = _split(y)
    # the warning itself (the port's loggers may not propagate)
    warned = []
    monkeypatch.setattr(booster_mod._log, "warning",
                        lambda msg, *a: warned.append(msg % a))
    es = ttrain({**KW, "early_stopping_round": 3}, X[tr], y[tr],
                valid=(X[te], y[te]), device="cpu")
    assert es._resume is None
    assert any("keep_training_data requested" in w for w in warned)


def test_fresh_data_boost_more_matches_jax(higgs):
    X, y, Xte, yte = higgs
    base_kw = {k: v for k, v in KW.items() if k != "keep_training_data"}
    jbase = jtrain(base_kw, X, y)
    tbase = ttrain(base_kw, X, y, device="cpu")
    X2, y2 = Xte[:1000], yte[:1000]
    ja = jbase.boost_more(4, X2, y2)
    ta = tbase.boost_more(4, X2, y2)
    tb = tbase.boost_more(4, X2, y2)
    assert ta.num_trees == tbase.num_trees + 4
    _same_forest(ta, tb)                  # deterministic
    _close_forest(ta, ja)
    # the new trees split in the base forest's bin space
    new = ~ta.trees["is_leaf"][8:].astype(bool)
    lut = tbase.bin_mapper.threshold_matrix(
        int(tbase.bin_mapper.num_bins.max()))
    for t, f in zip(ta.trees["threshold"][8:][new],
                    ta.trees["feature"][8:][new]):
        assert np.isin(t, lut[f]).item() or not np.isfinite(t), (t, f)
    loaded = TBooster.from_string(tbase.model_to_string(), device="cpu")
    with pytest.raises(ValueError, match="BinMapper"):
        loaded.boost_more(2, X2, y2)


def test_estimator_keep_training_data_param(breast_cancer):
    X, y = breast_cancer
    t = mtt.DataTable({"features": np.asarray(X, np.float64),
                       "label": np.asarray(y, np.float64)})
    m = mtt.TPUBoostClassifier(numIterations=4, keepTrainingData=True,
                               device="cpu").fit(t)
    grown = m.get_booster().boost_more(2)
    assert grown.num_trees == 6
