"""PyTorch port: the linear models (``models/linear.py``) against the JAX
package, on the CPU.

The linear-model cases of ``tests/test_sparse.py`` and
``tests/test_lifecycle.py`` (``partial_fit``, ``drift_monitor``) run
through both packages on the same seeded numpy inputs. Tolerances,
stated:
- weights (f32, summed by torch and by XLA in other orders): within
  rtol 1e-4 / atol 1e-5 of the weights' largest magnitude, the rule
  ``chip_smoke.py`` 11(f) holds between the card and the CPU;
  predictions equal on at least 99.9 % of the rows;
- the standardization statistics (float64 numpy in both): bitwise;
- scores given the same weights (host numpy in float64 in both):
  bitwise.
Within the port: a fit and its repeat are bitwise equal; the sparse
fit's column sums (in pieces) equal a float64 scatter within f32
rounding.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.sparse import CSRMatrix as JCSR
from mmlspark_tpu.core.stage import load_stage as jload_stage
from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.models import linear as JL

from mmlspark_tpu_torch.core.metrics import DriftMonitor
from mmlspark_tpu_torch.core.sparse import CSRMatrix as PCSR
from mmlspark_tpu_torch.core.stage import load_stage as pload_stage
from mmlspark_tpu_torch.core.table import DataTable as PTable
from mmlspark_tpu_torch.models import linear as PL


def assert_weights_close(p, j, keys):
    """rtol 1e-4 / atol 1e-5 of the largest magnitude over all ``keys``
    (a standardized fit's bias sits at rounding level beside W)."""
    scale = max(float(np.abs(np.asarray(j[k])).max()) for k in keys)
    for k in keys:
        np.testing.assert_allclose(p[k], j[k], rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=k)


def _agree(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


def blobs(n=600, d=6, seed=1, classes=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 3, d) + rng.normal(size=d)
    w = rng.normal(size=(d, classes))
    y = np.argmax(X @ w + rng.normal(scale=0.5, size=(n, classes)),
                  axis=1).astype(np.float64)
    return X, y


def regression(n=500, d=5, seed=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * 2 + 1
    y = X @ rng.normal(size=d) + 3 + rng.normal(scale=0.1, size=n)
    return X, y


def both(X, y, col="features"):
    return (PTable({col: X, "label": y}), JTable({col: X, "label": y}))


# ---------------------------------------------------------------------------
# fits against the JAX package
# ---------------------------------------------------------------------------

LOGISTIC = [dict(), dict(maxIter=50, stepSize=0.2, regParam=1e-2),
            dict(maxIter=120, stepSize=0.9, regParam=0.0)]


@pytest.mark.parametrize("classes", [2, 3])
@pytest.mark.parametrize("kw", LOGISTIC, ids=["default", "short", "no_l2"])
def test_dense_logistic_matches_jax(kw, classes):
    X, y = blobs(classes=classes)
    pt, jt = both(X, y)
    pm = PL.TPULogisticRegression(device="cpu", **kw).fit(pt)
    jm = JL.TPULogisticRegression(**kw).fit(jt)
    pw, jw = pm.get("weights"), jm.get("weights")
    assert pw["W"].shape == (6, classes) and pw["W"].dtype == np.float32
    assert_weights_close(pw, jw, ("W", "b"))
    for k in ("mu", "sd"):
        np.testing.assert_array_equal(pw[k], jw[k])
    assert _agree(pm.transform(pt)["prediction"],
                  jm.transform(jt)["prediction"]) >= 0.999


@pytest.mark.parametrize("kw", [dict(), dict(maxIter=40, stepSize=0.3,
                                             regParam=1e-3)],
                         ids=["default", "short"])
def test_linear_regression_matches_jax(kw):
    X, y = regression()
    pt, jt = both(X, y)
    pm = PL.TPULinearRegression(device="cpu", **kw).fit(pt)
    jm = JL.TPULinearRegression(**kw).fit(jt)
    pw, jw = pm.get("weights"), jm.get("weights")
    assert_weights_close(pw, jw, ("w", "b"))
    for k in ("mu", "sd", "y_mu", "y_sd"):
        np.testing.assert_array_equal(pw[k], jw[k])
    pp = np.asarray(pm.transform(pt)["prediction"])
    jp = np.asarray(jm.transform(jt)["prediction"])
    np.testing.assert_allclose(pp, jp, rtol=1e-4,
                               atol=1e-5 * float(np.abs(jp).max()))


def _token_csr(n=400, seed=0, width=1 << 12):
    """A hashed two-class token table as CSR rows (test_sparse.py's
    ``_token_table`` shape), returned for both packages."""
    from mmlspark_tpu_torch.stages.text import hash_counts_csr
    rng = np.random.default_rng(seed)
    vocab_a = [f"a{i}" for i in range(40)]
    vocab_b = [f"b{i}" for i in range(40)]
    common = [f"c{i}" for i in range(10)]
    docs, labels = [], []
    for _ in range(n):
        y = int(rng.random() < 0.5)
        pool = vocab_a if y else vocab_b
        docs.append(list(rng.choice(pool, size=8))
                    + list(rng.choice(common, size=4)))
        labels.append(float(y))
    p = hash_counts_csr(docs, width)
    j = JCSR(p.data, p.indices, p.indptr, p.shape)
    return p, j, np.asarray(labels)


def _dense_csr(seed=3):
    rng = np.random.default_rng(seed)
    X = np.where(rng.random((500, 12)) < 0.3, rng.normal(size=(500, 12)),
                 0.0).astype(np.float32)
    y = (X[:, 0] + 2 * X[:, 1] - X[:, 5] > 0).astype(np.float64)
    return PCSR.from_dense(X), JCSR.from_dense(X), y


@pytest.mark.parametrize("make", [_token_csr, _dense_csr],
                         ids=["hashed_text", "sparse_numeric"])
def test_sparse_logistic_matches_jax(make):
    p, j, y = make()
    pm = PL.TPULogisticRegression(device="cpu", maxIter=150).fit(
        PTable({"features": p, "label": y}))
    jm = JL.TPULogisticRegression(maxIter=150).fit(
        JTable({"features": j, "label": y}))
    pw, jw = pm.get("weights"), jm.get("weights")
    assert "mu" not in pw
    assert_weights_close(pw, jw, ("W", "b"))
    pp = pm.transform(PTable({"features": p}))["prediction"]
    assert _agree(pp, jm.transform(JTable({"features": j}))["prediction"]) \
        >= 0.999
    assert _agree(pp, y) > 0.9


@pytest.mark.parametrize("piece", [256, 3])
def test_sparse_fit_is_bitwise_on_repeat_and_sums_by_column(piece,
                                                            monkeypatch):
    """At the default piece length and at 3 (every column cut into many
    pieces, some of them short)."""
    monkeypatch.setattr(PL, "_PIECE", piece)
    p, _, y = _token_csr(seed=5)
    t = PTable({"features": p, "label": y})
    w1 = PL.TPULogisticRegression(device="cpu", maxIter=30).fit(t)
    w2 = PL.TPULogisticRegression(device="cpu", maxIter=30).fit(t)
    for k in ("W", "b"):
        np.testing.assert_array_equal(w1.get("weights")[k],
                                      w2.get("weights")[k])
    # one step from zero: the gradient's column sums against a float64
    # scatter of the same products
    res = PL._fit_logistic_sparse(p, y, 1.0, 0.0, 1, 2,
                                  torch.device("cpu"))
    rows = np.repeat(np.arange(p.shape[0]), np.diff(p.indptr))
    r = (np.full((len(y), 2), 0.5) - np.eye(2)[y.astype(int)]) / len(y)
    g = np.zeros((p.shape[1], 2))
    np.add.at(g, p.indices, p.data[:, None].astype(np.float64) * r[rows])
    np.testing.assert_allclose(res["W"], -g, rtol=1e-6, atol=1e-8)


def test_column_pieces_cover_each_column_in_order():
    col_ptr = np.asarray([0, 0, 3, 3, 600, 1112, 1113])
    piece_len, pieces = PL._column_pieces(col_ptr)
    assert pieces.tolist() == [0, 1, 0, 3, 2, 1]
    assert piece_len.tolist() == [3, 256, 256, 85, 256, 256, 1]
    assert piece_len.max() <= PL._PIECE and piece_len.min() > 0


def test_scores_bitwise_given_the_jax_weights():
    X, y = blobs(classes=3)
    pt, jt = both(X, y)
    jm = JL.TPULogisticRegression(maxIter=40).fit(jt)
    pm = PL.TPULogisticRegressionModel(weights=jm.get("weights"))
    for c in ("rawPrediction", "probability", "prediction"):
        np.testing.assert_array_equal(pm.transform(pt)[c],
                                      jm.transform(jt)[c])
    Xr, yr = regression()
    pt, jt = both(Xr, yr)
    jr = JL.TPULinearRegression(maxIter=40).fit(jt)
    pr = PL.TPULinearRegressionModel(weights=jr.get("weights"))
    np.testing.assert_array_equal(pr.transform(pt)["prediction"],
                                  jr.transform(jt)["prediction"])
    p, j, ys = _token_csr(n=100)
    js = JL.TPULogisticRegression(maxIter=20).fit(
        JTable({"features": j, "label": ys}))
    ps = PL.TPULogisticRegressionModel(weights=js.get("weights"))
    np.testing.assert_array_equal(
        ps.transform(PTable({"features": p}))["probability"],
        js.transform(JTable({"features": j}))["probability"])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("family", ["logistic", "linear"])
def test_fitted_models_cross_packages(tmp_path, direction, family):
    X, y = blobs() if family == "logistic" else regression()
    pt, jt = both(X, y)
    if direction == "jax_to_port":
        est = (JL.TPULogisticRegression if family == "logistic"
               else JL.TPULinearRegression)(maxIter=30)
        src, load, dst = est.fit(jt), pload_stage, pt
    else:
        est = (PL.TPULogisticRegression if family == "logistic"
               else PL.TPULinearRegression)(maxIter=30, device="cpu")
        src, load, dst = est.fit(pt), jload_stage, jt
    src.save(str(tmp_path / "m"))
    loaded = load(str(tmp_path / "m"))
    for k, v in src.get("weights").items():
        np.testing.assert_array_equal(loaded.get("weights")[k], v)
    ref = src.transform(jt if direction == "jax_to_port" else pt)
    np.testing.assert_array_equal(loaded.transform(dst)["prediction"],
                                  ref["prediction"])


# ---------------------------------------------------------------------------
# partial_fit (tests/test_lifecycle.py's TestPartialFit)
# ---------------------------------------------------------------------------

def _lr(**kw):
    return PL.TPULogisticRegression(device="cpu", **kw)


def test_partial_fit_none_model_is_fit():
    X, y = blobs()
    t = PTable({"features": X, "label": y})
    a, b = _lr(maxIter=50).partial_fit(t), _lr(maxIter=50).fit(t)
    for k in ("W", "b"):
        np.testing.assert_array_equal(a.get("weights")[k],
                                      b.get("weights")[k])


def test_partial_fit_deterministic_and_matches_jax():
    X, y = blobs()
    pt, jt = both(X, y)
    base = _lr(maxIter=50).fit(pt)
    m1, m2 = (_lr(maxIter=50).partial_fit(pt, base) for _ in range(2))
    for k in ("W", "b"):
        np.testing.assert_array_equal(m1.get("weights")[k],
                                      m2.get("weights")[k])
    jbase = JL.TPULogisticRegression(maxIter=50).fit(jt)
    jm = JL.TPULogisticRegression(maxIter=50).partial_fit(jt, jbase)
    assert_weights_close(m1.get("weights"), jm.get("weights"), ("W", "b"))


def test_linear_partial_fit_matches_jax():
    X, y = regression()
    pt, jt = both(X, y)
    est = PL.TPULinearRegression(maxIter=40, device="cpu")
    jest = JL.TPULinearRegression(maxIter=40)
    half_p, half_j = both(X[:250], y[:250])
    pm = est.partial_fit(pt, est.fit(half_p))
    jm = jest.partial_fit(jt, jest.fit(half_j))
    assert_weights_close(pm.get("weights"), jm.get("weights"), ("w", "b"))
    for k in ("mu", "sd", "y_mu", "y_sd"):
        np.testing.assert_array_equal(pm.get("weights")[k],
                                      jm.get("weights")[k])


def test_incremental_batches_converge_to_full_refit_selection():
    X, y = blobs()
    full_t = PTable({"features": X, "label": y})
    est = _lr(maxIter=200, stepSize=0.5)
    full = est.fit(full_t)
    pred_full = np.asarray(full.transform(full_t)["prediction"])
    m = est.fit(PTable({"features": X[:200], "label": y[:200]}))
    for _epoch in range(2):
        for lo in range(0, len(y), 200):
            m = est.partial_fit(PTable({"features": X[lo:lo + 200],
                                        "label": y[lo:lo + 200]}), m)
    assert not np.array_equal(m.get("weights")["mu"],
                              full.get("weights")["mu"])
    assert (np.asarray(m.transform(full_t)["prediction"])
            == pred_full).mean() >= 0.99


def test_standardization_stats_frozen():
    X, y = blobs()
    est = _lr(maxIter=20)
    base = est.fit(PTable({"features": X, "label": y}))
    m = est.partial_fit(PTable({"features": X + 10.0, "label": y}), base)
    for k in ("mu", "sd"):
        np.testing.assert_array_equal(m.get("weights")[k],
                                      base.get("weights")[k])


def test_empty_batch_is_a_noop():
    X, y = blobs()
    empty = PTable({"features": np.zeros((0, X.shape[1])),
                    "label": np.zeros(0)})
    base = _lr(maxIter=10).fit(PTable({"features": X, "label": y}))
    assert _lr(maxIter=10).partial_fit(empty, base) is base
    lin = PL.TPULinearRegression(maxIter=10, device="cpu")
    lbase = lin.fit(PTable({"features": X, "label": X[:, 0]}))
    assert lin.partial_fit(empty, lbase) is lbase


def test_partial_fit_refusals():
    X, y = blobs()
    base = _lr(maxIter=10).fit(PTable({"features": X, "label": y}))
    with pytest.raises(ValueError, match="classes"):
        _lr(maxIter=10).partial_fit(
            PTable({"features": X[:10], "label": np.full(10, 5.0)}), base)
    p, _, ys = _token_csr(n=50)
    sparse = _lr(maxIter=5).fit(PTable({"features": p, "label": ys}))
    with pytest.raises(ValueError, match="dense-featured"):
        _lr(maxIter=5).partial_fit(PTable({"features": p, "label": ys}),
                                   sparse)
    with pytest.raises(ValueError, match="dense features"):
        _lr(maxIter=5).partial_fit(
            PTable({"features": PCSR.from_dense(X.astype(np.float32)),
                    "label": y}), base)


def test_linear_partial_fit_converges():
    X, _ = blobs()
    rng = np.random.default_rng(3)
    y = X @ rng.normal(size=X.shape[1]) + rng.normal(scale=0.05,
                                                     size=len(X))
    t = PTable({"features": X, "label": y})
    est = PL.TPULinearRegression(maxIter=200, device="cpu")
    full = est.fit(t)
    m = est.fit(PTable({"features": X[:300], "label": y[:300]}))
    for _epoch in range(3):
        for lo in range(0, len(y), 300):
            m = est.partial_fit(PTable({"features": X[lo:lo + 300],
                                        "label": y[lo:lo + 300]}), m)
    pf = np.asarray(full.transform(t)["prediction"])
    assert np.corrcoef(pf, np.asarray(m.transform(t)["prediction"]))[0, 1] \
        > 0.999


# ---------------------------------------------------------------------------
# drift, int8, devices
# ---------------------------------------------------------------------------

def test_drift_monitor_hook_matches_jax():
    X, y = blobs(n=300)
    pm = _lr(maxIter=20).fit(PTable({"features": X, "label": y}))
    jm = JL.TPULogisticRegression(maxIter=20).fit(
        JTable({"features": X, "label": y}))
    pd_, jd = pm.drift_monitor(), jm.drift_monitor()
    assert isinstance(pd_, DriftMonitor)
    pd_.observe(X)
    jd.observe(X)
    assert pd_.summary()["max_abs_mean_delta_sigma"] < 0.2
    assert pd_.summary() == jd.summary()
    Xr, yr = regression()
    lm = PL.TPULinearRegression(maxIter=5, device="cpu").fit(
        PTable({"features": Xr, "label": yr}))
    assert isinstance(lm.drift_monitor(), DriftMonitor)
    p, _, ys = _token_csr(n=50)
    with pytest.raises(ValueError, match="sparse"):
        _lr(maxIter=5).fit(PTable({"features": p, "label": ys})
                           ).drift_monitor()


@pytest.mark.parametrize("family", ["logistic", "linear"])
def test_int8_raises_naming_the_roadmap_item(family):
    """int8 is ported ('DNN int8 inference'): quantize returns a new
    int8 model and leaves this one f32, and precision='int8' set by hand
    on an f32 model is refused (it would have no int8 weights)."""
    X, y = blobs() if family == "logistic" else regression()
    t = PTable({"features": X, "label": y})
    est = (PL.TPULogisticRegression if family == "logistic"
           else PL.TPULinearRegression)(maxIter=5, device="cpu")
    m = est.fit(t)
    q = m.quantize(t)
    assert q.get("precision") == "int8" and m.get("precision") == "f32"
    with pytest.raises(ValueError, match="quantize"):
        m.set("precision", "int8")
    assert m.get("precision") == "f32"
    assert len(q.transform(t)[m.get_prediction_col()]) == len(y)


@pytest.mark.parametrize("family", ["logistic", "linear"])
def test_fits_default_to_the_card_and_raise_without_one(family,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = blobs() if family == "logistic" else regression()
    est = (PL.TPULogisticRegression if family == "logistic"
           else PL.TPULinearRegression)(maxIter=5)
    assert est.get("device") == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        est.fit(PTable({"features": X, "label": y}))


def test_batched_fit_at_one_candidate_is_the_serial_fit():
    """``fit`` is ``_fit_logistic_batch`` at C = 1: the same call gives
    the estimator's weights bitwise."""
    X, y = blobs()
    t = PTable({"features": X, "label": y})
    m = _lr(maxIter=25, stepSize=0.3, regParam=1e-3).fit(t)
    w = m.get("weights")
    Xs = (X - w["mu"]) / w["sd"]
    got = PL._fit_logistic_batch(
        torch.as_tensor(Xs.astype(np.float32)),
        torch.as_tensor(y.astype(np.float32)), [0.3], [1e-3], 25, 2)
    np.testing.assert_array_equal(got["W"][0], w["W"])
    np.testing.assert_array_equal(got["b"][0], w["b"])
