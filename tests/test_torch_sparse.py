"""PyTorch port: sparse (CSR) input against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package's
``CSRMatrix``, DataTable, ``BinMapper.fit_sparse`` / ``transform_sparse``,
``train`` and estimators, and through the port's with ``device="cpu"``
(the JAX side on its scatter path). Held: ``CSRMatrix`` arrays, cuts
and bins bitwise; a CSR table saved by either package loads in the
other; forests by ROADMAP.md §3's rule (every tree's structure equal,
the first tree's thresholds and counts bitwise, leaf values to rtol
1e-5); ``raw_score``
of CSR rows bitwise the dense one.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from mmlspark_tpu.core import sparse as jsparse
from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.gbdt.binning import BinMapper as JBinMapper
from mmlspark_tpu.gbdt.booster import train as jtrain
from mmlspark_tpu.gbdt.estimators import TPUBoostClassifier as JClassifier

import mmlspark_tpu_torch as mtt
from mmlspark_tpu_torch.core import sparse as tsparse
from mmlspark_tpu_torch.core.table import features_matrix
from mmlspark_tpu_torch.gbdt.binning import BinMapper as TBinMapper
from mmlspark_tpu_torch.gbdt.booster import train as ttrain

STRUCTURE = ("feature", "bin_threshold", "left", "right", "is_leaf")


def _sparse_dense(n=1500, f=20, density=0.3, seed=0, dtype=np.float32):
    """A dense matrix with ~``density`` nonzeros (the shape of
    tests/test_sparse.py's CSR fits) and a label that depends on a few
    of its columns."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(dtype)
    X[rng.random((n, f)) >= density] = 0
    logit = X[:, 0] + 0.8 * X[:, 1] - 0.6 * X[:, 2] + 0.5 * X[:, 3] * X[:, 4]
    y = (logit + rng.normal(scale=0.3, size=n) > 0).astype(np.float64)
    return X, y


def _csr_pair(X):
    return jsparse.CSRMatrix.from_dense(X), tsparse.CSRMatrix.from_dense(X)


def _assert_csr_equal(t, j):
    assert isinstance(t, tsparse.CSRMatrix)
    assert t.shape == j.shape
    for k in ("data", "indices", "indptr"):
        a, b = getattr(t, k), getattr(j, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _assert_forest_rule(tb, jb):
    """ROADMAP.md §3's rule: every tree's structure equal, tree 0's
    thresholds and row counts bitwise, leaf values to rtol 1e-5 (f32
    leaf values part by an ulp where XLA's exp or its sum order differs
    from torch's, tree 0 included; §3)."""
    assert tb.num_trees == jb.num_trees
    for k in STRUCTURE:
        np.testing.assert_array_equal(tb.trees[k], jb.trees[k], err_msg=k)
    for k in ("threshold", "count"):
        np.testing.assert_array_equal(tb.trees[k][0], jb.trees[k][0],
                                      err_msg=f"tree 0 {k}")
    np.testing.assert_allclose(tb.trees["value"], jb.trees["value"],
                               rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# CSRMatrix
# ---------------------------------------------------------------------------

_OPS = {
    "from_dense": lambda m, X: m.CSRMatrix.from_dense(X),
    "from_rows": lambda m, X: m.CSRMatrix.from_rows(
        [{int(c): float(X[i, c]) for c in np.flatnonzero(X[i])}
         for i in range(len(X))], X.shape[1]),
    "from_scipy": lambda m, X: m.CSRMatrix.from_scipy(sp.csr_matrix(X)),
    "slice": lambda m, X: m.CSRMatrix.from_dense(X)[7:53],
    "step_slice": lambda m, X: m.CSRMatrix.from_dense(X)[3:90:4],
    "take": lambda m, X: m.CSRMatrix.from_dense(X).take(
        np.array([5, 0, 99, 5, 31])),
    "bool_mask": lambda m, X: m.CSRMatrix.from_dense(X)[X[:, 0] > 0],
    "vstack": lambda m, X: m.vstack([m.CSRMatrix.from_dense(X[:40]),
                                     m.CSRMatrix.from_dense(X[40:])]),
    "hstack": lambda m, X: m.hstack([m.CSRMatrix.from_dense(X[:, :4]),
                                     X[:, 4:9], X[:, 9]]),
    "method_hstack": lambda m, X: m.CSRMatrix.from_dense(X[:, :5]).hstack(
        [m.CSRMatrix.from_dense(X[:, 5:])]),
}


@pytest.mark.parametrize("op", sorted(_OPS))
def test_csr_constructors_and_row_selection_match_jax(op):
    X, _ = _sparse_dense(n=100, f=12, seed=1)
    t, j = _OPS[op](tsparse, X), _OPS[op](jsparse, X)
    _assert_csr_equal(t, j)
    np.testing.assert_array_equal(t.toarray(), j.toarray())
    assert t.nnz == j.nnz and len(t) == len(j)
    assert t.max_row_nnz() == j.max_row_nnz()


def test_csr_views_match_jax():
    X, _ = _sparse_dense(n=120, f=10, seed=2)
    j, t = _csr_pair(X)
    for a, b in zip(t.csc(), j.csc()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t[17], j[17])
    np.testing.assert_array_equal(t[-1], j[-1])
    k = t.max_row_nnz()
    for a, b in zip(t.padded_batch(10, 60, k), j.padded_batch(10, 60, k)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="silently drop"):
        t.padded_batch(0, 120, 1)
    for a, b in zip(t.padded_batch(0, 120, 1, allow_truncate=True),
                    j.padded_batch(0, 120, 1, allow_truncate=True)):
        np.testing.assert_array_equal(a, b)
    rt = t.to_scipy()
    np.testing.assert_array_equal(rt.toarray(), X)
    with pytest.raises(ValueError, match="indptr length"):
        tsparse.CSRMatrix(t.data, t.indices, t.indptr[:-1], t.shape)


# ---------------------------------------------------------------------------
# a table with a sparse column
# ---------------------------------------------------------------------------


def test_table_concat_and_take_keep_the_column_sparse():
    X, y = _sparse_dense(n=60, f=8, seed=3)
    jparts = [JTable({"f": jsparse.CSRMatrix.from_dense(X[:25]),
                      "y": y[:25]}),
              JTable({"f": X[25:], "y": y[25:]})]
    tparts = [mtt.DataTable({"f": tsparse.CSRMatrix.from_dense(X[:25]),
                             "y": y[:25]}),
              mtt.DataTable({"f": X[25:], "y": y[25:]})]
    jc, tc = JTable.concat(jparts), mtt.DataTable.concat(tparts)
    _assert_csr_equal(tc["f"], jc["f"])
    assert tc.schema.to_json() == jc.schema.to_json()
    assert tc.field("f").meta == {"sparse": True}
    idx = np.array([3, 40, 3, 59])
    _assert_csr_equal(tc._take_indices(idx)["f"], jc._take_indices(idx)["f"])
    _assert_csr_equal(tc.slice(10, 30)["f"], jc.slice(10, 30)["f"])
    # the one place a sparse column densifies, as in the JAX package
    np.testing.assert_array_equal(features_matrix(tc, "f"),
                                  X.astype(np.float64))


@pytest.mark.parametrize("saver,loader", [("port", "jax"), ("jax", "port"),
                                          ("port", "port")])
def test_csr_table_save_load_across_packages(tmp_path, saver, loader):
    X, y = _sparse_dense(n=80, f=9, seed=4)
    cols = {"y": y, "name": [f"r{i}" for i in range(80)]}
    if saver == "port":
        mtt.DataTable({"f": tsparse.CSRMatrix.from_dense(X), **cols}).save(
            str(tmp_path / "t"))
    else:
        JTable({"f": jsparse.CSRMatrix.from_dense(X), **cols}).save(
            str(tmp_path / "t"))
    got = (mtt.DataTable if loader == "port" else JTable).load(
        str(tmp_path / "t"))
    cls = (tsparse if loader == "port" else jsparse).CSRMatrix
    assert isinstance(got["f"], cls)
    ref = jsparse.CSRMatrix.from_dense(X)
    for k in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(got["f"], k), getattr(ref, k))
    assert got["f"].shape == ref.shape
    np.testing.assert_array_equal(got["y"], y)
    assert list(got["name"]) == cols["name"]
    assert got.field("f").meta == {"sparse": True}


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("sample_cnt", [200_000, 700])
def test_fit_sparse_and_transform_sparse_match_jax(dtype, sample_cnt):
    X, _ = _sparse_dense(n=2000, f=12, seed=5, dtype=dtype)
    X[::97, 2] = np.nan
    X[:, 5] = 0.0                        # a column with no nonzero
    X[1::3, 6] = 1.5                     # a heavy nonzero value
    j = jsparse.CSRMatrix(X[X != 0], np.nonzero(X)[1],
                          np.concatenate([[0], np.cumsum((X != 0).sum(1))]),
                          X.shape)
    t = tsparse.CSRMatrix(j.data, j.indices, j.indptr, j.shape)
    jm = JBinMapper.fit_sparse(j, max_bin=63, sample_cnt=sample_cnt)
    tm = TBinMapper.fit_sparse(t, max_bin=63, sample_cnt=sample_cnt)
    assert len(tm.upper_bounds) == len(jm.upper_bounds)
    for a, b in zip(tm.upper_bounds, jm.upper_bounds):
        np.testing.assert_array_equal(a, b)
    assert tm.f32_values_safe == jm.f32_values_safe
    assert tm.f32_cuts_exact == jm.f32_cuts_exact
    bt = tm.transform_sparse(t)
    assert bt.dtype == np.int32
    np.testing.assert_array_equal(bt, jm.transform_sparse(j))
    np.testing.assert_array_equal(tm.transform_sparse(t, dtype=np.uint8), bt)
    # the sparse bins equal the dense transform of the same rows
    np.testing.assert_array_equal(bt, tm.transform(t.toarray()).T)


# ---------------------------------------------------------------------------
# training, validation and scoring on CSR
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("objective,extra", [
    ("binary", {}), ("regression", {}), ("multiclass", {"num_class": 3})])
def test_train_on_csr_matches_jax(objective, extra):
    X, y = _sparse_dense()
    if objective == "regression":
        y = X[:, 0] * 2.0 - X[:, 1] + 0.1 * X[:, 2] ** 2
    elif objective == "multiclass":
        # noisy classes, as the binary label is: labels read exactly off
        # the features leave pure nodes, whose splits have gains of float
        # noise (3e-5 against 0) that an ulp of the softmax decides
        noise = np.random.default_rng(1).normal(scale=0.3, size=len(y))
        y = np.digitize(X[:, 0] + X[:, 1] + noise,
                        [-0.3, 0.3]).astype(np.float64)
    j, t = _csr_pair(X)
    kw = {"objective": objective, "num_iterations": 8, "num_leaves": 15,
          "max_bin": 63, **extra}
    jb = jtrain({**kw, "hist_method": "scatter"}, j, y)
    tb = ttrain(kw, t, y, device="cpu")
    assert tb.train_info["bin_path"] == "host"
    _assert_forest_rule(tb, jb)
    np.testing.assert_allclose(tb.raw_score(t), jb.raw_score(j), rtol=1e-5,
                               atol=1e-5)
    # a CSR fit and a fit of its dense copy share cuts, bins and trees
    td = ttrain(kw, X, y, device="cpu")
    for k in STRUCTURE:
        np.testing.assert_array_equal(tb.trees[k], td.trees[k], err_msg=k)


def test_csr_validation_with_early_stopping_matches_jax():
    X, y = _sparse_dense(n=2000)
    j, t = _csr_pair(X)
    kw = {"objective": "binary", "num_iterations": 30, "num_leaves": 7,
          "max_bin": 31, "early_stopping_round": 3}
    # flipped validation labels: the loss rises from the first trees on,
    # so the run stops, and best_iteration is read at the same cadence
    yv = 1.0 - y[1500:]
    jb = jtrain({**kw, "hist_method": "scatter"}, j[:1500], y[:1500],
                valid=(j[1500:], yv))
    tb = ttrain(kw, t[:1500], y[:1500], valid=(t[1500:], yv), device="cpu")
    assert tb.best_iteration == jb.best_iteration
    assert tb.num_trees == jb.num_trees < 30
    _assert_forest_rule(tb, jb)
    # CSR validation reads the same losses as its dense copy
    td = ttrain(kw, X[:1500], y[:1500], valid=(X[1500:], yv), device="cpu")
    assert td.best_iteration == tb.best_iteration
    np.testing.assert_array_equal(td.train_info["valid_loss"],
                                  tb.train_info["valid_loss"])


@pytest.mark.parametrize("f32_unsafe", [False, True])
def test_raw_score_on_csr_is_bitwise_the_dense_walk(f32_unsafe):
    X, y = _sparse_dense(n=1500, f=20)
    kw = {"objective": "binary", "num_iterations": 4, "num_leaves": 7,
          "max_bin": 31}
    if f32_unsafe:
        # a dense float64 fit whose feature 0 has gaps below float32's
        # resolution: its forest scores through the float64 host walk
        Xd = X.astype(np.float64)
        Xd[:, 0] = 1e6 + np.round(X[:, 0] * 20) / 100
        tb = ttrain(kw, Xd, y, device="cpu")
        X = Xd
    else:
        tb = ttrain(kw, tsparse.CSRMatrix.from_dense(X), y, device="cpu")
    assert tb._needs_f64_inference() == f32_unsafe
    # 20,000 rows cross the 8192-row chunks of the CSR path twice
    rng = np.random.default_rng(9)
    big = X[rng.integers(0, len(X), size=20000)]
    big_csr = tsparse.CSRMatrix.from_dense(big)
    got = tb.raw_score(big_csr)
    want = tb.raw_score(big_csr.toarray())
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tb.predict(big_csr), tb.predict(
        big_csr.toarray()))
    assert tb.raw_score(tsparse.CSRMatrix.from_dense(X[:0])).shape == (0,)


def test_estimator_on_a_csr_column_matches_jax():
    X, y = _sparse_dense(n=2000)
    jt = JTable({"features": jsparse.CSRMatrix.from_dense(X[:1500]),
                 "label": y[:1500]})
    tt = mtt.DataTable({"features": tsparse.CSRMatrix.from_dense(X[:1500]),
                        "label": y[:1500]})
    kw = dict(numIterations=6, numLeaves=15, maxBin=63)
    jm = JClassifier(histMethod="scatter", **kw).fit(jt)
    tm = mtt.TPUBoostClassifier(device="cpu", **kw).fit(tt)
    _assert_forest_rule(tm.get_booster(), jm.get_booster())
    te_t = mtt.DataTable({"features": tsparse.CSRMatrix.from_dense(
        X[1500:]), "label": y[1500:]})
    te_j = JTable({"features": jsparse.CSRMatrix.from_dense(X[1500:]),
                   "label": y[1500:]})
    ot, oj = tm.transform(te_t), jm.transform(te_j)
    np.testing.assert_allclose(ot["probability"], oj["probability"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ot["prediction"], oj["prediction"])
    # the CSR column scores bitwise like its dense copy
    dense = tm.transform(mtt.DataTable({"features": X[1500:],
                                        "label": y[1500:]}))
    np.testing.assert_array_equal(ot["rawPrediction"], dense["rawPrediction"])
