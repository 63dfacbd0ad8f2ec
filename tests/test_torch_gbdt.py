"""PyTorch port: the GBDT slice against the JAX package, on the CPU.

Same inputs (numpy, from a seed) through the JAX function and its
counterpart in ``mmlspark_tpu_torch``: objectives, binning, tree growth,
``train`` and the estimators end to end, and forests scored across the
two packages. The port runs with ``device="cpu"``, where its histogram
kernel's plain version stands in for the CUDA kernel; the JAX package
runs its scatter path. Also pinned: the port imports nothing of JAX or
of ``mmlspark_tpu``, refuses to run on the CPU unless asked, and raises
``NotImplementedError`` for every option outside its slice.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.gbdt import binning as jbinning
from mmlspark_tpu.gbdt import objectives as jobj
from mmlspark_tpu.gbdt import tree as jtree
from mmlspark_tpu.gbdt.booster import Booster as JBooster
from mmlspark_tpu.gbdt.booster import train as jtrain
from mmlspark_tpu.gbdt.estimators import (
    TPUBoostClassifier as JClassifier, TPUBoostRegressor as JRegressor,
)

import mmlspark_tpu_torch as mtt
from mmlspark_tpu_torch import convert
from mmlspark_tpu_torch.core.sparse import CSRMatrix
from mmlspark_tpu_torch.gbdt import binning as tbinning
from mmlspark_tpu_torch.gbdt import hist_kernels as HK
from mmlspark_tpu_torch.gbdt import objectives as tobj
from mmlspark_tpu_torch.gbdt import tree as ttree
from mmlspark_tpu_torch.gbdt.booster import train as ttrain
from mmlspark_tpu_torch.io.ooc import ChunkedTable

REPO = Path(__file__).resolve().parent.parent
TREE_KEYS = ("feature", "bin_threshold", "left", "right", "is_leaf")


def _auc(y, p):
    order = np.argsort(p, kind="stable")
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    n_pos = int((y == 1).sum())
    n_neg = len(y) - n_pos
    return (ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def _higgs_shape(n=6000, seed=7):
    """The HIGGS-shaped fixture of tests/test_gbdt_dist_quant.py: 28
    dense f32 features, nonlinear boundary, label noise."""
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


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------

OBJECTIVES = ["regression", "regression_l1", "huber", "quantile", "poisson",
              "tweedie", "gamma", "binary", "multiclass"]


def _objective_data(name, rng, n=2000):
    if name == "multiclass":
        return (rng.normal(size=(3, n)).astype(np.float32),
                rng.integers(0, 3, size=n).astype(np.float32))
    s = (rng.normal(size=n) * 1.5).astype(np.float32)
    if name == "binary":
        y = (rng.random(n) < 0.4).astype(np.float32)
    elif name in ("poisson", "tweedie", "gamma"):
        y = rng.gamma(2.0, size=n).astype(np.float32)
    else:
        y = rng.normal(size=n).astype(np.float32)
    return s, y


@pytest.mark.parametrize("name", OBJECTIVES)
def test_objective_matches_jax(name):
    rng = np.random.default_rng(11)
    s, y = _objective_data(name, rng)
    w = rng.uniform(0.5, 2.0, size=len(y))
    kw = dict(num_class=3, alpha=0.7, tweedie_variance_power=1.3)
    jo, to = jobj.get_objective(name, **kw), tobj.get_objective(name, **kw)
    # init_score is the same numpy float64 code: equal
    np.testing.assert_array_equal(
        to.init_score(y.astype(np.float64), w),
        jo.init_score(y.astype(np.float64), w))
    js, jy = jnp.asarray(s), jnp.asarray(y)
    ts, ty = torch.from_numpy(s), torch.from_numpy(y)
    # elementwise float32; XLA's and torch's exp/log differ by up to one
    # ulp, which a cancelling difference (p - y) turns into an absolute
    # error of ~1e-7 on values near 0: rtol 1e-6, atol 1e-6
    tol = dict(rtol=1e-6, atol=1e-6)
    for a, b in zip(to.grad_hess(ts, ty), jo.grad_hess(js, jy)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    np.testing.assert_allclose(to.transform(ts).numpy(),
                               np.asarray(jo.transform(js)), **tol)
    np.testing.assert_allclose(float(to.loss(ts, ty)),
                               float(jo.loss(js, jy)), **tol)


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------


def _binning_data(n, dtype, seed=5):
    rng = np.random.default_rng(seed)
    X = np.column_stack([
        rng.normal(size=n), rng.exponential(size=n) * 1e3,
        rng.integers(0, 7, size=n),                    # few distinct values
        np.full(n, 3.0),                               # constant
    ]).astype(dtype)
    X[rng.random(n) < 0.05, 0] = np.nan
    return X


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,sample_cnt", [(1500, 200_000), (3000, 1000)])
def test_binmapper_matches_jax(dtype, n, sample_cnt):
    X = _binning_data(n, dtype)
    jm = jbinning.BinMapper.fit(X, max_bin=63, sample_cnt=sample_cnt, seed=2)
    tm = tbinning.BinMapper.fit(X, max_bin=63, sample_cnt=sample_cnt, seed=2)
    assert len(jm.upper_bounds) == len(tm.upper_bounds)
    for a, b in zip(tm.upper_bounds, jm.upper_bounds):
        np.testing.assert_array_equal(a, b)
    assert (tm.f32_values_safe, tm.f32_cuts_exact) == \
        (jm.f32_values_safe, jm.f32_cuts_exact)
    np.testing.assert_array_equal(tm.transform_fm(X),
                                  np.asarray(jm.transform_fm(X), np.int32))
    np.testing.assert_array_equal(tm.transform(X), jm.transform(X))
    np.testing.assert_array_equal(tm.threshold_matrix(64),
                                  jm.threshold_matrix(64))


def test_bucketize_device_matches_jax_with_nan_and_inf():
    X = _binning_data(2000, np.float32)
    m = tbinning.BinMapper.fit(X, max_bin=31)
    X[:7, 1] = np.inf
    X[7:13, 1] = -np.inf
    X[13:20, 2] = np.nan
    bounds = m.bounds_matrix(np.float32)
    ref = np.asarray(jbinning.bucketize_fm_device(jnp.asarray(X),
                                                  jnp.asarray(bounds)))
    got = tbinning.bucketize_fm_device(
        torch.from_numpy(np.ascontiguousarray(X.T)),
        torch.from_numpy(bounds))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), m.transform_fm(X))


# ---------------------------------------------------------------------------
# tree growth
# ---------------------------------------------------------------------------


def _separated_fixture(n=3000, f=6, B=32, seed=4):
    """Gradients driven by a few features with well-separated effects,
    so no two candidate gains are near-ties. Centered: a gain is the
    children's split scores minus the parent's, and a large parent score
    would cancel the f32 noise of the two frameworks' different cumsum
    orders into the gain."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(f, n)).astype(np.int32)
    effect = (-3.0 * (bins[0] > 16) - 1.7 * (bins[1] > 8)
              - 0.9 * (bins[2] > 20) + 0.37 * (bins[3] > 5))
    grad = (effect - effect.mean()
            + rng.normal(scale=0.05, size=n)).astype(np.float32)
    hess = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    weight = (rng.random(n) < 0.9).astype(np.float32)
    return bins, grad, hess, weight


@pytest.mark.parametrize("extra", [
    {}, {"max_depth": 2}, {"lambda_l1": 0.5, "lambda_l2": 2.0},
    {"min_gain_to_split": 5.0},
])
def test_grow_tree_matches_jax(extra):
    bins, grad, hess, weight = _separated_fixture()
    f = bins.shape[0]
    fmask = np.ones(f, np.float32)
    fmask[5] = 0.0
    kw = dict(num_leaves=8, num_bins=32, min_data_in_leaf=20, **extra)
    jt, jleaf, jvals, jn = jtree.grow_tree(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(weight), jnp.asarray(fmask),
        jtree.GrowParams(hist_method="scatter", **kw))
    tt, tleaf, tvals, tn = ttree.grow_tree(
        *[torch.from_numpy(a) for a in (bins, grad, hess, weight, fmask)],
        ttree.GrowParams(hist_method="pallas", **kw))
    assert tn == int(jn)
    for k in TREE_KEYS:
        np.testing.assert_array_equal(getattr(tt, k),
                                      np.asarray(getattr(jt, k)), err_msg=k)
    np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))
    for k in ("value", "gain", "count"):
        np.testing.assert_allclose(getattr(tt, k), np.asarray(getattr(jt, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tvals.numpy(), np.asarray(jvals),
                               rtol=1e-5, atol=1e-6)


def test_predict_trees_matches_jax_nan_left():
    rng = np.random.default_rng(9)
    X = rng.normal(size=(300, 4)).astype(np.float32)
    X[::17, 2] = np.nan
    b = jtrain({"objective": "regression", "num_iterations": 3,
                "num_leaves": 7, "min_data_in_leaf": 5}, X,
               X[:, 2] + X[:, 0])
    tr = b.trees
    ref = np.asarray(jtree.predict_trees(
        jnp.asarray(X), *[jnp.asarray(tr[k]) for k in
                          ("feature", "threshold", "left", "right",
                           "value")], max_depth=6))
    got = ttree.predict_trees(
        torch.from_numpy(X), *[torch.from_numpy(np.ascontiguousarray(
            tr[k], dtype=np.float32 if k == "threshold" else None))
            for k in ("feature", "threshold", "left", "right", "value")],
        max_depth=6, row_block=128)
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# the slice: train and the estimators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_bin", [63, 255])
def test_train_binary_matches_jax(higgs, max_bin):
    Xtr, ytr, Xte, yte = higgs
    kw = {"objective": "binary", "num_iterations": 10, "num_leaves": 15,
          "max_bin": max_bin}
    jb = jtrain({**kw, "hist_method": "scatter"}, Xtr, ytr)
    HK.reset_launches()
    tb = ttrain(kw, Xtr, ytr, device="cpu")
    assert sum(HK.LAUNCHES.values()) == 0      # CPU: the plain version
    assert tb.params["hist_method"] == "scatter"
    assert tb.train_info["histograms"] == 10 * 15
    pj, pt = jb.predict(Xte), tb.predict(Xte)
    assert abs(_auc(yte, pj) - _auc(yte, pt)) < 0.005
    assert _auc(yte, pt) > 0.8
    # on this fixture the trees match, so predictions agree to f32 noise
    for k in TREE_KEYS:
        np.testing.assert_array_equal(tb.trees[k], jb.trees[k], err_msg=k)
    np.testing.assert_allclose(pt, pj, atol=1e-5)
    tk = ttrain({**kw, "hist_method": "pallas"}, Xtr, ytr, device="cpu")
    np.testing.assert_array_equal(tk.predict(Xte), pt)


@pytest.mark.parametrize("objective,extra", [
    ("regression", {}), ("multiclass", {"num_class": 3}),
    ("poisson", {}),
])
def test_train_other_objectives_match_jax(objective, extra):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(800, 5))
    if objective == "multiclass":
        y = np.digitize(X[:, 0] + 0.5 * X[:, 1], [-0.5, 0.5]).astype(float)
    elif objective == "poisson":
        y = rng.poisson(np.exp(0.5 * X[:, 0])).astype(float)
    else:
        y = 2.0 * X[:, 0] - X[:, 1] ** 2 + rng.normal(scale=0.1, size=800)
    kw = {"objective": objective, "num_iterations": 5, "num_leaves": 7,
          "max_bin": 31, "min_data_in_leaf": 10, **extra}
    jb = jtrain({**kw, "hist_method": "scatter"}, X, y)
    tb = ttrain(kw, X, y, device="cpu")
    for k in TREE_KEYS:
        np.testing.assert_array_equal(tb.trees[k], jb.trees[k], err_msg=k)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=1e-5,
                               atol=1e-5)


def test_classifier_fit_transform_matches_jax(higgs):
    Xtr, ytr, Xte, yte = higgs
    kw = dict(numIterations=8, numLeaves=15, maxBin=63)
    jm = JClassifier(**kw).fit(JTable({"features": Xtr, "label": ytr}))
    tm = mtt.TPUBoostClassifier(device="cpu", **kw).fit(
        mtt.DataTable({"features": Xtr, "label": ytr}))
    jo = jm.transform(JTable({"features": Xte, "label": yte}))
    to = tm.transform(mtt.DataTable({"features": Xte, "label": yte}))
    assert to.column_names == jo.column_names
    for col in ("rawPrediction", "probability"):
        assert to[col].shape == jo[col].shape
        assert to[col].dtype == np.asarray(jo[col]).dtype
        np.testing.assert_allclose(to[col], jo[col], atol=1e-5)
    np.testing.assert_array_equal(to["prediction"], jo["prediction"])
    assert to["prediction"].dtype == np.float64


def test_regressor_fit_transform_matches_jax():
    rng = np.random.default_rng(8)
    X = rng.normal(size=(600, 4))
    y = X[:, 0] * 3 + np.sin(X[:, 1])
    kw = dict(numIterations=6, numLeaves=7, maxBin=31, objective="huber",
              alpha=0.8)
    jo = JRegressor(**kw).fit(JTable({"features": X, "label": y})) \
        .transform(JTable({"features": X, "label": y}))
    to = mtt.TPUBoostRegressor(device="cpu", **kw).fit(
        mtt.DataTable({"features": X, "label": y})) \
        .transform(mtt.DataTable({"features": X, "label": y}))
    np.testing.assert_allclose(to["prediction"], jo["prediction"],
                               rtol=1e-5, atol=1e-5)


def test_estimator_params_carry_over():
    ours = {p.name: p.default for p in mtt.TPUBoostClassifier.params()}
    theirs = {p.name: p.default for p in JClassifier.params()}
    assert set(ours) - set(theirs) == {"device"}
    assert ours["device"] == "cuda"
    assert {k: ours[k] for k in theirs} == theirs


# ---------------------------------------------------------------------------
# forests across the two packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_forests(higgs):
    Xtr, ytr, _, _ = higgs
    rng = np.random.default_rng(1)
    ts = (1.7e9 + rng.integers(0, 600, size=(2000, 1))).astype(float)
    return {
        "binary": jtrain({"objective": "binary", "num_iterations": 6,
                          "num_leaves": 15, "max_bin": 63}, Xtr, ytr),
        "multiclass": jtrain({"objective": "multiclass", "num_class": 3,
                              "num_iterations": 3, "num_leaves": 7},
                             Xtr, (Xtr[:, 0] > 0) + (Xtr[:, 1] > 0.5)),
        # timestamp-scale feature: the forest needs the f64 walk
        "f64": jtrain({"objective": "binary", "num_iterations": 5,
                       "min_data_in_leaf": 5}, ts,
                      (ts[:, 0] % 600 > 300).astype(float)),
    }


@pytest.mark.parametrize("kind", ["binary", "multiclass", "f64"])
def test_jax_forest_scores_bit_equal_in_port(higgs, jax_forests, kind):
    jb = jax_forests[kind]
    X = (higgs[2] if kind != "f64" else
         (1.7e9 + np.random.default_rng(2).integers(0, 600, (500, 1)))
         .astype(float))
    assert jb._needs_f64_inference() == (kind == "f64")
    via_arrays = convert.booster_from_reference(
        jb.trees, jb.init_score, jb.objective, jb.num_class,
        jb.feature_names, jb.params, best_iteration=jb.best_iteration,
        tree_depths=jb.tree_depths, device="cpu")
    via_string = convert.booster_from_model_string(jb.model_to_string(),
                                                   device="cpu")
    for tb in (via_arrays, via_string):
        assert tb._needs_f64_inference() == (kind == "f64")
        # the forest walk and the tree sums are bit-equal ...
        np.testing.assert_array_equal(tb.raw_score(X), jb.raw_score(X))
        # ... and the link function differs by at most an ulp (XLA's and
        # torch's exp round differently)
        np.testing.assert_allclose(tb.predict(X), jb.predict(X),
                                   rtol=0, atol=2.5e-7)


def test_port_model_string_loads_in_jax(higgs):
    Xtr, ytr, Xte, _ = higgs
    tb = ttrain({"objective": "binary", "num_iterations": 4,
                 "num_leaves": 7, "max_bin": 63}, Xtr, ytr, device="cpu")
    s = tb.model_to_string()
    jb = JBooster.from_string(s)
    np.testing.assert_array_equal(jb.raw_score(Xte), tb.raw_score(Xte))
    back = mtt.Booster.from_string(jb.model_to_string(), device="cpu")
    assert back.model_to_string() == s


# ---------------------------------------------------------------------------
# rules of the port
# ---------------------------------------------------------------------------


def _port_files():
    return sorted((REPO / "mmlspark_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "flax", "optax", "msgpack",
                           "ml_dtypes", "mmlspark_tpu"):
                    bad.append(f"{path.relative_to(REPO)}: {name}")
    assert not bad, bad


def test_port_imports_and_fits_with_jax_blocked():
    code = """
import sys
sys.modules["jax"] = None
sys.modules["mmlspark_tpu"] = None
import numpy as np
import mmlspark_tpu_torch as mtt
rng = np.random.default_rng(0)
X = rng.normal(size=(300, 4)).astype(np.float32)
y = (X[:, 0] > 0).astype(np.float64)
t = mtt.DataTable({"features": X, "label": y})
out = mtt.TPUBoostClassifier(numIterations=3, numLeaves=7, maxBin=31,
                             device="cpu").fit(t).transform(t)
assert (out["prediction"] == y).mean() > 0.9
# quantized, bagged, feature-sampled, early-stopped on a validation set
m = mtt.TPUBoostClassifier(numIterations=20, numLeaves=7, maxBin=31,
                           histBits=16, baggingFraction=0.8, baggingFreq=1,
                           featureFraction=0.8, earlyStoppingRound=3,
                           validationData=t, keepTrainingData=False,
                           device="cpu").fit(t)
assert (m.transform(t)["prediction"] == y).mean() > 0.9
assert m.get_booster().best_iteration > 0
# sparse features (a CSR column) and an out-of-core sketch fit
from mmlspark_tpu_torch.core.sparse import CSRMatrix
from mmlspark_tpu_torch.io.ooc import ChunkedTable
Xs = np.where(np.abs(X) > 0.7, X, 0).astype(np.float32)
ts = mtt.DataTable({"features": CSRMatrix.from_dense(Xs), "label": y})
ms = mtt.TPUBoostClassifier(numIterations=3, numLeaves=7, maxBin=31,
                            device="cpu").fit(ts)
assert (ms.transform(ts)["prediction"] == y).mean() > 0.8
mc = mtt.TPUBoostClassifier(numIterations=3, numLeaves=7, maxBin=31,
                            binFit="sketch", device="cpu").fit(
    ChunkedTable.from_table(t, chunk_rows=100))
assert (mc.transform(t)["prediction"] == y).mean() > 0.9
assert not any(m.split(".")[0] in ("jax", "mmlspark_tpu")
               for m, v in sys.modules.items() if v is not None)
print("OK")
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(REPO), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OK" in r.stdout


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_the_cpu_unless_asked(no_card, higgs):
    Xtr, ytr, _, _ = higgs
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain({"objective": "binary", "num_iterations": 1}, Xtr, ytr)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mtt.TPUBoostClassifier(numIterations=1).fit(
            mtt.DataTable({"features": Xtr, "label": ytr}))
    tb = ttrain({"objective": "binary", "num_iterations": 1}, Xtr, ytr,
                device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mtt.Booster.from_string(tb.model_to_string())


@pytest.mark.parametrize("params", [
    {"parallelism": "data"}, {"parallelism": "feature"},
    {"parallelism": "voting"}, {"parallelism": "data", "hist_bits": 16},
], ids=["data", "feature", "voting", "data-q16"])
def test_parallel_modes_fit_as_a_group_of_one(params):
    """Outside a process group the distributed modes train as a group of
    one: every collective is the identity, so the forest is the serial
    one bitwise (voting with top_k >= F searches every feature; q16 data
    resolves hist_comm 'auto' to reduce_scatter, whose one slice holds
    every feature)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1500, 9)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] > 0).astype(np.float64)
    kw = {"objective": "binary", "num_iterations": 3, "num_leaves": 15,
          "max_bin": 31, "min_data_in_leaf": 5,
          "hist_bits": params.get("hist_bits", 32)}
    serial = ttrain(kw, X, y, device="cpu")
    got = ttrain({**kw, **params}, X, y, device="cpu")
    assert got.params["parallelism"] == params["parallelism"]
    assert got.params["hist_comm"] == (
        "reduce_scatter" if "hist_bits" in params else "psum")
    assert got.train_info["comm_bytes"] == {
        "psum": 0, "psum_scatter": 0, "all_gather": 0}
    for k in serial.trees:
        np.testing.assert_array_equal(got.trees[k], serial.trees[k],
                                      err_msg=k)


def test_estimator_parallelism_reaches_train():
    """``parallelism`` / ``histComm`` / ``topK`` of the estimator reach
    ``train`` (tests/test_gbdt.py::test_fp_estimator_stage's flow)."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(600, 12)).astype(np.float32)
    y = (X[:, 0] + X[:, 3] > 0).astype(np.int64)
    t = mtt.DataTable({"features": X, "label": y})
    model = mtt.TPUBoostClassifier(numIterations=8, numLeaves=15,
                                   parallelism="voting", topK=12,
                                   histComm="psum", device="cpu").fit(t)
    p = model.get_booster().params
    assert (p["parallelism"], p["top_k"], p["hist_comm"]) == \
        ("voting", 12, "psum")
    acc = np.mean(np.asarray(model.transform(t)["prediction"]) == y)
    assert acc > 0.9


@pytest.mark.parametrize("params", [
    {"hist_bits": 16}, {"hist_bits": 8},
    {"bagging_fraction": 0.5, "bagging_freq": 1},
    {"feature_fraction": 0.5},
    {"early_stopping_round": 5},
    {"keep_training_data": True},
])
def test_options_of_this_slice_no_longer_raise(params):
    # bagging, feature fraction, quantized training, early stopping and
    # keep_training_data were out of the slice until the port took them
    X = np.random.default_rng(0).normal(size=(50, 3))
    b = ttrain({"num_iterations": 2, "min_data_in_leaf": 5, **params}, X,
               X[:, 0], valid=(X, X[:, 0]), device="cpu")
    assert b.num_trees == 2


def test_warm_start_validation_and_streaming_raise():
    X = np.random.default_rng(0).normal(size=(50, 3))
    y = X[:, 0]
    # warm start and validation are in the slice: a bad model string and
    # a validation set of another width raise, as in the JAX package
    with pytest.raises(KeyError):
        ttrain({"num_iterations": 1}, X, y, init_model="{}", device="cpu")
    with pytest.raises(ValueError):
        ttrain({"num_iterations": 1, "early_stopping_round": 2}, X, y,
               valid=(X[:, :2], y), device="cpu")
    with pytest.raises(ValueError, match="validation data has shape"):
        ttrain({"num_iterations": 1, "early_stopping_round": 2}, X, y,
               valid=(CSRMatrix.from_dense(X[:, :2]), y), device="cpu")
    # streamed input cannot warm-start, as in the JAX package
    with pytest.raises(ValueError, match="requires dense X"):
        ttrain({"num_iterations": 1}, iter([(X, y)]), None,
               init_model="{}", device="cpu")


def _ingest_case(case):
    """Inputs that raised NotImplementedError ("GBDT ingest beyond dense
    input") until the port took them."""
    X = np.random.default_rng(0).normal(size=(60, 3))
    X[X < -0.5] = 0.0
    y = X[:, 0]
    kw = {"num_iterations": 2, "min_data_in_leaf": 5}
    if case == "bin_fit_sketch":
        return ttrain({**kw, "bin_fit": "sketch"}, X, y, device="cpu")
    if case == "bin_fit_sketch_hist_bits_8":
        return ttrain({**kw, "bin_fit": "sketch", "hist_bits": 8}, X, y,
                      device="cpu")
    if case == "csr_validation":
        return ttrain({**kw, "early_stopping_round": 2}, X, y,
                      valid=(CSRMatrix.from_dense(X), y), device="cpu")
    if case == "one_shot_stream":
        return ttrain(kw, iter([(X[:30], y[:30]), (X[30:], y[30:])]), None,
                      device="cpu")
    table = mtt.DataTable({"features": X, "label": y})
    return mtt.TPUBoostRegressor(numIterations=2, minDataInLeaf=5,
                                 device="cpu").fit(
        ChunkedTable.from_table(table, chunk_rows=20)).get_booster()


@pytest.mark.parametrize("case", [
    "bin_fit_sketch", "bin_fit_sketch_hist_bits_8", "csr_validation",
    "one_shot_stream", "chunked_table_fit"])
def test_ingest_beyond_dense_no_longer_raises(case):
    # these raised NotImplementedError (test_out_of_slice_options_raise's
    # two bin_fit='sketch' cases and test_warm_start_validation_and_
    # streaming_raise's three ingest raises) until the port took them
    b = _ingest_case(case)
    assert b.num_trees == 2


@pytest.mark.parametrize("method", ["auto", "pallas"])
def test_kernel_route_beyond_its_bin_range_raises_on_the_card(method):
    from mmlspark_tpu_torch.gbdt.booster import resolve_hist_method
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert resolve_hist_method(method, cuda, 2047) == "pallas"
    with pytest.raises(ValueError, match="hist_method='scatter'"):
        resolve_hist_method(method, cuda, 2048)
    assert resolve_hist_method("scatter", cuda, 4095) == "scatter"
    assert resolve_hist_method(method, cpu, 4095) == (
        "onehot" if method == "pallas" else "scatter")
