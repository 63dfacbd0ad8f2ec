"""PyTorch port: quantized GBDT training (hist_bits 16 / 8) against JAX.

The JAX grower rounds each tree's gradients, hessians and weights to
int16 / int8 once (stochastic rounding under global-L1 scales, keyed on
the row id) and builds exact int32 histograms. The port does the same
(``mmlspark_tpu_torch/gbdt/tree.py``: ``quant_scales``, ``_sround``,
``quantize_stats``), on the CPU through the histogram kernel's plain
version. Pinned here:

  - the rounding, given the same scales and key: bitwise;
  - one quantized tree from the same inputs, when the two packages'
    float32 L1 sums agree (asserted first): bitwise, values included;
  - a quantized fit on the HIGGS-shaped fixture: its first tree bitwise,
    at 16 bits every tree's structure bitwise and the holdout AUC within
    0.005 of the JAX fit's;
  - at 569 rows (the breast-cancer fixture) the L1 sums differ in their
    last bit between XLA's order and torch's: the test states it, pins
    the rounding given the reference's scales, and holds the two fits'
    training AUC within 0.005;
  - hist_bits=32 explicit equals the default; q16 holdout AUC within
    0.005 of f32 (the rule of tests/test_gbdt_dist_quant.py:101); the
    errors for onehot and for an unsupported width.

Later trees of a fit differ in their last bits for the reasons
``test_torch_sampling.py`` gives (XLA's FMA-contracted score update, its
``exp``, its f32 sum order); a one-ulp change of a scale can flip one
row's rounding, and at 8 bits that can move a split.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.gbdt import tree as jtree
from mmlspark_tpu.gbdt.binning import BinMapper as JBinMapper
from mmlspark_tpu.gbdt.booster import train as jtrain

from mmlspark_tpu_torch.gbdt import hist_kernels as HK
from mmlspark_tpu_torch.gbdt import prng
from mmlspark_tpu_torch.gbdt import tree as ttree
from mmlspark_tpu_torch.gbdt.booster import train as ttrain

ALL_KEYS = ("feature", "bin_threshold", "left", "right", "value", "count")
STRUCT_KEYS = ("feature", "bin_threshold", "left", "right", "count")
_KW = {"objective": "binary", "num_iterations": 6, "num_leaves": 15,
       "max_bin": 63, "min_data_in_leaf": 5}
SDT = {16: (jnp.int16, torch.int16), 8: (jnp.int8, torch.int8)}


def _higgs_shape(n=6000, seed=7):
    """The HIGGS-shaped fixture of tests/test_gbdt_dist_quant.py."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 28)).astype(np.float32)
    logit = (X[:, 0] + 0.6 * X[:, 1] * X[:, 2]
             + 0.4 * np.sin(2 * X[:, 3]) - 0.3 * X[:, 4] ** 2 + 0.3)
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return X, y


def _auc(y, p):
    order = np.argsort(p, kind="stable")
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    n_pos = int((y == 1).sum())
    n_neg = len(y) - n_pos
    return (ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


@pytest.fixture(scope="module")
def higgs():
    X, y = _higgs_shape()
    return X[:4096], y[:4096], X[4096:], y[4096:]


@pytest.fixture(scope="module")
def fits(higgs):
    """One fit per (package, hist_bits) on the HIGGS-shaped fixture."""
    Xtr, ytr, _, _ = higgs
    out = {}
    for bits in (32, 16, 8):
        kw = {**_KW, "hist_bits": bits}
        out["jax", bits] = jtrain({**kw, "hist_method": "scatter"}, Xtr, ytr)
        out["port", bits] = ttrain(kw, Xtr, ytr, device="cpu")
    return out


def _jax_scales(g, h, w, bits):
    """The JAX grower's scale expression (tree.py:281-291)."""
    Q = 1 << (bits - 2)
    gw, hw = g * w, h * w
    s = jnp.stack([jnp.sum(jnp.abs(gw)), jnp.sum(jnp.abs(hw)),
                   jnp.sum(jnp.abs(w))])
    tiny = jnp.float32(1e-30)
    return [np.asarray(jnp.maximum(s[i], tiny) / Q) for i in range(3)]


def _jax_sround(vals, delta, key, chan, bits):
    """The JAX grower's ``_sround`` (tree.py:296-305), serial."""
    x = vals / delta
    fl = jnp.floor(x)
    u = jtree._index_uniforms(jax.random.fold_in(key, chan),
                              jnp.arange(vals.shape[0]))
    return np.asarray((fl + (u < (x - fl))).astype(SDT[bits][0]))


def _iter0_stats(y, w):
    """Iteration-0 binary gradients / hessians from the JAX objective."""
    from mmlspark_tpu.gbdt.objectives import get_objective
    obj = get_objective("binary")
    s0 = np.float32(obj.init_score(y.astype(np.float64),
                                   w.astype(np.float64))[0])
    g, h = obj.grad_hess(jnp.full(len(y), s0), jnp.asarray(y, jnp.float32))
    return np.array(g), np.array(h)


@pytest.mark.parametrize("bits", [16, 8])
def test_sround_bitwise_given_scales_and_key(bits):
    rng = np.random.default_rng(bits)
    n = 5000
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.05, 0.25, size=n).astype(np.float32)
    w = (rng.random(n) < 0.8).astype(np.float32) * rng.uniform(0.5, 2, n) \
        .astype(np.float32)
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(5), 2), 3)
    tkey = prng.fold_in(prng.fold_in(prng.PRNGKey(5), 2), 3)
    deltas = _jax_scales(jnp.asarray(g), jnp.asarray(h), jnp.asarray(w), bits)
    sdt = SDT[bits][1]
    for chan, vals in enumerate((g * w, h * w, w)):
        ref = _jax_sround(jnp.asarray(vals), jnp.asarray(deltas[chan]), jkey,
                          chan, bits)
        got = ttree._sround(torch.from_numpy(vals),
                            torch.tensor(deltas[chan]), tkey, chan, sdt)
        assert got.dtype == sdt
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"{chan}")
        assert (got.numpy()[w == 0] == 0).all()     # 0-weight rows: 0


@pytest.mark.parametrize("bits", [16, 8])
def test_quantized_grow_tree_matches_jax(higgs, bits):
    Xtr, ytr, _, _ = higgs
    mapper = JBinMapper.fit(Xtr, max_bin=63)
    bins = mapper.transform_fm(Xtr).astype(np.int32)
    w = np.ones(len(ytr), np.float32)
    g, h = _iter0_stats(ytr, w)
    fm = np.ones(28, np.float32)
    # the pin needs the same scales: assert first that XLA's and torch's
    # float32 L1 sums agree on these inputs
    js = _jax_scales(jnp.asarray(g), jnp.asarray(h), jnp.asarray(w), bits)
    ts = ttree.quant_scales(torch.from_numpy(g), torch.from_numpy(h),
                            torch.from_numpy(w), bits)
    for a, b in zip(js, ts):
        assert a.view(np.uint32) == b.numpy().view(np.uint32), (a, b)
    kw = dict(num_leaves=15, num_bins=int(mapper.num_bins.max()),
              min_data_in_leaf=5, hist_bits=bits)
    jk = jax.random.fold_in(jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(7), 0), 3), 0)
    tk = prng.fold_in(prng.fold_in(prng.fold_in(prng.PRNGKey(7), 0), 3), 0)
    jt, jleaf, jvals, jn = jtree.grow_tree(
        *[jnp.asarray(a) for a in (bins, g, h, w, fm)],
        jtree.GrowParams(hist_method="scatter", **kw), quant_key=jk)
    tt, tleaf, tvals, tn = ttree.grow_tree(
        *[torch.from_numpy(a) for a in (bins, g, h, w, fm)],
        ttree.GrowParams(hist_method="pallas", **kw), quant_key=tk)
    assert tn == int(jn)
    for k in ALL_KEYS + ("is_leaf",):
        np.testing.assert_array_equal(getattr(tt, k),
                                      np.asarray(getattr(jt, k)), err_msg=k)
    np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))


def test_quantized_grow_tree_needs_a_key_and_a_width():
    t = torch.zeros(8)
    bins = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="quant_key"):
        ttree.grow_tree(bins, t, t + 1, t + 1, torch.ones(2),
                        ttree.GrowParams(num_leaves=2, num_bins=4,
                                         hist_bits=16))
    with pytest.raises(ValueError, match="hist_bits=12"):
        ttree.grow_tree(bins, t, t + 1, t + 1, torch.ones(2),
                        ttree.GrowParams(num_leaves=2, num_bins=4,
                                         hist_bits=12), quant_key=(0, 1))


@pytest.mark.parametrize("bits", [16, 8])
def test_quantized_fit_matches_jax(fits, higgs, bits):
    _, _, Xte, yte = higgs
    jb, tb = fits["jax", bits], fits["port", bits]
    assert tb.num_trees == jb.num_trees == 6
    assert tb.train_info["histograms"] == int(
        (~tb.trees["is_leaf"]).sum() + tb.num_trees)
    for k in ALL_KEYS:     # the first tree: iteration 0's scales agree
        np.testing.assert_array_equal(tb.trees[k][0], jb.trees[k][0],
                                      err_msg=k)
    if bits == 16:
        for k in STRUCT_KEYS:
            np.testing.assert_array_equal(tb.trees[k], jb.trees[k],
                                          err_msg=k)
        np.testing.assert_allclose(tb.trees["value"], jb.trees["value"],
                                   rtol=1e-5, atol=1e-6)
    a_j, a_t = _auc(yte, jb.predict(Xte)), _auc(yte, tb.predict(Xte))
    assert a_t > 0.5 and a_j > 0.5
    if bits == 16:
        assert abs(a_j - a_t) < 0.005, (a_j, a_t)
    # at 8 bits the later trees part ways (a one-ulp scale difference
    # moves splits) and the holdout AUCs with them: no closeness is held


def test_hist_bits_32_explicit_equals_default(fits, higgs):
    Xtr, ytr, _, _ = higgs
    default = ttrain(_KW, Xtr, ytr, device="cpu")
    for k in ALL_KEYS + ("is_leaf", "gain", "threshold"):
        np.testing.assert_array_equal(fits["port", 32].trees[k],
                                      default.trees[k], err_msg=k)


def test_q16_auc_within_0005_of_f32(fits, higgs):
    _, _, Xte, yte = higgs
    auc32 = _auc(yte, fits["port", 32].predict(Xte))
    auc16 = _auc(yte, fits["port", 16].predict(Xte))
    assert auc32 > 0.80
    assert abs(auc32 - auc16) < 0.005, (auc32, auc16)


def test_quantized_fit_kernel_route_equals_plain_on_cpu(fits, higgs):
    # hist_method='pallas' on CPU tensors runs the kernel's plain
    # version, so it must give the scatter path's forest bitwise
    Xtr, ytr, _, _ = higgs
    HK.reset_launches()
    tk = ttrain({**_KW, "hist_bits": 16, "hist_method": "pallas"}, Xtr,
                ytr, device="cpu")
    assert sum(HK.LAUNCHES.values()) == 0
    assert sum(HK.LAUNCHES_BY_TYPE.values()) == 0
    for k in ALL_KEYS:
        np.testing.assert_array_equal(tk.trees[k],
                                      fits["port", 16].trees[k], err_msg=k)


def test_569_rows_l1_scales_differ_in_order_and_fits_agree():
    from sklearn.datasets import load_breast_cancer
    X, y = load_breast_cancer(return_X_y=True)
    # the L2 objective's iteration-0 gradients, f32(mean y) - y, as both
    # packages compute them (exact): their float32 L1 sum over 569 rows
    # differs in the last bit between XLA's order and torch's
    g = (np.float32(np.mean(y)) - y.astype(np.float32)).astype(np.float32)
    h = np.ones_like(g)
    w = np.ones_like(g)
    js = _jax_scales(jnp.asarray(g), jnp.asarray(h), jnp.asarray(w), 16)
    ts = ttree.quant_scales(torch.from_numpy(g), torch.from_numpy(h),
                            torch.from_numpy(w), 16)
    assert js[0] != ts[0].item(), "the sums agree: restate this test"
    assert js[1] == ts[1].item() and js[2] == ts[2].item()  # exact sums
    # given the reference's scale the rounding is bitwise
    key = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    ref = _jax_sround(jnp.asarray(g), jnp.asarray(js[0]), key, 0, 16)
    got = ttree._sround(torch.from_numpy(g), torch.tensor(js[0]),
                        tuple(np.asarray(key).tolist()), 0, torch.int16)
    np.testing.assert_array_equal(got.numpy(), ref)
    # and the two fits (q16, L2 on the 0/1 labels) rank alike
    kw = {"objective": "regression", "num_iterations": 6, "num_leaves": 15,
          "max_bin": 63, "min_data_in_leaf": 5, "hist_bits": 16}
    jb = jtrain({**kw, "hist_method": "scatter"}, X, y)
    tb = ttrain(kw, X, y, device="cpu")
    a_j, a_t = _auc(y, jb.predict(X)), _auc(y, tb.predict(X))
    assert abs(a_j - a_t) < 0.005, (a_j, a_t)


def test_quantized_onehot_and_unsupported_width_raise():
    X = np.zeros((64, 2), np.float32)
    y = np.zeros(64, np.float32)
    with pytest.raises(ValueError, match="onehot"):
        ttrain({"objective": "regression", "hist_bits": 16,
                "hist_method": "onehot"}, X, y, device="cpu")
    with pytest.raises(ValueError, match="hist_bits=12"):
        ttrain({"objective": "regression", "hist_bits": 12}, X, y,
               device="cpu")
