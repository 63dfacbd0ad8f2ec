"""PyTorch port: the GBDT's random bits and sampling masks against JAX.

The port reproduces ``jax.random``'s threefry bits in torch
(``mmlspark_tpu_torch/gbdt/prng.py``): ``PRNGKey``, ``fold_in`` and
``uniform`` are pinned bitwise, then the JAX package's
``_index_uniforms`` and ``sample_iteration_masks`` (bagging and feature
fraction, with the exact-k count and its ``uf <= kth`` tie rule), then a
bagged, feature-sampled fit on the HIGGS-shaped fixture of
``tests/test_gbdt_dist_quant.py``. Everything runs on the CPU
(``device="cpu"``; the JAX package on its scatter path).

What a fit can and cannot pin across the two packages: the trees'
structure and counts come out bitwise; the leaf values differ in their
last bits, because the JAX package's f32 arithmetic is XLA's: its f32
sums (a histogram bin, a leaf's total over its bins) add in another
order than torch's, on the CPU it contracts the score update
``s + lr * v`` into one FMA, and its ``exp`` rounds differently from
torch's. The values are held to rtol 1e-5, as ``test_torch_gbdt.py``
holds them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.gbdt import tree as jtree
from mmlspark_tpu.gbdt.booster import train as jtrain

from mmlspark_tpu_torch.gbdt import prng
from mmlspark_tpu_torch.gbdt import tree as ttree
from mmlspark_tpu_torch.gbdt.booster import train as ttrain

STRUCT_KEYS = ("feature", "bin_threshold", "left", "right", "count")


def _higgs_shape(n=6000, seed=7):
    """The HIGGS-shaped fixture of tests/test_gbdt_dist_quant.py."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 28)).astype(np.float32)
    logit = (X[:, 0] + 0.6 * X[:, 1] * X[:, 2]
             + 0.4 * np.sin(2 * X[:, 3]) - 0.3 * X[:, 4] ** 2 + 0.3)
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return X, y


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


SEEDS = [0, 7, 2 ** 31 - 1]
DATA = [0, 1, 2 ** 20, 2 ** 31 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_fold_in_uniform_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert tuple(np.asarray(jk).tolist()) == tk
    assert _bits(jax.random.uniform(jk)) == _bits(prng.uniform(tk))
    for d in DATA:
        jf, tf = jax.random.fold_in(jk, d), prng.fold_in(tk, d)
        assert tuple(np.asarray(jf).tolist()) == tf, (seed, d)
        assert _bits(jax.random.uniform(jf)) == _bits(prng.uniform(tf))
        # a key folded twice, as the masks and the rounding fold it
        assert tuple(np.asarray(jax.random.fold_in(jf, 3)).tolist()) == \
            prng.fold_in(tf, 3)


def test_index_uniforms_bitwise_over_10000_ids():
    key = jax.random.fold_in(jax.random.PRNGKey(7), 11)
    ids = np.arange(10_000)
    ref = jtree._index_uniforms(key, jnp.asarray(ids))
    got = ttree._index_uniforms(tuple(np.asarray(key).tolist()),
                                torch.from_numpy(ids))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))
    # counter-based: a prefix draws the same values
    head = ttree._index_uniforms(tuple(np.asarray(key).tolist()),
                                 torch.arange(100))
    np.testing.assert_array_equal(_bits(head.numpy()), _bits(ref)[:100])


def _masks_both(seed, it, n, f, bag_cfg, ff_cfg):
    rng = np.random.default_rng(seed + it)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    fm = np.ones(f, np.float32)
    jw, jf = jtree.sample_iteration_masks(
        jax.random.PRNGKey(seed), jnp.int32(it), jnp.asarray(w),
        jnp.asarray(fm), bag_cfg, ff_cfg, f, f)
    tw, tf = ttree.sample_iteration_masks(
        prng.PRNGKey(seed), it, torch.from_numpy(w), torch.from_numpy(fm),
        bag_cfg, ff_cfg, f, f)
    return (np.asarray(jw), np.asarray(jf)), (tw.numpy(), tf.numpy())


@pytest.mark.parametrize("frac", [0.5, 0.8])
@pytest.mark.parametrize("freq", [1, 3])
def test_bagging_masks_bitwise(frac, freq):
    for it in (0, 1, 2, 5):
        (jw, _), (tw, _) = _masks_both(7, it, 3000, 28, (frac, freq), None)
        np.testing.assert_array_equal(tw, jw, err_msg=f"it={it}")
        kept = (tw != 0).mean()
        assert abs(kept - frac) < 0.05, kept
    # freq > 1 reuses the bag between resamples
    (_, _), (a, _) = _masks_both(7, 3, 3000, 28, (frac, 3), None)
    (_, _), (b, _) = _masks_both(7, 5, 3000, 28, (frac, 3), None)
    np.testing.assert_array_equal(a != 0, b != 0)


@pytest.mark.parametrize("ff", [0.0, 0.3, 0.8])
def test_feature_fraction_masks_bitwise_exact_k(ff):
    f = 28
    k = max(1, int(np.ceil(ff * f)))
    for it in (0, 1, 2, 5):
        (_, jf), (_, tf) = _masks_both(3, it, 100, f, None, ff)
        np.testing.assert_array_equal(tf, jf, err_msg=f"it={it}")
        assert int((tf != 0).sum()) == k
    # and the seed matters, at feature_fraction 0.0 (one feature) too
    picks = {tuple(_masks_both(s, 0, 100, f, None, ff)[1][1] != 0)
             for s in range(6)}
    assert len(picks) > 1


def test_feature_fraction_ties_keep_more_than_k(monkeypatch):
    # uniforms tied with the k-th smallest all stay (uf <= kth), in both
    tied = np.array([0.5, 0.1, 0.5, 0.9, 0.5, 0.7], np.float32)
    monkeypatch.setattr(jtree, "_index_uniforms",
                        lambda key, ids: jnp.asarray(tied[:len(ids)]))
    monkeypatch.setattr(ttree, "_index_uniforms",
                        lambda key, ids: torch.from_numpy(tied[:len(ids)]))
    fm = np.ones(6, np.float32)
    _, jf = jtree.sample_iteration_masks(
        jax.random.PRNGKey(0), jnp.int32(0), jnp.ones(4), jnp.asarray(fm),
        None, 0.3, 6, 6)
    _, tf = ttree.sample_iteration_masks(
        prng.PRNGKey(0), 0, torch.ones(4), torch.from_numpy(fm), None, 0.3,
        6, 6)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    # k = ceil(0.3 * 6) = 2: the 2nd smallest is 0.5, held three times
    np.testing.assert_array_equal(tf.numpy(), [1, 1, 1, 0, 1, 0])


_KW = {"objective": "binary", "num_iterations": 6, "num_leaves": 15,
       "max_bin": 63, "min_data_in_leaf": 5}
_SAMPLED = {"bagging_fraction": 0.8, "bagging_freq": 1,
            "feature_fraction": 0.8}


def test_bagged_feature_sampled_fit_matches_jax():
    X, y = _higgs_shape()
    Xtr, ytr = X[:4096], y[:4096]
    kw = {**_KW, **_SAMPLED, "seed": 7}
    jb = jtrain({**kw, "hist_method": "scatter"}, Xtr, ytr)
    tb = ttrain(kw, Xtr, ytr, device="cpu")
    assert tb.num_trees == jb.num_trees == 6
    for k in STRUCT_KEYS:
        np.testing.assert_array_equal(tb.trees[k], jb.trees[k], err_msg=k)
    np.testing.assert_allclose(tb.trees["value"], jb.trees["value"],
                               rtol=1e-5, atol=1e-7)
    # the bags were active: a tree's root holds about 80 % of the rows
    root_left = tb.trees["count"][:, 1] + tb.trees["count"][:, 2]
    assert (root_left < 0.9 * 4096).all() and (root_left > 0.7 * 4096).all()
    # a different seed draws other bags
    other = ttrain({**kw, "seed": 8}, Xtr, ytr, device="cpu")
    assert not np.array_equal(other.trees["count"], tb.trees["count"])
