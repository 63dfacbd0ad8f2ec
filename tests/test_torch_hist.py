"""PyTorch port: the GBDT histogram against the JAX package.

The port's ``build_histogram`` on CPU tensors runs the plain version of
its CUDA kernel (``hist_kernels.hist_plain``); it is held against the
JAX ``build_histogram(..., 'pallas')`` in interpret mode, the TPU
kernels' own CPU path (same cases as tests/test_gbdt.py), and against
the JAX scatter path's exact integer mode. The kernel itself runs only
on a CUDA card: its tests are in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.gbdt.histogram import (
    _hist_scatter as jax_hist_scatter, build_histogram as jax_build,
)
from mmlspark_tpu_torch.gbdt import hist_kernels as HK
from mmlspark_tpu_torch.gbdt.histogram import build_histogram


def skewed_bins(rng, f, n, B, skew):
    """(f, n) int32 bins: uniform over [0, B) (skew None), all bin 0
    ('constant'), bins 0 and B - 1 only ('binary'), or 90 % of the rows
    in bin 0 and the rest uniform over [1, B) ('bin0_90')."""
    if skew is None:
        return rng.integers(0, B, size=(f, n)).astype(np.int32)
    if skew == "constant":
        return np.zeros((f, n), np.int32)
    if skew == "binary":
        return ((B - 1) * (rng.random((f, n)) < 0.5)).astype(np.int32)
    assert skew == "bin0_90"
    rest = rng.integers(1, max(B, 2), size=(f, n))
    return np.where(rng.random((f, n)) < 0.9, 0, rest).astype(np.int32)


def _inputs(n, f, L, B, seed=2, skew=None):
    rng = np.random.default_rng(seed)
    return (skewed_bins(rng, f, n, B, skew),
            rng.normal(size=n).astype(np.float32),
            rng.uniform(0.1, 1, size=n).astype(np.float32),
            (rng.random(n) < 0.8).astype(np.float32),
            rng.integers(0, L, size=n).astype(np.int32))


def _torch(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _case(n, f, L, B, skew=None):
    tag = f"{n}-{f}-{L}-{B}" + (f"-{skew}" if skew else "")
    return pytest.param(n, f, L, B, skew, id=tag)


CASES = [
    _case(700, 20, 6, 16),     # multi-leaf, B < 128: the _hist_kernel route
    _case(600, 20, 1, 256),    # single-leaf B=256: the nibble route
    _case(600, 20, 1, 160),
    _case(600, 20, 1, 100),    # padded B=128, the edge of the nibble route
    _case(100, 3, 4, 8),
    # skewed features, where one bin holds most rows: a constant column, a
    # binary one, one with 90 % of its rows in bin 0
    _case(600, 20, 1, 256, "constant"),
    _case(600, 20, 1, 256, "binary"),
    _case(600, 20, 1, 256, "bin0_90"),
    _case(700, 20, 6, 16, "bin0_90"),
]


@pytest.mark.parametrize("n,f,L,B,skew", CASES)
def test_plain_matches_jax_pallas_interpret(n, f, L, B, skew):
    arrs = _inputs(n, f, L, B, skew=skew)
    ref = np.asarray(jax_build(*[jnp.asarray(a) for a in arrs], L, B,
                               "pallas"))
    got = build_histogram(*_torch(*arrs), L, B, method="pallas")
    assert got.dtype == torch.float32 and got.shape == (3, L, f, B)
    # f32 sums in a different order: rtol/atol 1e-5
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["scatter", "onehot"])
def test_other_methods_match_jax(method):
    arrs = _inputs(500, 4, 6, 16, seed=1)
    ref = np.asarray(jax_build(*[jnp.asarray(a) for a in arrs], 6, 16,
                               method))
    got = build_histogram(*_torch(*arrs), 6, 16, method=method)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sdt", [np.int16, np.int8])
@pytest.mark.parametrize("with_count", [False, True])
def test_integer_stats_exact(sdt, with_count):
    rng = np.random.default_rng(3)
    n, f, L, B = 900, 7, 3, 64
    hi = 120 if sdt == np.int8 else 3000
    bins = rng.integers(0, B, size=(f, n)).astype(np.int32)
    g = rng.integers(-hi, hi, size=n).astype(sdt)
    h = rng.integers(0, hi, size=n).astype(sdt)
    w = (rng.random(n) < 0.7).astype(sdt)
    leaf = rng.integers(0, L, size=n).astype(np.int32)
    cv = rng.integers(0, hi, size=n).astype(sdt) if with_count else None
    ref = np.asarray(jax_hist_scatter(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), jnp.asarray(w),
        jnp.asarray(leaf), L, B,
        count_values=None if cv is None else jnp.asarray(cv)))
    got = build_histogram(*_torch(bins, g, h, w, leaf), L, B,
                          method="pallas",
                          count_values=None if cv is None
                          else torch.from_numpy(cv))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_cpu_tensors_never_count_as_launches():
    HK.reset_launches()
    build_histogram(*_torch(*_inputs(100, 3, 1, 8)), 1, 8, method="pallas")
    assert HK.LAUNCHES == {"_hist_kernel_nibble": 0, "_hist_kernel": 0}


@pytest.mark.parametrize("L,B,route", [(1, 255, "_hist_kernel_nibble"),
                                       (1, 97, "_hist_kernel_nibble"),
                                       (1, 96, "_hist_kernel"),
                                       (1, 64, "_hist_kernel"),
                                       (6, 256, "_hist_kernel")])
def test_tpu_route_matches_block_plan(L, B, route):
    from mmlspark_tpu.gbdt.pallas_hist import _block_plan
    assert _block_plan(20, 600, B, L)[0] == (route == "_hist_kernel_nibble")
    assert HK.tpu_route(L, B) == route


@pytest.mark.parametrize("f,n,L,B", [(28, 1_000_000, 1, 256),
                                     (28, 1_000_000, 1, 64),
                                     (20, 700, 6, 16),
                                     (5, 100, 1, 2048),
                                     (3, 10, 4, 8)])
def test_launch_plan_geometry(f, n, L, B, monkeypatch):
    # the plan is a function of (F, N, L, B) alone: it reads nothing of the
    # card, so the chunking (the f32 summation order) is the same on all
    def no_card(*a, **k):
        raise AssertionError("launch_plan asked the card")
    for name in ("get_device_properties", "device_count", "is_available",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    HK.launch_plan.cache_clear()
    plan = HK.launch_plan(f, n, L, B)
    assert plan == HK.launch_plan(f, n, L, B)
    ft, warps, rows, n_chunks, cap, smem = plan
    assert 1 <= warps <= HK.MAX_WARPS and warps <= ft
    assert -(-ft // warps) * warps - ft < warps   # balanced features a warp
    assert smem == HK._smem(ft, L, B, cap) <= HK.SMEM_MAX
    assert cap in (plan.piece, 2 * plan.piece)
    n_ftiles = -(-f // ft)
    assert n_ftiles * ft >= f > (n_ftiles - 1) * ft   # features once each
    assert rows % 32 == 0 and n_chunks <= HK.TARGET_BLOCKS
    # every row is covered exactly once: chunk by chunk, piece by piece,
    # and the staged list never outgrows cap (the kernel's own loop, with
    # every row active)
    cover = np.zeros(n, np.int32)
    for c in range(n_chunks):
        r0, r1 = c * rows, min(n, (c + 1) * rows)
        assert r0 < r1
        staged = 0
        for p0 in range(r0, r1, plan.piece):
            p1 = min(p0 + plan.piece, r1)
            cover[p0:p1] += 1
            staged += p1 - p0
            assert staged <= cap
            if p0 + plan.piece >= r1 or staged + plan.piece > cap:
                staged = 0
    assert (cover == 1).all()
    if (f, n) == (28, 1_000_000):
        # the main path: one block holds every feature of its chunk, and
        # the chunk count is the fixed target
        assert ft == 28 and n_chunks == HK.TARGET_BLOCKS


@pytest.mark.parametrize("L,B", [(1, 2049), (1, 0), (64, 512)])
def test_launch_plan_refuses_out_of_range(L, B):
    with pytest.raises(ValueError):
        HK.launch_plan(10, 1000, L, B)


def test_distributed_histogram_not_ported():
    with pytest.raises(NotImplementedError, match="Distributed GBDT"):
        build_histogram(*_torch(*_inputs(50, 2, 1, 8)), 1, 8,
                        method="pallas", axis_name="data")
