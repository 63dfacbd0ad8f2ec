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


def _inputs(n, f, L, B, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, B, size=(f, n)).astype(np.int32),
            rng.normal(size=n).astype(np.float32),
            rng.uniform(0.1, 1, size=n).astype(np.float32),
            (rng.random(n) < 0.8).astype(np.float32),
            rng.integers(0, L, size=n).astype(np.int32))


def _torch(*arrs):
    return [torch.from_numpy(a) for a in arrs]


CASES = [
    (700, 20, 6, 16),     # multi-leaf, B < 128: the _hist_kernel route
    (600, 20, 1, 256),    # single-leaf B=256: the _hist_kernel_nibble route
    (600, 20, 1, 160),
    (600, 20, 1, 100),    # padded B=128, the edge of the nibble route
    (100, 3, 4, 8),
]


@pytest.mark.parametrize("n,f,L,B", CASES)
def test_plain_matches_jax_pallas_interpret(n, f, L, B):
    arrs = _inputs(n, f, L, B)
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


def test_launch_plan_geometry():
    # HIGGS shape: 28 features in 4 tiles of 7 warps, ~528 blocks, whole
    # warps of rows, every row covered exactly once
    f_tile, rows, n_chunks, smem = HK.launch_plan(28, 1_000_000, 1, 256)
    assert f_tile == 7 and rows % 32 == 0
    assert rows * n_chunks >= 1_000_000 > rows * (n_chunks - 1)
    assert smem == 7 * 3 * 256 * 4 <= HK.SMEM_MAX
    assert 4 * n_chunks <= HK.TARGET_BLOCKS + 4
    # tiny inputs get one chunk
    assert HK.launch_plan(3, 10, 4, 8)[2] == 1
    # the widest single-leaf histogram still fits a block
    assert HK.launch_plan(5, 100, 1, 2048)[0] >= 1


@pytest.mark.parametrize("L,B", [(1, 2049), (1, 0), (64, 512)])
def test_launch_plan_refuses_out_of_range(L, B):
    with pytest.raises(ValueError):
        HK.launch_plan(10, 1000, L, B)


def test_distributed_histogram_not_ported():
    with pytest.raises(NotImplementedError, match="Distributed GBDT"):
        build_histogram(*_torch(*_inputs(50, 2, 1, 8)), 1, 8,
                        method="pallas", axis_name="data")
