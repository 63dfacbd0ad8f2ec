"""PyTorch port: the CUDA histogram kernel against its plain version.

Needs a CUDA card of compute capability >= 9.0 (marked ``cuda``; each
test skips without one). This file imports neither JAX nor the JAX
package, so on a machine with the card and without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.gbdt import hist_kernels as HK

CASES = [
    (700, 20, 6, 16),     # multi-leaf, B < 128: the _hist_kernel route
    (600, 20, 1, 256),    # single-leaf B=256: the _hist_kernel_nibble route
    (600, 20, 1, 160),
    (600, 20, 1, 100),
    (100, 3, 4, 8),
    (100_000, 28, 1, 256),
    (5000, 4, 1, 2048),   # the widest bin range: > 48 KB of shared memory
]


@pytest.fixture
def card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA card of compute capability >= 9.0")
    return torch.device("cuda")


def _inputs(n, f, L, B, sdt=np.float32, seed=2):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(f, n)).astype(np.int32)
    leaf = rng.integers(0, L, size=n).astype(np.int32)
    if sdt == np.float32:
        return (bins, rng.normal(size=n).astype(np.float32),
                rng.uniform(0.1, 1, size=n).astype(np.float32),
                (rng.random(n) < 0.8).astype(np.float32), leaf, None)
    hi = 120 if sdt == np.int8 else 3000
    return (bins, rng.integers(-hi, hi, size=n).astype(sdt),
            rng.integers(0, hi, size=n).astype(sdt),
            (rng.random(n) < 0.7).astype(sdt), leaf,
            rng.integers(0, hi, size=n).astype(sdt))


def _on(dev, arrs):
    return [None if a is None else torch.from_numpy(a).to(dev)
            for a in arrs]


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,L,B", CASES)
def test_cuda_kernel_matches_plain(card, n, f, L, B):
    b, g, h, w, leaf, _ = _on(card, _inputs(n, f, L, B))
    HK.reset_launches()
    got = HK.hist_device(b, g, h, w, leaf, L, B)
    again = HK.hist_device(b, g, h, w, leaf, L, B)
    torch.cuda.synchronize()
    assert sum(HK.LAUNCHES.values()) == 2
    assert HK.LAUNCHES[HK.tpu_route(L, B)] == 2
    assert torch.equal(got, again)       # no order-dependent atomics
    ref = HK.hist_plain(b, g.double(), h.double(), w.double(), leaf, L, B)
    # f32 sums in another order than the float64 reference
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("sdt", [np.int16, np.int8])
@pytest.mark.parametrize("with_count", [False, True])
def test_cuda_kernel_integer_stats_exact(card, sdt, with_count):
    n, f, L, B = 50_000, 7, 3, 64
    b, g, h, w, leaf, cv = _on(card, _inputs(n, f, L, B, sdt))
    cv = cv if with_count else None
    got = HK.hist_device(b, g, h, w, leaf, L, B, cv)
    ref = HK.hist_plain(b, g, h, w, leaf, L, B, cv)
    assert got.dtype == torch.int32
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_bad_inputs(card):
    b, g, h, w, leaf, _ = _on(card, _inputs(100, 3, 1, 8))
    with pytest.raises(ValueError):
        HK.hist_device(b.long(), g, h, w, leaf, 1, 8)
    with pytest.raises(ValueError):
        HK.hist_device(b, g.double(), h, w, leaf, 1, 8)
    with pytest.raises(ValueError):
        HK.hist_device(b, g, h.cpu(), w, leaf, 1, 8)
    with pytest.raises(ValueError):
        HK.hist_device(b, g, h, w, leaf, 1, 4096)
