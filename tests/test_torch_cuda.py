"""PyTorch port: the CUDA kernels against their plain versions.

Needs a CUDA card of compute capability >= 9.0 (marked ``cuda``; each
test skips without one). This file imports neither JAX nor the JAX
package, so on a machine with the card and without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.gbdt import hist_kernels as HK
from mmlspark_tpu_torch.models.networks import build_network
from mmlspark_tpu_torch.models.tpu_model import TPUModel
from mmlspark_tpu_torch.ops import flash_attention as FA

def _case(n, f, L, B, skew=None, active=0.8):
    tag = (f"{n}-{f}-{L}-{B}" + (f"-{skew}" if skew else "")
           + (f"-active{active:g}" if active != 0.8 else ""))
    return pytest.param(n, f, L, B, skew, active, id=tag)


CASES = [
    _case(700, 20, 6, 16),     # multi-leaf, B < 128: the _hist_kernel route
    _case(600, 20, 1, 256),    # single-leaf B=256: the nibble route
    _case(600, 20, 1, 160),
    _case(600, 20, 1, 100),
    _case(100, 3, 4, 8),
    _case(100_000, 28, 1, 256),
    _case(5000, 4, 1, 2048),   # the widest bin range: > 48 KB of shared memory
    # the tree grower's launches: a masked right child (a scattered 5 % of
    # the rows), a root (every row), no row at all, a ragged row count
    _case(100_000, 28, 1, 256, active=0.05),
    _case(100_000, 28, 1, 256, active=1.0),
    _case(100_000, 28, 1, 256, active=0.0),
    _case(99_999, 5, 3, 64, active=0.3),
    # skewed features: a constant column, a binary one, 90 % in bin 0
    _case(100_000, 28, 1, 256, "constant"),
    _case(100_000, 28, 1, 256, "binary"),
    _case(100_000, 28, 1, 256, "bin0_90"),
    _case(20_000, 6, 6, 16, "bin0_90"),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA card of compute capability >= 9.0")
    return torch.device("cuda")


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


def _inputs(n, f, L, B, sdt=np.float32, seed=2, skew=None, active=None):
    rng = np.random.default_rng(seed)
    bins = skewed_bins(rng, f, n, B, skew)
    leaf = rng.integers(0, L, size=n).astype(np.int32)
    if sdt == np.float32:
        active = 0.8 if active is None else active
        return (bins, rng.normal(size=n).astype(np.float32),
                rng.uniform(0.1, 1, size=n).astype(np.float32),
                (rng.random(n) < active).astype(np.float32), leaf, None)
    active = 0.7 if active is None else active
    hi = 120 if sdt == np.int8 else 3000
    return (bins, rng.integers(-hi, hi, size=n).astype(sdt),
            rng.integers(0, hi, size=n).astype(sdt),
            (rng.random(n) < active).astype(sdt), leaf,
            rng.integers(0, hi, size=n).astype(sdt))


def _on(dev, arrs):
    return [None if a is None else torch.from_numpy(a).to(dev)
            for a in arrs]


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,L,B,skew,active", CASES)
def test_cuda_kernel_matches_plain(card, n, f, L, B, skew, active):
    b, g, h, w, leaf, _ = _on(card, _inputs(n, f, L, B, skew=skew,
                                            active=active))
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
@pytest.mark.parametrize("sdt", [np.int16, np.int8])
@pytest.mark.parametrize("skew", ["constant", "binary", "bin0_90"])
def test_cuda_kernel_skewed_integer_stats_exact(card, sdt, skew):
    n, f, L, B = 100_000, 28, 1, 256
    b, g, h, w, leaf, cv = _on(card, _inputs(n, f, L, B, sdt, skew=skew))
    got = HK.hist_device(b, g, h, w, leaf, L, B, cv)
    again = HK.hist_device(b, g, h, w, leaf, L, B, cv)
    assert torch.equal(got, again)
    assert torch.equal(got, HK.hist_plain(b, g, h, w, leaf, L, B, cv))


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


# (B, Lq, Lk, H, D, causal, q_offset, k_offset): the slice's shape, the
# ragged cases of tests/test_flash_attention.py, shard offsets, a fully
# masked shard, a wide head, the tile edges of the tensor-core kernels
# (Lq, Lk in {1, 17, 65, 1000}, D in {8, 20, 64, 256}) and a long causal
# sequence (the truncating tensor-core sums must not drift), as
# chip_smoke.py's FLASH_CASES
FLASH_CASES = [
    (8, 1024, 1024, 16, 128, True, 0, 0),
    (2, 100, 100, 3, 16, True, 0, 0),
    (2, 300, 520, 3, 16, False, 0, 0),
    (2, 520, 300, 3, 16, True, 0, 0),
    (1, 64, 64, 2, 8, True, 64, 0),
    (1, 32, 32, 2, 8, True, 0, 1000),
    (1, 300, 300, 2, 160, True, 0, 0),
    (1, 1, 1, 2, 64, True, 0, 0),
    (1, 17, 65, 2, 20, False, 0, 0),
    (1, 65, 17, 2, 8, True, 0, 0),
    (1, 65, 1000, 2, 64, True, 935, 0),
    (1, 1000, 65, 3, 64, False, 0, 0),
    (2, 1000, 1000, 2, 256, True, 0, 0),
    (1, 8192, 8192, 1, 128, True, 0, 0),
]


def _qkv(dev, b, lq, lk, h, d, dtype, seed=0, unaligned=False):
    """q, k, v; unaligned: views one element into rows of D + 1, so that
    no row starts on a 16-byte boundary (the kernels' element-wise
    staging)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    e = int(unaligned)

    def mk(length):
        return torch.randn((b, length, h, d + e), generator=g,
                           device=dev).to(dtype)[..., e:]
    return mk(lq), mk(lk), mk(lk)


def _assert_flash_close(got, ref, dtype):
    out, lse = got
    rout, rlse = ref
    if dtype == torch.float32:
        # f32 sums in another order than the float64 reference
        torch.testing.assert_close(out.double(), rout, rtol=1e-4, atol=1e-4)
    else:
        # one rounding of the f32 result to bfloat16 (half an ulp, 2**-9)
        torch.testing.assert_close(out.double(), rout, rtol=2 ** -8,
                                   atol=1e-5)
    torch.testing.assert_close(lse.double(), rlse, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_matches_plain(card, case, dtype):
    b, lq, lk, h, d, causal, qo, ko = case
    q, k, v = _qkv(card, b, lq, lk, h, d, dtype, seed=lq + lk)
    FA.reset_launches()
    got = FA.flash_forward(q, k, v, causal, qo, ko)
    again = FA.flash_forward(q, k, v, causal, qo, ko)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["_fwd_kernel"] == 2
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    assert got[0].shape == (b, lq, h, d) and got[1].shape == (b, h, lq)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    ref = FA.flash_forward_plain(q.double(), k.double(), v.double(),
                                 causal, qo, ko)
    _assert_flash_close(got, ref, dtype)
    if ko == 1000:
        assert torch.all(got[0] == 0) and torch.all(got[1] == FA.NEG_INF)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_reads_strided_qkv_views(card, dtype):
    """The q / k / v of a TransformerBlock: views of one (B, L, 3*H*D)
    projection, read in place through their strides."""
    b, l, h, d = 2, 600, 4, 32
    g = torch.Generator(device=card).manual_seed(5)
    qkv = torch.randn((b, l, 3 * h * d), generator=g, device=card).to(dtype)
    q, k, v = (t.view(b, l, h, d) for t in qkv.split(h * d, dim=-1))
    assert not q.is_contiguous()
    got = FA.flash_forward(q, k, v, True)
    ref = FA.flash_forward_plain(q.double(), k.double(), v.double(), True)
    _assert_flash_close(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_reads_unaligned_views(card, dtype):
    """Rows that do not start on a 16-byte boundary: the bf16 kernels
    stage them element by element, forward and backward alike."""
    b, l, h, d = 1, 300, 2, 64
    q, k, v = _qkv(card, b, l, l, h, d, dtype, seed=13, unaligned=True)
    assert q.data_ptr() % 16 != 0 and q.stride(-1) == 1
    FA.reset_launches()
    got = FA.flash_forward(q, k, v, True)
    assert FA.LAUNCHES["_fwd_kernel"] == 1      # read in place, not copied
    _assert_flash_close(got, FA.flash_forward_plain(
        q.double(), k.double(), v.double(), True), dtype)
    out, lse = got
    gout = torch.randn(out.shape, generator=torch.Generator(
        device=card).manual_seed(3), device=card).to(dtype)
    grads = FA.flash_backward(q, k, v, out, lse, gout, True)
    ref = FA.flash_backward_plain(q.double(), k.double(), v.double(),
                                  out.double(), lse.double(), gout.double(),
                                  True)
    _assert_grads_close(grads, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [20, 40, 128])
def test_cuda_flash_f32_relabelled_products(card, d):
    """The f32 forward (3xTF32) feeds P from its accumulator fragments
    to P V with k relabelled (key 2t as logical k t, 2t+1 as t+4) and
    reads V with the same relabelling: a slip would pair a probability
    with another key's value row. Held at a non-causal, non-power-of-two
    Lk, where every key of every tile counts, with rows of V far apart."""
    q, k, v = _qkv(card, 2, 50, 77, 3, d, torch.float32, seed=d)
    v = v + torch.arange(77, device=card, dtype=torch.float32)[
        None, :, None, None]
    got = FA.flash_forward(q, k, v, False)
    ref = FA.flash_forward_plain(q.double(), k.double(), v.double(), False)
    _assert_flash_close(got, ref, torch.float32)


@pytest.mark.cuda
def test_cuda_flash_bf16_launches_repeat_bitwise(card):
    """The tensor-core kernels at the slice's shape: no atomics and no
    order that changes between launches, so repeats are bitwise equal."""
    q, k, v = _qkv(card, 8, 1024, 1024, 16, 128, torch.bfloat16, seed=21)
    runs = []
    for _ in range(3):
        out, lse = FA.flash_forward(q, k, v, True)
        g = (out.float() * 0.5).to(torch.bfloat16)
        runs.append((out, lse, *FA.flash_backward(q, k, v, out, lse, g,
                                                  True)))
    torch.cuda.synchronize()
    for again in runs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(runs[0], again))


@pytest.mark.cuda
def test_cuda_flash_wrapper_refuses_bad_inputs(card):
    q, k, v = _qkv(card, 1, 64, 64, 2, 16, torch.float32)
    with pytest.raises(ValueError):
        FA.flash_forward(*_qkv(card, 1, 64, 64, 1, 272, torch.float32))
    with pytest.raises(ValueError):
        FA.flash_forward(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        FA.flash_forward(q, k.cpu(), v)
    with pytest.raises(ValueError):
        FA.flash_forward(q, k[:, :, :1], v)


def _assert_grads_close(got, ref, dtype):
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        if dtype == torch.float32:
            # f32 sums in another order than the float64 reference
            torch.testing.assert_close(a.double(), b, rtol=1e-4, atol=1e-4,
                                       msg=name)
        else:
            # one rounding of the f32 result to bfloat16
            torch.testing.assert_close(a.double(), b, rtol=2 ** -8,
                                       atol=1e-5, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_backward_matches_plain(card, case, dtype):
    b, lq, lk, h, d, causal, qo, ko = case
    q, k, v = _qkv(card, b, lq, lk, h, d, dtype, seed=lq + lk + 1)
    out, lse = FA.flash_forward(q, k, v, causal, qo, ko)
    g = torch.randn(out.shape, generator=torch.Generator(
        device=card).manual_seed(7), device=card).to(dtype)
    FA.reset_launches()
    got = FA.flash_backward(q, k, v, out, lse, g, causal, qo, ko)
    again = FA.flash_backward(q, k, v, out, lse, g, causal, qo, ko)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == {"_fwd_kernel": 0, "_dq_kernel": 2,
                           "_dkv_kernel": 2}
    pairs = FA.unmasked_pairs(lq, lk, causal, qo, ko)
    assert FA.FLOPS["_dq_kernel"] == 2 * 6 * d * b * h * pairs
    assert FA.FLOPS["_dkv_kernel"] == 2 * 8 * d * b * h * pairs
    for a, b2, like in zip(got, again, (q, k, v)):
        assert a.dtype == dtype and a.shape == like.shape
        assert torch.equal(a, b2)          # no order-dependent atomics
    ref = FA.flash_backward_plain(q.double(), k.double(), v.double(),
                                  out.double(), lse.double(), g.double(),
                                  causal, qo, ko)
    _assert_grads_close(got, ref, dtype)
    if ko == 1000:
        assert all(torch.all(t == 0) for t in got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_autograd_through_strided_qkv_views(card, dtype):
    """The gradient of a TransformerBlock's attention: q / k / v views of
    one (B, L, 3*H*D) projection, through forward and both backward
    kernels, against the same graph on the CPU in float64 (the plain
    versions). In bf16 the backward is held to the plain backward in
    float64 on the kernel forward's own (out, lse), as the other bf16
    checks are: the float64 graph's out differs from the bf16 out by
    one rounding, which the gradients would carry."""
    b, l, h, d = 2, 600, 4, 32
    gen = torch.Generator(device=card).manual_seed(11)
    qkv = torch.randn((b, l, 3 * h * d), generator=gen, device=card
                      ).to(dtype)
    g = torch.randn((b, l, h, d), generator=gen, device=card).to(dtype)

    def split(proj):
        return [t.view(b, l, h, d) for t in proj.split(h * d, dim=-1)]

    def grad_of(proj, gout):
        proj = proj.detach().requires_grad_(True)
        (FA.flash_attention(*split(proj), causal=True) * gout).sum(
            ).backward()
        return proj.grad
    FA.reset_launches()
    got = grad_of(qkv, g)
    assert FA.LAUNCHES == {"_fwd_kernel": 1, "_dq_kernel": 1,
                           "_dkv_kernel": 1}
    if dtype == torch.float32:
        ref = grad_of(qkv.cpu().double(), g.cpu().double())
        assert FA.LAUNCHES["_dq_kernel"] == 1   # the CPU never launches
        torch.testing.assert_close(got.cpu().double(), ref, rtol=1e-4,
                                   atol=1e-4)
    else:
        q, k, v = split(qkv)
        out, lse = FA.flash_forward(q, k, v, True)
        ref = FA.flash_backward_plain(q.double(), k.double(), v.double(),
                                      out.double(), lse.double(),
                                      g.double(), True)
        _assert_grads_close(split(got), ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 20, 64, 128, 256])
def test_cuda_flash_f32_backward_relabelled_products(card, d):
    """The f32 backward (3xTF32) feeds dS and P^T from their accumulator
    fragments to dS K, dS^T Q and P^T dO with k relabelled (row 2t as
    logical k t, 2t+1 as t+4), and reads K, Q and dO from swizzled tiles
    in both orientations: a slip would pair a gradient with another
    key's or query's row. Held at a non-causal, non-power-of-two Lq and
    Lk, where every key of every tile counts, with D = 20 staged element
    by element."""
    q, k, v = _qkv(card, 2, 50, 77, 3, d, torch.float32, seed=d)
    out, lse = FA.flash_forward(q, k, v, False)
    g = torch.randn(out.shape, generator=torch.Generator(
        device=card).manual_seed(d + 1), device=card)
    FA.reset_launches()
    got = FA.flash_backward(q, k, v, out, lse, g, False)
    assert FA.LAUNCHES["_dq_kernel"] == FA.LAUNCHES["_dkv_kernel"] == 1
    ref = FA.flash_backward_plain(q.double(), k.double(), v.double(),
                                  out.double(), lse.double(), g.double(),
                                  False)
    _assert_grads_close(got, ref, torch.float32)


@pytest.mark.cuda
def test_cuda_flash_backward_refuses_bad_inputs(card):
    q, k, v = _qkv(card, 1, 64, 64, 2, 16, torch.float32)
    out, lse = FA.flash_forward(q, k, v, True)
    with pytest.raises(ValueError):
        FA.flash_backward(q, k, v, out, lse.double(), out, True)
    with pytest.raises(ValueError):
        FA.flash_backward(q, k, v, out, lse[:, :1], out, True)
    with pytest.raises(ValueError):
        FA.flash_backward(q, k, v, out, lse, out.cpu(), True)
    with pytest.raises(ValueError):
        FA.flash_backward_cuda(q.cpu(), k.cpu(), v.cpu(), out.cpu(),
                               lse.cpu(), out.cpu(), True)


@pytest.mark.cuda
def test_cuda_learner_fit_matches_cpu(card):
    """TPULearner on the card (flash forward and backward kernels) against
    the same fit on the CPU (their plain versions), from the same weights:
    a small L = 512 Transformer, 4 SGD steps at a constant rate."""
    from mmlspark_tpu_torch.models.learner import TPULearner
    spec = {"type": "transformer", "vocab_size": 64, "dim": 32, "depth": 2,
            "heads": 4, "max_len": 512}
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 64, size=(8, 512)).astype(np.float32)
    table = DataTable({"features": toks,
                       "label": np.roll(toks.astype(np.int64), -1, 1)})
    init = build_network(spec, device="cpu", seed=4).state_dict()

    def fit(device):
        module = build_network(spec, device="cpu", seed=0)
        module.load_state_dict(init)
        learner = TPULearner(moduleFactory=lambda: module, device=device,
                             loss="token_cross_entropy", optimizer="sgd",
                             schedule="constant", learningRate=0.5,
                             batchSize=4, epochs=2, computeDtype="float32",
                             logEvery=1)
        model = learner.fit(table)
        return learner, model
    FA.reset_launches()
    lg, mg = fit("cuda")
    assert FA.LAUNCHES == {"_fwd_kernel": 8, "_dq_kernel": 8,
                           "_dkv_kernel": 8}
    lc, mc = fit("cpu")
    np.testing.assert_allclose([h["loss"] for h in lg.history],
                               [h["loss"] for h in lc.history], rtol=1e-4)
    wg, wc = mg.get("weights"), mc.get("weights")
    for name in wc:
        np.testing.assert_allclose(wg[name].cpu().numpy(),
                                   wc[name].numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=name)


@pytest.mark.cuda
def test_cuda_tpumodel_transform_matches_cpu(card):
    """TPUModel on the card (flash kernel, pinned uploads, side-stream
    readback, bf16 head widened on the host) against the same weights on
    the CPU (plain version): three micro-batches, the last one ragged."""
    spec = {"type": "transformer", "vocab_size": 300, "dim": 64,
            "depth": 2, "heads": 4, "max_len": 512}
    tokens = np.random.default_rng(0).integers(0, 300, size=(19, 512))
    table = DataTable({"tokens": tokens})
    module = build_network(spec, device="cpu", seed=3)
    ref = TPUModel.from_module(module, device="cpu", inputCol="tokens",
                               outputCol="logits", batchSize=8
                               ).transform(table)["logits"]
    model = TPUModel.from_module(module, device=card, inputCol="tokens",
                                 outputCol="logits", batchSize=8)
    FA.reset_launches()
    got = model.transform(table)["logits"]
    assert FA.LAUNCHES["_fwd_kernel"] == spec["depth"] * 3
    assert got.shape == (19, 512, 300) and got.dtype == np.float32
    # f32 throughout (TF32 off): the card and the CPU sum in other orders
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    m = model.metrics()
    assert m["pad_ms"]["count"] == m["readback_ms"]["count"] == 3


@pytest.mark.cuda
def test_cuda_gbdt_served_over_http_equals_transform(card, tmp_path):
    """A GBDT model fit on the card (hist kernel), saved, loaded and
    served from the card through json_scoring_pipeline and the row
    scorer: every reply equals transform's value for its row
    (rawPrediction bitwise)."""
    import json
    import threading
    import time
    import urllib.request
    from mmlspark_tpu_torch.core.stage import load_stage
    from mmlspark_tpu_torch.gbdt.estimators import TPUBoostClassifier
    from mmlspark_tpu_torch.serving import (
        json_row_scoring_pipeline, json_scoring_pipeline, serve_model)

    rng = np.random.default_rng(2)
    X = rng.normal(size=(20_000, 28)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float32)
    HK.reset_launches()
    fitted = TPUBoostClassifier(numIterations=4, numLeaves=15,
                                device="cuda").fit(
        DataTable({"features": X, "label": y}))
    assert sum(HK.LAUNCHES.values()) > 0
    fitted.save(str(tmp_path / "m"))
    model = load_stage(str(tmp_path / "m"))
    assert model.get("device") == "cuda"
    rows = X[:64]
    want = model.transform(DataTable({"features": rows}))

    def post(addr, row):
        req = urllib.request.Request(
            addr, data=json.dumps({"features": row.tolist()}).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
            return json.loads(r.read())

    for scorer, key, expect in (
            (json_scoring_pipeline(model), "prediction",
             [{"prediction": int(p)} for p in want["prediction"]]),
            (json_row_scoring_pipeline(model, reply_col="rawPrediction"),
             "rawPrediction", want["rawPrediction"].tolist())):
        engine = serve_model(scorer, port=0, batch_size=16, workers=2,
                             max_wait_ms=5)
        try:
            got = {}

            def client(i):
                for j in range(i, len(rows), 8):
                    got[j] = post(engine.source.address, rows[j])

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert [got[j] for j in range(len(rows))] == expect, key
            deadline = time.monotonic() + 10
            while engine.source.requests_answered < len(rows) and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            assert engine.source.requests_answered == len(rows)
            assert engine.is_alive()
        finally:
            engine.stop()
