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


def _gbdt_table(n=20_000, seed=7):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 28)).astype(np.float32)
    y = (X[:, 0] + 0.6 * X[:, 1] * X[:, 2] + 0.3
         + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return X, y


@pytest.mark.cuda
def test_cuda_sampling_masks_and_rounding_equal_cpu(card):
    """The threefry draws are integer ops: the bagging / feature-fraction
    masks and the stochastic rounding of the same float32 stats under the
    same scales and key come out bitwise equal on the card and the CPU."""
    from mmlspark_tpu_torch.gbdt import prng
    from mmlspark_tpu_torch.gbdt.tree import (
        _sround, quant_scales, sample_iteration_masks)
    key = prng.PRNGKey(7)
    cpu = torch.device("cpu")
    w = {d: torch.ones(100_000, device=d) for d in (card, cpu)}
    fm = {d: torch.ones(28, device=d) for d in (card, cpu)}
    for it in range(3):
        wg, fg = sample_iteration_masks(key, it, w[card], fm[card],
                                        (0.8, 1), 0.3, 28, 28)
        wc, fc = sample_iteration_masks(key, it, w[cpu], fm[cpu],
                                        (0.8, 1), 0.3, 28, 28)
        assert torch.equal(wg.cpu(), wc) and torch.equal(fg.cpu(), fc)
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=100_000).astype(np.float32))
    h = torch.from_numpy(rng.uniform(0.05, 0.25, 100_000).astype(np.float32))
    wc = torch.from_numpy((rng.random(100_000) < 0.8).astype(np.float32))
    for bits, sdt in ((16, torch.int16), (8, torch.int8)):
        scales = quant_scales(g, h, wc, bits)
        for chan, (v, d) in enumerate(zip((g * wc, h * wc, wc), scales)):
            a = _sround(v, d, key, chan, sdt)
            b = _sround(v.to(card), d.to(card), key, chan, sdt)
            assert torch.equal(a, b.cpu()), (bits, chan)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,max_bin", [(16, 255), (8, 63)])
def test_cuda_quantized_fit_launches_the_int_kernel(card, bits, max_bin,
                                                    monkeypatch):
    """A quantized fit on the card launches the int16 / int8 kernel once
    per histogram and never the f32 one, and each of its trees is the one
    the CPU grows from that tree's inputs under the card's three scales
    (structure, gains, values, leaf of every row). The card's and the
    CPU's f32 L1 sums may differ in the last bit, and at 8 bits that ulp
    can flip a near-tied split, so the two whole fits are held by AUC at
    16 bits only."""
    from mmlspark_tpu_torch.gbdt import booster as booster_mod
    from mmlspark_tpu_torch.gbdt import tree as tree_mod
    from mmlspark_tpu_torch.gbdt.booster import train
    X, y = _gbdt_table(24_000)
    kw = {"objective": "binary", "num_iterations": 5, "num_leaves": 15,
          "max_bin": max_bin, "hist_bits": bits, "seed": 7}
    grown, scales = [], []
    grow, quant_scales = booster_mod.grow_tree, tree_mod.quant_scales

    def rec_grow(bins, grad, hess, w, fm, gp, quant_key=None):
        out = grow(bins, grad, hess, w, fm, gp, quant_key=quant_key)
        grown.append(([t.cpu() for t in (bins, grad, hess, w, fm)], gp,
                      quant_key, out[0], out[1].cpu()))
        return out

    def rec_scales(*a):
        deltas = quant_scales(*a)
        scales.append(deltas.cpu())
        return deltas
    with monkeypatch.context() as m:
        m.setattr(booster_mod, "grow_tree", rec_grow)
        m.setattr(tree_mod, "quant_scales", rec_scales)
        HK.reset_launches()
        bg = train(kw, X[:20_000], y[:20_000], device="cuda")
        launches = dict(HK.LAUNCHES_BY_TYPE)
    sdt = f"int{bits}"
    assert launches[sdt] == bg.train_info["histograms"] > 0
    assert sum(launches.values()) == launches[sdt]
    assert len(grown) == len(scales) == 5
    for t, (inputs, gp, key, card_tree, card_leaf) in enumerate(grown):
        with monkeypatch.context() as m:
            m.setattr(tree_mod, "quant_scales", lambda *a: scales[t])
            tr, leaf_of_row, _, _ = tree_mod.grow_tree(*inputs, gp,
                                                       quant_key=key)
        for k in tr._fields:
            np.testing.assert_array_equal(getattr(tr, k),
                                          getattr(card_tree, k),
                                          err_msg=f"tree {t} {k}")
        assert torch.equal(leaf_of_row, card_leaf), t
    bc = train(kw, X[:20_000], y[:20_000], device="cpu")

    def auc(b):
        p = b.predict(X[20_000:])
        yt = y[20_000:]
        order = np.argsort(p, kind="stable")
        ranks = np.empty(len(p))
        ranks[order] = np.arange(1, len(p) + 1)
        n_pos = int(yt.sum())
        return (ranks[yt == 1].sum() - n_pos * (n_pos + 1) / 2) / (
            n_pos * (len(yt) - n_pos))
    if bits == 16:
        assert abs(auc(bg) - auc(bc)) < 0.005
    assert auc(bg) > 0.6 and auc(bc) > 0.6


@pytest.mark.cuda
def test_cuda_retained_continuation_bitwise(card):
    """On the card too, keep_training_data + boost_more(3) gives the
    forest of one longer run bitwise (q16, bagging, feature fraction)."""
    from mmlspark_tpu_torch.gbdt.booster import train
    X, y = _gbdt_table()
    kw = {"objective": "binary", "num_iterations": 3, "num_leaves": 15,
          "max_bin": 63, "hist_bits": 16, "seed": 3,
          "bagging_fraction": 0.7, "bagging_freq": 1,
          "feature_fraction": 0.8}
    one = train({**kw, "num_iterations": 6}, X, y, device="cuda")
    grown = train({**kw, "keep_training_data": True}, X, y,
                  device="cuda").boost_more(3)
    assert grown.num_trees == one.num_trees == 6
    for k in one.trees:
        np.testing.assert_array_equal(grown.trees[k], one.trees[k],
                                      err_msg=k)


# ---------------------------------------------------------------------------
# GBDT ingest beyond dense input: host binning, CSR fits, sparse-skew bins
# ---------------------------------------------------------------------------


def _csr_table(n=24_000, f=200, density=0.2, seed=7):
    """A CSR table (f32 nonzeros at ``density``) and a noisy label."""
    from mmlspark_tpu_torch.core.sparse import CSRMatrix
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[rng.random((n, f)) >= density] = 0
    logit = X[:, :20] @ rng.normal(scale=0.7, size=20)
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return CSRMatrix.from_dense(X), y


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_host_binning_library_equals_numpy(card, dtype):
    """On the card's machine, the OpenMP library that bins a card fit's
    host input (csrc/bins.cpp) equals its plain numpy version bitwise,
    over all features and over a feature range."""
    from mmlspark_tpu_torch.gbdt.binning import BinMapper
    X, _ = _gbdt_table(200_000)
    X = X.astype(dtype)
    X[::37, 3] = np.nan
    m = BinMapper.fit(X, max_bin=255)
    ref = m._numpy_bin_block(X, 0, 28)
    got = m.transform_fm(X, native=True)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(m.transform_fm_range(X, 4, 19,
                                                       native=True),
                                  ref[4:19])
    np.testing.assert_array_equal(m.transform(X, native=True), ref.T)


@pytest.mark.cuda
def test_cuda_csr_fit_matches_cpu(card, monkeypatch):
    """A CSR fit on the card bins exactly as the CPU fit of the same CSR
    (the same cuts, and the bins it ships equal transform_sparse's), and
    each tree of a quantized (hist_bits 16) CSR fit on the card is the
    one the CPU grows from that tree's inputs under the card's scales,
    bitwise; the f32 fits agree on holdout AUC within 0.005 (their f32
    histogram sums add in another order)."""
    from mmlspark_tpu_torch.gbdt import booster as booster_mod
    from mmlspark_tpu_torch.gbdt import tree as tree_mod
    from mmlspark_tpu_torch.gbdt.booster import train
    csr, y = _csr_table()
    tr, te, ytr, yte = csr[:20_000], csr[20_000:], y[:20_000], y[20_000:]
    kw = {"objective": "binary", "num_iterations": 5, "num_leaves": 15,
          "max_bin": 255, "seed": 7}
    grown, scales = [], []
    grow, quant_scales = booster_mod.grow_tree, tree_mod.quant_scales

    def rec_grow(bins, grad, hess, w, fm, gp, quant_key=None):
        out = grow(bins, grad, hess, w, fm, gp, quant_key=quant_key)
        grown.append(([t.cpu() for t in (bins, grad, hess, w, fm)], gp,
                      quant_key, out[0], out[1].cpu()))
        return out

    def rec_scales(*a):
        deltas = quant_scales(*a)
        scales.append(deltas.cpu())
        return deltas
    with monkeypatch.context() as m:
        m.setattr(booster_mod, "grow_tree", rec_grow)
        m.setattr(tree_mod, "quant_scales", rec_scales)
        HK.reset_launches()
        bg = train({**kw, "hist_bits": 16}, tr, ytr, device="cuda")
        launches = dict(HK.LAUNCHES_BY_TYPE)
    assert launches["int16"] == bg.train_info["histograms"] > 0
    bc = train({**kw, "hist_bits": 16}, tr, ytr, device="cpu")
    for u, v in zip(bg.bin_mapper.upper_bounds, bc.bin_mapper.upper_bounds):
        np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(grown[0][0][0].numpy(),
                                  bc.bin_mapper.transform_sparse(tr))
    for t, (inputs, gp, key, card_tree, card_leaf) in enumerate(grown):
        with monkeypatch.context() as m:
            m.setattr(tree_mod, "quant_scales", lambda *a: scales[t])
            tr_, leaf_of_row, _, _ = tree_mod.grow_tree(*inputs, gp,
                                                        quant_key=key)
        for k in tr_._fields:
            np.testing.assert_array_equal(getattr(tr_, k),
                                          getattr(card_tree, k),
                                          err_msg=f"tree {t} {k}")
        assert torch.equal(leaf_of_row, card_leaf), t
    # f32: the card's CSR fit against the CPU's, by holdout AUC
    fg = train(kw, tr, ytr, device="cuda")
    fc = train(kw, tr, ytr, device="cpu")

    def auc(b):
        p = b.predict(te)
        order = np.argsort(p, kind="stable")
        ranks = np.empty(len(p))
        ranks[order] = np.arange(1, len(p) + 1)
        n_pos = int(yte.sum())
        return (ranks[yte == 1].sum() - n_pos * (n_pos + 1) / 2) / (
            n_pos * (len(yte) - n_pos))
    assert abs(auc(fg) - auc(fc)) < 0.005 and auc(fg) > 0.7
    np.testing.assert_array_equal(fg.predict(te), fg.predict(te.toarray()))


@pytest.mark.cuda
@pytest.mark.parametrize("active", [1.0, 0.05])
def test_cuda_kernel_on_sparse_skew_bins_matches_plain(card, active):
    """The kernel on the bins of a CSR table with 95 % of each feature's
    rows in its zero bin (the peer-mask and xor-tree path for equal keys)
    equals the plain version in float64 (rtol 1e-5, atol 1e-3), at a
    root and at a scattered 5 % child; two launches bitwise equal."""
    from mmlspark_tpu_torch.gbdt.binning import BinMapper
    csr, _ = _csr_table(n=200_000, f=64, density=0.05, seed=3)
    m = BinMapper.fit_sparse(csr, max_bin=255)
    bins_np = m.transform_sparse(csr)
    zero_bin = np.asarray([np.searchsorted(u, 0.0)
                           for u in m.upper_bounds])
    assert (bins_np == zero_bin[:, None]).mean() > 0.94
    B = int(m.num_bins.max())
    rng = np.random.default_rng(5)
    n = csr.shape[0]
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.uniform(0.1, 1, size=n).astype(np.float32)
    w = (rng.random(n) < active).astype(np.float32)
    leaf = np.zeros(n, np.int32)
    bins, g, h, wd, lf = _on(card, [bins_np, grad, hess, w, leaf])
    out = HK.hist_device(bins, g, h, wd, lf, 1, B)
    again = HK.hist_device(bins, g, h, wd, lf, 1, B)
    assert torch.equal(out, again)
    ref = HK.hist_plain(*_on(torch.device("cpu"), [
        bins_np, grad.astype(np.float64), hess.astype(np.float64),
        w.astype(np.float64), leaf]), 1, B)
    torch.testing.assert_close(out.double().cpu(), ref, rtol=1e-5,
                               atol=1e-3)


# the zoo's image and sequence networks: (spec, one input row's shape)
ZOO = {
    "convnet": ({"type": "convnet", "conv_features": [16, 32],
                 "dense_features": [32], "num_classes": 10}, (32, 32, 3)),
    "resnet-cifar": ({"type": "resnet", "stage_sizes": [1, 1], "width": 16,
                      "num_classes": 10}, (32, 32, 3)),
    "resnet-imagenet": ({"type": "resnet", "stage_sizes": [1, 1, 1, 1],
                         "width": 16, "num_classes": 10,
                         "stem": "imagenet"}, (64, 64, 3)),
    "bilstm": ({"type": "bilstm", "vocab_size": 50, "embed_dim": 32,
                "hidden": 64, "num_tags": 3}, (12,)),
}


def _zoo_module(case, dtype="float32", seed=5):
    """The case's module on the CPU with seeded weights, its BatchNorm
    running buffers moved off 0 / 1, and an input batch of 16 rows."""
    spec, row = ZOO[case]
    module = build_network(dict(spec, dtype=dtype), device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in module.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5
                      if name.endswith("running_var")
                      else 0.1 * torch.randn(buf.shape, generator=g))
        for name, p in module.named_parameters():
            if "BatchNorm" in name and name.endswith("weight"):
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=g))
    rng = np.random.default_rng(seed)
    if spec["type"] == "bilstm":
        x = rng.integers(0, spec["vocab_size"], size=(16,) + row)
        x = torch.from_numpy(x.astype(np.int64))
    else:
        x = torch.from_numpy(rng.normal(size=(16,) + row).astype(np.float32))
    return module, x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ZOO))
def test_cuda_zoo_forward_matches_cpu(card, case, dtype):
    """Each network in eval mode on the card (cuDNN convolutions and LSTM)
    against the same weights on the CPU, every capture layer. float32
    within 1e-5 of the output's scale, which TF32 (1e-3) would miss;
    bfloat16 within 2**-6 of it: the card and the CPU each round each
    layer's products once to bfloat16, after sums in other orders."""
    module, x = _zoo_module(case, dtype)
    on_card = build_network(dict(ZOO[case][0], dtype=dtype), device=card)
    on_card.load_state_dict(module.state_dict())
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6
    for capture in [None] + module.feature_layers():
        with torch.no_grad():
            want = module(x, capture=capture).float()
            got = on_card(x.to(card), capture=capture).float().cpu()
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= tol, (capture, err)


@pytest.mark.cuda
def test_cuda_batchnorm_train_steps_match_cpu(card):
    """A ResNet trained 2 SGD steps through TPULearner on the card and on
    the CPU from the same weights, f32 (TF32 off): losses within rtol
    1e-4, weights and running statistics within 1e-3 of the largest
    update."""
    from mmlspark_tpu_torch.models.learner import TPULearner
    module, _ = _zoo_module("resnet-cifar")
    init = {k: v.clone() for k, v in module.state_dict().items()}
    rng = np.random.default_rng(6)
    x = rng.normal(size=(16, 32, 32, 3)).astype(np.float32)
    table = DataTable({"features": x.reshape(16, -1),
                       "label": rng.integers(0, 10, 16).astype(np.int64)})

    def fit(device):
        m = build_network(ZOO["resnet-cifar"][0], device="cpu")
        m.load_state_dict(init)
        learner = TPULearner(moduleFactory=lambda: m, device=device,
                             optimizer="sgd", schedule="constant",
                             learningRate=0.1, batchSize=8, epochs=1,
                             inputShape=[32, 32, 3], computeDtype="float32",
                             logEvery=1)
        model = learner.fit(table)
        return [h["loss"] for h in learner.history], {
            k: t.detach().cpu() for k, t in model.get("weights").items()}
    l_card, w_card = fit("cuda")
    l_cpu, w_cpu = fit("cpu")
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-4)
    upd = max(float((w_cpu[k] - init[k]).abs().max()) for k in init)
    for k in init:
        diff = float((w_card[k] - w_cpu[k]).abs().max())
        assert diff <= 1e-3 * upd, (k, diff, upd)
    assert not torch.equal(w_card["BatchNorm_0.running_var"],
                           init["BatchNorm_0.running_var"])


@pytest.mark.cuda
def test_cuda_allow_tf32_restored_after_an_f32_forward(card):
    module, x = _zoo_module("resnet-cifar")
    module = module.to(card)
    before = torch.backends.cudnn.allow_tf32
    try:
        for setting in (True, False):
            torch.backends.cudnn.allow_tf32 = setting
            with torch.no_grad():
                module(x.to(card))
            torch.cuda.synchronize()
            assert torch.backends.cudnn.allow_tf32 is setting
    finally:
        torch.backends.cudnn.allow_tf32 = before
