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


# ---------------------------------------------------------------------------
# the transfer-learning image path: image ops, ImageTransformer and
# ImageFeaturizer on the card against the port's CPU versions
# ---------------------------------------------------------------------------


def _photos(n, seed=0, shape=(375, 500, 3)):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 256, shape, dtype=np.uint8)
                     for _ in range(n)])


@pytest.mark.cuda
@pytest.mark.parametrize("op,args", [
    ("resize_batch", (224, 224)), ("resize_batch", (500, 333)),
    ("box_blur_batch", (5, 4)), ("gaussian_blur_batch", (5, 0.0)),
    ("threshold_batch", (127.5, 200.0, "trunc")),
    ("color_convert_batch", ("BGR2GRAY",)),
    ("color_convert_batch", ("GRAY2BGR",)), ("flip_batch", (-1,)),
    ("crop_batch", (10, 20, 100, 150)), ("unroll_batch", ()),
    ("normalize_batch", ([10.0, 20.0, 30.0], [2.0, 4.0, 8.0]))])
def test_cuda_image_batch_ops_match_cpu(card, op, args):
    """Each batch op on the card against the same op on the CPU, on 0-255
    images: float results within 5e-3 absolute for the resize (torch's
    CUDA antialiased kernel weighs the taps a little apart from its CPU
    kernel: 1.8e-3 and 2.4e-3 measured on an H100 at these two sizes,
    ~1e-5 of the range), within 1e-3 for the rest (the blurs in strict
    f32 match; in TF32 they would miss by ~1e-1)."""
    from mmlspark_tpu_torch.ops import image_ops
    x = torch.from_numpy(_photos(4, seed=len(op)))
    fn = getattr(image_ops, op)
    want = fn(x, *args)
    got = fn(x.to(card), *args).cpu()
    assert got.shape == want.shape and got.dtype == want.dtype
    atol = 5e-3 if op == "resize_batch" else 1e-3
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.cuda
def test_cuda_image_transformer_uniform_matches_ragged_and_cpu(card):
    """The uniform path on the card (one upload, the composed op list,
    uint8 on the card, one readback) against the same stage on the CPU,
    and, for a resize and a flip, against the ragged path (per image on
    the host, the native uint8 resize): at most 1 apart in at most 0.1 %
    of the pixels. (The ragged path rounds to uint8 after every op, so
    after a resize and a blur it parts from the uniform path by more.)"""
    from mmlspark_tpu_torch.core.schema import ImageSchema
    from mmlspark_tpu_torch.stages.image import ImageTransformer
    imgs = _photos(8, seed=3)
    table = DataTable({"image": [ImageSchema.make_row(f"p{i}", im)
                                 for i, im in enumerate(imgs)]})

    def run(stage):
        out = stage.transform(table)
        return np.stack([r[ImageSchema.DATA] for r in out["image"]])

    def close(got, want):
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, \
            (d.max(), (d > 0).mean())
    full = [ImageTransformer(device=d).resize(224, 224)
            .gaussian_kernel(5, 0).flip() for d in ("cuda", "cpu")]
    close(run(full[0]), run(full[1]))
    uniform = ImageTransformer(device="cuda").resize(224, 224).flip()
    ragged = ImageTransformer(device="cuda").resize(224, 224).flip()
    ragged._batchable = lambda: False            # force the host path
    close(run(uniform), run(ragged))


def _featurizer_weights():
    from mmlspark_tpu_torch.importers.torch_import import (
        TORCHVISION_RESNET18_SPEC, import_torchvision_resnet)
    from mmlspark_tpu_torch.profile_featurize import (
        seeded_resnet18_state_dict)
    return TORCHVISION_RESNET18_SPEC, import_torchvision_resnet(
        seeded_resnet18_state_dict(seed=4))


@pytest.mark.cuda
def test_cuda_featurizer_matches_cpu_forward(card):
    """ResNet-18 features of Flowers-sized images on the card against the
    same featurizer on the CPU (the same host resize): rtol 1e-4 and
    atol 1e-5 of the features' scale, in strict f32."""
    from mmlspark_tpu_torch.profile_featurize import flowers_table
    from mmlspark_tpu_torch.stages.featurizer import ImageFeaturizer
    spec, variables = _featurizer_weights()
    table = flowers_table(12, seed=2)

    def feats(device):
        return ImageFeaturizer(networkSpec=spec, weights=variables,
                               inputHeight=224, inputWidth=224,
                               batchSize=8, device=device
                               ).transform(table)["features"]
    got, want = feats("cuda"), feats("cpu")
    assert got.shape == (12, 512)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.cuda
def test_cuda_featurizer_builds_and_ships_weights_once(card, monkeypatch):
    """Three transforms of mixed sizes: the module is built from the
    weights and put on the card once, and the forward runs at one
    shape."""
    from mmlspark_tpu_torch import convert
    from mmlspark_tpu_torch.profile_featurize import flowers_table
    from mmlspark_tpu_torch.stages import featurizer
    builds = []
    real = convert.module_from_flax

    def counting(*a, **k):
        builds.append(k.get("device"))
        return real(*a, **k)
    monkeypatch.setattr(featurizer.convert, "module_from_flax", counting)
    spec, variables = _featurizer_weights()
    feat = featurizer.ImageFeaturizer(networkSpec=spec, weights=variables,
                                      inputHeight=224, inputWidth=224,
                                      batchSize=8)
    module = None
    for n in (5, 8, 19):
        out = feat.transform(flowers_table(n, seed=n))["features"]
        assert out.shape == (n, 512) and np.isfinite(out).all()
        module = module or feat._device_module
        assert feat._device_module is module
    assert len(builds) == 1 and torch.device(builds[0]).type == "cuda"
    assert next(module.parameters()).is_cuda
    assert feat.jit_cache_misses == 1


# ---------------------------------------------------------------------------
# the AutoML slice: batched tunes, the sparse logistic fit, threads
# ---------------------------------------------------------------------------


def _automl_rows(n, seed=0):
    """A small bench_automl-shaped table and its float label."""
    from mmlspark_tpu_torch.profile_automl import automl_table
    return automl_table(n, seed)


def _featurized(n, seed=0, **kw):
    from mmlspark_tpu_torch.automl import Featurize
    from mmlspark_tpu_torch.profile_automl import FEATURE_COLUMNS
    table, label = _automl_rows(n, seed)
    fm = Featurize(featureColumns=FEATURE_COLUMNS, numberOfFeatures=16,
                   **kw).fit(table)
    return fm.transform(table)["features"], label, table


@pytest.mark.cuda
def test_cuda_batched_tune_selects_as_on_the_cpu(card):
    from mmlspark_tpu_torch.profile_automl import tuner
    X, y, _ = _featurized(3000)
    t = DataTable({"features": X, "label": y})
    on_card = tuner("auto", device="cuda").fit(t)
    on_cpu = tuner("auto", device="cpu").fit(t)
    serial = tuner("off", device="cuda").fit(t)
    assert on_card.search_info["path"] == "vmap"
    assert on_card.search_info["dispatches"] == 3
    assert on_card.get("bestParams") == on_cpu.get("bestParams")
    assert on_card.get("bestParams") == serial.get("bestParams")


@pytest.mark.cuda
def test_cuda_sparse_logistic_fit_bitwise_on_repeat(card):
    from mmlspark_tpu_torch.automl import Featurize
    from mmlspark_tpu_torch.models.linear import TPULogisticRegression
    from mmlspark_tpu_torch.profile_automl import FEATURE_COLUMNS
    table, y = _automl_rows(4000)
    st = Featurize(featureColumns=FEATURE_COLUMNS,
                   sparse=True).fit(table).transform(table)
    w1 = TPULogisticRegression(maxIter=50).fit(st).get("weights")
    w2 = TPULogisticRegression(maxIter=50).fit(st).get("weights")
    wc = TPULogisticRegression(maxIter=50, device="cpu").fit(st).get(
        "weights")
    for k in ("W", "b"):
        np.testing.assert_array_equal(w1[k], w2[k])
        scale = float(np.abs(wc[k]).max())
        np.testing.assert_allclose(w1[k], wc[k], rtol=1e-4,
                                   atol=1e-5 * scale)


@pytest.mark.cuda
def test_cuda_threaded_gbdt_tune_equals_one_thread(card):
    from mmlspark_tpu_torch.automl import (
        DiscreteHyperParam, GridSpace, TuneHyperparameters)
    from mmlspark_tpu_torch.gbdt.estimators import TPUBoostClassifier
    X, y, _ = _featurized(4000)
    t = DataTable({"features": X, "label": y})
    space = GridSpace({"numIterations": DiscreteHyperParam([3, 6]),
                       "numLeaves": DiscreteHyperParam([7, 15])})
    runs = [TuneHyperparameters(
        models=[TPUBoostClassifier(minDataInLeaf=5)], paramSpace=space,
        numFolds=2, parallelism=par).fit(t) for par in (4, 1)]
    assert runs[0].get("history") == runs[1].get("history")
    assert runs[0].get("bestParams") == runs[1].get("bestParams")
    assert runs[0].get("bestMetric") == runs[1].get("bestMetric")


@pytest.mark.cuda
def test_cuda_train_classifier_launches_the_hist_kernel(card):
    from mmlspark_tpu_torch.automl import TrainClassifier
    from mmlspark_tpu_torch.profile_automl import FEATURE_COLUMNS
    table, y = _automl_rows(5000)
    t = table.with_column("label", np.where(y > 0.5, "yes", "no").tolist())
    HK.reset_launches()
    m = TrainClassifier(featureColumns=FEATURE_COLUMNS,
                        numFeatures=16).fit(t)
    assert sum(HK.LAUNCHES.values()) > 0
    out = m.transform(t)
    pred = np.asarray(out["prediction"])
    assert (pred == y).mean() > 0.95
    assert list(out["scored_labels"]) == \
        np.where(pred == 1.0, "yes", "no").tolist()


# ---------------------------------------------------------------------------
# models entering and leaving the system: int8, ONNX, checkpoint / resume
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 17])
def test_cuda_int8_matmul_bitwise_to_host_at_padded_shapes(card, m):
    """torch._int_mm needs > 16 rows, K and N multiples of 8: at M = 1,
    8, 17, N = 10, K = 20 the zero-padded product still equals
    int8_matmul_host bit for bit (NaN row included), and each call is
    one counted launch."""
    from mmlspark_tpu_torch.core import quantize as PQ
    rng = np.random.default_rng(m)
    x = rng.normal(size=(m, 20)).astype(np.float32)
    x[0, 3] = np.nan
    wq, ws = PQ.quantize_weight(rng.normal(size=(20, 10)))
    xs = PQ.act_scale(np.nanmax(np.abs(x)))
    PQ.reset_launches()
    got = PQ.int8_matmul(torch.from_numpy(x).to(card),
                         torch.from_numpy(wq).to(card), xs,
                         torch.from_numpy(ws).to(card))
    assert PQ.LAUNCHES["int8_mm"] == 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  PQ.int8_matmul_host(x, wq, xs, ws))
    op = PQ.mm_operand(torch.from_numpy(wq).to(card))
    assert op.shape == (24, 16) and op.stride() == (1, 24)
    again = PQ.int8_matmul(torch.from_numpy(x).to(card),
                           torch.from_numpy(wq).to(card), xs, ws,
                           operand=op)
    assert torch.equal(torch.nan_to_num(got, nan=7.0),
                       torch.nan_to_num(again, nan=7.0))


@pytest.mark.cuda
def test_cuda_int8_tpumodel_matches_cpu(card):
    """A quantized MLP on the card against the same int8 model on the
    CPU: the accumulators are exact, the f32 epilogues equal."""
    net = build_network({"type": "mlp", "features": [64, 32],
                         "num_classes": 10, "in_features": 24},
                        device="cpu", seed=3)
    x = np.random.default_rng(4).normal(size=(50, 24)).astype(np.float32)
    q = TPUModel.from_module(net, device="cpu", inputCol="x",
                             outputCol="y", batchSize=32
                             ).quantize({"x": x})
    want = q.transform(DataTable({"x": x}))["y"]
    q.set("device", "cuda")
    got = q.transform(DataTable({"x": x}))["y"]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.array_equal(got.argmax(1), want.argmax(1))


@pytest.mark.cuda
def test_cuda_onnx_resnet_matches_cpu(card, tmp_path):
    """The narrow resnet18 ONNX graph (width 8) on the card against the
    CPU: rtol 2e-4 / atol 2e-4, equal argmax (strict f32 convolutions)."""
    import onnx_writer as ow
    from mmlspark_tpu_torch.importers import import_onnx_model
    path = str(tmp_path / "r18.onnx")
    ow.resnet18_onnx(path, num_classes=10, width=8, seed=3)
    x = np.random.default_rng(1).normal(size=(12, 3 * 32 * 32)
                                        ).astype(np.float32)
    got, want = (import_onnx_model(path, batch_size=8,
                                   input_shape=[3, 32, 32],
                                   device=dev).transform(
        DataTable({"images": x}))["scores"] for dev in ("cuda", "cpu"))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert np.array_equal(got.argmax(1), want.argmax(1))


@pytest.mark.cuda
@pytest.mark.parametrize("feed", ["host", "device"])
def test_cuda_checkpoint_resume_bitwise(card, tmp_path, feed):
    """An interrupted fit on the card resumed from its checkpoint equals
    the uninterrupted fit bit for bit: losses and weights."""
    from mmlspark_tpu_torch.models.learner import TPULearner
    rng = np.random.default_rng(5)
    x = rng.normal(size=(256, 16)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.int64)
    t = DataTable({"features": x, "label": y})
    kw = dict(networkSpec={"type": "mlp", "features": [32],
                           "num_classes": 2},
              optimizer="adamw", batchSize=64, learningRate=0.01,
              schedule="constant", computeDtype="bfloat16", dataFeed=feed,
              logEvery=1, checkpointEvery=4)
    full = TPULearner(epochs=4, **kw)
    wf = full.fit(t).get("weights")
    ck = str(tmp_path / "ck")
    TPULearner(epochs=2, checkpointDir=ck, **kw).fit(t)
    resumed = TPULearner(epochs=4, checkpointDir=ck, **kw)
    wr = resumed.fit(t).get("weights")
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in full.history][8:]
    for k in wf:
        assert torch.equal(wf[k], wr[k]), k


# ---------------------------------------------------------------------------
# fused and streamed pipelines (core/fusion.py) on the card
# ---------------------------------------------------------------------------


def _fused_pipeline(n=4096, seed=0):
    """A fitted Featurize -> StandardScaler -> logistic pipeline over
    raw rows (NaN numerics, a string, token lists), fitted on the CPU."""
    from mmlspark_tpu_torch.automl.featurize import Featurize
    from mmlspark_tpu_torch.core.stage import Pipeline
    from mmlspark_tpu_torch.models.linear import TPULogisticRegression
    from mmlspark_tpu_torch.stages.dataprep import StandardScaler
    rng = np.random.default_rng(seed)
    b = rng.normal(size=n)
    b[rng.random(n) < 0.2] = np.nan
    t = DataTable({
        "a": rng.normal(size=n).astype(np.float32), "b": b,
        "cat": [f"l{int(i)}" for i in rng.integers(0, 8, n)],
        "toks": [[f"w{int(x)}" for x in rng.integers(0, 30, 4)]
                 for _ in range(n)],
        "label": rng.integers(0, 2, n).astype(np.float64)})
    pm = Pipeline(stages=[
        Featurize(featureColumns=["a", "b", "cat", "toks"],
                  numberOfFeatures=16, oneHotEncodeCategoricals=True),
        StandardScaler(inputCol="features"),
        TPULogisticRegression(featuresCol="features", labelCol="label",
                              maxIter=10, device="cpu"),
    ]).fit(t)
    return t.drop("label"), pm


@pytest.mark.cuda
def test_cuda_fused_pipeline_matches_cpu(card):
    """The same fused pipeline on the card and on the CPU: the assembled
    features bitwise (selects, compares, counts), probabilities within
    rtol 1e-5 / atol 1e-6, predictions equal but on near ties (top-two
    margin under 1e-5); fused bitwise transform_staged on the card."""
    raw, pm = _fused_pipeline()
    on_card, on_cpu = pm.fused(device="cuda"), pm.fused(device="cpu")
    got, want = on_card.transform(raw), on_cpu.transform(raw)
    np.testing.assert_array_equal(got["features"], want["features"])
    np.testing.assert_allclose(got["probability"], want["probability"],
                               rtol=1e-5, atol=1e-6)
    top2 = np.sort(np.asarray(want["probability"]), axis=1)[:, -2:]
    near = (top2[:, 1] - top2[:, 0]) < 1e-5
    diff = np.asarray(got["prediction"]) != np.asarray(want["prediction"])
    assert not (diff & ~near).any()
    staged = on_card.transform_staged(raw)
    for c in ("features", "rawPrediction", "probability", "prediction"):
        np.testing.assert_array_equal(got[c], staged[c])
    assert on_card.plan_for(raw.schema).last_roundtrips == 3


@pytest.mark.cuda
def test_cuda_execute_chunked_depths_agree(card):
    """execute_chunked with prefetch depth 0 (inline uploads) and 3
    (uploads on a side stream from the prefetch worker) gives the same
    outputs, each bitwise the fused transform of its chunk."""
    from mmlspark_tpu_torch.io.ooc import ChunkedTable
    raw, pm = _fused_pipeline()
    fused = pm.fused(device="cuda")
    outs = {}
    for depth in (0, 3):
        ct = ChunkedTable.from_table(raw, chunk_rows=512)
        outs[depth] = list(fused.transform_chunked(ct,
                                                   prefetch_depth=depth))
    assert len(outs[0]) == len(outs[3]) == 8
    for i, (a, b) in enumerate(zip(outs[0], outs[3])):
        ref = fused.transform(raw.slice(512 * i, 512 * (i + 1)))
        for c in ("features", "probability", "prediction"):
            np.testing.assert_array_equal(a[c], b[c])
            np.testing.assert_array_equal(a[c], ref[c])


@pytest.mark.cuda
def test_cuda_reused_pinned_buffer_never_leaks_rows(card):
    """A pinned staging buffer is reused every ``slots`` uploads; each
    chunk's device tensor must hold that chunk's rows, never a previous
    one's, also while the card is still busy with earlier copies."""
    from mmlspark_tpu_torch.core.fusion import HostStaging, Upload, adopt
    staging = HostStaging(2, pinned=True)
    side = torch.cuda.Stream(card)
    held = []
    for k in range(12):
        host = np.full((1 << 20,), k, np.float32)
        up = Upload(card, staging, side)
        t = up.ship("x", host)
        ready = up.finish()
        adopt({"x": t}, ready, card)
        held.append(t)
    torch.cuda.synchronize()
    for k, t in enumerate(held):
        vals = torch.unique(t).cpu().numpy()
        assert vals.tolist() == [float(k)], (k, vals[:4])
    assert staging.stats()["buffers"] == 2
    # the edge pad of a short batch into a reused buffer
    up = Upload(card, staging, side)
    t = up.ship("y", np.arange(5, dtype=np.float32), rows=8)
    adopt({"y": t}, up.finish(), card)
    assert t.cpu().numpy().tolist() == [0, 1, 2, 3, 4, 4, 4, 4]


@pytest.mark.cuda
def test_cuda_fused_scorer_one_copy_a_batch(card):
    """The fused scorer on the card: one device-to-host copy a batch,
    replies equal to the fused transform of their rows."""
    import json
    from mmlspark_tpu_torch.serving.fleet import json_scoring_pipeline
    raw, pm = _fused_pipeline(n=512)
    fused = pm.fused(device="cuda", batch_size=64)
    scorer = json_scoring_pipeline(fused).scorer
    rows = [{"a": float(raw["a"][i]), "b": float(raw["b"][i]),
             "cat": raw["cat"][i], "toks": raw["toks"][i]}
            for i in range(40)]
    table = DataTable({"id": [str(i) for i in range(40)],
                       "request": [{"entity": json.dumps(r).encode()}
                                   for r in rows]})
    out = scorer.transform(table)
    # the served batch runs edge-padded to its bucket (64 rows)
    padded = raw.slice(0, 40)._take_indices(np.minimum(np.arange(64), 39))
    want = fused.transform(padded)["prediction"][:40]
    assert [r["prediction"] for r in out["reply"]] == \
        [int(v) for v in want]
    assert scorer.device_roundtrips == scorer.batches_scored == 1


@pytest.fixture
def own_tracer():
    """A fresh process tracer for the test (the process-wide buffer is
    shared by every test of a worker), the old one put back after."""
    from mmlspark_tpu_torch.core import trace as T
    old = T.get_tracer()
    tracer = T.Tracer(enabled=True)
    T.set_tracer(tracer)
    yield tracer
    T.set_tracer(old)


@pytest.mark.cuda
def test_cuda_traced_hist_fit(card, own_tracer):
    """A fit on the card leaves one gbdt.train trace whose phase spans
    and boost_chunk spans enclose the hist launches: the launches happen
    inside the boost span (their count read around it), the chunks lie
    inside it, and the phase histograms rise by one fit."""
    from mmlspark_tpu_torch.core import metrics as MC
    from mmlspark_tpu_torch.gbdt.booster import train
    X, y = _gbdt_table(50_000)
    before = {k: h.snapshot()["count"]
              for k, h in MC.gbdt_train_histograms().items()}
    HK.reset_launches()
    booster = train({"objective": "binary", "num_iterations": 3,
                     "num_leaves": 15, "max_bin": 255}, X, y,
                    device="cuda")
    launches = sum(HK.LAUNCHES.values())
    assert launches > 0
    traces = [t for t in own_tracer.buffer.traces()
              if t.root.name == "gbdt.train"]
    assert len(traces) == 1
    tr = traces[0]
    names = [s.name for s in tr.spans()[1:]]
    assert [n for n in names if n != "boost_chunk"] == \
        ["bin", "ship", "boost", "fetch"]
    boost = next(s for s in tr.spans() if s.name == "boost")
    chunks = [s for s in tr.spans() if s.name == "boost_chunk"]
    assert len(chunks) == tr.root.attrs["boost_chunks"] == 3
    assert all(boost.start <= c.start <= c.end <= boost.end
               for c in chunks)
    assert tr.root.attrs["trees"] == 3
    assert tr.root.attrs["bin_path"] == booster.train_info["bin_path"]
    assert abs(boost.duration_ms / 1e3
               - booster.train_timing["boost"]) < 2e-3
    rises = {k: h.snapshot()["count"] - before[k]
             for k, h in MC.gbdt_train_histograms().items()}
    assert rises["boost"] == rises["bin"] == 1 and rises["boost_chunk"] == 3


@pytest.mark.cuda
def test_cuda_traced_flash_step(card, own_tracer):
    """A fit of a small L = 512 Transformer on the card: one
    learner.fit trace with one learner.step span a step, memory samples
    read from the card (bytes_in_use above 0) as memory spans, and the
    flash kernels launched each step."""
    from mmlspark_tpu_torch.models.learner import TPULearner
    spec = {"type": "transformer", "vocab_size": 64, "dim": 32, "depth": 2,
            "heads": 4, "max_len": 512}
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 64, size=(8, 512)).astype(np.float32)
    table = DataTable({"features": toks,
                       "label": np.roll(toks.astype(np.int64), -1, 1)})
    FA.reset_launches()
    learner = TPULearner(networkSpec=spec, device="cuda",
                         loss="token_cross_entropy", batchSize=4, epochs=1,
                         computeDtype="bfloat16", logEvery=1,
                         memoryStatsEvery=1, dataFeed="device")
    learner.fit(table)
    assert FA.LAUNCHES == {"_fwd_kernel": 4, "_dq_kernel": 4,
                           "_dkv_kernel": 4}
    tr = next(t for t in own_tracer.buffer.traces()
              if t.root.name == "learner.fit")
    steps = [s for s in tr.spans() if s.name == "learner.step"]
    mems = [s for s in tr.spans() if s.name == "memory"]
    assert len(steps) == 2 and tr.root.attrs["steps"] == 2
    assert tr.root.attrs["feed"] == "device"
    assert [m["step"] for m in learner.memory_samples] == [1, 2]
    assert all(m["bytes_in_use"] > 0 and m["bytes_limit"] > 0
               for m in learner.memory_samples)
    assert [m.attrs["bytes_in_use"] for m in mems] == \
        [m["bytes_in_use"] for m in learner.memory_samples]


@pytest.mark.cuda
def test_cuda_device_memory_stats_keys(card):
    """The card's allocator counters under the JAX package's keys, once
    this process has a CUDA context; the one-card mesh sums equal."""
    from mmlspark_tpu_torch.utils import profiling
    x = torch.ones(1 << 20, device=card)
    stats = profiling.device_memory_stats()
    assert set(stats) == {"bytes_in_use", "peak_bytes_in_use",
                          "bytes_limit"}
    assert stats["bytes_in_use"] >= x.numel() * 4
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"]
    mesh = profiling.mesh_memory_stats()
    assert mesh["devices"] == torch.cuda.device_count()
    assert mesh["per_device"]["cuda:0"] > 0


@pytest.mark.cuda
def test_cuda_boost_more_refresh_rolled_into_a_fleet(card):
    """A forest fitted on the card, refreshed by boost_more through the
    hist kernel (one launch a histogram), rolled into a 2-engine fleet
    serving on the card while a client thread posts: every reply is v1's
    or v2's prediction of its row, and after the rollout v2's."""
    import threading
    from mmlspark_tpu_torch.gbdt.estimators import (
        TPUBoostClassificationModel, TPUBoostClassifier)
    from mmlspark_tpu_torch.serving import (
        CanaryPolicy, ServingFleet, json_scoring_pipeline)
    X, y = _gbdt_table(40_000)
    Xtr, ytr, Xte = X[:30_000], y[:30_000], X[30_000:30_400]
    v1 = TPUBoostClassifier(numIterations=3, numLeaves=15,
                            device="cuda").fit(
        DataTable({"features": Xtr, "label": ytr}))
    HK.reset_launches()
    b2 = v1.get_booster().boost_more(3, Xtr, ytr)
    assert sum(HK.LAUNCHES.values()) == b2.train_info["histograms"] > 0
    v2 = TPUBoostClassificationModel(modelString=b2.model_to_string(),
                                     numClasses=2, device="cuda")
    want = {name: np.asarray(m.transform(DataTable(
        {"features": Xte}))["prediction"]).astype(int)
        for name, m in (("v1", v1), ("v2", v2))}
    fleet = ServingFleet(json_scoring_pipeline(v1), n_engines=2,
                         base_port=0, batch_size=64, version="v1",
                         flight_recorder=False)
    got, stop = [], threading.Event()

    def client():
        i = 0
        while not stop.is_set():
            row = i % len(Xte)
            got.append((row, fleet.post(
                {"features": Xte[row].tolist()})["prediction"]))
            i += 1
    t = threading.Thread(target=client)
    try:
        t.start()
        report = fleet.rolling_swap(
            json_scoring_pipeline(v2), "v2",
            policy=CanaryPolicy(fraction=0.5, min_batches=4))
        stop.set()
        t.join(timeout=30)
        assert report["ok"] and report["completed"] == 2, report
        for row in range(8):
            assert fleet.post({"features": Xte[row].tolist()})[
                "prediction"] == want["v2"][row]
    finally:
        stop.set()
        fleet.stop_all()
    assert got and all(p in (want["v1"][r], want["v2"][r]) for r, p in got)


@pytest.mark.cuda
def test_cuda_shm_post_columns_equals_json(card):
    """post_columns over the shared-memory ring to engines serving a
    forest on the card: every reply bitwise the per-row JSON oracle's,
    no fallback, every slot free, the segment unlinked at stop_all."""
    import os
    from mmlspark_tpu_torch.gbdt.estimators import TPUBoostClassifier
    from mmlspark_tpu_torch.serving import (
        ServingFleet, json_scoring_pipeline)
    X, y = _gbdt_table(20_000)
    model = TPUBoostClassifier(numIterations=3, numLeaves=15,
                               device="cuda").fit(
        DataTable({"features": X[:16_000], "label": y[:16_000]}))
    rows = X[16_000:16_300]
    fleet = ServingFleet(json_scoring_pipeline(model), n_engines=2,
                         base_port=0, batch_size=64, shm_transport=True,
                         flight_recorder=False)
    try:
        out = fleet.post_columns({"features": rows})
        ring = fleet._shm_ring
        assert fleet._shm_fallbacks == 0 and fleet._shm_ok
        assert sorted(ring._free) == list(range(ring.nslots))
        oracle = [fleet.post({"features": r.tolist()})["prediction"]
                  for r in rows]
        assert out["prediction"] == oracle
        name = ring.name
    finally:
        fleet.stop_all()
    assert not os.path.exists(f"/dev/shm/{name}")


@pytest.mark.cuda
def test_cuda_trainer_refit_bitwise_direct_boost_more(card):
    """A ContinuousTrainer cycle on a card engine: its boost_more refit
    runs on the trainer thread through the hist kernel (one launch a
    histogram), and the promoted forest is bitwise the same boost_more
    run on this thread over the same window snapshot."""
    import json
    import threading
    import time
    import urllib.request
    from mmlspark_tpu_torch.gbdt.estimators import (
        TPUBoostClassificationModel, TPUBoostClassifier)
    from mmlspark_tpu_torch.serving import (
        CanaryPolicy, ContinuousTrainer, GatePolicy, json_scoring_pipeline,
        serve_model)
    X, y = _gbdt_table(60_000)
    base = TPUBoostClassifier(numIterations=3, numLeaves=15,
                              device="cuda").fit(
        DataTable({"features": X[:20_000], "label": y[:20_000]}))
    b0 = base.get_booster()
    counts = {}

    def refit(window, active):
        tab = window.materialize()
        n0 = sum(HK.LAUNCHES.values())
        b = b0.boost_more(3, np.asarray(tab["features"], np.float32),
                          np.asarray(tab["label"], np.float32))
        counts["launches"] = sum(HK.LAUNCHES.values()) - n0
        counts["hists"] = b.train_info["histograms"]
        counts["thread"] = threading.current_thread().name
        m = TPUBoostClassificationModel(modelString=b.model_to_string(),
                                        numClasses=2, device="cuda")
        m._booster = b
        return json_scoring_pipeline(m)

    engine = serve_model(json_scoring_pipeline(base), port=0,
                         batch_size=64, version="v1", flight_recorder=False)
    tr = ContinuousTrainer(
        engine, refit, gate=GatePolicy(shadow_rows=512,
                                       min_quality_delta=-1.0,
                                       max_divergence=1.0),
        canary=CanaryPolicy(fraction=0.5, min_batches=2),
        poll_interval_s=0.02)
    for lo in range(20_000, 60_000, 10_000):
        tr.ingest(DataTable({"features": X[lo:lo + 10_000],
                             "label": y[lo:lo + 10_000]}))
    snap = tr.window.snapshot()
    stop = threading.Event()

    def client():
        i = 0
        while not stop.is_set():
            req = urllib.request.Request(
                engine.source.address,
                data=json.dumps({"features": X[i % 100].tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            i += 1
            try:
                urllib.request.urlopen(req, timeout=10).read()
            except Exception:  # noqa: BLE001 — the load only feeds batches
                pass
    t = threading.Thread(target=client, daemon=True)
    try:
        tr.start()
        t.start()
        tr.trigger_now("card drill")
        deadline = time.monotonic() + 120
        while tr.promotions + tr.quarantines + tr.refit_failures == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert tr.promotions == 1, (tr.status(), tr.history)
        assert counts["thread"] == "controlplane-trainer"
        assert counts["launches"] == counts["hists"] > 0
        tab = snap.materialize()
        direct = b0.boost_more(3, np.asarray(tab["features"], np.float32),
                               np.asarray(tab["label"], np.float32))
        got = engine._active.pipeline.model.get_booster()
        assert got.model_to_string() == direct.model_to_string()
    finally:
        stop.set()
        tr.stop()
        engine.stop()


def test_port_and_chip_smoke_import_no_jax():
    """The AST scan of test_torch_gbdt.py, in this JAX-free file: the
    port's package, its telemetry modules included, and chip_smoke.py
    import nothing of JAX or the JAX package."""
    import ast
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    files = sorted((repo / "mmlspark_tpu_torch").rglob("*.py")) + \
        [repo / "chip_smoke.py"]
    assert repo / "mmlspark_tpu_torch" / "core" / "trace.py" in files
    assert repo / "mmlspark_tpu_torch" / "serving" / "lifecycle.py" in files
    assert repo / "mmlspark_tpu_torch" / "testing" / "chaos.py" in files
    for new in (("serving", "controlplane.py"), ("io", "shm.py"),
                ("testing", "serving_worker.py")):
        assert repo.joinpath("mmlspark_tpu_torch", *new) in files
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "flax",
                                           "mmlspark_tpu")]
    assert not bad, bad


# ---------------------------------------------------------------------------
# the flash forward as a custom op, and an AOT artifact on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_custom_op_is_the_direct_launch(card, dtype):
    """torch.ops.mmlspark_tpu_torch.flash_fwd launches the same kernel as
    flash_forward_cuda: bitwise, one counted launch each."""
    g = torch.Generator(device=card).manual_seed(11)
    qkv = torch.randn(2, 600, 3, 4, 64, generator=g, device=card,
                      dtype=dtype)
    q, k, v = qkv.unbind(2)           # strided views, as the LM's
    FA.reset_launches()
    out, lse = torch.ops.mmlspark_tpu_torch.flash_fwd(q, k, v, True, 0, 0)
    want_out, want_lse = FA.flash_forward_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["_fwd_kernel"] == 2
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)


@pytest.mark.cuda
def test_cuda_aot_lm_loads_bitwise(card, tmp_path):
    """A small LM exported on the card and loaded: its logits bitwise the
    in-process model's, the flash kernel launched from inside the loaded
    program, no first run at request time."""
    from mmlspark_tpu_torch.serving import aot
    spec = {"type": "transformer", "vocab_size": 128, "dim": 64,
            "depth": 2, "heads": 4, "max_len": 512,
            "head_dtype": "float32"}
    model = TPUModel.from_module(build_network(spec, device=card, seed=0),
                                 device="cuda", inputCol="tokens",
                                 outputCol="logits", batchSize=8)
    toks = np.random.default_rng(3).integers(0, 128, size=(11, 512))
    table = DataTable({"tokens": toks})
    want = model.transform(table)["logits"]
    art = str(tmp_path / "lm")
    manifest = aot.export_model(model, table, art)
    assert manifest["backend"] == "cuda"
    assert "flash_fwd" in manifest["kernels"]
    loaded = aot.load_model(art)
    FA.reset_launches()
    got = loaded.transform(table)["logits"]
    assert FA.LAUNCHES["_fwd_kernel"] == spec["depth"] * 2
    assert np.array_equal(got, want)
    assert loaded.jit_cache_misses == 0


# ---------------------------------------------------------------------------
# the multi-model plane on the card
# ---------------------------------------------------------------------------

ZOO_LM = {"type": "transformer", "vocab_size": 8192, "dim": 1024,
          "depth": 2, "heads": 8, "max_len": 512, "head_dtype": "float32"}


def _settled_allocated() -> int:
    """Allocated card bytes once nothing is in flight, without the
    cuBLAS workspaces (one per stream that ran a GEMM: the zoo's loader
    stream gets its own at its first warmup)."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return torch.cuda.memory_allocated()


@pytest.mark.cuda
def test_cuda_zoo_lm_artifact_evicted_frees_memory(card, tmp_path):
    """An LM artifact activated in a zoo on the card (its weights on the
    loader's own stream, cost_source 'device'), served through the
    model-routed engine with the flash kernel launched from its program,
    then evicted: memory_allocated falls by its resident_bytes and comes
    back to the level before the activation, both within 5 %."""
    from mmlspark_tpu_torch.serving import ModelZoo, ServingEngine, HTTPSource
    from mmlspark_tpu_torch.serving import aot
    import json
    import urllib.request
    model = TPUModel.from_module(build_network(ZOO_LM, device=card, seed=0),
                                 device="cuda", inputCol="tokens",
                                 outputCol="logits", batchSize=8)
    toks = np.random.default_rng(3).integers(0, ZOO_LM["vocab_size"],
                                              size=(2, 512))
    want = model.transform(DataTable({"tokens": toks[:1]}))["logits"]
    aot.export_model(model, DataTable({"tokens": toks}),
                     str(tmp_path / "lm" / "v1"))
    del model
    before = _settled_allocated()
    zoo = ModelZoo(artifact_root=str(tmp_path), memory_probe=None)
    source = HTTPSource(port=0)
    engine = ServingEngine(source, zoo=zoo, tracing=False,
                           flight_recorder=False).start()
    try:
        FA.reset_launches()
        req = urllib.request.Request(
            source.address, data=json.dumps(
                {"tokens": toks[0].tolist()}).encode(),
            headers={"Content-Type": "application/json",
                     "X-Model": "lm"})
        with urllib.request.urlopen(req, timeout=300) as r:
            body = json.loads(r.read())
            assert r.headers["X-Model"] == "lm@v1"
        assert body["prediction"] == want[0].argmax(-1).tolist()
        # the warmup forward and the request's: depth launches each
        assert FA.LAUNCHES["_fwd_kernel"] == 2 * ZOO_LM["depth"]
        st = zoo.entry_status("lm")
        assert st["cost_source"] == "device"
        rb = st["cost_bytes"]
        resident = _settled_allocated()
        assert abs((resident - before) - rb) <= 0.05 * rb
        assert zoo.evict("lm")
        after = _settled_allocated()
        assert abs((resident - after) - rb) <= 0.05 * rb
        assert abs(after - before) <= 0.05 * rb
    finally:
        engine.stop()
        zoo.close()


@pytest.mark.cuda
def test_cuda_int8_rung_routed_under_pressure(card, tmp_path):
    """A [f32, int8] ladder of one LM's artifacts on the card: a reply
    off rung 0 is the f32 model's argmax; queue pressure steps the route
    down, and the reply echoes the int8 variant and equals the int8
    model's own argmax (its GEMMs run inside the loaded program, where
    the Python launch counter does not see them); clean air past hold_s
    steps it back up."""
    import json
    import time
    import urllib.request
    from mmlspark_tpu_torch.serving import (
        HTTPSource, ModelZoo, ServingEngine, VariantSelector,
    )
    from mmlspark_tpu_torch.serving import aot
    model = TPUModel.from_module(build_network(ZOO_LM, device=card, seed=0),
                                 device="cuda", inputCol="tokens",
                                 outputCol="logits", batchSize=8)
    toks = np.random.default_rng(4).integers(0, ZOO_LM["vocab_size"],
                                              size=(8, 512))
    table = DataTable({"tokens": toks})
    q = model.quantize(table)
    row = DataTable({"tokens": toks[:1]})
    want_f32 = model.transform(row)["logits"][0].argmax(-1).tolist()
    want = q.transform(row)["logits"]
    aot.export_model(model, table, str(tmp_path / "lm" / "v1"))
    aot.export_model(q, table, str(tmp_path / "lm_int8" / "v1"))
    zoo = ModelZoo(artifact_root=str(tmp_path), memory_probe=None)
    sel = VariantSelector(zoo, decide_interval_s=0.05, hold_s=2.0,
                          pressure_limit=4)
    sel.declare("lm", ["lm", "lm_int8"], slo_ms=1e6,
                costs={"lm": 4.0, "lm_int8": 1.0})
    source = HTTPSource(port=0)
    engine = ServingEngine(source, zoo=zoo, variants=sel, tracing=False,
                           flight_recorder=False).start()

    def post():
        req = urllib.request.Request(
            source.address, data=json.dumps(
                {"tokens": toks[0].tolist()}).encode(),
            headers={"Content-Type": "application/json", "X-Model": "lm"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.headers["X-Model"], json.loads(r.read())

    try:
        zoo.get("lm", timeout=300)
        zoo.get("lm_int8", timeout=300)
        served, body = post()
        assert served == "lm@v1" and body["prediction"] == want_f32
        assert sel.tick(pressure=64, min_interval_s=0.0)
        assert sel.route("lm") == "lm_int8@v1"
        served, body = post()
        assert served == "lm_int8@v1"
        assert body["prediction"] == want[0].argmax(-1).tolist()
        deadline = time.monotonic() + 30
        while sel.route("lm") != "lm@v1" and time.monotonic() < deadline:
            time.sleep(0.05)
        assert sel.route("lm") == "lm@v1"
        assert [e.kind for e in sel.events].count("step_up") == 1
    finally:
        engine.stop()
        zoo.close()
