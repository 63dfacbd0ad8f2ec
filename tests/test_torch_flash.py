"""PyTorch port: flash attention (forward and backward) and the attention
routes against the JAX package, on the CPU.

The same numpy inputs go through the JAX ``_flash_forward`` /
``_flash_backward`` (their Pallas kernels in interpret mode, as
``tests/test_flash_attention.py`` runs them) and the port's
``flash_forward`` / ``flash_backward``, which on CPU tensors run their
plain versions; the CUDA kernels are held to those plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.ops.flash_attention import _flash_backward, _flash_forward
from mmlspark_tpu.parallel import ring_attention as jra

from mmlspark_tpu_torch.ops import flash_attention as FA
from mmlspark_tpu_torch.parallel import ring_attention as tra

F32, BF16 = "float32", "bfloat16"

# (B, Lq, Lk, H, D, causal, q_offset, k_offset, dtype): the five shapes of
# tests/test_flash_attention.py::test_matches_dense, shard offsets, a
# fully masked shard, bf16 inputs and a wide head
CASES = [
    (2, 64, 64, 3, 16, False, 0, 0, F32),
    (2, 64, 64, 3, 16, True, 0, 0, F32),
    (2, 100, 100, 3, 16, True, 0, 0, F32),
    (2, 300, 520, 3, 16, False, 0, 0, F32),
    (2, 520, 300, 3, 16, True, 0, 0, F32),
    (1, 64, 64, 2, 8, True, 64, 0, F32),
    (1, 32, 32, 2, 8, True, 0, 1000, F32),
    (1, 96, 96, 2, 16, True, 0, 0, BF16),
    (1, 300, 300, 2, 160, True, 0, 0, F32),
]


def _qkv(b, lq, lk, h, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, n, h, d)).astype(np.float32)
                 for n in (lq, lk, lk))


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _jax(arrs, dtype):
    return [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrs]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_forward_matches_jax_kernel(case):
    b, lq, lk, h, d, causal, qo, ko, dtype = case
    arrs = _qkv(b, lq, lk, h, d, seed=lq + lk + d)
    jout, jlse = _flash_forward(*_jax(arrs, dtype), causal=causal,
                                q_offset=qo, k_offset=ko, interpret=True)
    FA.reset_launches()
    out, lse = FA.flash_forward(*_torch(arrs, dtype), causal, qo, ko)
    assert FA.LAUNCHES["_fwd_kernel"] == 0      # CPU tensors never launch
    assert out.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    assert out.shape == (b, lq, h, d) and lse.shape == (b, h, lq)
    # f32: the tolerance of test_flash_attention.py; bf16: one bf16
    # rounding of outputs of magnitude ~1
    tol = 2e-4 if dtype == F32 else 2e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32),
                               rtol=tol, atol=tol)
    # the JAX lse is (B*H, Lq_pad, 1): its true rows
    jl = np.asarray(jlse)[:, :lq, 0].reshape(b, h, lq)
    np.testing.assert_allclose(lse.numpy(), jl, rtol=0, atol=1e-4)
    if ko == 1000:
        assert torch.all(out == 0) and torch.all(lse == FA.NEG_INF)


@pytest.mark.parametrize("lq,lk,causal,qo,ko", [
    (64, 64, True, 0, 0),         # below FLASH_MIN_LEN: the dense route
    (512, 512, True, 0, 0),       # the flash route (plain version on CPU)
    (512, 600, False, 0, 0),
    (512, 512, True, 0, 40),
])
def test_attention_routes_match_jax_dense(lq, lk, causal, qo, ko,
                                         monkeypatch):
    arrs = _qkv(1, lq, lk, 2, 8, seed=lq + lk + ko)
    calls = []
    real = tra.flash_attention
    monkeypatch.setattr(tra, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = tra.attention(*_torch(arrs, F32), causal=causal, q_offset=qo,
                        k_offset=ko)
    assert len(calls) == int(min(lq, lk) >= tra.FLASH_MIN_LEN)
    ref = jra.dense_attention(*_jax(arrs, F32), causal, qo, ko)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)
    dense = tra.dense_attention(*_torch(arrs, F32), causal, qo, ko)
    np.testing.assert_allclose(dense.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)
    # the two routes of the port agree with each other as well
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_dense_attention_fully_masked_rows_are_zero():
    arrs = _qkv(1, 32, 32, 2, 8, seed=9)
    got = tra.dense_attention(*_torch(arrs, F32), True, 0, 1000)
    ref = jra.dense_attention(*_jax(arrs, F32), True, 0, 1000)
    assert torch.all(got == 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# (B, Lq, Lk, H, D, causal, q_offset, k_offset): the forward's ragged,
# offset, fully masked and wide-head cases
BWD_CASES = [
    (2, 100, 100, 3, 16, True, 0, 0),
    (2, 300, 520, 3, 16, False, 0, 0),
    (2, 520, 300, 3, 16, True, 0, 0),
    (2, 100, 100, 3, 16, True, 64, 0),
    (1, 32, 32, 2, 8, True, 0, 1000),
    (1, 300, 300, 2, 160, True, 0, 0),
]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("case", BWD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_plain_backward_matches_jax_kernels(case, dtype):
    b, lq, lk, h, d, causal, qo, ko = case
    q, k, v = _qkv(b, lq, lk, h, d, seed=lq + 2 * lk + d)
    g = np.random.default_rng(d).normal(size=q.shape).astype(np.float32)
    jq, jk, jv, jg = _jax((q, k, v, g), dtype)
    jout, jlse = _flash_forward(jq, jk, jv, causal=causal, q_offset=qo,
                                k_offset=ko, interpret=True)
    ref = _flash_backward(jq, jk, jv, jout, jlse, jg, causal, qo, ko, True)
    # the JAX forward's out and its lse, (B*H, Lq_pad, 1) -> (B, H, Lq)
    out = _torch([np.asarray(jout.astype(jnp.float32))], dtype)[0]
    lse = torch.from_numpy(np.array(jlse)[:, :lq, 0].reshape(b, h, lq))
    FA.reset_launches()
    got = FA.flash_backward(*_torch((q, k, v), dtype), out, lse,
                            _torch([g], dtype)[0], causal, qo, ko)
    assert sum(FA.LAUNCHES.values()) == 0        # CPU tensors never launch
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == getattr(torch, dtype) and a.shape == r.shape
        r = np.asarray(r.astype(jnp.float32))
        if dtype == F32:
            # f32 sums in another order than the interpreted kernels
            np.testing.assert_allclose(a.numpy(), r, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        else:
            # both round an f32 sum to bf16 once: one bf16 ulp apart
            np.testing.assert_allclose(a.float().numpy(), r, rtol=2 ** -7,
                                       atol=1e-5, err_msg=name)
    if ko == 1000:
        assert all(torch.all(t == 0) for t in got)


@pytest.mark.parametrize("causal,qo,ko", [(False, 0, 0), (True, 0, 0),
                                          (True, 3, 0)])
def test_flash_attention_gradcheck(causal, qo, ko):
    """Finite differences in float64 through the autograd Function: the
    plain forward and the plain backward on the CPU."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, n, 2, 4)))
               .requires_grad_(True) for n in (6, 7, 7))
    assert torch.autograd.gradcheck(
        lambda a, b, c: FA.flash_attention(a, b, c, causal, qo, ko),
        (q, k, v), eps=1e-6, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("causal,ko", [(True, 0), (False, 0), (True, 40)])
def test_attention_gradient_matches_jax_dense(causal, ko):
    """Autograd of the port's ``attention`` at L = 512 (the flash route,
    its plain backward on the CPU) against ``jax.grad`` of the JAX
    ``dense_attention``, on the same inputs and output cotangent."""
    q, k, v = _qkv(1, 512, 512, 2, 8, seed=ko + 8)
    g = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    ref = jax.grad(lambda a, b, c: jnp.sum(
        jra.dense_attention(a, b, c, causal, 0, ko) * g),
        argnums=(0, 1, 2))(*_jax((q, k, v), F32))
    tq, tk, tv = (t.requires_grad_(True) for t in _torch((q, k, v), F32))
    out = tra.attention(tq, tk, tv, causal=causal, k_offset=ko)
    (out * torch.from_numpy(g)).sum().backward()
    for name, a, r in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_dense_route_differentiates_through_autograd():
    """Below FLASH_MIN_LEN the route is dense_attention, differentiated by
    autograd; it agrees with the flash route's backward."""
    q, k, v = _qkv(1, 64, 64, 2, 8, seed=1)
    g = torch.from_numpy(np.random.default_rng(2).normal(
        size=q.shape).astype(np.float32))
    grads = []
    for fn in (tra.attention, FA.flash_attention):
        ts = [t.requires_grad_(True) for t in _torch((q, k, v), F32)]
        (fn(*ts, causal=True) * g).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_sequence_parallel_schemes_raise():
    q, k, v = _torch(_qkv(1, 8, 8, 2, 8, seed=2), F32)
    for fn in (tra.ring_attention, tra.ulysses_attention):
        with pytest.raises(NotImplementedError, match="Long context"):
            fn(q, k, v, axis_name="seq")


def test_wrappers_refuse_bad_inputs():
    q, k, v = _torch(_qkv(1, 8, 8, 2, 8, seed=3), F32)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_forward_cuda(q, k, v)           # CPU tensors: no kernel
    out, lse = FA.flash_forward(q, k, v, True)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_backward_cuda(q, k, v, out, lse, out, True)
    with pytest.raises(ValueError, match="lse"):
        FA.flash_backward(q, k, v, out, lse[:, :1], out, True)
    with pytest.raises(ValueError, match="g "):
        FA.flash_backward(q, k, v, out, lse, out[:, :4], True)
    with pytest.raises(ValueError):
        FA.flash_forward(q, k.double(), v)
    with pytest.raises(ValueError):
        FA.flash_forward(q, k[:, :, :1], v)
    with pytest.raises(ValueError):
        FA.flash_forward(q, k, v, True, q_offset=1.5)


def _split_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the bf16 kernels form it: the f32 operand ``a`` split
    into ``hi = bf16(a)`` and ``lo = bf16(a - hi)``, each product of bf16
    values exact in f32, the two summed in one f32 accumulator."""
    hi = a.bfloat16()
    lo = (a - hi.float()).bfloat16()
    return hi.float() @ b.float() + lo.float() @ b.float()


@pytest.mark.parametrize("product", ["P V", "dS^T Q", "dS K"])
def test_bf16_split_keeps_the_f32_contract(product):
    """Why the tensor-core kernels split P and dS into hi + lo bf16: at
    the card tests' tolerance (one bf16 rounding of the result, rtol 2**-8,
    atol 1e-5 against float64), causal P V, dS^T Q (flash_dkv) and dS K
    (flash_dq) at L = 1024, D = 128 pass with the split and fail on about a
    quarter of the elements when P or dS is rounded once to bf16, as FA2
    and SDPA do."""
    rng = np.random.default_rng(0)
    bh, n, d = 4, 1024, 128
    q, k, v, g = (torch.from_numpy(rng.normal(size=(bh, n, d)))
                  .bfloat16().double() for _ in range(4))
    scale = d ** -0.5
    s = (q @ k.transpose(-1, -2) * scale).masked_fill(
        ~torch.ones(n, n, dtype=torch.bool).tril(), -torch.inf)
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    if product == "P V":
        a, b = p, v
    else:
        dp = g @ v.transpose(-1, -2)
        delta = (g * (p @ v)).sum(-1, keepdim=True)
        ds = p * (dp - delta) * scale
        a, b = (ds.transpose(-1, -2), q) if product == "dS^T Q" else (ds, k)
    ref = a @ b                                   # float64
    a32 = a.float()                               # the kernel's f32 operand
    split = _split_product(a32, b).bfloat16().double()
    once = (a32.bfloat16().float() @ b.float()).bfloat16().double()
    torch.testing.assert_close(split, ref, rtol=2 ** -8, atol=1e-5)
    failing = (~torch.isclose(once, ref, rtol=2 ** -8, atol=1e-5)).double()
    assert 0.15 < float(failing.mean()) < 0.4


def _tf32(x: torch.Tensor, rounding: str) -> torch.Tensor:
    """float32 ``x`` as TF32 (10 mantissa bits) on the f32 bits: rounded
    to nearest even (``"even"``), to nearest with ties away from zero
    (``"away"``), or truncated (``"zero"``, how the tensor cores read an
    f32 operand)."""
    i = x.contiguous().view(torch.int32)
    add = {"even": ((i >> 13) & 1) + 0xFFF, "away": 0x1000, "zero": 0}
    return ((i + add[rounding]) & ~0x1FFF).view(torch.float32)


def _3xtf32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as flash_fwd_tf32x3 forms it (``mma_tf32.cuh``): each f32
    operand split into ``big = tf32(x)`` rounded to nearest and ``small =
    x - big``, which the mma truncates to TF32; the products of TF32
    values exact in f32, small*big + big*small + big*big summed in f32."""
    ab, bb = _tf32(a, "away"), _tf32(b, "away")
    a_s, b_s = _tf32(a - ab, "zero"), _tf32(b - bb, "zero")
    return a_s @ bb + ab @ b_s + ab @ bb


# the backward's five products, each with the gradients it feeds
BWD_PRODUCTS = {"Q K^T": ("dq", "dk", "dv"), "dO V^T": ("dq", "dk"),
                "dS K": ("dq",), "dS^T Q": ("dk",), "P^T dO": ("dv",)}


def _3xtf32_inputs():
    """q, k, v, dO of causal attention at L = 1024, D = 128 (4 heads)."""
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.normal(size=(4, 1024, 128))
                             .astype(np.float32)) for _ in range(4)]


def _backward_with(products, q, k, v, g, lse, delta, causal):
    """dq, dk, dv as flash_dq / flash_dkv form them, with each of the five
    products by ``products[name]`` and P, dS in the inputs' type."""
    scale = q.shape[-1] ** -0.5
    s = products["Q K^T"](q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - lse).masked_fill(~causal, 0.0)
    dp = products["dO V^T"](g, v.transpose(-1, -2))
    ds = p * (dp - delta) * scale
    return {"dq": products["dS K"](ds, k),
            "dk": products["dS^T Q"](ds.transpose(-1, -2), q),
            "dv": products["P^T dO"](p.transpose(-1, -2), g)}


@pytest.mark.parametrize("product", ["forward", *BWD_PRODUCTS])
def test_3xtf32_keeps_the_f32_contract(product):
    """Why the f32 kernels run 3xTF32 and not TF32 on the tensor cores: at
    the card tests' f32 tolerance (rtol 1e-4, atol 1e-4 against float64),
    causal attention at L = 1024, D = 128 passes on every element with
    every product in 3xTF32.
    - forward (Q K^T and P V): with each operand rounded once to TF32 (to
      nearest even, the best one rounding can do) about 2 % of the
      elements fail (2.3 % here, f32 sums).
    - backward (flash_dq's Q K^T, dO V^T, dS K; flash_dkv's K Q^T, V dO^T,
      dS^T Q, P^T dO), from f32 LSE and delta: dq, dk and dv within 1e-5;
      and each of the five products alone rounded once to TF32 (the rest
      3xTF32) fails 0.76-1.34 % of the elements of every gradient it
      feeds, so none of them can drop to one TF32 product."""
    q, k, v, g = _3xtf32_inputs()
    n, d = q.shape[-2:]
    scale = d ** -0.5
    causal = torch.ones(n, n, dtype=torch.bool).tril()
    s64 = (q.double() @ k.double().transpose(-1, -2) * scale).masked_fill(
        ~causal, -torch.inf)
    if product == "forward":
        def attention(prod):
            s = (prod(q, k.transpose(-1, -2)) * scale).masked_fill(
                ~causal, -torch.inf)
            p = torch.exp(s - s.amax(-1, keepdim=True))
            return prod(p, v) / p.sum(-1, keepdim=True)
        ref = torch.softmax(s64, -1) @ v.double()
        split = attention(_3xtf32_product).double()
        once = attention(
            lambda a, b: _tf32(a, "even") @ _tf32(b, "even")).double()
        torch.testing.assert_close(split, ref, rtol=1e-4, atol=1e-4)
        assert float((split - ref).abs().max()) < 1e-5
        failing = (~torch.isclose(once, ref, rtol=1e-4, atol=1e-4)).double()
        assert 0.01 < float(failing.mean()) < 0.05
        return
    # the forward's LSE and delta = rowsum(dO o O), as the kernels get them
    lse = torch.logsumexp(s64, -1, keepdim=True)
    delta = (g.double() * (torch.exp(s64 - lse) @ v.double())).sum(
        -1, keepdim=True)
    lse, delta = lse.float(), delta.float()
    ref = _backward_with(dict.fromkeys(BWD_PRODUCTS, torch.matmul),
                         *(x.double() for x in (q, k, v, g, lse, delta)),
                         causal)
    split = _backward_with(dict.fromkeys(BWD_PRODUCTS, _3xtf32_product),
                           q, k, v, g, lse, delta, causal)
    one = dict.fromkeys(BWD_PRODUCTS, _3xtf32_product)
    one[product] = lambda a, b: _tf32(a, "even") @ _tf32(b, "even")
    once = _backward_with(one, q, k, v, g, lse, delta, causal)
    for name, r in ref.items():
        torch.testing.assert_close(split[name].double(), r, rtol=1e-4,
                                   atol=1e-4, msg=name)
        assert float((split[name].double() - r).abs().max()) < 1e-5
        failing = float((~torch.isclose(once[name].double(), r, rtol=1e-4,
                                        atol=1e-4)).double().mean())
        if name in BWD_PRODUCTS[product]:
            assert 0.005 < failing < 0.025, (name, failing)
        else:
            assert failing == 0.0, (name, failing)
