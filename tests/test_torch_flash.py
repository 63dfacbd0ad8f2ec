"""PyTorch port: the flash-attention forward and the attention routes
against the JAX package, on the CPU.

The same numpy inputs go through the JAX ``_flash_forward`` (its Pallas
``_fwd_kernel`` in interpret mode, as ``tests/test_flash_attention.py``
runs it) and the port's ``flash_forward``, which on CPU tensors runs its
plain version; the CUDA kernel is held to that plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.ops.flash_attention import _flash_forward
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


def test_gradient_request_raises():
    q, k, v = _torch(_qkv(1, 64, 64, 2, 8, seed=1), F32)
    q.requires_grad_(True)
    out = FA.flash_attention(q, k, v, causal=True)
    with pytest.raises(NotImplementedError, match="DNN training"):
        out.sum().backward()


def test_sequence_parallel_schemes_raise():
    q, k, v = _torch(_qkv(1, 8, 8, 2, 8, seed=2), F32)
    for fn in (tra.ring_attention, tra.ulysses_attention):
        with pytest.raises(NotImplementedError, match="Long context"):
            fn(q, k, v, axis_name="seq")


def test_wrappers_refuse_bad_inputs():
    q, k, v = _torch(_qkv(1, 8, 8, 2, 8, seed=3), F32)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_forward_cuda(q, k, v)           # CPU tensors: no kernel
    with pytest.raises(ValueError):
        FA.flash_forward(q, k.double(), v)
    with pytest.raises(ValueError):
        FA.flash_forward(q, k[:, :, :1], v)
    with pytest.raises(ValueError):
        FA.flash_forward(q, k, v, True, q_offset=1.5)
