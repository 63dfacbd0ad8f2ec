"""Flash attention, forward and backward: wrappers, plain versions, counts.

``flash_forward`` and ``flash_backward`` are the entries: for tensors on
the card they launch the hand-written CUDA kernels (``csrc/flash_fwd.cu``
replaces the JAX package's Pallas ``_fwd_kernel``, ``csrc/flash_bwd.cu``
its ``_dq_kernel`` and ``_dkv_kernel``); for tensors on the CPU they run
``flash_forward_plain`` / ``flash_backward_plain``, the plain PyTorch
versions of the same functions. There is no fallback from one to the
other: a CUDA tensor launches the kernel or raises.

Contract, as the JAX ``_flash_forward``: q ``(B, Lq, H, D)``, k / v
``(B, Lk, H, D)``, float32 or bfloat16, softmax and sums in float32;
optional causal masking on global positions (static integer
``q_offset`` / ``k_offset``, for shards of a longer sequence). Returns
``(out, lse)``: ``out`` ``(B, Lq, H, D)`` in q's dtype, ``lse``
``(B, H, Lq)`` float32 — the JAX ``(B*H, Lq_pad, 1)`` without its Mosaic
padding. A row whose keys are all masked gives ``out = 0`` and
``lse = NEG_INF``.

``flash_backward(q, k, v, out, lse, g, ...)`` -> ``(dq, dk, dv)`` is the
JAX ``_flash_backward``: the probabilities are recomputed from ``lse``,
``delta = rowsum(dO * O)`` is a float32 torch expression outside the
kernels (the JAX package computes it in XLA outside Pallas), and the
gradients come back in the inputs' types as fresh ``(B, L, H, D)``
tensors. ``flash_attention`` wraps both in a ``torch.autograd.Function``.

``LAUNCHES`` counts kernel launches by the TPU kernel each stands in for;
``FLOPS`` adds each launch's useful flops (4·D, 6·D or 8·D per unmasked
(query, key) pair, times B·H), which ``torch.utils.flop_counter`` cannot
see inside a ctypes kernel.

The forward runs as the custom op ``torch.ops.mmlspark_tpu_torch.
flash_fwd`` (registered at import, with a fake implementation), so
``torch.export`` keeps it as one node of an exported program and a
loaded program launches the same kernel; the backward kernels are
called directly from ``_FlashAttention.backward``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256          # the kernels' register tiles cover D <= 256
MAX_GRID_Y = 65535          # B * H rides the grid's y dimension
MAX_OFFSET = 1 << 30        # positions are int32 inside the kernels
PLAIN_BLOCK_K = 128         # keys per block of the plain versions

# launches of the CUDA kernels, keyed by the TPU kernel each launch stands
# in for; the plain versions and the CPU path never count
LAUNCHES: Dict[str, int] = {"_fwd_kernel": 0, "_dq_kernel": 0,
                            "_dkv_kernel": 0}
# useful flops of those launches, by the same keys
FLOPS: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)
# flops per unmasked (query, key) pair and head-dim element: S and PV in
# the forward; S, dP and dQ in _dq_kernel; S, dP, dV and dK in _dkv_kernel
FLOPS_PER_PAIR = {"_fwd_kernel": 4, "_dq_kernel": 6, "_dkv_kernel": 8}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    """Zero ``LAUNCHES`` and ``FLOPS``."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        FLOPS[k] = 0


def unmasked_pairs(lq: int, lk: int, causal: bool, q_offset: int = 0,
                   k_offset: int = 0) -> int:
    """(query, key) pairs of one head that the mask keeps."""
    if not causal:
        return lq * lk
    return int(np.clip(np.arange(lq, dtype=np.int64) + q_offset - k_offset
                       + 1, 0, lk).sum())


def _count(kernel: str, q: torch.Tensor, lk: int, causal: bool,
           q_offset: int, k_offset: int) -> None:
    b, lq, h, d = q.shape
    LAUNCHES[kernel] += 1
    FLOPS[kernel] += (FLOPS_PER_PAIR[kernel] * d * b * h
                      * unmasked_pairs(lq, lk, causal, q_offset, k_offset))


def _c_func(lib: str, entry: str, dtype: torch.dtype, n_ptr: int,
            n_long: int):
    """The C entry ``mml_<entry>_<type>`` of kernel library ``lib``, its
    ctypes signature set: ``n_ptr`` pointers, (B, H, Lq, Lk, D),
    ``n_long`` strides, then (scale, causal, q_off, k_off, stream)."""
    fn = getattr(_build.load(lib), f"mml_{entry}_{_SUFFIX[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * n_long
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _strides(*tensors: torch.Tensor):
    return [s for t in tensors for s in (t.stride(0), t.stride(1),
                                         t.stride(2))]


def _launch(fn, ptrs, shape, strides, q, causal, q_offset, k_offset,
            what: str) -> None:
    b, lq, h, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, *shape, *strides, 1.0 / float(d) ** 0.5,
                 int(bool(causal)), q_offset, k_offset, stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t "
                           f"{err} (B={b}, Lq={lq}, Lk={shape[3]}, H={h}, "
                           f"D={d}, {q.dtype})")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, q_offset: int = 0,
                        k_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: blockwise online softmax over KV blocks with the
    m / l / acc algebra of the TPU ``_fwd_kernel``. Computes in float32,
    or in float64 for float64 inputs (the reference the kernel is held
    to on the card); ``lse`` comes back in that type."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    cdt = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = 1.0 / float(d) ** 0.5
    dev = q.device
    qh = q.to(cdt).permute(0, 2, 1, 3)                     # (B, H, Lq, D)
    m = torch.full((b, h, lq, 1), NEG_INF, dtype=cdt, device=dev)
    l = torch.zeros((b, h, lq, 1), dtype=cdt, device=dev)
    acc = torch.zeros((b, h, lq, d), dtype=cdt, device=dev)
    qpos = torch.arange(lq, device=dev)[:, None] + q_offset
    for k0 in range(0, lk, PLAIN_BLOCK_K):
        if causal and k0 + k_offset > lq - 1 + q_offset:
            break   # this block and every later one lie above the diagonal
        kb = k[:, k0:k0 + PLAIN_BLOCK_K].to(cdt).permute(0, 2, 1, 3)
        vb = v[:, k0:k0 + PLAIN_BLOCK_K].to(cdt).permute(0, 2, 1, 3)
        s = torch.matmul(qh, kb.transpose(-1, -2)) * scale
        if causal:
            kpos = torch.arange(k0, k0 + kb.shape[2], device=dev)[None, :]
            valid = qpos >= kpos + k_offset
            s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        if causal:
            p = torch.where(valid, p, 0.0)
        corr = torch.exp(torch.clamp(m - m_new, max=0.0))
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vb)
        m = m_new
    l_safe = torch.where(l > 0, l, 1.0)
    out = (acc / l_safe).permute(0, 2, 1, 3).to(q.dtype)
    return out, (m + torch.log(l_safe)).squeeze(-1)


def _check_common(q, k, v, q_offset, k_offset) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, L, H, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} in batch, heads and "
                         "head dim")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    for name, off in (("q_offset", q_offset), ("k_offset", k_offset)):
        if not isinstance(off, int) or abs(off) >= MAX_OFFSET:
            raise ValueError(f"{name} must be an int below 2**30 in "
                             f"magnitude, got {off!r}")


def _check_cuda(q: torch.Tensor, what: str) -> None:
    """What the kernels need beyond ``_check_common``."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {q.device}")
    if q.dtype not in _SUFFIX:
        raise ValueError(f"dtype {q.dtype} not supported; use float32 or "
                         "bfloat16")
    b, _, h, d = q.shape
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is beyond the kernel's range "
                         f"[1, {MAX_HEAD_DIM}]")
    if b * h > MAX_GRID_Y:
        raise ValueError(f"B * H = {b * h} exceeds {MAX_GRID_Y}")


def _unit_last(*tensors: torch.Tensor):
    """Each tensor as is when its head dim is unit-stride, else a copy."""
    return tuple(t if t.stride(-1) == 1 else t.contiguous() for t in tensors)


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False, q_offset: int = 0, k_offset: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` through the custom op ``mmlspark_tpu_torch::
    flash_fwd``: the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU."""
    _check_common(q, k, v, q_offset, k_offset)
    return torch.ops.mmlspark_tpu_torch.flash_fwd(
        q, k, v, bool(causal), int(q_offset), int(k_offset))


# The forward as a torch custom op, registered at import (nothing builds
# here: the library builds at the first launch). An exported program
# (torch.export, serving/aot.py) keeps it as one opaque node, where it
# could not trace through the ctypes call; its fake implementation gives
# the shapes and types of (out, lse). The CUDA implementation always
# launches the hand-written kernel and counts the launch, wherever the
# call comes from; the CPU one runs the plain version. The op is defined
# through torch.library.Library, whose kernels the dispatcher calls
# directly: a torch.library.custom_op call first imports torch._dynamo,
# seconds that a fresh process would pay at its first forward.
_LIB = torch.library.Library("mmlspark_tpu_torch", "DEF")
_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "int q_offset, int k_offset) -> (Tensor, Tensor)")


def _flash_fwd_cuda(q, k, v, causal, q_offset, k_offset):
    return flash_forward_cuda(q, k, v, causal, q_offset, k_offset)


def _flash_fwd_cpu(q, k, v, causal, q_offset, k_offset):
    # contiguous, as the kernel writes them (the plain version's out is a
    # permuted view)
    out, lse = flash_forward_plain(q, k, v, causal, q_offset, k_offset)
    return out.contiguous(), lse.contiguous()


_LIB.impl("flash_fwd", _flash_fwd_cuda, "CUDA")
_LIB.impl("flash_fwd", _flash_fwd_cpu, "CPU")


@torch.library.register_fake("mmlspark_tpu_torch::flash_fwd")
def _flash_fwd_fake(q, k, v, causal, q_offset, k_offset):
    b, lq, h, d = q.shape
    lse_dtype = torch.float64 if q.dtype == torch.float64 else torch.float32
    return (q.new_empty((b, lq, h, d)),
            q.new_empty((b, h, lq), dtype=lse_dtype))


def flash_forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = False, q_offset: int = 0,
                       k_offset: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on the current stream. Reads q / k / v in
    place through their strides (only a tensor whose head dim is not
    unit-stride is copied). Raises on anything the kernel does not take
    and on a failed launch."""
    _check_common(q, k, v, q_offset, k_offset)
    _check_cuda(q, "flash_forward_cuda")
    b, lq, h, d = q.shape
    lk = k.shape[1]
    q, k, v = _unit_last(q, k, v)
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if b * h == 0 or lq == 0:
        return out, lse
    fn = _c_func("flash_fwd", "flash_fwd", q.dtype, 5, 9)
    _launch(fn, [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr()], (b, h, lq, lk, d), _strides(q, k, v), q,
            causal, q_offset, k_offset, "flash-attention forward")
    _count("_fwd_kernel", q, lk, causal, q_offset, k_offset)
    return out, lse


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def flash_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, lse: torch.Tensor,
                         g: torch.Tensor, causal: bool = False,
                         q_offset: int = 0, k_offset: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """The plain version: blockwise over KV blocks with the TPU kernels'
    algebra, ``p = valid ? exp(s - lse) : 0``, ``dp = dO·Vᵀ``,
    ``ds = p∘(dp − δ)·scale``, ``dQ = Σ ds·K``, ``dK = dsᵀ·Q``,
    ``dV = pᵀ·dO``. Computes in float32, or in float64 for float64
    inputs; returns dq, dk, dv in q's, k's and v's types."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    cdt = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = 1.0 / float(d) ** 0.5
    dev = q.device
    qh = q.to(cdt).permute(0, 2, 1, 3)                     # (B, H, Lq, D)
    gh = g.to(cdt).permute(0, 2, 1, 3)
    delta = (gh * out.to(cdt).permute(0, 2, 1, 3)).sum(-1, keepdim=True)
    lse = lse.to(cdt).reshape(b, h, lq, 1)
    dq = torch.zeros((b, h, lq, d), dtype=cdt, device=dev)
    dk = torch.zeros((b, h, lk, d), dtype=cdt, device=dev)
    dv = torch.zeros((b, h, lk, d), dtype=cdt, device=dev)
    qpos = torch.arange(lq, device=dev)[:, None] + q_offset
    for k0 in range(0, lk, PLAIN_BLOCK_K):
        if causal and k0 + k_offset > lq - 1 + q_offset:
            break   # this block and every later one lie above the diagonal
        kb = k[:, k0:k0 + PLAIN_BLOCK_K].to(cdt).permute(0, 2, 1, 3)
        vb = v[:, k0:k0 + PLAIN_BLOCK_K].to(cdt).permute(0, 2, 1, 3)
        s = torch.matmul(qh, kb.transpose(-1, -2)) * scale
        p = torch.exp(s - lse)
        if causal:
            kpos = torch.arange(k0, k0 + kb.shape[2], device=dev)[None, :]
            p = torch.where(qpos >= kpos + k_offset, p, 0.0)
        dp = torch.matmul(gh, vb.transpose(-1, -2))
        ds = p * (dp - delta) * scale
        dq += torch.matmul(ds, kb)
        dk[:, :, k0:k0 + PLAIN_BLOCK_K] = torch.matmul(ds.transpose(-1, -2),
                                                       qh)
        dv[:, :, k0:k0 + PLAIN_BLOCK_K] = torch.matmul(p.transpose(-1, -2),
                                                       gh)

    def back(x, like):
        return x.permute(0, 2, 1, 3).to(like.dtype)
    return back(dq, q), back(dk, k), back(dv, v)


def _check_backward(q, out, lse, g) -> None:
    b, lq, h, d = q.shape
    for name, t in (("out", out), ("g", g)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} does not match q "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
    if tuple(lse.shape) != (b, h, lq) or lse.device != q.device:
        raise ValueError(f"lse {tuple(lse.shape)} on {lse.device}, want "
                         f"{(b, h, lq)} on {q.device}")


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                   causal: bool = False, q_offset: int = 0,
                   k_offset: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``: the CUDA kernels for tensors on the card, the
    plain version for tensors on the CPU."""
    if q.device.type == "cpu":
        _check_common(q, k, v, q_offset, k_offset)
        _check_backward(q, out, lse, g)
        return flash_backward_plain(q, k, v, out, lse, g, causal, q_offset,
                                    k_offset)
    return flash_backward_cuda(q, k, v, out, lse, g, causal, q_offset,
                               k_offset)


def flash_backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        g: torch.Tensor, causal: bool = False,
                        q_offset: int = 0, k_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """Launch ``flash_dq`` and ``flash_dkv`` on the current stream. Reads
    q / k / v / g in place through their strides; ``delta`` is one float32
    torch expression before them. Raises on anything the kernels do not
    take and on a failed launch."""
    _check_common(q, k, v, q_offset, k_offset)
    _check_backward(q, out, lse, g)
    _check_cuda(q, "flash_backward_cuda")
    if lse.dtype != torch.float32:
        raise ValueError(f"lse is {lse.dtype}, the kernels read float32")
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if b * h == 0 or lq == 0 or lk == 0:
        return (torch.zeros_like(q), torch.zeros_like(k),
                torch.zeros_like(v))
    q, k, v, g = _unit_last(q, k, v, g)
    lse, delta = lse.contiguous(), flash_delta(out, g)
    dq = flash_dq_cuda(q, k, v, g, lse, delta, causal, q_offset, k_offset)
    dk, dv = flash_dkv_cuda(q, k, v, g, lse, delta, causal, q_offset,
                            k_offset)
    return dq, dk, dv


def flash_delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``delta_i = rowsum(dO_i * O_i)`` in float32, ``(B, H, Lq)``
    contiguous: the softmax-jacobian diagonal term."""
    return (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_dq_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  causal: bool = False, q_offset: int = 0,
                  k_offset: int = 0) -> torch.Tensor:
    """``flash_dq`` alone, on inputs as ``flash_backward_cuda`` hands them
    over (checked, unit-stride head dims, contiguous float32 ``lse`` and
    ``delta``): dq as a fresh ``(B, Lq, H, D)`` tensor."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    dq = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    _launch(_c_func("flash_bwd", "flash_dq", q.dtype, 7, 12),
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr()],
            (b, h, lq, lk, d), _strides(q, k, v, g), q, causal, q_offset,
            k_offset, "flash-attention dq")
    _count("_dq_kernel", q, lk, causal, q_offset, k_offset)
    return dq


def flash_dkv_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                   causal: bool = False, q_offset: int = 0,
                   k_offset: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_dkv`` alone, on inputs as for ``flash_dq_cuda``: dk and dv
    as fresh ``(B, Lk, H, D)`` tensors (every element written; key tiles
    that no query reaches as 0)."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    dk = torch.empty((b, lk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, lk, h, d), dtype=v.dtype, device=q.device)
    _launch(_c_func("flash_bwd", "flash_dkv", q.dtype, 8, 12),
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
             dv.data_ptr()],
            (b, h, lq, lk, d), _strides(q, k, v, g), q, causal, q_offset,
            k_offset, "flash-attention dkv")
    _count("_dkv_kernel", q, lk, causal, q_offset, k_offset)
    return dk, dv


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, k_offset):
        out, lse = flash_forward(q, k, v, causal, q_offset, k_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, q_offset, k_offset)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, grad_out, *ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, q_offset: int = 0,
                    k_offset: int = 0) -> torch.Tensor:
    """Drop-in for ``parallel.ring_attention.attention`` on long
    sequences: the attention output in q's dtype, differentiable through
    the backward kernels (their plain version on the CPU)."""
    return _FlashAttention.apply(q, k, v, bool(causal), int(q_offset),
                                 int(k_offset))
