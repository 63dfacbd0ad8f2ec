"""Flash-attention forward: its wrapper, its plain version, its count.

``flash_forward`` is the one entry: for tensors on the card it launches
the hand-written CUDA kernel in ``csrc/flash_fwd.cu`` (which replaces the
JAX package's Pallas ``_fwd_kernel``); for tensors on the CPU it runs
``flash_forward_plain``, the plain PyTorch version of the same function.
There is no fallback from one to the other: a CUDA tensor launches the
kernel or raises.

Contract, as the JAX ``_flash_forward``: q ``(B, Lq, H, D)``, k / v
``(B, Lk, H, D)``, float32 or bfloat16, softmax and sums in float32;
optional causal masking on global positions (static integer
``q_offset`` / ``k_offset``, for shards of a longer sequence). Returns
``(out, lse)``: ``out`` ``(B, Lq, H, D)`` in q's dtype, ``lse``
``(B, H, Lq)`` float32 — the JAX ``(B*H, Lq_pad, 1)`` without its Mosaic
padding. A row whose keys are all masked gives ``out = 0`` and
``lse = NEG_INF``.

``flash_attention`` wraps the forward in a ``torch.autograd.Function``.
Its backward (the TPU ``_dq_kernel`` / ``_dkv_kernel``) is not ported
yet and raises ``NotImplementedError``: a gradient never quietly
differentiates the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from mmlspark_tpu_torch import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256          # the kernel's register tile covers D <= 256
MAX_GRID_Y = 65535          # B * H rides the grid's y dimension
MAX_OFFSET = 1 << 30        # positions are int32 inside the kernel
PLAIN_BLOCK_K = 128         # keys per block of the plain version

# launches of the CUDA kernel, keyed by the TPU kernel each launch stands
# in for; the plain version and the CPU path never count
LAUNCHES: Dict[str, int] = {"_fwd_kernel": 0}

_C_FUNCS = {torch.float32: "mml_flash_fwd_f32",
            torch.bfloat16: "mml_flash_fwd_bf16"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False, q_offset: int = 0, k_offset: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU."""
    if q.device.type == "cpu":
        _check_common(q, k, v, q_offset, k_offset)
        return flash_forward_plain(q, k, v, causal, q_offset, k_offset)
    return flash_forward_cuda(q, k, v, causal, q_offset, k_offset)


def flash_forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = False, q_offset: int = 0,
                       k_offset: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream. Reads q / k / v in
    place through their strides (only a tensor whose head dim is not
    unit-stride is copied). Raises on anything the kernel does not take
    and on a failed launch."""
    _check_common(q, k, v, q_offset, k_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward_cuda needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in _C_FUNCS:
        raise ValueError(f"dtype {q.dtype} not supported; use float32 or "
                         "bfloat16")
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is beyond the kernel's range "
                         f"[1, {MAX_HEAD_DIM}]")
    if b * h > MAX_GRID_Y:
        raise ValueError(f"B * H = {b * h} exceeds {MAX_GRID_Y}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if b * h == 0 or lq == 0:
        return out, lse
    fn = getattr(_build.load("flash_fwd"), _C_FUNCS[q.dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    strides = [s for t in (q, k, v) for s in (t.stride(0), t.stride(1),
                                              t.stride(2))]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, h, lq, lk, d, *strides,
                 1.0 / float(d) ** 0.5, int(bool(causal)), q_offset,
                 k_offset, stream)
    if err != 0:
        raise RuntimeError(f"flash-attention kernel launch failed: "
                           f"cudaError_t {err} (B={b}, Lq={lq}, Lk={lk}, "
                           f"H={h}, D={d}, {q.dtype})")
    LAUNCHES["_fwd_kernel"] += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, k_offset):
        out, _ = flash_forward(q, k, v, causal, q_offset, k_offset)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the flash-attention backward (the TPU _dq_kernel and "
            "_dkv_kernel) is not ported yet: ROADMAP.md, 'DNN training'")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, q_offset: int = 0,
                    k_offset: int = 0) -> torch.Tensor:
    """Drop-in for ``parallel.ring_attention.attention`` on long
    sequences: the attention output in q's dtype. Forward only."""
    return _FlashAttention.apply(q, k, v, bool(causal), int(q_offset),
                                 int(k_offset))
