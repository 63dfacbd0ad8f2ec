"""The GBDT histogram kernel: its wrapper, its plain version, its count.

``hist_device`` is the one entry: for a tensor on the card it launches the
hand-written CUDA kernel in ``csrc/hist.cu`` (which replaces both TPU
kernels of ``mmlspark_tpu/gbdt/pallas_hist.py``); for a tensor on the CPU
it runs ``hist_plain``, the plain PyTorch version of the same function —
an exact copy of the JAX package's ``histogram._hist_scatter``. There is
no fallback from one to the other: a CUDA tensor launches the kernel or
raises.

Contract, as ``pallas_hist.hist_pallas``: bins FEATURES-MAJOR (F, N)
int32 in [0, B); grad / hess / weight (N,) float32 give a float32
(3, L, F, B) histogram of (grad*w, hess*w, count) sums; int8 / int16
stats (quantized training, weight the 0/1 row mask in the same type,
``count_values`` the quantized per-row weight) give an exact int32 one.
Rows with weight 0 contribute nothing. ``leaf_of_row`` (N,) int32 picks
the leaf slot when L > 1; with L == 1 the kernel ignores it, as the TPU
single-leaf kernel does (the tree grower passes zeros).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from mmlspark_tpu_torch import _build

MAX_BINS = 2048            # the range the JAX package accepts
SMEM_MAX = 232_448         # shared memory one block may use on Hopper
MAX_FEATURE_TILE = 8       # warps (one per feature) per block
# row chunks are sized for a FIXED block count, not the card's SM count,
# so the chunking — and with it the f32 summation order — is the same on
# every card
TARGET_BLOCKS = 528

# launches of the CUDA kernel, keyed by the TPU kernel each launch stands
# in for (pallas_hist._block_plan's routing); the plain version and the
# CPU path never count
LAUNCHES: Dict[str, int] = {"_hist_kernel_nibble": 0, "_hist_kernel": 0}

_C_FUNCS = {torch.float32: "mml_hist_f32", torch.int16: "mml_hist_i16",
            torch.int8: "mml_hist_i8"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def tpu_route(num_leaves: int, num_bins: int) -> str:
    """The TPU kernel pallas_hist routes (L, B) to: the digit
    decomposition for single-leaf histograms at padded B >= 128, the
    direct one-hot kernel otherwise."""
    b_pad = -(-num_bins // 32) * 32
    return ("_hist_kernel_nibble" if num_leaves == 1 and b_pad >= 128
            else "_hist_kernel")


def launch_plan(f: int, n: int, num_leaves: int,
                num_bins: int) -> Tuple[int, int, int, int]:
    """(f_tile, rows_per_chunk, n_chunks, shared-memory bytes) for a
    TRUE (f, n) input. Raises ValueError outside the kernel's range, as
    ``pallas_hist._block_plan`` does for the TPU kernels."""
    if not 1 <= num_bins <= MAX_BINS:
        raise ValueError(
            f"num_bins={num_bins} is beyond the histogram kernel's range "
            f"[1, {MAX_BINS}]; use hist_method='scatter'")
    if f < 1 or num_leaves < 1:
        raise ValueError(f"need f >= 1 and num_leaves >= 1, got {f}, "
                         f"{num_leaves}")
    per_feat = 3 * num_leaves * num_bins * 4
    if per_feat > SMEM_MAX:
        raise ValueError(
            f"num_leaves={num_leaves} x num_bins={num_bins}: one feature's "
            f"(3, L, B) histogram needs {per_feat} bytes of shared memory, "
            f"more than a block's {SMEM_MAX}; use hist_method='scatter'")
    cap = min(MAX_FEATURE_TILE, SMEM_MAX // per_feat)
    n_ftiles = -(-f // cap)
    f_tile = -(-f // n_ftiles)
    n_chunks = max(1, min(-(-TARGET_BLOCKS // n_ftiles), -(-n // 32)))
    per_chunk = -(-n // n_chunks)
    rows = max(32, -(-per_chunk // 32) * 32)    # whole warps of rows
    n_chunks = max(1, -(-n // rows))
    return f_tile, rows, n_chunks, f_tile * per_feat


def hist_plain(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
               weight: torch.Tensor, leaf_of_row: torch.Tensor,
               num_leaves: int, num_bins: int,
               count_values: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: ``index_add_`` over flat
    ``((leaf * F) + f) * B + bin`` segment ids, a copy of the JAX
    package's ``_hist_scatter``. Integer stats multiply in their own
    narrow type and widen to int32 before the add (exact)."""
    f, n = bins.shape
    lfb = num_leaves * f * num_bins
    feats = torch.arange(f, device=bins.device)[:, None]
    seg = ((leaf_of_row.long()[None, :] * f + feats) * num_bins
           + bins.long()).reshape(-1)

    def one(values):
        if not values.is_floating_point():
            values = values.to(torch.int32)
        v = values[None, :].expand(f, n).reshape(-1)
        return torch.zeros(lfb, dtype=v.dtype,
                           device=v.device).index_add_(0, seg, v)

    g = one(grad * weight)
    h = one(hess * weight)
    c = one(weight if count_values is None else count_values * weight)
    return torch.stack([g, h, c]).reshape(3, num_leaves, f, num_bins)


def hist_device(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                weight: torch.Tensor, leaf_of_row: torch.Tensor,
                num_leaves: int, num_bins: int,
                count_values: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(3, L, F, B) histogram: the CUDA kernel for tensors on the card,
    the plain version for tensors on the CPU."""
    if bins.device.type == "cpu":
        return hist_plain(bins, grad, hess, weight, leaf_of_row,
                          num_leaves, num_bins, count_values)
    return hist_cuda(bins, grad, hess, weight, leaf_of_row, num_leaves,
                     num_bins, count_values)


def _check(bins, grad, hess, weight, leaf_of_row, num_leaves,
           count_values) -> torch.dtype:
    if bins.device.type != "cuda":
        raise ValueError(f"hist_cuda needs CUDA tensors, got {bins.device}")
    if bins.dtype != torch.int32 or bins.dim() != 2:
        raise ValueError(f"bins must be (F, N) int32, got {bins.dtype} "
                         f"{tuple(bins.shape)}")
    n = bins.shape[1]
    sdt = grad.dtype
    if sdt not in _C_FUNCS:
        raise ValueError(f"stats dtype {sdt} not supported; use float32, "
                         "int16 or int8")
    stats = {"grad": grad, "hess": hess, "weight": weight}
    if count_values is not None:
        stats["count_values"] = count_values
    if num_leaves > 1:
        stats["leaf_of_row"] = leaf_of_row
    for name, t in {"bins": bins, **stats}.items():
        if t.device != bins.device:
            raise ValueError(f"{name} is on {t.device}, bins on "
                             f"{bins.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in stats.items():
        want = torch.int32 if name == "leaf_of_row" else sdt
        if t.dtype != want or t.shape != (n,):
            raise ValueError(f"{name} must be ({n},) {want}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return torch.float32 if sdt == torch.float32 else torch.int32


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def hist_cuda(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              weight: torch.Tensor, leaf_of_row: torch.Tensor,
              num_leaves: int, num_bins: int,
              count_values: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA histogram kernel on the current stream. Raises on
    anything the kernel does not take and on a failed launch."""
    acc = _check(bins, grad, hess, weight, leaf_of_row, num_leaves,
                 count_values)
    f, n = bins.shape
    f_tile, rows, n_chunks, smem = launch_plan(f, n, num_leaves, num_bins)
    out = torch.empty((3, num_leaves, f, num_bins), dtype=acc,
                      device=bins.device)
    if n == 0:
        return out.zero_()
    scratch = torch.empty((n_chunks if n_chunks > 1 else 0, 3, num_leaves,
                           f, num_bins), dtype=acc, device=bins.device)
    fn = getattr(_build.load("hist"), _C_FUNCS[grad.dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8
                       + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(bins.device):
        stream = torch.cuda.current_stream(bins.device).cuda_stream
        err = fn(bins.data_ptr(), grad.data_ptr(), hess.data_ptr(),
                 weight.data_ptr(), _ptr(count_values),
                 _ptr(leaf_of_row) if num_leaves > 1 else None,
                 out.data_ptr(), scratch.data_ptr(), f, n, num_leaves,
                 num_bins, f_tile, rows, n_chunks, smem, stream)
    if err != 0:
        raise RuntimeError(f"histogram kernel launch failed: cudaError_t "
                           f"{err} (F={f}, N={n}, L={num_leaves}, "
                           f"B={num_bins})")
    LAUNCHES[tpu_route(num_leaves, num_bins)] += 1
    return out
