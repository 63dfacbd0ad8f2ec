"""Histogram building — the GBDT hot loop, on the device.

Port of ``mmlspark_tpu/gbdt/histogram.py`` with the same contract: bins
FEATURES-MAJOR (F, N) int32, output (3, L, F, B) — channels grad / hess /
count, L leaf slots, F features, B bins. Float32 by default; integer
(quantized) stats give exact int32 sums.

Three methods, one contract, and the same ``hist_method`` values as the
JAX package so a model's params carry over:
  - 'pallas': in the port this means the HAND-WRITTEN DEVICE KERNEL —
    ``csrc/hist.cu`` through ``hist_kernels.hist_device`` (its plain
    version for CPU tensors).
  - 'scatter': the plain ``index_add_`` version (``hist_kernels.hist_plain``).
  - 'onehot': stats x one-hot products over row chunks, plain torch.

With ``axis_name`` the histogram is summed over the data axis of a
``torch.distributed`` group (``parallel.distributed.Axis``: an ordered
sum on every rank), so every rank sees the global histogram. Integer
(quantized) histograms ride a NARROW wire when ``wire_dtype`` is given
(int16): the global-L1 gradient scales of the tree grower bound every
partial sum by the quantization range, so the narrow bytes cannot
overflow, and the sum widens back to exact int32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F_

from mmlspark_tpu_torch.gbdt.hist_kernels import hist_device, hist_plain


def build_histogram(bins: torch.Tensor, grad: torch.Tensor,
                    hess: torch.Tensor, weight: torch.Tensor,
                    leaf_of_row: torch.Tensor, num_leaves: int,
                    num_bins: int, method: str = "scatter",
                    axis_name: Optional[str] = None,
                    count_values: Optional[torch.Tensor] = None,
                    wire_dtype=None) -> torch.Tensor:
    """Per-(leaf, feature, bin) sums of grad/hess/count: (3, L, F, B).

    ``weight`` doubles as the padding/bagging mask (0 = row ignored).
    Bins come unpadded: the kernel masks the ragged edge itself, so the
    JAX package's ``true_shape`` argument has no counterpart.
    ``axis_name`` (a ``parallel.distributed.Axis``, or any name for the
    default group's) sums the rank-local histogram over the ranks."""
    hist = _local_histogram(bins, grad, hess, weight, leaf_of_row,
                            num_leaves, num_bins, method, count_values)
    if axis_name is not None:
        from mmlspark_tpu_torch.parallel.distributed import as_axis
        hist = as_axis(axis_name).psum(
            hist, wire_dtype=wire_dtype if not
            hist.dtype.is_floating_point else None)
    return hist


def _local_histogram(bins, grad, hess, weight, leaf_of_row, num_leaves,
                     num_bins, method, count_values):
    if method == "onehot":
        if count_values is not None:
            raise ValueError(
                "quantized histograms (hist_bits < 32) are not supported "
                "by hist_method='onehot' (it accumulates f32); use "
                "hist_method='scatter' or 'pallas'")
        return _hist_onehot(bins, grad, hess, weight, leaf_of_row,
                            num_leaves, num_bins)
    if method == "pallas":
        return hist_device(bins, grad, hess, weight, leaf_of_row,
                           num_leaves, num_bins, count_values)
    if method == "scatter":
        return hist_plain(bins, grad, hess, weight, leaf_of_row,
                          num_leaves, num_bins, count_values)
    raise ValueError(f"unknown hist method {method!r}; expected 'scatter', "
                     "'onehot' or 'pallas'")


def _hist_onehot(bins, grad, hess, weight, leaf_of_row, num_leaves,
                 num_bins, chunk: int = 4096):
    f, n = bins.shape
    acc = torch.zeros((3, num_leaves, f * num_bins), dtype=torch.float32,
                      device=bins.device)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        w = weight[s:e]
        stats = torch.stack([grad[s:e] * w, hess[s:e] * w, w])    # (3, C)
        leaf_oh = F_.one_hot(leaf_of_row[s:e].long(),
                             num_leaves).to(torch.float32)        # (C, L)
        lhs = stats[:, None, :] * leaf_oh.T[None, :, :]           # (3, L, C)
        bin_oh = F_.one_hot(bins[:, s:e].long(),
                            num_bins).to(torch.float32)           # (F, C, B)
        rhs = bin_oh.permute(1, 0, 2).reshape(e - s, f * num_bins)
        acc += torch.einsum("slc,cx->slx", lhs, rhs)
    return acc.reshape(3, num_leaves, f, num_bins)
