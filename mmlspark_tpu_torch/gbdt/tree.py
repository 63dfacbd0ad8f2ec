"""Leaf-wise tree growth and the batched forest walk.

Port of ``mmlspark_tpu/gbdt/tree.py`` (serial). The
JAX grower is one jitted ``fori_loop`` with masked updates; here the
split loop is a Python loop whose per-split bookkeeping lives on the host
(a few (L,) / (2L-1,) numpy arrays) while the row-sized work stays on the
device: the row partition, one histogram per split through
``build_histogram`` (the hand-written kernel under ``hist_method=
'pallas'``), the sibling subtraction and the best-split search. One small
device->host read per split carries the two children's best candidates.

Kept from the JAX grower, so trees come out the same:
  - the histogram cache with sibling subtraction (left = parent - right);
  - leaf totals from feature 0's bins (any feature's bins partition a
    leaf's rows);
  - the first-max tie-break of ``argmax`` over the flattened (F, B) gain
    and over the cached best gains (``torch.argmax`` / ``np.argmax`` also
    return the first maximum);
  - the masked ``do`` semantics: once no leaf can split, every later step
    is a no-op, so the loop breaks instead (``done`` is sticky);
  - the dummy-slot value scatter for inactive leaf slots.

It builds one L = 1 histogram for the root and one per split: at most
``num_leaves`` histograms per tree per class.

Quantized training (``hist_bits`` 16 / 8) follows the JAX grower: the
gradients, hessians and weights are stochastically rounded once per tree
to int16 / int8 under global-L1 scales, with uniforms keyed on
``quant_key`` and the row id (``prng``, JAX's threefry bit for bit); the
histograms, the cache's sibling subtraction and the bin cumsums are exact
int32, dequantized once at gain time and at the leaf values. The
bagging / feature-fraction masks of ``sample_iteration_masks`` come from
the same bits. The distributed modes are not ported yet
(``booster.train`` raises NotImplementedError naming the ROADMAP.md
item).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.gbdt import prng
from mmlspark_tpu_torch.gbdt.histogram import build_histogram

NEG_INF = -1e30


class GrowParams(NamedTuple):
    """Growth hyperparams: the JAX package's fields and defaults for the
    serial grower (its distributed fields are not ported yet)."""
    num_leaves: int = 31
    num_bins: int = 64
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    max_depth: int = 0  # <=0 means unlimited
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    hist_method: str = "scatter"
    # 32 = float32 histograms; 16 / 8 = stochastically rounded int16 /
    # int8 stats with exact int32 histograms
    hist_bits: int = 32


class Tree(NamedTuple):
    """Flat tree arrays (host numpy); node 0 is the root, max 2L-1 nodes.
    Leaves have left == right == own index (self-loop), which makes batch
    inference a fixed-depth pointer walk (see predict_trees)."""
    feature: np.ndarray        # (M,) int32 split feature
    bin_threshold: np.ndarray  # (M,) int32 'go left if bin <= t'
    threshold: np.ndarray      # (M,) f32 raw-value threshold (filled later)
    left: np.ndarray           # (M,) int32
    right: np.ndarray          # (M,) int32
    value: np.ndarray          # (M,) f32 leaf output
    is_leaf: np.ndarray        # (M,) bool
    gain: np.ndarray           # (M,) f32 split gain at internal nodes
    count: np.ndarray          # (M,) f32 row count at node


def _index_uniforms(key: prng.Key, ids: torch.Tensor) -> torch.Tensor:
    """Counter-based float32 uniforms: u[j] = uniform(fold_in(key,
    ids[j])), a function of (key, ids[j]) alone, so a row or feature
    draws the same value whatever the length of ``ids``. On the device
    of ``ids``."""
    return prng.uniform(prng.fold_in(key, ids))


def sample_iteration_masks(key: prng.Key, it: int, w_base: torch.Tensor,
                           fmask_base: torch.Tensor, bag_cfg, ff_cfg,
                           f_valid: int, f_total: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bagging / feature-fraction masks of boosting iteration ``it`` (the
    JAX package's, serial): a pure function of (key, it) and the row /
    feature index.

    - Bagging (``bag_cfg = (fraction, freq)``): per-row uniforms from the
      key folded with the last resample iteration and then 1; a row stays
      while its uniform is below the fraction (in float32).
    - Feature fraction (``ff_cfg = fraction``): per-feature uniforms from
      the key folded with ``it`` and then 2; with k = max(1, ceil(fraction
      * f_valid)), the features whose uniform is at most the k-th smallest
      stay (``uf <= kth``: features tied with the k-th all stay, as in
      the JAX package)."""
    w = w_base
    if bag_cfg is not None:
        frac, freq = bag_cfg
        bag_it = (it // freq) * freq
        kb = prng.fold_in(prng.fold_in(key, bag_it), 1)
        u = _index_uniforms(kb, torch.arange(w_base.shape[0],
                                             device=w_base.device))
        # the fraction as the float32 the JAX package compares with
        w = w_base * (u < float(np.float32(frac)))
    fmask = fmask_base
    if ff_cfg is not None:
        dev = fmask_base.device
        kf = prng.fold_in(prng.fold_in(key, it), 2)
        uf = _index_uniforms(kf, torch.arange(f_total, device=dev))
        valid = torch.arange(f_total, device=dev) < f_valid
        uf = torch.where(valid, uf, torch.full_like(uf, math.inf))
        k = max(1, math.ceil(ff_cfg * f_valid))
        kth = torch.sort(uf).values[k - 1]
        m = ((uf <= kth) & valid).to(fmask_base.dtype)
        fmask = fmask_base * m
    return w, fmask


def _leaf_output(g, h, l1, l2):
    """Optimal leaf value with L1 soft-thresholding:
    -sgn(g)·max(|g|-l1, 0) / (h + l2)."""
    num = torch.sign(g) * torch.clamp(torch.abs(g) - l1, min=0.0)
    return -num / (h + l2)


def _split_gain(g, h, l1, l2):
    num = torch.clamp(torch.abs(g) - l1, min=0.0)
    return num * num / (h + l2)


def quant_scales(grad: torch.Tensor, hess: torch.Tensor,
                 weight: torch.Tensor, hist_bits: int) -> torch.Tensor:
    """The (3,) float32 quantization steps (dg, dh, dc) of one tree:
    ``delta = max(sum(|stat|), 1e-30) / Q``, Q = 2**(bits - 2), over
    grad * weight, hess * weight and weight — float32 sums in torch's
    order, as the JAX package takes them in XLA's."""
    scales = torch.stack([torch.sum(torch.abs(grad * weight)),
                          torch.sum(torch.abs(hess * weight)),
                          torch.sum(torch.abs(weight))])
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=grad.device)
    return torch.maximum(scales, tiny) / (1 << (hist_bits - 2))


def _sround(vals: torch.Tensor, delta: torch.Tensor, quant_key: prng.Key,
            chan: int, sdt: torch.dtype) -> torch.Tensor:
    """Stochastic rounding of vals / delta: floor(x) + (u < x - floor(x))
    with u the uniform of (fold_in(quant_key, chan), row id), so every
    row rounds the same way whatever the layout."""
    x = vals / delta
    fl = torch.floor(x)
    u = _index_uniforms(prng.fold_in(quant_key, chan),
                        torch.arange(vals.shape[0], device=vals.device))
    return (fl + (u < (x - fl)).to(torch.float32)).to(sdt)


def quantize_stats(grad: torch.Tensor, hess: torch.Tensor,
                   weight: torch.Tensor, hist_bits: int,
                   quant_key: prng.Key):
    """The JAX grower's once-per-tree discretization: (qg, qh, qc) in
    int16 / int8 (channels 0, 1, 2 of the rounding) and the (3,) scales
    (dg, dh, dc). Rows of weight 0 round to 0."""
    sdt = torch.int8 if hist_bits == 8 else torch.int16
    deltas = quant_scales(grad, hess, weight, hist_bits)
    return (_sround(grad * weight, deltas[0], quant_key, 0, sdt),
            _sround(hess * weight, deltas[1], quant_key, 1, sdt),
            _sround(weight, deltas[2], quant_key, 2, sdt), deltas)


def grow_tree(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              weight: torch.Tensor, feature_mask: torch.Tensor,
              p: GrowParams, quant_key: Optional[prng.Key] = None
              ) -> Tuple[Tree, torch.Tensor, torch.Tensor, int]:
    """Grow one tree; returns (Tree, leaf_of_row, leaf_values, n_leaves).

    bins is FEATURES-MAJOR (F, N) int32; grad/hess/weight (N,) float32
    and feature_mask (F,) float32 (0 disables a feature) on the same
    device. The Tree's arrays are host numpy; ``leaf_of_row`` (N,) int32
    and ``leaf_values`` (L,) float32 stay on the device for the score
    update. ``p.hist_bits`` 16 / 8 needs ``quant_key``, the tree's key
    for the stochastic rounding (``quantize_stats``)."""
    f, n = bins.shape
    L = p.num_leaves
    M = 2 * L - 1
    B = p.num_bins
    dev = bins.device
    l1, l2 = p.lambda_l1, p.lambda_l2
    min_hess = p.min_sum_hessian_in_leaf
    min_data = float(p.min_data_in_leaf)
    zero_leaf = torch.zeros(n, dtype=torch.int32, device=dev)
    neg_inf = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    fm_ok = (feature_mask > 0)[:, None]
    quantized = p.hist_bits < 32
    if quantized:
        if p.hist_bits not in (16, 8):
            raise ValueError(
                f"hist_bits={p.hist_bits} is not supported: use 32 "
                "(f32), 16 or 8 (quantized stochastic rounding)")
        if quant_key is None:
            raise ValueError(
                "hist_bits < 32 requires quant_key (per-round PRNG key "
                "for deterministic stochastic rounding)")
        sdt = torch.int8 if p.hist_bits == 8 else torch.int16
        qg, qh, qc, deltas = quantize_stats(grad, hess, weight, p.hist_bits,
                                            quant_key)

    def leaf_hist(mask_weight):
        """(3, F, B) histogram of the rows selected by mask_weight:
        float32, or exact int32 when quantized (mask_weight is then the
        0/1 row indicator in the narrow type; the row weight lives in
        qg / qh / qc)."""
        if quantized:
            return build_histogram(bins, qg, qh, mask_weight, zero_leaf, 1,
                                   B, method=p.hist_method,
                                   count_values=qc)[:, 0]
        return build_histogram(bins, grad, hess, mask_weight, zero_leaf, 1,
                               B, method=p.hist_method)[:, 0]

    def best_split(hist, depth_ok: bool) -> torch.Tensor:
        """Best candidate split of one leaf from its (3, F, B) histogram:
        float64 (gain, feature, bin, left_count, total_count) — every
        entry an exact widening of its float32 / int value."""
        if quantized:
            # exact int32 cumsums, one dequantize at gain time: float32(int)
            # * delta; feature 0's last cumsum is the leaf's exact total
            GL, HL, CL = (torch.cumsum(hist, dim=-1, dtype=torch.int32)
                          .to(torch.float32) * deltas[:, None, None])
            G, H, C = GL[0, -1], HL[0, -1], CL[0, -1]
        else:
            Gh, Hh, Ch = hist[0], hist[1], hist[2]               # (F, B)
            G, H, C = Gh[0].sum(), Hh[0].sum(), Ch[0].sum()
            GL = torch.cumsum(Gh, dim=-1)
            HL = torch.cumsum(Hh, dim=-1)
            CL = torch.cumsum(Ch, dim=-1)
        GR, HR, CR = G - GL, H - HL, C - CL
        parent_score = _split_gain(G, H, l1, l2)
        gain = (_split_gain(GL, HL, l1, l2) + _split_gain(GR, HR, l1, l2)
                - parent_score)
        ok = ((CL >= min_data) & (CR >= min_data)
              & (HL >= min_hess) & (HR >= min_hess) & fm_ok)
        if not depth_ok:
            ok = torch.zeros_like(ok)
        gain = torch.where(ok, gain, neg_inf).reshape(-1)
        flat = torch.argmax(gain)
        return torch.stack([gain[flat].double(), (flat // B).double(),
                            (flat % B).double(),
                            CL.reshape(-1)[flat].double(), C.double()])

    # root: slot 0 holds all rows (its children sit at depth 1, legal for
    # any max_depth >= 1, so the root's candidate is never depth-blocked)
    root_hist = leaf_hist(torch.ones(n, dtype=sdt, device=dev)
                          if quantized else weight)
    hist_cache = torch.zeros((L,) + tuple(root_hist.shape),
                             dtype=root_hist.dtype, device=dev)
    hist_cache[0] = root_hist
    g0, f0, b0, cl0, c0 = best_split(root_hist, True).cpu().numpy()

    feature = np.zeros(M, np.int32)
    bin_threshold = np.zeros(M, np.int32)
    left = np.arange(M, dtype=np.int32)     # self-loops by default
    right = np.arange(M, dtype=np.int32)
    is_leaf = np.ones(M, dtype=bool)
    gain_arr = np.zeros(M, np.float32)
    count_arr = np.zeros(M, np.float32)
    leaf_to_node = np.zeros(L, np.int32)    # leaf slot -> node id
    leaf_depth = np.zeros(L, np.int32)
    best_gain = np.full(L, NEG_INF, np.float32)
    best_feat = np.zeros(L, np.int32)
    best_bin = np.zeros(L, np.int32)
    best_cl = np.zeros(L, np.float32)
    leaf_count = np.zeros(L, np.float32)
    best_gain[0], best_feat[0], best_bin[0] = g0, f0, b0
    best_cl[0], leaf_count[0] = cl0, c0

    leaf_of_row = zero_leaf
    n_leaves, next_node = 1, 1
    min_gain = np.float32(p.min_gain_to_split)
    for _ in range(L - 1):
        bl = int(np.argmax(best_gain))
        bg = best_gain[bl]
        if not (bg > min_gain and bg > np.float32(NEG_INF / 2)):
            break   # `done` is sticky: every later step would be a no-op
        bf, bb = int(best_feat[bl]), int(best_bin[bl])
        new_leaf = n_leaves
        goes_right = (leaf_of_row == bl) & (bins[bf] > bb)
        leaf_of_row = torch.where(goes_right, new_leaf, leaf_of_row) \
            .to(torch.int32)

        # one masked single-leaf histogram for the right child; the left
        # sibling is parent - right (the LightGBM subtraction trick)
        if quantized:
            hist_r = leaf_hist((leaf_of_row == new_leaf).to(sdt))
        else:
            hist_r = leaf_hist(weight * (leaf_of_row == new_leaf))
        hist_l = hist_cache[bl] - hist_r

        child_depth = int(leaf_depth[bl]) + 1
        depth_ok = p.max_depth <= 0 or child_depth < p.max_depth
        (gl, fl, bl_bin, cll, cl_tot), (gr, fr, br_bin, clr, cr_tot) = \
            torch.stack([best_split(hist_l, depth_ok),
                         best_split(hist_r, depth_ok)]).cpu().numpy()

        parent = leaf_to_node[bl]
        lid, rid = next_node, next_node + 1
        feature[parent] = bf
        bin_threshold[parent] = bb
        left[parent], right[parent] = lid, rid
        is_leaf[parent] = False
        gain_arr[parent] = bg
        cl_best = best_cl[bl]
        count_arr[lid] = cl_best
        count_arr[rid] = leaf_count[bl] - cl_best
        leaf_to_node[bl], leaf_to_node[new_leaf] = lid, rid
        leaf_depth[bl] = leaf_depth[new_leaf] = child_depth
        hist_cache[bl] = hist_l
        hist_cache[new_leaf] = hist_r
        best_gain[bl], best_gain[new_leaf] = gl, gr
        best_feat[bl], best_feat[new_leaf] = fl, fr
        best_bin[bl], best_bin[new_leaf] = bl_bin, br_bin
        best_cl[bl], best_cl[new_leaf] = cll, clr
        leaf_count[bl], leaf_count[new_leaf] = cl_tot, cr_tot
        n_leaves += 1
        next_node += 2

    # per-leaf grad/hess sums straight from the cached histograms:
    # feature 0's bin sums ARE the leaf totals
    g_leaf = hist_cache[:, 0, 0, :].sum(-1)
    h_leaf = hist_cache[:, 1, 0, :].sum(-1)
    if quantized:
        g_leaf = g_leaf.to(torch.float32) * deltas[0]
        h_leaf = h_leaf.to(torch.float32) * deltas[1]
    active_d = torch.arange(L, device=dev) < n_leaves
    leaf_values = torch.where(active_d, _leaf_output(g_leaf, h_leaf, l1, l2),
                              torch.zeros((), device=dev))

    # inactive slots all hold leaf_to_node=0; route them to a dummy slot M
    # so the scatter can't zero the root's value (node 0)
    active = np.arange(L) < n_leaves
    scatter_idx = np.where(active, leaf_to_node, M)
    value = np.zeros(M + 1, np.float32)
    value[scatter_idx] = np.where(active, leaf_values.cpu().numpy(), 0.0)

    tree = Tree(feature=feature, bin_threshold=bin_threshold,
                threshold=np.zeros(M, np.float32), left=left, right=right,
                value=value[:M], is_leaf=is_leaf, gain=gain_arr,
                count=count_arr)
    return tree, leaf_of_row, leaf_values, n_leaves


def predict_trees(features: torch.Tensor, feature_arr: torch.Tensor,
                  threshold_arr: torch.Tensor, left_arr: torch.Tensor,
                  right_arr: torch.Tensor, value_arr: torch.Tensor,
                  max_depth: int, row_block: int = 1 << 16) -> torch.Tensor:
    """Batch inference over stacked trees: features (N, F) float32, tree
    arrays (T, M) on the same device. Returns (T, N) leaf outputs.

    Fixed-depth pointer walk: leaves self-loop, so walking max_depth
    steps from the root always lands on the reached leaf. NaN goes LEFT
    (``~(fv > thr)`` is True for NaN), matching training, where binning
    maps NaN to bin 0. Rows go in blocks to bound the (T, rows) index
    tensors."""
    T, n = feature_arr.shape[0], features.shape[0]
    feat, left, right = (a.long() for a in (feature_arr, left_arr,
                                            right_arr))
    out = torch.empty((T, n), dtype=value_arr.dtype, device=features.device)
    for r0 in range(0, n, row_block):
        X = features[r0:r0 + row_block]
        rows = torch.arange(X.shape[0], device=X.device)[None, :]
        node = torch.zeros((T, X.shape[0]), dtype=torch.long,
                           device=X.device)
        for _ in range(max_depth):
            fv = X[rows, torch.gather(feat, 1, node)]
            go_left = ~(fv > torch.gather(threshold_arr, 1, node))
            node = torch.where(go_left, torch.gather(left, 1, node),
                               torch.gather(right, 1, node))
        out[:, r0:r0 + X.shape[0]] = torch.gather(value_arr, 1, node)
    return out
