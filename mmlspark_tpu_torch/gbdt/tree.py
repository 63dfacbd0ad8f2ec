"""Leaf-wise tree growth and the batched forest walk.

Port of ``mmlspark_tpu/gbdt/tree.py``. The
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
the same bits. The distributed modes (data / reduce-scatter, voting,
feature) run over a ``torch.distributed`` group, one rank per process
(``grow_tree``'s docstring).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.gbdt import prng
from mmlspark_tpu_torch.gbdt.histogram import build_histogram
from mmlspark_tpu_torch.parallel.distributed import as_axis

NEG_INF = -1e30


class GrowParams(NamedTuple):
    """Growth hyperparams: the JAX package's fields and defaults (its
    ``n_shards`` is the data axis's size here)."""
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
    voting_k: int = 20   # parallel_mode='voting': candidates per rank
    # data-parallel histogram collective: 'psum' sums the full (3, F, B)
    # histogram on every rank; 'reduce_scatter' gives each rank the sum
    # of its F / D features' slices (LightGBM's reduce-scatter recipe)
    hist_comm: str = "psum"


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
                           f_valid: int, f_total: int, axis_name=None,
                           parallel_mode: str = "data"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bagging / feature-fraction masks of boosting iteration ``it`` (the
    JAX package's): a pure function of (key, it) and the GLOBAL row /
    feature index, so serial and distributed runs draw the same masks.

    - Bagging (``bag_cfg = (fraction, freq)``): per-row uniforms from the
      key folded with the last resample iteration and then 1; a row stays
      while its uniform is below the fraction (in float32). Row-sharded
      modes (data / voting, ``axis_name`` set) index by the rank's global
      row offset, rank x local rows.
    - Feature fraction (``ff_cfg = fraction``): per-feature uniforms from
      the key folded with ``it`` and then 2; with k = max(1, ceil(fraction
      * f_valid)), the features whose uniform is at most the k-th smallest
      stay (``uf <= kth``: features tied with the k-th all stay, as in
      the JAX package). Feature-parallel ranks take their window of the
      global mask."""
    w = w_base
    axis = None if axis_name is None else as_axis(axis_name)
    if bag_cfg is not None:
        frac, freq = bag_cfg
        bag_it = (it // freq) * freq
        kb = prng.fold_in(prng.fold_in(key, bag_it), 1)
        n_loc = w_base.shape[0]
        row0 = (axis.rank * n_loc
                if axis is not None and parallel_mode != "feature" else 0)
        u = _index_uniforms(kb, row0 + torch.arange(n_loc,
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
        f_loc = fmask_base.shape[0]
        if axis is not None and parallel_mode == "feature" \
                and f_total != f_loc:
            m = m[axis.rank * f_loc:(axis.rank + 1) * f_loc]
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
                 weight: torch.Tensor, hist_bits: int,
                 axis_name=None) -> torch.Tensor:
    """The (3,) float32 quantization steps (dg, dh, dc) of one tree:
    ``delta = max(sum(|stat|), 1e-30) / Q``, Q = 2**(bits - 2), over
    grad * weight, hess * weight and weight — float32 sums in torch's
    order, as the JAX package takes them in XLA's; summed over the ranks
    (one stacked 3-scalar psum) when rows are sharded over
    ``axis_name``."""
    scales = torch.stack([torch.sum(torch.abs(grad * weight)),
                          torch.sum(torch.abs(hess * weight)),
                          torch.sum(torch.abs(weight))])
    if axis_name is not None:
        scales = as_axis(axis_name).psum(scales)
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=grad.device)
    return torch.maximum(scales, tiny) / (1 << (hist_bits - 2))


def _sround(vals: torch.Tensor, delta: torch.Tensor, quant_key: prng.Key,
            chan: int, sdt: torch.dtype, row0: int = 0) -> torch.Tensor:
    """Stochastic rounding of vals / delta: floor(x) + (u < x - floor(x))
    with u the uniform of (fold_in(quant_key, chan), global row id =
    ``row0`` + local index), so every row rounds the same way whatever
    the layout."""
    x = vals / delta
    fl = torch.floor(x)
    u = _index_uniforms(prng.fold_in(quant_key, chan),
                        row0 + torch.arange(vals.shape[0],
                                            device=vals.device))
    return (fl + (u < (x - fl)).to(torch.float32)).to(sdt)


def quantize_stats(grad: torch.Tensor, hess: torch.Tensor,
                   weight: torch.Tensor, hist_bits: int,
                   quant_key: prng.Key, axis_name=None, row0: int = 0):
    """The JAX grower's once-per-tree discretization: (qg, qh, qc) in
    int16 / int8 (channels 0, 1, 2 of the rounding) and the (3,) scales
    (dg, dh, dc). Rows of weight 0 round to 0."""
    sdt = torch.int8 if hist_bits == 8 else torch.int16
    deltas = (quant_scales(grad, hess, weight, hist_bits)
              if axis_name is None else
              quant_scales(grad, hess, weight, hist_bits, axis_name))
    return (_sround(grad * weight, deltas[0], quant_key, 0, sdt, row0),
            _sround(hess * weight, deltas[1], quant_key, 1, sdt, row0),
            _sround(weight, deltas[2], quant_key, 2, sdt, row0), deltas)


def _slot_totals(hist: torch.Tensor, slot: int) -> torch.Tensor:
    """(3,) grad / hess / count sums over the bins of feature slot
    ``slot`` of a (3, F, B) histogram (any feature's bins partition the
    leaf's rows): exact integer sums, or float32 sums taken on a fresh
    copy, so the device reduction's order does not depend on where the
    slot sits in memory (psum and reduce-scatter caches place it apart)."""
    if not hist.dtype.is_floating_point:
        return hist[:, slot, :].sum(-1, dtype=torch.int64)
    t = hist[:, slot, :].clone()
    return torch.stack([t[0].sum(), t[1].sum(), t[2].sum()])


def _leaf_sums(hist_cache: torch.Tensor, slot: int) -> torch.Tensor:
    """(2, L) grad / hess sums of every leaf slot from its cached
    histogram's feature ``slot`` (int64 when quantized)."""
    if not hist_cache.dtype.is_floating_point:
        return hist_cache[:, :2, slot, :].sum(-1, dtype=torch.int64).T
    return hist_cache[:, :2, slot, :].clone().sum(-1).T


def grow_tree(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              weight: torch.Tensor, feature_mask: torch.Tensor,
              p: GrowParams, quant_key: Optional[prng.Key] = None,
              axis_name=None, parallel_mode: str = "data"
              ) -> Tuple[Tree, torch.Tensor, torch.Tensor, int]:
    """Grow one tree; returns (Tree, leaf_of_row, leaf_values, n_leaves).

    bins is FEATURES-MAJOR (F, N) int32; grad/hess/weight (N,) float32
    and feature_mask (F,) float32 (0 disables a feature) on the same
    device. The Tree's arrays are host numpy; ``leaf_of_row`` (N,) int32
    and ``leaf_values`` (L,) float32 stay on the device for the score
    update. ``p.hist_bits`` 16 / 8 needs ``quant_key``, the tree's key
    for the stochastic rounding (``quantize_stats``).

    Distribution (``axis_name``: a ``parallel.distributed.Axis``, the
    ranks of a ``torch.distributed`` group, one device each) follows the
    JAX grower's ``tree_learner`` modes; each rank's histogram stays the
    hist kernel on the card (the plain version on the CPU), only the
    collectives are new:

    - ``'data'``: rows sharded; each histogram is summed over the ranks
      (``hist_comm='psum'``), so every rank grows the same tree. With
      ``hist_comm='reduce_scatter'`` each rank gets the sum of a
      contiguous F / D feature slice plus the summed feature-0 slice
      (the leaf totals in psum's association), proposes its slice's best
      split, and the (D, 4) candidate table is all-gathered; the first
      maximum over ranks is psum's lowest-(feature, bin) tie-break.
    - ``'voting'``: rows sharded; each rank votes its top ``voting_k``
      features by local gain, the votes are all-gathered and only the
      candidates' slices (and feature 0's) are summed. The left child's
      search ships the (parent, right) pair unsubtracted, so the f32
      subtraction follows the sum, data-parallel's order. Exact search
      when ``voting_k >= F``.
    - ``'feature'``: features sharded (F / D each, global ids in the
      tree), rows replicated. Each rank proposes its best local split
      against the totals of global feature 0 (its owner, rank 0,
      broadcasts them), the candidates are all-gathered, and the winning
      feature's owner broadcasts the row bitmap (packed bits); the leaf
      sums are rank 0's feature-0 sums, broadcast — serial's, so the
      ranks' trees are bitwise equal.

    Quantized stats round with GLOBAL row ids (rank x local rows) under
    scales summed over the ranks; their histograms cross on an int16
    wire and sum to exact int32."""
    from mmlspark_tpu_torch.parallel.distributed import pack_bits, \
        unpack_bits
    f, n = bins.shape
    L = p.num_leaves
    M = 2 * L - 1
    B = p.num_bins
    dev = bins.device
    l1, l2 = p.lambda_l1, p.lambda_l2
    min_hess = p.min_sum_hessian_in_leaf
    min_data = float(p.min_data_in_leaf)
    axis = None if axis_name is None else as_axis(axis_name)
    feat_par = parallel_mode == "feature" and axis is not None
    voting = parallel_mode == "voting" and axis is not None
    quantized = p.hist_bits < 32
    rs = (p.hist_comm == "reduce_scatter" and axis is not None
          and parallel_mode == "data")
    if p.hist_comm not in ("psum", "reduce_scatter"):
        raise ValueError(f"unknown hist_comm={p.hist_comm!r}; "
                         "expected 'psum' or 'reduce_scatter'")
    if p.hist_comm == "reduce_scatter" and (feat_par or voting):
        raise ValueError(
            "hist_comm='reduce_scatter' is a data-parallel recipe; "
            f"parallel_mode={parallel_mode!r} already keeps histograms "
            "local (feature/voting) — use hist_comm='psum'")
    zero_leaf = torch.zeros(n, dtype=torch.int32, device=dev)
    neg_inf = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    wire = torch.int16 if quantized else None
    if quantized:
        if p.hist_bits not in (16, 8):
            raise ValueError(
                f"hist_bits={p.hist_bits} is not supported: use 32 "
                "(f32), 16 or 8 (quantized stochastic rounding)")
        if feat_par:
            raise ValueError(
                "hist_bits < 32 with parallel_mode='feature' is not "
                "supported: feature-parallel histograms never cross "
                "the wire, so quantization only adds rounding noise")
        if quant_key is None:
            raise ValueError(
                "hist_bits < 32 requires quant_key (per-round PRNG key "
                "for deterministic stochastic rounding)")
        sdt = torch.int8 if p.hist_bits == 8 else torch.int16
        qg, qh, qc, deltas = quantize_stats(
            grad, hess, weight, p.hist_bits, quant_key, axis,
            row0=axis.rank * n if axis is not None else 0)
    # voting and feature keep histograms local; reduce-scatter runs its
    # own collective inside leaf_hist
    hist_axis = None if (feat_par or voting or rs) else axis
    fm_ok = feature_mask > 0
    if rs:
        D = axis.size
        Fp = -(-f // D) * D           # F padded to a multiple of D
        fs = Fp // D                  # owned features per rank
        f_off = axis.rank * fs
        fm_rows = torch.nn.functional.pad(fm_ok, (0, Fp - f))[
            f_off:f_off + fs]
        tot_slot = -1
    else:
        f_off = axis.rank * f if feat_par else 0
        fm_rows = fm_ok
        tot_slot = 0

    def leaf_hist(mask_weight):
        """Histogram of the rows selected by mask_weight: (3, F, B)
        float32, or exact int32 when quantized (mask_weight is then the
        0/1 row indicator in the narrow type; the row weight lives in
        qg / qh / qc); under reduce_scatter (3, fs + 1, B), the owned
        feature slices and the summed feature-0 slice."""
        # the data axis's arguments only when the histogram is summed
        # here: a one-process tree calls build_histogram as it always has
        dist_kw = ({} if hist_axis is None else
                   {"axis_name": hist_axis, "wire_dtype": wire})
        if quantized:
            h = build_histogram(bins, qg, qh, mask_weight, zero_leaf, 1,
                                B, method=p.hist_method, count_values=qc,
                                **dist_kw)[:, 0]
        else:
            h = build_histogram(bins, grad, hess, mask_weight, zero_leaf, 1,
                                B, method=p.hist_method, **dist_kw)[:, 0]
        if rs:
            tot0 = axis.psum(h[:, 0, :], wire_dtype=wire)          # (3, B)
            owned = axis.psum_scatter(
                torch.nn.functional.pad(h, (0, 0, 0, Fp - f)), dim=1,
                wire_dtype=wire)                                   # (3, fs, B)
            h = torch.cat([owned, tot0[:, None, :]], dim=1)
        return h

    def best_split(hist, depth_ok: bool, tot=None) -> torch.Tensor:
        """Best candidate split of one leaf among this rank's feature
        rows: float64 (gain, global feature, bin, left_count,
        total_count) — every entry an exact widening of its float32 /
        int value. ``tot`` overrides the leaf totals (feature-parallel:
        global feature 0's)."""
        rows = hist[:, :-1] if rs else hist
        if tot is None:
            tot = _slot_totals(hist, tot_slot)
        if quantized:
            # exact int32 cumsums, one dequantize at gain time
            GL, HL, CL = (torch.cumsum(rows, dim=-1, dtype=torch.int32)
                          .to(torch.float32) * deltas[:, None, None])
            G, H, C = tot.to(torch.float32) * deltas
        else:
            G, H, C = tot
            GL = torch.cumsum(rows[0], dim=-1)
            HL = torch.cumsum(rows[1], dim=-1)
            CL = torch.cumsum(rows[2], dim=-1)
        GR, HR, CR = G - GL, H - HL, C - CL
        parent_score = _split_gain(G, H, l1, l2)
        gain = (_split_gain(GL, HL, l1, l2) + _split_gain(GR, HR, l1, l2)
                - parent_score)
        ok = ((CL >= min_data) & (CR >= min_data)
              & (HL >= min_hess) & (HR >= min_hess) & fm_rows[:, None])
        if not depth_ok:
            ok = torch.zeros_like(ok)
        gain = torch.where(ok, gain, neg_inf).reshape(-1)
        flat = torch.argmax(gain)
        Bh = rows.shape[-1]
        return torch.stack([gain[flat].double(),
                            (flat // Bh + f_off).double(),
                            (flat % Bh).double(),
                            CL.reshape(-1)[flat].double(), C.double()])

    def best_split_voting(hist, depth_ok: bool, hist_sub=None
                          ) -> torch.Tensor:
        """PV-tree split search: rank features by LOCAL gain, vote the
        union of every rank's top-k, sum only the candidates' slices
        (and feature 0's, whose bin sums are the leaf totals in
        data-parallel's association), then pick the global best among
        them with psum's lowest-(feature, bin) tie-break. ``hist_sub``
        is the right child of a (parent, right) pair shipped
        unsubtracted."""
        local = hist if hist_sub is None else hist - hist_sub
        if quantized:
            lcs = (torch.cumsum(local[:2], dim=-1, dtype=torch.int32)
                   .to(torch.float32) * deltas[:2, None, None])
            GLl, HLl = lcs[0], lcs[1]
            Gt, Ht = GLl[0, -1], HLl[0, -1]
        else:
            Gt, Ht, _ = _slot_totals(local, 0)
            GLl = torch.cumsum(local[0], dim=-1)
            HLl = torch.cumsum(local[1], dim=-1)
        parent_l = _split_gain(Gt, Ht, l1, l2)
        gain_l = (_split_gain(GLl, HLl, l1, l2)
                  + _split_gain(Gt - GLl, Ht - HLl, l1, l2) - parent_l)
        gain_f = torch.where(fm_ok[:, None], gain_l, neg_inf).amax(-1)
        k = min(max(p.voting_k, 1), f)
        # the k largest, ties to the lower feature (XLA's top_k order)
        topk = torch.sort(gain_f, descending=True, stable=True).indices[:k]
        cand = axis.all_gather(topk.to(torch.int32)).reshape(-1).long()
        sel = torch.cat([cand, torch.zeros(1, dtype=torch.long,
                                           device=dev)])
        if hist_sub is None:
            ps = axis.psum(hist[:, sel, :], wire_dtype=wire)
        else:
            pair = axis.psum(torch.stack([hist[:, sel, :],
                                          hist_sub[:, sel, :]]),
                             wire_dtype=wire)
            ps = pair[0] - pair[1]
        ch = ps[:, :-1, :]
        if quantized:
            G, H, C = (ps[:, -1, :].sum(-1, dtype=torch.int64)
                       .to(torch.float32) * deltas)
            GL, HL, CL = (torch.cumsum(ch, dim=-1, dtype=torch.int32)
                          .to(torch.float32) * deltas[:, None, None])
        else:
            G, H, C = _slot_totals(ps, ps.shape[1] - 1)
            GL = torch.cumsum(ch[0], dim=-1)
            HL = torch.cumsum(ch[1], dim=-1)
            CL = torch.cumsum(ch[2], dim=-1)
        GR, HR, CR = G - GL, H - HL, C - CL
        parent_score = _split_gain(G, H, l1, l2)
        gain = (_split_gain(GL, HL, l1, l2) + _split_gain(GR, HR, l1, l2)
                - parent_score)
        ok = ((CL >= min_data) & (CR >= min_data)
              & (HL >= min_hess) & (HR >= min_hess)
              & fm_ok[cand][:, None])
        if not depth_ok:
            ok = torch.zeros_like(ok)
        gain = torch.where(ok, gain, neg_inf)
        best = gain.max()
        fb_key = cand[:, None] * B + torch.arange(B, device=dev)
        keyed = torch.where(gain >= best, fb_key,
                            torch.full_like(fb_key, 2 ** 62))
        flat = torch.argmin(keyed.reshape(-1))
        ci, bb = flat // B, flat % B
        return torch.stack([gain.reshape(-1)[flat].double(),
                            cand[ci].double(), bb.double(),
                            CL[ci, bb].double(), C.double()])

    def search(hists, depth_ok: bool, subs=None) -> np.ndarray:
        """(k, 5) float64 host array: each leaf's best split (gain,
        global feature, bin, left count, total count), one device->host
        read; under reduce_scatter / feature the ranks' candidates are
        all-gathered and the first maximum over ranks wins."""
        if voting:
            return torch.stack([
                best_split_voting(h, depth_ok, None if subs is None
                                  else subs[i])
                for i, h in enumerate(hists)]).cpu().numpy()
        tots = [None] * len(hists)
        if feat_par:
            # global feature 0's totals, from its owner (rank 0)
            tot_all = axis.broadcast(torch.stack(
                [_slot_totals(h, 0) for h in hists]), src=0)
            tots = list(tot_all)
        local = torch.stack([best_split(h, depth_ok, t)
                             for h, t in zip(hists, tots)])
        if not (rs or feat_par):
            return local.cpu().numpy()
        allc = axis.all_gather(local[:, :4].float()).cpu().numpy()
        out = local.cpu().numpy()
        for c in range(len(hists)):
            win = int(np.argmax(allc[:, c, 0]))
            out[c, :4] = allc[win, c]
        return out

    def split_indicator(leaf_of_row, bl: int, bf: int, bb: int):
        """Rows of leaf ``bl`` that go RIGHT under split (bf, bb); in
        feature-parallel mode only the owner holds column bf, so it
        broadcasts the bitmap (packed bits) to the other ranks."""
        if feat_par:
            owner = bf // f
            ind = (bins[bf - owner * f] > bb if axis.rank == owner
                   else torch.zeros(n, dtype=torch.bool, device=dev))
            ind = unpack_bits(axis.broadcast(pack_bits(ind), src=owner), n)
            return (leaf_of_row == bl) & ind
        return (leaf_of_row == bl) & (bins[bf] > bb)

    # root: slot 0 holds all rows (its children sit at depth 1, legal for
    # any max_depth >= 1, so the root's candidate is never depth-blocked)
    root_hist = leaf_hist(torch.ones(n, dtype=sdt, device=dev)
                          if quantized else weight)
    hist_cache = torch.zeros((L,) + tuple(root_hist.shape),
                             dtype=root_hist.dtype, device=dev)
    hist_cache[0] = root_hist
    g0, f0, b0, cl0, c0 = search([root_hist], True)[0]

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
        goes_right = split_indicator(leaf_of_row, bl, bf, bb)
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
        if voting:
            # ship the (parent, right) pair unsubtracted: the sum then the
            # subtraction, data-parallel's order
            res = search([hist_cache[bl], hist_r], depth_ok,
                         subs=[hist_r, None])
        else:
            res = search([hist_l, hist_r], depth_ok)
        (gl, fl, bl_bin, cll, cl_tot), (gr, fr, br_bin, clr, cr_tot) = res

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

    # per-leaf grad/hess sums straight from the cached histograms: feature
    # 0's bin sums ARE the leaf totals (under reduce_scatter the summed
    # feature-0 slice; voting sums its local ones over the ranks; feature
    # takes rank 0's, the owner of global feature 0)
    gh_leaf = _leaf_sums(hist_cache, tot_slot)
    if voting:
        gh_leaf = axis.psum(gh_leaf.to(torch.int32) if quantized
                            else gh_leaf)
    elif feat_par:
        gh_leaf = axis.broadcast(gh_leaf, src=0)
    g_leaf, h_leaf = gh_leaf[0], gh_leaf[1]
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
