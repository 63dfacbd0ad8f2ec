"""Booster: GBDT training driver + serialized model.

Port of ``mmlspark_tpu/gbdt/booster.py`` for single-device training:
the dataset is binned once and kept on the device as a features-major
(F, N) int32 matrix, and every boosting iteration is one Python step —
sampling masks -> gradients -> K trees -> score update. Dense input bins
on the device when the cuts are float32-exact, on the host otherwise;
CSR input (``core.sparse.CSRMatrix``) bins on the host from its
nonzeros; a ``ChunkedTable`` or a stream of ``(X, y[, w])`` shards bins
shard by shard on the host, its cuts from a reservoir sample
(``bin_fit='sample'``) or a one-pass quantile sketch (``'sketch'``). A
host-binned matrix crosses to the card as uint8 when every feature has
at most 256 bins and widens there.
Bagging, feature fraction, quantized ``hist_bits`` 16 / 8, validation
with early stopping, warm start (``init_model``) and ``boost_more`` are
the JAX package's, bit for bit on the same device. The JAX engine fuses
iterations into ``lax.scan`` chunks; the chunking changes none of its
trees, so it is not reproduced, except where early stopping reads the
losses at the chunk boundaries (``boost_chunk`` sets that cadence).

The model string is the JAX package's ``"mmlspark_tpu.booster.v1"``
JSON, so each package loads the other's forests.

Options outside this slice raise ``NotImplementedError`` naming the
ROADMAP.md item that will port them; none of them silently runs
something else.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.core.sparse import CSRMatrix
from mmlspark_tpu_torch.device import DeviceLike, resolve_device
from mmlspark_tpu_torch.gbdt.binning import BinMapper, bucketize_fm_device
from mmlspark_tpu_torch.gbdt import prng
from mmlspark_tpu_torch.gbdt.objectives import Objective, get_objective
from mmlspark_tpu_torch.gbdt.tree import GrowParams, Tree, grow_tree, \
    predict_trees, sample_iteration_masks

_log = logging.getLogger("mmlspark_tpu_torch.gbdt")

DEFAULTS: Dict[str, Any] = {
    # the JAX package's names and defaults (TrainParams analog)
    "objective": "regression",
    "num_iterations": 100,
    "learning_rate": 0.1,
    "num_leaves": 31,
    "max_bin": 255,
    "max_depth": 0,
    "min_data_in_leaf": 20,
    "min_sum_hessian_in_leaf": 1e-3,
    "lambda_l1": 0.0,
    "lambda_l2": 0.0,
    "min_gain_to_split": 0.0,
    "feature_fraction": 1.0,
    "bagging_fraction": 1.0,
    "bagging_freq": 0,
    "num_class": 1,
    "boost_from_average": True,
    "early_stopping_round": 0,
    "seed": 0,
    "alpha": 0.9,                      # quantile / huber
    "tweedie_variance_power": 1.5,
    # 'auto' | 'scatter' | 'onehot' | 'pallas' ('pallas' = the
    # hand-written device kernel in the port)
    "hist_method": "auto",
    "hist_bits": 32,
    "hist_comm": "auto",
    "parallelism": "serial",
    "top_k": 20,
    "boost_chunk": 0,
    "device_binning": "auto",
    "bin_fit": "sample",
    "keep_training_data": False,
}

_TREE_DTYPES = {"feature": np.int32, "threshold": np.float64,
                "left": np.int32, "right": np.int32, "value": np.float32,
                "is_leaf": bool, "gain": np.float32, "count": np.float32,
                "bin_threshold": np.int32}


class Booster:
    """A trained forest, serializable to a model string. Scores on
    ``device`` (default the card; ``'cpu'`` must be asked for)."""

    def __init__(self, objective: Objective, trees: Dict[str, np.ndarray],
                 init_score: np.ndarray, num_class: int,
                 feature_names: List[str], params: Dict[str, Any],
                 best_iteration: int = -1,
                 tree_depths: Optional[List[int]] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.objective = objective
        # stacked (T, M) arrays: feature/bin_threshold/threshold/left/
        # right/value/is_leaf/gain/count
        self.trees = trees
        self.init_score = np.asarray(init_score, dtype=np.float64)
        self.num_class = int(num_class)
        self.feature_names = list(feature_names)
        self.params = dict(params)
        self.best_iteration = int(best_iteration)
        self.tree_depths = list(tree_depths or [])
        self._f64_flag: Optional[bool] = None
        self._dev_forest: Optional[Tuple[int, Dict[str, torch.Tensor]]] = None
        self.train_timing: Dict[str, float] = {}
        self.train_info: Dict[str, Any] = {}
        # in memory only (a Booster rebuilt from a model string has
        # neither): the frozen BinMapper for boost_more on fresh data, and
        # the retained training state for boost_more(data=None)
        self.bin_mapper: Optional[BinMapper] = None
        self._resume: Optional[Dict[str, Any]] = None

    # -- inference ----------------------------------------------------------

    @property
    def num_trees(self) -> int:
        return 0 if not self.trees else int(self.trees["feature"].shape[0])

    def _max_depth(self, t_limit: int) -> int:
        depths = self.tree_depths[:t_limit] or [
            self.params.get("num_leaves", 31) - 1]
        return max(1, max(depths))

    def _needs_f64_inference(self) -> bool:
        """True when the f32 walk could misroute rows: the fit-time flag
        ('f32_unsafe' in params), else thresholds beyond f32's 24-bit
        integer range or per-feature threshold spacing below the f32
        rounding band. Such forests score on the host in float64."""
        if self._f64_flag is None:
            self._f64_flag = self._compute_f64_flag()
        return self._f64_flag

    def _compute_f64_flag(self) -> bool:
        if "f32_unsafe" in self.params:
            return bool(self.params["f32_unsafe"])
        if not self.trees:
            return False
        internal = ~self.trees["is_leaf"].astype(bool)
        thr = self.trees["threshold"][internal]
        feats = self.trees["feature"][internal]
        keep = np.isfinite(thr)
        thr, feats = thr[keep], feats[keep]
        if not len(thr):
            return False
        if np.abs(thr).max() >= 2.0 ** 24:
            return True
        eps32 = float(np.finfo(np.float32).eps)
        for fid in np.unique(feats):
            t = np.unique(thr[feats == fid])
            if len(t) < 2:
                continue
            gaps = np.diff(t)
            band = 8.0 * eps32 * np.maximum(np.abs(t[:-1]), np.abs(t[1:]))
            if (gaps <= band).any():
                return True
        return False

    def raw_score(self, X: np.ndarray,
                  num_iteration: Optional[int] = None) -> np.ndarray:
        """Raw margin scores, shape (N,) or (K, N) for multiclass. A
        ``CSRMatrix`` scores through chunked densification (at most 8192
        rows, or a 256 MB dense budget, at a time), each chunk walked as
        dense rows are, so the result is bitwise the dense one."""
        if isinstance(X, CSRMatrix):
            if X.shape[0] == 0:
                return self.raw_score(
                    np.zeros((0, len(self.feature_names))), num_iteration)
            step = max(1, min(8192, (256 << 20) // (4 * X.shape[1])))
            outs = [self.raw_score(X[lo:min(lo + step, X.shape[0])]
                                   .toarray(), num_iteration)
                    for lo in range(0, X.shape[0], step)]
            return np.concatenate(outs, axis=-1)
        X = np.asarray(X)
        n = X.shape[0]
        K = self.num_class
        it = self._resolve_iterations(num_iteration)
        t_limit = it * K
        scores = np.broadcast_to(
            self.init_score[:, None].astype(np.float32), (K, n)).copy()
        if t_limit > 0 and self.num_trees > 0:
            if self._needs_f64_inference():
                out = _host_predict_trees(
                    np.asarray(X, dtype=np.float64),
                    {k: v[:t_limit] for k, v in self.trees.items()},
                    self._max_depth(t_limit))
            else:
                dev = self._device_trees(t_limit)
                Xd = torch.from_numpy(np.ascontiguousarray(
                    X, dtype=np.float32)).to(self.device)
                out = predict_trees(
                    Xd, dev["feature"], dev["threshold"], dev["left"],
                    dev["right"], dev["value"],
                    max_depth=self._max_depth(t_limit)).cpu().numpy()
            scores += out.reshape(it, K, n).sum(axis=0)
        return scores[0] if K == 1 else scores

    def _device_trees(self, t_limit: int) -> Dict[str, torch.Tensor]:
        """Device-resident stacked tree arrays for the f32 walk, cached
        per ``t_limit`` (thresholds cast to float32 here, as the JAX walk
        receives them)."""
        cached = self._dev_forest
        if cached is None or cached[0] != t_limit:
            arrs = {k: torch.from_numpy(np.ascontiguousarray(
                        self.trees[k][:t_limit],
                        dtype=np.float32 if k == "threshold" else None))
                    .to(self.device)
                    for k in ("feature", "threshold", "left", "right",
                              "value")}
            cached = (int(t_limit), arrs)
            self._dev_forest = cached
        return cached[1]

    def predict(self, X: np.ndarray,
                num_iteration: Optional[int] = None) -> np.ndarray:
        """Transformed prediction (probability / mean). Multiclass returns
        (N, K) probabilities."""
        raw = self.raw_score(X, num_iteration)
        out = self.objective.transform(torch.from_numpy(raw)).numpy()
        return out.T if self.num_class > 1 else out

    def _resolve_iterations(self, num_iteration: Optional[int]) -> int:
        total = self.num_trees // max(self.num_class, 1)
        if num_iteration is not None and num_iteration > 0:
            return min(num_iteration, total)
        if self.best_iteration > 0:
            return min(self.best_iteration, total)
        return total

    # -- introspection ------------------------------------------------------

    def feature_importance(self, importance_type: str = "split") -> np.ndarray:
        """Per-feature split counts or total gain."""
        out = np.zeros(len(self.feature_names))
        if self.num_trees == 0:
            return out
        internal = ~self.trees["is_leaf"].astype(bool)
        feats = self.trees["feature"][internal]
        if importance_type == "split":
            np.add.at(out, feats, 1.0)
        elif importance_type == "gain":
            np.add.at(out, feats, self.trees["gain"][internal])
        else:
            raise ValueError(f"importance_type {importance_type!r}")
        return out

    # -- incremental refresh (continued boosting) ---------------------------

    def boost_more(self, num_iterations: int, X=None,
                   y: Optional[np.ndarray] = None,
                   sample_weight: Optional[np.ndarray] = None,
                   valid: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                   mesh=None) -> "Booster":
        """Append ``num_iterations`` boosting rounds and return the grown
        forest as a NEW Booster.

        - ``X is None``: exact continuation on the retained training state
          (``train(..., {'keep_training_data': True})``): the device
          state picks up where train() stopped, so the result is bitwise
          the forest of one run of ``it + num_iterations`` rounds. The
          state is single-use: it moves to the returned booster, and a
          second call on this one raises.
        - ``X, y`` given: boosting goes on over FRESH data binned with the
          frozen ``bin_mapper`` (the base forest's bin space), warm-started
          from this forest (``train(..., init_model=self)``); its sampling
          masks start again at iteration 0, as the JAX package's code
          does."""
        if num_iterations <= 0:
            raise ValueError(
                f"num_iterations must be positive: {num_iterations}")
        if X is None:
            if y is not None or sample_weight is not None \
                    or valid is not None:
                raise ValueError(
                    "boost_more(data=None) continues on the retained "
                    "training state; y/sample_weight/valid only apply "
                    "with fresh X")
            return self._boost_more_retained(int(num_iterations))
        if self.bin_mapper is None:
            raise ValueError(
                "this Booster carries no BinMapper (rebuilt from a "
                "model string?); boost_more on fresh data needs the "
                "frozen fit-time binning — keep the trained Booster "
                "object, or refit")
        params = {k: v for k, v in self.params.items() if k in DEFAULTS}
        params["num_iterations"] = int(num_iterations)
        # the warm start cannot retain continuation state; carrying the
        # flag would only log train()'s warning on every refresh
        params.pop("keep_training_data", None)
        if valid is None:
            params["early_stopping_round"] = 0
        return train(params, X, y, sample_weight=sample_weight,
                     valid=valid, feature_names=self.feature_names,
                     mesh=mesh, init_model=self,
                     bin_mapper=self.bin_mapper, device=self.device)

    def _boost_more_retained(self, extra: int) -> "Booster":
        st = self._resume
        if st is None:
            raise ValueError(
                "no retained training state: pass "
                "{'keep_training_data': True} to train() (single-host, "
                "no init_model, no early stopping) to enable "
                "boost_more(data=None)")
        if st["consumed"]:
            raise ValueError(
                "retained training state already consumed: the run's "
                "scores moved on in place, so continuation chains "
                "through the NEWEST booster returned by boost_more")
        t_start = time.perf_counter()
        run: _BoostRun = st["run"]
        it0 = st["it_done"]
        total = it0 + extra
        # consumed before the first step: the run's scores move on in place
        st["consumed"] = True
        hists0 = run.histograms
        for it in range(it0, total):
            run.step(it)
        stacked, tree_depths = _stack_forest(run.trees, st["mapper"],
                                             st["num_bins"], run.lr)
        p2 = dict(self.params)
        p2["num_iterations"] = total
        booster = Booster(self.objective, stacked, st["init_score"],
                          self.num_class, st["feature_names"], p2,
                          best_iteration=-1, tree_depths=tree_depths,
                          device=self.device)
        booster.bin_mapper = st["mapper"]
        booster._resume = {**st, "it_done": total, "consumed": False}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        booster.train_timing = {
            "boost": round(time.perf_counter() - t_start, 3)}
        booster.train_info = {"bin_path": "retained",
                              "histograms": run.histograms - hists0}
        return booster

    # -- serialization ------------------------------------------------------

    def model_to_string(self) -> str:
        d = {
            "format": "mmlspark_tpu.booster.v1",
            "objective": self.objective.name,
            "objective_config": {
                "num_class": self.num_class,
                "alpha": getattr(self.objective, "alpha", None),
                "rho": getattr(self.objective, "rho", None),
            },
            "num_class": self.num_class,
            "init_score": self.init_score.tolist(),
            "feature_names": self.feature_names,
            "best_iteration": self.best_iteration,
            "tree_depths": self.tree_depths,
            "params": {k: v for k, v in self.params.items()
                       if isinstance(v, (int, float, str, bool))},
            "trees": {k: v.tolist() for k, v in self.trees.items()},
        }
        return json.dumps(d)

    @staticmethod
    def from_string(s: str, device: DeviceLike = None) -> "Booster":
        d = json.loads(s)
        cfg = d.get("objective_config", {})
        alpha = cfg.get("alpha")
        rho = cfg.get("rho")
        obj = get_objective(
            d["objective"], num_class=d["num_class"],
            alpha=0.9 if alpha is None else alpha,
            tweedie_variance_power=1.5 if rho is None else rho)
        trees = {k: np.asarray(v, dtype=_TREE_DTYPES.get(k, np.float32))
                 for k, v in d["trees"].items()}
        return Booster(obj, trees, np.asarray(d["init_score"]),
                       d["num_class"], d["feature_names"], d["params"],
                       d.get("best_iteration", -1), d.get("tree_depths"),
                       device=device)

    def save_native_model(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.model_to_string())

    @staticmethod
    def load_native_model(path: str, device: DeviceLike = None) -> "Booster":
        with open(path) as f:
            return Booster.from_string(f.read(), device=device)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def resolve_hist_method(hist_method: str, device: torch.device,
                        max_bin: int) -> str:
    """Resolve the ``hist_method`` knob against the device: 'auto' picks
    the hand-written kernel ('pallas') for CUDA tensors and the plain
    scatter version on the CPU. Beyond the kernel's bin range
    (max_bin + 1 > 2048) 'pallas' raises on the card, which never runs a
    plain version in the kernel's place; on the CPU it degrades to
    'onehot' with a warning, as the JAX package does."""
    if hist_method == "auto":
        hist_method = "pallas" if device.type == "cuda" else "scatter"
    if hist_method == "pallas" and max_bin + 1 > 2048:
        if device.type == "cuda":
            raise ValueError(
                f"max_bin={max_bin} exceeds the histogram kernel's bin "
                "range (max_bin + 1 <= 2048); pass hist_method='scatter' "
                "for the plain version on the card")
        _log.warning("max_bin=%d exceeds the histogram kernel's bin range; "
                     "using the onehot path", max_bin)
        hist_method = "onehot"
    return hist_method


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to mmlspark_tpu_torch yet "
        f"(ROADMAP.md, '{item}')")


def _validate_params(p: Dict[str, Any], mesh) -> None:
    """Fail fast on everything outside this slice of the port."""
    hist_bits = int(p["hist_bits"])
    if hist_bits not in (32, 16, 8):
        raise ValueError(
            f"hist_bits={p['hist_bits']} is not supported: use 32 "
            "(f32), 16 or 8 (quantized histograms)")
    if hist_bits < 32 and p["hist_method"] == "onehot":
        raise ValueError(
            f"hist_bits={hist_bits} is not supported by "
            "hist_method='onehot' (its einsum accumulates f32, so the "
            "run would silently lose the integer-exactness contract); "
            "use hist_method='scatter' (any device) or 'pallas' (the "
            "card's kernel), or hist_bits=32")
    if p["parallelism"] != "serial" or mesh is not None:
        raise _not_ported(f"parallelism={p['parallelism']!r}",
                          "Distributed GBDT")
    if p["hist_comm"] not in ("auto", "psum", "reduce_scatter"):
        raise ValueError(
            f"unknown hist_comm={p['hist_comm']!r}; expected 'auto', "
            "'psum' or 'reduce_scatter'")
    if p["hist_comm"] == "reduce_scatter":
        raise ValueError(
            "hist_comm='reduce_scatter' requires parallelism='data'")
    p["hist_comm"] = "psum"
    if p["device_binning"] not in ("auto", "on", "off"):
        raise ValueError(f"device_binning={p['device_binning']!r}; expected "
                         "'auto', 'on' or 'off'")


class _BoostRun:
    """The device state of one boosting run and its step: iteration
    ``it``'s sampling masks, gradients and K trees, and the score update.
    A Booster keeps it (``keep_training_data``) so that ``boost_more``
    steps on from where ``train`` stopped."""

    def __init__(self, objective: Objective, gp: GrowParams, lr: float,
                 bins_d: torch.Tensor, y_d: torch.Tensor,
                 w_d: torch.Tensor, fmask: torch.Tensor,
                 scores: torch.Tensor, mask_key: prng.Key, bag_cfg,
                 ff_cfg):
        self.objective, self.gp, self.lr = objective, gp, lr
        self.bins_d, self.y_d, self.w_d, self.fmask = bins_d, y_d, w_d, fmask
        self.scores = scores
        self.mask_key, self.bag_cfg, self.ff_cfg = mask_key, bag_cfg, ff_cfg
        self.trees: List[Tree] = []
        self.histograms = 0

    def step(self, it: int) -> List[Tree]:
        """Boost iteration ``it``; returns (and keeps) its K trees."""
        K = self.objective.num_class
        f = self.bins_d.shape[0]
        w, fmask = sample_iteration_masks(self.mask_key, it, self.w_d,
                                          self.fmask, self.bag_cfg,
                                          self.ff_cfg, f, f)
        scores = self.scores
        grad, hess = self.objective.grad_hess(
            scores[0] if K == 1 else scores, self.y_d)
        if K == 1:
            grad, hess = grad[None, :], hess[None, :]
        # per-round stochastic-rounding key: fold 3 (bagging folds 1,
        # feature fraction 2), then the class
        kq = (prng.fold_in(prng.fold_in(self.mask_key, it), 3)
              if self.gp.hist_bits < 32 else None)
        out = []
        for k in range(K):
            tree, leaf_of_row, leaf_vals, n_leaves = grow_tree(
                self.bins_d, grad[k].contiguous(), hess[k].contiguous(), w,
                fmask, self.gp,
                quant_key=None if kq is None else prng.fold_in(kq, k))
            scores[k] += self.lr * leaf_vals[leaf_of_row.long()]
            out.append(tree)
            self.histograms += n_leaves
        self.trees.extend(out)
        return out


class _ValidEval:
    """Validation scores for early stopping: the held-out rows in the
    training bins (float32), walked by each iteration's trees with
    ``bin_threshold`` as the split value, ``scores + lr * tree`` in
    float32, then the objective's loss (a 0-d tensor on the device)."""

    def __init__(self, objective: Objective, lr: float, bins_v, yv,
                 v_scores, depth: int, dev: torch.device):
        self.objective, self.lr, self.depth = objective, lr, depth
        self.bins_v = torch.from_numpy(bins_v).to(dev)
        self.yv = torch.from_numpy(yv).to(dev)
        self.scores = torch.from_numpy(np.ascontiguousarray(
            v_scores, dtype=np.float32)).to(dev)

    def add(self, trees: List[Tree]) -> torch.Tensor:
        dev = self.bins_v.device

        def stack(name, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(np.stack(
                [getattr(t, name) for t in trees]), dtype=dtype)).to(dev)
        tv = predict_trees(self.bins_v, stack("feature"),
                           stack("bin_threshold", np.float32),
                           stack("left"), stack("right"), stack("value"),
                           max_depth=self.depth)             # (K, Nv)
        self.scores = self.scores + self.lr * tv
        K = self.scores.shape[0]
        return self.objective.loss(self.scores[0] if K == 1 else self.scores,
                                   self.yv)


def _stack_forest(trees: List[Tree], mapper: BinMapper, num_bins: int,
                  lr: float) -> Tuple[Dict[str, np.ndarray], List[int]]:
    """Host (T, M) tree arrays with raw-value thresholds (float64) and
    the shrinkage baked into the values, and each tree's depth."""
    if not trees:
        return {}, []
    stacked = {name: np.stack([getattr(t, name) for t in trees])
               for name in Tree._fields}
    # bin threshold -> raw value threshold, one vectorized gather,
    # stored in float64 (the f32 walk casts down itself)
    thr = mapper.threshold_matrix(num_bins)[stacked["feature"],
                                            stacked["bin_threshold"]]
    stacked["threshold"] = np.where(stacked["is_leaf"], 0.0, thr)
    stacked["value"] = stacked["value"] * lr  # bake shrinkage
    tree_depths = [_tree_depth({k: v[t] for k, v in stacked.items()})
                   for t in range(len(trees))]
    return stacked, tree_depths


def train(params: Dict[str, Any], X, y: Optional[np.ndarray] = None,
          sample_weight: Optional[np.ndarray] = None,
          valid: Optional[Tuple[Any, np.ndarray]] = None,
          feature_names: Optional[List[str]] = None,
          mesh=None, init_model=None,
          bin_mapper: Optional[BinMapper] = None,
          device: DeviceLike = None) -> Booster:
    """Train a Booster on ``device`` (default the card; ``'cpu'`` must
    be asked for). ``X`` is a dense (N, F) matrix or a ``CSRMatrix``
    with labels ``y``; or, with ``y=None``, a ``ChunkedTable`` (features
    and label columns) or an iterable of ``(X_shard, y_shard[,
    w_shard])`` tuples, of which only the binned matrix is kept. A list,
    tuple or zero-arg factory of shards is replayed: its cuts come from
    a reservoir sample of every row (``bin_fit='sample'``) or a quantile
    sketch of every row (``'sketch'``); a one-shot iterator is binned
    with its first shard's cuts, and a drift of more than 1 % against a
    reservoir of the whole stream is logged as a warning.

    ``init_model`` (a Booster or a model string) warm-starts: boosting
    goes on from its effective forest's scores (``best_iteration`` trees
    when it stopped early) and the returned Booster carries those trees
    and the new ones. ``valid`` = (X_valid, y_valid) with
    ``early_stopping_round`` > 0 scores the held-out rows after every
    iteration; as in the JAX package the stop decision reads the losses
    every ``min(early_stopping_round, 8)`` iterations (the JAX engine's
    ``boost_chunk`` cadence, which ``boost_chunk`` sets here too), so a
    run may train a few iterations past its stop, and ``best_iteration``
    truncates scoring. ``bin_mapper`` overrides the bin-boundary fit
    with a frozen mapper. With ``keep_training_data`` (no warm start, no
    early stopping) the run's device state stays on the Booster for
    ``boost_more()``. The returned Booster carries ``train_timing``
    (per-phase wall seconds: bin (the cut fit and any host binning),
    ship (to the device, device binning), boost, fetch) and ``train_info``
    (bin_path, histograms built and, with early stopping, valid_loss:
    the validation losses the stop decision read).

    Each call leaves one ``gbdt.train`` trace in the process tracer
    (``core.trace.get_tracer()``, when enabled): the phases as spans, a
    ``boost_chunk`` span per chunk of iterations (host wall; the grower
    reads every split back, so it tracks the card), and the root
    attributes ``bin_path``, ``boost_chunks`` and ``trees``. The phases
    and chunks are observed into ``core.metrics.gbdt_train_histograms()``."""
    from mmlspark_tpu_torch.core.metrics import gbdt_train_histograms
    from mmlspark_tpu_torch.core.trace import get_tracer
    dev = resolve_device(device)
    tracer = get_tracer()
    # one trace per train(): the phase marks double as spans
    trace = tracer.new_trace("gbdt.train") if tracer.enabled else None
    phases: Dict[str, float] = {}
    phase_s: Dict[str, float] = {}
    t_phase = time.perf_counter()

    def mark(name: str) -> None:
        nonlocal t_phase
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        phases[name] = round(now - t_phase, 3)
        phase_s[name] = now - t_phase
        if trace is not None:
            tracer.emit(name, t_phase, now, trace=trace)
        t_phase = now

    p = dict(DEFAULTS)
    p.update(params or {})
    p["hist_method"] = resolve_hist_method(p["hist_method"], dev,
                                           int(p["max_bin"]))
    _validate_params(p, mesh)

    objective = get_objective(
        p["objective"], num_class=p["num_class"], alpha=p["alpha"],
        tweedie_variance_power=p["tweedie_variance_power"])
    K = objective.num_class
    # host binning on a card fit goes through the OpenMP library, which
    # raises rather than fall back (gbdt/native_bins.py)
    native = dev.type == "cuda"

    # 1) bin once. Streaming = an iterable of shards passed WITHOUT y,
    # told apart from dense list-of-lists and mislabelled iterators with
    # the JAX package's errors
    from mmlspark_tpu_torch.io.ooc import ChunkedTable
    if isinstance(X, ChunkedTable):
        # out-of-core ingest: chunks carry the features and label
        # columns; decode runs on the source's prefetch worker
        if y is not None:
            raise ValueError(
                "pass labels inside the ChunkedTable (label column), "
                "not as a separate y")
        X = X.as_xy()
    streaming = y is None and not isinstance(X, (np.ndarray, CSRMatrix))
    if streaming and isinstance(X, (list, tuple)):
        try:
            X = np.asarray(X, dtype=np.float64)   # dense rows as lists
            streaming = False
        except (TypeError, ValueError):
            pass   # a genuine list of shard tuples / DataTables
    if not streaming and y is None:
        raise ValueError("y is required when X is a dense matrix")
    if y is not None and not isinstance(X, np.ndarray) \
            and hasattr(X, "__next__"):
        raise ValueError(
            "iterator X with a separate y is ambiguous: streaming mode "
            "passes y=None and the iterator yields "
            "(X_shard, y_shard[, w_shard]) tuples")
    bins_fm: Optional[np.ndarray] = None   # host-binned (F, N), if any
    if streaming:
        if sample_weight is not None:
            raise ValueError(
                "pass per-shard weights inside the shard tuples in "
                "streaming mode")
        if init_model is not None:
            # fail fast, before consuming the (possibly huge) stream
            raise ValueError("init_model warm start requires dense X")
        mapper, bins_fm, y, w_base = _bin_stream(
            X, p["max_bin"], p["seed"], mapper=bin_mapper,
            bin_fit=p["bin_fit"], native=native)
        f, n = bins_fm.shape
    elif isinstance(X, CSRMatrix):
        # CSR ingest: bins straight from the sparse structure, no dense
        # float matrix (the LGBM_DatasetCreateFromCSR analog); the
        # device layout is still a dense (F, N) int32 matrix, so guard it
        y = np.asarray(y, dtype=np.float64)
        n, f = X.shape
        if f * n * 4 > 8 << 30:
            raise ValueError(
                f"binned matrix for CSR input would need "
                f"{f * n * 4 / 2**30:.1f} GB ({f} features x {n} "
                f"rows); reduce the feature width (hashing) first")
        mapper = bin_mapper or BinMapper.fit_sparse(
            X, max_bin=p["max_bin"], seed=p["seed"])
    else:
        # float32 input stays float32 (binning widens per compare, exact)
        X = np.asarray(X)
        if X.dtype not in (np.float32, np.float64):
            X = X.astype(np.float64)
        y = np.asarray(y, dtype=np.float64)
        n, f = X.shape
        mapper = bin_mapper or BinMapper.fit(X, max_bin=p["max_bin"],
                                             seed=p["seed"])
    if not streaming:
        w_base = (np.ones(n) if sample_weight is None
                  else np.asarray(sample_weight, dtype=np.float64))
    if feature_names is None:
        feature_names = [f"Column_{i}" for i in range(f)]
    if len(mapper.num_bins) != f:
        raise ValueError(f"bin_mapper covers {len(mapper.num_bins)} "
                         f"features, X has {f}")
    num_bins = int(mapper.num_bins.max())
    p["f32_unsafe"] = not mapper.f32_values_safe
    # on-device binning when f32 compares provably equal f64 ones
    # (f32-snapped cuts of dense input); host binning otherwise, shipped
    # as uint8 when every feature has at most 256 bins
    use_device_bin = (p["device_binning"] != "off" and not streaming
                      and isinstance(X, np.ndarray)
                      and mapper.f32_cuts_exact)
    if p["device_binning"] == "on" and not use_device_bin:
        _log.warning(
            "device_binning='on' requested but ineligible (%s); binning on "
            "host", "input is CSR / streaming" if not isinstance(
                X, np.ndarray) or streaming else
            "the cuts are not f32-exact (pass float32 features)")
    narrow = np.uint8 if num_bins <= 256 else np.int32
    if isinstance(X, CSRMatrix):
        bins_fm = mapper.transform_sparse(X, dtype=narrow)
    elif not use_device_bin and not streaming:
        bins_fm = mapper.transform_fm(X, native=native)
    mark("bin")
    if use_device_bin:
        raw = torch.from_numpy(np.ascontiguousarray(
            X.T, dtype=np.float32)).to(dev)
        bounds = torch.from_numpy(mapper.bounds_matrix(np.float32)).to(dev)
        bins_d = bucketize_fm_device(raw, bounds)
        del raw
    else:
        # the narrow matrix crosses to the device and widens there
        bins_d = torch.from_numpy(bins_fm).to(dev).to(torch.int32)
        del bins_fm

    # 2) init scores: a fresh start, or a warm start from a base forest
    base_model: Optional[Booster] = None
    if init_model is not None:
        base_model = (Booster.from_string(init_model, device=dev)
                      if isinstance(init_model, str) else init_model)
        if base_model.num_class != K:
            raise ValueError(
                f"init_model has {base_model.num_class} classes, "
                f"objective expects {K}")
        if base_model.objective.name != objective.name:
            raise ValueError(
                f"init_model was trained with objective "
                f"{base_model.objective.name!r}; resuming as "
                f"{objective.name!r} would mix link spaces")
        if len(base_model.feature_names) != f:
            raise ValueError(
                f"init_model was trained on "
                f"{len(base_model.feature_names)} features, X has {f} "
                f"(out-of-range gathers would clamp silently)")
        init_score = base_model.init_score
        p["f32_unsafe"] = bool(p["f32_unsafe"]) or bool(
            base_model.params.get("f32_unsafe", False))
        # an early-stopped base contributes only its best_iteration trees
        base_eff_trees = base_model._resolve_iterations(None) * K
        scores_np = _base_raw_kn(base_model, X, K)
    else:
        init_score = (objective.init_score(y, w_base)
                      if p["boost_from_average"] else np.zeros(K))
        scores_np = np.broadcast_to(
            np.asarray(init_score, np.float32)[:, None], (K, n))
    scores = torch.from_numpy(np.ascontiguousarray(scores_np)).to(dev)
    y_d = torch.from_numpy(y.astype(np.float32)).to(dev)
    w_d = torch.from_numpy(w_base.astype(np.float32)).to(dev)
    fmask = torch.ones(f, dtype=torch.float32, device=dev)

    # validation state: the held-out rows through the binned view, the
    # comparisons training makes
    esr = int(p["early_stopping_round"])
    use_valid = valid is not None and esr > 0
    lr = float(p["learning_rate"])
    if use_valid:
        Xv = valid[0]
        if isinstance(Xv, CSRMatrix):
            if Xv.shape[1] != f:
                raise ValueError(f"validation data has shape {Xv.shape}, "
                                 f"X has {f} features")
            bins_v = mapper.transform_sparse(Xv).T
        else:
            Xv = np.asarray(Xv, dtype=np.float64)
            if Xv.ndim != 2 or Xv.shape[1] != f:
                raise ValueError(f"validation data has shape {Xv.shape}, "
                                 f"X has {f} features")
            bins_v = mapper.transform(Xv, native=native)
        v_scores = (_base_raw_kn(base_model, Xv, K) if base_model is not None
                    else np.broadcast_to(np.asarray(
                        init_score, np.float32)[:, None], (K, len(bins_v))))
        valid_eval = _ValidEval(
            objective, lr, np.ascontiguousarray(bins_v, dtype=np.float32),
            np.asarray(valid[1], dtype=np.float32), v_scores,
            int(p["max_depth"]) if int(p["max_depth"]) > 0
            else int(p["num_leaves"]) - 1, dev)
    mark("ship")

    gp = GrowParams(
        num_leaves=int(p["num_leaves"]), num_bins=num_bins,
        min_data_in_leaf=int(p["min_data_in_leaf"]),
        min_sum_hessian_in_leaf=float(p["min_sum_hessian_in_leaf"]),
        max_depth=int(p["max_depth"]),
        lambda_l1=float(p["lambda_l1"]), lambda_l2=float(p["lambda_l2"]),
        min_gain_to_split=float(p["min_gain_to_split"]),
        hist_method=p["hist_method"], hist_bits=int(p["hist_bits"]))
    bag_active = (float(p["bagging_fraction"]) < 1.0
                  and int(p["bagging_freq"]) > 0)
    ff_active = float(p["feature_fraction"]) < 1.0
    bag_cfg = ((float(p["bagging_fraction"]), int(p["bagging_freq"]))
               if bag_active else None)
    ff_cfg = float(p["feature_fraction"]) if ff_active else None
    # the JAX package's key: the seed when any mask or the quantization
    # draws (is-None checks: ff_cfg == 0.0 still samples), else 0
    mask_key = prng.PRNGKey(
        int(p["seed"]) if (bag_cfg is not None or ff_cfg is not None
                           or gp.hist_bits < 32) else 0)
    run = _BoostRun(objective, gp, lr, bins_d, y_d, w_d, fmask, scores,
                    mask_key, bag_cfg, ff_cfg)

    # the stop decision reads the losses at the JAX engine's chunk
    # boundaries: every esr_sync = min(esr, 8) iterations and at the end
    # (its chunk length S_cfg, capped at esr_sync), so best_iteration and
    # the number of trees trained past the stop come out the same
    n_iter = int(p["num_iterations"])
    esr_sync = max(1, min(esr, 8)) if esr > 0 else 1
    S_cfg = int(p.get("boost_chunk", 0) or 0)
    if S_cfg <= 0:
        S_cfg = 8 if n_iter >= 16 else 1
    if use_valid:
        S_cfg = min(S_cfg, esr_sync)
    S_cfg = max(1, min(S_cfg, n_iter))
    best_loss, best_iter = np.inf, -1
    pending: List[Tuple[int, torch.Tensor]] = []
    read_losses: List[float] = []
    boost_chunk_hist = gbdt_train_histograms()["boost_chunk"]
    n_chunks = 0
    it0, stop = 0, False
    while it0 < n_iter and not stop:
        S = min(S_cfg, n_iter - it0)
        t_chunk = time.perf_counter()
        for it in range(it0, it0 + S):
            trees_it = run.step(it)
            if use_valid:
                pending.append((it, valid_eval.add(trees_it)))
        # host wall of the chunk; no compile-bearing first chunk here,
        # so every chunk is observed (the JAX engine skips its first)
        t_chunk_end = time.perf_counter()
        n_chunks += 1
        boost_chunk_hist.observe((t_chunk_end - t_chunk) * 1e3)
        if trace is not None:
            tracer.emit("boost_chunk", t_chunk, t_chunk_end, trace=trace,
                        attrs={"it0": int(it0), "length": int(S)})
        if use_valid and (len(pending) >= esr_sync or it0 + S >= n_iter):
            losses = torch.stack([v for _, v in pending]).cpu().numpy()
            for (it, _), cur in zip(pending, losses.tolist()):
                read_losses.append(cur)
                if cur < best_loss - 1e-12:
                    best_loss, best_iter = cur, it + 1
                elif it + 1 - best_iter >= esr:
                    stop = True
                    break
            pending.clear()
        it0 += S
    mark("boost")

    stacked, tree_depths = _stack_forest(run.trees, mapper, num_bins, lr)
    if base_model is not None and base_eff_trees > 0:
        base_trees = {key: v[:base_eff_trees]
                      for key, v in base_model.trees.items()}
        stacked = _concat_forests(base_trees, stacked)
        tree_depths = (list(base_model.tree_depths[:base_eff_trees])
                       + tree_depths)
        if best_iter > 0:
            best_iter += base_eff_trees // K
    booster = Booster(objective, stacked, init_score, K, feature_names, p,
                      best_iteration=best_iter if esr > 0 else -1,
                      tree_depths=tree_depths, device=dev)
    mark("fetch")
    booster.train_timing = phases
    booster.train_info = {"bin_path": "device" if use_device_bin else "host",
                          "histograms": run.histograms}
    if use_valid:
        # the validation losses the stop decision read, one per iteration
        booster.train_info["valid_loss"] = read_losses
    booster.bin_mapper = mapper
    if p.get("keep_training_data") and base_model is None and not use_valid:
        # continuation is bit-identical to one longer run only without a
        # warm-start base (its trees live outside the run) and without
        # early stopping (a stopped run's scores hold the overshoot)
        booster._resume = {"run": run, "it_done": it0, "mapper": mapper,
                           "num_bins": num_bins, "init_score": init_score,
                           "feature_names": feature_names,
                           "consumed": False}
    elif p.get("keep_training_data"):
        _log.warning(
            "keep_training_data requested but continuation state is "
            "only retained for single-host runs without init_model or "
            "early stopping; boost_more(data=None) will be unavailable")
    hists = gbdt_train_histograms()
    for phase_name, secs in phase_s.items():
        hists[phase_name].observe(secs * 1e3)
    if trace is not None:
        trace.root.set("bin_path", booster.train_info["bin_path"])
        trace.root.set("boost_chunks", n_chunks)
        trace.root.set("trees", len(run.trees))
        tracer.finish(trace)
    return booster


_RESERVOIR_CAP = 200_000


def _reservoir_rows(shard_iter, cap: int, seed: int) -> np.ndarray:
    """Uniform row sample of a whole shard stream in one pass and
    bounded memory: Algorithm R over row blocks (LightGBM samples the
    whole dataset for its cuts, not its head). Bitwise the JAX
    package's sample for the same stream and seed."""
    rng = np.random.default_rng(seed ^ 0x5EED)
    buf: Optional[np.ndarray] = None
    seen = 0
    for shard in shard_iter:
        Xs = np.asarray(shard[0], dtype=np.float64)
        i = 0
        if buf is None:
            take = min(cap, len(Xs))
            buf = Xs[:take].copy()
            seen = take
            i = take
        elif len(buf) < cap:
            take = min(cap - len(buf), len(Xs))
            buf = np.concatenate([buf, Xs[:take]])
            seen += take
            i = take
        rest = Xs[i:]
        if len(rest):
            t = seen + np.arange(1, len(rest) + 1)
            accept = rng.random(len(rest)) < (cap / t)
            n_acc = int(accept.sum())
            if n_acc:
                buf[rng.integers(0, cap, size=n_acc)] = rest[accept]
            seen += len(rest)
    if buf is None:
        raise ValueError("empty shard stream")
    return buf


def _bin_stream(shards, max_bin: int, seed: int,
                mapper: Optional[BinMapper] = None,
                bin_fit: str = "sample", native: bool = False):
    """Streaming ingest: ``shards`` yields (X, y[, w]) tuples, and only
    the features-major binned matrix is kept (uint8 when every feature
    has at most 256 bins, else int32), so the raw floats never sit in
    memory at once. Returns (mapper, bins (F, N), y, w).

    Replayable inputs (list / tuple or zero-arg factory) take two
    passes: cuts from a reservoir sample of every row then ``fit``
    (``bin_fit='sample'``), or from ``fit_streaming``'s sketches of
    every row (``'sketch'``); then binning. A one-shot iterator is
    binned with cuts from its first shard, while a reservoir of the
    whole stream measures the drift that cost and warns above 1 %.
    ``native``: bin through the OpenMP library (a card fit)."""
    replayable = isinstance(shards, (list, tuple)) or callable(shards)
    factory = (shards if callable(shards)
               else (lambda: iter(shards)) if replayable else None)

    forced = mapper is not None
    if forced:
        stream = factory() if replayable else shards
    elif replayable and bin_fit == "sketch":
        mapper = BinMapper.fit_streaming(
            (s[0] for s in factory()), max_bin=max_bin)
        stream = factory()
    elif replayable:
        sample = _reservoir_rows(factory(), _RESERVOIR_CAP, seed)
        mapper = BinMapper.fit(sample, max_bin=max_bin, seed=seed)
        stream = factory()
    else:
        stream = shards

    rng = np.random.default_rng(seed ^ 0x5EED)
    res_buf: Optional[np.ndarray] = None
    res_seen = 0
    first_shard_rows = 0
    bins_parts, y_parts, w_parts = [], [], []
    for shard in stream:
        Xs = np.asarray(shard[0], dtype=np.float64)
        ys = np.asarray(shard[1], dtype=np.float64)
        ws = (np.asarray(shard[2], dtype=np.float64) if len(shard) > 2
              else np.ones(len(ys)))
        if mapper is None:
            mapper = BinMapper.fit(Xs, max_bin=max_bin, seed=seed)
            first_shard_rows = len(Xs)
        if not replayable and not forced:
            # the whole stream's reservoir for the drift check (the fill /
            # top-up / replace discipline of _reservoir_rows)
            i = 0
            if res_buf is None:
                take = min(_RESERVOIR_CAP, len(Xs))
                res_buf, res_seen, i = Xs[:take].copy(), take, take
            elif len(res_buf) < _RESERVOIR_CAP:
                take = min(_RESERVOIR_CAP - len(res_buf), len(Xs))
                res_buf = np.concatenate([res_buf, Xs[:take]])
                res_seen += take
                i = take
            rest = Xs[i:]
            if len(rest):
                t = res_seen + np.arange(1, len(rest) + 1)
                accept = rng.random(len(rest)) < (_RESERVOIR_CAP / t)
                n_acc = int(accept.sum())
                if n_acc and len(res_buf) >= 1:
                    res_buf[rng.integers(0, len(res_buf), size=n_acc)] \
                        = rest[accept]
                res_seen += len(rest)
        part = mapper.transform_fm(Xs, native=native)
        if part.dtype != np.uint8 and mapper._u8_ok():
            part = part.astype(np.uint8)
        bins_parts.append(part)
        y_parts.append(ys)
        w_parts.append(ws)
    if mapper is None:
        raise ValueError("empty shard stream")
    if (not replayable and not forced and res_buf is not None
            and res_seen > first_shard_rows):
        # did the one-shot stream's first shard misrepresent the data?
        full_mapper = BinMapper.fit(res_buf, max_bin=max_bin, seed=seed)
        drift = float(np.mean(mapper.transform(res_buf, native=native)
                              != full_mapper.transform(res_buf,
                                                       native=native)))
        if drift > 0.01:
            _log.warning(
                "streaming binning drift: %.1f%% of sampled cells bin "
                "differently under first-shard vs full-stream "
                "boundaries — the shard order looks skewed/sorted. "
                "Pass a list or zero-arg factory of shards for exact "
                "two-pass quantiles.", 100 * drift)
    return (mapper, np.concatenate(bins_parts, axis=1),
            np.concatenate(y_parts), np.concatenate(w_parts))


def _host_predict_trees(X: np.ndarray, trees: Dict[str, np.ndarray],
                        max_depth: int) -> np.ndarray:
    """float64 numpy tree walk — same semantics as predict_trees (leaves
    self-loop, NaN goes left) without the f32 cast. (T, N)."""
    t_count, n = trees["feature"].shape[0], X.shape[0]
    out = np.empty((t_count, n), np.float32)
    rows = np.arange(n)
    for t in range(t_count):
        feat, thr = trees["feature"][t], trees["threshold"][t]
        left, right = trees["left"][t], trees["right"][t]
        node = np.zeros(n, np.int64)
        for _ in range(max_depth):
            fv = X[rows, feat[node]]
            go_left = ~(fv > thr[node])        # NaN -> left, like binning
            node = np.where(go_left, left[node], right[node])
        out[t] = trees["value"][t][node]
    return out


def _base_raw_kn(base_model: Booster, X: np.ndarray, K: int) -> np.ndarray:
    """Base-forest raw margins as (K, N) float32 (warm-start init)."""
    raw = base_model.raw_score(X)
    if K == 1:
        raw = raw[None, :]
    return np.asarray(raw, dtype=np.float32)


def _pad_nodes(v: np.ndarray, m: int, key: str) -> np.ndarray:
    """Grow a (T, M) tree-array's node dim with inert self-loop leaves."""
    t, cur = v.shape
    if cur == m:
        return v
    pad = m - cur
    if key in ("left", "right"):
        idx = np.broadcast_to(np.arange(cur, m), (t, pad))
        return np.concatenate([v, idx.astype(v.dtype)], axis=1)
    if key == "is_leaf":
        return np.concatenate([v, np.ones((t, pad), v.dtype)], axis=1)
    return np.concatenate([v, np.zeros((t, pad), v.dtype)], axis=1)


def _concat_forests(a: Dict[str, np.ndarray],
                    b: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Stack two stacked-tree dicts along T, padding node dims to match
    (warm start may use a different num_leaves than the base model)."""
    if not a:
        return b
    if not b:
        return a
    m = max(a["feature"].shape[1], b["feature"].shape[1])
    return {key: np.concatenate(
        [_pad_nodes(a[key], m, key), _pad_nodes(b[key], m, key)], axis=0)
        for key in b}


def _tree_depth(tree_host: Dict[str, np.ndarray]) -> int:
    """Max root->leaf depth (host-side walk over the flat arrays)."""
    left, right = tree_host["left"], tree_host["right"]
    is_leaf = tree_host["is_leaf"].astype(bool)
    depth = 0
    frontier = [(0, 0)]
    while frontier:
        node, d = frontier.pop()
        if is_leaf[node] or left[node] == node:
            depth = max(depth, d)
            continue
        frontier.append((int(left[node]), d + 1))
        frontier.append((int(right[node]), d + 1))
    return max(depth, 1)
