"""Booster: GBDT training driver + serialized model.

Port of ``mmlspark_tpu/gbdt/booster.py`` for dense, single-device,
float32-histogram training: the dataset is binned once (on the device
when the cuts are float32-exact, on the host otherwise), kept on the
device as a features-major (F, N) int32 matrix, and every boosting
iteration is one Python step — gradients -> K trees -> score update.
The JAX engine fuses iterations into ``lax.scan`` chunks; the chunking
does not change its results, so it is not reproduced (``boost_chunk`` is
accepted and has no effect).

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

from mmlspark_tpu_torch.device import DeviceLike, resolve_device
from mmlspark_tpu_torch.gbdt.binning import BinMapper, bucketize_fm_device
from mmlspark_tpu_torch.gbdt.objectives import Objective, get_objective
from mmlspark_tpu_torch.gbdt.tree import GrowParams, Tree, grow_tree, \
    predict_trees

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
        self.bin_mapper: Optional[BinMapper] = None

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
        """Raw margin scores, shape (N,) or (K, N) for multiclass."""
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


def _validate_params(p: Dict[str, Any], X, valid, init_model, mesh) -> None:
    """Fail fast on everything outside this slice of the port."""
    hist_bits = int(p["hist_bits"])
    if hist_bits not in (32, 16, 8):
        raise ValueError(
            f"hist_bits={p['hist_bits']} is not supported: use 32 "
            "(f32), 16 or 8 (quantized histograms)")
    if hist_bits < 32:
        raise _not_ported(f"hist_bits={hist_bits}",
                          "Quantized hist_bits=16/8 training")
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
    if float(p["bagging_fraction"]) < 1.0 and int(p["bagging_freq"]) > 0:
        raise _not_ported("bagging (bagging_fraction < 1)",
                          "Bagging and feature fraction")
    if float(p["feature_fraction"]) < 1.0:
        raise _not_ported("feature_fraction < 1",
                          "Bagging and feature fraction")
    if init_model is not None:
        raise _not_ported("init_model warm start",
                          "GBDT warm start, validation and early stopping")
    if valid is not None or int(p["early_stopping_round"]) > 0:
        raise _not_ported("validation data / early stopping",
                          "GBDT warm start, validation and early stopping")
    if p.get("keep_training_data"):
        raise _not_ported("keep_training_data / boost_more",
                          "GBDT warm start, validation and early stopping")
    if p["bin_fit"] == "sketch":
        raise _not_ported("bin_fit='sketch'", "GBDT ingest beyond dense input")
    if not isinstance(X, np.ndarray):
        raise _not_ported(f"{type(X).__name__} input (CSR, ChunkedTable or "
                          "streamed shards)", "GBDT ingest beyond dense input")
    if p["device_binning"] not in ("auto", "on", "off"):
        raise ValueError(f"device_binning={p['device_binning']!r}; expected "
                         "'auto', 'on' or 'off'")


def train(params: Dict[str, Any], X: np.ndarray, y: np.ndarray,
          sample_weight: Optional[np.ndarray] = None,
          valid: Optional[Tuple[np.ndarray, np.ndarray]] = None,
          feature_names: Optional[List[str]] = None,
          mesh=None, init_model=None,
          bin_mapper: Optional[BinMapper] = None,
          device: DeviceLike = None) -> Booster:
    """Train a Booster on a dense (N, F) matrix ``X`` with labels ``y``,
    on ``device`` (default the card; ``'cpu'`` must be asked for).

    ``bin_mapper`` overrides the bin-boundary fit with a frozen mapper.
    The returned Booster carries ``train_timing`` (per-phase wall
    seconds: bin, ship, boost, fetch) and ``train_info`` (bin_path,
    histograms built)."""
    dev = resolve_device(device)
    phases: Dict[str, float] = {}
    t_phase = time.perf_counter()

    def mark(name: str) -> None:
        nonlocal t_phase
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        phases[name] = round(now - t_phase, 3)
        t_phase = now

    p = dict(DEFAULTS)
    p.update(params or {})
    p["hist_method"] = resolve_hist_method(p["hist_method"], dev,
                                           int(p["max_bin"]))
    if isinstance(X, (list, tuple)) and y is not None:
        X = np.asarray(X, dtype=np.float64)   # dense rows as lists
    _validate_params(p, X, valid, init_model, mesh)
    if y is None:
        raise ValueError("y is required when X is a dense matrix")

    objective = get_objective(
        p["objective"], num_class=p["num_class"], alpha=p["alpha"],
        tweedie_variance_power=p["tweedie_variance_power"])
    K = objective.num_class

    # 1) bin once: float32 input stays float32 (binning widens per
    # compare, exact)
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    y = np.asarray(y, dtype=np.float64)
    n, f = X.shape
    w_base = (np.ones(n) if sample_weight is None
              else np.asarray(sample_weight, dtype=np.float64))
    if feature_names is None:
        feature_names = [f"Column_{i}" for i in range(f)]
    mapper = bin_mapper or BinMapper.fit(X, max_bin=p["max_bin"],
                                         seed=p["seed"])
    if len(mapper.num_bins) != f:
        raise ValueError(f"bin_mapper covers {len(mapper.num_bins)} "
                         f"features, X has {f}")
    num_bins = int(mapper.num_bins.max())
    p["f32_unsafe"] = not mapper.f32_values_safe
    # on-device binning when f32 compares provably equal f64 ones
    # (f32-snapped cuts); host binning otherwise
    use_device_bin = (p["device_binning"] != "off" and mapper.f32_cuts_exact)
    if p["device_binning"] == "on" and not use_device_bin:
        _log.warning("device_binning='on' requested but the cuts are not "
                     "f32-exact (pass float32 features); binning on host")
    mark("bin")
    if use_device_bin:
        raw = torch.from_numpy(np.ascontiguousarray(
            X.T, dtype=np.float32)).to(dev)
        bounds = torch.from_numpy(mapper.bounds_matrix(np.float32)).to(dev)
        bins_d = bucketize_fm_device(raw, bounds)
        del raw
    else:
        bins_d = torch.from_numpy(mapper.transform_fm(X)).to(dev)
    init_score = (objective.init_score(y, w_base) if p["boost_from_average"]
                  else np.zeros(K))
    scores = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        np.asarray(init_score, np.float32)[:, None], (K, n)))).to(dev)
    y_d = torch.from_numpy(y.astype(np.float32)).to(dev)
    w_d = torch.from_numpy(w_base.astype(np.float32)).to(dev)
    fmask = torch.ones(f, dtype=torch.float32, device=dev)
    mark("ship")

    gp = GrowParams(
        num_leaves=int(p["num_leaves"]), num_bins=num_bins,
        min_data_in_leaf=int(p["min_data_in_leaf"]),
        min_sum_hessian_in_leaf=float(p["min_sum_hessian_in_leaf"]),
        max_depth=int(p["max_depth"]),
        lambda_l1=float(p["lambda_l1"]), lambda_l2=float(p["lambda_l2"]),
        min_gain_to_split=float(p["min_gain_to_split"]),
        hist_method=p["hist_method"])
    lr = float(p["learning_rate"])

    trees: List[Tree] = []
    histograms = 0
    for _ in range(int(p["num_iterations"])):
        grad, hess = objective.grad_hess(scores[0] if K == 1 else scores,
                                         y_d)
        if K == 1:
            grad, hess = grad[None, :], hess[None, :]
        for k in range(K):
            tree, leaf_of_row, leaf_vals, n_leaves = grow_tree(
                bins_d, grad[k].contiguous(), hess[k].contiguous(), w_d,
                fmask, gp)
            scores[k] += lr * leaf_vals[leaf_of_row.long()]
            trees.append(tree)
            histograms += n_leaves
    mark("boost")

    if trees:
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
    else:
        stacked, tree_depths = {}, []
    booster = Booster(objective, stacked, init_score, K, feature_names, p,
                      best_iteration=-1, tree_depths=tree_depths,
                      device=dev)
    mark("fetch")
    booster.train_timing = phases
    booster.train_info = {"bin_path": "device" if use_device_bin else "host",
                          "histograms": histograms}
    booster.bin_mapper = mapper
    return booster


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
