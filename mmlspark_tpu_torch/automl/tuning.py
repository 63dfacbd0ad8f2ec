"""Hyperparameter search + model selection: the PyTorch port of
``mmlspark_tpu/automl/tuning.py``.

Analog of tune-hyperparameters / find-best-model
(ref: src/tune-hyperparameters/.../TuneHyperparameters.scala:33-188,
ParamSpace.scala:11-40, HyperparamBuilder.scala:11-98,
src/find-best-model/.../FindBestModel.scala:50,
EvaluationUtils.scala:13): randomized/grid search over typed param
spaces with k-fold CV, candidates evaluated in parallel (thread pool —
the reference uses scala Futures; each fit releases the GIL into its
device work),
and FindBestModel evaluating fitted models on a validation table.

The CV sweep is fold-cached and device-batched: the k (train, val)
fold pairs are assembled ONCE and shared by every candidate (the old
path rebuilt the train table with DataTable.concat inside every
candidate x fold evaluation — k x C full-dataset copies), each fold's
dense (N, D) feature matrix is extracted once, and when every candidate
is the same linear-model family on one device with numeric-only
hyperparameter deltas, each fold fits the whole group at once: the
candidates share the fold's matrix and take a leading candidate axis
(``models/linear._fit_logistic_batch`` / ``_fit_linear_batch``), one
call per (fold, maxIter group) — a handful of dispatches instead of
C x k serial fits. A serial fit is the same function at one candidate.
The serial thread-pool path stays as the general fallback (any
estimator, sparse features, structural params); its GBDT candidates
fit on the card side by side. The ``tune_fold_build`` /
``tune_trials`` / ``tune_refit`` histograms are observed, and a fit
leaves one ``automl.tune`` trace (the JAX package's spans of those
names under it, ``path`` on the root) in the process tracer.
"""

from __future__ import annotations

import itertools
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from mmlspark_tpu_torch.automl.statistics import ComputeModelStatistics
from mmlspark_tpu_torch.core import metrics as MC
from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.core.params import (
    EnumParam, IntParam, ListParam, StageParam, StringParam,
)
from mmlspark_tpu_torch.core.stage import Estimator, Model
from mmlspark_tpu_torch.core.table import DataTable

_LOG = get_logger("automl.tuning")

# metric -> larger-is-better? (ref: EvaluationUtils.getMetricWithOperator)
_METRIC_ASCENDING = {
    MC.MSE: False, MC.RMSE: False, MC.MAE: False, MC.R2: True,
    MC.AUC: True, MC.ACCURACY: True, MC.PRECISION: True, MC.RECALL: True,
}


class Dist:
    """A sampling distribution for one hyperparameter
    (ref: ParamSpace.scala:34 Dist)."""

    def sample(self, rng: np.random.Generator) -> Any:
        raise NotImplementedError

    def grid(self) -> List[Any]:
        raise NotImplementedError


class DiscreteHyperParam(Dist):
    """ref: HyperparamBuilder.scala DiscreteHyperParam."""

    def __init__(self, values: Sequence[Any]):
        self.values = list(values)

    def sample(self, rng):
        return self.values[int(rng.integers(0, len(self.values)))]

    def grid(self):
        return list(self.values)


class RangeHyperParam(Dist):
    """Uniform numeric range; int if both ends are ints
    (ref: HyperparamBuilder.scala:40-98 typed RangeHyperParams)."""

    def __init__(self, low, high, n_grid: int = 5, log: bool = False):
        self.low, self.high = low, high
        self.is_int = isinstance(low, int) and isinstance(high, int)
        self.n_grid = n_grid
        self.log = log

    def sample(self, rng):
        if self.log:
            v = float(np.exp(rng.uniform(np.log(self.low),
                                         np.log(self.high))))
        else:
            v = float(rng.uniform(self.low, self.high))
        return int(round(v)) if self.is_int else v

    def grid(self):
        if self.log:
            vals = np.exp(np.linspace(np.log(self.low), np.log(self.high),
                                      self.n_grid))
        else:
            vals = np.linspace(self.low, self.high, self.n_grid)
        return [int(round(v)) if self.is_int else float(v) for v in vals]


class HyperparamBuilder:
    """Collects (param-name -> Dist) pairs (ref:
    HyperparamBuilder.scala:11)."""

    def __init__(self):
        self._space: Dict[str, Dist] = {}

    def add_hyperparam(self, name: str, dist: Dist) -> "HyperparamBuilder":
        self._space[name] = dist
        return self

    def build(self) -> Dict[str, Dist]:
        return dict(self._space)


class GridSpace:
    """Exhaustive cartesian grid (ref: ParamSpace.scala:11)."""

    def __init__(self, space: Dict[str, Dist]):
        self.space = space

    def param_maps(self) -> Iterator[Dict[str, Any]]:
        names = list(self.space)
        for combo in itertools.product(
                *(self.space[n].grid() for n in names)):
            yield dict(zip(names, combo))


class RandomSpace:
    """Random sampling (ref: ParamSpace.scala:25)."""

    def __init__(self, space: Dict[str, Dist], seed: int = 0):
        self.space = space
        self.seed = seed

    def param_maps(self) -> Iterator[Dict[str, Any]]:
        rng = np.random.default_rng(self.seed)
        while True:
            yield {n: d.sample(rng) for n, d in self.space.items()}


def _evaluate_scored(scored: DataTable, metric: str) -> float:
    mode = ("regression" if metric in MC.REGRESSION_METRICS
            else "classification" if metric in MC.CLASSIFICATION_METRICS
            else "auto")
    stats = ComputeModelStatistics(evaluationMetric=mode).transform(scored)
    row = stats.row(0)
    if metric not in row:
        raise KeyError(f"metric {metric!r} not computed; have {list(row)}")
    return float(row[metric])


def _evaluate(model: Model, table: DataTable, metric: str) -> float:
    return _evaluate_scored(model.transform(table), metric)


# ---------------------------------------------------------------------------
# device-batched trials
# ---------------------------------------------------------------------------

# the only hyperparameters the batched trial path may sweep: stepSize
# and regParam are per-candidate (C, 1, 1) tensors, maxIter is the loop
# bound (candidates group by it — one dispatch per distinct value per
# fold)
_SWEEPABLE = {"stepSize", "regParam", "maxIter"}


def _batched_trials(candidates: List[Tuple[Estimator, Dict[str, Any]]],
                    fold_pairs: List[Tuple[DataTable, DataTable]],
                    metric: str, info: Dict[str, Any]
                    ) -> Optional[List[float]]:
    """The device-batched CV sweep. Returns per-candidate mean scores
    ordered like ``candidates``, or None when the sweep cannot be
    batched (mixed estimator families or devices, structural params,
    sparse features) — the caller then runs the serial thread-pool path.

    Per fold: ONE feature-matrix extraction + standardization shared by
    all C candidates and uploaded once, then one batched fit per
    distinct maxIter group fitting every candidate in that group at
    once (``info["path"]`` keeps the JAX package's name, ``"vmap"``).
    Candidate weights come back stacked; scoring reuses the fold's
    cached validation matrix (``transform_from_matrix``), and selection
    runs the exact serial-path code on the scores."""
    from mmlspark_tpu_torch.core.sparse import CSRMatrix
    from mmlspark_tpu_torch.device import resolve_device
    from mmlspark_tpu_torch.models.linear import (
        TPULinearRegression, TPULogisticRegression,
        TPULinearRegressionModel, TPULogisticRegressionModel,
        _Standardizer, _device_f32, _fit_linear_batch,
        _fit_logistic_batch, _features_matrix,
    )

    if not candidates:
        return None
    ests = [e for e, _ in candidates]
    cls = type(ests[0])
    if cls not in (TPULogisticRegression, TPULinearRegression):
        return None
    if any(type(e) is not cls for e in ests):
        return None
    if any(set(pm) - _SWEEPABLE for _, pm in candidates):
        return None
    fcol = ests[0].get_features_col()
    lcol = ests[0].get_label_col()
    pcol = ests[0].get_prediction_col()
    if any(e.get_features_col() != fcol or e.get_label_col() != lcol
           or e.get_prediction_col() != pcol
           or e.get("device") != ests[0].get("device") for e in ests):
        return None
    try:
        if any(isinstance(t.column(fcol), CSRMatrix)
               or isinstance(v.column(fcol), CSRMatrix)
               for t, v in fold_pairs):
            return None   # the sparse gather fit has per-fold
            #               data-dependent shapes; serial path keeps it
    except KeyError:
        return None

    dev = resolve_device(ests[0].get("device"))
    logistic = cls is TPULogisticRegression
    # effective (stepSize, regParam, maxIter) per candidate: estimator
    # value overridden by the swept param map — exactly what the serial
    # path's est.copy()+set() produces
    configs = []
    for est, pm in candidates:
        cfg = {n: est.get(n) for n in ("stepSize", "regParam", "maxIter")}
        cfg.update(pm)
        configs.append(cfg)
    groups: Dict[int, List[int]] = {}
    for i, cfg in enumerate(configs):
        groups.setdefault(int(cfg["maxIter"]), []).append(i)

    scores = np.empty((len(candidates), len(fold_pairs)), np.float64)
    dispatches = 0
    for fi, (train_t, val_t) in enumerate(fold_pairs):
        # fold-cached matrices: ONE extraction + standardization per
        # fold, shared by every candidate's fit AND scoring
        X = _features_matrix(train_t, fcol)
        y = np.asarray(train_t[lcol], dtype=np.float64)
        mu, sd = _Standardizer.compute(X)
        Xs = (X - mu) / sd
        Xval = _features_matrix(val_t, fcol)
        Xd = _device_f32(Xs, dev)
        if logistic:
            yd = _device_f32(y, dev)
            num_class = int(y.max()) + 1 if len(y) else 2
            num_class = max(num_class, 2)
        else:
            y_mu, y_sd = float(y.mean()), float(y.std() or 1.0)
            ysd = _device_f32((y - y_mu) / y_sd, dev)
        for n_steps, idxs in groups.items():
            lrs = [configs[i]["stepSize"] for i in idxs]
            l2s = [configs[i]["regParam"] for i in idxs]
            if logistic:
                stacked = _fit_logistic_batch(Xd, yd, lrs, l2s, n_steps,
                                              num_class)
            else:
                stacked = _fit_linear_batch(Xd, ysd, lrs, l2s, n_steps)
            dispatches += 1
            for j, ci in enumerate(idxs):
                if logistic:
                    weights = {"W": stacked["W"][j], "b": stacked["b"][j],
                               "mu": mu, "sd": sd}
                    mdl: Model = TPULogisticRegressionModel(
                        weights=weights)
                else:
                    weights = {"w": stacked["w"][j], "b": stacked["b"][j],
                               "mu": mu, "sd": sd,
                               "y_mu": y_mu, "y_sd": y_sd}
                    mdl = TPULinearRegressionModel(weights=weights)
                mdl.set("featuresCol", fcol)
                mdl.set("predictionCol", pcol)
                scored = mdl.transform_from_matrix(val_t, Xval)
                scores[ci, fi] = _evaluate_scored(scored, metric)
    info.update(path="vmap", dispatches=dispatches,
                groups=len(groups))
    return [float(np.mean(scores[c])) for c in range(len(candidates))]


class TuneHyperparameters(Estimator):
    """Randomized/grid search with k-fold CV over one or more estimators
    (ref: TuneHyperparameters.scala:112-188). Fold pairs are assembled
    once and shared across candidates; homogeneous linear-model sweeps
    with numeric-only deltas run device-batched (see ``batchTrials``)."""

    models = ListParam("candidate estimators", default=None)
    paramSpace = StageParam("GridSpace or RandomSpace (or list of spaces "
                            "aligned with models)", default=None)
    evaluationMetric = StringParam("metric to optimize", default=MC.ACCURACY)
    numFolds = IntParam("k-fold count", default=3)
    numRuns = IntParam("sampled configs per model (random spaces)",
                       default=10)
    parallelism = IntParam("concurrent evaluations", default=4)
    seed = IntParam("shuffle seed", default=0)
    batchTrials = EnumParam(
        ["auto", "on", "off"],
        "device-batched CV trials: fit all candidates of a batchable "
        "linear-model sweep together, one call per fold and maxIter "
        "('auto' = when eligible, 'on' = warn + serial fallback when "
        "not, 'off' = always the serial thread pool)", default="auto")

    def fit(self, table: DataTable) -> "TuneHyperparametersModel":
        from mmlspark_tpu_torch.core.trace import get_tracer
        tracer = get_tracer()
        tune_trace = tracer.new_trace("automl.tune") \
            if tracer.enabled else None
        hists = MC.automl_histograms()
        models: List[Estimator] = self.get("models")
        space = self.get("paramSpace")
        metric = self.get("evaluationMetric")
        ascending = _METRIC_ASCENDING.get(metric, True)
        k = self.get("numFolds")

        # fold pairs built ONCE, outside the candidate loop: the old
        # path re-ran this concat inside every candidate evaluation —
        # k x C full-dataset copies before any model trained
        t0 = time.perf_counter()
        shuffled = table.shuffle(self.get("seed"))
        folds = shuffled.shards(k)
        fold_pairs: List[Tuple[DataTable, DataTable]] = [
            (DataTable.concat([f for j, f in enumerate(folds) if j != i]),
             folds[i])
            for i in range(k)]
        hists["tune_fold_build"].observe(
            (time.perf_counter() - t0) * 1e3)
        if tune_trace is not None:
            tracer.emit("tune_fold_build", t0, trace=tune_trace,
                        attrs={"folds": k})

        candidates: List[Tuple[Estimator, Dict[str, Any]]] = []
        for est in models:
            maps = space.param_maps()
            if isinstance(space, RandomSpace):
                maps = itertools.islice(maps, self.get("numRuns"))
            for pm in maps:
                usable = {n: v for n, v in pm.items()
                          if _has_param(est, n)}
                candidates.append((est, usable))

        info: Dict[str, Any] = {"path": "serial", "dispatches": 0,
                                "candidates": len(candidates),
                                "folds": k}
        t0 = time.perf_counter()
        results: Optional[List[float]] = None
        batch_mode = self.get("batchTrials")
        if batch_mode != "off":
            results = _batched_trials(candidates, fold_pairs, metric,
                                      info)
            if results is None and batch_mode == "on":
                _LOG.warning(
                    "batchTrials='on' but the sweep cannot be batched "
                    "(mixed estimator families or devices, non-numeric "
                    "params, or sparse features); falling back to "
                    "serial trials")

        if results is None:
            def eval_candidate(args):
                est, pm = args
                scores = []
                for train_t, val_t in fold_pairs:
                    e = est.copy()
                    for n, v in pm.items():
                        e.set(n, v)
                    model = e.fit(train_t)
                    scores.append(_evaluate(model, val_t, metric))
                return float(np.mean(scores))

            with ThreadPoolExecutor(self.get("parallelism")) as pool:
                results = list(pool.map(eval_candidate, candidates))
        hists["tune_trials"].observe((time.perf_counter() - t0) * 1e3)
        if tune_trace is not None:
            tracer.emit("tune_trials", t0, trace=tune_trace,
                        attrs={"path": info["path"],
                               "candidates": info["candidates"]})

        best_i = int(np.argmax(results) if ascending
                     else np.argmin(results))
        best_est, best_pm = candidates[best_i]
        final = best_est.copy()
        for n, v in best_pm.items():
            final.set(n, v)
        t0 = time.perf_counter()
        best_model = final.fit(table)
        hists["tune_refit"].observe((time.perf_counter() - t0) * 1e3)
        if tune_trace is not None:
            tracer.emit("tune_refit", t0, trace=tune_trace)
            tune_trace.root.set("path", info["path"])
            tracer.finish(tune_trace)
        history = [{"model": type(e).__name__, "params": pm,
                    "metric": r}
                   for (e, pm), r in zip(candidates, results)]
        tuned = TuneHyperparametersModel(
            bestModel=best_model, bestMetric=results[best_i],
            bestParams=best_pm, history=history)
        tuned.search_info = info
        return tuned


def _has_param(stage, name: str) -> bool:
    try:
        stage.param(name)
        return True
    except KeyError:
        return False


class TuneHyperparametersModel(Model):
    bestModel = StageParam("the winning fitted model", default=None)
    from mmlspark_tpu_torch.core.params import FloatParam as _FP, DictParam as _DP
    bestMetric = _FP("winning CV metric", default=0.0)
    bestParams = _DP("winning param map", default=None)
    history = ListParam("all (model, params, metric) records", default=None)

    def _post_init(self):
        # how the sweep ran (path: 'vmap' (batched) | 'serial',
        # dispatches, groups)
        # — runtime diagnostics, not a persisted param
        self.search_info: Dict[str, Any] = {}

    def transform(self, table: DataTable) -> DataTable:
        return self.get("bestModel").transform(table)

    def get_best_model_info(self) -> str:
        return (f"{type(self.get('bestModel')).__name__} "
                f"params={self.get('bestParams')} "
                f"metric={self.get('bestMetric')}")


class FindBestModel(Estimator):
    """Evaluate fitted models on the given table, keep the best
    (ref: FindBestModel.scala:50)."""

    models = ListParam("candidate fitted models", default=None)
    evaluationMetric = StringParam("metric", default=MC.ACCURACY)

    def fit(self, table: DataTable) -> "BestModel":
        metric = self.get("evaluationMetric")
        ascending = _METRIC_ASCENDING.get(metric, True)
        models: List[Model] = self.get("models")
        scores = [_evaluate(m, table, metric) for m in models]
        best_i = int(np.argmax(scores) if ascending
                     else np.argmin(scores))
        rows = [{"model": type(m).__name__, metric: s}
                for m, s in zip(models, scores)]
        # record all-metrics evaluation of the winner (ref: FindBestModel
        # records ROC/metrics dfs)
        scored = models[best_i].transform(table)
        all_metrics = ComputeModelStatistics().transform(scored)
        return BestModel(bestModel=models[best_i],
                         bestModelMetrics=all_metrics,
                         allModelMetrics=DataTable.from_rows(rows))


class BestModel(Model):
    bestModel = StageParam("winning model", default=None)
    from mmlspark_tpu_torch.core.params import TableParam as _TP
    bestModelMetrics = _TP("metrics table of the winner", default=None)
    allModelMetrics = _TP("metric per candidate", default=None)

    def transform(self, table: DataTable) -> DataTable:
        return self.get("bestModel").transform(table)

    def get_evaluation_results(self) -> DataTable:
        return self.get("allModelMetrics")
