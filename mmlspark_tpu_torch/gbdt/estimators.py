"""TPUBoostClassifier / TPUBoostRegressor pipeline stages.

Port of ``mmlspark_tpu/gbdt/estimators.py``: the same Param names and
defaults (so a JAX stage's settings carry over), plus ``device`` — the
torch device the stage trains and scores on, ``'cuda'`` by default
(raising without a card) or ``'cpu'`` when asked for. ``fit`` returns a
Model holding the model string of the ``"mmlspark_tpu.booster.v1"``
format; ``transform`` writes the same rawPrediction / probability /
prediction columns as the JAX package.

Bagging, feature fraction, quantized histograms (``histBits`` 16 / 8),
validation data with early stopping, the ``initModelString`` warm start
and ``keepTrainingData`` run as in the JAX package; the fitted model
keeps the live booster, so ``model.get_booster().boost_more(...)``
works. A sparse (``CSRMatrix``) features column trains and scores
without densifying the table, and ``fit`` also takes an out-of-core
``ChunkedTable`` (``binFit='sketch'`` for one-pass sketch cuts).
Distributed modes raise ``NotImplementedError`` from ``booster.train``.

The fitted models carry the fusion hook ``device_op``
(``core/fusion.py``): the forest walk (``tree.predict_trees``) and the
objective transform as torch ops, with the stacked forest as device
constants. The trees' outputs are summed one iteration after another,
the order of the host path's numpy sum, so the fused raw scores are
bitwise the host ones; forests that need f64 routing return None (host
path).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.params import (
    BoolParam, ColParam, EnumParam, FloatParam, HasFeaturesCol, HasLabelCol,
    HasPredictionCol, IntParam, StringParam, TableParam, range_domain,
)
from mmlspark_tpu_torch.core.schema import Field, Schema, VECTOR, F64
from mmlspark_tpu_torch.core.stage import Estimator, Model
from mmlspark_tpu_torch.core.sparse import CSRMatrix
from mmlspark_tpu_torch.core.table import DataTable, features_matrix
from mmlspark_tpu_torch.device import HasDevice
from mmlspark_tpu_torch.gbdt.booster import Booster, train
from mmlspark_tpu_torch.gbdt.tree import predict_trees
from mmlspark_tpu_torch.io.ooc import ChunkedTable


class _BoostParams(HasFeaturesCol, HasLabelCol, HasPredictionCol,
                   HasDevice):
    """Shared boosting params (the JAX package's names and defaults)."""

    numIterations = IntParam("number of boosting iterations", default=100,
                             domain=range_domain(lo=1))
    learningRate = FloatParam("shrinkage rate", default=0.1,
                              domain=range_domain(lo=0.0, lo_inc=False))
    numLeaves = IntParam("max leaves per tree", default=31,
                         domain=range_domain(lo=2))
    maxBin = IntParam("max feature bins", default=255,
                      domain=range_domain(lo=2))
    maxDepth = IntParam("max tree depth (<=0 unlimited)", default=0)
    minDataInLeaf = IntParam("min rows per leaf", default=20)
    minSumHessianInLeaf = FloatParam("min hessian sum per leaf", default=1e-3)
    lambdaL1 = FloatParam("L1 regularization", default=0.0)
    lambdaL2 = FloatParam("L2 regularization", default=0.0)
    minGainToSplit = FloatParam("min gain to split", default=0.0)
    featureFraction = FloatParam("feature subsample per tree", default=1.0,
                                 domain=range_domain(lo=0.0, hi=1.0,
                                                     lo_inc=False))
    baggingFraction = FloatParam("row subsample fraction", default=1.0,
                                 domain=range_domain(lo=0.0, hi=1.0,
                                                     lo_inc=False))
    baggingFreq = IntParam("bagging frequency (0 off)", default=0)
    earlyStoppingRound = IntParam("early stopping rounds (0 off)", default=0)
    boostFromAverage = BoolParam("start from average score", default=True)
    seed = IntParam("random seed", default=0)
    weightCol = ColParam("optional row-weight column", default=None)
    histMethod = EnumParam(
        ["auto", "scatter", "onehot", "pallas"],
        "histogram strategy: 'pallas' = the hand-written device kernel, "
        "'scatter' = the plain index_add_ version; 'auto' = the kernel "
        "on a CUDA device, scatter on the CPU", default="auto")
    histBits = IntParam("histogram precision: 32 = f32; 16 / 8 = "
                        "stochastically rounded int16 / int8 stats with "
                        "exact int32 histograms", default=32)
    histComm = EnumParam(["auto", "psum", "reduce_scatter"],
                         "data-parallel histogram collective: 'psum' sums "
                         "the full histogram on every rank, "
                         "'reduce_scatter' gives each rank its feature "
                         "slice; 'auto' = reduce_scatter for quantized "
                         "data-parallel fits, else psum", default="auto")
    parallelism = EnumParam(["serial", "data", "feature", "voting"],
                            "tree learner parallelism over the "
                            "torch.distributed group (one rank per "
                            "process; outside a group, a group of one)",
                            default="serial")
    topK = IntParam("voting-parallel candidates per worker", default=20)
    boostChunk = IntParam(
        "boosting iterations fused per device dispatch in the JAX "
        "package (0 = auto); here one Python step runs each iteration "
        "and the value sets only the early-stopping cadence, as it does "
        "there (capped at min(earlyStoppingRound, 8))", default=0,
        domain=range_domain(lo=0))
    deviceBinning = EnumParam(
        ["auto", "on", "off"],
        "bin raw features on the device ('auto' = when the mapper's cuts "
        "are f32-exact, i.e. float32 input)", default="auto")
    binFit = EnumParam(["sample", "sketch"],
                       "streaming bin-boundary fit: 'sample' (reservoir "
                       "sample of every row) or 'sketch' (one-pass "
                       "mergeable quantile sketch); in-memory fits use "
                       "'sample'",
                       default="sample")
    validationData = TableParam("held-out table for early stopping",
                                default=None)
    initModelString = StringParam("serialized booster to warm-start from",
                                  default="")
    keepTrainingData = BoolParam(
        "retain the training state on the fitted booster so that "
        "Booster.boost_more(data=None) continues exactly where fit() "
        "stopped (no warm start, no early stopping)", default=False)

    def _train_params(self) -> Dict[str, Any]:
        return {
            "keep_training_data": self.get("keepTrainingData"),
            "num_iterations": self.get("numIterations"),
            "learning_rate": self.get("learningRate"),
            "num_leaves": self.get("numLeaves"),
            "max_bin": self.get("maxBin"),
            "max_depth": self.get("maxDepth"),
            "min_data_in_leaf": self.get("minDataInLeaf"),
            "min_sum_hessian_in_leaf": self.get("minSumHessianInLeaf"),
            "lambda_l1": self.get("lambdaL1"),
            "lambda_l2": self.get("lambdaL2"),
            "min_gain_to_split": self.get("minGainToSplit"),
            "feature_fraction": self.get("featureFraction"),
            "bagging_fraction": self.get("baggingFraction"),
            "bagging_freq": self.get("baggingFreq"),
            "early_stopping_round": self.get("earlyStoppingRound"),
            "boost_from_average": self.get("boostFromAverage"),
            "seed": self.get("seed"),
            "hist_method": self.get("histMethod"),
            "hist_bits": self.get("histBits"),
            "hist_comm": self.get("histComm"),
            "parallelism": self.get("parallelism"),
            "top_k": self.get("topK"),
            "boost_chunk": self.get("boostChunk"),
            "device_binning": self.get("deviceBinning"),
            "bin_fit": self.get("binFit"),
        }

    def _features_matrix(self, table: DataTable) -> np.ndarray:
        col = table.column(self.get_features_col())
        if isinstance(col, CSRMatrix):
            return col    # booster.train bins CSR directly, no densify
        if isinstance(col, np.ndarray) and col.ndim == 2 \
                and col.dtype == np.float32:
            # keep float32: the f32-exact cut snapping keeps on-device
            # binning eligible and no f64 copy materializes
            return col
        return features_matrix(table, self.get_features_col())

    def _valid(self):
        vt = self.get_or_none("validationData")
        if vt is None:
            return None
        return (self._features_matrix(vt),
                np.asarray(vt.column(self.get_label_col()), dtype=np.float64))

    def _train(self, params: Dict[str, Any], table) -> Booster:
        if isinstance(table, ChunkedTable):
            # out-of-core fit through train()'s streaming ingest
            if self.get("initModelString"):
                raise ValueError(
                    "init-model warm start requires an in-memory table "
                    "(streaming ingest cannot warm-start)")
            fac = table.as_xy(self.get_features_col(), self.get_label_col(),
                              self.get_or_none("weightCol"))
            return train(params, fac, y=None, valid=self._valid(),
                         device=self.get("device"))
        X = self._features_matrix(table)
        y = np.asarray(table.column(self.get_label_col()), dtype=np.float64)
        wcol = self.get_or_none("weightCol")
        w = (np.asarray(table.column(wcol), dtype=np.float64)
             if wcol else None)
        return train(params, X, y, sample_weight=w, valid=self._valid(),
                     init_model=self.get("initModelString") or None,
                     device=self.get("device"))


class _BoosterModel(Model, HasFeaturesCol, HasPredictionCol, HasDevice):
    """Shared fitted-model plumbing: lazy booster from the model string."""

    modelString = StringParam("serialized booster", default="")

    def _post_init(self):
        self._booster: Optional[Booster] = None

    def _on_param_change(self, name):
        if name in ("modelString", "device"):
            self._booster = None

    def get_booster(self) -> Booster:
        if self._booster is None:
            self._booster = Booster.from_string(self.get("modelString"),
                                                device=self.get("device"))
        return self._booster

    _features_matrix = _BoostParams._features_matrix

    def reads_columns(self, schema):
        return [self.get_features_col()]

    def _forest_op(self, writes, out_fields, out_dtypes, head):
        """The shared device op: ``head(raw, prob, K)`` turns the (K, N)
        raw scores and their objective transform into the written
        columns. None when the forest must score on the host."""
        from mmlspark_tpu_torch.core import fusion as FZ
        try:
            booster = self.get_booster()
        except Exception:  # noqa: BLE001 — unparseable model: host path
            return None
        if booster.num_trees == 0 or booster._needs_f64_inference():
            return None
        feat = self.get_features_col()
        K = booster.num_class
        it = booster._resolve_iterations(None)
        t_limit = it * K
        if t_limit <= 0:
            return None
        max_depth = booster._max_depth(t_limit)
        obj = booster.objective
        FZ.register_kernel(head, f"{type(self).__name__}:{self.uid}:head")

        def make_consts():
            b = self.get_booster()
            trees = {k: np.asarray(b.trees[k][:t_limit])
                     for k in ("feature", "left", "right", "value")}
            # thresholds as float32, as the f32 walk receives them
            trees["threshold"] = np.asarray(
                b.trees["threshold"][:t_limit], np.float32)
            return {"trees": trees,
                    "init": np.asarray(b.init_score, np.float32)}

        def fn(consts, env, _f=feat, _it=it, _K=K, _depth=max_depth):
            X = env[_f]
            tr = consts["trees"]
            out = predict_trees(X, tr["feature"], tr["threshold"],
                                tr["left"], tr["right"], tr["value"],
                                max_depth=_depth)
            per_it = out.reshape(_it, _K, X.shape[0])
            acc = per_it[0]
            for i in range(1, _it):
                acc = acc + per_it[i]
            raw = consts["init"][:, None] + acc
            return head(raw, obj.transform(raw), _K)

        return FZ.DeviceOp(
            self, reads=[feat], writes=writes, fn=fn,
            make_consts=make_consts, out_fields=out_fields,
            out_dtypes=out_dtypes)

    def save_native_model(self, path: str) -> None:
        self.get_booster().save_native_model(path)

    def get_feature_importances(self, kind: str = "split") -> np.ndarray:
        return self.get_booster().feature_importance(kind)


def _chunked_classes(table: ChunkedTable, label_col: str) -> np.ndarray:
    """The distinct labels of a chunk stream, in one pass that keeps no
    chunk once it returns (a chunk left bound in the caller's frame would
    stay in memory through the whole fit)."""
    classes: np.ndarray = np.empty(0)
    for chunk in table.chunks():
        y = np.asarray(chunk[label_col], np.float64)
        classes = np.union1d(classes, np.unique(y))
    return classes


class TPUBoostClassifier(Estimator, _BoostParams):
    """GBDT classifier (ref: LightGBMClassifier.scala:36)."""

    objective = EnumParam(["binary", "multiclass"],
                          "classification objective", default="binary")
    probabilityCol = ColParam("probability output column",
                              default="probability")
    rawPredictionCol = ColParam("raw score output column",
                                default="rawPrediction")

    def fit(self, table) -> "TPUBoostClassificationModel":
        """Fit on a DataTable or a ``ChunkedTable`` (out of core: one
        extra pass over the labels finds the class count)."""
        if isinstance(table, ChunkedTable):
            classes = _chunked_classes(table, self.get_label_col())
        else:
            classes = np.unique(np.asarray(
                table.column(self.get_label_col()), dtype=np.float64))
        num_class = len(classes)
        if not np.array_equal(classes, np.arange(num_class)):
            raise ValueError(
                f"labels must be 0..K-1 integers, got {classes[:10]}")
        params = self._train_params()
        if num_class > 2:
            params["objective"] = "multiclass"
            params["num_class"] = num_class
        else:
            params["objective"] = "binary"
        booster = self._train(params, table)
        model = TPUBoostClassificationModel(
            modelString=booster.model_to_string(), numClasses=num_class,
            device=self.get("device"))
        model._booster = booster     # the live booster (bin_mapper rides)
        for name in ("featuresCol", "predictionCol", "probabilityCol",
                     "rawPredictionCol"):
            model.set(name, self.get(name))
        return model

    def transform_schema(self, schema: Schema) -> Schema:
        schema.require(self.get_features_col())
        schema.require(self.get_label_col())
        return (schema
                .add_or_replace(Field(self.get("rawPredictionCol"), VECTOR))
                .add_or_replace(Field(self.get("probabilityCol"), VECTOR))
                .add_or_replace(Field(self.get_prediction_col(), F64)))


class TPUBoostClassificationModel(_BoosterModel):
    """Fitted GBDT classifier (ref: LightGBMClassificationModel)."""

    numClasses = IntParam("number of classes", default=2)
    probabilityCol = ColParam("probability output column",
                              default="probability")
    rawPredictionCol = ColParam("raw score output column",
                                default="rawPrediction")

    def writes_columns(self, schema):
        return [self.get("rawPredictionCol"), self.get("probabilityCol"),
                self.get_prediction_col()]

    def device_op(self, schema):
        """Fusion hook: the f32 forest walk + the objective transform
        on the device; raw / probability stay float32 like the host
        path's, the prediction widens to f64."""
        raw_col = self.get("rawPredictionCol")
        prob_col = self.get("probabilityCol")
        pred_col = self.get_prediction_col()

        def head(raw, prob, K, _r=raw_col, _pr=prob_col, _p=pred_col):
            if K == 1:
                raw2 = torch.stack([-raw[0], raw[0]], dim=1)
                prob2 = torch.stack([1.0 - prob[0], prob[0]], dim=1)
            else:
                raw2 = raw.T
                prob2 = prob.T
            pred = torch.argmax(prob2, dim=1).to(torch.float32)
            return {_r: raw2, _pr: prob2, _p: pred}

        return self._forest_op(
            [raw_col, prob_col, pred_col],
            {raw_col: Field(raw_col, VECTOR),
             prob_col: Field(prob_col, VECTOR),
             pred_col: Field(pred_col, F64)},
            {pred_col: np.float64}, head)

    def transform(self, table: DataTable) -> DataTable:
        X = self._features_matrix(table)
        booster = self.get_booster()
        raw = booster.raw_score(X)   # single forest walk; reuse for both
        prob = booster.objective.transform(torch.from_numpy(raw)).numpy()
        if booster.num_class == 1:          # binary
            raw2 = np.stack([-raw, raw], axis=1)
            prob2 = np.stack([1 - prob, prob], axis=1)
        else:
            raw2 = np.asarray(raw).T
            prob2 = prob.T
        pred = np.argmax(prob2, axis=1).astype(np.float64)
        return (table
                .with_column(self.get("rawPredictionCol"), raw2)
                .with_column(self.get("probabilityCol"), prob2)
                .with_column(self.get_prediction_col(), pred))

    def transform_schema(self, schema: Schema) -> Schema:
        schema.require(self.get_features_col())
        return (schema
                .add_or_replace(Field(self.get("rawPredictionCol"), VECTOR))
                .add_or_replace(Field(self.get("probabilityCol"), VECTOR))
                .add_or_replace(Field(self.get_prediction_col(), F64)))


class TPUBoostRegressor(Estimator, _BoostParams):
    """GBDT regressor with quantile/tweedie/poisson/huber objectives
    (ref: LightGBMRegressor.scala, TrainParams.scala:48-61)."""

    objective = EnumParam(
        ["regression", "regression_l1", "huber", "quantile", "poisson",
         "tweedie", "gamma", "l2", "l1", "mae", "mse"],
        "regression objective", default="regression")
    alpha = FloatParam("quantile level / huber delta", default=0.9)
    tweedieVariancePower = FloatParam("tweedie variance power in (1,2)",
                                      default=1.5)

    def fit(self, table) -> "TPUBoostRegressionModel":
        """Fit on a DataTable or a ``ChunkedTable`` (out of core)."""
        params = self._train_params()
        params["objective"] = self.get("objective")
        params["alpha"] = self.get("alpha")
        params["tweedie_variance_power"] = self.get("tweedieVariancePower")
        booster = self._train(params, table)
        model = TPUBoostRegressionModel(modelString=booster.model_to_string(),
                                        device=self.get("device"))
        model._booster = booster
        for name in ("featuresCol", "predictionCol"):
            model.set(name, self.get(name))
        return model

    def transform_schema(self, schema: Schema) -> Schema:
        schema.require(self.get_features_col())
        schema.require(self.get_label_col())
        return schema.add_or_replace(Field(self.get_prediction_col(), F64))


class TPUBoostRegressionModel(_BoosterModel):
    """Fitted GBDT regressor."""

    def writes_columns(self, schema):
        return [self.get_prediction_col()]

    def device_op(self, schema):
        """Fusion hook: forest walk + objective transform on the device
        (see TPUBoostClassificationModel.device_op)."""
        pred_col = self.get_prediction_col()

        def head(raw, pred, K, _p=pred_col):
            return {_p: pred[0]}

        return self._forest_op(
            [pred_col], {pred_col: Field(pred_col, F64)},
            {pred_col: np.float64}, head)

    def transform(self, table: DataTable) -> DataTable:
        X = self._features_matrix(table)
        pred = np.asarray(self.get_booster().predict(X), dtype=np.float64)
        return table.with_column(self.get_prediction_col(), pred)

    def transform_schema(self, schema: Schema) -> Schema:
        schema.require(self.get_features_col())
        return schema.add_or_replace(Field(self.get_prediction_col(), F64))
