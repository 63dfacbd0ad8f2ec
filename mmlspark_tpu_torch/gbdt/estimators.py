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
from mmlspark_tpu_torch.gbdt.booster import Booster, train
from mmlspark_tpu_torch.io.ooc import ChunkedTable


def _device_domain(v: str) -> bool:
    return v.split(":")[0] in ("cuda", "cpu")


class _DeviceParam:
    device = StringParam(
        "torch device to train and score on: 'cuda' (default; raises "
        "when no card is present) or 'cpu' (explicit opt-in)",
        default="cuda", domain=_device_domain)


class _BoostParams(HasFeaturesCol, HasLabelCol, HasPredictionCol,
                   _DeviceParam):
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
                         "data-parallel histogram collective (distributed "
                         "modes are not ported yet)", default="auto")
    parallelism = EnumParam(["serial", "data", "feature", "voting"],
                            "tree learner parallelism (only 'serial' is "
                            "ported yet)", default="serial")
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


class _BoosterModel(Model, HasFeaturesCol, HasPredictionCol, _DeviceParam):
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

    def transform(self, table: DataTable) -> DataTable:
        X = self._features_matrix(table)
        pred = np.asarray(self.get_booster().predict(X), dtype=np.float64)
        return table.with_column(self.get_prediction_col(), pred)

    def transform_schema(self, schema: Schema) -> Schema:
        schema.require(self.get_features_col())
        return schema.add_or_replace(Field(self.get_prediction_col(), F64))
