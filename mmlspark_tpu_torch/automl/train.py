"""TrainClassifier / TrainRegressor — one-call model training: the
PyTorch port of ``mmlspark_tpu/automl/train.py``.

Analog of the reference's train-classifier / train-regressor components
(ref: src/train-classifier/.../TrainClassifier.scala:40-288,
src/train-regressor/.../TrainRegressor.scala:20-149): index the label if
non-numeric, auto-featurize the inputs, fit the underlying model, and
return a wrapper model that featurizes + scores + un-indexes labels.

Both estimators take the port's ``device`` param and hand it to the
default ``TPUBoost*`` learner they build; a caller's own ``model=``
keeps its own ``device``.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from mmlspark_tpu_torch.automl.featurize import Featurize
from mmlspark_tpu_torch.core.params import (
    BoolParam, HasLabelCol, IntParam, ListParam, StageParam,
)
from mmlspark_tpu_torch.core.schema import Field, Schema, F64, STRING
from mmlspark_tpu_torch.core.stage import Estimator, Model
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.device import HasDevice
from mmlspark_tpu_torch.stages.dataprep import ValueIndexer

_FEATURES_COL = "TrainClassifier_features"


class TrainClassifier(Estimator, HasLabelCol, HasDevice):
    """Auto-featurize + fit a classifier
    (ref: TrainClassifier.scala:102-260). ``model`` is any Estimator with
    featuresCol/labelCol params; default TPUBoostClassifier on this
    stage's ``device``."""

    model = StageParam("underlying classifier estimator", default=None)
    featureColumns = ListParam("columns to featurize (None = all)",
                               default=None)
    numFeatures = IntParam("hash width for token columns",
                           default=1 << 12)  # see Featurize note on 2^18
    oneHotEncodeCategoricals = BoolParam("one-hot categoricals",
                                         default=False)
    reindexLabel = BoolParam("index the label column", default=True)

    def _get_model(self) -> Estimator:
        m = self.get_or_none("model")
        if m is None:
            from mmlspark_tpu_torch.gbdt import TPUBoostClassifier
            m = TPUBoostClassifier(device=self.get("device"))
        return m

    def fit(self, table: DataTable) -> "TrainedClassifierModel":
        label_col = self.get_label_col()
        levels: Optional[List[Any]] = None
        work = table
        if self.get("reindexLabel"):
            f = work.schema[label_col]
            needs_index = f.tag == STRING
            if not needs_index:
                y = np.asarray(work[label_col], dtype=np.float64)
                classes = np.unique(y)
                needs_index = not np.array_equal(
                    classes, np.arange(len(classes)))
            if needs_index:
                idx_model = ValueIndexer(
                    inputCol=label_col, outputCol=label_col).fit(work)
                levels = idx_model.get("levels")
                work = idx_model.transform(work)

        feat_cols = self.get_or_none("featureColumns")
        if feat_cols is None:
            feat_cols = [c for c in work.column_names if c != label_col]
        featurizer = Featurize(
            featureColumns=feat_cols, outputCol=_FEATURES_COL,
            oneHotEncodeCategoricals=self.get("oneHotEncodeCategoricals"),
            numberOfFeatures=self.get("numFeatures")).fit(work)
        feats = featurizer.transform(work)

        est = self._get_model().copy()
        est.set("featuresCol", _FEATURES_COL)
        est.set("labelCol", label_col)
        fitted = est.fit(feats)
        return TrainedClassifierModel(
            featurizer=featurizer, innerModel=fitted, levels=levels,
            labelCol=label_col)


class TrainedClassifierModel(Model):
    """ref: TrainClassifier.scala:288 TrainedClassifierModel — scores and
    un-indexes the predicted label back to original values."""

    featurizer = StageParam("fitted featurizer", default=None)
    innerModel = StageParam("fitted classifier model", default=None)
    levels = ListParam("original label levels (None = numeric)",
                       default=None)

    from mmlspark_tpu_torch.core.params import ColParam as _CP
    labelCol = _CP("label column name", default="label")

    def transform(self, table: DataTable) -> DataTable:
        out = self.get("featurizer").transform(table)
        out = self.get("innerModel").transform(out)
        out = out.drop(_FEATURES_COL)
        levels = self.get_or_none("levels")
        if levels:
            from mmlspark_tpu_torch.stages.dataprep import unindex_codes
            orig = unindex_codes(out["prediction"], levels)
            out = out.with_column("scored_labels", orig)
        else:
            out = out.with_column("scored_labels", out["prediction"])
        return out

    def transform_schema(self, schema: Schema) -> Schema:
        return schema.add_or_replace(Field("scored_labels", F64))


class TrainRegressor(Estimator, HasLabelCol, HasDevice):
    """ref: TrainRegressor.scala:20-149."""

    model = StageParam("underlying regressor estimator", default=None)
    featureColumns = ListParam("columns to featurize (None = all)",
                               default=None)
    numFeatures = IntParam("hash width for token columns",
                           default=1 << 12)  # see Featurize note on 2^18
    oneHotEncodeCategoricals = BoolParam("one-hot categoricals",
                                         default=False)

    def _get_model(self) -> Estimator:
        m = self.get_or_none("model")
        if m is None:
            from mmlspark_tpu_torch.gbdt import TPUBoostRegressor
            m = TPUBoostRegressor(device=self.get("device"))
        return m

    def fit(self, table: DataTable) -> "TrainedRegressorModel":
        label_col = self.get_label_col()
        feat_cols = self.get_or_none("featureColumns")
        if feat_cols is None:
            feat_cols = [c for c in table.column_names if c != label_col]
        featurizer = Featurize(
            featureColumns=feat_cols, outputCol=_FEATURES_COL,
            oneHotEncodeCategoricals=self.get("oneHotEncodeCategoricals"),
            numberOfFeatures=self.get("numFeatures")).fit(table)
        feats = featurizer.transform(table)
        est = self._get_model().copy()
        est.set("featuresCol", _FEATURES_COL)
        est.set("labelCol", label_col)
        fitted = est.fit(feats)
        return TrainedRegressorModel(featurizer=featurizer,
                                     innerModel=fitted,
                                     labelCol=label_col)


class TrainedRegressorModel(Model):
    featurizer = StageParam("fitted featurizer", default=None)
    innerModel = StageParam("fitted regressor model", default=None)

    from mmlspark_tpu_torch.core.params import ColParam as _CP
    labelCol = _CP("label column name", default="label")

    def transform(self, table: DataTable) -> DataTable:
        out = self.get("featurizer").transform(table)
        out = self.get("innerModel").transform(out)
        return out.drop(_FEATURES_COL)

    def transform_schema(self, schema: Schema) -> Schema:
        return schema.add_or_replace(Field("prediction", F64))
