"""Model evaluation as table-producing stages: the PyTorch port's copy
of ``mmlspark_tpu/automl/statistics.py`` (host numpy, bitwise equal).

Analog of compute-model-statistics / compute-per-instance-statistics
(ref: src/compute-model-statistics/.../ComputeModelStatistics.scala:57,
src/compute-per-instance-statistics/.../ComputePerInstanceStatistics.scala:42):
evaluation metrics are a *table* a pipeline produces, not a side-channel
service. Classification: confusion matrix, accuracy, per-class precision/
recall (macro + micro), AUC + binned ROC for binary. Regression:
mse/rmse/r2/mae.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from mmlspark_tpu_torch.core import metrics as MC
from mmlspark_tpu_torch.core.params import ColParam, EnumParam, IntParam
from mmlspark_tpu_torch.core.schema import Field, Schema, F64
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.core.table import DataTable


# numpy >= 2 names it trapezoid; older ones only trapz (the same rule)
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def roc_curve(y: np.ndarray, score: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, float]:
    """(fpr, tpr, auc) via rank statistics — vectorized numpy.

    Tied scores are collapsed into one ROC point (a tied group moves
    diagonally), so AUC is exact and row-order independent."""
    order = np.argsort(-score, kind="stable")
    y_sorted = y[order]
    s_sorted = score[order]
    tps = np.cumsum(y_sorted)
    fps = np.cumsum(1 - y_sorted)
    if len(s_sorted):
        # keep only the last index of each tied-score group
        keep = np.r_[np.nonzero(np.diff(s_sorted))[0], len(s_sorted) - 1]
        tps, fps = tps[keep], fps[keep]
    n_pos = max(tps[-1], 1e-12) if len(tps) else 1e-12
    n_neg = max(fps[-1], 1e-12) if len(fps) else 1e-12
    tpr = np.concatenate([[0.0], tps / n_pos])
    fpr = np.concatenate([[0.0], fps / n_neg])
    auc = float(_trapezoid(tpr, fpr))
    return fpr, tpr, auc


class ComputeModelStatistics(Transformer):
    """Evaluate scored tables (ref: ComputeModelStatistics.scala:57).

    Column discovery follows the reference's metadata-driven approach:
    defaults match what TrainClassifier/TPUBoost models emit
    (label / prediction / probability), overridable via params.
    """

    evaluationMetric = EnumParam(
        ["classification", "regression", "auto", MC.ALL_METRICS],
        "metric family", default="auto")
    labelCol = ColParam("ground-truth column", default="label")
    scoresCol = ColParam("prediction column", default="prediction")
    scoredProbabilitiesCol = ColParam("probability vector column",
                                      default="probability")
    numBins = IntParam("ROC bins (parity: BinaryClassificationMetrics)",
                       default=100)

    def _mode(self, table: DataTable) -> str:
        mode = self.get("evaluationMetric")
        if mode not in ("auto", MC.ALL_METRICS):
            return mode
        y = np.asarray(table[self.get("labelCol")], dtype=np.float64)
        distinct = np.unique(y[np.isfinite(y)])
        if len(distinct) <= max(20, int(np.sqrt(len(y)))) and \
                np.allclose(distinct, np.round(distinct)):
            return "classification"
        return "regression"

    def transform(self, table: DataTable) -> DataTable:
        y = np.asarray(table[self.get("labelCol")], dtype=np.float64)
        pred = np.asarray(table[self.get("scoresCol")], dtype=np.float64)
        if self._mode(table) == "regression":
            err = pred - y
            mse = float(np.mean(err ** 2))
            row = {
                MC.MSE: mse,
                MC.RMSE: float(np.sqrt(mse)),
                MC.R2: float(1.0 - mse / max(np.var(y), 1e-300)),
                MC.MAE: float(np.mean(np.abs(err))),
            }
            return DataTable.from_rows([row])

        # classification
        classes = np.unique(np.concatenate([y, pred])).astype(int)
        if len(classes) and classes.min() < 0:
            raise ValueError(
                f"negative class labels {classes[classes < 0]} — index "
                f"labels to 0..K-1 first (ValueIndexer)")
        k = int(classes.max()) + 1 if len(classes) else 2
        cm = np.zeros((k, k))
        for t, p in zip(y.astype(int), pred.astype(int)):
            cm[t, p] += 1
        accuracy = float(np.trace(cm) / max(cm.sum(), 1e-12))
        # macro-average only over classes actually present, so gaps in
        # the label range don't drag the averages down
        present = np.zeros(k, dtype=bool)
        present[classes] = True
        with np.errstate(invalid="ignore", divide="ignore"):
            per_class_prec = np.nan_to_num(np.diag(cm) / cm.sum(axis=0))
            per_class_rec = np.nan_to_num(np.diag(cm) / cm.sum(axis=1))
        precision = float(per_class_prec[present].mean())
        recall = float(per_class_rec[present].mean())
        row: Dict[str, Any] = {
            MC.CONFUSION_MATRIX: cm,
            MC.ACCURACY: accuracy,
            MC.PRECISION: precision,
            MC.RECALL: recall,
        }
        # binary AUC from the probability column when present
        prob_col = self.get("scoredProbabilitiesCol")
        if k == 2 and prob_col in table:
            prob = table[prob_col]
            p1 = (np.asarray(prob)[:, 1]
                  if isinstance(prob, np.ndarray) and prob.ndim == 2
                  else np.asarray([np.asarray(v)[1] for v in prob]))
            _, _, auc = roc_curve(y, p1)
            row[MC.AUC] = auc
        return DataTable.from_rows([row])

    def roc_table(self, table: DataTable) -> DataTable:
        """Binned ROC curve table (the reference records it as a df)."""
        y = np.asarray(table[self.get("labelCol")], dtype=np.float64)
        prob = table[self.get("scoredProbabilitiesCol")]
        p1 = (np.asarray(prob)[:, 1]
              if isinstance(prob, np.ndarray) and prob.ndim == 2
              else np.asarray([np.asarray(v)[1] for v in prob]))
        fpr, tpr, _ = roc_curve(y, p1)
        nb = self.get("numBins")
        idx = np.linspace(0, len(fpr) - 1, min(nb, len(fpr))).astype(int)
        return DataTable({"false_positive_rate": fpr[idx],
                          "true_positive_rate": tpr[idx]})

    def transform_schema(self, schema: Schema) -> Schema:
        mode = self.get("evaluationMetric")
        if mode in ("auto", MC.ALL_METRICS):
            # data-dependent; promise only the universally-present rows
            return Schema([])
        if mode == "regression":
            return Schema([Field(m, F64) for m in
                           (MC.MSE, MC.RMSE, MC.R2, MC.MAE)])
        return Schema([Field(MC.ACCURACY, F64), Field(MC.PRECISION, F64),
                       Field(MC.RECALL, F64)])


class ComputePerInstanceStatistics(Transformer):
    """Per-row L1/L2 loss (regression) or log-loss (classification)
    (ref: ComputePerInstanceStatistics.scala:42)."""

    evaluationMetric = EnumParam(["classification", "regression", "auto"],
                                 "metric family", default="auto")
    labelCol = ColParam("ground-truth column", default="label")
    scoresCol = ColParam("prediction column", default="prediction")
    scoredProbabilitiesCol = ColParam("probability vector column",
                                      default="probability")

    def transform(self, table: DataTable) -> DataTable:
        y = np.asarray(table[self.get("labelCol")], dtype=np.float64)
        mode = self.get("evaluationMetric")
        if mode == "auto":
            prob_col = self.get("scoredProbabilitiesCol")
            mode = ("classification" if prob_col in table
                    else "regression")
        if mode == "regression":
            pred = np.asarray(table[self.get("scoresCol")],
                              dtype=np.float64)
            out = table.with_column(MC.L1_LOSS, np.abs(pred - y),
                                    Field(MC.L1_LOSS, F64))
            return out.with_column(MC.L2_LOSS, (pred - y) ** 2,
                                   Field(MC.L2_LOSS, F64))
        prob = table[self.get("scoredProbabilitiesCol")]
        mat = (np.asarray(prob) if isinstance(prob, np.ndarray)
               and prob.ndim == 2
               else np.stack([np.asarray(v) for v in prob]))
        picked = mat[np.arange(len(y)), y.astype(int)]
        log_loss = -np.log(np.clip(picked, 1e-15, 1.0))
        return table.with_column(MC.LOG_LOSS, log_loss,
                                 Field(MC.LOG_LOSS, F64))

    def transform_schema(self, schema: Schema) -> Schema:
        mode = self.get("evaluationMetric")
        if mode == "regression":
            return (schema.add_or_replace(Field(MC.L1_LOSS, F64))
                    .add_or_replace(Field(MC.L2_LOSS, F64)))
        if mode == "classification":
            return schema.add_or_replace(Field(MC.LOG_LOSS, F64))
        return schema  # auto: data-dependent
