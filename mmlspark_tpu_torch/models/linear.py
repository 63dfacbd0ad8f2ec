"""Linear models of the PyTorch port: logistic and linear regression.

The port of ``mmlspark_tpu/models/linear.py``. The reference's AutoML
layer wraps SparkML's LogisticRegression / LinearRegression as candidate
models (ref: src/train-classifier/.../TrainClassifier.scala:112-156);
both packages implement them directly as full-batch gradient descent
with momentum: ``vel = 0.9 vel - lr g; p = p + vel`` over ``maxIter``
steps, with ``l2 ΣW²`` on the weights and not on the bias.

Where the JAX package jits one ``lax.fori_loop`` (and ``vmap``s it over
candidates), the port runs a Python loop over device tensors with a
closed-form gradient, in strict float32 (``networks.strict_f32``; torch
keeps TF32 off for matmuls by default):

- **Dense fits** take an explicit leading candidate axis C: the
  standardized features gain a ones column (the bias row of the weight
  block), ``Wb`` is (C, D + 1, K), ``lr`` and ``l2`` are (C, 1, 1), and
  every product is a batched matmul over C. ``fit`` and ``partial_fit``
  call the same function at C = 1, so a candidate of a batched CV sweep
  (``automl/tuning.py``) and its serial fit share one arithmetic.
- **The sparse logistic fit** reads ``CSRMatrix.padded_batch`` gather
  blocks: ``logits = einsum('nm,nmk->nk', val, W[idx]) + b``. Its weight
  gradient is summed per column in the CSC order of ``CSRMatrix.csc``,
  in pieces of at most ``_PIECE`` nonzeros and then over each column's
  pieces (two ``torch.segment_reduce`` calls), never by an atomic
  scatter, so two fits on the card are bitwise equal.

Standardization (``_Standardizer``) runs in float64 on the host and the
result goes to the device as float32, as in the reference. Scoring
(``transform`` / ``transform_from_matrix``) stays host numpy in float64,
so equal weights give bitwise equal scores in both packages. Int8
quantization (``quantize``) returns a new model with ``precision='int8'``
that scores through ``core.quantize.int8_matmul_host``, the JAX
package's host mirror, so a quantized model saved by either package
scores bitwise equal in the other; ``precision='int8'`` cannot be set by
hand on an f32 model. ``device_op`` is the fusion hook
(``core/fusion.py``): standardize, product and scoring as f32 torch ops
on the fused plan's device, with every weight and statistic a device
tensor (an int8 model through ``core.quantize.int8_matmul``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.core.params import (
    EnumParam, FloatParam, HasFeaturesCol, HasLabelCol, HasPredictionCol,
    IntParam, PyTreeParam,
)
from mmlspark_tpu_torch.core.schema import Field, Schema, F64, VECTOR
from mmlspark_tpu_torch.core.sparse import CSRMatrix
from mmlspark_tpu_torch.core.stage import Estimator, Model
from mmlspark_tpu_torch.core.table import DataTable, features_matrix as _features_matrix
from mmlspark_tpu_torch.device import HasDevice, resolve_device
from mmlspark_tpu_torch.core import quantize as QZ
from mmlspark_tpu_torch.models.networks import strict_f32

_MOMENTUM = 0.9
# nonzeros summed in one piece of a column's gradient: segment_reduce
# walks a segment in one thread, and a dense feature's column holds
# every row
_PIECE = 256


def _refuse_hand_set_int8(model) -> None:
    """``precision='int8'`` comes from ``quantize``: an f32 model (its
    weights carry no ``wq``) refuses it. A stage being loaded sets its
    params before its weights, so an unset ``weights`` passes."""
    w = model.get("weights")
    if model.get("precision") == "int8" and w is not None \
            and "wq" not in w:
        model._paramMap["precision"] = "f32"
        raise ValueError(
            "precision='int8' is set by quantize(calib), which returns a "
            "new model with int8 weights; it cannot be set by hand on an "
            "f32 model")


def _quantized(model, calib, weight: np.ndarray, percentile: float):
    """The int8 clone of a dense-featured linear model: ``weight`` (D, C)
    per-channel quantized, the standardized features' clip calibrated on
    ``calib`` (the JAX package's ``quantize``)."""
    w = model.get("weights")
    table = calib if isinstance(calib, DataTable) \
        else DataTable(dict(calib))
    X = _features_matrix(table, model.get_features_col())
    if X.shape[0] == 0:
        raise ValueError("quantize needs at least one calibration row")
    Xs = (X - w["mu"]) / w["sd"]
    wq, w_scale = QZ.quantize_weight(weight, axis=-1)
    cal = QZ.ActivationCalibrator(percentile=percentile)
    cal.observe("x", Xs)
    qweights = {k: np.asarray(v) for k, v in w.items()}
    qweights.update(wq=wq, w_scale=w_scale, x_scale=cal.scale("x"))
    out = type(model)(weights=qweights, precision="int8")
    out.set("featuresCol", model.get_features_col())
    out.set("predictionCol", model.get_prediction_col())
    return out


# ---------------------------------------------------------------------------
# the momentum loops
# ---------------------------------------------------------------------------


def _with_bias_column(X: torch.Tensor, c: int) -> torch.Tensor:
    """(N, D) -> (C, N, D + 1): the features and a ones column, one copy
    per candidate so every batched product reads plain strided blocks."""
    ones = torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)
    return torch.cat([X, ones], dim=1).expand(c, -1, -1).contiguous()


def _momentum_fit(Xb: torch.Tensor, Wb: torch.Tensor, lrs, l2s,
                  n_steps: int, residual) -> torch.Tensor:
    """The shared loop: ``n_steps`` momentum steps of C candidates at
    once, from ``Wb`` (C, D + 1, K), whose last row is the bias. The
    gradient is ``Xbᵀ residual(Xb Wb) + 2 l2 W``. Updates ``Wb`` in
    place and returns it."""
    c, d1, _ = Wb.shape
    dev = Wb.device
    lr = torch.as_tensor(np.asarray(lrs, np.float32), device=dev)
    l2 = torch.as_tensor(np.asarray(l2s, np.float32), device=dev)
    neg_lr = (-lr).view(c, 1, 1)
    # 2 l2 on the weight rows, 0 on the bias row
    decay = torch.zeros((c, d1, 1), dtype=torch.float32, device=dev)
    decay[:, :-1] = (2.0 * l2).view(c, 1, 1)
    XbT = Xb.transpose(1, 2)
    vel = torch.zeros_like(Wb)
    with strict_f32(), torch.no_grad():
        for _ in range(n_steps):
            g = torch.bmm(XbT, residual(torch.bmm(Xb, Wb)))
            g.addcmul_(Wb, decay)
            vel.mul_(_MOMENTUM).addcmul_(g, neg_lr)
            Wb.add_(vel)
    return Wb


def _logistic_residual(onehot: torch.Tensor):
    """d loss / d logits of the mean multinomial log-loss."""
    inv_n = 1.0 / max(onehot.shape[0], 1)

    def residual(logits: torch.Tensor) -> torch.Tensor:
        return torch.softmax(logits, dim=-1).sub_(onehot).mul_(inv_n)
    return residual


def _fit_logistic_batch(X: torch.Tensor, y: torch.Tensor, lrs, l2s,
                        n_steps: int, num_class: int,
                        W0: Optional[np.ndarray] = None,
                        b0: Optional[np.ndarray] = None
                        ) -> Dict[str, np.ndarray]:
    """C logistic fits on one standardized (N, D) float32 matrix on its
    device, one per (lr, l2) pair, from zeros or from ``W0`` / ``b0``
    (a warm start; the velocity restarts at zero). Returns ``W``
    (C, D, K) and ``b`` (C, K) as float32 numpy."""
    c, d = len(lrs), X.shape[1]
    Wb = torch.zeros((c, d + 1, num_class), dtype=torch.float32,
                     device=X.device)
    if W0 is not None:
        Wb[:, :d] = torch.as_tensor(np.asarray(W0, np.float32))
        Wb[:, d] = torch.as_tensor(np.asarray(b0, np.float32))
    onehot = torch.nn.functional.one_hot(
        y.long(), num_class).to(torch.float32)
    Wb = _momentum_fit(_with_bias_column(X, c), Wb, lrs, l2s, n_steps,
                       _logistic_residual(onehot))
    out = Wb.cpu().numpy()
    return {"W": out[:, :d], "b": out[:, d]}


def _fit_linear_batch(X: torch.Tensor, y: torch.Tensor, lrs, l2s,
                      n_steps: int, w0: Optional[np.ndarray] = None,
                      b0: Optional[float] = None) -> Dict[str, np.ndarray]:
    """C linear-regression fits (mean squared error) on one
    standardized matrix and standardized labels; see
    ``_fit_logistic_batch``. Returns ``w`` (C, D) and ``b`` (C,)."""
    c, d = len(lrs), X.shape[1]
    Wb = torch.zeros((c, d + 1, 1), dtype=torch.float32, device=X.device)
    if w0 is not None:
        Wb[:, :d, 0] = torch.as_tensor(np.asarray(w0, np.float32))
        Wb[:, d, 0] = float(np.float32(b0))
    target = y.to(torch.float32).view(1, -1, 1)
    scale = 2.0 / max(X.shape[0], 1)

    def residual(pred: torch.Tensor) -> torch.Tensor:
        return pred.sub_(target).mul_(scale)

    Wb = _momentum_fit(_with_bias_column(X, c), Wb, lrs, l2s, n_steps,
                       residual)
    out = Wb[:, :, 0].cpu().numpy()
    return {"w": out[:, :d], "b": out[:, d]}


def _column_pieces(col_ptr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Cut each column's run of CSC nonzeros into pieces of at most
    ``_PIECE``: (the pieces' lengths, the number of pieces of each
    column). Summing the pieces, then each column's piece sums, is a
    fixed order of the column's sum."""
    lengths = np.diff(col_ptr)
    pieces = -(-lengths // _PIECE)
    piece_len = np.full(int(pieces.sum()), _PIECE, np.int64)
    full = pieces > 0
    piece_len[np.cumsum(pieces)[full] - 1] = \
        lengths[full] - _PIECE * (pieces[full] - 1)
    return piece_len, pieces


def _fit_logistic_sparse(csr: CSRMatrix, y: np.ndarray, lr: float,
                         l2: float, n_steps: int, num_class: int,
                         dev: torch.device) -> Dict[str, np.ndarray]:
    """Sparse logistic regression from zero weights, without a dense
    (N, D) matrix: the forward gathers ``W[idx]`` over the padded
    (N, max_nnz) blocks of ``csr.padded_batch`` (padding entries have
    value 0 and add nothing); the weight gradient ``Xᵀ r`` is the sum,
    per column, of ``val * r[row]`` over the column's nonzeros in the
    CSC order of ``csr.csc()``, in pieces (``_column_pieces``; a fixed
    order, no atomics)."""
    n, d = csr.shape
    idx_np, val_np, _ = csr.padded_batch(0, n, max(1, csr.max_row_nnz()))
    idx = torch.as_tensor(idx_np, device=dev).long()
    val = torch.as_tensor(val_np, device=dev)
    col_ptr, row_np, cval_np = csr.csc()
    piece_len, col_pieces = (torch.as_tensor(a, device=dev)
                             for a in _column_pieces(col_ptr))
    rows = torch.as_tensor(row_np, device=dev).long()
    cval = torch.as_tensor(cval_np, device=dev).unsqueeze(1)
    onehot = torch.nn.functional.one_hot(
        torch.as_tensor(y, device=dev).long(), num_class).to(torch.float32)
    residual = _logistic_residual(onehot)
    W = torch.zeros((d, num_class), dtype=torch.float32, device=dev)
    b = torch.zeros(num_class, dtype=torch.float32, device=dev)
    vW, vb = torch.zeros_like(W), torch.zeros_like(b)
    neg_lr = -float(np.float32(lr))
    decay = 2.0 * float(np.float32(l2))
    with strict_f32(), torch.no_grad():
        for _ in range(n_steps):
            r = residual(torch.einsum("nm,nmk->nk", val, W[idx]) + b)
            gW = torch.segment_reduce(
                torch.segment_reduce(cval * r[rows], "sum",
                                     lengths=piece_len, axis=0),
                "sum", lengths=col_pieces, axis=0)
            gW.add_(W, alpha=decay)
            vW.mul_(_MOMENTUM).add_(gW, alpha=neg_lr)
            vb.mul_(_MOMENTUM).add_(r.sum(0), alpha=neg_lr)
            W.add_(vW)
            b.add_(vb)
    return {"W": W.cpu().numpy(), "b": b.cpu().numpy()}


def _sparse_logits(csr, W: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Host-side CSR @ W + b without densifying (inference path)."""
    n = csr.shape[0]
    rows = np.repeat(np.arange(n), np.diff(csr.indptr).astype(np.int64))
    logits = np.zeros((n, W.shape[1]), np.float64)
    np.add.at(logits, rows, W[csr.indices] * csr.data[:, None])
    return logits + b


class _Standardizer:
    """Feature standardization folded into the fitted params."""

    @staticmethod
    def compute(X: np.ndarray):
        mu = X.mean(axis=0)
        sd = X.std(axis=0)
        sd = np.where(sd < 1e-12, 1.0, sd)
        return mu, sd


def _device_f32(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def _linear_consts(model, weight_key: str, int8: bool,
                   scalars: Tuple[str, ...] = ()):
    """The ``make_consts`` of a linear model's device op: the weights
    read at call time as float32 host arrays (f32 scalars for the label
    statistics), which the fused plan ships as device tensors; an int8
    model's quantized weight, its scales and no f32 weight."""
    def make_consts():
        ww = model.get("weights")
        consts = {"b": np.asarray(ww["b"], np.float32),
                  "mu": np.asarray(ww["mu"], np.float32),
                  "sd": np.asarray(ww["sd"], np.float32)}
        for k in scalars:
            consts[k] = np.float32(ww[k])
        if int8:
            consts.update(wq=np.asarray(ww["wq"], np.int8),
                          w_scale=np.asarray(ww["w_scale"], np.float32),
                          x_scale=np.float32(ww["x_scale"]))
        else:
            consts[weight_key] = np.asarray(ww[weight_key], np.float32)
        return consts
    return make_consts


class TPULogisticRegression(Estimator, HasFeaturesCol, HasLabelCol,
                            HasPredictionCol, HasDevice):
    """Multinomial logistic regression; labels must be 0..K-1.

    Standardization depends on the feature column's storage: DENSE
    features are standardized (mean/std folded into the fitted params);
    SPARSE (CSR) features are NOT — centering would densify, so the raw
    values feed the solver directly (the reference's hashed-text
    pipeline behaves the same). The same data therefore trains to a
    different model dense vs sparse at identical stepSize/regParam;
    pre-scale sparse features if scale-invariance matters. ``fit`` runs
    on ``device``; the fitted model scores on the host."""

    maxIter = IntParam("gradient steps", default=300)
    regParam = FloatParam("L2 regularization", default=1e-4)
    stepSize = FloatParam("learning rate (dense features are "
                          "standardized first; sparse are not — see "
                          "class docstring)", default=0.5)

    def reads_columns(self, schema):
        return [self.get_features_col(), self.get_label_col()]

    def writes_columns(self, schema):
        return ["rawPrediction", "probability",
                self.get_prediction_col()]

    def fit(self, table: DataTable) -> "TPULogisticRegressionModel":
        dev = resolve_device(self.get("device"))
        y = np.asarray(table[self.get_label_col()], dtype=np.float64)
        num_class = int(y.max()) + 1 if len(y) else 2
        num_class = max(num_class, 2)
        feats = table.column(self.get_features_col())
        if isinstance(feats, CSRMatrix):
            # no standardization (it would densify), gather blocks
            # instead of a dense matrix
            weights = _fit_logistic_sparse(
                feats, y, self.get("stepSize"), self.get("regParam"),
                self.get("maxIter"), num_class, dev)
        else:
            X = _features_matrix(table, self.get_features_col())
            mu, sd = _Standardizer.compute(X)
            params = _fit_logistic_batch(
                _device_f32((X - mu) / sd, dev), _device_f32(y, dev),
                [self.get("stepSize")], [self.get("regParam")],
                self.get("maxIter"), num_class)
            weights = {"W": params["W"][0], "b": params["b"][0],
                       "mu": mu, "sd": sd}
        return self._model(weights)

    def _model(self, weights) -> "TPULogisticRegressionModel":
        model = TPULogisticRegressionModel(weights=weights)
        model.set("featuresCol", self.get_features_col())
        model.set("predictionCol", self.get_prediction_col())
        return model

    def partial_fit(self, table: DataTable,
                    model: Optional["TPULogisticRegressionModel"] = None,
                    ) -> "TPULogisticRegressionModel":
        """Incremental refresh: warm-start from ``model``'s weights and
        run ``maxIter`` momentum steps on this batch only, no refit over
        history. ``model=None`` degenerates to ``fit``.

        The fit-time feature standardization (mu/sd) is FROZEN at the
        first fit: new batches standardize with the original stats, so
        the weight space stays consistent across updates (feature drift
        is surfaced by ``core.metrics.DriftMonitor``, not silently
        absorbed into shifting normalization). Deterministic: the same
        (model, batch) always produces the same new model, and the
        class count is pinned by the warm-started weight shape — labels
        outside it are an error, not a silent resize."""
        if model is None:
            return self.fit(table)
        w = model.get("weights")
        if "mu" not in w:
            raise ValueError(
                "partial_fit warm start requires a dense-featured model "
                "(sparse models carry no frozen standardization stats)")
        feats = table.column(self.get_features_col())
        if isinstance(feats, CSRMatrix):
            raise ValueError(
                "partial_fit requires dense features (the warm-started "
                "kernel standardizes against the frozen fit-time stats)")
        y = np.asarray(table[self.get_label_col()], dtype=np.float64)
        if len(y) == 0:
            # an empty refresh window is a no-op, not an update: zero
            # rows would mean() to NaN and silently corrupt the weights
            return model
        num_class = int(np.asarray(w["W"]).shape[1])
        if int(y.max()) + 1 > num_class:
            raise ValueError(
                f"label {int(y.max())} outside the warm-started model's "
                f"{num_class} classes; refit from scratch to add classes")
        dev = resolve_device(self.get("device"))
        X = _features_matrix(table, self.get_features_col())
        params = _fit_logistic_batch(
            _device_f32((X - w["mu"]) / w["sd"], dev), _device_f32(y, dev),
            [self.get("stepSize")], [self.get("regParam")],
            self.get("maxIter"), num_class, W0=w["W"], b0=w["b"])
        return self._model({"W": params["W"][0], "b": params["b"][0],
                            "mu": w["mu"], "sd": w["sd"]})


class TPULogisticRegressionModel(Model, HasFeaturesCol, HasPredictionCol):
    weights = PyTreeParam("W/b/mu/sd arrays", default=None)
    # 'int8' models carry per-channel-quantized W (wq/w_scale) and a
    # calibrated per-tensor activation scale (x_scale) next to the f32
    # arrays; set by quantize(), surfaced as the serving precision label
    precision = EnumParam(["f32", "int8"],
                          "inference precision (set by quantize())",
                          default="f32")

    def _on_param_change(self, name: str) -> None:
        if name in ("precision", "weights"):
            _refuse_hand_set_int8(self)

    def reads_columns(self, schema):
        return [self.get_features_col()]

    def writes_columns(self, schema):
        return ["rawPrediction", "probability",
                self.get_prediction_col()]

    def device_op(self, schema):
        """Fusion hook (core/fusion.py): standardize + logits + softmax
        + argmax as f32 torch ops on the device. The host ``transform``
        computes the same formulas in float64 numpy, so fused
        predictions match except on near ties and probabilities agree
        to f32 rounding; ``transform_staged`` (the same function run
        stage-at-a-time) is bitwise the fused path."""
        from mmlspark_tpu_torch.core import fusion as FZ
        w = self.get("weights")
        if w is None or "mu" not in w:
            return None    # sparse-featured models score on the host
        feat = self.get_features_col()
        pred_col = self.get_prediction_col()
        binary = int(np.asarray(w["W"]).shape[1]) == 2
        int8 = self.get("precision") == "int8"
        make_consts = _linear_consts(self, "W", int8)

        def fn(consts, env, _f=feat, _p=pred_col, _bin=binary,
               _int8=int8):
            Xs = (env[_f] - consts["mu"]) / consts["sd"]
            if _int8:
                # int8 tensor-core product + f32 dequant epilogue
                logits = QZ.int8_matmul(
                    Xs, consts["wq"], consts["x_scale"],
                    consts["w_scale"]) + consts["b"]
            else:
                logits = Xs @ consts["W"] + consts["b"]
            m = torch.amax(logits, dim=1, keepdim=True)
            e = torch.exp(logits - m)
            prob = e / torch.sum(e, dim=1, keepdim=True)
            pred = torch.argmax(prob, dim=1).to(torch.float32)
            if _bin:
                raw = torch.stack([logits[:, 0] - logits[:, 1],
                                   logits[:, 1] - logits[:, 0]], dim=1)
            else:
                raw = logits
            return {"rawPrediction": raw, "probability": prob, _p: pred}

        return FZ.DeviceOp(
            self, reads=[feat],
            writes=["rawPrediction", "probability", pred_col],
            fn=fn, make_consts=make_consts,
            out_fields={"rawPrediction": Field("rawPrediction", VECTOR),
                        "probability": Field("probability", VECTOR),
                        pred_col: Field(pred_col, F64)},
            out_dtypes={"rawPrediction": np.float64,
                        "probability": np.float64,
                        pred_col: np.float64},
            name=(f"{type(self).__name__}:{self.uid}:int8"
                  if int8 else None))

    def quantize(self, calib: DataTable, percentile: float = 100.0
                 ) -> "TPULogisticRegressionModel":
        """Int8 post-training quantization (core/quantize.py): W gets
        per-class-channel symmetric scales, the standardized feature
        activations get a per-tensor clip calibrated on ``calib``'s
        feature rows, and the returned NEW model scores through an
        int8 x int8 -> i32 matmul with an f32 dequant epilogue on the
        host. This (f32) model is untouched — the accuracy oracle and
        the rollback target."""
        w = self.get("weights")
        if w is None or "mu" not in w:
            raise ValueError(
                "quantize requires a dense-featured model (sparse models "
                "score through the host CSR path and carry no "
                "standardization stats to calibrate against)")
        return _quantized(self, calib, np.asarray(w["W"]), percentile)

    def drift_monitor(self):
        """A ``core.metrics.DriftMonitor`` seeded with this model's
        FIT-TIME feature statistics (mu/sd) — hand it to
        ``json_scoring_pipeline`` so served traffic's per-feature
        mean/var/null drift vs training shows up on /healthz."""
        from mmlspark_tpu_torch.core.metrics import DriftMonitor
        w = self.get("weights")
        if "mu" not in w:
            raise ValueError("sparse-featured models carry no fit-time "
                             "standardization stats to drift against")
        return DriftMonitor(w["mu"], np.asarray(w["sd"]) ** 2)

    def transform(self, table: DataTable) -> DataTable:
        w = self.get("weights")
        feats = table.column(self.get_features_col())
        if isinstance(feats, CSRMatrix) and "mu" not in w:
            logits = _sparse_logits(feats, np.asarray(w["W"]),
                                    np.asarray(w["b"]))
            return self._attach_scores(table, logits)
        return self.transform_from_matrix(
            table, _features_matrix(table, self.get_features_col()))

    def transform_from_matrix(self, table: DataTable,
                              X: np.ndarray) -> DataTable:
        """``transform`` with the dense (N, D) extraction hoisted by the
        caller — the CV hot path scores every candidate against ONE
        cached fold matrix instead of re-extracting it per candidate."""
        w = self.get("weights")
        if "mu" in w:
            X = (X - w["mu"]) / w["sd"]
        if self.get("precision") == "int8":
            # integer accumulation is exact: the same accumulator as the
            # JAX package's host path, bit for bit
            logits = QZ.int8_matmul_host(X, w["wq"], w["x_scale"],
                                         w["w_scale"]) + w["b"]
            return self._attach_scores(table, logits)
        return self._attach_scores(table, X @ w["W"] + w["b"])

    def _attach_scores(self, table: DataTable,
                       logits: np.ndarray) -> DataTable:
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        prob = e / e.sum(axis=1, keepdims=True)
        pred = prob.argmax(axis=1).astype(np.float64)
        if prob.shape[1] == 2:
            raw = np.stack([-logits[:, 1] + logits[:, 0],
                            logits[:, 1] - logits[:, 0]], axis=1)
        else:
            raw = logits
        return (table
                .with_column("rawPrediction", raw.astype(np.float64),
                             Field("rawPrediction", VECTOR))
                .with_column("probability", prob.astype(np.float64),
                             Field("probability", VECTOR))
                .with_column(self.get_prediction_col(), pred,
                             Field(self.get_prediction_col(), F64)))

    def transform_schema(self, schema: Schema) -> Schema:
        return (schema
                .add_or_replace(Field("rawPrediction", VECTOR))
                .add_or_replace(Field("probability", VECTOR))
                .add_or_replace(Field(self.get_prediction_col(), F64)))


class TPULinearRegression(Estimator, HasFeaturesCol, HasLabelCol,
                          HasPredictionCol, HasDevice):
    maxIter = IntParam("gradient steps", default=300)
    regParam = FloatParam("L2 regularization", default=1e-4)
    stepSize = FloatParam("learning rate", default=0.1)

    def reads_columns(self, schema):
        return [self.get_features_col(), self.get_label_col()]

    def writes_columns(self, schema):
        return [self.get_prediction_col()]

    def fit(self, table: DataTable) -> "TPULinearRegressionModel":
        dev = resolve_device(self.get("device"))
        X = _features_matrix(table, self.get_features_col())
        y = np.asarray(table[self.get_label_col()], dtype=np.float64)
        mu, sd = _Standardizer.compute(X)
        y_mu, y_sd = float(y.mean()), float(y.std() or 1.0)
        params = _fit_linear_batch(
            _device_f32((X - mu) / sd, dev),
            _device_f32((y - y_mu) / y_sd, dev),
            [self.get("stepSize")], [self.get("regParam")],
            self.get("maxIter"))
        return self._model({"w": params["w"][0], "b": params["b"][0],
                            "mu": mu, "sd": sd, "y_mu": y_mu,
                            "y_sd": y_sd})

    def _model(self, weights) -> "TPULinearRegressionModel":
        model = TPULinearRegressionModel(weights=weights)
        model.set("featuresCol", self.get_features_col())
        model.set("predictionCol", self.get_prediction_col())
        return model

    def partial_fit(self, table: DataTable,
                    model: Optional["TPULinearRegressionModel"] = None,
                    ) -> "TPULinearRegressionModel":
        """Warm-started incremental update (see
        ``TPULogisticRegression.partial_fit``): feature AND label
        standardization stats are frozen at the first fit, the momentum
        loop restarts from the fitted weights on this batch only."""
        if model is None:
            return self.fit(table)
        w = model.get("weights")
        y = np.asarray(table[self.get_label_col()], dtype=np.float64)
        if len(y) == 0:
            return model   # empty refresh window: no-op (NaN guard)
        dev = resolve_device(self.get("device"))
        X = _features_matrix(table, self.get_features_col())
        params = _fit_linear_batch(
            _device_f32((X - w["mu"]) / w["sd"], dev),
            _device_f32((y - w["y_mu"]) / w["y_sd"], dev),
            [self.get("stepSize")], [self.get("regParam")],
            self.get("maxIter"), w0=w["w"], b0=w["b"])
        return self._model({"w": params["w"][0], "b": params["b"][0],
                            "mu": w["mu"], "sd": w["sd"],
                            "y_mu": w["y_mu"], "y_sd": w["y_sd"]})


class TPULinearRegressionModel(Model, HasFeaturesCol, HasPredictionCol):
    weights = PyTreeParam("w/b/mu/sd arrays", default=None)
    precision = EnumParam(["f32", "int8"],
                          "inference precision (set by quantize())",
                          default="f32")

    def _on_param_change(self, name: str) -> None:
        if name in ("precision", "weights"):
            _refuse_hand_set_int8(self)

    def reads_columns(self, schema):
        return [self.get_features_col()]

    def writes_columns(self, schema):
        return [self.get_prediction_col()]

    def device_op(self, schema):
        """Fusion hook: standardize + dot + un-standardize in f32 (see
        ``TPULogisticRegressionModel.device_op``); int8 models route the
        dot through the quantized matmul with its f32 dequant epilogue."""
        from mmlspark_tpu_torch.core import fusion as FZ
        if self.get("weights") is None:
            return None
        feat = self.get_features_col()
        pred_col = self.get_prediction_col()
        int8 = self.get("precision") == "int8"
        make_consts = _linear_consts(self, "w", int8, ("y_mu", "y_sd"))

        def fn(consts, env, _f=feat, _p=pred_col, _int8=int8):
            Xs = (env[_f] - consts["mu"]) / consts["sd"]
            if _int8:
                dot = QZ.int8_matmul(Xs, consts["wq"],
                                     consts["x_scale"],
                                     consts["w_scale"])[:, 0]
            else:
                dot = Xs @ consts["w"]
            pred = (dot + consts["b"]) * consts["y_sd"] \
                + consts["y_mu"]
            return {_p: pred}

        return FZ.DeviceOp(
            self, reads=[feat], writes=[pred_col], fn=fn,
            make_consts=make_consts,
            out_fields={pred_col: Field(pred_col, F64)},
            out_dtypes={pred_col: np.float64},
            name=(f"{type(self).__name__}:{self.uid}:int8"
                  if int8 else None))

    def quantize(self, calib: DataTable, percentile: float = 100.0
                 ) -> "TPULinearRegressionModel":
        """Int8 PTQ of the regression weight vector (treated as a
        (D, 1) matmul — one output channel, one weight scale) with the
        standardized-feature activation clip calibrated on ``calib``.
        See ``TPULogisticRegressionModel.quantize``."""
        w = self.get("weights")
        if w is None:
            raise ValueError("quantize requires a fitted model "
                             "(weights is None)")
        return _quantized(self, calib, np.asarray(w["w"]).reshape(-1, 1),
                          percentile)

    def drift_monitor(self):
        """Fit-time feature-stat DriftMonitor (see
        ``TPULogisticRegressionModel.drift_monitor``)."""
        from mmlspark_tpu_torch.core.metrics import DriftMonitor
        w = self.get("weights")
        return DriftMonitor(w["mu"], np.asarray(w["sd"]) ** 2)

    def transform(self, table: DataTable) -> DataTable:
        return self.transform_from_matrix(
            table, _features_matrix(table, self.get_features_col()))

    def transform_from_matrix(self, table: DataTable,
                              X: np.ndarray) -> DataTable:
        """``transform`` with the (N, D) extraction hoisted by the
        caller (see TPULogisticRegressionModel.transform_from_matrix)."""
        w = self.get("weights")
        Xs = (X - w["mu"]) / w["sd"]
        if self.get("precision") == "int8":
            dot = QZ.int8_matmul_host(Xs, w["wq"], w["x_scale"],
                                      w["w_scale"])[:, 0]
        else:
            dot = Xs @ w["w"]
        pred = (dot + w["b"]) * w["y_sd"] + w["y_mu"]
        return table.with_column(self.get_prediction_col(),
                                 np.asarray(pred, dtype=np.float64),
                                 Field(self.get_prediction_col(), F64))

    def transform_schema(self, schema: Schema) -> Schema:
        return schema.add_or_replace(Field(self.get_prediction_col(), F64))
