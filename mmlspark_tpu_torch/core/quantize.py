"""Int8 post-training quantization of the PyTorch port (see
``mmlspark_tpu/core/quantize.py``).

Integer-arithmetic-only inference (Jacob et al., CVPR 2018): weights
quantize to int8 with **per-output-channel symmetric scales** computed
from the fitted weights, activations quantize **per-tensor** with a clip
range calibrated on a held-out batch, and every quantized matmul is an
int8 x int8 -> int32 product with a float32 dequantization epilogue:

    y = (q(x) . q(W)) * (s_x * s_w) + b        # accumulate in i32,
                                               # dequant + bias in f32

The host half (``QMAX``, ``per_channel_scales``, ``quantize_weight``,
``act_scale``, ``int8_matmul_host``) is the JAX package's, copied, so the
same f32 weights give the same int8 values and scales bit for bit. The
device half is torch: ``int8_matmul``'s product is ``torch._int_mm`` —
on the card cuBLASLt's int8 tensor-core GEMM (the JAX package's product
is an XLA ``dot_general`` outside any Pallas kernel, so this is a
library call, not a ported kernel), on the CPU oneDNN's; both accumulate
in int32 exactly (the plain int32 matmul gives the same integers ~100x
slower). ``quantize_weight_t`` is ``quantize_weight`` on a tensor's own
device, in float64 there, with the same result bit for bit. Given the same
f32 inputs its int32 accumulator, and so its output, equals
``int8_matmul_host``'s bit for bit: the activation is divided by its
scale in f32 (a true division: the scale is a device tensor, never a
CPU scalar, which torch would turn into a reciprocal multiply on the
card), rounded half to even (``torch.round``, like numpy and XLA), and
the epilogue forms ``s_x * s_w`` in f32 before it multiplies.

What quantizes: every dense layer of a zoo network, i.e. every call of
``models/networks.py::_dense`` — the counterpart of flax's ``nn.Dense``,
which the JAX package intercepts. ``calibrate_module`` and
``quantize_module`` install a per-call interceptor there
(``networks.DENSE_HOOK``) keyed by the layer's module path, written with
``/`` as flax writes it (``block_0/qkv``, ``lm_head``); nothing of the
f32 model is mutated, so it stays the accuracy oracle and the rollback
target. Conv kernels, embeddings, LayerNorm / BatchNorm and LSTM cells
stay f32 (the LSTM's gates are not ``_dense`` calls, as flax's
``OptimizedLSTMCell`` computes them outside ``nn.Dense``). An int8 layer
casts its input to f32 and adds its bias in f32, whatever the layer's
``dtype``.

``LAUNCHES["int8_mm"]`` counts the int8 GEMMs launched on the card.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

# int8 symmetric range: +-127 (not -128) so negation stays exact and the
# zero point is exactly 0 — the standard symmetric-PTQ choice
QMAX = 127.0

# floor below which a scale is clamped: a dead channel (all-zero weights
# or a constant-zero activation) must not divide by zero
_SCALE_FLOOR = 1e-12

# key under which the quantized tensors ride in the TPUModel weights
# pytree, next to the untouched f32 weights (the oracle/rollback copy)
QUANT_KEY = "__quant__"

# int8 GEMMs launched on the card (torch._int_mm); CPU products never count
LAUNCHES: Dict[str, int] = {"int8_mm": 0}
_LAUNCH_LOCK = threading.Lock()

# torch._int_mm on the card wants more than 16 rows, K >= 16 and a
# multiple of 8, and N a multiple of 8; smaller operands are zero-padded
# (zero rows / columns add nothing to the integer sums). Its right
# operand runs ~5x faster column-major (cuBLASLt's TN int8 layout) than
# row-major on an H100, so ``mm_operand`` lays a weight out that way once.
_MM_MIN_ROWS = 17
_MM_MIN_K = 16
_MM_ALIGN = 8


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        LAUNCHES["int8_mm"] = 0


# ---------------------------------------------------------------------------
# scale computation (host, at quantization time) — the JAX package's
# ---------------------------------------------------------------------------


def per_channel_scales(w: np.ndarray, axis: int = -1) -> np.ndarray:
    """Symmetric per-output-channel scales for a weight matrix: one
    scale per slice along ``axis`` (the output-channel axis; -1 for the
    (D, K) layout every Dense/linear weight here uses), computed as
    max|w| / 127 over the remaining axes."""
    w = np.asarray(w, dtype=np.float64)
    reduce_axes = tuple(i for i in range(w.ndim)
                        if i != (axis % w.ndim))
    amax = np.abs(w).max(axis=reduce_axes)
    return np.maximum(amax / QMAX, _SCALE_FLOOR).astype(np.float32)


def quantize_weight(w: np.ndarray, axis: int = -1
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Weight -> (int8 values, f32 per-channel scales). Round-to-nearest
    -even (numpy/XLA agree), clipped to the symmetric +-127 range."""
    scale = per_channel_scales(w, axis=axis)
    shape = [1] * np.ndim(w)
    shape[axis % np.ndim(w)] = -1
    q = np.clip(np.round(np.asarray(w, np.float64)
                         / scale.reshape(shape)), -QMAX, QMAX)
    return q.astype(np.int8), scale


def act_scale(amax: float) -> np.float32:
    """Per-tensor activation scale from a calibrated |x| clip value."""
    return np.float32(max(float(amax), _SCALE_FLOOR) / QMAX)


class ActivationCalibrator:
    """Running per-tensor |x| statistics over calibration batches.

    ``percentile=100`` (default) clips at the observed absolute max —
    exact range, sensitive to outliers; for a tensor it is taken on the
    tensor's device (a max is exact, so it equals the JAX package's f64
    host max). Lower percentiles (e.g. 99.9) trade a little saturation
    on the tail for finer resolution of the bulk; they are computed with
    ``np.percentile`` on the host in f64, as the JAX package does
    (``torch.quantile`` refuses inputs above 2**24 values). The clip is
    the max over batches of the per-batch value, so one calibration
    batch is enough and more batches only widen it. Thread-safe."""

    def __init__(self, percentile: float = 100.0):
        if not 0.0 < percentile <= 100.0:
            raise ValueError(f"percentile must be in (0, 100]: "
                             f"{percentile}")
        self.percentile = float(percentile)
        self._amax: Dict[str, float] = {}
        self._lock = threading.Lock()

    def observe(self, key: str, x) -> None:
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.numel() == 0:
                return
            if self.percentile >= 100.0:
                a = float(x.abs().amax())
            else:
                a = float(np.percentile(
                    np.abs(x.float().cpu().numpy().astype(np.float64)),
                    self.percentile))
        else:
            x = np.abs(np.asarray(x, dtype=np.float64))
            if x.size == 0:
                return
            a = float(x.max()) if self.percentile >= 100.0 \
                else float(np.percentile(x, self.percentile))
        with self._lock:
            if key not in self._amax or a > self._amax[key]:
                self._amax[key] = a

    def amax(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._amax)

    def scale(self, key: str) -> np.float32:
        with self._lock:
            if key not in self._amax:
                raise KeyError(
                    f"no calibration observed for {key!r}; "
                    f"have {sorted(self._amax)}")
            return act_scale(self._amax[key])


# ---------------------------------------------------------------------------
# the device path
# ---------------------------------------------------------------------------


def _as_scale(s, device: torch.device) -> torch.Tensor:
    """A scale as an f32 tensor on ``device`` (a 0-dim one for a
    per-tensor scale), so division by it is a true tensor division."""
    if isinstance(s, torch.Tensor):
        return s.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(s, np.float32), device=device)


def quantize_act(x: torch.Tensor, x_scale) -> torch.Tensor:
    """Per-tensor activation quantization on ``x``'s device: divide by
    the scale in f32, round half to even, saturate to +-127. NaN inputs
    quantize to 0 (as the host mirror does); ``int8_matmul`` re-injects
    the NaN in its epilogue."""
    q = x.float() / _as_scale(x_scale, x.device)
    q.round_().clamp_(-QMAX, QMAX).nan_to_num_(nan=0.0)
    return q.to(torch.int8)


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def quantize_weight_t(w: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_weight(w, axis=-1)`` of a (K, N) tensor on its own
    device: the same float64 arithmetic (max|w| / 127 per output channel,
    clamped at the floor, a correctly rounded float64 division, round
    half to even, +-127), so the same int8 values and float32 scales bit
    for bit. The divisors are tensors: torch turns a division by a CPU
    scalar into a reciprocal multiply on the card."""
    w64 = w.detach().to(torch.float64)
    qmax = torch.tensor(QMAX, dtype=torch.float64, device=w.device)
    amax = w64.abs().amax(dim=0)
    scale = torch.clamp(amax / qmax, min=_SCALE_FLOOR).to(torch.float32)
    q = torch.round(w64 / scale.to(torch.float64)).clamp_(-QMAX, QMAX)
    return q.to(torch.int8), scale


def _is_operand(b: torch.Tensor) -> bool:
    k, n = b.shape
    return (k % _MM_ALIGN == 0 and k >= _MM_MIN_K and n % _MM_ALIGN == 0
            and b.stride(0) == 1 and b.stride(1) == k)


def mm_operand(wq: torch.Tensor) -> torch.Tensor:
    """A (K, N) int8 weight as ``torch._int_mm``'s right operand on the
    card: zero-padded to the K and N it takes, column-major. A CPU
    tensor is returned as it is."""
    if wq.device.type != "cuda" or _is_operand(wq):
        return wq
    k, n = wq.shape
    kp = max(_ceil_to(k, _MM_ALIGN), _MM_MIN_K)
    out = torch.zeros((_ceil_to(n, _MM_ALIGN), kp), dtype=torch.int8,
                      device=wq.device)
    out[:n, :k] = wq.t()
    return out.t()


def int8_mm(a: torch.Tensor, b: torch.Tensor,
            n: Optional[int] = None) -> torch.Tensor:
    """Exact (M, K) int8 x (K, N) int8 -> (M, n) int32 (``n`` defaults to
    N; pass the unpadded width with an ``mm_operand``): ``torch._int_mm``,
    on the card with ``a``'s rows and K zero-padded to what it takes
    (counted in ``LAUNCHES``)."""
    n = b.shape[1] if n is None else n
    if a.device.type != "cuda":
        return torch._int_mm(a.contiguous(), b.contiguous())[:, :n]
    b = mm_operand(b)
    m, k = a.shape
    kp = b.shape[0]
    if m < _MM_MIN_ROWS or k != kp:
        pad = torch.zeros((max(m, _MM_MIN_ROWS), kp), dtype=torch.int8,
                          device=a.device)
        pad[:m, :k] = a
        a = pad
    out = torch._int_mm(a.contiguous(), b)
    with _LAUNCH_LOCK:
        LAUNCHES["int8_mm"] += 1
    return out[:m, :n]


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, x_scale,
                w_scale, operand: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """The quantized matmul: quantize ``x`` per-tensor on its device,
    contract its last axis against int8 weights ``wq`` (K, N) with an
    int32 accumulator, then dequantize in float32: ``acc * (s_x * s_w)``.
    ``operand`` is ``mm_operand(wq)`` when the caller keeps one. NaN rows
    propagate: an integer accumulator cannot carry NaN, so the epilogue
    puts it back wherever the f32 oracle would have produced one."""
    dev = x.device
    xs = _as_scale(x_scale, dev)
    ws = _as_scale(w_scale, dev)
    lead = x.shape[:-1]
    n = wq.shape[1]
    xq = quantize_act(x, xs).reshape(-1, x.shape[-1])
    acc = int8_mm(xq, operand if operand is not None else wq.to(dev), n)
    out = acc.float().mul_(xs * ws)
    nan_row = torch.isnan(x).any(dim=-1, keepdim=True).reshape(-1, 1)
    out.masked_fill_(nan_row, float("nan"))
    return out.reshape(lead + (n,))


def int8_matmul_host(x: np.ndarray, wq: np.ndarray, x_scale,
                     w_scale: np.ndarray) -> np.ndarray:
    """Numpy mirror of ``int8_matmul``: the activation quotient is
    computed in f32 exactly like the device path (so identical input
    bits quantize identically) and integer accumulation is exact, so
    host and device agree bit-for-bit on the i32 accumulator GIVEN the
    same f32 inputs; the f32 dequant multiply matches the device's f32
    epilogue. Used by the quantized linear models' host ``transform``."""
    x = np.asarray(x)
    q = (x.astype(np.float32) / np.float32(x_scale)).astype(np.float32)
    with np.errstate(invalid="ignore"):
        xq = np.clip(np.round(q), -QMAX, QMAX)
    xq = np.nan_to_num(xq, nan=0.0).astype(np.int8)
    acc = xq.astype(np.int32) @ wq.astype(np.int32)
    out = acc.astype(np.float32) * (
        np.float32(x_scale) * np.asarray(w_scale, np.float32))
    nan_row = np.isnan(x.astype(np.float32)).any(axis=-1, keepdims=True)
    return np.where(nan_row, np.float32(np.nan), out)


# ---------------------------------------------------------------------------
# module quantization (the TPUModel zoo path)
# ---------------------------------------------------------------------------


def dense_paths(module: nn.Module) -> Dict[nn.Module, str]:
    """Every ``nn.Linear`` of ``module`` -> its flax-style path
    (``block_0/qkv``)."""
    return {mod: name.replace(".", "/")
            for name, mod in module.named_modules()
            if isinstance(mod, nn.Linear)}


class _DenseHook:
    """The ``networks.DENSE_HOOK`` of one forward: observe each dense
    layer's input (``calib``) or run its int8 product (``quant``)."""

    def __init__(self, paths: Dict[nn.Module, str],
                 calib: Optional[ActivationCalibrator] = None,
                 quant: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                 operands: Optional[Dict[str, Tuple[torch.Tensor,
                                                    torch.Tensor]]] = None):
        self.paths, self.calib, self.quant = paths, calib, quant
        # path -> (the int8 weight, its mm_operand), kept by the modelFn
        self.operands = operands if operands is not None else {}

    def __call__(self, x: torch.Tensor, lin: nn.Linear, dtype):
        path = self.paths.get(lin)
        if path is None:
            return None
        if self.calib is not None:
            self.calib.observe(path, x)
            return None
        q = self.quant.get(path)
        if q is None:
            return None
        y = int8_matmul(x.float(), q["wq"], q["x_scale"], q["w_scale"],
                        operand=self._operand(path, q["wq"]))
        if lin.bias is not None:
            y.add_(lin.bias.float())
        return y


    def _operand(self, path: str, wq: torch.Tensor) -> torch.Tensor:
        """``mm_operand(wq)``, made again only when ``wq`` is another
        tensor (the weights moved)."""
        src, op = self.operands.get(path, (None, None))
        if src is not wq:
            op = mm_operand(wq)
            self.operands[path] = (wq, op)
        return op


def _run_with_hook(model_fn, weights, inputs, hook: _DenseHook):
    from mmlspark_tpu_torch.models import networks
    token = networks.DENSE_HOOK.set(hook)
    try:
        return model_fn(weights, inputs)
    finally:
        networks.DENSE_HOOK.reset(token)


def calibrate_module(model_fn, weights: Dict[str, torch.Tensor],
                     calib_inputs: Dict[str, torch.Tensor],
                     percentile: float = 100.0) -> ActivationCalibrator:
    """Run the calibration inputs through the f32 model once (one
    forward, as the JAX package's ``calibrate_flax``), capturing every
    dense layer's input |x| range (per-tensor) under its path.
    ``model_fn`` is a module ``modelFn`` (``.module``) of TPUModel."""
    calib = ActivationCalibrator(percentile=percentile)
    with torch.inference_mode():
        _run_with_hook(model_fn, weights, calib_inputs,
                       _DenseHook(dense_paths(model_fn.module), calib))
    return calib


class QuantizedModuleApply:
    """``modelFn`` of an int8 TPUModel: the f32 model's ``modelFn`` run
    with every calibrated dense layer replaced by the int8 product (+ the
    layer's f32 bias). The quantized tensors travel in the weights pytree
    under ``QUANT_KEY``, so they reach the card with the other weights."""

    def __init__(self, base):
        self.base = base
        self.module = base.module
        self.int_input = bool(getattr(base, "int_input", False))
        self.vocab_size = getattr(base, "vocab_size", None)
        self._paths: Optional[Dict[nn.Module, str]] = None
        self._operands: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_paths"] = None
        state["_operands"] = {}
        state["module"] = None       # the base's pickle carries it
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.module = self.base.module

    def __call__(self, weights: Dict[str, Any],
                 inputs: Dict[str, torch.Tensor]):
        if self._paths is None:
            self._paths = dense_paths(self.module)
        quant = weights[QUANT_KEY]
        params = {k: v for k, v in weights.items() if k != QUANT_KEY}
        return _run_with_hook(self.base, params, inputs,
                              _DenseHook(self._paths, quant=quant,
                                         operands=self._operands))


def quantize_module(model_fn, weights: Dict[str, torch.Tensor],
                    calib_inputs: Dict[str, torch.Tensor],
                    percentile: float = 100.0
                    ) -> Tuple[QuantizedModuleApply, Dict[str, Any]]:
    """Post-training-quantize a module model: calibrate activation
    ranges on ``calib_inputs``, quantize every calibrated dense kernel
    per channel (the flax kernel is the torch weight transposed), and
    return
    ``(quantized modelFn, weights pytree)`` where the pytree is the
    ORIGINAL weights plus the ``QUANT_KEY`` subtree of ``{path: {wq (K,
    N) int8, w_scale (N,) f32, x_scale () f32}}`` on the weights'
    device (``quantize_weight_t``: the JAX package's ``quantize_weight``
    of the same kernel, bit for bit)."""
    calib = calibrate_module(model_fn, weights, calib_inputs, percentile)
    amax = calib.amax()
    quant: Dict[str, Dict[str, torch.Tensor]] = {}
    for mod, path in dense_paths(model_fn.module).items():
        if path not in amax:
            continue   # layer never saw calibration traffic: stays f32
        w = weights[f"{path.replace('/', '.')}.weight"]
        wq, w_scale = quantize_weight_t(w.t())
        quant[path] = {
            "wq": wq.contiguous(), "w_scale": w_scale,
            "x_scale": torch.tensor(act_scale(amax[path]),
                                    dtype=torch.float32, device=w.device)}
    if not quant:
        raise ValueError(
            "nothing to quantize: no calibrated dense layers found "
            "(conv/LSTM/embedding layers stay f32 by design)")
    qweights: Dict[str, Any] = dict(weights)
    qweights[QUANT_KEY] = quant
    return QuantizedModuleApply(model_fn), qweights


def quantized_paths(weights: Dict[str, Any]) -> List[str]:
    """The layer paths an int8 weights pytree quantizes, sorted."""
    return sorted(weights.get(QUANT_KEY, {}))


# ---------------------------------------------------------------------------
# generic stage quantization
# ---------------------------------------------------------------------------


def quantize_stage(stage, calib_table,
                   percentile: float = 100.0) -> Tuple[Any, bool]:
    """Quantize one fitted stage if it supports it: returns
    ``(stage_or_quantized_clone, was_quantized)``. Stages advertise
    support through a duck-typed ``quantize(calib_table, percentile=)``
    hook that must return a NEW stage (the f32 original stays the
    oracle)."""
    hook = getattr(stage, "quantize", None)
    if not callable(hook):
        return stage, False
    return hook(calib_table, percentile=percentile), True


def stage_precision(stage) -> str:
    """A stage's serving precision label: 'int8' when the stage carries
    quantized weights, else 'f32'."""
    get = getattr(stage, "get", None)
    if callable(get):
        try:
            p = get("precision")
            if p:
                return str(p)
        except Exception:  # noqa: BLE001 — stages without the param
            pass
    return str(getattr(stage, "precision", "f32"))

