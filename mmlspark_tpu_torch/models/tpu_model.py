"""TPUModel of the PyTorch port — batched DNN inference over tables (see
``mmlspark_tpu/models/tpu_model.py``).

The model is ``modelFn(weights, inputs: dict[str, Tensor]) -> dict |
Tensor``; ``from_module`` wraps an ``nn.Module`` (the counterpart of
``from_flax``), ``from_fn`` any such callable. ``transform`` cuts the
table into ``batchSize`` micro-batches, pads a ragged one up to the next
power-of-two bucket (edge-padded, so padded rows stay valid inputs),
ships each through pinned host memory with ``non_blocking`` uploads
while the previous one runs, runs the forward under
``torch.inference_mode()``, and reads batch k back while batch k+1 runs
(its real rows, through pinned memory; bfloat16 outputs widen to float32
on the host). Token-id models
(``int_input``) get int32 ids on the host, widened to int64 on the card.

The card is the default device (``device`` Param, ``None`` = cuda);
without one it raises unless ``device='cpu'`` was asked for.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mmlspark_tpu_torch.core.metrics import histogram_set
from mmlspark_tpu_torch.core.params import (
    DictParam, EnumParam, HasInputCol, HasOutputCol, IntParam, PyTreeParam,
    StringParam, UDFParam,
)
from mmlspark_tpu_torch.core.schema import (
    Field, ImageSchema, Schema, TENSOR, VECTOR,
)
from mmlspark_tpu_torch.core.stage import Model
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.device import DeviceLike, resolve_device
from mmlspark_tpu_torch.parallel.mesh import pad_to_multiple
from mmlspark_tpu_torch.utils.prefetch import make_prefetcher

# smallest serving shape bucket: ragged micro-batches pad UP to the next
# power of two from here (see TPUModel.bucket_sizes)
MIN_BUCKET = 8

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _column_to_array(col, field: Optional[Field], dtype) -> np.ndarray:
    """Coerce a table column into a dense batch array."""
    if field is not None and ImageSchema.is_image(field):
        return np.stack([np.asarray(r[ImageSchema.DATA]) for r in col]
                        ).astype(dtype)
    if isinstance(col, np.ndarray):
        return np.asarray(col, dtype=dtype)
    first = next((x for x in col if x is not None), None)
    if isinstance(first, np.ndarray):
        return np.stack([np.asarray(x) for x in col]).astype(dtype)
    return np.asarray(col, dtype=dtype)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md, "
                               f"'{item}'")


class TPUModel(Model, HasInputCol, HasOutputCol):
    """Run a forward function over a table, minibatched, on one device."""

    modelFn = UDFParam("callable (weights, inputs dict) -> outputs",
                       default=None)
    weights = PyTreeParam("model weights: a dict of tensors", default=None)
    feedDict = DictParam("map model input name -> table column",
                         default=None)
    fetchDict = DictParam("map output column -> model output name",
                          default=None)
    batchSize = IntParam("minibatch size", default=64)
    computeDtype = EnumParam(["float32", "bfloat16"],
                             "on-device compute dtype of float inputs",
                             default="float32")
    precision = EnumParam(["f32", "int8"], "inference precision",
                          default="f32")
    device = StringParam(
        "torch device to score on: None = 'cuda' (raises when no card is "
        "present) or 'cpu' (explicit opt-in)", default=None)

    def _post_init(self):
        self._device_weights = None
        # host batch assembly + upload, the dispatch -> readback-complete
        # round trip, and the readback alone
        self._hists = histogram_set("pad_ms", "device_ms", "readback_ms")

    def _on_param_change(self, name: str) -> None:
        if name in ("weights", "device"):
            self._device_weights = None
        elif name == "precision" and self.get("precision") == "int8":
            raise _not_ported("precision='int8'", "DNN int8 inference")

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_fn(fn: Callable, weights: Any, **kw) -> "TPUModel":
        return TPUModel(modelFn=fn, weights=weights, **kw)

    @staticmethod
    def from_module(module: nn.Module, device: DeviceLike = None,
                    input_shape: Optional[List[int]] = None,
                    input_scale: float = 1.0, **kw) -> "TPUModel":
        """Wrap an ``nn.Module`` (moved to ``device`` in eval mode); its
        parameters and buffers become ``weights``, and the table's feed
        columns are passed positionally in ``feedDict`` order. A float
        input is reshaped to ``(rows, *input_shape)`` when one is given
        and multiplied by ``input_scale`` (1/255 for image columns)."""
        dev = resolve_device(device)
        module = module.to(dev).eval()
        weights = {**dict(module.named_parameters()),
                   **dict(module.named_buffers())}
        return TPUModel(modelFn=_ModuleApply(module, input_shape,
                                             input_scale),
                        weights={k: t.detach() for k, t in weights.items()},
                        device=str(dev), **kw)

    # -- not ported yet -----------------------------------------------------

    def set_mesh(self, mesh) -> "TPUModel":
        raise _not_ported("set_mesh", "Device pipeline and serving "
                          "compilation")

    def set_sharding(self, *args, **kwargs) -> "TPUModel":
        raise _not_ported("set_sharding", "Device pipeline and serving "
                          "compilation")

    def device_op(self, schema):
        raise _not_ported("device_op (pipeline fusion)", "Device pipeline "
                          "and serving compilation")

    def quantize(self, calib, percentile: float = 100.0) -> "TPUModel":
        raise _not_ported("quantize", "DNN int8 inference")

    def warmup(self, example, sizes: Optional[List[int]] = None) -> int:
        raise _not_ported("warmup", "HTTP serving of the GBDT model")

    # -- device state -------------------------------------------------------

    def _device(self) -> torch.device:
        return resolve_device(self.get("device"))

    def _weights_on_device(self):
        if self._device_weights is None:
            dev = self._device()
            w = self.get("weights")
            self._device_weights = (
                {k: t.to(dev) for k, t in w.items()}
                if isinstance(w, dict) else w)
        return self._device_weights

    def _feeds(self) -> Dict[str, str]:
        fd = self.get("feedDict")
        return dict(fd) if fd else {"input": self.get_input_col()}

    def _fetches(self) -> Dict[str, str]:
        fd = self.get("fetchDict")
        return dict(fd) if fd else {self.get_output_col(): "output"}

    # -- serving shape buckets ----------------------------------------------

    def bucket_sizes(self) -> List[int]:
        """The padded batch-row sizes: powers of two from MIN_BUCKET up,
        capped by (and always including) batchSize."""
        cap = int(self.get("batchSize"))
        sizes: List[int] = []
        b = MIN_BUCKET
        while b < cap:
            sizes.append(b)
            b *= 2
        sizes.append(cap)
        return sizes

    def bucket_for(self, rows: int) -> int:
        """The padded bucket a ``rows``-row micro-batch runs at."""
        cap = int(self.get("batchSize"))
        b = MIN_BUCKET
        while b < rows:
            b *= 2
        return min(b, cap)

    def metrics(self) -> Dict[str, Any]:
        """pad / device / readback latency summaries (ms) and the
        precision label."""
        out: Dict[str, Any] = {k: h.summary()
                               for k, h in self._hists.items()}
        out["precision"] = self.get("precision")
        return out

    # -- transform ----------------------------------------------------------

    def transform(self, table: DataTable) -> DataTable:
        feeds = self._feeds()
        fetches = self._fetches()
        dtype = _COMPUTE_DTYPES[self.get("computeDtype")]
        batch_size = int(self.get("batchSize"))
        dev = self._device()
        weights = self._weights_on_device()
        model_fn = self.get("modelFn")
        int_input = bool(getattr(model_fn, "int_input", False))
        vocab = getattr(model_fn, "vocab_size", None)
        on_card = dev.type == "cuda"
        n = len(table)
        results: Dict[str, np.ndarray] = {}

        def prepare(start: int) -> Tuple[int, int, Dict[str, torch.Tensor]]:
            """Host batch assembly + upload (on the prefetch thread)."""
            t0 = time.perf_counter()
            stop = min(start + batch_size, n)
            rows = stop - start
            inputs = {}
            for model_in, col_name in feeds.items():
                arr = _column_to_array(table[col_name][start:stop],
                                       table.schema.get(col_name),
                                       np.int32 if int_input else np.float32)
                if int_input and vocab is not None and arr.size and (
                        arr.min() < 0 or arr.max() >= vocab):
                    raise ValueError(
                        f"column {col_name!r} holds token ids outside "
                        f"[0, {vocab})")
                # edge-pad: padded rows stay valid inputs
                arr, _ = pad_to_multiple(arr, self.bucket_for(rows), axis=0)
                t = torch.from_numpy(np.ascontiguousarray(arr))
                if on_card:
                    t = t.pin_memory().to(dev, non_blocking=True)
                t = t.long() if int_input else t.to(dtype)
                inputs[model_in] = t
            self._hists["pad_ms"].observe((time.perf_counter() - t0) * 1e3)
            return start, rows, inputs

        def dispatch(inputs):
            """Queue the forward; returns (outputs, an event recorded after
            it on the card, None on the CPU)."""
            with torch.inference_mode():
                outputs = model_fn(weights, inputs)
            if not isinstance(outputs, dict):
                outputs = {"output": outputs}
            for model_out in fetches.values():
                if model_out not in outputs:
                    raise KeyError(f"model output {model_out!r} not in "
                                   f"outputs {list(outputs)}")
            done = None
            if on_card:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
            return outputs, done

        copy_stream = torch.cuda.Stream(dev) if on_card else None

        def flush(item):
            start, rows, (outputs, done), t_dispatch = item
            t0 = time.perf_counter()
            for out_col, model_out in fetches.items():
                val = outputs[model_out][:rows]
                if on_card:
                    # batch k's real rows to pinned memory on a side
                    # stream, after batch k's compute, while batch k+1
                    # runs on the main one
                    copy_stream.wait_event(done)
                    with torch.cuda.stream(copy_stream):
                        host = torch.empty(val.shape, dtype=val.dtype,
                                           pin_memory=True)
                        host.copy_(val, non_blocking=True)
                    copy_stream.synchronize()
                    val = host
                if out_col not in results:
                    wide = (torch.float32 if val.dtype == torch.bfloat16
                            else val.dtype)
                    results[out_col] = torch.empty(
                        (n,) + tuple(val.shape[1:]), dtype=wide).numpy()
                # bfloat16 widens to float32 here, in torch's copy, which
                # runs on every host core
                torch.from_numpy(results[out_col][start:start + rows]
                                 ).copy_(val)
            now = time.perf_counter()
            self._hists["readback_ms"].observe((now - t0) * 1e3)
            self._hists["device_ms"].observe((now - t_dispatch) * 1e3)

        if 0 < n <= batch_size:
            # one micro-batch: no prefetch thread
            start, rows, inputs = prepare(0)
            t_dispatch = time.perf_counter()
            flush((start, rows, dispatch(inputs), t_dispatch))
        elif n > 0:
            feed = make_prefetcher(iter(range(0, n, batch_size)), prepare,
                                   dev, depth=2)
            pending: List[tuple] = []
            try:
                for start, rows, inputs in feed:
                    t_dispatch = time.perf_counter()
                    pending.append((start, rows, dispatch(inputs),
                                    t_dispatch))
                    if len(pending) > 1:
                        # delayed-by-one readback: batch k's copy runs
                        # while batch k+1 computes
                        flush(pending.pop(0))
            finally:
                feed.close()
            for item in pending:
                flush(item)

        result = table
        for out_col in fetches:
            merged = results.get(out_col, np.empty((0,), np.float32))
            tag = VECTOR if merged.ndim == 2 else TENSOR if merged.ndim > 2 \
                else Field(out_col, "f32").tag
            result = result.with_column(out_col, merged, Field(out_col, tag))
        return result

    def transform_schema(self, schema: Schema) -> Schema:
        for col_name in self._feeds().values():
            schema.require(col_name)
        out = schema
        for out_col in self._fetches():
            out = out.add_or_replace(Field(out_col, VECTOR))
        return out


class _ModuleApply:
    """``modelFn`` over an ``nn.Module``: runs it with the given weights
    (``torch.func.functional_call``), inputs passed positionally; a lone
    float input reshaped to ``input_shape`` and scaled by ``input_scale``
    first (the JAX learner's ``_InferApply``)."""

    def __init__(self, module: nn.Module,
                 input_shape: Optional[List[int]] = None,
                 input_scale: float = 1.0):
        self.module = module
        self.int_input = bool(getattr(module, "int_input", False))
        self.vocab_size = getattr(module, "vocab_size", None)
        self.input_shape = list(input_shape) if input_shape else None
        self.input_scale = float(input_scale)

    def __call__(self, weights: Dict[str, torch.Tensor],
                 inputs: Dict[str, torch.Tensor]):
        args = tuple(inputs.values())
        if self.input_shape or self.input_scale != 1.0:
            x = args[0]
            if self.input_shape:
                x = x.reshape((x.shape[0],) + tuple(self.input_shape))
            if not self.int_input and self.input_scale != 1.0:
                x = x.float() * self.input_scale
            args = (x,) + args[1:]
        return torch.func.functional_call(self.module, weights, args)
