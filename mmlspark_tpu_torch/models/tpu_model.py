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

Serving hooks (the reference's): ``warmup`` runs every shape bucket once
before traffic (``core/warmup.py``); ``jit_cache_misses`` counts the
distinct padded (bucket rows, dtype) shapes the model has run for the
first time — the port's analog of the reference's XLA compile counter
(an eager torch forward compiles nothing, but a shape's first run pays
for cuBLAS heuristics, kernel loads and fresh allocator blocks), so a
first ``warmup`` returns ``len(bucket_sizes())`` and a second 0;
``histograms`` hands out the raw pad / device / readback histograms.
Saved with ``save``, the weights go as a pytree and a module's
``_ModuleApply`` as a pickle of its structure (parameters on the meta
device; the weights restore them).

``device_op`` is the fusion hook (``core/fusion.py``): the forward as one
op of a fused segment, under ``networks.strict_f32()``, run in blocks of
``batchSize`` rows with the ragged last block edge-padded to its bucket
— the shapes ``transform`` runs, so a fused forward issues the same
kernels on the same shapes; token ids arrive through an int32 ``Feed``.

``_forward_fn`` is the AOT hook: ``transform`` runs every padded batch
through what it returns, the model fn here; the model that
``serving/aot.py`` loads from an artifact returns a dispatcher to its
exported programs.

``quantize(calib, percentile)`` returns a NEW model whose dense layers
run int8 (``core/quantize.py``): ``precision='int8'``, ``computeDtype``
pinned to float32, the quantized tensors in the weights pytree under
``quantize.QUANT_KEY``; it saves and loads like any other. This model
stays the f32 oracle. ``precision='int8'`` cannot be set by hand on a
model whose ``modelFn`` is not a quantized one.
"""

from __future__ import annotations

import copy
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


def _token_ids(col, field: Optional[Field], name: str,
               vocab: Optional[int]) -> np.ndarray:
    """A token column as int32 ids, refused when an id falls outside
    ``[0, vocab)`` (the host check ``transform`` makes per batch)."""
    arr = _column_to_array(col, field, np.int32)
    if vocab is not None and arr.size and (arr.min() < 0
                                           or arr.max() >= vocab):
        raise ValueError(f"column {name!r} holds token ids outside "
                         f"[0, {vocab})")
    return arr


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
        # (padded rows, dtype) shapes run so far; set.add is atomic, so
        # concurrent transforms count each shape once
        self._seen_shapes: set = set()

    def _on_param_change(self, name: str) -> None:
        if name in ("weights", "device"):
            self._device_weights = None
        elif name == "precision" and self.get("precision") == "int8":
            from mmlspark_tpu_torch.core.quantize import QuantizedModuleApply
            fn = self.get("modelFn")
            if fn is not None and not isinstance(fn, QuantizedModuleApply):
                self._paramMap["precision"] = "f32"
                raise ValueError(
                    "precision='int8' is set by quantize(calib), which "
                    "returns a new model with int8 weights; it cannot be "
                    "set by hand on an f32 model")

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

    # -- fusion hook ---------------------------------------------------------

    def reads_columns(self, schema):
        return list(self._feeds().values())

    def writes_columns(self, schema):
        return list(self._fetches().keys())

    def device_op(self, schema):
        """Fusion hook (core/fusion.py): the forward becomes one op in a
        fused segment — upstream featurization flows into it on the
        device. It runs in blocks of ``batchSize`` rows, the last one
        edge-padded to its bucket, as ``transform`` does, so device
        memory stays bounded by the model's batch and the kernels see
        ``transform``'s shapes. Integer-token models feed through an
        int32 Feed (range-checked on the host) so ids never round-trip
        through float."""
        from mmlspark_tpu_torch.core import fusion as FZ
        from mmlspark_tpu_torch.models.networks import strict_f32
        feeds_map = self._feeds()
        fetches = self._fetches()
        model_fn = self.get("modelFn")
        if model_fn is None:
            return None
        dtype = _COMPUTE_DTYPES[self.get("computeDtype")]
        int_input = bool(getattr(model_fn, "int_input", False))
        vocab = getattr(model_fn, "vocab_size", None)
        batch = int(self.get("batchSize"))
        reads: List[str] = []
        op_feeds: List[Any] = []
        env_key: Dict[str, str] = {}
        for model_in, col in feeds_map.items():
            if int_input:
                name = f"{self.uid}:{col}:i32"
                op_feeds.append(FZ.Feed(
                    name, lambda t, _c=col: _token_ids(
                        t[_c], t.schema.get(_c), _c, vocab)))
                env_key[model_in] = name
            else:
                reads.append(col)
                env_key[model_in] = col

        def fn(consts, env, _keys=tuple(env_key.items()),
               _fetch=tuple(fetches.items()), _dtype=dtype,
               _int=int_input, _batch=batch, _bucket=self.bucket_for):
            n = env[_keys[0][1]].shape[0]
            res = {}
            with strict_f32():
                for start in range(0, n, _batch):
                    rows = min(_batch, n - start)
                    pad = _bucket(rows) - rows
                    inputs = {}
                    for model_in, key in _keys:
                        x = env[key][start:start + rows]
                        if pad:
                            x = torch.cat([x, x[-1:].expand(
                                (pad,) + tuple(x.shape[1:]))])
                        inputs[model_in] = x.long() if _int \
                            else x.to(_dtype)
                    out = model_fn(consts, inputs)
                    if not isinstance(out, dict):
                        out = {"output": out}
                    for out_col, model_out in _fetch:
                        val = out[model_out][:rows]
                        if val.dtype == torch.bfloat16:
                            val = val.to(torch.float32)
                        if out_col not in res:
                            res[out_col] = torch.empty(
                                (n,) + tuple(val.shape[1:]),
                                dtype=val.dtype, device=val.device)
                        res[out_col][start:start + rows] = val
            return res

        return FZ.DeviceOp(
            self, reads=reads, writes=list(fetches.keys()), fn=fn,
            make_consts=lambda: self.get("weights"), feeds=op_feeds,
            name=(f"{type(self).__name__}:{self.uid}:int8"
                  if self.get("precision") == "int8" else None))

    # -- post-training quantization -----------------------------------------

    def quantize(self, calib, percentile: float = 100.0) -> "TPUModel":
        """Int8 post-training quantization (core/quantize.py): calibrate
        per-tensor activation clip ranges on the ``calib`` rows (a
        DataTable or column->array dict holding a held-out batch for
        every feed column; they go through one forward), quantize every
        dense kernel per channel, and return a NEW ``TPUModel`` whose
        forward runs int8 x int8 -> int32 matmuls with f32 dequant
        epilogues, labelled ``precision='int8'``. This model (the f32
        path) is untouched — the accuracy oracle and the rollback target.

        Needs a module model (``from_module``, the JAX package's
        ``from_flax``, or a learner's model): quantization intercepts
        the network's dense layers. An ``OnnxApply`` graph or an
        arbitrary callable raises ``ValueError``."""
        from mmlspark_tpu_torch.core import quantize as QZ
        model_fn = self.get("modelFn")
        if not isinstance(model_fn, _ModuleApply):
            raise ValueError(
                "quantize() needs a module model (TPUModel.from_module — "
                "the JAX package's from_flax — or a learner's model); "
                "arbitrary callables and ONNX graphs cannot be "
                "post-training quantized")
        table = calib if isinstance(calib, DataTable) \
            else DataTable(dict(calib))
        if len(table) == 0:
            raise ValueError("quantize needs at least one calibration row")
        dev = self._device()
        int_input = bool(model_fn.int_input)
        inputs = {}
        for model_in, col in self._feeds().items():
            arr = _column_to_array(table[col], table.schema.get(col),
                                   np.int32 if int_input else np.float32)
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
            inputs[model_in] = t.long() if int_input else t
        qfn, qweights = QZ.quantize_module(
            model_fn, self._weights_on_device(), inputs,
            percentile=percentile)
        # computeDtype pins to float32: the dequant epilogue contract is
        # f32, and routing int8 dequant through bf16 would stack a
        # second rounding on top of the quantization error
        return TPUModel(modelFn=qfn, weights=qweights,
                        feedDict=self.get("feedDict"),
                        fetchDict=self.get("fetchDict"),
                        batchSize=self.get("batchSize"),
                        computeDtype="float32",
                        inputCol=self.get("inputCol"),
                        outputCol=self.get("outputCol"),
                        device=self.get("device"),
                        precision="int8")

    # -- device state -------------------------------------------------------

    def _device(self) -> torch.device:
        return resolve_device(self.get("device"))

    def _weights_on_device(self):
        if self._device_weights is None:
            dev = self._device()

            def to_dev(node):
                if isinstance(node, dict):
                    return {k: to_dev(v) for k, v in node.items()}
                return node.to(dev) if isinstance(node, torch.Tensor) \
                    else node
            self._device_weights = to_dev(self.get("weights"))
        return self._device_weights

    def resident_bytes(self) -> int:
        """Bytes the weights shipped to the device occupy (one device's
        sum: the port has no mesh) — the zoo's per-model eviction-cost
        signal. Before the first ship, the host weights' bytes."""
        tree = self._device_weights
        if tree is None:
            tree = self.get("weights")
        return _tree_nbytes(tree)

    def unload(self) -> None:
        """Drop the device copy of the weights (the model zoo calls this
        on eviction, so the card memory comes back even while the stage
        object is still referenced); the next transform ships them
        again."""
        self._device_weights = None

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

    def warmup(self, example, sizes: Optional[List[int]] = None) -> int:
        """Run every serving bucket once before traffic, so no live
        request pays a shape's first run. ``example`` is a DataTable, or
        a dict of column -> array, holding at least one representative
        row for every feed column; rows are tiled up to each bucket size
        and pushed through ``transform`` (core/warmup.py, each bucket's
        wall time in the ``model_warmup_ms`` histogram). Returns the
        number of first-time shapes it met (0 when all were warm)."""
        from mmlspark_tpu_torch.core.warmup import warmup_transform
        return warmup_transform(self, example, sizes)

    @property
    def jit_cache_misses(self) -> int:
        """Distinct padded (rows, dtype) shapes run for the first time."""
        return len(self._seen_shapes)

    def histograms(self) -> Dict[str, Any]:
        """The raw pad / device / readback histogram objects (exact
        buckets); ``metrics()`` keeps returning the summary view."""
        return dict(self._hists)

    def metrics(self) -> Dict[str, Any]:
        """pad / device / readback latency summaries (ms), the
        first-run shape counter and the precision label."""
        out: Dict[str, Any] = {k: h.summary()
                               for k, h in self._hists.items()}
        out["jit_cache_misses"] = self.jit_cache_misses
        out["precision"] = self.get("precision")
        return out

    # -- transform ----------------------------------------------------------

    def _forward_fn(self) -> Callable:
        """What ``transform`` calls on each padded batch: ``(weights,
        inputs) -> outputs``. The model fn here; an AOT-loaded model
        (``serving/aot.py``) dispatches to its exported programs by
        input signature instead."""
        return self.get("modelFn")

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
                col, field = table[col_name][start:stop], \
                    table.schema.get(col_name)
                arr = (_token_ids(col, field, col_name, vocab) if int_input
                       else _column_to_array(col, field, np.float32))
                # edge-pad: padded rows stay valid inputs
                arr, _ = pad_to_multiple(arr, self.bucket_for(rows), axis=0)
                self._seen_shapes.add(
                    (arr.shape[0], torch.long if int_input else dtype))
                t = torch.from_numpy(np.ascontiguousarray(arr))
                if on_card:
                    t = t.pin_memory().to(dev, non_blocking=True)
                t = t.long() if int_input else t.to(dtype)
                inputs[model_in] = t
            self._hists["pad_ms"].observe((time.perf_counter() - t0) * 1e3)
            return start, rows, inputs

        forward = self._forward_fn()

        def dispatch(inputs):
            """Queue the forward; returns (outputs, an event recorded after
            it on the card, None on the CPU)."""
            with torch.inference_mode():
                outputs = forward(weights, inputs)
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


def _tree_nbytes(tree) -> int:
    """Bytes of every tensor / array leaf of a nested dict / list."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(getattr(tree, "nbytes", 0))


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

    def __getstate__(self):
        # the structure travels, not the values: parameters and buffers
        # go to the meta device (the TPUModel's ``weights`` pytree holds
        # them, and ``functional_call`` swaps them in on every call)
        memo = {id(p): nn.Parameter(torch.empty_like(p, device="meta"),
                                    requires_grad=p.requires_grad)
                for p in self.module.parameters()}
        memo.update({id(b): torch.empty_like(b, device="meta")
                     for b in self.module.buffers()})
        state = dict(self.__dict__)
        state["module"] = copy.deepcopy(self.module, memo)
        return state

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
