"""ImageFeaturizer of the PyTorch port — transfer learning via truncated
pretrained networks (see ``mmlspark_tpu/stages/featurizer.py``).

Analog of the reference's image-featurizer
(ref: src/image-featurizer/src/main/scala/ImageFeaturizer.scala:36-141):
the reference composes ImageTransformer.resize → UnrollImage → CNTKModel
with ``cutOutputLayers`` removing the head layers. Here the zoo network
is the port's module of ``networkSpec``, built once by
``convert.module_from_flax`` from the flax-layout ``weights`` param (the
JAX package's tree, so a featurizer saved by either package loads in the
other) and kept on the device; cutting N output layers means capturing
at ``feature_layers()[-N]``.

The transform is pipelined as the JAX package's is: host decode / resize
fans out over a process-wide thread pool and runs on a prefetch thread
(``utils/prefetch``, depth 2), so batch k+1's resize overlaps batch k's
forward; every batch is padded up to ``batchSize`` with copies of its
last image (sliced off at readback), so the forward runs at one shape;
the batch goes up from pinned host memory without blocking; the forward
runs under ``networks.strict_f32()`` (cuDNN's TF32 off); and readback
lags by one batch, through pinned memory on a side stream, so batch k's
copy overlaps batch k+1's forward. ``jit_cache_misses`` counts the
(forward, input shape) pairs run for the first time, as ``TPUModel``
counts its shapes. The ``image_resize`` and ``image_forward``
histograms of ``core.metrics.automl_histograms()`` observe each batch.

The ``device`` param is the card by default (``None`` = cuda); without
one the stage raises unless ``device='cpu'`` was asked for. ``set_mesh``
raises, as ``TPUModel.set_mesh`` does.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mmlspark_tpu_torch import convert
from mmlspark_tpu_torch.core import metrics as MC
from mmlspark_tpu_torch.core.params import (
    BoolParam, DictParam, HasInputCol, HasOutputCol, IntParam, PyTreeParam,
    StringParam,
)
from mmlspark_tpu_torch.core.schema import Field, ImageSchema, Schema, VECTOR
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.device import resolve_device
from mmlspark_tpu_torch.models.networks import strict_f32
from mmlspark_tpu_torch.models.tpu_model import _not_ported
from mmlspark_tpu_torch.ops import image_ops
from mmlspark_tpu_torch.utils.prefetch import make_prefetcher

# One process-wide host decode/resize pool shared by every
# ImageFeaturizer — instances come and go (model reloads, per-request
# pipelines) and must not each pin a thread set for the process
# lifetime. Daemon-threaded executor, reaped at interpreter exit.
_RESIZE_POOL = None
_RESIZE_POOL_LOCK = threading.Lock()
# Each F.interpolate in the pool fans out again over torch's intra-op
# threads, so fewer pool threads than cores do better: on an 8-core host
# beside an H100, profile_featurize measured the host half at 0.83-0.86
# ms an image with 4 threads against 0.96-1.17 ms with 8 (PERF.md §6).
RESIZE_WORKERS = min(4, os.cpu_count() or 1)


def _shared_resize_pool():
    global _RESIZE_POOL
    if _RESIZE_POOL is None:
        with _RESIZE_POOL_LOCK:
            if _RESIZE_POOL is None:
                from concurrent.futures import ThreadPoolExecutor
                _RESIZE_POOL = ThreadPoolExecutor(
                    max_workers=RESIZE_WORKERS,
                    thread_name_prefix="img-resize")
    return _RESIZE_POOL


def load_image(row, height: int, width: int, scale: float) -> np.ndarray:
    """One image row -> a (height, width, C) float32 network input: the
    host half of a featurizer batch (float resize where the size
    differs, then ``scale``), run on the resize pool's threads."""
    img = np.asarray(row[ImageSchema.DATA], dtype=np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[:2] != (height, width):
        img = image_ops.resize_host(img, height, width)
    return img * scale


class ImageFeaturizer(Transformer, HasInputCol, HasOutputCol):
    """Resize images, forward through a truncated zoo network, emit the
    captured activation as a flat feature vector column."""

    networkSpec = DictParam(
        "declarative network spec (models.networks.build_network)",
        default=None)
    weights = PyTreeParam("flax-layout variables tree", default=None)
    cutOutputLayers = IntParam(
        "how many output layers to cut; 0 = keep head "
        "(ref: ImageFeaturizer.scala cutOutputLayers :91)", default=1)
    inputHeight = IntParam("network input height", default=32)
    inputWidth = IntParam("network input width", default=32)
    inputChannels = IntParam("network input channels", default=3)
    scaleImage = BoolParam("scale uint8 [0,255] to [0,1]", default=True)
    batchSize = IntParam("inference minibatch size", default=64)
    modelName = StringParam("zoo model name (informational)", default="")
    device = StringParam(
        "torch device to featurize on: None = 'cuda' (raises when no card "
        "is present) or 'cpu' (explicit opt-in)", default=None)

    def __init__(self, **kw):
        kw.setdefault("inputCol", "image")
        kw.setdefault("outputCol", "features")
        super().__init__(**kw)

    def _post_init(self):
        # the module on its device, built from `weights` once
        self._device_module: Optional[nn.Module] = None
        # (forward generation, input shape) pairs run so far; the
        # generation moves when the network or the capture point changes
        self._forward_gen = 0
        self._seen_shapes: set = set()

    def _on_param_change(self, name: str) -> None:
        if name in ("networkSpec", "cutOutputLayers", "weights", "device"):
            self._device_module = None
        if name in ("networkSpec", "cutOutputLayers"):
            self._forward_gen += 1

    @property
    def jit_cache_misses(self) -> int:
        """(forward, input shape) pairs run for the first time: 1 per
        configuration, since every batch pads to ``batchSize``."""
        return len(self._seen_shapes)

    # -- construction from the model zoo ------------------------------------

    @staticmethod
    def from_model_schema(schema, downloader, **kw) -> "ImageFeaturizer":
        """Build from a downloader ModelSchema
        (ref: ImageFeaturizer.setModel(ModelSchema))."""
        variables = downloader.load_variables(schema.name)
        feat = ImageFeaturizer(networkSpec=schema.network_spec,
                               weights=variables,
                               modelName=schema.name, **kw)
        if len(schema.input_shape) == 3:
            h, w, c = schema.input_shape
            feat.set("inputHeight", int(h))
            feat.set("inputWidth", int(w))
            feat.set("inputChannels", int(c))
        return feat

    def set_mesh(self, mesh) -> "ImageFeaturizer":
        raise _not_ported("set_mesh", "Device pipeline and serving "
                          "compilation")

    # -- forward ------------------------------------------------------------

    def _module_on(self, dev: torch.device) -> nn.Module:
        """The network with ``weights``, on ``dev``: built and shipped
        once, then reused until a param it depends on changes."""
        if self._device_module is None:
            spec = self.get("networkSpec")
            if spec is None:
                raise ValueError("networkSpec is not set")
            variables = self.get("weights")
            if variables is None:
                raise ValueError("weights is not set")
            self._device_module = convert.module_from_flax(spec, variables,
                                                           device=dev)
        return self._device_module

    def _capture_layer(self, module: nn.Module) -> Optional[str]:
        cut = self.get("cutOutputLayers")
        if cut <= 0:
            return None
        layers = module.feature_layers()
        if cut > len(layers):
            raise ValueError(
                f"cutOutputLayers={cut} but network has only "
                f"{len(layers)} feature layers: {layers}")
        return layers[-cut]

    def transform(self, table: DataTable) -> DataTable:
        dev = resolve_device(self.get("device"))
        on_card = dev.type == "cuda"
        module = self._module_on(dev)
        capture = self._capture_layer(module)
        h, w = self.get("inputHeight"), self.get("inputWidth")
        rows = table[self.get_input_col()]
        bs = self.get("batchSize")
        scale = 1.0 / 255.0 if self.get("scaleImage") else 1.0
        hists = MC.automl_histograms()
        n = len(rows)
        pool = _shared_resize_pool()

        def prepare(start: int) -> Tuple[int, torch.Tensor]:
            """Decode + resize (pool fan-out) + pad into pinned memory +
            upload, on the prefetch thread."""
            t0 = time.perf_counter()
            imgs = list(pool.map(lambda r: load_image(r, h, w, scale),
                                 rows[start:min(start + bs, n)]))
            true_len = len(imgs)
            batch = torch.empty((bs,) + imgs[0].shape, dtype=torch.float32,
                                pin_memory=on_card)
            host = batch.numpy()
            for i, img in enumerate(imgs):
                host[i] = img
            # pad with copies of the last image: valid inputs, sliced off
            # at readback, so the forward always runs at (bs, h, w, c)
            host[true_len:] = imgs[-1]
            if on_card:
                batch = batch.to(dev, non_blocking=True)
            hists["image_resize"].observe((time.perf_counter() - t0) * 1e3)
            return true_len, batch

        copy_stream = torch.cuda.Stream(dev) if on_card else None

        def dispatch(batch: torch.Tensor):
            self._seen_shapes.add((self._forward_gen, tuple(batch.shape)))
            with torch.inference_mode(), strict_f32():
                out = module(batch, capture=capture)
                out = out.reshape(batch.shape[0], -1).float()
            done = None
            if on_card:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
            return out, done

        feats: List[np.ndarray] = []

        def flush(item) -> None:
            true_len, (out, done), t_dispatch = item
            val = out[:true_len]
            if on_card:
                # batch k's rows to pinned memory on a side stream, after
                # batch k's forward, while batch k+1's runs
                copy_stream.wait_event(done)
                with torch.cuda.stream(copy_stream):
                    host = torch.empty(val.shape, dtype=val.dtype,
                                       pin_memory=True)
                    host.copy_(val, non_blocking=True)
                copy_stream.synchronize()
                val = host
            feats.append(val.numpy())
            hists["image_forward"].observe(
                (time.perf_counter() - t_dispatch) * 1e3)

        if n > 0:
            feed = make_prefetcher(range(0, n, bs), prepare, dev, depth=2)
            pending: List[Any] = []
            try:
                for true_len, batch in feed:
                    t_dispatch = time.perf_counter()
                    pending.append((true_len, dispatch(batch), t_dispatch))
                    if len(pending) > 1:
                        # delayed-by-one readback
                        flush(pending.pop(0))
            finally:
                feed.close()
            for item in pending:
                flush(item)
        merged = (np.concatenate(feats, axis=0) if feats
                  else np.empty((0, 0), np.float32))
        return table.with_column(self.get_output_col(), merged,
                                 Field(self.get_output_col(), VECTOR))

    def transform_schema(self, schema: Schema) -> Schema:
        f = schema[self.get_input_col()]
        if not ImageSchema.is_image(f):
            raise TypeError(
                f"column {self.get_input_col()!r} is not an image column")
        return schema.add_or_replace(Field(self.get_output_col(), VECTOR))
