"""TPULearner of the PyTorch port — minibatch training of zoo networks as an
Estimator (see ``mmlspark_tpu/models/learner.py``).

``TPULearner(...).fit(table)`` trains a network from ``networkSpec``
(``build_network``, weights drawn from ``seed``) or ``moduleFactory`` (an
``nn.Module`` whose weights are the initial weights; it is trained in
place) on one device, and returns a ``TPUModel`` over the trained module.
The card is the default device (``device`` Param, ``None`` = cuda);
without one it raises unless ``device='cpu'`` was asked for.

The module is built after the table is read, from the shape of one row
(``networks.sized_spec``), as the JAX learner's ``module.init(rng,
sample)`` sizes it: an MLP's input width, a ConvNet's input channels and
flattened width, a ResNet's input channels. Image columns are scaled by
1/255 and stay NHWC; ``inputShape`` reshapes a flat column per row.

What carries over from the JAX learner, so both packages take the same
steps on the same data:
- **Batches.** Host feed: each epoch's order is the same
  ``np.random.default_rng(seed)`` permutation; the final batch is
  edge-padded to ``batchSize`` with zero loss weight; batches are built
  on a prefetch thread and uploaded through pinned memory with
  ``non_blocking`` copies. Shard streams (a sequence of ``DataTable``s or
  a zero-arg callable returning an iterable of them) shuffle within
  shards and carry remainder rows across shard boundaries. Device feed:
  the padded dataset lives on the card once; each epoch's permutation is
  drawn on the card from a ``torch.Generator`` seeded from ``seed + 17``
  and the epoch, and a step's batch is a gather there (its bits are
  torch's, so the order differs from the JAX device feed's).
- **Losses** on float32 logits, ``sum(loss * w) / max(sum(w), 1)``.
- **Optimizers** (``make_optimizer``): optax's ``sgd``, Nesterov
  ``momentum``, ``adam`` and ``adamw`` as ``torch.optim`` optimizers
  whose learning rate is set before each step from ``lr_schedule``, a
  port of optax's ``constant``, ``linear_schedule`` warmup and
  ``warmup_cosine_decay_schedule``, evaluated at the step count before
  the update as optax does (so the default cosine schedule without
  warmup takes its first step at lr 0).
- **Mixed precision**: ``computeDtype='bfloat16'`` sets the spec's
  ``dtype``; parameters and optimizer state stay float32. A step's
  forward and backward run under ``networks.strict_f32()``, so cuDNN's
  float32 convolutions and LSTMs take no TF32.
- **BatchNorm**: the module trains in train mode, so BatchNorm normalizes
  with the batch's statistics (the edge-padded rows of a final batch
  included, as in the JAX learner) and updates its running buffers on
  the device; the returned model holds them and scores in eval mode with
  them, as the JAX learner's ``batch_stats``.
- **Logging**: losses stay on the device and are read one ``logEvery``
  interval late; ``history`` holds ``{step, loss, epoch, time}``.
- **Timing**: ``timing`` has ``steps_timed``, ``wall_s`` and
  ``examples_per_sec`` after the first step; on an H100 also
  ``model_flops_per_step`` (``torch.utils.flop_counter`` over the first
  step plus ``flash_attention.FLOPS`` and ``networks.RNN_FLOPS``, which
  the counter cannot see),
  ``tflops_per_sec_per_chip`` and ``mfu`` against 989 TFLOP/s dense bf16.

Not ported yet, and raising ``NotImplementedError`` naming the ROADMAP.md
item: ``meshAxes`` with an axis above 1, ``paramSharding='fsdp'``,
``set_mesh`` and multi-process feeding ('DNN training across cards');
``checkpointDir`` ('DNN training: checkpoint/resume'); an
``io.ooc.ChunkedTable`` ('Out-of-core ingest'). The port has no
``core/trace``, so a fit emits no framework spans.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.core.params import (
    BoolParam, DictParam, EnumParam, FloatParam, HasFeaturesCol, HasLabelCol,
    IntParam, StringParam, UDFParam,
)
from mmlspark_tpu_torch.core.schema import ImageSchema
from mmlspark_tpu_torch.core.stage import Estimator
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.device import resolve_device
from mmlspark_tpu_torch.models import networks
from mmlspark_tpu_torch.models.networks import build_network
from mmlspark_tpu_torch.models.tpu_model import TPUModel
from mmlspark_tpu_torch.ops import flash_attention as FA
from mmlspark_tpu_torch.parallel.mesh import pad_to_multiple
from mmlspark_tpu_torch.utils.prefetch import make_prefetcher
from mmlspark_tpu_torch.utils.profiling import (
    annotate, device_memory_stats, maybe_trace,
)

logger = logging.getLogger("mmlspark_tpu_torch.learner")

H100_PEAK_BF16_FLOPS = 989e12   # dense bf16, NVIDIA's H100 SXM data sheet


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md, "
                               f"'{item}'")


# ---------------------------------------------------------------------------
# optimizers / schedules
# ---------------------------------------------------------------------------


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax.linear_schedule(init, end, steps) at ``count``."""
    c = min(max(count, 0), steps)
    return (init - end) * (1.0 - c / steps) + end


def lr_schedule(lr: float, schedule: str = "constant", warmup_steps: int = 0,
                total_steps: int = 1000) -> Callable[[int], float]:
    """``lr_at(step)``: the learning rate of the update at ``step``
    (0-based), as the JAX learner's optax schedule gives it: ``constant``
    (a linear warmup from 0 over ``warmup_steps`` when > 0) or ``cosine``,
    ``warmup_cosine_decay_schedule(0, lr, max(w, 1), max(total, w + 1))``."""
    if schedule == "cosine":
        w = max(warmup_steps, 1)
        span = max(total_steps, w + 1) - w

        def lr_at(step: int) -> float:
            if step < w:
                return _linear(0.0, lr, w, step)
            t = min(step - w, span)
            return lr * 0.5 * (1.0 + math.cos(math.pi * t / span))
        return lr_at
    if schedule == "constant":
        if warmup_steps > 0:
            return lambda step: _linear(0.0, lr, warmup_steps, step)
        return lambda step: lr
    raise ValueError(f"unknown schedule {schedule!r}")


def make_optimizer(name: str, params, lr: float, *, momentum: float = 0.9,
                   weight_decay: float = 0.0, schedule: str = "constant",
                   warmup_steps: int = 0, total_steps: int = 1000
                   ) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """``(optimizer, lr_at)`` over ``params``: the ``torch.optim`` form of
    the JAX learner's optax transform. Set each param group's ``lr`` to
    ``lr_at(step)`` before step ``step``. optax's ``sgd`` with Nesterov
    momentum keeps ``t = g + m·t`` and steps along ``g + m·t``, which is
    torch's ``SGD(nesterov=True)``; optax's ``adamw`` decays every leaf by
    ``lr·wd·p``, which is torch's ``AdamW``."""
    lr_at = lr_schedule(lr, schedule, warmup_steps, total_steps)
    params = list(params)
    if name == "sgd":
        opt = torch.optim.SGD(params, lr=lr)
    elif name == "momentum":
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum,
                              nesterov=True)
    elif name == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return opt, lr_at


# ---------------------------------------------------------------------------
# feature extraction from table columns
# ---------------------------------------------------------------------------


def table_to_xy(table: DataTable, features_col: str, label_col: str,
                input_shape: Optional[List[int]] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    field = table.schema.get(features_col)
    col = table[features_col]
    if field is not None and ImageSchema.is_image(field):
        x = np.stack([np.asarray(r[ImageSchema.DATA]) for r in col]
                     ).astype(np.float32) / 255.0
    elif isinstance(col, np.ndarray):
        x = np.asarray(col, dtype=np.float32)
    else:
        x = np.stack([np.asarray(v) for v in col]).astype(np.float32)
    if input_shape:
        x = x.reshape((x.shape[0],) + tuple(input_shape))
    y = np.asarray(table[label_col])
    return x, y


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host batch on ``dev``: through pinned memory with a
    ``non_blocking`` copy on the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    return t


class TPULearner(Estimator, HasFeaturesCol, HasLabelCol):
    """Train a zoo network on a table; returns a TPUModel."""

    networkSpec = DictParam(
        "declarative network spec, e.g. {'type':'transformer',...}",
        default=None)
    moduleFactory = UDFParam(
        "callable () -> nn.Module holding the initial weights (alternative "
        "to networkSpec); the module is trained in place", default=None)
    loss = EnumParam(["cross_entropy", "mse", "token_cross_entropy"],
                     "training loss", default="cross_entropy")
    optimizer = EnumParam(["sgd", "momentum", "adam", "adamw"],
                          "optimizer", default="momentum")
    learningRate = FloatParam("peak learning rate", default=0.1)
    momentum = FloatParam("sgd momentum", default=0.9)
    weightDecay = FloatParam("adamw weight decay", default=1e-4)
    schedule = EnumParam(["constant", "cosine"], "lr schedule",
                         default="cosine")
    warmupSteps = IntParam("lr warmup steps", default=0)
    epochs = IntParam("training epochs", default=1)
    batchSize = IntParam("global batch size", default=128)
    seed = IntParam("rng seed", default=0)
    computeDtype = EnumParam(["float32", "bfloat16"],
                             "device compute dtype", default="bfloat16")
    meshAxes = DictParam("mesh axes; on one card every axis is 1 (or -1)",
                         default=None)
    paramSharding = EnumParam(["replicated", "fsdp"],
                              "parameter sharding strategy",
                              default="replicated")
    inputShape = UDFParam("reshape flat features to this per-row shape "
                          "(list), e.g. [32,32,3]", default=None)
    checkpointDir = StringParam("checkpoint directory ('' = off)", default="")
    checkpointEvery = IntParam("steps between checkpoints", default=200)
    resume = BoolParam("resume from latest checkpoint if present",
                       default=True)
    logEvery = IntParam("steps between loss logs", default=50)
    dataFeed = EnumParam(
        ["host", "device"],
        "'host' streams minibatches through a prefetch thread; 'device' "
        "places the whole (padded) dataset on the device once and "
        "shuffles there per epoch (in-memory tables only)",
        default="host")
    profileDir = StringParam(
        "write a torch.profiler chrome trace of the training loop here "
        "('' = off)", default="")
    traceAnnotations = BoolParam(
        "wrap each train step in a torch.profiler.record_function range "
        "named learner_step", default=False)
    memoryStatsEvery = IntParam(
        "steps between device-memory samples (bytes_in_use / peak / "
        "limit) recorded into learner.memory_samples (0 = off)", default=0)
    device = StringParam(
        "torch device to train on: None = 'cuda' (raises when no card is "
        "present) or 'cpu' (explicit opt-in)", default=None)

    def _post_init(self):
        self.history: List[Dict[str, float]] = []
        self.timing: Dict[str, float] = {}
        self.memory_samples: List[Dict[str, Any]] = []

    def set_mesh(self, mesh) -> "TPULearner":
        raise _not_ported("set_mesh", "DNN training across cards")

    # -- internals ----------------------------------------------------------

    def _refuse_out_of_slice(self, table) -> None:
        axes = self.get("meshAxes") or {}
        if any(int(s) not in (1, -1) for s in axes.values()):
            raise _not_ported(f"meshAxes={axes}", "DNN training across "
                              "cards")
        if self.get("paramSharding") == "fsdp":
            raise _not_ported("paramSharding='fsdp'",
                              "DNN training across cards")
        if (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise _not_ported("multi-process feeding",
                              "DNN training across cards")
        if self.get("checkpointDir"):
            raise _not_ported("checkpointDir", "DNN training: "
                              "checkpoint/resume")
        if type(table).__name__ == "ChunkedTable":
            raise _not_ported("io.ooc.ChunkedTable input",
                              "Out-of-core ingest")

    def _build_module(self, dev: torch.device, row_shape) -> nn.Module:
        """The module to train, sized from one input row's shape."""
        factory = self.get("moduleFactory")
        if factory is not None:
            return factory().to(dev)
        spec = self.get("networkSpec")
        if spec is None:
            raise ValueError("set networkSpec or moduleFactory")
        spec = networks.sized_spec(spec, row_shape)
        if self.get("computeDtype") == "bfloat16":
            spec.setdefault("dtype", "bfloat16")
        return build_network(spec, device=dev, seed=self.get("seed"))

    def _loss_fn(self, logits: torch.Tensor, y: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
        kind = self.get("loss")
        if kind == "cross_entropy":
            losses = F.cross_entropy(logits.float(), y, reduction="none")
        elif kind == "token_cross_entropy":
            lf = logits.float()
            losses = F.cross_entropy(
                lf.reshape(-1, lf.shape[-1]), y.reshape(-1),
                reduction="none").reshape(y.shape).mean(dim=-1)
        else:  # mse
            pred = logits.float()
            if pred.ndim == 2 and pred.shape[-1] == 1:
                pred = pred[:, 0]
            losses = (pred - y.float()) ** 2
        return (losses * w).sum() / torch.clamp(w.sum(), min=1.0)

    def fit(self, table) -> TPUModel:
        """``table`` is a DataTable, or a sequence of DataTable shards / a
        zero-arg callable returning an iterable of shards (re-invoked each
        epoch; shuffling is within-shard with remainder rows carried
        across shard boundaries)."""
        self._refuse_out_of_slice(table)
        dev = resolve_device(self.get("device"))
        input_shape = self.get("inputShape")
        fcol, lcol = self.get_features_col(), self.get_label_col()
        # int64 class / token ids: what torch's cross-entropy takes
        y_cast = np.int64 if self.get("loss") != "mse" else np.float32

        streaming = not isinstance(table, DataTable)
        if streaming:
            if not callable(table) and iter(table) is table:
                raise ValueError(
                    "streaming fit() needs to replay shards every epoch: "
                    "pass a sequence of DataTables or a zero-arg callable "
                    "returning a fresh iterator, not a one-shot generator")
            factory = table if callable(table) else (lambda: iter(table))
            n, first_shard = 0, None
            for t in factory():
                if first_shard is None:
                    first_shard = t
                n += len(t)
            if n == 0:
                raise ValueError("empty shard stream")
            row_shape = table_to_xy(first_shard, fcol, lcol,
                                    input_shape)[0].shape[1:]
            schema_src = first_shard
            x = y = None
        else:
            x, y = table_to_xy(table, fcol, lcol, input_shape)
            y = y.astype(y_cast)
            n = x.shape[0]
            row_shape = x.shape[1:]
            schema_src = table
        module = self._build_module(dev, row_shape)

        batch_size = self.get("batchSize")
        device_feed = self.get("dataFeed") == "device"
        if device_feed and streaming:
            raise ValueError(
                "dataFeed='device' needs the whole dataset resident on the "
                "device: pass an in-memory DataTable (use dataFeed='host' "
                "for shard streams)")
        steps_per_epoch = max(1, (n + batch_size - 1) // batch_size)
        epochs = self.get("epochs")
        total_steps = steps_per_epoch * epochs

        opt, lr_at = make_optimizer(
            self.get("optimizer"), module.parameters(),
            self.get("learningRate"), momentum=self.get("momentum"),
            weight_decay=self.get("weightDecay"),
            schedule=self.get("schedule"),
            warmup_steps=self.get("warmupSteps"), total_steps=total_steps)
        seed = self.get("seed")
        module.train()
        if hasattr(module, "dropout_generator"):
            module.dropout_generator = torch.Generator(
                device=dev).manual_seed(seed + 1)
        is_int_input = bool(getattr(module, "int_input", False))
        on_card = dev.type == "cuda"
        count_flops = on_card and "H100" in torch.cuda.get_device_name(dev)
        ann_on = bool(self.get("traceAnnotations"))
        mem_every = int(self.get("memoryStatsEvery") or 0)
        log_every = self.get("logEvery")

        self.history = []
        self.timing = {}
        self.memory_samples = []
        pending: List[Tuple[int, int, torch.Tensor, float]] = []

        def flush_logs(final: bool = False) -> None:
            # read entries whose device value is (almost surely) ready:
            # everything but the newest, or everything when final
            keep = 0 if final else 1
            while len(pending) > keep:
                step_, epoch_, dev_loss, t = pending.pop(0)
                lv = float(dev_loss)
                self.history.append({"step": step_, "loss": lv,
                                     "epoch": epoch_, "time": t})
                logger.info("step %d/%d loss %.4f", step_, total_steps, lv)

        def train_step(step: int, xb, yb, wb) -> torch.Tensor:
            lr = lr_at(step)
            for group in opt.param_groups:
                group["lr"] = lr
            opt.zero_grad(set_to_none=True)
            with annotate("learner_step", ann_on), networks.strict_f32():
                out = module(xb.long() if is_int_input else xb)
                loss = self._loss_fn(out, yb, wb)
                loss.backward()
                opt.step()
            return loss.detach()

        global_step = 0
        t_first: Optional[float] = None
        first_timed_step = 0
        examples_timed: Any = 0    # true (unpadded) rows after the first step
        flops_per_step: Optional[float] = None

        def one_step(epoch: int, xb, yb, wb, true_rows) -> None:
            nonlocal global_step, t_first, first_timed_step, examples_timed
            nonlocal flops_per_step
            if t_first is None and count_flops:
                from torch.utils.flop_counter import FlopCounterMode
                unseen0 = sum(FA.FLOPS.values()) + networks.RNN_FLOPS["lstm"]
                with FlopCounterMode(display=False) as counter:
                    loss = train_step(global_step, xb, yb, wb)
                unseen = (sum(FA.FLOPS.values())
                          + networks.RNN_FLOPS["lstm"] - unseen0)
                flops_per_step = float(counter.get_total_flops() + unseen)
            else:
                loss = train_step(global_step, xb, yb, wb)
            global_step += 1
            if t_first is None:
                float(loss)     # the first step (set-up included) ends here
                t_first = time.time()
                first_timed_step = global_step
            else:
                examples_timed = examples_timed + true_rows
            if global_step % log_every == 0 or global_step == total_steps:
                pending.append((global_step, epoch, loss, time.time()))
                flush_logs()
            if mem_every and global_step % mem_every == 0:
                stats = device_memory_stats(dev)
                if stats:
                    self.memory_samples.append({"step": global_step,
                                                **stats})

        with maybe_trace(self.get("profileDir")):
            if device_feed:
                self._device_feed(x, y, dev, n, steps_per_epoch, epochs,
                                  batch_size, seed, one_step)
            else:
                self._host_feed(x, y, factory if streaming else None, n,
                                epochs, batch_size, dev, fcol, lcol,
                                input_shape, y_cast, seed, one_step)
        if on_card:
            torch.cuda.synchronize(dev)
        t_end = time.time()
        flush_logs(final=True)
        steps_timed = global_step - first_timed_step
        if t_first is not None and steps_timed > 0:
            wall = t_end - t_first
            rows = float(examples_timed)
            self.timing = {"steps_timed": steps_timed, "wall_s": wall,
                           "examples_per_sec": rows / max(wall, 1e-9)}
            if flops_per_step:
                tflops = flops_per_step * steps_timed / max(wall, 1e-9) / 1e12
                self.timing.update(
                    model_flops_per_step=flops_per_step,
                    tflops_per_sec_per_chip=tflops,
                    mfu=tflops * 1e12 / H100_PEAK_BF16_FLOPS)

        field = schema_src.schema.get(fcol)
        img_scale = (1.0 / 255.0) if (field is not None
                                      and ImageSchema.is_image(field)) else 1.0
        return TPUModel.from_module(
            module.eval(), dev, input_shape=input_shape,
            input_scale=img_scale, inputCol=fcol, outputCol="scores",
            batchSize=batch_size)

    # -- feeds ----------------------------------------------------------------

    @staticmethod
    def _host_feed(x, y, factory, n, epochs, batch_size, dev, fcol, lcol,
                   input_shape, y_cast, seed, one_step) -> None:
        """Host batches in the JAX learner's order, built and uploaded on
        a prefetch thread (inline on the CPU)."""
        np_rng = np.random.default_rng(seed)

        def index_stream():
            for epoch in range(epochs):
                if factory is None:
                    order = np_rng.permutation(n)
                    for bstart in range(0, n, batch_size):
                        idx = order[bstart:bstart + batch_size]
                        yield epoch, x[idx], y[idx]
                    continue
                carry_x = carry_y = None
                for shard in factory():
                    xs, ys = table_to_xy(shard, fcol, lcol, input_shape)
                    ys = ys.astype(y_cast)
                    perm = np_rng.permutation(len(xs))
                    xs, ys = xs[perm], ys[perm]
                    if carry_x is not None:
                        xs = np.concatenate([carry_x, xs])
                        ys = np.concatenate([carry_y, ys])
                    n_full = len(xs) // batch_size
                    for i in range(n_full):
                        sl = slice(i * batch_size, (i + 1) * batch_size)
                        yield epoch, xs[sl], ys[sl]
                    rest = len(xs) - n_full * batch_size
                    carry_x = xs[-rest:] if rest else None
                    carry_y = ys[-rest:] if rest else None
                if carry_x is not None:
                    yield epoch, carry_x, carry_y

        def make_batch(item):
            epoch, bx_np, by_np = item
            bx, true_len = pad_to_multiple(bx_np, batch_size, axis=0)
            by, _ = pad_to_multiple(by_np, batch_size, axis=0)
            w = (np.arange(batch_size) < true_len).astype(np.float32)
            return epoch, true_len, _upload(bx, dev), _upload(by, dev), \
                _upload(w, dev)

        feed = make_prefetcher(index_stream(), make_batch, dev, depth=2)
        try:
            for epoch, true_len, xb, yb, wb in feed:
                one_step(epoch, xb, yb, wb, true_len)
        finally:
            # an abnormal exit must not leave the worker blocked in put()
            # holding prefetched batches on the card
            feed.close()

    @staticmethod
    def _device_feed(x, y, dev, n, steps_per_epoch, epochs, batch_size,
                     seed, one_step) -> None:
        """The padded dataset on the device once; each epoch's
        permutation drawn there; a step's batch is a gather."""
        n_pad = steps_per_epoch * batch_size
        pad = n_pad - n
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
            y = np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)])
        x_dev, y_dev = _upload(x, dev), _upload(y, dev)
        w_dev = _upload((np.arange(n_pad) < n).astype(np.float32), dev)
        for epoch in range(epochs):
            g = torch.Generator(device=dev).manual_seed(
                (seed + 17) * 1_000_003 + epoch)
            perm = torch.randperm(n_pad, generator=g, device=dev)
            for i in range(steps_per_epoch):
                sel = perm[i * batch_size:(i + 1) * batch_size]
                wb = w_dev[sel]
                # true rows stay a device scalar until the clock stops
                one_step(epoch, x_dev[sel], y_dev[sel], wb, wb.sum())
