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
- **Checkpoint / resume** (``checkpointDir``, ``checkpointEvery``,
  ``resume``), on a local path or any scheme of ``utils/filesystem.py``
  (``webdav://``): the JAX learner's layout, ``step_XXXXXXXX/`` holding
  ``leaves.npz`` and ``treedef.json`` (written last: it marks the
  checkpoint complete), the 3 newest kept (remote pruning best-effort).
  The tree is the JAX learner's ``{"batch_stats", "opt_state",
  "params", "step"}``: ``params`` and ``batch_stats`` in the flax names
  and layouts (``convert.flax_collections``), ``opt_state`` optax's tree
  for the optimizer (``sgd``: no state; ``momentum``: the trace, torch's
  ``momentum_buffer``; ``adam`` / ``adamw``: ``ScaleByAdamState(count,
  mu, nu)``, torch's ``step``, ``exp_avg``, ``exp_avg_sq``; a
  schedule's count where the learning rate is a schedule), so a
  checkpoint written by either package resumes in the other. Resume
  tries the checkpoints newest first and falls back to older ones, then
  to a fresh init, when one is corrupt; an ``OSError`` (a store outage)
  propagates. A resumed fit replays the uninterrupted one's batches
  (the host feed's permutations are drawn and skipped; the device
  feed's are seeded by the epoch), learning rates and dropout bits
  (the dropout generator is reseeded from ``seed`` and the step before
  each step). A final checkpoint is written at the end of the fit
  unless its step was just saved.
- **Timing**: ``timing`` has ``steps_timed``, ``wall_s`` and
  ``examples_per_sec`` after the first step; on an H100 also
  ``model_flops_per_step`` (``torch.utils.flop_counter`` over the first
  step plus ``flash_attention.FLOPS`` and ``networks.RNN_FLOPS``, which
  the counter cannot see),
  ``tflops_per_sec_per_chip`` and ``mfu`` against 989 TFLOP/s dense bf16.

Not ported yet, and raising ``NotImplementedError`` naming the ROADMAP.md
item: ``meshAxes`` with an axis above 1, ``paramSharding='fsdp'``,
``set_mesh`` and multi-process feeding, with the same-resume-step check
across hosts ('DNN training across cards'); an
``io.ooc.ChunkedTable`` ('Out-of-core ingest'). The port has no
``core/trace``, so a fit emits no framework spans.
"""

from __future__ import annotations

import logging
import math
import os
import re
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch import convert
from mmlspark_tpu_torch.core import serialize as ser
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
        sched_count = (self.get("schedule") == "cosine"
                       or self.get("warmupSteps") > 0)
        ckpt_dir = self.get("checkpointDir")
        ckpt_every = self.get("checkpointEvery")
        start_step = 0
        if ckpt_dir and self.get("resume"):
            start_step = _resume(ckpt_dir, module, opt,
                                 self.get("optimizer"), sched_count)
        module.train()
        dropout_gen = None
        if hasattr(module, "dropout_generator"):
            dropout_gen = torch.Generator(device=dev)
            module.dropout_generator = dropout_gen
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
            if dropout_gen is not None:
                # per step, so a resumed fit draws the same bits
                dropout_gen.manual_seed((seed + 1) * 1_000_003 + step)
            opt.zero_grad(set_to_none=True)
            with annotate("learner_step", ann_on), networks.strict_f32():
                out = module(xb.long() if is_int_input else xb)
                loss = self._loss_fn(out, yb, wb)
                loss.backward()
                opt.step()
            return loss.detach()

        global_step = start_step
        last_saved = -1
        t_first: Optional[float] = None
        first_timed_step = start_step
        examples_timed: Any = 0    # true (unpadded) rows after the first step
        flops_per_step: Optional[float] = None

        def save(step: int) -> None:
            nonlocal last_saved
            _save_checkpoint(ckpt_dir, step, train_state_tree(
                module, opt, self.get("optimizer"), sched_count, step))
            last_saved = step

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
            if ckpt_dir and global_step % ckpt_every == 0:
                save(global_step)

        with maybe_trace(self.get("profileDir")):
            if device_feed:
                self._device_feed(x, y, dev, n, steps_per_epoch, epochs,
                                  batch_size, seed, one_step, start_step)
            else:
                self._host_feed(x, y, factory if streaming else None, n,
                                epochs, batch_size, dev, fcol, lcol,
                                input_shape, y_cast, seed, one_step,
                                start_step)
        if on_card:
            torch.cuda.synchronize(dev)
        t_end = time.time()
        if ckpt_dir and last_saved != global_step:
            save(global_step)
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
                   input_shape, y_cast, seed, one_step,
                   start_step: int = 0) -> None:
        """Host batches in the JAX learner's order, built and uploaded on
        a prefetch thread (inline on the CPU). After a resume, the first
        ``start_step`` batches are drawn and skipped."""
        np_rng = np.random.default_rng(seed)

        def index_stream():
            step = 0
            for epoch in range(epochs):
                if factory is None:
                    order = np_rng.permutation(n)
                    for bstart in range(0, n, batch_size):
                        step += 1
                        if step <= start_step:
                            continue      # fast-forward after a resume
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
                        step += 1
                        if step <= start_step:
                            continue
                        sl = slice(i * batch_size, (i + 1) * batch_size)
                        yield epoch, xs[sl], ys[sl]
                    rest = len(xs) - n_full * batch_size
                    carry_x = xs[-rest:] if rest else None
                    carry_y = ys[-rest:] if rest else None
                if carry_x is not None:
                    step += 1
                    if step > start_step:
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
                     seed, one_step, start_step: int = 0) -> None:
        """The padded dataset on the device once; each epoch's
        permutation drawn there; a step's batch is a gather. After a
        resume, the run starts at step ``start_step`` of its epoch."""
        n_pad = steps_per_epoch * batch_size
        pad = n_pad - n
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
            y = np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)])
        x_dev, y_dev = _upload(x, dev), _upload(y, dev)
        w_dev = _upload((np.arange(n_pad) < n).astype(np.float32), dev)
        for epoch in range(epochs):
            first = start_step - epoch * steps_per_epoch
            if first >= steps_per_epoch:
                continue                  # a whole epoch done before
            g = torch.Generator(device=dev).manual_seed(
                (seed + 17) * 1_000_003 + epoch)
            perm = torch.randperm(n_pad, generator=g, device=dev)
            for i in range(max(0, first), steps_per_epoch):
                sel = perm[i * batch_size:(i + 1) * batch_size]
                wb = w_dev[sel]
                # true rows stay a device scalar until the clock stops
                one_step(epoch, x_dev[sel], y_dev[sel], wb, wb.sum())


# ---------------------------------------------------------------------------
# checkpoint / resume (the JAX learner's layout and tree)
# ---------------------------------------------------------------------------


def _named_state(module: nn.Module, opt: torch.optim.Optimizer, key: str
                 ) -> Dict[str, np.ndarray]:
    """Per-parameter optimizer state ``key`` by torch parameter name, as
    host arrays; zeros where the optimizer holds none yet (optax's
    initial state)."""
    out = {}
    for name, p in module.named_parameters():
        t = opt.state.get(p, {}).get(key)
        out[name] = (t.detach().float().cpu().numpy() if t is not None
                     else np.zeros(tuple(p.shape), np.float32))
    return out


def _flax_params(module: nn.Module, values: Dict[str, np.ndarray]):
    return convert.flax_collections(module, values, stats=False)["params"]


def train_state_tree(module: nn.Module, opt: torch.optim.Optimizer,
                     optimizer: str, sched_count: bool, step: int
                     ) -> Dict[str, Any]:
    """The JAX learner's train state, host numpy, for ``module`` and its
    optimizer after ``step`` updates: ``{"batch_stats", "opt_state",
    "params", "step"}`` with ``opt_state`` in optax's tree for
    ``optimizer`` (``sched_count``: the learning rate is a schedule, whose
    state is its count)."""
    values = {k: t.detach().float().cpu().numpy()
              for k, t in {**dict(module.named_parameters()),
                           **dict(module.named_buffers())}.items()}
    coll = convert.flax_collections(module, values)
    count = np.asarray(step, np.int32)
    sched = (count,) if sched_count else ()
    if optimizer == "sgd":
        opt_state: Tuple = ((), sched)
    elif optimizer == "momentum":
        opt_state = ((_flax_params(module, _named_state(
            module, opt, "momentum_buffer")),), sched)
    elif optimizer in ("adam", "adamw"):
        adam = (count,
                _flax_params(module, _named_state(module, opt, "exp_avg")),
                _flax_params(module, _named_state(module, opt,
                                                  "exp_avg_sq")))
        opt_state = ((adam, sched) if optimizer == "adam"
                     else (adam, (), sched))
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return {"batch_stats": coll["batch_stats"], "opt_state": opt_state,
            "params": coll["params"], "step": count}


def _expect_tuple(node, n: int, what: str) -> tuple:
    if not isinstance(node, tuple) or len(node) != n:
        raise ValueError(f"checkpoint {what}: expected a tuple of {n}, "
                         f"got {type(node).__name__}"
                         f"{len(node) if isinstance(node, tuple) else ''}")
    return node


def load_train_state(tree: Dict[str, Any], module: nn.Module,
                     opt: torch.optim.Optimizer, optimizer: str,
                     sched_count: bool) -> int:
    """Set ``module`` and ``opt`` from a train-state tree written by
    either package (``train_state_tree``'s layout); returns its step.
    Everything is read and checked before anything is set, so a tree
    that does not fit (``ValueError``) leaves the fresh init intact."""
    step = int(np.asarray(tree["step"]))
    coll = {"params": tree["params"],
            "batch_stats": tree.get("batch_stats") or {}}
    state = convert.params_from_flax(module, coll)
    opt_state = tree["opt_state"]
    n_sched = 1 if sched_count else 0
    per_param: Dict[str, Dict[str, np.ndarray]] = {}
    count = None
    if optimizer == "sgd":
        _expect_tuple(opt_state, 2, "opt_state")
        _expect_tuple(opt_state[0], 0, "sgd state")
        sched = opt_state[1]
    elif optimizer == "momentum":
        _expect_tuple(opt_state, 2, "opt_state")
        (trace,) = _expect_tuple(opt_state[0], 1, "trace state")
        per_param["momentum_buffer"] = convert.params_from_flax(
            module, {"params": trace}, stats=False)
        sched = opt_state[1]
    elif optimizer in ("adam", "adamw"):
        _expect_tuple(opt_state, 2 if optimizer == "adam" else 3,
                      "opt_state")
        count, mu, nu = _expect_tuple(opt_state[0], 3, "adam state")
        if optimizer == "adamw":
            _expect_tuple(opt_state[1], 0, "weight-decay state")
        per_param["exp_avg"] = convert.params_from_flax(
            module, {"params": mu}, stats=False)
        per_param["exp_avg_sq"] = convert.params_from_flax(
            module, {"params": nu}, stats=False)
        sched = opt_state[-1]
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    _expect_tuple(sched, n_sched, "schedule state")
    # all read: now set
    named = {**dict(module.named_parameters()),
             **dict(module.named_buffers())}
    with torch.no_grad():
        for k, arr in state.items():
            named[k].copy_(torch.from_numpy(arr))
    opt.state.clear()
    if per_param:
        for name, p in module.named_parameters():
            st: Dict[str, torch.Tensor] = {}
            for key, arrs in per_param.items():
                st[key] = torch.from_numpy(
                    np.ascontiguousarray(arrs[name])).to(p.device)
            if count is not None:
                st["step"] = torch.tensor(float(np.asarray(count)),
                                          dtype=torch.float32)
            opt.state[p] = st
    return step


def _is_remote(path: str) -> bool:
    from mmlspark_tpu_torch.utils import filesystem as fslib
    return fslib.scheme_of(path) != "file"


def _remote_steps(ckpt_dir: str) -> List[str]:
    """Sorted step_XXXXXXXX names that have a COMPLETE checkpoint
    (treedef.json is uploaded last, so its presence marks done)."""
    from mmlspark_tpu_torch.utils import filesystem as fslib
    fs = fslib.get_filesystem(ckpt_dir)
    steps = set()
    for f in fs.list_files(ckpt_dir.rstrip("/"), recursive=True):
        m = re.search(r"(step_\d{8})/treedef\.json$", f)
        if m:
            steps.add(m.group(1))
    return sorted(steps)


def _save_checkpoint(ckpt_dir: str, step: int, tree: Dict[str, Any]
                     ) -> None:
    """Write ``tree`` as ``<ckpt_dir>/step_XXXXXXXX/`` (``leaves.npz``,
    then ``treedef.json``) and keep the 3 newest."""
    if _is_remote(ckpt_dir):
        from mmlspark_tpu_torch.utils import filesystem as fslib
        fs = fslib.get_filesystem(ckpt_dir)
        base = f"{ckpt_dir.rstrip('/')}/step_{step:08d}"
        with tempfile.TemporaryDirectory() as td:
            ser._save_pytree(tree, td)
            # treedef.json LAST: it is the completeness marker that
            # _remote_steps / resume key on
            names = sorted(os.listdir(td),
                           key=lambda n: n == "treedef.json")
            for fn in names:
                with open(os.path.join(td, fn), "rb") as f:
                    fs.write_bytes(f"{base}/{fn}", f.read())
        try:
            for stale in _remote_steps(ckpt_dir)[:-3]:
                fs.delete_path(f"{ckpt_dir.rstrip('/')}/{stale}/")
        except (IOError, OSError, NotImplementedError):
            pass                       # pruning (incl. listing) is
            #                            best-effort — the save landed
        return
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    ser._save_pytree(tree, path)
    all_ckpts = sorted(d for d in os.listdir(ckpt_dir)
                       if d.startswith("step_"))
    for stale in all_ckpts[:-3]:
        shutil.rmtree(os.path.join(ckpt_dir, stale), ignore_errors=True)


def _checkpoint_candidates(ckpt_dir: str) -> List[str]:
    """All retained checkpoint paths, NEWEST first — the corrupt-
    checkpoint fallback order. A remote LISTING failure propagates (the
    filesystem layer already retries): an unreachable store must fail
    loudly, not silently restart training from scratch."""
    if _is_remote(ckpt_dir):
        steps = _remote_steps(ckpt_dir)
        return [f"{ckpt_dir.rstrip('/')}/{s}" for s in reversed(steps)]
    if not os.path.isdir(ckpt_dir):
        return []
    ckpts = sorted((d for d in os.listdir(ckpt_dir)
                    if d.startswith("step_")), reverse=True)
    return [os.path.join(ckpt_dir, d) for d in ckpts]


def _load_checkpoint_pytree(path: str):
    """``serialize._load_pytree`` from a local OR remote checkpoint
    directory."""
    if not _is_remote(path):
        return ser._load_pytree(path)
    from mmlspark_tpu_torch.utils import filesystem as fslib
    fs = fslib.get_filesystem(path)
    with tempfile.TemporaryDirectory() as td:
        for fn in ("leaves.npz", "treedef.json"):
            data = fs.read_bytes(f"{path.rstrip('/')}/{fn}")
            with open(os.path.join(td, fn), "wb") as f:
                f.write(data)
        return ser._load_pytree(td)


def _resume(ckpt_dir: str, module: nn.Module, opt: torch.optim.Optimizer,
            optimizer: str, sched_count: bool) -> int:
    """Load the newest loadable checkpoint of ``ckpt_dir`` into
    ``module`` and ``opt``; returns its step (0: none, fresh init). A
    corrupt or truncated checkpoint falls back to the previous one; an
    ``OSError`` (a store outage, not a bad file) propagates."""
    candidates = _checkpoint_candidates(ckpt_dir)
    for candidate in candidates:
        try:
            tree = _load_checkpoint_pytree(candidate)
            step = load_train_state(tree, module, opt, optimizer,
                                    sched_count)
        except OSError:
            raise
        except Exception as e:  # noqa: BLE001 — a corrupt checkpoint
            logger.warning("failed to load checkpoint %s (%s); falling "
                           "back to the previous one", candidate, e)
            continue
        logger.info("resumed from %s (step %d)", candidate, step)
        return step
    if candidates:
        logger.warning("no loadable checkpoint in %s; training from "
                       "fresh init", ckpt_dir)
    return 0
