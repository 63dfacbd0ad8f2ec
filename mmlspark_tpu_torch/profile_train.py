"""Where the time of a training step goes on a CUDA card (the PyTorch port).

    python3 -m mmlspark_tpu_torch.profile_train [--network {lm,convnet,resnet20}]
        [--steps 4] [--trace PATH] [--compute-dtype {bfloat16,float32}]

``--network lm`` (the default) trains the configuration ``chip_smoke.py``
phase 5 drives (``TPULearner`` over the full-width ``LM_SPEC`` of
bench.py, token cross-entropy, AdamW at 1e-3, batches of 8 x 1024
tokens, device feed; tokens from numpy seed 7). ``convnet`` and
``resnet20`` train bench.py's CIFAR configurations (``bench_cifar``'s
ConvNet [64, 64, 64] / [256] and ``bench_resnet``'s ResNet-20, 10
classes, ``inputShape`` [32, 32, 3]) at its settings: batches of 1024,
lr 0.1, the default Nesterov momentum and cosine schedule, device feed,
seeded CIFAR-shaped data as ``bench.py::_train_throughput`` draws it.
Each runs in ``--compute-dtype`` (bf16 by default; float32 runs the f32
flash kernels, strict-f32 GEMMs, since torch keeps ``allow_tf32`` False,
and cuDNN without TF32 under ``networks.strict_f32``) for ``--steps``
steps once to warm up (kernel builds, cuBLAS and cuDNN heuristics, the
allocator), then again under ``torch.profiler`` (CPU and CUDA
activities) with ``traceAnnotations`` on, and prints for the steps after
the first (whose end the learner waits for):
  - step seconds and tokens/s or images/s over that window (and, first,
    the warm-up fit's unprofiled ``learner.timing``, with its MFU);
  - the device's busy and idle shares of the window;
  - device time by kind of the kernels launched in that window, each
    classed by the operator that launched it where that says more than
    its name: cuDNN convolution
    forward and backward, BatchNorm (forward and backward, the port's
    ``_BatchNormTrain`` node), pooling, cuBLAS GEMMs, the three flash
    kernels, the optimizer, cross-entropy, casts and copies, LayerNorm,
    GELU, the rest; then by kernel name, largest first.
With ``--trace`` it writes the profiler's chrome trace of the window's
fit there (a few MB at 4 steps). Exits 1 without a card, or if the
profiler records no device activity.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import defaultdict

import numpy as np

from mmlspark_tpu_torch.profile_fit import union_us
from mmlspark_tpu_torch.profile_transform import LM_SPEC

BATCH = 8
CIFAR_BATCH = 1024
# bench.py's bench_cifar and bench_resnet networks
CIFAR_SPECS = {
    "convnet": {"type": "convnet", "conv_features": [64, 64, 64],
                "dense_features": [256], "num_classes": 10},
    "resnet20": {"type": "resnet", "stage_sizes": [3, 3, 3], "width": 16,
                 "num_classes": 10},
}
# (kind, substrings of a kernel name), first match wins
KINDS = [
    ("flash_fwd", ("flash_fwd",)),
    ("flash_dq", ("flash_dq",)),
    ("flash_dkv", ("flash_dkv",)),
    ("cuBLAS GEMMs", ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "sm80_")),
    ("optimizer", ("multi_tensor_apply", "adam")),
    ("cross-entropy", ("softmax", "nll_loss", "cross_entropy")),
    ("casts and copies", ("copy", "memcpy", "memset", "fill")),
    ("LayerNorm", ("layer_norm",)),
    ("GELU", ("gelu",)),
]
# (kind, test on the name of an operator or range around the launch),
# outermost first, checked before the kernel's name
OWNER_KINDS = [
    ("BatchNorm (fwd + bwd)", lambda n: "_BatchNormTrain" in n),
    ("optimizer", lambda n: n.startswith("Optimizer.step")),
    ("cuDNN conv backward", lambda n: n == "aten::convolution_backward"),
    ("cuDNN conv forward", lambda n: n == "aten::convolution"),
    ("pooling", lambda n: n.startswith("aten::max_pool2d")),
    ("cross-entropy", lambda n: n.startswith(("aten::nll_loss",
                                              "aten::_log_softmax"))),
    ("cuBLAS GEMMs", lambda n: n in ("aten::mm", "aten::addmm", "aten::bmm",
                                     "aten::baddbmm")),
]


def kind_of(name: str, owners=()) -> str:
    """The kind of a kernel named ``name`` launched inside the operators
    and ranges ``owners`` (outermost first)."""
    for kind, test in OWNER_KINDS:
        if any(test(o) for o in owners):
            return kind
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other (elementwise, reductions, embedding)"


def launched_kernels(events, t0: float):
    """``(kernel name, device us, owners)`` of every kernel launched by a
    CPU operator that started at or after ``t0`` (us): the profiler lists
    a kernel under the innermost operator open at its launch, and the
    owners are that operator and the operators and ranges around it,
    outermost first."""
    import torch
    for e in events:
        if (e.device_type != torch.autograd.DeviceType.CPU or not e.kernels
                or e.time_range.start < t0):
            continue
        names, node = [], e
        while node is not None:
            names.append(node.name)
            node = node.cpu_parent
        owners = tuple(reversed(names))
        for k in e.kernels:
            yield k.name, k.duration, owners


def slice_learner(steps: int, compute_dtype: str = "bfloat16", **kw):
    from mmlspark_tpu_torch.models.learner import TPULearner
    return TPULearner(networkSpec=LM_SPEC, loss="token_cross_entropy",
                      optimizer="adamw", learningRate=1e-3,
                      batchSize=BATCH, computeDtype=compute_dtype,
                      dataFeed="device", epochs=1, logEvery=steps, **kw)


def slice_table(rows: int):
    """Token and label columns as bench.py's bench_lm makes them."""
    from mmlspark_tpu_torch.core.table import DataTable
    rng = np.random.default_rng(7)
    toks = rng.integers(0, LM_SPEC["vocab_size"],
                        size=(rows, LM_SPEC["max_len"])).astype(np.float32)
    tgts = np.roll(toks.astype(np.int64), -1, axis=1)
    return DataTable({"features": toks, "label": tgts})


def cifar_learner(network: str, steps: int, compute_dtype: str = "bfloat16",
                  **kw):
    """bench.py's ``_train_throughput`` learner for one CIFAR network."""
    from mmlspark_tpu_torch.models.learner import TPULearner
    args = dict(networkSpec=CIFAR_SPECS[network], inputShape=[32, 32, 3],
                batchSize=CIFAR_BATCH, learningRate=0.1,
                computeDtype=compute_dtype, epochs=1, logEvery=steps,
                dataFeed="device")
    args.update(kw)
    return TPULearner(**args)


def cifar_table(rows: int, seed: int = 0):
    """CIFAR-shaped rows as bench.py's ``_train_throughput`` draws them:
    uint8 pixels scaled to [0, 1], flattened, and random labels."""
    from mmlspark_tpu_torch.core.table import DataTable
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(rows, 32, 32, 3)).astype(np.float32)
    x /= 255.0
    y = rng.integers(0, 10, size=rows).astype(np.int64)
    return DataTable({"features": x.reshape(rows, -1), "label": y})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--network", default="lm",
                    choices=["lm"] + sorted(CIFAR_SPECS))
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--trace", default="")
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from mmlspark_tpu_torch.ops import flash_attention as FA

    if args.network == "lm":
        table = slice_table(args.steps * BATCH)
        rows, unit = BATCH * LM_SPEC["max_len"], "tokens"

        def make(**kw):
            return slice_learner(args.steps, args.compute_dtype, **kw)
        what = (f"LM_SPEC, {args.steps} steps of {BATCH} x "
                f"{LM_SPEC['max_len']} tokens, AdamW")
    else:
        table = cifar_table(args.steps * CIFAR_BATCH)
        rows, unit = CIFAR_BATCH, "images"

        def make(**kw):
            return cifar_learner(args.network, args.steps,
                                 args.compute_dtype, **kw)
        what = (f"{args.network} {CIFAR_SPECS[args.network]}, {args.steps} "
                f"steps of {CIFAR_BATCH} x 32 x 32 x 3, Nesterov momentum")
    t0 = time.perf_counter()
    warm = make()
    warm.fit(table)                                      # warm-up
    torch.cuda.synchronize()
    print(f"warm-up fit of {args.steps} steps: "
          f"{time.perf_counter() - t0:.3f} s; unprofiled learner.timing "
          f"{warm.timing}")
    del warm
    torch.cuda.empty_cache()

    learner = make(traceAnnotations=True)
    FA.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        learner.fit(table)
        torch.cuda.synchronize()
    print(f"card: {torch.cuda.get_device_name(0)}; {what}, "
          f"{args.compute_dtype} compute (allow_tf32: matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN off inside the "
          f"step); flash launches {dict(FA.LAUNCHES)}")
    print(f"learner.timing: {learner.timing}")

    events = prof.events()
    steps = sorted(e.time_range.start for e in events
                   if e.name == "learner_step"
                   and e.device_type == torch.autograd.DeviceType.CPU)
    # record_function ranges (learner_step, Optimizer.step#AdamW.step)
    # are projected onto the device timeline too; they are no device work
    dev_events = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
    if not dev_events or len(steps) < 2:
        print("profile_train: the profiler recorded no device activity or "
              "too few steps", file=sys.stderr)
        return 1
    # the learner waits for the first step's end before the second starts,
    # so the window of steps 2.. opens where the second step is enqueued
    w0 = steps[1]
    inside = [e for e in dev_events if e.time_range.start >= w0]
    w1 = max(e.time_range.end for e in inside)
    window = w1 - w0
    busy = union_us([(e.time_range.start, e.time_range.end)
                     for e in inside])
    n_steps = len(steps) - 1
    step_s = window / 1e6 / n_steps
    print(f"steps 2..{len(steps)}: {window / 1e3:.3f} ms, "
          f"{step_s:.4f} s per step, {rows / step_s:.0f} {unit}/s")
    print(f"device busy {busy / 1e3:.3f} ms ({100 * busy / window:.1f} %), "
          f"idle {100 * (1 - busy / window):.1f} % of the window")

    by_kind = defaultdict(lambda: [0, 0.0])
    by_name = defaultdict(lambda: [0, 0.0])
    for name, us, owners in launched_kernels(events, w0):
        for table_, key in ((by_kind, kind_of(name, owners)),
                            (by_name, name[:90])):
            table_[key][0] += 1
            table_[key][1] += us
    total = sum(v[1] for v in by_kind.values())
    print(f"device time by kind ({total / 1e3:.3f} ms in all, "
          f"{total / 1e3 / n_steps:.3f} ms per step):")
    for kind, (count, us) in sorted(by_kind.items(), key=lambda kv: -kv[1][1]):
        print(f"  {us / 1e3 / n_steps:10.3f} ms/step  {100 * us / total:5.1f} %"
              f"  x{count // n_steps:<5d} {kind}")
    print("device time by kernel, largest first:")
    for name, (count, us) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:16]:
        print(f"  {us / 1e3 / n_steps:10.3f} ms/step  {100 * us / total:5.1f} %"
              f"  x{count // n_steps:<5d} {name}")
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)
        print(f"trace written to {args.trace} "
              f"({os.path.getsize(args.trace) / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
