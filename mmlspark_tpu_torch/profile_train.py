"""Where the time of a training step goes on a CUDA card (the PyTorch port).

    python3 -m mmlspark_tpu_torch.profile_train [--steps 4] [--trace PATH]
        [--compute-dtype {bfloat16,float32}]

Trains the configuration ``chip_smoke.py`` drives (``TPULearner`` over
the full-width ``LM_SPEC`` of bench.py, token cross-entropy, AdamW at
1e-3, batches of 8 x 1024 tokens, device feed; tokens from numpy seed 7)
in ``--compute-dtype`` (bf16 by default; float32 runs the f32 flash
kernels and strict-f32 GEMMs, since torch keeps ``allow_tf32`` False)
for ``--steps`` steps once to warm up (kernel builds,
cuBLAS, the allocator), then again under ``torch.profiler`` (CPU and
CUDA activities) with ``traceAnnotations`` on, and prints for the steps
after the first (whose end the learner waits for):
  - step seconds and tokens/s over that window (and, first, the
    warm-up fit's unprofiled ``learner.timing``);
  - the device's busy and idle shares of the window;
  - device time by kind: cuBLAS GEMMs, the three flash kernels, the
    optimizer, cross-entropy, casts and copies, LayerNorm, GELU, the
    rest; then by kernel name, largest first.
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
# (kind, substrings of a kernel name), first match wins
KINDS = [
    ("flash_fwd", ("flash_fwd",)),
    ("flash_dq", ("flash_dq",)),
    ("flash_dkv", ("flash_dkv",)),
    ("cuBLAS GEMMs", ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "sm80_")),
    ("optimizer (AdamW)", ("multi_tensor_apply", "adam")),
    ("cross-entropy", ("softmax", "nll_loss", "cross_entropy")),
    ("casts and copies", ("copy", "memcpy", "memset", "fill")),
    ("LayerNorm", ("layer_norm",)),
    ("GELU", ("gelu",)),
]


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other (elementwise, reductions, embedding)"


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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

    table = slice_table(args.steps * BATCH)
    t0 = time.perf_counter()
    warm = slice_learner(args.steps, args.compute_dtype)
    warm.fit(table)                                      # warm-up
    torch.cuda.synchronize()
    print(f"warm-up fit of {args.steps} steps: "
          f"{time.perf_counter() - t0:.3f} s; unprofiled learner.timing "
          f"{warm.timing}")
    del warm
    torch.cuda.empty_cache()

    learner = slice_learner(args.steps, args.compute_dtype,
                            traceAnnotations=True)
    FA.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        learner.fit(table)
        torch.cuda.synchronize()
    print(f"card: {torch.cuda.get_device_name(0)}; LM_SPEC, {args.steps} "
          f"steps of {BATCH} x {LM_SPEC['max_len']} tokens, "
          f"{args.compute_dtype} compute (allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}), AdamW; flash launches "
          f"{dict(FA.LAUNCHES)}")
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
    tokens = BATCH * LM_SPEC["max_len"]
    print(f"steps 2..{len(steps)}: {window / 1e3:.3f} ms, "
          f"{step_s:.4f} s per step, {tokens / step_s:.0f} tokens/s")
    print(f"device busy {busy / 1e3:.3f} ms ({100 * busy / window:.1f} %), "
          f"idle {100 * (1 - busy / window):.1f} % of the window")

    by_kind = defaultdict(lambda: [0, 0.0])
    by_name = defaultdict(lambda: [0, 0.0])
    for e in inside:
        us = e.time_range.end - e.time_range.start
        for table_, key in ((by_kind, kind_of(e.name)),
                            (by_name, e.name[:90])):
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
