"""Where the time of one LM transform goes on a CUDA card (the PyTorch port).

    python3 -m mmlspark_tpu_torch.profile_transform [--trace PATH]

Builds the full-width LM that ``chip_smoke.py`` drives (``LM_SPEC`` of
bench.py, weights from seed 0) and times ``build_network`` twice (the
first build pays one-time set-up on the card). Runs
``TPUModel.transform`` of 20 rows x 1024 tokens (batchSize 8) once to
warm up, then again under ``torch.profiler`` (CPU and CUDA activities),
and prints:
  - the transform's seconds and ``TPUModel.metrics()`` (pad, device,
    readback);
  - the transform window on the device (first to last device activity),
    the union of device activity inside it, and so the device's busy and
    idle shares there;
  - device time by kernel name, largest first.
With ``--trace`` it also writes the profiler's chrome trace there. Exits
1 without a card, or if the profiler records no device activity.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import defaultdict

import numpy as np

from mmlspark_tpu_torch.profile_fit import union_us

# the full-width LM of bench.py (LM_SPEC, bench.py:163-166) and the
# traffic chip_smoke.py drives through it
LM_SPEC = {"type": "transformer", "vocab_size": 32000, "dim": 2048,
           "depth": 8, "heads": 16, "max_len": 1024,
           "head_dtype": "bfloat16"}
ROWS, BATCH = 20, 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default="")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_transform: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.models.networks import build_network
    from mmlspark_tpu_torch.models.tpu_model import TPUModel
    from mmlspark_tpu_torch.ops import flash_attention as FA

    for attempt in ("first", "second"):
        t0 = time.perf_counter()
        lm = build_network(LM_SPEC, device="cuda", seed=0)
        torch.cuda.synchronize()
        print(f"build_network ({attempt}): {time.perf_counter() - t0:.3f} s")
    tokens = np.random.default_rng(7).integers(
        0, LM_SPEC["vocab_size"], size=(ROWS, LM_SPEC["max_len"]))
    table = DataTable({"tokens": tokens})
    model = TPUModel.from_module(lm, device="cuda", inputCol="tokens",
                                 outputCol="logits", batchSize=BATCH)
    model.transform(table)                          # warm-up
    torch.cuda.synchronize()

    model = TPUModel.from_module(lm, device="cuda", inputCol="tokens",
                                 outputCol="logits", batchSize=BATCH)
    FA.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.transform(table)
        torch.cuda.synchronize()
        tr_s = time.perf_counter() - t0
    n_tok = ROWS * LM_SPEC["max_len"]
    print(f"card: {torch.cuda.get_device_name(0)}; LM_SPEC, {ROWS} rows x "
          f"{LM_SPEC['max_len']} tokens, batchSize {BATCH}")
    print(f"transform {tr_s:.3f} s ({n_tok / tr_s:.0f} tokens/s); flash "
          f"launches {dict(FA.LAUNCHES)}")
    for name, summ in model.metrics().items():
        print(f"  {name}: {summ}")

    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        print("profile_transform: the profiler recorded no device "
              "activity", file=sys.stderr)
        return 1
    w0 = min(e.time_range.start for e in dev_events)
    w1 = max(e.time_range.end for e in dev_events)
    busy = union_us([(e.time_range.start, e.time_range.end)
                     for e in dev_events])
    window = w1 - w0
    print(f"transform window on the device {window / 1e3:.3f} ms: busy "
          f"{busy / 1e3:.3f} ms ({100 * busy / window:.1f} %), idle "
          f"{100 * (1 - busy / window):.1f} %")

    by_name = defaultdict(lambda: [0, 0.0])
    for e in dev_events:
        rec = by_name[e.name[:90]]
        rec[0] += 1
        rec[1] += e.time_range.end - e.time_range.start
    total = sum(v[1] for v in by_name.values())
    print(f"device time by kernel ({total / 1e3:.3f} ms in all, copies "
          "and kernels on every stream):")
    for name, (count, us) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:14]:
        print(f"  {us / 1e3:10.3f} ms  {100 * us / total:5.1f} %  "
              f"x{count:<6d} {name}")
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)
        print(f"trace written to {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
