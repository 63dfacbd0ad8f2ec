"""Where the time of one GBDT fit goes on a CUDA card (the PyTorch port).

    python3 -m mmlspark_tpu_torch.profile_fit [--max-bin 255] [--trace PATH]
    python3 mmlspark_tpu_torch/profile_fit.py [--root DIR] [--repeat K] ...

Fits ``mmlspark_tpu_torch.TPUBoostClassifier`` at the configuration that
``chip_smoke.py`` drives (1M rows x 28 features, 5 rounds, 63 leaves)
once to warm up (kernel build, allocator), then fits again on the same
HIGGS-shaped table under
``torch.profiler`` (CPU and CUDA activities) and prints:
  - the booster's phases (``train_timing``: bin, ship, boost, fetch);
  - the share of rows each histogram launch of the warm-up fit saw
    active (nonzero weight): its roots (every row) and its masked right
    children (mean, median, p90), the shares the kernel is timed at;
  - the histogram kernels' device time in the fit, in all and per
    launch;
  - the boost window on the device (first to last histogram-kernel
    launch), the union of device activity inside it, and so the
    device's busy and idle shares there;
  - device time by kernel name, largest first.
With ``--repeat K`` it first times K more fits without the profiler
(fit seconds and phases each). Run as a script path, ``--root`` fits
with the port of another checkout (an older commit unpacked beside this
one), so that two trees compare in one call.
With ``--trace`` it also writes the profiler's chrome trace there (about
70 MB at the default size). Exits 1 without a
card, or if the profiler records no device activity.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import defaultdict

import numpy as np

ROWS, ITERS, LEAVES = 1_000_000, 5, 63


def higgs_shape(n: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 28)).astype(np.float32)
    logit = (X[:, 0] + 0.6 * X[:, 1] * X[:, 2]
             + 0.4 * np.sin(2 * X[:, 3]) - 0.3 * X[:, 4] ** 2 + 0.3)
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return X, y


def union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-bin", type=int, default=255)
    ap.add_argument("--trace", default="")
    ap.add_argument("--repeat", type=int, default=0,
                    help="unprofiled fits timed before the profiled one")
    own = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--root", default=os.path.dirname(own),
                    help="checkout whose mmlspark_tpu_torch is fitted "
                         "(run as a script path to pick another one)")
    args = ap.parse_args()
    # run as a script, its own directory (the package's) heads sys.path;
    # only the checkout named by --root may provide the port
    root = os.path.abspath(args.root)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != own]
    sys.path.insert(0, root)

    import torch
    if not torch.cuda.is_available():
        print("profile_fit: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.gbdt import hist_kernels as HK
    from mmlspark_tpu_torch.gbdt import tree as tree_mod
    from mmlspark_tpu_torch.gbdt.estimators import TPUBoostClassifier
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(HK.__file__))))
    if src != root:
        print(f"profile_fit: imported the port from {src}, not {root}",
              file=sys.stderr)
        return 1

    X, y = higgs_shape(ROWS)
    table = DataTable({"features": X, "label": y})
    est = TPUBoostClassifier(numIterations=ITERS,
                             numLeaves=LEAVES, maxBin=args.max_bin)
    active = []
    grow_build = tree_mod.build_histogram

    def counting(bins, grad, hess, weight, *a, **kw):
        active.append((weight != 0).sum())
        return grow_build(bins, grad, hess, weight, *a, **kw)
    tree_mod.build_histogram = counting
    try:
        est.fit(table)                              # warm-up, counted
    finally:
        tree_mod.build_histogram = grow_build
    torch.cuda.synchronize()
    for i in range(args.repeat):
        t0 = time.perf_counter()
        timing = est.fit(table).get_booster().train_timing
        torch.cuda.synchronize()
        print(f"unprofiled fit {i + 1}/{args.repeat}: "
              f"{time.perf_counter() - t0:.3f} s; phases {timing}")

    HK.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        booster = est.fit(table).get_booster()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    print(f"port from {root}")
    print(f"card: {torch.cuda.get_device_name(0)}; rows {ROWS}, "
          f"iters {ITERS}, leaves {LEAVES}, max_bin "
          f"{args.max_bin}")
    print(f"fit {fit_s:.3f} s; phases {booster.train_timing}; histogram "
          f"launches {dict(HK.LAUNCHES)}")
    # a tree's root sees every row; every other launch is a right child,
    # which holds fewer rows than its tree's root
    counts = torch.stack(active).cpu().numpy().astype(np.int64)
    share = counts / ROWS
    child = share[counts < counts.max()]
    print(f"active rows per histogram launch (warm-up fit): "
          f"{int((counts == counts.max()).sum())} roots at "
          f"{100 * share.max():.1f} %; {child.size} masked children: mean "
          f"{100 * child.mean():.2f} %, median "
          f"{100 * np.median(child):.2f} %, p90 "
          f"{100 * np.percentile(child, 90):.2f} %")

    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        print("profile_fit: the profiler recorded no device "
              "activity", file=sys.stderr)
        return 1
    hist = [e for e in dev_events if "hist_" in e.name]
    if not hist:
        print("profile_fit: no histogram kernel in the trace",
              file=sys.stderr)
        return 1
    w0 = min(e.time_range.start for e in hist)
    w1 = max(e.time_range.end for e in hist)
    inside = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
              for e in dev_events
              if e.time_range.end > w0 and e.time_range.start < w1]
    busy = union_us(inside)
    window = w1 - w0
    print(f"boost window on the device {window / 1e3:.3f} ms: busy "
          f"{busy / 1e3:.3f} ms ({100 * busy / window:.1f} %), idle "
          f"{100 * (1 - busy / window):.1f} %")

    hist_us = sum(e.time_range.end - e.time_range.start for e in hist)
    n_launch = sum(HK.LAUNCHES.values())
    print(f"histogram kernels (hist_partial + hist_reduce) "
          f"{hist_us / 1e3:.3f} ms over {n_launch} launches: "
          f"{hist_us / 1e3 / n_launch:.4f} ms per launch")

    by_name = defaultdict(lambda: [0, 0.0])
    for e in dev_events:
        rec = by_name[e.name[:90]]
        rec[0] += 1
        rec[1] += e.time_range.end - e.time_range.start
    total = sum(v[1] for v in by_name.values())
    print(f"device time by kernel ({total / 1e3:.3f} ms in all):")
    for name, (count, us) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:12]:
        print(f"  {us / 1e3:10.3f} ms  {100 * us / total:5.1f} %  "
              f"x{count:<6d} {name}")
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)
        print(f"trace written to {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
