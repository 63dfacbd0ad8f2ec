"""Where the time of one GBDT fit goes on a CUDA card (the PyTorch port).

    python3 -m mmlspark_tpu_torch.profile_fit [--max-bin 255] [--trace PATH]
        [--hist-bits 32|16|8] [--bagging]
    python3 mmlspark_tpu_torch/profile_fit.py [--root DIR] [--repeat K] ...

Fits ``mmlspark_tpu_torch.TPUBoostClassifier`` at the configuration that
``chip_smoke.py`` drives (1M rows x 28 features, 5 rounds, 63 leaves;
``--hist-bits 16|8`` quantized training, ``--bagging`` bagging 0.8 every
iteration and feature fraction 0.8, seed 7, as ``chip_smoke.py`` phase 7)
once to warm up (kernel build, allocator), then fits again on the same
HIGGS-shaped table under
``torch.profiler`` (CPU and CUDA activities) and prints:
  - the booster's phases (``train_timing``: bin, ship, boost, fetch);
  - the share of rows each histogram launch of the warm-up fit saw
    active (nonzero weight): its roots (each tree's first launch) and
    its masked right children (mean, median, p90), the shares the kernel
    is timed at;
  - with ``--bagging`` or ``--hist-bits`` below 32, the cost of the
    threefry draws on the card (device time and host wall time): one
    iteration's bagging / feature-fraction masks and one tree's
    quantization (three L1 scales and three rounding draws);
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


def threefry_costs(torch) -> dict:
    """What the threefry draws cost on the card at ROWS rows, as
    {what: (device ms, host wall ms)}: the device time (median of
    CUDA-event timings, the host's issue time out) and the host's wall
    time with a synchronise, of one iteration's bagging /
    feature-fraction masks and of one tree's quantization."""
    from mmlspark_tpu_torch.gbdt import prng
    from mmlspark_tpu_torch.gbdt.tree import (quantize_stats,
                                              sample_iteration_masks)
    from mmlspark_tpu_torch.profile_hist import time_ms
    dev = torch.device("cuda")
    key = prng.PRNGKey(7)
    w = torch.ones(ROWS, device=dev)
    fm = torch.ones(28, device=dev)
    g = torch.randn(ROWS, device=dev)
    costs = {}
    for label, fn in (
            ("bagging + feature-fraction masks (one iteration)",
             lambda: sample_iteration_masks(key, 1, w, fm, (0.8, 1), 0.8,
                                            28, 28)),
            ("quantization, 16 bits (one tree)",
             lambda: quantize_stats(g, w * 0.25, w, 16, key))):
        dev_ms = time_ms(fn)
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        costs[label] = (dev_ms, 1e3 * (time.perf_counter() - t0) / 10)
    return costs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-bin", type=int, default=255)
    ap.add_argument("--hist-bits", type=int, default=32,
                    choices=(32, 16, 8))
    ap.add_argument("--bagging", action="store_true",
                    help="bagging 0.8 every iteration, feature fraction 0.8")
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
    from mmlspark_tpu_torch.gbdt import booster as booster_mod
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
    sampled = (dict(baggingFraction=0.8, baggingFreq=1,
                    featureFraction=0.8) if args.bagging else {})
    est = TPUBoostClassifier(numIterations=ITERS, numLeaves=LEAVES,
                             maxBin=args.max_bin, histBits=args.hist_bits,
                             seed=7, **sampled)
    active, roots = [], []
    grow_build, grow = tree_mod.build_histogram, booster_mod.grow_tree

    def counting(bins, grad, hess, weight, *a, **kw):
        active.append((weight != 0).sum())
        return grow_build(bins, grad, hess, weight, *a, **kw)

    def new_tree(*a, **kw):
        roots.append(len(active))       # the tree's first launch is next
        return grow(*a, **kw)
    tree_mod.build_histogram, booster_mod.grow_tree = counting, new_tree
    try:
        est.fit(table)                              # warm-up, counted
    finally:
        tree_mod.build_histogram, booster_mod.grow_tree = grow_build, grow
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
          f"iters {ITERS}, leaves {LEAVES}, max_bin {args.max_bin}, "
          f"hist_bits {args.hist_bits}, bagging / feature fraction "
          f"{'0.8 / 0.8' if args.bagging else 'off'}")
    print(f"fit {fit_s:.3f} s; phases {booster.train_timing}; histogram "
          f"launches {dict(HK.LAUNCHES)}, by stats type "
          f"{dict(HK.LAUNCHES_BY_TYPE)}")
    # each tree's first launch is its root; every other launch is a
    # masked right child
    counts = torch.stack(active).cpu().numpy().astype(np.int64)
    share = counts / ROWS
    is_root = np.zeros(len(counts), bool)
    is_root[roots] = True
    child = share[~is_root]
    print(f"active rows per histogram launch (warm-up fit): "
          f"{int(is_root.sum())} roots at {100 * share[is_root].mean():.1f} "
          f"% on average; {child.size} masked children: mean "
          f"{100 * child.mean():.2f} %, median "
          f"{100 * np.median(child):.2f} %, p90 "
          f"{100 * np.percentile(child, 90):.2f} %")
    if args.bagging or args.hist_bits < 32:
        for label, (dev_ms, wall_ms) in threefry_costs(torch).items():
            print(f"threefry draws, {label}: device {dev_ms:.3f} ms, host "
                  f"wall {wall_ms:.3f} ms")

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
