"""Time the GBDT histogram kernel at the launches a fit makes (PyTorch port).

    python3 mmlspark_tpu_torch/profile_hist.py [--root DIR] [--reps 20]
                                               [--json PATH]

Times ``hist_kernels.hist_device`` on the card at F = 28, N = 1M, L = 1,
B = 255 and 63 (the HIGGS shape's bin counts at max_bin 255 and 63), at
the weights the tree grower passes it:
  - 80 % of the rows active (``chip_smoke.py`` phase 2's timed case);
  - a root: every row active;
  - masked right children: a scattered 5 % (the mean right-child share
    of a fit, ``profile_fit.py``) and 1.6 % (the median) of the rows;
  - skewed features at the root: 90 % of each feature's rows in bin 0, a
    binary feature (bins 0 and B - 1), a constant one (all bin 0).
For each: the kernel, its plain version and one ``torch.bincount`` (the
library's way to the same sums), median of ``--reps`` CUDA-event
launches; the kernel's device time by kernel (hist_partial,
hist_reduce) from torch.profiler, and the host's time to issue one call;
the max error against the plain version in float64; and the
bound (the least bytes these inputs need at the card's memory rate). It
uses only ``hist_device``'s public contract, so ``--root`` times the port
of another checkout (an older commit unpacked beside this one) in the
same process layout. Exits 1 without a card or if a case disagrees with
the plain version beyond rtol 1e-5 / atol 1e-3.

``chip_smoke.py`` imports ``hist_inputs``, ``hist_bound_ms``,
``bincount_call`` and ``time_ms`` from here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM CUDA-core rate, outside tensor cores
SECTOR_BYTES = 32           # the unit of a DRAM read
F, N = 28, 1_000_000
# (label, B, active share of rows, skew)
CASES = [("80 % active", 255, 0.8, None),
         ("root", 255, 1.0, None),
         ("child 5 %", 255, 0.05, None),
         ("child 1.6 %", 255, 0.016, None),
         ("root, 90 % in bin 0", 255, 1.0, "bin0_90"),
         ("root, binary", 255, 1.0, "binary"),
         ("root, constant", 255, 1.0, "constant"),
         ("80 % active", 63, 0.8, None),
         ("root", 63, 1.0, None),
         ("child 5 %", 63, 0.05, None)]


def hist_inputs(dev, f, n, num_leaves, num_bins, sdt, seed, active=0.8,
                skew=None):
    """(bins, grad, hess, weight, leaf, count_values) on ``dev`` from a
    seeded torch generator. ``weight`` is a scattered 0/1 mask with the
    share ``active`` of rows set; ``skew`` reshapes the bins as 'bin0_90'
    (90 % of each feature's rows in bin 0), 'binary' (bins 0 and B - 1)
    or 'constant' (all bin 0), drawn after everything else so that the
    other inputs stay those of the unskewed case."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(lo, hi, dt):
        return torch.randint(lo, hi, (n,), generator=g, device=dev,
                             dtype=dt)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)
    bins = torch.randint(0, num_bins, (f, n), generator=g, device=dev,
                         dtype=torch.int32)
    leaf = ints(0, num_leaves, torch.int32)
    if sdt == torch.float32:
        grad = torch.randn(n, generator=g, device=dev)
        hess = rand(n) * 0.9 + 0.1
        w = (rand(n) < active).float()
        out = [bins, grad, hess, w, leaf, None]
    else:
        hi = 120 if sdt == torch.int8 else 2000
        w = (rand(n) < active).to(sdt)
        out = [bins, ints(-hi, hi, sdt), ints(0, hi, sdt), w, leaf,
               ints(0, hi, sdt)]
    if skew == "bin0_90":
        out[0] = torch.where(rand(f, n) < 0.9, 0,
                             bins % max(num_bins - 1, 1) + 1
                             ).clamp_(max=num_bins - 1).to(torch.int32)
    elif skew == "binary":
        out[0] = ((num_bins - 1) * (rand(f, n) < 0.5)).to(torch.int32)
    elif skew == "constant":
        out[0] = torch.zeros_like(bins)
    else:
        assert skew is None, skew
    return tuple(out)


def hist_bound_ms(f, n, w, num_leaves, num_bins, sdt, with_count):
    """Least time for the histogram on these inputs: every row's weight
    read once; the bins, other stats and leaf id read once in each
    32-byte DRAM sector that holds a row of nonzero weight (the only rows
    that contribute); the (3, L, F, B) output written once. Returns
    (ms, "bytes" or "operations")."""
    import torch
    item = torch.tensor([], dtype=sdt).element_size()
    nz = w != 0

    def sector_bytes(itemsize):
        per = SECTOR_BYTES // itemsize
        padded = torch.nn.functional.pad(nz, (0, (-n) % per))
        return SECTOR_BYTES * int(padded.view(-1, per).any(1).sum())
    nbytes = (item * n + f * sector_bytes(4)
              + (3 if with_count else 2) * sector_bytes(item)
              + (sector_bytes(4) if num_leaves > 1 else 0)
              + 3 * num_leaves * f * num_bins * 4)
    ops = 3 * f * int(nz.sum())  # one add per channel per (row, feature)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def bincount_call(bins, grad, hess, w, leaf, num_leaves, num_bins, cv):
    """One torch.bincount with weights on precomputed segment ids — the
    library's way to the same (3, L, F, B) sums; timed as a yardstick,
    never called by the port. The ids and weights are written 64
    features at a time into their final buffers, so building them takes
    no more memory than they hold (3 F N ids and weights: ~41 GB at
    F = 968, N = 1.18M)."""
    import torch
    f, n = bins.shape
    lfb = num_leaves * f * num_bins
    vals = [grad * w, hess * w, w if cv is None else cv * w]
    wdt = torch.float32 if grad.is_floating_point() else torch.float64
    seg3 = torch.empty(3 * f * n, dtype=torch.long, device=bins.device)
    wts = torch.empty(3 * f * n, dtype=wdt, device=bins.device)
    for j0 in range(0, f, 64):
        j1 = min(f, j0 + 64)
        seg = ((leaf.long()[None, :] * f
                + torch.arange(j0, j1, device=bins.device)[:, None])
               * num_bins + bins[j0:j1].long()).reshape(-1)
        for c, v in enumerate(vals):
            lo = (c * f + j0) * n
            seg3[lo:lo + seg.numel()] = seg + c * lfb
            wts[lo:lo + seg.numel()] = v.to(wdt)[None, :].expand(
                j1 - j0, n).reshape(-1)
    return lambda: torch.bincount(seg3, weights=wts, minlength=3 * lfb)


SLEEP_CYCLES = 2_000_000     # ~1 ms of the card's clock


def time_ms(fn, reps=20):
    """Median of ``reps`` CUDA-event timings of fn(), after 3 warm-ups.
    Before each, the card spins for ~1 ms (``torch.cuda._sleep``), so the
    host has issued all of fn() before the first event runs: the time is
    the card's, without the host's time to issue the call."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def device_ms(fn, reps=20):
    """fn()'s device time per call, from torch.profiler over ``reps``
    calls after 3 warm-ups: (total ms, {kernel name: mean ms a launch})
    for the device kernels whose name holds "hist_": a cross-check of
    ``time_ms`` that no host time can enter."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                "hist_" in e.name:
            name = e.name.split("<")[0].split("::")[-1]
            spans.setdefault(name, []).append(
                (e.time_range.end - e.time_range.start) / 1e3)
    # the mean over the launches the profiler recorded (it may drop some)
    by = {k: float(np.mean(v)) for k, v in spans.items()}
    return sum(by.values()), by


def host_us(fn, reps=20):
    """Host microseconds to issue fn() once: ``reps`` calls back to back
    on a warm card, before the final synchronise."""
    import time

    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here,
                    help="checkout whose mmlspark_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", default="", help="also write the rows here")
    args = ap.parse_args()
    # run as a script, its own directory (the package's) heads sys.path;
    # only the checkout named by --root may provide the port
    own = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != own]

    import torch
    if not torch.cuda.is_available():
        print("profile_hist: no CUDA device available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from mmlspark_tpu_torch.gbdt import hist_kernels as HK
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(HK.__file__))))
    if src != root:
        print(f"profile_hist: imported the port from {src}, not {root}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"card: {torch.cuda.get_device_name(0)}; port from {root}; "
          f"F={F}, N={N}, L=1, median of {args.reps} launches")
    rows = []
    for i, (label, B, active, skew) in enumerate(CASES):
        bins, grad, hess, w, leaf, cv = hist_inputs(
            dev, F, N, 1, B, torch.float32, seed=i, active=active, skew=skew)
        out = HK.hist_device(bins, grad, hess, w, leaf, 1, B)
        ref = HK.hist_plain(bins, grad.double(), hess.double(), w.double(),
                            leaf, 1, B)
        err = float((out.double() - ref).abs().max())
        if not torch.allclose(out.double(), ref, rtol=1e-5, atol=1e-3):
            print(f"profile_hist: {label} B={B}: max_abs_err {err}",
                  file=sys.stderr)
            return 1
        def kernel():
            return HK.hist_device(bins, grad, hess, w, leaf, 1, B)
        k_ms = time_ms(kernel, args.reps)
        d_ms, d_by = device_ms(kernel, args.reps)
        h_us = host_us(kernel, args.reps)
        p_ms = time_ms(lambda: HK.hist_plain(bins, grad, hess, w, leaf, 1,
                                             B), args.reps)
        l_ms = time_ms(bincount_call(bins, grad, hess, w, leaf, 1, B, cv),
                       args.reps)
        bd, by = hist_bound_ms(F, N, w, 1, B, torch.float32, False)
        row = dict(case=label, B=B, active=float((w != 0).float().mean()),
                   skew=skew, ms=k_ms, device_ms=d_ms, device_by=d_by,
                   host_us=h_us, plain_ms=p_ms, library_ms=l_ms,
                   bound_ms=bd, bound_by=by, max_abs_err=err)
        rows.append(row)
        dev_note = ", ".join(f"{k} {v:.4f}" for k, v in sorted(d_by.items()))
        print(f"hist {label} (B={B}, {100 * row['active']:.1f} % active): "
              f"kernel {k_ms:.4f} ms (device {dev_note}; host {h_us:.1f} us "
              f"a call), plain {p_ms:.4f} ms, bincount {l_ms:.4f} ms, bound "
              f"{bd:.4f} ms ({by}), kernel/bound {k_ms / bd:.2f}, "
              f"max_abs_err {err:.3e}")
        del bins, grad, hess, w, leaf, out, ref
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump({"card": torch.cuda.get_device_name(0), "root": root,
                       "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
