#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mmlspark_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. build   — compile every kernel under mmlspark_tpu_torch/csrc/ with
               nvcc (sm_90a) and print the seconds it took, the card's
               name and power limit.
  2. kernels — call each kernel's wrapper on the card and hold it against
               its plain PyTorch version on the same inputs: float32
               within rtol 1e-5 / atol 1e-3 of the plain version in
               float64, integer stats bitwise, two launches bitwise equal.
               Time the kernel, its plain version, one library call
               computing the same function, and its bound.
  3. the slice — TPUBoostClassifier.fit -> transform on a 1M x 28
               HIGGS-shaped table (5 rounds, 63 leaves) through the
               kernel, at max_bin 255 and 63; launch counts are reset
               just before each fit and read just after. A third fit on
               the plain scatter path must reach the same holdout AUC
               (within 0.005), and a small fit on the card must agree
               with the same fit on the CPU.
Then one JSON line of per-kernel numbers, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}.

Needs a CUDA card; without one it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM CUDA-core rate, outside tensor cores
SECTOR_BYTES = 32           # the unit of a DRAM read
N_TRAIN, N_TEST = 1_000_000, 100_000


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def higgs_shape(n: int, seed: int = 7):
    """HIGGS-shaped synthetic binary task (the generator of
    tests/test_gbdt_dist_quant.py): 28 dense f32 features."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 28)).astype(np.float32)
    logit = (X[:, 0] + 0.6 * X[:, 1] * X[:, 2]
             + 0.4 * np.sin(2 * X[:, 3]) - 0.3 * X[:, 4] ** 2 + 0.3)
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return X, y


def auc(y, p) -> float:
    order = np.argsort(p, kind="stable")
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    n_pos = int((y == 1).sum())
    n_neg = len(y) - n_pos
    return float((ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from mmlspark_tpu_torch import _build
        from mmlspark_tpu_torch.core.table import DataTable
        from mmlspark_tpu_torch.gbdt import hist_kernels as HK
        from mmlspark_tpu_torch.gbdt.binning import BinMapper
        from mmlspark_tpu_torch.gbdt.estimators import TPUBoostClassifier
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    for name, (secs, log) in built.items():
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "bytes stack" in ln]
        print(f"build: {_build.SOURCES[name]} built in {secs:.1f} s; "
              + " | ".join(regs[:6]))
    print(f"build: all kernels ready in {time.perf_counter() - t0:.1f} s "
          f"({len(built)} compiled); card: {smi}")

    # ---- data and the main path's bin counts -----------------------------
    X, y = higgs_shape(N_TRAIN + N_TEST)
    Xtr, ytr, Xte, yte = X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:], y[N_TRAIN:]
    b255 = int(BinMapper.fit(Xtr, max_bin=255).num_bins.max())
    b63 = int(BinMapper.fit(Xtr, max_bin=63).num_bins.max())
    print(f"data: {Xtr.shape} train, {Xte.shape} holdout; main-path bins "
          f"B={b255} (max_bin 255), B={b63} (max_bin 63)")

    # ---- 2. kernels vs their plain versions ------------------------------
    def inputs(F, N, L, B, sdt, seed):
        g = torch.Generator(device=dev).manual_seed(seed)

        def ints(lo, hi, dt):
            return torch.randint(lo, hi, (N,), generator=g, device=dev,
                                 dtype=dt)
        bins = torch.randint(0, B, (F, N), generator=g, device=dev,
                             dtype=torch.int32)
        leaf = ints(0, L, torch.int32)
        if sdt == torch.float32:
            grad = torch.randn(N, generator=g, device=dev)
            hess = torch.rand(N, generator=g, device=dev) * 0.9 + 0.1
            w = (torch.rand(N, generator=g, device=dev) < 0.8).float()
            return bins, grad, hess, w, leaf, None
        hi = 120 if sdt == torch.int8 else 2000
        w = (torch.rand(N, generator=g, device=dev) < 0.8).to(sdt)
        return (bins, ints(-hi, hi, sdt), ints(0, hi, sdt), w, leaf,
                ints(0, hi, sdt))

    def time_ms(fn, reps=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return float(np.median(ts))

    def bound_ms(F, N, w, L, B, sdt, with_count):
        """Least time for the function on these inputs: every row's
        weight read once; the bins, other stats and leaf id read once in
        each 32-byte DRAM sector that holds a row of nonzero weight (the
        only rows that contribute); the (3, L, F, B) output written once."""
        item = torch.tensor([], dtype=sdt).element_size()
        nz = w != 0

        def sector_bytes(itemsize):
            per = SECTOR_BYTES // itemsize
            padded = torch.nn.functional.pad(nz, (0, (-N) % per))
            return SECTOR_BYTES * int(padded.view(-1, per).any(1).sum())
        nbytes = (item * N + F * sector_bytes(4)
                  + (3 if with_count else 2) * sector_bytes(item)
                  + (sector_bytes(4) if L > 1 else 0) + 3 * L * F * B * 4)
        ops = 3 * F * int(nz.sum())  # one add per channel per (row, feature)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
        return (1e3 * max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    def library_call(bins, grad, hess, w, leaf, L, B, cv):
        """One torch.bincount with weights on precomputed segment ids —
        the library's way to the same (3, L, F, B) sums; timed as a
        yardstick, never called by the port."""
        F, N = bins.shape
        lfb = L * F * B
        seg = ((leaf.long()[None, :] * F
                + torch.arange(F, device=dev)[:, None]) * B
               + bins.long()).reshape(-1)
        vals = [grad * w, hess * w, w if cv is None else cv * w]
        wdt = torch.float32 if grad.is_floating_point() else torch.float64
        seg3 = torch.cat([seg + c * lfb for c in range(3)])
        wts = torch.cat([v.to(wdt)[None, :].expand(F, N).reshape(-1)
                         for v in vals])
        return lambda: torch.bincount(seg3, weights=wts,
                                      minlength=3 * lfb)

    measured = {}
    shapes = [(28, N_TRAIN, 1, 256, torch.float32),
              (28, N_TRAIN, 1, 64, torch.float32),
              (20, 700, 6, 16, torch.float32),
              (28, N_TRAIN, 1, 256, torch.int16),
              (28, N_TRAIN, 1, 256, torch.int8),
              (28, N_TRAIN, 1, b255, torch.float32),
              (28, N_TRAIN, 1, b63, torch.float32)]
    timed = {(28, N_TRAIN, 1, b255), (28, N_TRAIN, 1, b63)}
    for i, (F, N, L, B, sdt) in enumerate(shapes):
        bins, grad, hess, w, leaf, cv = inputs(F, N, L, B, sdt, seed=i)
        out = HK.hist_device(bins, grad, hess, w, leaf, L, B, cv)
        again = HK.hist_device(bins, grad, hess, w, leaf, L, B, cv)
        torch.cuda.synchronize()
        check(torch.equal(out, again),
              f"two launches differ at {(F, N, L, B)} {sdt}")
        tag = f"kernel {str(sdt).split('.')[-1]} (F={F}, N={N}, L={L}, B={B})"
        if sdt == torch.float32:
            ref = HK.hist_plain(bins, grad.double(), hess.double(),
                                w.double(), leaf, L, B)
            err = float((out.double() - ref).abs().max())
            ok = torch.allclose(out.double(), ref, rtol=1e-5, atol=1e-3)
            check(ok, f"{tag}: max_abs_err {err} beyond rtol 1e-5 atol 1e-3")
            print(f"{tag}: max_abs_err {err:.3e} vs float64 plain "
                  "(rtol 1e-5, atol 1e-3); repeat launch bitwise equal")
        else:
            ref = HK.hist_plain(bins, grad, hess, w, leaf, L, B, cv)
            err = float((out.long() - ref.long()).abs().max())
            check(torch.equal(out, ref), f"{tag}: int sums differ ({err})")
            print(f"{tag}: bitwise equal to the plain version (exact "
                  "int32); repeat launch bitwise equal")
        if (F, N, L, B) in timed and sdt == torch.float32:
            lib = library_call(bins, grad, hess, w, leaf, L, B, cv)
            k_ms = time_ms(lambda: HK.hist_device(bins, grad, hess, w, leaf,
                                                  L, B, cv))
            p_ms = time_ms(lambda: HK.hist_plain(bins, grad, hess, w, leaf,
                                                 L, B, cv))
            l_ms = time_ms(lib)
            bd, by = bound_ms(F, N, w, L, B, sdt, cv is not None)
            measured[B] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                               library_ms=l_ms, bound_ms=bd, bound_by=by)
            print(f"{tag}: kernel {k_ms:.4f} ms, plain index_add_ "
                  f"{p_ms:.4f} ms, bincount {l_ms:.4f} ms, bound "
                  f"{bd:.4f} ms ({by})")
        del bins, grad, hess, w, leaf, cv, out, again, ref
    torch.cuda.empty_cache()

    # ---- 3. the slice end to end -----------------------------------------
    train_t = DataTable({"features": Xtr, "label": ytr})
    test_t = DataTable({"features": Xte, "label": yte})

    def fit_transform(label, expect_route, **kw):
        HK.reset_launches()
        t0 = time.perf_counter()
        model = TPUBoostClassifier(numIterations=5, numLeaves=63,
                                   **kw).fit(train_t)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = model.transform(test_t)
        tr_s = time.perf_counter() - t0
        launches = dict(HK.LAUNCHES)
        prob = np.asarray(out["probability"])
        raw = np.asarray(out["rawPrediction"])
        check(prob.shape == (N_TEST, 2) and raw.shape == (N_TEST, 2),
              f"{label}: output shapes {prob.shape} {raw.shape}")
        check(np.isfinite(prob).all() and np.isfinite(raw).all(),
              f"{label}: non-finite outputs")
        check(((prob >= 0) & (prob <= 1)).all(),
              f"{label}: probabilities outside [0, 1]")
        check(set(np.unique(out["prediction"])) <= {0.0, 1.0},
              f"{label}: predictions not in {{0, 1}}")
        a = auc(yte, prob[:, 1])
        booster = model.get_booster()
        if expect_route is None:
            check(sum(launches.values()) == 0,
                  f"{label}: the plain path launched the kernel {launches}")
        else:
            check(booster.params["hist_method"] == "pallas",
                  f"{label}: hist_method {booster.params['hist_method']}")
            check(launches[expect_route] >= 5 * 63,
                  f"{label}: {launches[expect_route]} launches of "
                  f"{expect_route} < 5 x 63")
        print(f"slice {label}: fit {fit_s:.2f} s "
              f"({booster.train_timing}), transform {tr_s:.3f} s, holdout "
              f"AUC {a:.5f}, launches {launches}")
        return a, launches

    auc255, l255 = fit_transform("max_bin=255 kernel", "_hist_kernel_nibble",
                                 histMethod="auto")
    auc63, l63 = fit_transform("max_bin=63 kernel", "_hist_kernel",
                               maxBin=63, histMethod="auto")
    auc_plain, _ = fit_transform("max_bin=255 plain scatter", None,
                                 histMethod="scatter")
    check(abs(auc255 - auc_plain) < 0.005,
          f"kernel AUC {auc255} vs plain {auc_plain}")
    check(auc255 > 0.8, f"holdout AUC {auc255} too low: the model did not "
          "learn")
    print(f"slice: kernel vs plain holdout AUC {auc255:.5f} vs "
          f"{auc_plain:.5f} (|diff| {abs(auc255 - auc_plain):.5f} < 0.005)")

    # a small fit on the card against the same fit on the CPU (the plain
    # version): same trees unless a near-tie split flips
    small = DataTable({"features": Xtr[:20000], "label": ytr[:20000]})
    kw = dict(numIterations=5, numLeaves=15, maxBin=63)
    m_gpu = TPUBoostClassifier(device="cuda", **kw).fit(small)
    m_cpu = TPUBoostClassifier(device="cpu", **kw).fit(small)
    tg, tc = m_gpu.get_booster().trees, m_cpu.get_booster().trees
    same = all(np.array_equal(tg[k], tc[k]) for k in
               ("feature", "bin_threshold", "left", "right"))
    pg = m_gpu.transform(test_t)["probability"][:, 1]
    pc = m_cpu.transform(test_t)["probability"][:, 1]
    diff = float(np.abs(pg - pc).max())
    check(abs(auc(yte, pg) - auc(yte, pc)) < 0.005,
          "card and CPU fits disagree on holdout AUC")
    check(not same or diff < 1e-4,
          f"identical trees but predictions differ by {diff}")
    print(f"slice: 20k-row fit on the card vs on the CPU: trees identical "
          f"{same}, max |p diff| {diff:.3e}")

    kernels = []
    for name, route, B, launches, line in (
            (f"hist (single leaf, B={b255})", "_hist_kernel_nibble", b255,
             l255, 67),
            (f"hist (single leaf, B={b63})", "_hist_kernel", b63, l63, 117)):
        m = measured[B]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/hist.cu",
            "replaces": f"mmlspark_tpu/gbdt/pallas_hist.py:{line}",
            "launches": launches[route], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
