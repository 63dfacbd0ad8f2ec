#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mmlspark_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. build   — compile every kernel under mmlspark_tpu_torch/csrc/ with
               nvcc (sm_90a) and print the seconds it took, the card's
               name and power limit; then each flash kernel's registers,
               spills and shared memory (-Xptxas -v) and its count of
               HMMA instructions (cuobjdump -sass), and the blocks per SM
               and shared memory of the f32 forward, bf16 flash_dq and
               f32 flash_dq / flash_dkv at D = 128. Fails if a flash
               kernel (forward, flash_dq and flash_dkv, bf16 and f32 in
               3xTF32) has no HMMA, if one spills at D = 128, or without
               cuobjdump.
  2. kernels — call each kernel's wrapper on the card and hold it against
               its plain PyTorch version on the same inputs: float32
               within rtol 1e-5 / atol 1e-3 of the plain version in
               float64, integer stats bitwise, two launches bitwise equal;
               the hist cases include a fit's root (every row active), its
               mean masked right child (a scattered 5 % of the rows) and
               skewed bins (90 % in bin 0, binary, constant) in f32, int16
               and int8. Print the hist kernel's registers, spills, launch
               plan and blocks per SM. Time the kernel, its plain version,
               one library call computing the same function, and its bound
               (hist: at 80 % active as before, the root, the 5 % child and
               the 90 %-in-bin-0 root).
  2b. flash  — the flash-attention kernel against its plain version in
               float64 (f32 within rtol 1e-4 / atol 1e-4; bf16 out within
               one bf16 rounding, rtol 2**-8), at the slice's shape
               (8, 1024, 16, 128) causal, the ragged, offset, fully
               masked and D = 160 cases, the tile edges (Lq, Lk in
               {1, 17, 65, 1000}, D in {8, 20, 64, 256}), a causal
               L = 8192 and unaligned views; two launches bitwise equal;
               in bf16, SDPA's error
               on the same inputs beside the kernel's. Time the kernel,
               its plain version, SDPA and the bound at the slice's shape
               in f32 and bf16.
  2c. flash backward — the flash_dq / flash_dkv kernels against their
               plain version in float64 on the same cases (dq, dk, dv with
               2b's tolerances); two launches bitwise equal; in bf16,
               SDPA's backward error beside them. At the slice's
               shape, time each kernel, the plain version, SDPA's backward
               and each kernel's bound, in f32 and bf16.
  3. GBDT slice — TPUBoostClassifier.fit -> transform on a 1M x 28
               HIGGS-shaped table (5 rounds, 63 leaves) through the
               kernel, at max_bin 255 and 63; launch counts are reset
               just before each fit and read just after. A third fit on
               the plain scatter path must reach the same holdout AUC
               (within 0.005), and a small fit on the card must agree
               with the same fit on the CPU.
  4. DNN slice — TPUModel.transform of 20 rows x 1024 tokens through the
               full-width LM of bench.py (LM_SPEC, seeded weights):
               exactly 8 flash launches per batch (24), finite logits of
               shape (20, 1024, 32000), rows 16-19 alone equal to the
               full run, and a depth-2 f32 model agreeing on the card
               and on the CPU (max |logit diff| <= 1e-3, argmax equal on
               >= 99.9 % of positions).
  5. training slice — TPULearner.fit of the full-width LM (LM_SPEC,
               token cross-entropy, AdamW at 1e-3, bf16 compute, device
               feed) over 32 rows x 1024 tokens for 2 epochs (8 steps of
               8): exactly 64 launches of each flash kernel, 8 finite
               losses with the last below the first, the returned model
               scoring finite logits; the same fit in f32 compute (the
               f32 flash kernels, strict-f32 GEMMs) with the same checks,
               step seconds, tokens/s and peak memory; then a depth-2
               f32 model trained 2
               SGD steps at batch 2, L = 512 on the card and on the CPU
               from the same weights (losses within rtol 1e-4, weights
               within 1e-3 of the largest update).
Then one JSON line of per-kernel numbers, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}.

Needs a CUDA card; without one it exits 1 and prints no result.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate
# useful f32-contract work on the tensor cores: 3 TF32 products (3xTF32) per
# f32 product at the dense TF32 rate, the least time for f32 attention
F32_CONTRACT_OPS_PER_S = 495e12 / 3
N_TRAIN, N_TEST = 1_000_000, 100_000
# (B, Lq, Lk, H, D, causal, q_offset, k_offset): the slice's attention,
# the ragged cases of tests/test_flash_attention.py, shard offsets, a
# fully masked shard, a wide head, the tile edges of the tensor-core
# route (Lq, Lk in {1, 17, 65, 1000}, D in {8, 20, 64, 256}), and a long
# causal sequence, where sums accumulated inside the tensor cores (which
# truncate) would drift past the f32 tolerance
FLASH_MAIN = (8, 1024, 1024, 16, 128, True, 0, 0)
FLASH_CASES = [FLASH_MAIN,
               (2, 100, 100, 3, 16, True, 0, 0),
               (2, 300, 520, 3, 16, False, 0, 0),
               (2, 520, 300, 3, 16, True, 0, 0),
               (2, 100, 100, 3, 16, True, 64, 0),
               (2, 100, 100, 3, 16, True, 0, 1000),
               (1, 300, 300, 2, 160, True, 0, 0),
               (1, 1, 1, 2, 64, True, 0, 0),
               (1, 17, 65, 2, 20, False, 0, 0),
               (1, 65, 17, 2, 8, True, 0, 0),
               (1, 65, 1000, 2, 64, True, 935, 0),
               (1, 1000, 65, 3, 64, False, 0, 0),
               (2, 1000, 1000, 2, 256, True, 0, 0),
               (1, 8192, 8192, 1, 128, True, 0, 0)]
# q, k, v as views one element into wider rows: no row is 16-byte aligned
FLASH_UNALIGNED = (1, 300, 300, 2, 64, True, 0, 0)
# the tensor-core kernels by library (bf16, and f32 in 3xTF32); each must
# run HMMA instructions, and at D = 128 (the slice's head) spill nothing
TC_KERNELS = {"flash_fwd": ("flash_fwd_bf16", "flash_fwd_tf32x3"),
              "flash_bwd": ("flash_dkv_bf16", "flash_dq_bf16",
                            "flash_dkv_tf32x3", "flash_dq_tf32x3")}
TC_AT_128 = ("flash_fwd_bf16<128>", "flash_fwd_tf32x3<128>",
             "flash_dkv_bf16<128, 1>", "flash_dq_bf16<128, 1>",
             "flash_dkv_tf32x3<128>", "flash_dq_tf32x3<128, 1>")
# the kernels whose blocks per SM phase 1 prints at D = 128: (kernel,
# library, C entry)
OCCUPANCY = (("flash_fwd_tf32x3<128>", "flash_fwd",
              "mml_flash_fwd_f32_occupancy"),
             ("flash_dq_bf16<128, 1>", "flash_bwd",
              "mml_flash_dq_bf16_occupancy"),
             ("flash_dq_tf32x3<128, 1>", "flash_bwd",
              "mml_flash_dq_f32_occupancy"),
             ("flash_dkv_tf32x3<128>", "flash_bwd",
              "mml_flash_dkv_f32_occupancy"))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def short_name(mangled: str) -> str:
    """``flash_fwd_bf16<128>`` for the mangled name of a kernel in the
    port's anonymous namespace (template arguments: ints, float, bf16)."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, name = 3, mangled
    while True:      # length-prefixed components: namespace, then name
        m = re.compile(r"(\d+)").match(mangled, i)
        if m is None:
            break
        i = m.end() + int(m.group(1))
        name = mangled[m.end():i]
    if i >= len(mangled) or mangled[i] != "I":
        return name
    args, i = [], i + 1
    while i < len(mangled) and mangled[i] != "E":
        lit = re.compile(r"Li(-?\d+)E").match(mangled, i)
        num = re.compile(r"(\d+)").match(mangled, i)
        if lit:
            args.append(lit.group(1))
            i = lit.end()
        elif num:
            j = num.end() + int(num.group(1))
            args.append(mangled[num.end():j])
            i = j
        else:
            args.append({"f": "float", "i": "int", "s": "short",
                         "a": "signed char"}.get(mangled[i], mangled[i]))
            i += 1
    return f"{name}<{', '.join(args)}>"


def ptxas_table(log: str):
    """{kernel: [registers, spill store bytes, spill load bytes, shared
    bytes]} from the ``nvcc -Xptxas -v`` output of a build."""
    table, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", ln)
        if m:
            name = short_name(m.group(1))
            table.setdefault(name, [0, 0, 0, 0])
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            table[name][1:3] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            table[name][0] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            table[name][3] = int(m.group(1))
    return table


def hmma_counts(lib) -> dict:
    """{kernel: number of HMMA (tensor-core) instructions} in the SASS of
    a built library, read with cuobjdump; fails where cuobjdump is
    missing."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(os.path.exists(exe), "cuobjdump not found: cannot show that the "
          "bf16 kernels run on the tensor cores")
    sass = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump -sass {lib}: {sass.stderr}")
    counts, name = {}, None
    for ln in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = short_name(m.group(1))
            counts[name] = 0
        elif name is not None and "HMMA" in ln:
            counts[name] += 1
    return counts


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
        from mmlspark_tpu_torch.models.learner import TPULearner
        from mmlspark_tpu_torch.models.networks import build_network
        from mmlspark_tpu_torch.models.tpu_model import TPUModel
        from mmlspark_tpu_torch.ops import flash_attention as FA
        from mmlspark_tpu_torch.profile_hist import (
            bincount_call, device_ms, hist_bound_ms, hist_inputs, time_ms)
        from mmlspark_tpu_torch.profile_train import (
            BATCH as TRAIN_BATCH, slice_table)
        from mmlspark_tpu_torch.profile_transform import (
            BATCH as LM_BATCH, LM_SPEC, ROWS as LM_ROWS)
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
        print(f"build: {_build.SOURCES[name]} built in {secs:.1f} s")
    print(f"build: all kernels ready in {time.perf_counter() - t0:.1f} s "
          f"({len(built)} compiled); card: {smi}")
    # registers, spills and tensor-core instructions of every flash kernel
    for lib, tcs in TC_KERNELS.items():
        ptx = ptxas_table(_build.build_log(lib))
        check(bool(ptx), f"no -Xptxas -v output kept for {lib}")
        hmma = hmma_counts(_build.library_path(lib))
        for kname in sorted(set(ptx) | set(hmma)):
            regs, sst, sld, sm = ptx.get(kname, [0, 0, 0, 0])
            print(f"build: {kname}: {regs} registers, spill stores {sst} B "
                  f"/ loads {sld} B, {sm} B static smem, "
                  f"{hmma.get(kname, 0)} HMMA")
            if kname.startswith(tcs):
                check(hmma.get(kname, 0) > 0,
                      f"{kname} runs no tensor-core (HMMA) instruction")
            if kname in TC_AT_128:
                check(sst == 0 and sld == 0,
                      f"{kname} spills at D = 128 ({sst} / {sld} B)")
        for tc in tcs:
            check(any(n.startswith(tc) for n in hmma),
                  f"no {tc} kernel in the SASS of {lib}")
    for kname, lib, entry in OCCUPANCY:
        occ = (ctypes.c_int * 2)()
        err = getattr(_build.load(lib), entry)(128, occ)
        check(err == 0 and occ[0] > 0, f"{entry}: cudaError_t {err}, "
              f"{occ[0]} blocks per SM")
        print(f"build: {kname}: {occ[0]} blocks per SM, {occ[1]} B of "
              "dynamic shared memory each")

    # ---- data and the main path's bin counts -----------------------------
    X, y = higgs_shape(N_TRAIN + N_TEST)
    Xtr, ytr, Xte, yte = X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:], y[N_TRAIN:]
    b255 = int(BinMapper.fit(Xtr, max_bin=255).num_bins.max())
    b63 = int(BinMapper.fit(Xtr, max_bin=63).num_bins.max())
    print(f"data: {Xtr.shape} train, {Xte.shape} holdout; main-path bins "
          f"B={b255} (max_bin 255), B={b63} (max_bin 63)")

    # ---- 2. kernels vs their plain versions ------------------------------
    plan = HK.launch_plan(28, N_TRAIN, 1, b255)
    occ = ctypes.c_int(0)
    err = _build.load("hist").mml_hist_occupancy(
        plan.n_warps, plan.smem_bytes, ctypes.byref(occ))
    check(err == 0 and occ.value > 0, f"mml_hist_occupancy: cudaError_t "
          f"{err}, {occ.value} blocks per SM")
    for kname, (regs, sst, sld, sm) in sorted(
            ptxas_table(_build.build_log("hist")).items()):
        print(f"build: {kname}: {regs} registers, spill stores {sst} B / "
              f"loads {sld} B, {sm} B static smem")
    print(f"kernel hist plan at (F=28, N={N_TRAIN}, L=1, B={b255}): {plan}; "
          f"{occ.value} blocks per SM")

    measured = {}
    # (F, N, L, B, stats type, active share, skew); the timed cases are
    # keyed by what they stand for in `measured`: the 80 %-active cases at
    # the main path's bin counts (as before), a fit's root (every row), a
    # fit's mean masked right child (a scattered 5 % of the rows), and the
    # skewed worst case (90 % of each feature's rows in bin 0, at a root)
    shapes = [(28, N_TRAIN, 1, 256, torch.float32, 0.8, None),
              (28, N_TRAIN, 1, 64, torch.float32, 0.8, None),
              (20, 700, 6, 16, torch.float32, 0.8, None),
              (28, N_TRAIN, 1, 256, torch.int16, 0.8, None),
              (28, N_TRAIN, 1, 256, torch.int8, 0.8, None),
              (28, N_TRAIN, 1, b255, torch.float32, 0.8, None),
              (28, N_TRAIN, 1, b63, torch.float32, 0.8, None),
              (28, N_TRAIN, 1, b255, torch.float32, 1.0, None),
              (28, N_TRAIN, 1, b255, torch.float32, 0.05, None)]
    shapes += [(28, N_TRAIN, 1, b255, sdt, 1.0, skew)
               for skew in ("bin0_90", "binary", "constant")
               for sdt in (torch.float32, torch.int16, torch.int8)]
    timed = {(28, N_TRAIN, 1, b255, 0.8, None): b255,
             (28, N_TRAIN, 1, b63, 0.8, None): b63,
             (28, N_TRAIN, 1, b255, 1.0, None): "root",
             (28, N_TRAIN, 1, b255, 0.05, None): "child",
             (28, N_TRAIN, 1, b255, 1.0, "bin0_90"): "bin0_90"}
    for i, (F, N, L, B, sdt, active, skew) in enumerate(shapes):
        bins, grad, hess, w, leaf, cv = hist_inputs(
            dev, F, N, L, B, sdt, seed=i, active=active, skew=skew)
        out = HK.hist_device(bins, grad, hess, w, leaf, L, B, cv)
        again = HK.hist_device(bins, grad, hess, w, leaf, L, B, cv)
        torch.cuda.synchronize()
        check(torch.equal(out, again),
              f"two launches differ at {(F, N, L, B)} {sdt} {active} {skew}")
        tag = (f"kernel {str(sdt).split('.')[-1]} (F={F}, N={N}, L={L}, "
               f"B={B}" + (f", {100 * active:g} % active" if active != 0.8
                           else "") + (f", bins {skew}" if skew else "")
               + ")")
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
        key = timed.get((F, N, L, B, active, skew))
        if key is not None and sdt == torch.float32:
            lib = bincount_call(bins, grad, hess, w, leaf, L, B, cv)
            k_ms = time_ms(lambda: HK.hist_device(bins, grad, hess, w, leaf,
                                                  L, B, cv))
            p_ms = time_ms(lambda: HK.hist_plain(bins, grad, hess, w, leaf,
                                                 L, B, cv))
            l_ms = time_ms(lib)
            d_ms, _ = device_ms(lambda: HK.hist_device(
                bins, grad, hess, w, leaf, L, B, cv))
            bd, by = hist_bound_ms(F, N, w, L, B, sdt, cv is not None)
            measured[key] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                 library_ms=l_ms, bound_ms=bd, bound_by=by)
            print(f"{tag}: kernel {k_ms:.4f} ms (device time {d_ms:.4f} ms, "
                  f"torch.profiler), plain index_add_ {p_ms:.4f} ms, "
                  f"bincount {l_ms:.4f} ms, bound {bd:.4f} ms ({by})")
            del lib
        del bins, grad, hess, w, leaf, cv, out, again, ref
    torch.cuda.empty_cache()

    # ---- 2b. flash-attention kernel vs its plain version -----------------
    def flash_bound_ms(case, dtype):
        """Least time on these inputs: q, k, v read once and O, LSE
        written once at the memory rate, or 4*D flops per unmasked
        (query, key) pair at the input type's tensor-core peak (f32:
        3xTF32), whichever is larger."""
        b, lq, lk, h, d, causal, qo, ko = case
        item = torch.tensor([], dtype=dtype).element_size()
        pairs = lq * lk
        if causal:
            pairs = int(np.clip(np.arange(lq) + qo - ko + 1, 0, lk).sum())
        nbytes = item * b * h * d * (2 * lq + 2 * lk) + 4 * b * h * lq
        rate = (F32_CONTRACT_OPS_PER_S if dtype == torch.float32
                else BF16_OPS_PER_S)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = 4 * d * pairs * b * h / rate
        return (1e3 * max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def flash_qkv(case, dtype, g, unaligned):
        """q, k, v of a case; unaligned: views one element into rows of
        D + 1, so that no row starts on a 16-byte boundary."""
        b, lq, lk, h, d = case[:5]
        e = int(unaligned)
        return tuple(torch.randn((b, n, h, d + e), generator=g, device=dev
                                 ).to(dtype)[..., e:] for n in (lq, lk, lk))

    def sdpa_on(case, q, k, v, dout=None):
        """SDPA on the same inputs, masked on the same global positions:
        out, or (dq, dk, dv) for the output gradient dout. A yardstick of
        accuracy only; the port never calls it."""
        lq, lk, causal, qo, ko = case[1], case[2], *case[5:]
        mask = None
        if causal:
            mask = (torch.arange(lq, device=dev)[:, None] + qo
                    >= torch.arange(lk, device=dev)[None, :] + ko)
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(
            dout is not None) for t in (q, k, v))
        out = sdpa(qt, kt, vt, attn_mask=mask)
        if dout is None:
            return out.detach().transpose(1, 2)
        grads = torch.autograd.grad(out, (qt, kt, vt), dout.transpose(1, 2))
        return tuple(x.transpose(1, 2) for x in grads)

    def err_of(x, ref):
        """max |x - ref| over finite entries, and the non-finite count
        (SDPA gives NaN on rows whose keys are all masked)."""
        dx = (x.double() - ref).abs()
        fin = torch.isfinite(dx)
        return (float(dx[fin].max()) if bool(fin.any()) else float("nan"),
                int((~fin).sum()))

    def sdpa_note(errs):
        return "; SDPA max_abs_err " + ", ".join(
            f"{n} {e:.3e}" + (f" ({bad} non-finite)" if bad else "")
            for n, (e, bad) in errs.items())

    flash_all = ([(c, False) for c in FLASH_CASES]
                 + [(FLASH_UNALIGNED, True)])
    flash_measured = {}
    for ci, (case, unaligned) in enumerate(flash_all):
        b, lq, lk, h, d, causal, qo, ko = case
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(100 + ci)
            q, k, v = flash_qkv(case, dtype, g, unaligned)
            out, lse = FA.flash_forward(q, k, v, causal, qo, ko)
            out2, lse2 = FA.flash_forward(q, k, v, causal, qo, ko)
            torch.cuda.synchronize()
            tag = (f"flash {str(dtype).split('.')[-1]} (B={b}, Lq={lq}, "
                   f"Lk={lk}, H={h}, D={d}, causal={causal}, "
                   f"offsets={qo}/{ko}{', unaligned views' * unaligned})")
            check(torch.equal(out, out2) and torch.equal(lse, lse2),
                  f"{tag}: two launches differ")
            rout, rlse = FA.flash_forward_plain(q.double(), k.double(),
                                                v.double(), causal, qo, ko)
            err = float((out.double() - rout).abs().max())
            lerr = float((lse.double() - rlse).abs().max()
                         / max(1.0, float(rlse.abs().max())))
            rtol, atol = ((1e-4, 1e-4) if dtype == torch.float32
                          else (2 ** -8, 1e-5))
            check(torch.allclose(out.double(), rout, rtol=rtol, atol=atol),
                  f"{tag}: out max_abs_err {err} beyond rtol {rtol} "
                  f"atol {atol}")
            check(torch.allclose(lse.double(), rlse, rtol=1e-4, atol=1e-4),
                  f"{tag}: lse beyond rtol 1e-4 atol 1e-4")
            note = ("" if dtype == torch.float32 else sdpa_note(
                {"out": err_of(sdpa_on(case, q, k, v), rout)}))
            print(f"{tag}: out max_abs_err {err:.3e} vs float64 plain "
                  f"(rtol {rtol:g}, atol {atol:g}), lse rel err "
                  f"{lerr:.1e}; repeat launch bitwise equal{note}")
            if case == FLASH_MAIN:
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v))
                k_ms = time_ms(lambda: FA.flash_forward(q, k, v, causal))
                p_ms = time_ms(lambda: FA.flash_forward_plain(q, k, v,
                                                              causal))
                l_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
                bd, by = flash_bound_ms(case, dtype)
                flash_measured[dtype] = dict(
                    max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                    bound_ms=bd, bound_by=by)
                print(f"{tag}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                      f"SDPA {l_ms:.4f} ms, bound {bd:.4f} ms ({by})")
                del qt, kt, vt
            del q, k, v, out, lse, out2, lse2, rout, rlse
    torch.cuda.empty_cache()

    # ---- 2c. flash-attention backward kernels vs their plain version -----
    def flash_bwd_bound_ms(case, dtype, kernel):
        """Least time on these inputs: q, k, v, dO read once with LSE and
        delta, and the kernel's outputs (dQ, or dK and dV) written once,
        at the memory rate; or its flops per unmasked pair (6·D for dQ,
        8·D for dK and dV) at the input type's tensor-core peak (f32:
        3xTF32); whichever is larger."""
        b, lq, lk, h, d, causal, qo, ko = case
        item = torch.tensor([], dtype=dtype).element_size()
        outs = lq if kernel == "_dq_kernel" else 2 * lk
        nbytes = (item * b * h * d * (2 * lq + 2 * lk + outs)
                  + 2 * 4 * b * h * lq)
        rate = (F32_CONTRACT_OPS_PER_S if dtype == torch.float32
                else BF16_OPS_PER_S)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = (FA.FLOPS_PER_PAIR[kernel] * d * b * h
                 * FA.unmasked_pairs(lq, lk, causal, qo, ko) / rate)
        return (1e3 * max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    bwd_measured = {}
    for ci, (case, unaligned) in enumerate(flash_all):
        b, lq, lk, h, d, causal, qo, ko = case
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(200 + ci)
            q, k, v = flash_qkv(case, dtype, g, unaligned)
            out, lse = FA.flash_forward(q, k, v, causal, qo, ko)
            dout = torch.randn(out.shape, generator=g, device=dev).to(dtype)
            got = FA.flash_backward(q, k, v, out, lse, dout, causal, qo, ko)
            again = FA.flash_backward(q, k, v, out, lse, dout, causal, qo,
                                      ko)
            torch.cuda.synchronize()
            tag = (f"flash bwd {str(dtype).split('.')[-1]} (B={b}, Lq={lq}, "
                   f"Lk={lk}, H={h}, D={d}, causal={causal}, "
                   f"offsets={qo}/{ko}{', unaligned views' * unaligned})")
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"{tag}: two launches differ")
            ref = FA.flash_backward_plain(q.double(), k.double(), v.double(),
                                          out.double(), lse.double(),
                                          dout.double(), causal, qo, ko)
            rtol, atol = ((1e-4, 1e-4) if dtype == torch.float32
                          else (2 ** -8, 1e-5))
            errs = {}
            for name, x, r in zip(("dq", "dk", "dv"), got, ref):
                errs[name] = float((x.double() - r).abs().max())
                check(torch.allclose(x.double(), r, rtol=rtol, atol=atol),
                      f"{tag}: {name} max_abs_err {errs[name]} beyond rtol "
                      f"{rtol} atol {atol}")
            note = ("" if dtype == torch.float32 else sdpa_note(
                {n: err_of(x, r) for n, x, r in zip(
                    ("dq", "dk", "dv"), sdpa_on(case, q, k, v, dout), ref)}))
            print(f"{tag}: max_abs_err dq {errs['dq']:.3e} dk "
                  f"{errs['dk']:.3e} dv {errs['dv']:.3e} vs float64 plain "
                  f"(rtol {rtol:g}, atol {atol:g}); repeat launch bitwise "
                  f"equal{note}")
            if case == FLASH_MAIN:
                args = (q, k, v, out, lse, dout, causal)
                delta = FA.flash_delta(out, dout)
                kargs = (q, k, v, dout, lse, delta, causal)
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              .requires_grad_(True) for t in (q, k, v))
                sdpa_out = torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True)
                g_t = dout.transpose(1, 2).contiguous()
                dq_ms = time_ms(lambda: FA.flash_dq_cuda(*kargs))
                dkv_ms = time_ms(lambda: FA.flash_dkv_cuda(*kargs))
                p_ms = time_ms(lambda: FA.flash_backward_plain(*args))
                l_ms = time_ms(lambda: torch.autograd.grad(
                    sdpa_out, (qt, kt, vt), g_t, retain_graph=True))
                for kernel, ms, err in (
                        ("_dq_kernel", dq_ms, errs["dq"]),
                        ("_dkv_kernel", dkv_ms, max(errs["dk"], errs["dv"]))):
                    bd, by = flash_bwd_bound_ms(case, dtype, kernel)
                    bwd_measured[(kernel, dtype)] = dict(
                        max_abs_err=err, ms=ms, plain_ms=p_ms,
                        library_ms=l_ms, bound_ms=bd, bound_by=by)
                    print(f"{tag}: {kernel} {ms:.4f} ms, bound {bd:.4f} ms "
                          f"({by})")
                print(f"{tag}: plain backward (dq, dk, dv) {p_ms:.4f} ms, "
                      f"SDPA backward (dq, dk, dv) {l_ms:.4f} ms")
                del qt, kt, vt, sdpa_out, g_t, args, kargs, delta
            del q, k, v, out, lse, dout, got, again, ref
    torch.cuda.empty_cache()

    # ---- 3. the GBDT slice end to end ------------------------------------
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

    # ---- 4. the DNN slice: TPUModel.transform through the full-width LM --
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = build_network(LM_SPEC, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    w_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    tokens = np.random.default_rng(7).integers(
        0, LM_SPEC["vocab_size"], size=(LM_ROWS, LM_SPEC["max_len"]))
    table = DataTable({"tokens": tokens})
    model = TPUModel.from_module(lm, device="cuda", inputCol="tokens",
                                 outputCol="logits", batchSize=LM_BATCH)
    FA.reset_launches()
    t0 = time.perf_counter()
    scored = model.transform(table)
    torch.cuda.synchronize()
    tr_s = time.perf_counter() - t0
    lm_launches = FA.LAUNCHES["_fwd_kernel"]
    n_batches = -(-LM_ROWS // LM_BATCH)
    check(lm_launches == LM_SPEC["depth"] * n_batches,
          f"LM transform launched the flash kernel {lm_launches} times, "
          f"not {LM_SPEC['depth']} x {n_batches}")
    met = model.metrics()
    logits = scored["logits"]
    want = (LM_ROWS, LM_SPEC["max_len"], LM_SPEC["vocab_size"])
    check(logits.shape == want and logits.dtype == np.float32,
          f"logits {logits.shape} {logits.dtype}, want {want} float32")
    check(bool(np.isfinite(logits).all()), "non-finite logits")
    peak = torch.cuda.max_memory_allocated()
    n_tok = LM_ROWS * LM_SPEC["max_len"]
    print(f"LM slice: {w_bytes / 1e9:.3f} GB of weights on the card "
          f"(init {init_s:.2f} s), peak device memory {peak / 1e9:.3f} GB")
    print(f"LM slice: transform {LM_ROWS} x {LM_SPEC['max_len']} tokens in "
          f"{tr_s:.3f} s ({n_tok / tr_s:.0f} tokens/s), {n_batches} batches "
          f"of {LM_BATCH}, flash launches {lm_launches}; pad_ms "
          f"{met['pad_ms']}, device_ms {met['device_ms']}")
    print(f"LM slice: readback of {logits.nbytes / 1e9:.3f} GB of f32 "
          f"logits, readback_ms {met['readback_ms']}")
    t0 = time.perf_counter()
    model.transform(table)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"LM slice: warm transform {warm_s:.3f} s "
          f"({n_tok / warm_s:.0f} tokens/s)")
    tail = model.transform(DataTable({"tokens": tokens[16:20]}))["logits"]
    tail_err = float(np.abs(tail - logits[16:20]).max())
    check(tail_err <= 1e-5, f"rows 16-19 alone differ from the full run by "
          f"{tail_err}")
    print(f"LM slice: rows 16-19 alone vs the full run: max |diff| "
          f"{tail_err:.3e} (<= 1e-5)")
    del lm, model, scored, logits, tail
    torch.cuda.empty_cache()

    # the same depth-2 f32 model on the card (flash kernel) and on the CPU
    # (its plain version); an f32 head, since a bf16 head rounds logits to
    # 2**-8 relative, above the 1e-3 held here
    spec2 = dict(LM_SPEC, depth=2, head_dtype="float32")
    m2 = build_network(spec2, device="cuda", seed=1)
    row = torch.from_numpy(tokens[:1])
    with torch.inference_mode():
        on_card = m2(row.to(dev)).cpu()
    m2 = m2.to("cpu")
    with torch.inference_mode():
        on_cpu = m2(row)
    l_diff = float((on_card - on_cpu).abs().max())
    agree = float((on_card.argmax(-1) == on_cpu.argmax(-1)).double().mean())
    check(l_diff <= 1e-3, f"depth-2 card vs CPU logits differ by {l_diff}")
    check(agree >= 0.999, f"depth-2 card vs CPU argmax agree on {agree}")
    print(f"LM slice: depth-2 f32 card vs CPU: max |logit diff| "
          f"{l_diff:.3e} (<= 1e-3), argmax equal on {100 * agree:.2f} % "
          "of positions")
    del m2, on_card, on_cpu

    # ---- 5. the training slice: TPULearner.fit of the full-width LM ------
    train_rows = 32
    train_table = slice_table(train_rows)
    n_steps = 2 * train_rows // TRAIN_BATCH

    def train_slice(dtype: str) -> dict:
        """Fit the full-width LM for 2 epochs in compute type dtype; check
        the launches, losses and scores; return the flash launches. The
        tokens are random, so the loss falls only where the second epoch
        repeats rows."""
        learner = TPULearner(
            networkSpec=LM_SPEC, loss="token_cross_entropy",
            optimizer="adamw", learningRate=1e-3, batchSize=TRAIN_BATCH,
            computeDtype=dtype, dataFeed="device", epochs=2, logEvery=1)
        torch.cuda.reset_peak_memory_stats()
        FA.reset_launches()
        t0 = time.perf_counter()
        trained = learner.fit(train_table)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = dict(FA.LAUNCHES)
        want_l = LM_SPEC["depth"] * n_steps
        check(all(v == want_l for v in launches.values()),
              f"{dtype} training launched the flash kernels {launches} "
              f"times, not {want_l} each")
        losses = [h["loss"] for h in learner.history]
        check(len(losses) == n_steps and all(np.isfinite(losses)),
              f"{dtype} training losses {losses}")
        check(losses[-1] < losses[0],
              f"{dtype} training loss did not fall: {losses}")
        peak = torch.cuda.max_memory_allocated()
        tm = learner.timing
        step_s = tm["wall_s"] / tm["steps_timed"]
        tag = f"training slice {dtype}"
        print(f"{tag}: {n_steps} steps of {TRAIN_BATCH} x "
              f"{LM_SPEC['max_len']} tokens (AdamW, allow_tf32 "
              f"{torch.backends.cuda.matmul.allow_tf32}) in {fit_s:.3f} s "
              f"(build and first step included); flash launches "
              f"{launches}; peak device memory {peak / 1e9:.3f} GB")
        print(f"{tag}: losses {[round(x, 4) for x in losses]}")
        print(f"{tag}: {step_s:.4f} s per step after the first, "
              f"{tm['examples_per_sec'] * LM_SPEC['max_len']:.0f} "
              f"tokens/s; timing {tm}")
        scores = trained.transform(DataTable(
            {"features": np.asarray(train_table["features"][:4])}))["scores"]
        want = (4, LM_SPEC["max_len"], LM_SPEC["vocab_size"])
        check(scores.shape == want and bool(np.isfinite(scores).all()),
              f"{dtype}-trained model scores {scores.shape}, finite "
              f"{bool(np.isfinite(scores).all())}")
        print(f"{tag}: the returned model scores {scores.shape} finite "
              "logits")
        del learner, trained, scores
        torch.cuda.empty_cache()
        return launches

    train_launches = train_slice("bfloat16")
    # f32: the f32 flash_dq / flash_dkv (3xTF32) at the slice's shape;
    # torch keeps allow_tf32 False, so the GEMMs run strict f32
    f32_launches = train_slice("float32")

    # a depth-2 f32 model trained 2 SGD steps on the card (flash kernels)
    # and on the CPU (their plain versions) from the same weights
    import copy
    spec2 = dict(LM_SPEC, depth=2, head_dtype="float32")
    m0 = build_network(spec2, device="cpu", seed=2)
    w0 = {k: t.clone() for k, t in m0.state_dict().items()}
    toks2 = np.asarray(train_table["features"][:4, :512])
    small = DataTable({"features": toks2,
                       "label": np.roll(toks2.astype(np.int64), -1, 1)})

    def fit_small(device):
        lrn = TPULearner(moduleFactory=lambda: copy.deepcopy(m0),
                         device=device, loss="token_cross_entropy",
                         optimizer="sgd", schedule="constant",
                         learningRate=0.1, batchSize=2, epochs=1,
                         computeDtype="float32", logEvery=1)
        mod = lrn.fit(small)
        return [h["loss"] for h in lrn.history], {
            k: t.detach().cpu() for k, t in mod.get("weights").items()}
    FA.reset_launches()
    l_card, w_card = fit_small("cuda")
    check(FA.LAUNCHES["_dq_kernel"] == 4, f"depth-2 fit {FA.LAUNCHES}")
    t0 = time.perf_counter()
    l_cpu, w_cpu = fit_small("cpu")
    cpu_s = time.perf_counter() - t0
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    upd = max(float((w_cpu[k] - w0[k]).abs().max()) for k in w0)
    w_diff = max(float((w_card[k] - w_cpu[k]).abs().max()) for k in w0)
    check(loss_rel <= 1e-4, f"depth-2 card vs CPU losses {l_card} vs "
          f"{l_cpu}")
    check(w_diff <= 1e-3 * upd, f"depth-2 card vs CPU weights differ by "
          f"{w_diff}, largest update {upd}")
    print(f"training slice: depth-2 f32, 2 SGD steps, card vs CPU ({cpu_s:.1f}"
          f" s there): losses rel diff {loss_rel:.2e} (<= 1e-4), max |weight "
          f"diff| {w_diff:.3e} vs largest update {upd:.3e} (<= 1e-3 of it)")
    del m0, w0, w_card, w_cpu

    kernels = []
    for name, route, key, launches, line in (
            (f"hist (single leaf, B={b255})", "_hist_kernel_nibble", b255,
             l255, 67),
            (f"hist (single leaf, B={b63})", "_hist_kernel", b63, l63, 117),
            (f"hist (single leaf, B={b255}, 5 % child)",
             "_hist_kernel_nibble", "child", l255, 67),
            (f"hist (single leaf, B={b255}, root)", "_hist_kernel_nibble",
             "root", l255, 67)):
        m = measured[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/hist.cu",
            "replaces": f"mmlspark_tpu/gbdt/pallas_hist.py:{line}",
            "launches": launches[route], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"]})
    # the forward in both types: f32 on the LM transform's path, bf16
    # (the tensor-core body) on the training slice's
    for dtype, tname, launches in (
            (torch.float32, "f32", lm_launches),
            (torch.bfloat16, "bf16", train_launches["_fwd_kernel"])):
        m = flash_measured[dtype]
        kernels.append({
            "name": f"flash_fwd ({tname}, B=8, L=1024, H=16, D=128, causal)",
            "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "mmlspark_tpu/ops/flash_attention.py:93",
            "launches": launches, "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"]})
    # the backward in both types: bf16 on the training slice's bf16 fit,
    # f32 on its f32 fit; library_ms is SDPA's whole backward (dq, dk,
    # dv) in that type, plain_ms the whole plain backward
    for dtype, tname, launches in (
            (torch.bfloat16, "bf16", train_launches),
            (torch.float32, "f32", f32_launches)):
        for kernel, name, line in (("_dq_kernel", "flash_dq", 148),
                                   ("_dkv_kernel", "flash_dkv", 190)):
            m = bwd_measured[(kernel, dtype)]
            kernels.append({
                "name": f"{name} ({tname}, B=8, L=1024, H=16, D=128, "
                        "causal)",
                "route": "cuda",
                "source": "mmlspark_tpu_torch/csrc/flash_bwd.cu",
                "replaces": f"mmlspark_tpu/ops/flash_attention.py:{line}",
                "launches": launches[kernel],
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "library_ms": m["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
