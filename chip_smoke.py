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
               the 90 %-in-bin-0 root in f32; the root and the 5 % child
               in int16 at max_bin 255 and in int8 at max_bin 63).
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
  6. serving slice — the max_bin 255 model of phase 3, saved with the
               port's save and loaded back with load_stage in a fresh
               process where jax cannot be imported: its transform of the
               holdout bitwise equal to phase 3's. Served on the card from
               the main process through serve_model(json_scoring_pipeline
               (model), port=0, batch_size=256, workers=2, max_wait_ms=5):
               2,000 one-row JSON requests from 16 client threads of a
               second (spawned) process, so that the clients do not
               share the engine's interpreter lock, every reply's
               prediction equal to transform's; through
               json_row_scoring_pipeline(model, reply_col="rawPrediction"):
               200 rows, each reply bitwise equal to transform's
               rawPrediction; and the MLP scorer of bench.py's
               bench_serving ([256, 128] -> 10 classes at input dim 128,
               seeded weights, batchSize 256, f32) after warmup returned
               len(bucket_sizes()): 400 replies equal to a direct
               transform. Prints requests/s, client p50 / p99, batches
               and rows per batch, the engine's queue_wait / decode /
               pipeline / respond ms p50; hist launches are counted
               around the serving (the forest walk is plain torch, so
               none).
  7. GBDT training options — on phase 3's 1M x 28 table (63 leaves,
               seed 7, the 100k holdout as validation data), each fit's
               launches counted by stats type just around it and traced
               on the device (seconds, phases, the hist kernels' share of
               the boost phase): (a) bagging 0.8 / 1 and feature fraction
               0.8 with early_stopping_round 5 over 30 rounds —
               best_iteration is 1 + the argmin of the losses the run
               read and num_trees what the every-5-iterations cadence
               gives, on the holdout and on the holdout with its labels
               flipped (where the run must stop); the masks of iterations
               0-2 bitwise equal card vs CPU; (b) hist_bits=16 at max_bin
               255 (5 rounds): every launch int16, as many as histograms,
               holdout AUC above 0.8 and its gap to phase 3's f32 fit
               printed; q16 within 0.005 of f32 held at the size
               tests/test_gbdt_dist_quant.py pins it (4096 rows); (c)
               hist_bits=8 at max_bin 63: every launch int8, AUC finite
               and above 0.5; (d) q16 + sampling, 5 rounds with
               keepTrainingData then boost_more(5) bitwise equal to 10
               rounds in one call, then boost_more(5) on the holdout: 15
               iterations, finite scores; (e) a 20k-row q16 fit on the
               card and on the CPU (AUC within 0.005), the iteration-0 L1
               scales of each, and the q16 / q8 rounding of the same f32
               stats and the int16 / int8 root and masked-child
               histograms bitwise equal across the two.
  8. GBDT ingest beyond dense input — (a) the Bosch production-line
               shape of NVIDIA's gbm-bench as a CSRMatrix (1,183,747 rows
               x 968 float32 features, ~19 % nonzero, seed 7, drawn on
               the card; 100k more CSR rows held out) in a DataTable,
               TPUBoostClassifier (63 leaves, max_bin 255, 5 rounds) on
               the card, traced: fit s, train_timing, launches (one per
               histogram), hist share of the boost, holdout AUC;
               transform_sparse of 100k rows bitwise equal to the host
               library's dense transform and to the fit's bins; a 200k-row
               slice fitted from CSR and from its dense copy with equal
               upper_bounds and bitwise equal forests; predict on the CSR
               holdout bitwise equal to predict on its dense copy; the
               kernel on the table's bins at a root and a 5 % child
               against hist_plain in float64 (counts exact; g and h within
               rtol 1e-5 / atol 1e-3 + 2e-7 of the bin's absolute mass,
               since ~960k rows share a zero bin), with
               its time, the plain version's, a weighted bincount's and
               the bound. (b) phase 3's 1M x 28 table as .npy columns:
               ChunkedTable.from_npy (65,536-row chunks) fits with binFit
               'sample' and 'sketch', and booster.train on a list of (X,
               y) shards: fit s, OOCStats, holdout AUC within 0.005 of
               phase 3's dense fit, the chunk bytes alive at once (weakref
               count) within tracked_peak_bytes = (depth + 2) x peak
               chunk, the sketch cuts within 2 x sketch_eps in rank of an
               exact all-rows fit, and a sketch fit that never compacts
               (values on a 1/40 grid) giving the dense fit's cuts
               bitwise. (c) the host binning library (csrc/bins.cpp)
               bitwise equal to _numpy_bin_block on the 1M x 28 table in
               float32 and float64, all features and a range, with host
               ms and the OpenMP thread count.
  9. zoo networks — at the widths the repo uses, step counts cut: (a)
               bench.py's bench_cifar ConvNet ([64, 64, 64] / [256], 10
               classes, inputShape [32, 32, 3], batch 1024, bf16, device
               feed, lr 0.1, Nesterov momentum, cosine) on seeded
               CIFAR-shaped data for 1 epoch of 32 steps (bench.py: 9 of
               128); (b) bench_resnet's ResNet-20 the same way. Each prints
               imgs/s, step ms, peak memory and MFU; losses finite, the
               last below the first; ResNet-20's running statistics moved
               and finite, and its model's logits of rows 0-7 alone within
               2**-6 of theirs inside a 256-row batch (eval mode reads the
               running statistics). (c) a ResNet [1, 1] / width 16 trained
               2 SGD steps at batch 8 in f32 on the card and on the CPU
               from the same weights (losses within rtol 1e-4, weights and
               running statistics within 1e-3 of the largest update), and
               one f32 forward of the ConvNet, ResNet-20 and BiLSTM card
               vs CPU within 1e-4 of the output's scale, with the error
               TF32 would have left printed beside it. (d) the BiLSTM at
               examples/304_bilstm_tagger.py's shape (vocab 50, embed 32,
               hidden 64, 3 tags, T = 12, 512 rows, batch 128, adam 0.01,
               f32, 30 epochs): held-out per-token accuracy above 0.9,
               step ms. (e) ResNet-18 (imagenet stem, [2, 2, 2, 2], width
               64, 1000 classes, seeded weights): TPUModel.transform of
               1024 224 x 224 x 3 images at batch 256 in bf16 and f32,
               imgs/s of the second of two runs, finite logits of shape
               (1024, 1000).
Then one JSON line of per-kernel numbers (the hist rows include the int16
and int8 launches of 7(b) and 7(c) and the F = 968 launches of 8(a)), the
card's name and power limit, and as the last line
{"ok": true, "device": {...}}.

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


def served(engine, label: str, bodies, n_threads: int):
    """Drive ``engine`` with ``bodies`` from ``n_threads`` keep-alive
    client threads (60 s timeouts) of a spawned process, so that the
    clients do not contend with the engine for its interpreter lock;
    wait (polling) until its source has counted every reply, check its
    threads, print the numbers. Any non-200 reply or client error, or a
    client process that does not finish, fails the run."""
    import multiprocessing
    import queue
    from mmlspark_tpu_torch.profile_serving import _client_process
    ctx = multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    proc = ctx.Process(target=_client_process, args=(
        bodies, engine.source.address, n_threads, out_q))
    proc.start()
    try:
        replies, lat, wall, errors = out_q.get(timeout=300)
    except queue.Empty:
        fail(f"{label}: the client process sent no result")
    finally:
        proc.join(timeout=30)
        if proc.is_alive():
            proc.kill()
            proc.join()
    check(proc.exitcode == 0, f"{label}: client process exit code "
          f"{proc.exitcode}")
    check(not errors, f"{label}: serving errors {errors[:5]}")
    n = len(bodies)
    deadline = time.monotonic() + 30
    while engine.source.requests_answered < n and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    check(engine.source.requests_answered == n,
          f"{label}: {engine.source.requests_answered} answered of {n}")
    check(engine.is_alive() and engine.workers_restarted == 0,
          f"{label}: an engine thread died "
          f"({engine.workers_restarted} restarts)")
    m = engine.metrics()
    ms = np.sort(np.asarray(lat)) * 1e3
    print(f"{label}: {n} requests from {n_threads} clients (a second "
          f"process) in {wall:.3f} s "
          f"({n / wall:.1f} requests/s), client p50 "
          f"{ms[int(0.50 * (n - 1))]:.3f} ms, p99 "
          f"{ms[int(0.99 * (n - 1))]:.3f} ms; {m['batches_processed']} "
          f"batches, {m['batch_rows'].get('mean', 0):.2f} rows per batch; "
          f"p50 ms: queue_wait {m['queue_wait_ms'].get('p50')}, decode "
          f"{m['decode_ms'].get('p50')}, pipeline "
          f"{m['pipeline_ms'].get('p50')}, respond "
          f"{m['respond_ms'].get('p50')}")
    return replies


RELOAD_CHECK = """
import sys
sys.modules["jax"] = None
sys.modules["mmlspark_tpu"] = None
import numpy as np
from mmlspark_tpu_torch.core.stage import load_stage
from mmlspark_tpu_torch.core.table import DataTable
model = load_stage(sys.argv[1])
assert model.get("device") == "cuda", model.get("device")
ref = np.load(sys.argv[2])
out = model.transform(DataTable({"features": ref["features"]}))
for col in ("rawPrediction", "probability", "prediction"):
    assert np.array_equal(np.asarray(out[col]), ref[col]), col
bad = [k for k, v in sys.modules.items() if v is not None
       and k.split(".")[0] in ("jax", "jaxlib", "flax", "mmlspark_tpu")]
assert not bad, bad
print("reload OK")
"""


def serving_slice(model, out, Xte, smi: str) -> None:
    """Phase 6: save -> reload (fresh jax-blocked process) -> serve."""
    import torch
    from mmlspark_tpu_torch.core.stage import load_stage
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.gbdt import hist_kernels as HK
    from mmlspark_tpu_torch.models.networks import build_network
    from mmlspark_tpu_torch.models.tpu_model import TPUModel
    from mmlspark_tpu_torch.serving import (
        json_row_scoring_pipeline, json_scoring_pipeline, serve_model)

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "chip_smoke_serving")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "model_max_bin_255")
    t0 = time.perf_counter()
    model.save(path)
    save_s = time.perf_counter() - t0
    ref = os.path.join(work, "phase3_holdout.npz")
    np.savez(ref, features=Xte, **{c: np.asarray(out[c]) for c in (
        "rawPrediction", "probability", "prediction")})
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", RELOAD_CHECK, path, ref],
                       capture_output=True, text=True, cwd=root,
                       env={**os.environ, "PYTHONPATH": root}, timeout=300)
    check(r.returncode == 0 and "reload OK" in r.stdout,
          f"reload in a jax-blocked process failed: {r.stderr[-2000:]}")
    print(f"serving slice: saved in {save_s:.3f} s; reloaded in a fresh "
          f"jax-blocked process ({time.perf_counter() - t0:.1f} s): "
          f"transform of {len(Xte)} holdout rows bitwise equal to phase 3's")

    loaded = load_stage(path)
    raw = np.asarray(out["rawPrediction"])
    pred = np.asarray(out["prediction"])
    HK.reset_launches()
    engine = serve_model(json_scoring_pipeline(loaded), port=0,
                         batch_size=256, workers=2, max_wait_ms=5)
    try:
        bodies = [json.dumps({"features": Xte[i].tolist()}).encode()
                  for i in range(2000)]
        replies = served(engine, "serving slice GBDT (json_scoring_"
                         "pipeline)", bodies, 16)
    finally:
        engine.stop()
    bad = [i for i, rep in enumerate(replies)
           if rep != {"prediction": int(pred[i])}]
    check(not bad, f"{len(bad)} GBDT replies differ from transform, first "
          f"{[(i, replies[i], pred[i]) for i in bad[:3]]}")
    engine = serve_model(json_row_scoring_pipeline(
        loaded, reply_col="rawPrediction"), port=0, batch_size=256,
        workers=2, max_wait_ms=5)
    try:
        bodies = [json.dumps({"features": Xte[i].tolist()}).encode()
                  for i in range(200)]
        replies = served(engine, "serving slice GBDT (json_row_scoring_"
                         "pipeline, rawPrediction)", bodies, 16)
    finally:
        engine.stop()
    bad = [i for i, rep in enumerate(replies) if rep != raw[i].tolist()]
    check(not bad, f"{len(bad)} rawPrediction replies not bitwise equal "
          f"to transform's, first {[(i, replies[i]) for i in bad[:3]]}")
    launches = dict(HK.LAUNCHES)
    print(f"serving slice: 2000 predictions equal to transform's, 200 "
          f"rawPrediction replies bitwise equal; hist launches while "
          f"serving {launches} (the forest walk is plain torch)")

    # the MLP scorer of bench.py's bench_serving, on the card
    dim = 128
    net = build_network({"type": "mlp", "features": [256, 128],
                         "num_classes": 10, "in_features": dim},
                        device="cuda", seed=0)
    mlp = TPUModel.from_module(net, device="cuda", inputCol="features",
                               outputCol="scores", batchSize=256,
                               computeDtype="float32")
    x = np.random.default_rng(0).normal(size=(400, dim)).astype(np.float32)
    t0 = time.perf_counter()
    compiled = mlp.warmup({"features": x[:1]})
    warm_s = time.perf_counter() - t0
    check(compiled == len(mlp.bucket_sizes()),
          f"MLP warmup met {compiled} new shapes, not "
          f"{len(mlp.bucket_sizes())}")
    check(mlp.warmup({"features": x[:1]}) == 0, "second warmup not warm")
    want = mlp.transform(DataTable({"features": x}))["scores"].argmax(-1)
    torch.cuda.synchronize()
    engine = serve_model(json_scoring_pipeline(mlp), port=0,
                         batch_size=256, workers=2, max_wait_ms=5)
    try:
        bodies = [json.dumps({"features": row.tolist()}).encode()
                  for row in x]
        replies = served(engine, "serving slice MLP (bench_serving "
                         "scorer)", bodies, 16)
    finally:
        engine.stop()
    bad = [i for i, rep in enumerate(replies)
           if rep != {"prediction": int(want[i])}]
    check(not bad, f"{len(bad)} MLP replies differ from transform")
    check(mlp.jit_cache_misses == len(mlp.bucket_sizes()),
          f"serving met new shapes after warmup: {mlp.jit_cache_misses}")
    print(f"serving slice: MLP warmup ran {compiled} buckets "
          f"{mlp.bucket_sizes()} in {warm_s:.3f} s, 400 replies equal to "
          f"transform, no new shape while serving; card: {smi}")


def traced_fit(label: str, table, test_t, yte, **kw):
    """One main-path fit of TPUBoostClassifier (63 leaves, seed 7; counts
    set to 0 just before, read just after), traced on the device:
    seconds, phases, holdout AUC, and the hist kernels' share of the
    boost window. Returns (model, booster, AUC, launches by stats type,
    launches by route)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mmlspark_tpu_torch.gbdt import hist_kernels as HK
    from mmlspark_tpu_torch.gbdt.estimators import TPUBoostClassifier
    from mmlspark_tpu_torch.profile_fit import union_us
    HK.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model = TPUBoostClassifier(numLeaves=63, seed=7, **kw).fit(table)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = dict(HK.LAUNCHES_BY_TYPE)
    routes = dict(HK.LAUNCHES)
    booster = model.get_booster()
    prob = np.asarray(model.transform(test_t)["probability"])
    check(prob.shape == (len(yte), 2) and np.isfinite(prob).all(),
          f"{label}: outputs {prob.shape} not finite")
    a = auc(yte, prob[:, 1])
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    hist = [e for e in ev if "hist_" in e.name]
    share = "not measured (no device events traced)"
    if hist:
        hist_ms = sum(e.time_range.end - e.time_range.start
                      for e in hist) / 1e3
        w0 = min(e.time_range.start for e in hist)
        w1 = max(e.time_range.end for e in hist)
        busy = union_us([(max(e.time_range.start, w0),
                          min(e.time_range.end, w1)) for e in ev
                         if e.time_range.end > w0
                         and e.time_range.start < w1])
        boost_ms = 1e3 * booster.train_timing["boost"]
        share = (f"hist kernels {hist_ms:.3f} ms = "
                 f"{100 * hist_ms / boost_ms:.2f} % of the boost phase "
                 f"({boost_ms:.1f} ms); device busy "
                 f"{100 * busy / max(w1 - w0, 1e-9):.1f} % of the "
                 "first-to-last hist window")
    print(f"{label}: fit {secs:.2f} s under the CUDA profiler "
          f"({booster.train_timing}), {booster.num_trees} trees, holdout "
          f"AUC {a:.5f}, histograms {booster.train_info['histograms']}, "
          f"launches by stats type {launches}; {share}")
    return model, booster, a, launches, routes


def training_options(train_t, test_t, Xtr, ytr, Xte, yte, auc255: float,
                     smi: str) -> dict:
    """Phase 7: the GBDT training options at full width. Returns the
    int16 / int8 hist launches of the main-path fits (b) and (c)."""
    import torch
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.gbdt import hist_kernels as HK
    from mmlspark_tpu_torch.gbdt import prng
    from mmlspark_tpu_torch.gbdt.binning import BinMapper
    from mmlspark_tpu_torch.gbdt.estimators import TPUBoostClassifier
    from mmlspark_tpu_torch.gbdt.objectives import get_objective
    from mmlspark_tpu_torch.gbdt.tree import (
        _sround, quant_scales, sample_iteration_masks)
    from mmlspark_tpu_torch.profile_fit import threefry_costs

    dev = torch.device("cuda")
    sampled = dict(baggingFraction=0.8, baggingFreq=1, featureFraction=0.8)

    def fit(label, table=train_t, **kw):
        model, booster, a, launches, _ = traced_fit(
            f"training options {label}", table, test_t, yte, **kw)
        return model, booster, a, launches

    def int_route_only(label, booster, launches, sdt):
        h = booster.train_info["histograms"]
        check(launches[sdt] == h and all(
            v == 0 for k, v in launches.items() if k != sdt),
            f"training options {label}: launches {launches}, {h} "
            f"histograms, all of them expected as {sdt}")

    # (a) bagging + feature fraction with early stopping on the holdout;
    # then on the holdout with its labels flipped, where the validation
    # loss rises from the first tree on, so that the run stops
    def stop_checks(label, booster, n_iter, esr):
        losses = booster.train_info["valid_loss"]
        m = len(losses)
        check(booster.best_iteration == 1 + int(np.argmin(losses)),
              f"{label}: best_iteration {booster.best_iteration} vs "
              f"1 + argmin of {m} losses")
        stopped = m - booster.best_iteration >= esr
        sync = min(esr, 8)
        want = min(n_iter, -(-m // sync) * sync) if stopped else n_iter
        check(stopped or m == n_iter, f"{label}: {m} losses read")
        check(booster.num_trees == want,
              f"{label}: {booster.num_trees} trees, the cadence gives "
              f"{want}")
        print(f"training options {label}: best_iteration "
              f"{booster.best_iteration} = 1 + argmin of the {m} losses "
              f"read, stopped {stopped}, {booster.num_trees} trees as the "
              f"every-{sync}-iterations cadence gives")

    _, ba, auc_a, la = fit("(a) bagging 0.8/1, feature_fraction 0.8, "
                           "early_stopping_round 5", numIterations=30,
                           earlyStoppingRound=5, validationData=test_t,
                           **sampled)
    check(la["float32"] == ba.train_info["histograms"],
          f"(a): launches {la}")
    stop_checks("(a)", ba, 30, 5)
    flipped = DataTable({"features": Xte, "label": 1.0 - yte})
    _, bf, _, _ = fit("(a) on the label-flipped holdout", numIterations=30,
                      earlyStoppingRound=5, validationData=flipped,
                      **sampled)
    stop_checks("(a) flipped", bf, 30, 5)
    check(bf.num_trees < 30, "(a) flipped: the run did not stop")
    # the masks drawn on the card equal the CPU's, and what a draw costs
    key = prng.PRNGKey(7)
    ones = {d: (torch.ones(N_TRAIN, device=d), torch.ones(28, device=d))
            for d in (dev, torch.device("cpu"))}
    for it in range(3):
        (wg, fg), (wc, fc) = (sample_iteration_masks(
            key, it, *ones[d], (0.8, 1), 0.8, 28, 28)
            for d in (dev, torch.device("cpu")))
        check(torch.equal(wg.cpu(), wc) and torch.equal(fg.cpu(), fc),
              f"(a): the masks of iteration {it} differ card vs CPU")
    costs = threefry_costs(torch)
    print(f"training options (a): bagging / feature-fraction masks of "
          f"iterations 0-2 bitwise equal card vs CPU ({N_TRAIN} rows); "
          + "; ".join(f"{label}: {dev_ms:.3f} ms on the card"
                      for label, (dev_ms, _) in costs.items()))

    # (b) hist_bits=16 at max_bin 255: the int16 launch of the route of
    # _hist_kernel_nibble; (c) hist_bits=8 at max_bin 63: the int8 launch
    # of the route of _hist_kernel
    _, bb, auc_b, lb = fit("(b) hist_bits=16, max_bin 255",
                           numIterations=5, histBits=16)
    int_route_only("(b)", bb, lb, "int16")
    # the global-L1 scale leaves each row about Q / N of a step (0.016 at
    # 1M rows), so q16's gap to f32 grows with the rows: held here to
    # 0.01; the 0.005 rule of tests/test_gbdt_dist_quant.py:101 is held
    # at the size it pins (4096 rows)
    check(abs(auc_b - auc255) < 0.01, f"(b): q16 holdout AUC {auc_b} vs "
          f"f32 {auc255} at 1M rows")
    Xs, ys = higgs_shape(6000)
    small_kw = dict(numIterations=6, numLeaves=15, maxBin=63,
                    minDataInLeaf=5)
    small_t = DataTable({"features": Xs[:4096], "label": ys[:4096]})
    hold_t = DataTable({"features": Xs[4096:], "label": ys[4096:]})
    a16, a32 = (auc(ys[4096:], TPUBoostClassifier(histBits=bits, **small_kw)
                    .fit(small_t).transform(hold_t)["probability"][:, 1])
                for bits in (16, 32))
    check(abs(a16 - a32) < 0.005, f"(b): at 4096 rows q16 AUC {a16} vs "
          f"f32 {a32}")
    print(f"training options (b): q16 vs f32 (phase 3) holdout AUC "
          f"{auc_b:.5f} vs {auc255:.5f} at 1M rows (|diff| "
          f"{abs(auc_b - auc255):.5f} < 0.01); at tests/test_gbdt_dist_quant.py's "
          f"4096 rows on the card {a16:.5f} vs {a32:.5f} (|diff| "
          f"{abs(a16 - a32):.5f} < 0.005)")
    _, bc, auc_c, lc = fit("(c) hist_bits=8, max_bin 63", numIterations=5,
                           histBits=8, maxBin=63)
    int_route_only("(c)", bc, lc, "int8")
    check(np.isfinite(auc_c) and auc_c > 0.5, f"(c): q8 AUC {auc_c}")

    # (d) retained continuation: 5 + boost_more(5) == 10 in one call
    kw = dict(numLeaves=63, seed=7, histBits=16, **sampled)
    HK.reset_launches()
    m5 = TPUBoostClassifier(numIterations=5, keepTrainingData=True,
                            **kw).fit(train_t)
    grown = m5.get_booster().boost_more(5)
    m10 = TPUBoostClassifier(numIterations=10, **kw).fit(train_t)
    torch.cuda.synchronize()
    ld = dict(HK.LAUNCHES_BY_TYPE)
    one = m10.get_booster()
    for k in one.trees:
        check(np.array_equal(grown.trees[k], one.trees[k]),
              f"(d): boost_more(5) after 5 differs from 10 in {k!r}")
    fresh = grown.boost_more(5, Xte, yte)
    pf = fresh.predict(Xte)
    check(fresh.num_trees == 15 and np.isfinite(pf).all(),
          f"(d): fresh-data boost_more: {fresh.num_trees} trees")
    print(f"training options (d): q16 + sampling, 5 rounds + boost_more(5) "
          f"bitwise equal to 10 in one call (launches {ld}); "
          f"boost_more(5) on the holdout: 15 iterations, finite scores, "
          f"holdout AUC {auc(yte, pf):.5f}")

    # (e) the card against the CPU: a 20k-row quantized fit on each
    small = DataTable({"features": Xtr[:20000], "label": ytr[:20000]})
    skw = dict(numIterations=5, numLeaves=15, maxBin=63, histBits=16,
               seed=7)
    pg = TPUBoostClassifier(device="cuda", **skw).fit(small) \
        .transform(test_t)["probability"][:, 1]
    pc = TPUBoostClassifier(device="cpu", **skw).fit(small) \
        .transform(test_t)["probability"][:, 1]
    ag, ac = auc(yte, pg), auc(yte, pc)
    check(abs(ag - ac) < 0.005, f"(e): card AUC {ag} vs CPU {ac}")
    obj = get_objective("binary")
    ys = ytr[:20000].astype(np.float64)
    s0 = np.float32(obj.init_score(ys, np.ones_like(ys))[0])
    yc = torch.from_numpy(ytr[:20000].astype(np.float32))
    gc, hc = obj.grad_hess(torch.full((20000,), float(s0)), yc)
    wc = torch.ones(20000)
    gg, hg = obj.grad_hess(torch.full((20000,), float(s0), device=dev),
                           yc.to(dev))
    sc = quant_scales(gc, hc, wc, 16)
    sg = quant_scales(gg, hg, wc.to(dev), 16)
    print(f"training options (e): iteration-0 L1 scales (dg, dh, dc) on "
          f"the CPU {[float(v) for v in sc]}, on the card "
          f"{[float(v) for v in sg]}, equal "
          f"{all(float(a) == float(b) for a, b in zip(sc, sg))}")
    bins = torch.from_numpy(BinMapper.fit(Xtr[:20000], max_bin=63)
                            .transform_fm(Xtr[:20000]))
    B = int(bins.max()) + 1
    zero = torch.zeros(20000, dtype=torch.int32)
    tk = prng.fold_in(prng.fold_in(prng.fold_in(key, 0), 3), 0)
    for bits, sdt in ((16, torch.int16), (8, torch.int8)):
        sc = quant_scales(gc, hc, wc, bits)
        qc = [_sround(v, d, tk, ch, sdt)
              for ch, (v, d) in enumerate(zip((gc * wc, hc * wc, wc), sc))]
        qg = [_sround(v.to(dev), d.to(dev), tk, ch, sdt)
              for ch, (v, d) in enumerate(zip((gc * wc, hc * wc, wc), sc))]
        check(all(torch.equal(a, b.cpu()) for a, b in zip(qc, qg)),
              f"(e): {bits}-bit rounding differs card vs CPU")
        for what, mask in (("root", torch.ones(20000, dtype=sdt)),
                           ("masked child", (bins[0] > B // 2).to(sdt))):
            ref = HK.hist_plain(bins, qc[0], qc[1], mask, zero, 1, B, qc[2])
            got = HK.hist_device(bins.to(dev), qg[0], qg[1], mask.to(dev),
                                 zero.to(dev), 1, B, qg[2])
            check(torch.equal(got.cpu(), ref),
                  f"(e): {bits}-bit {what} histogram differs from plain")
    print(f"training options (e): q16 / q8 rounding of the same f32 stats "
          f"bitwise equal card vs CPU, int16 / int8 root and masked-child "
          f"histograms bitwise equal to hist_plain; 20k-row q16 fit holdout "
          f"AUC card {ag:.5f} vs CPU {ac:.5f} (|diff| {abs(ag - ac):.5f} "
          f"< 0.005); card: {smi}")
    for bits, max_bin in ((8, 63), (16, 255)):
        replay_on_cpu("phase 3's rows", Xtr[:20000], ytr[:20000], bits,
                      max_bin)
    # and on the table of tests/test_torch_cuda.py's quantized-fit test
    rng = np.random.default_rng(7)
    Xq = rng.normal(size=(24_000, 28)).astype(np.float32)
    yq = (Xq[:, 0] + 0.6 * Xq[:, 1] * Xq[:, 2] + 0.3
          + rng.normal(scale=0.5, size=24_000) > 0).astype(np.float32)
    replay_on_cpu("the card test's rows", Xq[:20_000], yq[:20_000], 8, 63)
    return {"int16": lb["int16"], "int8": lc["int8"]}


def replay_on_cpu(rows: str, X, y, bits: int, max_bin: int) -> None:
    """Phase 7(e), tree by tree: a 20k-row quantized fit on the card in
    which every int histogram is held bitwise to ``hist_plain`` on the
    same inputs, and each tree to the CPU grower's given that tree's
    inputs and the card's three scales (structure, gains, values, leaf of
    every row). Then tree 0 on the CPU with its own scales, to show where
    the one-ulp difference of the f32 L1 sums parts the two fits."""
    import torch
    from mmlspark_tpu_torch.gbdt import booster as booster_mod
    from mmlspark_tpu_torch.gbdt import hist_kernels as HK
    from mmlspark_tpu_torch.gbdt import tree as tree_mod

    grown, scales, n_hist = [], [], [0]
    grow, build, qs = (booster_mod.grow_tree, tree_mod.build_histogram,
                       tree_mod.quant_scales)

    def rec_grow(bins, grad, hess, w, fm, gp, quant_key=None):
        out = grow(bins, grad, hess, w, fm, gp, quant_key=quant_key)
        grown.append(([t.cpu() for t in (bins, grad, hess, w, fm)], gp,
                      quant_key, out[0], out[1].cpu()))
        return out

    def rec_scales(*a):
        scales.append(qs(*a))
        return scales[-1]

    def held_hist(bins, g, h, w, leaf, L, B, method, count_values):
        out = build(bins, g, h, w, leaf, L, B, method=method,
                    count_values=count_values)
        ref = HK.hist_plain(*(t.cpu() for t in (bins, g, h, w, leaf)), L, B,
                            count_values.cpu())
        check(torch.equal(out.cpu(), ref), f"(e) q{bits}: int histogram "
              f"{n_hist[0]} of the fit differs from hist_plain")
        n_hist[0] += 1
        return out

    booster_mod.grow_tree, tree_mod.quant_scales = rec_grow, rec_scales
    tree_mod.build_histogram = held_hist
    try:
        booster_mod.train({"objective": "binary", "num_iterations": 5,
                           "num_leaves": 15, "max_bin": max_bin,
                           "hist_bits": bits, "seed": 7}, X, y,
                          device="cuda")
    finally:
        booster_mod.grow_tree, tree_mod.build_histogram = grow, build
        tree_mod.quant_scales = qs
    check(len(grown) == len(scales) == 5, f"(e) q{bits}: {len(grown)} trees")

    def cpu_tree(t, deltas):
        inputs, gp, key, _, _ = grown[t]
        if deltas is not None:
            tree_mod.quant_scales = lambda *a: deltas
        try:
            tr, leaf_of_row, _, _ = tree_mod.grow_tree(*inputs, gp,
                                                       quant_key=key)
        finally:
            tree_mod.quant_scales = qs
        return tr, leaf_of_row

    for t, (_, _, _, card_tree, card_leaf) in enumerate(grown):
        tr, leaf_of_row = cpu_tree(t, scales[t].cpu())
        check(all(np.array_equal(getattr(tr, k), getattr(card_tree, k))
                  for k in tr._fields) and torch.equal(leaf_of_row,
                                                       card_leaf),
              f"(e) q{bits}: tree {t} on the CPU from the card's inputs "
              "and scales differs from the card's")
    own, _ = cpu_tree(0, None)
    own_scales = qs(*grown[0][0][1:4], bits)
    card0 = grown[0][3]
    split = np.flatnonzero(~card0.is_leaf)
    part = [j for j in split if (own.feature[j], own.bin_threshold[j])
            != (card0.feature[j], card0.bin_threshold[j])]
    where = "none"
    if part:
        j = part[0]
        where = (f"node {j}: card feature {card0.feature[j]} bin "
                 f"{card0.bin_threshold[j]} gain {card0.gain[j]!r}, CPU "
                 f"feature {own.feature[j]} bin {own.bin_threshold[j]} gain "
                 f"{own.gain[j]!r}")
    print(f"training options (e): q{bits} at max_bin {max_bin}, {rows}: "
          f"{n_hist[0]} int histograms of the card's fit bitwise equal to "
          f"hist_plain; its 5 trees bitwise equal to the CPU grower's given "
          f"the same inputs and the card's scales; tree 0's scales card "
          f"{[float(v) for v in scales[0]]} vs CPU "
          f"{[float(v) for v in own_scales]}; with its own scales the CPU's "
          f"tree 0 first parts from the card's at {where}")


# the Bosch production-line table of NVIDIA's gbm-bench (rows x float
# features, share of nonzero cells) and phase 8's holdout and chunk rows
BOSCH_ROWS, BOSCH_COLS, BOSCH_DENSITY = 1_183_747, 968, 0.19
BOSCH_HOLDOUT = 100_000
OOC_CHUNK = 65_536


def bosch_shape(dev, n: int, seed: int = 7):
    """Phase 8(a)'s table: n rows x 968 float32 features, each cell
    nonzero with probability 0.19, values N(0, 1), and a label drawn from
    the logistic of a sparse weight vector (a tenth of the features,
    N(0, 0.5)). Drawn on the card from a seeded generator in 65,536-row
    blocks and kept on the host as a CSRMatrix. Returns (CSR, y)."""
    import torch
    from mmlspark_tpu_torch.core.sparse import CSRMatrix
    g = torch.Generator(device=dev).manual_seed(seed)
    f = BOSCH_COLS
    wt = torch.where(torch.rand(f, generator=g, device=dev) < 0.1,
                     0.5 * torch.randn(f, generator=g, device=dev), 0.0)
    data, idx, counts, ys = [], [], [], []
    for lo in range(0, n, OOC_CHUNK):
        m = min(OOC_CHUNK, n - lo)
        vals = torch.randn((m, f), generator=g, device=dev)
        keep = torch.rand((m, f), generator=g, device=dev) < BOSCH_DENSITY
        vals = torch.where(keep, vals, 0.0)
        nz = vals != 0
        r, c = nz.nonzero(as_tuple=True)          # row-major: sorted rows
        data.append(vals[r, c].cpu().numpy())
        idx.append(c.to(torch.int32).cpu().numpy())
        counts.append(nz.sum(1).cpu().numpy())
        p = torch.sigmoid(vals @ wt)
        ys.append((torch.rand(m, generator=g, device=dev) < p)
                  .float().cpu().numpy())
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.concatenate(counts), out=indptr[1:])
    return (CSRMatrix(np.concatenate(data), np.concatenate(idx), indptr,
                      (n, f)), np.concatenate(ys))


def ingest_slice(auc255: float, Xtr, ytr, Xte, yte, test_t, measured,
                 smi: str) -> dict:
    """Phase 8: GBDT ingest beyond dense input. (a) a CSR fit at the
    Bosch shape, (b) out-of-core fits from .npy chunks and shard lists,
    (c) the host binning library against its plain version. Returns the
    hist launches of (a)'s fit by route."""
    import threading
    import weakref

    import torch
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.gbdt import hist_kernels as HK
    from mmlspark_tpu_torch.gbdt import native_bins
    from mmlspark_tpu_torch.gbdt.binning import BinMapper
    from mmlspark_tpu_torch.gbdt.booster import train
    from mmlspark_tpu_torch.gbdt.estimators import TPUBoostClassifier
    from mmlspark_tpu_torch.io.ooc import (
        ChunkedTable, peak_rss_bytes, table_nbytes)
    from mmlspark_tpu_torch.profile_hist import (
        bincount_call, device_ms, hist_bound_ms, hist_inputs, time_ms)
    dev = torch.device("cuda")

    # ---- (a) CSR at the Bosch shape ----------------------------------------
    t0 = time.perf_counter()
    csr, yb = bosch_shape(dev, BOSCH_ROWS + BOSCH_HOLDOUT)
    tr, hold = csr[:BOSCH_ROWS], csr[BOSCH_ROWS:]
    ytb, yhb = yb[:BOSCH_ROWS], yb[BOSCH_ROWS:]
    host_gib = (csr.data.nbytes + csr.indices.nbytes
                + csr.indptr.nbytes) / 2**30
    print(f"ingest (a): Bosch-shape CSR table {tr.shape} + "
          f"{hold.shape[0]} holdout rows, {csr.nnz} nonzeros "
          f"({100 * csr.nnz / (csr.shape[0] * csr.shape[1]):.2f} %), "
          f"{host_gib:.2f} GiB on the host, made in "
          f"{time.perf_counter() - t0:.1f} s (seed 7, on the card)")
    train_b = DataTable({"features": tr, "label": ytb})
    hold_b = DataTable({"features": hold, "label": yhb})
    torch.cuda.reset_peak_memory_stats()
    model, booster, a_csr, _, routes = traced_fit(
        "ingest (a) CSR fit, 5 rounds, max_bin 255", train_b, hold_b, yhb,
        numIterations=5, keepTrainingData=True)
    h = booster.train_info["histograms"]
    mapper = booster.bin_mapper
    bins = booster._resume["run"].bins_d        # the fit's (F, N) bins
    F, N = bins.shape
    B = int(mapper.num_bins.max())
    # a mostly-zero feature's equal-frequency cuts give its zero one bin
    # and its nonzeros the rest, so B may fall below the nibble route's
    route = HK.tpu_route(1, B)
    check(sum(routes.values()) == h == routes[route],
          f"(a): launches {routes} for {h} histograms (route {route})")
    check(a_csr > 0.6, f"(a): holdout AUC {a_csr}")
    check((F, N) == (BOSCH_COLS, BOSCH_ROWS) and bins.dtype == torch.int32,
          f"(a): bins {tuple(bins.shape)} {bins.dtype}")
    zero_bin = np.asarray([np.searchsorted(u, 0.0) for u in
                           mapper.upper_bounds])
    in_zero = float((bins[:, :200_000].cpu().numpy()
                     == zero_bin[:, None]).mean())
    print(f"ingest (a): {h} launches of {route}, one per "
          f"histogram; bins on the card {F * N * 4 / 1e9:.3f} GB int32 "
          f"(F={F}, N={N}, B={B}), {100 * in_zero:.1f} % of cells in their "
          f"feature's zero bin; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card: {smi}")

    # the sparse bins of a 100k-row slice equal the dense binning of it
    sl = tr[:100_000]
    b_sparse = mapper.transform_sparse(sl)
    b_dense = mapper.transform_fm(sl.toarray(), native=True)
    check(np.array_equal(b_sparse, b_dense),
          "(a): transform_sparse differs from the dense transform")
    check(np.array_equal(b_sparse, bins[:, :100_000].cpu().numpy()),
          "(a): the fit's bins differ from transform_sparse")
    print("ingest (a): transform_sparse of 100k rows bitwise equal to the "
          "library's dense transform of them and to the fit's bins")

    # a 200k-row slice fitted from CSR and from its dense copy
    s2, y2 = tr[:200_000], ytb[:200_000]
    fits = {}
    for kind, feats in (("CSR", s2), ("dense", s2.toarray())):
        t0 = time.perf_counter()
        m = TPUBoostClassifier(numIterations=5, numLeaves=63, seed=7).fit(
            DataTable({"features": feats, "label": y2}))
        fits[kind] = (m.get_booster(), time.perf_counter() - t0)
    (bs, ts), (bd, td) = fits["CSR"], fits["dense"]
    same_cuts = all(np.array_equal(u, v) for u, v in zip(
        bs.bin_mapper.upper_bounds, bd.bin_mapper.upper_bounds))
    same_trees = all(np.array_equal(bs.trees[k], bd.trees[k])
                     for k in bd.trees)
    check(same_cuts, "(a): 200k rows: CSR and dense cuts differ")
    check(same_trees, "(a): 200k rows: CSR and dense forests differ")
    print(f"ingest (a): 200k rows fitted from CSR ({ts:.2f} s, bin path "
          f"{bs.train_info['bin_path']}) and from the dense copy "
          f"({td:.2f} s, bin path {bd.train_info['bin_path']}): equal "
          f"upper_bounds, forests bitwise equal")
    del fits, bs, bd

    # predict on the CSR holdout equals predict on its dense copy
    t0 = time.perf_counter()
    p_csr = booster.predict(hold)
    t_csr = time.perf_counter() - t0
    p_dense = booster.predict(hold.toarray())
    check(np.array_equal(p_csr, p_dense),
          "(a): CSR and dense holdout predictions differ")
    print(f"ingest (a): predict on the 100k-row CSR holdout ({t_csr:.2f} s, "
          f"8192-row chunks) bitwise equal to predict on its dense copy; "
          f"holdout AUC {a_csr:.5f}")

    # the kernel on this table's bins: a root and a 5 % child
    for key, active, seed in (("bosch_root", 1.0, 81),
                              ("bosch_child", 0.05, 82)):
        _, grad, hess, w, leaf, _ = hist_inputs(
            dev, 1, N, 1, B, torch.float32, seed=seed, active=active)
        out = HK.hist_device(bins, grad, hess, w, leaf, 1, B)
        again = HK.hist_device(bins, grad, hess, w, leaf, 1, B)
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"(a) {key}: two launches differ")
        # float64 references, 128 features at a time: the sums, and each
        # bin's absolute mass (the sum of |g w| and |h w|)
        def plain64(g_, h_):
            return torch.cat([HK.hist_plain(bins[j:j + 128], g_, h_,
                                            w.double(), leaf, 1, B)
                              for j in range(0, F, 128)], 2)
        ref = plain64(grad.double(), hess.double())
        mass = plain64(grad.double().abs(), hess.double().abs())
        d = (out.double() - ref).abs()
        err = float(d.max())
        # counts exact; g and h within phase 2's rtol 1e-5 / atol 1e-3 plus
        # 2e-7 (~3.4 float32 ulps) of the bin's absolute mass: about 960k
        # rows share a feature's zero bin here, and a float32 sum of that
        # many terms strays past atol 1e-3 in any order (the plain version
        # in float32 strays ~30x further); a dropped or doubled row shows
        # in the exact counts
        tol = 1e-3 + 1e-5 * ref.abs() + 2e-7 * mass
        pf = torch.cat([HK.hist_plain(bins[j:j + 128], grad, hess, w, leaf,
                                      1, B) for j in range(0, F, 128)], 2)
        plain_err = float((pf[:2].double() - ref[:2]).abs().max())
        check(torch.equal(out[2].double(), ref[2]),
              f"(a) {key}: counts differ from the plain version")
        check(bool((d[:2] <= tol[:2]).all()),
              f"(a) {key}: max_abs_err {err} beyond rtol 1e-5, atol 1e-3 "
              f"+ 2e-7 of the bin's absolute mass")
        print(f"ingest (a) {key}: counts exact; g, h max_abs_err "
              f"{float(d[:2].max()):.3e} (worst share of the bound "
              f"{float((d[:2] / tol[:2]).max()):.3f}; phase 2's rtol 1e-5 / "
              f"atol 1e-3 alone is exceeded at "
              f"{int((d[:2] > 1e-3 + 1e-5 * ref[:2].abs()).sum())} of "
              f"{d[:2].numel()} entries); the plain version in float32: "
              f"{plain_err:.3e}")
        del ref, mass, d, tol, pf
        torch.cuda.empty_cache()
        k_ms = time_ms(lambda: HK.hist_device(bins, grad, hess, w, leaf,
                                              1, B))
        d_ms, _ = device_ms(lambda: HK.hist_device(bins, grad, hess, w,
                                                   leaf, 1, B))
        p_ms = time_ms(lambda: HK.hist_plain(bins, grad, hess, w, leaf, 1,
                                             B), reps=5)
        torch.cuda.empty_cache()
        lib = bincount_call(bins, grad, hess, w, leaf, 1, B, None)
        l_ms = time_ms(lib, reps=5)
        del lib
        torch.cuda.empty_cache()
        bd_ms, by = hist_bound_ms(F, N, w, 1, B, torch.float32, False)
        measured[key] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                             library_ms=l_ms, bound_ms=bd_ms, bound_by=by,
                             B=B, route=route)
        print(f"kernel float32 (F={F}, N={N}, L=1, B={B}, "
              f"{100 * active:g} % active, Bosch-shape CSR bins): "
              f"max_abs_err {err:.3e} vs float64 plain; repeat launch "
              f"bitwise equal; kernel {k_ms:.4f} ms "
              f"(device time {d_ms:.4f} ms), plain index_add_ {p_ms:.4f} "
              f"ms, bincount {l_ms:.4f} ms, bound {bd_ms:.4f} ms ({by})")
    del bins, booster, model, grad, hess, w, leaf, out, again
    torch.cuda.empty_cache()

    # ---- (b) out of core and streams ---------------------------------------
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_ooc")
    os.makedirs(work, exist_ok=True)
    paths = {"features": os.path.join(work, "features.npy"),
             "label": os.path.join(work, "label.npy")}
    np.save(paths["features"], Xtr)
    np.save(paths["label"], ytr)
    live = {"bytes": 0, "peak": 0}
    lock = threading.Lock()

    def release(nb):
        with lock:
            live["bytes"] -= nb

    def track(t):
        """Count the chunk's bytes while any reference to it lives."""
        nb = table_nbytes(t)
        with lock:
            live["bytes"] += nb
            live["peak"] = max(live["peak"], live["bytes"])
        weakref.finalize(t, release, nb)
        return t

    def ooc_fit(label, bin_fit):
        live["peak"] = 0
        src = ChunkedTable.from_npy(paths, chunk_rows=OOC_CHUNK)
        chunked = src.map(track)
        model, b, a, _, routes = traced_fit(
            f"ingest (b) ChunkedTable.from_npy, binFit={bin_fit!r}",
            chunked, test_t, yte, numIterations=5, binFit=bin_fit)
        st = chunked.stats
        check(routes["_hist_kernel_nibble"] == b.train_info["histograms"]
              and sum(routes.values()) == b.train_info["histograms"],
              f"(b) {label}: launches {routes}")
        check(abs(a - auc255) < 0.005, f"(b) {label}: AUC {a} vs dense "
              f"{auc255}")
        check(live["peak"] <= st.tracked_peak_bytes()
              <= (st.depth + 2) * st.peak_chunk_bytes,
              f"(b) {label}: {live['peak']} bytes of chunks alive at once "
              f"against the tracked {st.tracked_peak_bytes()}")
        print(f"ingest (b) {label}: holdout AUC {a:.5f} vs phase 3's "
              f"dense fit {auc255:.5f} (|diff| {abs(a - auc255):.5f} < "
              f"0.005); OOCStats {st.snapshot()}; chunk bytes alive at "
              f"once {live['peak']} <= tracked_peak_bytes "
              f"{st.tracked_peak_bytes()} = (depth {st.depth} + 2) x peak "
              f"chunk; sketch_eps {b.bin_mapper.sketch_eps:.6f}; host RSS "
              f"peak {peak_rss_bytes() / 2**30:.2f} GiB")
        return b

    ooc_fit("sample", "sample")
    b_sk = ooc_fit("sketch", "sketch")
    # the sketch's cuts against an exact all-rows fit, in rank
    eps = b_sk.bin_mapper.sketch_eps
    X64 = Xtr.astype(np.float64)
    exact = BinMapper.fit(X64, max_bin=255, sample_cnt=len(X64))
    drift = 0.0
    for j, (cs, ce) in enumerate(zip(b_sk.bin_mapper.upper_bounds,
                                     exact.upper_bounds)):
        check(len(cs) == len(ce), f"(b) sketch: feature {j} has {len(cs)} "
              f"cuts, the exact fit {len(ce)}")
        xs = np.sort(X64[:, j])
        rank = np.searchsorted(xs, cs) - np.searchsorted(xs, ce)
        drift = max(drift, float(np.abs(rank).max()) / len(xs))
    # the exact walk itself lands up to a row past each target, so its
    # cuts carry up to max_bin rows of slack
    check(0 < eps and drift <= 2 * eps + 255 / len(X64),
          f"(b) sketch: rank drift {drift} against 2 x eps {2 * eps}")
    print(f"ingest (b): sketch cuts within {drift:.6f} of the exact "
          f"all-rows fit's in rank (bound 2 x sketch_eps = {2 * eps:.6f})")
    del X64, exact
    # booster.train on a replayable list of (X, y) shards
    shards = [(Xtr[i:i + OOC_CHUNK], ytr[i:i + OOC_CHUNK])
              for i in range(0, len(Xtr), OOC_CHUNK)]
    HK.reset_launches()
    t0 = time.perf_counter()
    b_sh = train({"objective": "binary", "num_iterations": 5,
                  "num_leaves": 63, "seed": 7}, shards, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(HK.LAUNCHES)
    a_sh = auc(yte, b_sh.predict(Xte))
    check(launches["_hist_kernel_nibble"] == b_sh.train_info["histograms"],
          f"(b) shards: launches {launches}")
    check(abs(a_sh - auc255) < 0.005, f"(b) shards: AUC {a_sh}")
    print(f"ingest (b) booster.train on {len(shards)} (X, y) shards: fit "
          f"{secs:.2f} s ({b_sh.train_timing}), holdout AUC {a_sh:.5f} "
          f"(|diff| to dense {abs(a_sh - auc255):.5f} < 0.005), launches "
          f"{launches}")
    # a sketch fit that stays in one summary: the dense fit's cuts
    Xq = (np.round(Xtr * 40) / 40).astype(np.float32)
    qshards = [(Xq[i:i + OOC_CHUNK], ytr[i:i + OOC_CHUNK])
               for i in range(0, len(Xq), OOC_CHUNK)]
    b_q = train({"objective": "binary", "num_iterations": 1,
                 "num_leaves": 63, "max_bin": 63, "bin_fit": "sketch"},
                qshards, device="cuda")
    dense_q = BinMapper.fit(Xq, max_bin=63, sample_cnt=len(Xq))
    check(b_q.bin_mapper.sketch_eps == 0.0,
          f"(b): the quantized stream compacted (eps "
          f"{b_q.bin_mapper.sketch_eps})")
    check(all(np.array_equal(u, v) for u, v in zip(
        b_q.bin_mapper.upper_bounds, dense_q.upper_bounds)),
        "(b): uncompacted sketch cuts differ from the dense fit's")
    print(f"ingest (b): a 'sketch' fit of {len(Xq)} rows with at most "
          f"{max(len(np.unique(Xq[:, j])) for j in range(28))} distinct "
          f"values a feature (no compaction, sketch_eps 0): upper_bounds "
          f"bitwise equal to the dense all-rows fit's")
    del Xq, qshards

    # ---- (c) the host binning library against its plain version ----------
    m = BinMapper.fit(Xtr, max_bin=255)
    for X in (Xtr, Xtr.astype(np.float64)):
        tag = str(X.dtype)
        ref = m._numpy_bin_block(X, 0, X.shape[1])
        got = m.transform_fm(X, native=True)
        rng_got = m.transform_fm_range(X, 5, 17, native=True)
        check(np.array_equal(got, ref) and np.array_equal(rng_got,
                                                          ref[5:17]),
              f"(c) {tag}: bins.cpp differs from _numpy_bin_block")
        t_nat = host_ms(lambda: m.transform_fm(X, native=True))
        t_rng = host_ms(lambda: m.transform_fm_range(X, 5, 17, native=True))
        t_np = host_ms(lambda: m._numpy_bin_block(X, 0, X.shape[1]), 3)
        print(f"ingest (c) {tag} {X.shape}: bins.cpp bitwise equal to "
              f"_numpy_bin_block over all features and features [5, 17); "
              f"host ms bins.cpp {t_nat:.2f} (range {t_rng:.2f}), numpy "
              f"{t_np:.2f}; {native_bins.threads()} OpenMP threads, "
              f"{os.cpu_count()} cores")
    return routes


def host_ms(fn, reps: int = 5) -> float:
    """Median host wall milliseconds of fn() over ``reps`` calls after
    one warm-up."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ts))


ZOO_STEPS = 32              # phase 9's CIFAR fits: 1 epoch of 32 steps
RESNET18 = {"type": "resnet", "stage_sizes": [2, 2, 2, 2], "width": 64,
            "num_classes": 1000, "stem": "imagenet"}
RESNET18_ROWS, RESNET18_BATCH = 1024, 256
BILSTM = {"type": "bilstm", "vocab_size": 50, "embed_dim": 32, "hidden": 64,
          "num_tags": 3}


def bilstm_data(n: int, seed: int):
    """examples/304_bilstm_tagger.py's tokens: the tag of a token depends
    on it and on the token before it."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, BILSTM["vocab_size"], size=(n, 12))
    prev = np.roll(toks, 1, axis=1)
    prev[:, 0] = 0
    return toks.astype(np.int64), ((toks + prev) % 3).astype(np.int64)


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def zoo_slice(dev, smi: str) -> None:
    """Phase 9: the zoo's ConvNet, ResNet and BiLSTMTagger on the card."""
    import contextlib
    import copy

    import torch

    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.models import networks
    from mmlspark_tpu_torch.models.learner import TPULearner
    from mmlspark_tpu_torch.models.networks import build_network
    from mmlspark_tpu_torch.models.tpu_model import TPUModel
    from mmlspark_tpu_torch.profile_train import (
        CIFAR_BATCH, CIFAR_SPECS, cifar_learner, cifar_table)

    # (a), (b): bench.py's CIFAR configurations, 1 epoch of 32 steps
    table = cifar_table(ZOO_STEPS * CIFAR_BATCH)
    for net in ("convnet", "resnet20"):
        learner = cifar_learner(net, 1, device=str(dev))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = learner.fit(table)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        losses = [h["loss"] for h in learner.history]
        check(len(losses) == ZOO_STEPS and all(np.isfinite(losses)),
              f"{net} losses {losses}")
        check(losses[-1] < losses[0], f"{net} loss did not fall: {losses}")
        tm = learner.timing
        check("mfu" in tm, f"{net}: no MFU in learner.timing {tm}")
        print(f"zoo (a/b) {net}: {ZOO_STEPS} steps of {CIFAR_BATCH} x 32 x "
              f"32 x 3, bf16, device feed, in {fit_s:.3f} s (first step "
              f"included); {tm['examples_per_sec']:.1f} imgs/s, "
              f"{1e3 * tm['wall_s'] / tm['steps_timed']:.3f} ms per step "
              f"after the first, peak memory {peak / 1e9:.3f} GB, MFU "
              f"{tm['mfu']:.4f} ({tm['model_flops_per_step'] / 1e9:.2f} "
              f"GFLOP a step); card {smi}")
        print(f"zoo (a/b) {net}: losses first {losses[0]:.4f}, last "
              f"{losses[-1]:.4f}")
        if net == "resnet20":
            w = model.get("weights")
            stats = {k: v for k, v in w.items() if ".running_" in k}
            check(all(bool(torch.isfinite(v).all()) for v in stats.values()),
                  "ResNet-20 running statistics not finite")
            still = [k for k, v in stats.items() if bool(torch.all(
                v == (1.0 if k.endswith("running_var") else 0.0)))]
            check(not still, f"ResNet-20 running statistics never moved: "
                  f"{still}")
            x = np.asarray(table["features"][:256])
            full = torch.from_numpy(model.transform(DataTable(
                {"features": x}))["scores"])
            alone = torch.from_numpy(model.transform(DataTable(
                {"features": x[:8]}))["scores"])
            err = rel_err(alone, full[:8])
            check(err <= 2.0 ** -6, f"ResNet-20 rows 0-7 alone vs in a "
                  f"256-row batch differ by {err} of the scale")
            print(f"zoo (b) resnet20: {len(stats)} running buffers moved, "
                  f"finite; rows 0-7 alone vs in a 256-row batch: "
                  f"{err:.3e} of the logits' scale (<= 2**-6)")
        del learner, model
        torch.cuda.empty_cache()
    del table

    # (c) card vs CPU in f32: 2 SGD steps of a small ResNet, then one
    # forward of each network
    spec_c = {"type": "resnet", "stage_sizes": [1, 1], "width": 16,
              "num_classes": 10}
    m0 = build_network(spec_c, device="cpu", seed=2)
    w0 = {k: t.clone() for k, t in m0.state_dict().items()}
    small = cifar_table(16, seed=3)

    def fit_small(device):
        lrn = TPULearner(moduleFactory=lambda: copy.deepcopy(m0),
                         device=str(device), optimizer="sgd",
                         schedule="constant", learningRate=0.1, batchSize=8,
                         epochs=1, inputShape=[32, 32, 3],
                         computeDtype="float32", logEvery=1)
        mod = lrn.fit(small)
        return [h["loss"] for h in lrn.history], {
            k: t.detach().cpu() for k, t in mod.get("weights").items()}
    l_card, w_card = fit_small(dev)
    l_cpu, w_cpu = fit_small("cpu")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    upd = max(float((w_cpu[k] - w0[k]).abs().max()) for k in w0)
    w_diff = max(float((w_card[k] - w_cpu[k]).abs().max()) for k in w0)
    check(loss_rel <= 1e-4, f"ResNet card vs CPU losses {l_card} vs {l_cpu}")
    check(w_diff <= 1e-3 * upd, f"ResNet card vs CPU weights differ by "
          f"{w_diff}, largest update {upd}")
    print(f"zoo (c): ResNet [1, 1] / 16, 2 SGD steps f32, card vs CPU: "
          f"losses rel diff {loss_rel:.2e} (<= 1e-4), max |weight or running"
          f" stat diff| {w_diff:.3e} vs largest update {upd:.3e} (<= 1e-3 "
          "of it)")
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.uniform(
        0, 1, size=(64, 32, 32, 3)).astype(np.float32))
    tokens = torch.from_numpy(bilstm_data(64, 2)[0])
    for name, spec, x in (("convnet", CIFAR_SPECS["convnet"], images),
                          ("resnet20", CIFAR_SPECS["resnet20"], images),
                          ("bilstm", BILSTM, tokens)):
        module = build_network(spec, device="cpu", seed=5)
        with torch.no_grad():
            for buf_name, buf in module.named_buffers():
                if buf_name.endswith("running_var"):
                    buf.uniform_(0.5, 2.0)
            want = module(x)
            module = module.to(dev)
            got = module(x.to(dev)).cpu()
            err = rel_err(got, want)
            saved = networks.strict_f32
            tf32_before = torch.backends.cudnn.allow_tf32
            try:      # the same forward with TF32 left on, for contrast
                networks.strict_f32 = contextlib.nullcontext
                torch.backends.cudnn.allow_tf32 = True
                loose = rel_err(module(x.to(dev)).cpu(), want)
            finally:
                networks.strict_f32 = saved
                torch.backends.cudnn.allow_tf32 = tf32_before
        check(err <= 1e-4, f"{name} f32 forward card vs CPU: {err}")
        print(f"zoo (c): {name} f32 forward of {tuple(x.shape)}, card vs "
              f"CPU {err:.3e} of the output's scale (<= 1e-4); with cuDNN's "
              f"TF32 left on it would be {loose:.3e}")
    del m0, w0, w_card, w_cpu

    # (d) the BiLSTM tagger at examples/304_bilstm_tagger.py's shape
    toks, tags = bilstm_data(512, 0)
    learner = TPULearner(networkSpec=BILSTM, loss="token_cross_entropy",
                         epochs=30, batchSize=128, learningRate=0.01,
                         optimizer="adam", computeDtype="float32",
                         logEvery=50, device=str(dev))
    t0 = time.perf_counter()
    model = learner.fit(DataTable({"features": toks, "label": tags}))
    fit_s = time.perf_counter() - t0
    test_toks, test_tags = bilstm_data(128, 1)
    pred = model.transform(DataTable({"features": test_toks}))["scores"]
    acc = float(np.mean(np.argmax(pred, -1) == test_tags))
    check(acc > 0.9, f"BiLSTM held-out per-token accuracy {acc}")
    tm = learner.timing
    step_ms = 1e3 * tm["wall_s"] / tm["steps_timed"]
    # the LSTM products of a step (forward, and twice that backward),
    # which FlopCounterMode cannot see in cuDNN's RNN op
    lstm_flops = 3 * 2 * 2 * 12 * 128 * (BILSTM["embed_dim"]
                                         + BILSTM["hidden"]) \
        * 4 * BILSTM["hidden"]
    check(tm.get("model_flops_per_step", 0) >= lstm_flops,
          f"BiLSTM step flops {tm.get('model_flops_per_step')} leave out "
          f"the LSTM's {lstm_flops}")
    print(f"zoo (d) bilstm: 30 epochs x 4 steps of 128 x 12 tokens, f32, "
          f"adam, in {fit_s:.3f} s; {step_ms:.3f} ms per step after the "
          f"first; held-out per-token accuracy {acc:.4f} (> 0.9); "
          f"{tm['model_flops_per_step'] / 1e9:.3f} GFLOP a step (the "
          f"LSTM's {lstm_flops / 1e9:.3f}), MFU {tm['mfu']:.2e}")
    del learner, model

    # (e) ResNet-18 inference at 224 x 224
    images = np.random.default_rng(6).normal(
        size=(RESNET18_ROWS, 224, 224, 3)).astype(np.float32)
    table = DataTable({"image": images})
    state = build_network(RESNET18, device=dev, seed=11).state_dict()
    for dtype in ("bfloat16", "float32"):
        module = build_network(dict(RESNET18, dtype=dtype), device=dev)
        module.load_state_dict(state)
        model = TPUModel.from_module(module, device=dev, inputCol="image",
                                     outputCol="logits",
                                     batchSize=RESNET18_BATCH)
        secs = []
        for _ in range(2):
            t0 = time.perf_counter()
            logits = model.transform(table)["logits"]
            secs.append(time.perf_counter() - t0)
        check(logits.shape == (RESNET18_ROWS, 1000)
              and bool(np.isfinite(logits).all()),
              f"ResNet-18 {dtype} logits {logits.shape}, finite "
              f"{bool(np.isfinite(logits).all())}")
        print(f"zoo (e) resnet18 {dtype}: transform of {RESNET18_ROWS} x 224 "
              f"x 224 x 3 at batch {RESNET18_BATCH}: {secs[0]:.3f} s first, "
              f"{secs[1]:.3f} s second = {RESNET18_ROWS / secs[1]:.1f} imgs/s;"
              f" logits {logits.shape} finite")
        del module, model
    torch.cuda.empty_cache()


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
        print(f"build: {_build.source_of(name)} built in {secs:.1f} s")
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
    # the quantized fits' launches (phase 7): int16 at max_bin 255, int8
    # at max_bin 63, each at a root and at the 5 % child
    shapes += [(28, N_TRAIN, 1, B, sdt, active, None)
               for B, sdt in ((b255, torch.int16), (b63, torch.int8))
               for active in (1.0, 0.05)]
    f32 = torch.float32
    timed = {(28, N_TRAIN, 1, b255, f32, 0.8, None): b255,
             (28, N_TRAIN, 1, b63, f32, 0.8, None): b63,
             (28, N_TRAIN, 1, b255, f32, 1.0, None): "root",
             (28, N_TRAIN, 1, b255, f32, 0.05, None): "child",
             (28, N_TRAIN, 1, b255, f32, 1.0, "bin0_90"): "bin0_90",
             (28, N_TRAIN, 1, b255, torch.int16, 1.0, None): "root_i16",
             (28, N_TRAIN, 1, b255, torch.int16, 0.05, None): "child_i16",
             (28, N_TRAIN, 1, b63, torch.int8, 1.0, None): "root_i8",
             (28, N_TRAIN, 1, b63, torch.int8, 0.05, None): "child_i8"}
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
        key = timed.get((F, N, L, B, sdt, active, skew))
        if key is not None:
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
        return a, launches, model, out

    auc255, l255, model255, out255 = fit_transform(
        "max_bin=255 kernel", "_hist_kernel_nibble", histMethod="auto")
    auc63, l63, _, _ = fit_transform("max_bin=63 kernel", "_hist_kernel",
                                     maxBin=63, histMethod="auto")
    auc_plain, _, _, _ = fit_transform("max_bin=255 plain scatter", None,
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

    # ---- 6. the serving slice: save, reload, serve over HTTP --------------
    serving_slice(model255, out255, Xte, smi)

    # ---- 7. the GBDT training options at full width ----------------------
    int_launches = training_options(train_t, test_t, Xtr, ytr, Xte, yte,
                                    auc255, smi)

    # ---- 8. GBDT ingest beyond dense input --------------------------------
    ingest_routes = ingest_slice(auc255, Xtr, ytr, Xte, yte, test_t,
                                 measured, smi)

    # ---- 9. the zoo's ConvNet, ResNet and BiLSTM ---------------------------
    t0 = time.perf_counter()
    zoo_slice(dev, smi)
    print(f"zoo: phase 9 took {time.perf_counter() - t0:.1f} s")

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
    # the int16 / int8 instantiations, launched by phase 7's quantized fits
    # (b) and (c); times from phase 2
    for name, sdt, key, line in (
            (f"hist int16 (single leaf, B={b255}, root)", "int16",
             "root_i16", 67),
            (f"hist int16 (single leaf, B={b255}, 5 % child)", "int16",
             "child_i16", 67),
            (f"hist int8 (single leaf, B={b63}, root)", "int8", "root_i8",
             117),
            (f"hist int8 (single leaf, B={b63}, 5 % child)", "int8",
             "child_i8", 117)):
        m = measured[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/hist.cu",
            "replaces": f"mmlspark_tpu/gbdt/pallas_hist.py:{line}",
            "launches": int_launches[sdt], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"]})
    # the kernel on phase 8(a)'s Bosch-shape CSR bins (F = 968), launched
    # by its CSR fit; times from phase 8(a)
    for what, key in (("root", "bosch_root"), ("5 % child", "bosch_child")):
        m = measured[key]
        kernels.append({
            "name": f"hist (single leaf, B={m['B']}, F=968 Bosch-shape "
                    f"CSR bins, {what})", "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/hist.cu",
            "replaces": "mmlspark_tpu/gbdt/pallas_hist.py:" + (
                "67" if m["route"] == "_hist_kernel_nibble" else "117"),
            "launches": ingest_routes[m["route"]],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"]})
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
