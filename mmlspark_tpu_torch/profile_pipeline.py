"""Where a fused pipeline's time goes on the card, and the generators of
the reference's two pipeline benchmarks.

    python3 -m mmlspark_tpu_torch.profile_pipeline [--rows N] [--trace PATH]
    python3 -m mmlspark_tpu_torch.profile_pipeline --ooc [--rows N]

``pipeline_table`` is ``bench.py::bench_pipeline``'s input: raw rows of
``x1`` (normal, 1 % NaN), ``x2`` (uniform), a 128-level string
``color`` and token lists of 3-6 words from 800; label
``(x1 + x2) > 0.5``. ``ooc_chunk`` / ``ooc_source`` are
``bench.py::bench_ooc``'s chunk generator: ``a`` (normal f32), ``b``
(normal f32, 10 % NaN), an 8-level string and 3 tokens from 64, chunk i
drawn from seed 1000 + i.

The script fits bench_pipeline's pipeline (Featurize(32, one-hot) ->
StandardScaler -> TPULogisticRegression(maxIter=40) -> DropColumns) on
the first 100,000 rows, then times its transform of ``--rows`` rows
three ways — host stage-at-a-time, the same device ops stage-at-a-time
(``transform_staged``) and fused (a fresh table view, then warm) — and
profiles the warm fused transform: the card's busy and idle share, the
device-to-host copies, and the device time by kernel. With ``--ooc`` it
fits bench_ooc's pipeline instead and streams ``--rows`` rows (10M by
default) through ``transform_chunked`` at prefetch 3, 0, 3 and 0,
accounting each pass's wall in phase sums and thread CPU seconds
(``ooc_stream``), then profiles 8 chunks at prefetch 3 for the uploads'
streams (``ooc_streams_profile``). Needs a card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import numpy as np

PIPELINE_N = 1_000_000
PIPELINE_FIT_N = 100_000
PIPELINE_HASH_WIDTH = 32
PIPELINE_LEVELS = 128

OOC_ROWS = 10_000_000
OOC_CHUNK = 262_144
OOC_BUDGET_BYTES = 1_500_000_000
OOC_PREFETCH = 3
OOC_LEVELS = np.asarray([f"l{i}" for i in range(8)])
OOC_VOCAB = np.asarray([f"w{i:02d}" for i in range(64)])


def pipeline_table(n: Optional[int] = None, seed: int = 0):
    """bench_pipeline's raw rows (see the module docstring);
    ``PIPELINE_N`` of them by default."""
    from mmlspark_tpu_torch.core.table import DataTable
    n = PIPELINE_N if n is None else n
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n)
    x1[rng.random(n) < 0.01] = np.nan
    x2 = rng.uniform(size=n)
    colors = np.asarray([f"c{i:02d}" for i in range(PIPELINE_LEVELS)])
    color = colors[rng.integers(0, PIPELINE_LEVELS, n)].tolist()
    words = np.asarray([f"tok{i:04d}" for i in range(800)])
    lens = rng.integers(3, 7, n)
    flat = words[rng.integers(0, len(words), int(lens.sum()))].tolist()
    ends = np.cumsum(lens).tolist()
    starts = [0] + ends[:-1]
    toks = [flat[s:e] for s, e in zip(starts, ends)]
    label = ((np.nan_to_num(x1) + x2) > 0.5).astype(np.float64)
    return DataTable({"x1": x1, "x2": x2, "color": color, "toks": toks,
                      "label": label})


def pipeline_stages(device=None):
    """bench_pipeline's unfitted pipeline (the logistic fit on
    ``device``, None = the card)."""
    from mmlspark_tpu_torch.automl.featurize import Featurize
    from mmlspark_tpu_torch.core.stage import Pipeline
    from mmlspark_tpu_torch.models.linear import TPULogisticRegression
    from mmlspark_tpu_torch.stages.basic import DropColumns
    from mmlspark_tpu_torch.stages.dataprep import StandardScaler
    kw = {} if device is None else {"device": device}
    return Pipeline(stages=[
        Featurize(featureColumns=["x1", "x2", "color", "toks"],
                  numberOfFeatures=PIPELINE_HASH_WIDTH,
                  oneHotEncodeCategoricals=True),
        StandardScaler(inputCol="features", outputCol="features"),
        TPULogisticRegression(featuresCol="features", labelCol="label",
                              maxIter=40, **kw),
        DropColumns(cols=["features"]),
    ])


def fresh_view(table):
    """The same column buffers under a NEW table identity: the
    DeviceTable is cold, so a transform pays the host feed kernels and
    the upload as a fresh batch of data would."""
    from mmlspark_tpu_torch.core.table import DataTable
    return DataTable({c: table.column(c) for c in table.column_names},
                     table.schema)


def ooc_chunk(i: int, rows: int):
    """bench_ooc's chunk ``i`` (see the module docstring)."""
    from mmlspark_tpu_torch.core.table import DataTable
    rng = np.random.default_rng(1000 + i)
    a = rng.normal(size=rows).astype(np.float32)
    b = np.where(rng.random(rows) < 0.1, np.nan,
                 rng.normal(size=rows)).astype(np.float32)
    cat = OOC_LEVELS[rng.integers(0, len(OOC_LEVELS), rows)].tolist()
    toks = OOC_VOCAB[rng.integers(0, len(OOC_VOCAB),
                                  size=(rows, 3))].tolist()
    return DataTable({"a": a, "b": b, "cat": cat, "toks": toks})


def ooc_source(rows: Optional[int] = None, chunk: Optional[int] = None,
               depth: Optional[int] = None, on_end=None):
    """A ChunkedTable of ``rows`` rows of bench_ooc's chunks (by default
    ``OOC_ROWS`` in chunks of ``OOC_CHUNK``, prefetch ``OOC_PREFETCH``).
    ``on_end()``, when given, runs after a pass's last chunk on the
    thread that decodes."""
    from mmlspark_tpu_torch.io.ooc import ChunkedTable
    rows = OOC_ROWS if rows is None else rows
    chunk = OOC_CHUNK if chunk is None else chunk
    depth = OOC_PREFETCH if depth is None else depth

    def factory():
        done, i = 0, 0
        while done < rows:
            n = min(chunk, rows - done)
            yield ooc_chunk(i, n)
            done += n
            i += 1
        if on_end is not None:
            on_end()

    return ChunkedTable.from_generator(factory, num_rows=rows,
                                       prefetch_depth=depth)


def ooc_pipeline(device=None, rows: Optional[int] = None):
    """bench_ooc's fitted pipeline: Featurize(32) fitted streamed over
    ``ooc_source(rows)``, a StandardScaler fitted from a ChunkedTable of two
    chunks' features, and a logistic head (maxIter 10) on them, fused
    with ``batch_size=OOC_CHUNK`` on ``device`` (None = the card), its
    chunk shape run once. Returns (fused model, Featurize fit seconds)."""
    from mmlspark_tpu_torch.automl.featurize import Featurize
    from mmlspark_tpu_torch.core.fusion import fuse
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.io.ooc import ChunkedTable
    from mmlspark_tpu_torch.models.linear import TPULogisticRegression
    from mmlspark_tpu_torch.stages.dataprep import StandardScaler
    kw = {} if device is None else {"device": device}
    t0 = time.perf_counter()
    fz = Featurize(featureColumns=["a", "b", "cat", "toks"],
                   numberOfFeatures=32).fit(ooc_source(rows))
    fz_s = time.perf_counter() - t0
    sample = DataTable.concat([ooc_chunk(0, OOC_CHUNK),
                               ooc_chunk(1, OOC_CHUNK)])
    feat = fz.transform(sample)
    scaler = StandardScaler(inputCol="features").fit(
        ChunkedTable.from_table(feat, chunk_rows=OOC_CHUNK))
    rng = np.random.default_rng(0)
    y = (np.asarray(sample["a"], np.float64)
         + rng.normal(scale=0.5, size=len(sample)) > 0).astype(np.float64)
    logit = TPULogisticRegression(featuresCol="features", labelCol="label",
                                  maxIter=10, **kw).fit(
        scaler.transform(feat).with_column("label", y))
    fused = fuse([fz, scaler, logit], batch_size=OOC_CHUNK, device=device)
    fused.transform(ooc_chunk(0, OOC_CHUNK))    # the chunk shape's first run
    return fused, fz_s


def ooc_stream(fused, rows: Optional[int] = None,
               depth: int = OOC_PREFETCH) -> dict:
    """Stream ``rows`` of bench_ooc through ``fused.transform_chunked``
    at prefetch ``depth`` and account for the wall: the ooc phase sums
    (s), the CPU seconds of the thread that decodes and prepares (the
    prefetch worker; the consumer itself at depth 0), of the consumer
    and of the whole process, and the consumer's time outside the
    ``wait`` and ``dispatch`` phases (the output stream's own
    accounting and the loop body). Threads that run Python take turns
    on one interpreter lock, so where their CPU seconds add up to the
    wall, the stream ran on one core whatever the prefetch depth."""
    import torch

    from mmlspark_tpu_torch.core import metrics as MC
    worker = {}

    def on_end():
        # on the prefetch worker at depth > 0: its whole CPU clock
        worker["cpu_s"] = time.thread_time()

    src = ooc_source(rows=rows, depth=depth, on_end=on_end)
    for h in MC.ooc_histograms().values():
        h.reset()
    n, pred_sum = 0, 0.0
    c0, p0 = time.thread_time(), time.process_time()
    t0 = time.perf_counter()
    for out in fused.transform_chunked(src, prefetch_depth=depth):
        p = np.asarray(out["prediction"])
        n += len(p)
        pred_sum += float(p.sum())
    if fused.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    consumer_cpu = time.thread_time() - c0
    ph = {k: h.snapshot()["sum"] / 1e3
          for k, h in MC.ooc_histograms().items()}
    if depth == 0:
        worker["cpu_s"] = consumer_cpu
    return {"depth": depth, "rows": n, "pred_sum": pred_sum,
            "wall_s": wall, "phases_s": ph,
            "worker_cpu_s": worker.get("cpu_s", float("nan")),
            "consumer_cpu_s": consumer_cpu,
            "process_cpu_s": time.process_time() - p0,
            "consumer_outside_s": wall - ph["wait"] - ph["dispatch"]}


def ooc_streams_profile(fused, chunks: int = 8,
                        depth: int = OOC_PREFETCH) -> dict:
    """Profile ``chunks`` chunks of the bench_ooc stream at prefetch
    ``depth`` with torch.profiler and read its trace: the device's busy
    share of the window, host-to-device copies and kernels by CUDA
    stream, and the device time in which a copy ran beside a kernel of
    another stream (the side-stream uploads overlapping the dispatch)."""
    import json
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mmlspark_tpu_torch.profile_fit import union_us
    src = ooc_source(rows=chunks * OOC_CHUNK, depth=depth)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in fused.transform_chunked(src, prefetch_depth=depth):
            pass
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    h2d, kern = {}, {}
    for e in events:
        if e.get("ph") != "X" or "stream" not in e.get("args", {}):
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
        stream = int(e["args"]["stream"])
        if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""):
            h2d.setdefault(stream, []).append(span)
        elif e.get("cat") == "kernel":
            kern.setdefault(stream, []).append(span)
    all_spans = [s for v in list(h2d.values()) + list(kern.values())
                 for s in v]
    if not all_spans:
        raise RuntimeError("the profiler recorded no device activity")
    beside = 0.0
    for stream, spans in h2d.items():
        others = [s for k, v in kern.items() if k != stream for s in v]
        beside += (union_us(spans) + union_us(others)
                   - union_us(spans + others))
    return {"window_us": window_us, "busy_us": union_us(all_spans),
            "h2d_by_stream": {k: (len(v), union_us(v))
                              for k, v in h2d.items()},
            "kernels_by_stream": {k: (len(v), union_us(v))
                                  for k, v in kern.items()},
            "h2d_beside_kernel_us": beside}


def best_of(fn, reps: int):
    """(least wall seconds over ``reps`` runs, the last result); every
    run ends in a card synchronize."""
    import torch
    wall, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = min(wall, time.perf_counter() - t0)
    return wall, out


def profile_call(fn, trace: str = ""):
    """Run fn() under torch.profiler: (result, busy dict with the idle
    share, the device-to-host copy count and device time by name).
    Raises if the profiler recorded no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mmlspark_tpu_torch.profile_featurize import device_busy
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    busy = device_busy(prof, window_us)
    if not busy:
        raise RuntimeError("the profiler recorded no device activity")
    busy["d2h_copies"] = sum(
        v[0] for k, v in busy["by_name"].items()
        if "DtoH" in k or "Device -> Pinned" in k
        or "Device -> Pageable" in k)
    if trace:
        prof.export_chrome_trace(trace)
    return out, busy


def warm_profile(n: Optional[int] = None, trace: str = "") -> dict:
    """Fit bench_pipeline's pipeline on ``n`` rows' first
    ``PIPELINE_FIT_N``, fuse it on the card, run the table's shape once,
    then profile the warm fused transform: ``profile_call``'s busy dict
    with ``rows``. ``chip_smoke.py`` runs this in a fresh interpreter,
    where no earlier profiler session shares the process."""
    table = pipeline_table(n)
    pm = pipeline_stages().fit(table.slice(0, min(PIPELINE_FIT_N,
                                                  len(table))))
    fused = pm.fused()
    fused.transform(table)      # the shape's first run; columns ship
    _, busy = profile_call(lambda: fused.transform(table), trace)
    busy["rows"] = len(table)
    return busy


def ooc_main(rows: Optional[int]) -> int:
    """``--ooc``: see the module docstring."""
    import json

    import torch
    fused, fz_s = ooc_pipeline()
    print(f"bench_ooc pipeline on {torch.cuda.get_device_name(0)} "
          f"({os.cpu_count()} host cores): Featurize fitted streamed in "
          f"{fz_s:.3f} s; plan {fused.describe()}")
    sums = set()
    for depth in (OOC_PREFETCH, 0, OOC_PREFETCH, 0):
        r = ooc_stream(fused, rows, depth)
        sums.add(r["pred_sum"])
        ph = r["phases_s"]
        print(f"prefetch {depth}: {r['rows']} rows in {r['wall_s']:.3f} s;"
              f" phases decode {ph['decode']:.3f}, prepare "
              f"{ph['prepare']:.3f}, wait {ph['wait']:.3f}, dispatch "
              f"{ph['dispatch']:.3f}; consumer outside the phases "
              f"{r['consumer_outside_s']:.3f}; CPU s: decoding thread "
              f"{r['worker_cpu_s']:.3f}, consumer {r['consumer_cpu_s']:.3f},"
              f" process {r['process_cpu_s']:.3f} "
              f"({r['process_cpu_s'] / r['wall_s']:.2f} cores)")
        print(json.dumps(r))
    if len(sums) != 1:
        print(f"profile_pipeline: prediction sums differ across passes: "
              f"{sorted(sums)}", file=sys.stderr)
        return 1
    prof = ooc_streams_profile(fused)
    print(f"8 chunks at prefetch {OOC_PREFETCH} profiled: window "
          f"{prof['window_us'] / 1e3:.3f} ms, card busy "
          f"{prof['busy_us'] / 1e3:.3f} ms; host-to-device copies by "
          f"stream (count, us) {prof['h2d_by_stream']}; kernels by stream "
          f"{prof['kernels_by_stream']}; copies beside another stream's "
          f"kernels {prof['h2d_beside_kernel_us']:.1f} us")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--trace", default="")
    ap.add_argument("--ooc", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_pipeline: no CUDA device available", file=sys.stderr)
        return 1
    if args.ooc:
        return ooc_main(args.rows)
    table = pipeline_table(args.rows)
    args.rows = len(table)
    t0 = time.perf_counter()
    pm = pipeline_stages().fit(table.slice(0, min(PIPELINE_FIT_N,
                                                  args.rows)))
    print(f"fit on {min(PIPELINE_FIT_N, args.rows)} rows: "
          f"{time.perf_counter() - t0:.3f} s")
    fused = pm.fused()
    warm = table.slice(0, 4096)
    pm.transform(warm)
    fused.transform(warm)
    fused.transform_staged(warm)
    fused.transform(fresh_view(table))
    host_s, _ = best_of(lambda: pm.transform(fresh_view(table)), 2)
    staged_s, _ = best_of(lambda: fused.transform_staged(fresh_view(table)),
                          2)
    cold_s, _ = best_of(lambda: fused.transform(fresh_view(table)), 2)
    warm_s, _ = best_of(lambda: fused.transform(table), 3)
    print(f"{args.rows} rows on {torch.cuda.get_device_name(0)}: host "
          f"{host_s:.3f} s, staged on the card {staged_s:.3f} s, fused "
          f"cold {cold_s:.3f} s, warm {warm_s:.3f} s; plan "
          f"{fused.describe()}")
    _, busy = profile_call(lambda: fused.transform(table), args.trace)
    print(f"warm fused transform: window {busy['window_us'] / 1e3:.3f} ms,"
          f" card busy {busy['busy_us'] / 1e3:.3f} ms, idle "
          f"{100 * busy['idle_share']:.1f} %, device-to-host copies "
          f"{busy['d2h_copies']}")
    total = sum(v[1] for v in busy["by_name"].values())
    for name, (count, us) in sorted(busy["by_name"].items(),
                                    key=lambda kv: -kv[1][1])[:8]:
        print(f"  {us / 1e3:10.3f} ms  {100 * us / total:5.1f} %  "
              f"x{count:<6d} {name}")
    if args.trace:
        print(f"trace written to {os.path.abspath(args.trace)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
