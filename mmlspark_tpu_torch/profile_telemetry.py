"""How the port's request and training spans line up with a CUDA card,
and what tracing costs a fit (the PyTorch port).

    python3 -m mmlspark_tpu_torch.profile_telemetry [--rows N] [--requests N]
    python3 -m mmlspark_tpu_torch.profile_telemetry --turns 12

Run it in a fresh interpreter: ``torch.profiler`` records the card only
in a process no earlier profiler session shared (``chip_smoke.py`` phase
14 starts it so). Three parts:

  1. **GBDT**: ``TPUBoostClassifier`` (63 leaves, max_bin 255, 5 rounds,
     seed 7) on the 1M x 28 HIGGS-shaped table of ``chip_smoke.py``
     phase 3 (its first ``--rows``; ``chip_smoke.py`` runs 250,000):
     one fit to warm up, then four with the process tracer on,
     off, off, on (fit seconds each), then one with it on under
     ``torch.profiler`` (CPU and CUDA). Its ``gbdt.train`` trace must
     hold one ``bin``, ``ship`` and ``boost`` span and ``boost_chunk``
     spans summing to within 5 % of ``train_timing["boost"]``; the
     ``gbdt_train_histograms()`` counts must rise by one fit. A clock
     marker, a ``record_function`` range around a ``perf_counter`` read,
     is taken on both clocks: shifting the profiler's chrome events by
     it puts them on the trace's timeline, ``merge_chrome_traces`` joins
     the two, and every ``hist_partial`` / ``hist_reduce`` kernel must
     lie inside a ``boost`` span (up to the marker's own width), with
     as many ``hist_partial`` kernels as ``hist_kernels.LAUNCHES``.
  2. **Serving**: that model behind ``serve_model(json_scoring_pipeline(
     model), port=0, batch_size=256, workers=2, max_wait_ms=5)`` with a
     tracer, driven as ``chip_smoke.py`` phase 6 drives it (2,000
     one-row requests, ``--requests``, from 16 client threads of a
     spawned process)
     after a warm-up pass, once without the profiler (the device spans'
     own length) and once under it: each batch's ``device`` span against
     the device time (kernels and copies) of the work launched inside
     it. Every reply must equal ``transform``'s.
  3. **LM**: bench_lm's bf16 fit of ``LM_SPEC`` (32 rows x 1024 tokens,
     batch 8, 2 epochs, AdamW 1e-3, device feed, ``memoryStatsEvery=4``),
     once without the profiler (the step spans' own length), then
     profiled: one ``learner.fit`` trace with one ``learner.step`` span a
     step, memory samples with ``bytes_in_use`` > 0, 8 launches of each
     flash kernel a step; each step span against the device time of the
     kernels it launched (matched by the profiler's correlation ids).
The profiler records every host op, which lengthens the host's spans;
so each span is reported from the run without it too.

``--turns N`` instead serves that model (phase 6's settings and client,
each request with a ``traceparent``) N times through ``onoff_turns``,
telemetry on (the defaults) and off (``tracing=False, slo=False,
flight_recorder=False``) in the turns on, off, off, on, ...:
requests/s, client p50 / p99, the engine's pipeline p50 and rows a
batch of each turn, and the medians; every reply must equal
``transform``'s. ``chip_smoke.py`` phase 14(c) measures the cost through
the same helper.

A span is a host interval: it ends when its code returns, which for a
launch is when the launch is queued. No synchronisation is added for a
span's sake; what the numbers show is how far the host's spans sit from
the card's own time. Prints a line per part and, last, one JSON object
with every number; exits 1 without a card or if a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

ROWS, ITERS, LEAVES, MAX_BIN = 1_000_000, 5, 63, 255
REQUESTS, CLIENTS = 2000, 16
LM_ROWS, LM_EPOCHS = 32, 2
MARKER = "mmlspark_tpu_torch.clock_marker"


def clock_marker() -> Tuple[float, float]:
    """A ``record_function`` range whose start the profiler stamps on
    its own clock, around a ``perf_counter`` read: the range starts
    inside (t0, t1). A first range of another name takes the first
    call's set-up cost, which would otherwise widen (t0, t1)."""
    import torch
    with torch.profiler.record_function(MARKER + ".warmup"):
        pass
    t0 = time.perf_counter()
    with torch.profiler.record_function(MARKER):
        t1 = time.perf_counter()
    return t0, t1


def aligned_events(prof, marker: Tuple[float, float]) -> Tuple[list, float]:
    """The profiler's chrome events shifted onto ``core.trace``'s
    timeline (microseconds since its epoch) by the clock marker, and the
    marker's half-width in microseconds (the alignment's uncertainty)."""
    from mmlspark_tpu_torch.core import trace as T
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    mark = [e for e in events if e.get("name") == MARKER and "ts" in e]
    if not mark:
        raise RuntimeError("the clock marker is missing from the profile")
    t0, t1 = marker
    offset = float(mark[0]["ts"]) - ((t0 + t1) / 2 - T._T0) * 1e6
    out = []
    for e in events:
        if "ts" in e:
            e = dict(e)
            e["ts"] = float(e["ts"]) - offset
            out.append(e)
    return out, (t1 - t0) / 2 * 1e6


def device_time_by_span(events: list, spans: List[Dict[str, Any]]
                        ) -> List[float]:
    """For each span event, the device microseconds (kernels and
    copies) of the work whose launch the host issued inside it."""
    dev_us: Dict[Any, float] = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                dev_us[c] = dev_us.get(c, 0.0) + float(e.get("dur", 0.0))
    launches = sorted(
        (float(e["ts"]), (e.get("args") or {}).get("correlation"))
        for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver"))
    out = []
    for s in spans:
        a, b = s["ts"], s["ts"] + s["dur"]
        out.append(sum(dev_us.get(c, 0.0) for t, c in launches
                       if a <= t <= b))
    return out


def _fresh_tracer():
    from mmlspark_tpu_torch.core import trace as T
    tracer = T.Tracer(enabled=True)
    T.set_tracer(tracer)
    return tracer


def _only(tracer, name: str):
    found = [t for t in tracer.buffer.traces() if t.root.name == name]
    if len(found) != 1:
        raise RuntimeError(f"{len(found)} {name} traces, not 1")
    return found[0]


def gbdt_part(rows: int = ROWS, requests: int = REQUESTS
              ) -> Tuple[dict, Any, np.ndarray]:
    """Part 1 on ``rows`` training rows. Returns (numbers, fitted model,
    ``requests`` holdout rows, which part 2 serves)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mmlspark_tpu_torch.core import metrics as MC
    from mmlspark_tpu_torch.core import trace as T
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.gbdt import hist_kernels as HK
    from mmlspark_tpu_torch.gbdt.estimators import TPUBoostClassifier
    from mmlspark_tpu_torch.profile_fit import higgs_shape

    X, y = higgs_shape(rows + requests)
    table = DataTable({"features": X[:rows], "label": y[:rows]})

    def fit():
        model = TPUBoostClassifier(numIterations=ITERS, numLeaves=LEAVES,
                                   maxBin=MAX_BIN, seed=7).fit(table)
        torch.cuda.synchronize()
        return model

    fit()
    fit_s: Dict[str, List[float]] = {"on": [], "off": []}
    for mode in ("on", "off", "off", "on"):
        T.set_tracer(T.Tracer(enabled=mode == "on"))
        t0 = time.perf_counter()
        fit()
        fit_s[mode].append(time.perf_counter() - t0)
    tracer = _fresh_tracer()
    before = {k: h.snapshot()["count"]
              for k, h in MC.gbdt_train_histograms().items()}
    HK.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        marker = clock_marker()
        model = fit()
    launches = sum(HK.LAUNCHES.values())
    rises = {k: h.snapshot()["count"] - before[k]
             for k, h in MC.gbdt_train_histograms().items()}
    booster = model.get_booster()
    tr = _only(tracer, "gbdt.train")
    names = [s.name for s in tr.spans()[1:]]
    chunks = [s for s in tr.spans() if s.name == "boost_chunk"]
    chunk_s = sum(s.end - s.start for s in chunks)
    boost_s = float(booster.train_timing["boost"])
    events, slack_us = aligned_events(prof, marker)
    merged = T.merge_chrome_traces(
        T.to_chrome_trace([tr], process_name="gbdt.train"),
        {"traceEvents": events, "otherData": {}})
    boosts = [e for e in merged["traceEvents"]
              if e.get("cat") == "mmlspark_tpu" and e["name"] == "boost"]
    kernels = [e for e in merged["traceEvents"]
               if e.get("cat") == "kernel"
               and ("hist_partial" in e["name"]
                    or "hist_reduce" in e["name"])]
    partial = sum(1 for e in kernels if "hist_partial" in e["name"])
    outside_us = 0.0
    for k in kernels:
        k0, k1 = k["ts"], k["ts"] + k["dur"]
        outside_us = max(outside_us, min(
            max(b["ts"] - k0, k1 - (b["ts"] + b["dur"]), 0.0)
            for b in boosts))
    checks = {
        "phase_spans": {n: names.count(n) for n in ("bin", "ship", "boost")}
        == {"bin": 1, "ship": 1, "boost": 1},
        "chunks_within_5pct": abs(chunk_s - boost_s) <= 0.05 * boost_s,
        "histograms_rose": {k: rises[k] for k in
                            ("bin", "ship", "boost", "fetch")}
        == {"bin": 1, "ship": 1, "boost": 1, "fetch": 1}
        and rises["boost_chunk"] == len(chunks),
        "launches_in_profile": partial == launches > 0,
        "kernels_inside_boost": bool(kernels) and outside_us <= slack_us,
    }
    on, off = np.mean(fit_s["on"]), np.mean(fit_s["off"])
    out = {
        "fit_s_tracer_on": fit_s["on"], "fit_s_tracer_off": fit_s["off"],
        "fit_gap_s": float(on - off), "fit_gap_pct": float(
            100 * (on - off) / off),
        "train_timing": dict(booster.train_timing),
        "spans": {n: names.count(n) for n in sorted(set(names))},
        "boost_s": boost_s, "boost_chunks_sum_s": chunk_s,
        "boost_span_s": next(s.end - s.start for s in tr.spans()
                             if s.name == "boost"),
        "histogram_rises": rises, "launches": launches,
        "hist_launches": dict(HK.LAUNCHES),
        "profile_hist_partial": partial,
        "profile_hist_kernels": len(kernels),
        "kernel_outside_boost_us": outside_us,
        "marker_half_width_us": slack_us,
        "hist_device_ms": sum(k["dur"] for k in kernels) / 1e3,
        "checks": checks,
    }
    return out, model, X[rows:]


def _device_events(payload: dict) -> dict:
    """span_id -> the chrome event of each served batch's device span."""
    return {e["args"]["span_id"]: e for e in payload["traceEvents"]
            if e["name"] == "device" and e["ph"] == "X"}


def _check_replies(replies, pred) -> None:
    bad = sum(r != {"prediction": int(p)} for r, p in zip(replies, pred))
    if bad:
        raise RuntimeError(f"{bad} replies differ from transform")


def serving_part(model, rows: np.ndarray) -> dict:
    """Part 2."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mmlspark_tpu_torch.core import trace as T
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.profile_serving import drive, post_json
    from mmlspark_tpu_torch.serving import json_scoring_pipeline, serve_model

    pred = model.transform(DataTable({"features": rows}))["prediction"]
    bodies = [json.dumps({"features": r.tolist()}).encode() for r in rows]
    # room for every request's trace: the device spans come from them
    tracer = T.Tracer(enabled=True,
                      buffer=T.TraceBuffer(capacity=4 * len(bodies)))
    engine = serve_model(json_scoring_pipeline(model), port=0,
                         batch_size=256, workers=2, max_wait_ms=5,
                         tracer=tracer, flight_recorder=False)
    runs = []
    try:
        # warm-up: clients in this process, which spares a spawn
        post_json(bodies, engine.source.address, CLIENTS)
        for profiled in (False, True):
            tracer.buffer.clear()
            if profiled:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    marker = clock_marker()
                    run = drive(engine, bodies, CLIENTS)
                    torch.cuda.synchronize()
            else:
                run = drive(engine, bodies, CLIENTS)
            if run[3]:
                raise RuntimeError(f"serving errors: {run[3][:3]}")
            _check_replies(run[0], pred)
            runs.append((run, _device_events(engine.export_traces())))
    finally:
        engine.stop()
    (_, plain), (run, devs) = runs
    events, slack_us = aligned_events(prof, marker)
    spans = [{"ts": e["ts"], "dur": e["dur"]} for e in devs.values()]
    dev_us = device_time_by_span(events, spans)
    span_ms = [s["dur"] / 1e3 for s in spans]
    return {"requests": len(bodies), "wall_s": run[2],
            "device_spans": len(spans),
            "rows_mean_unprofiled": float(np.mean(
                [e["args"]["rows"] for e in plain.values()])),
            "device_span_ms_mean_unprofiled": float(np.mean(
                [e["dur"] / 1e3 for e in plain.values()])),
            "device_span_ms_mean": float(np.mean(span_ms)),
            "device_time_ms_mean": float(np.mean(dev_us)) / 1e3,
            "device_share_of_span": float(
                np.sum(dev_us) / 1e3 / max(np.sum(span_ms), 1e-9)),
            "rows_mean": float(np.mean([e["args"]["rows"]
                                        for e in devs.values()])),
            "marker_half_width_us": slack_us}


def lm_part() -> dict:
    """Part 3."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mmlspark_tpu_torch.models.learner import TPULearner
    from mmlspark_tpu_torch.ops import flash_attention as FA
    from mmlspark_tpu_torch.profile_train import BATCH, slice_table
    from mmlspark_tpu_torch.profile_transform import LM_SPEC

    table = slice_table(LM_ROWS)
    steps = LM_EPOCHS * LM_ROWS // BATCH

    def learner():
        return TPULearner(
            networkSpec=LM_SPEC, loss="token_cross_entropy",
            optimizer="adamw", learningRate=1e-3, batchSize=BATCH,
            computeDtype="bfloat16", dataFeed="device", epochs=LM_EPOCHS,
            logEvery=1, memoryStatsEvery=4)

    tracer = _fresh_tracer()
    learner().fit(table)
    torch.cuda.synchronize()
    plain = [(s.end - s.start) * 1e3 for s in
             _only(tracer, "learner.fit").spans()
             if s.name == "learner.step"]
    tracer = _fresh_tracer()
    lrn = learner()
    FA.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        marker = clock_marker()
        lrn.fit(table)
        torch.cuda.synchronize()
    launches = dict(FA.LAUNCHES)
    tr = _only(tracer, "learner.fit")
    step_spans = [s for s in tr.spans() if s.name == "learner.step"]
    events, slack_us = aligned_events(prof, marker)
    own = {e["args"]["span_id"]: e for e in _chrome_events(tr)
           if e["name"] == "learner.step"}
    spans = [{"ts": own[s.span_id]["ts"], "dur": own[s.span_id]["dur"]}
             for s in step_spans]
    dev_us = device_time_by_span(events, spans)
    span_ms = [s["dur"] / 1e3 for s in spans]
    samples = lrn.memory_samples
    checks = {
        "one_step_span_a_step": len(step_spans) == steps
        and tr.root.attrs["steps"] == steps,
        "memory_samples": [s["step"] for s in samples] == list(
            range(4, steps + 1, 4))
        and all(s["bytes_in_use"] > 0 for s in samples),
        "flash_launches": all(v == LM_SPEC["depth"] * steps
                              for v in launches.values()),
    }
    return {"steps": steps, "launches": launches,
            "step_span_ms": span_ms, "step_device_ms": [
                u / 1e3 for u in dev_us],
            "step_span_ms_mean_after_first": float(np.mean(span_ms[1:])),
            "step_span_ms_unprofiled": plain,
            "step_span_ms_mean_after_first_unprofiled": float(
                np.mean(plain[1:])),
            "step_device_ms_mean_after_first": float(
                np.mean(dev_us[1:])) / 1e3,
            "memory_samples": samples, "root": dict(tr.root.attrs),
            "marker_half_width_us": slack_us, "checks": checks}


def _chrome_events(trace) -> list:
    from mmlspark_tpu_torch.core import trace as T
    return T.to_chrome_trace([trace])["traceEvents"]


def onoff_turns(scorer, bodies, traceparents, turns: int,
                inspect: Optional[Callable] = None) -> dict:
    """Serve ``scorer`` in ``turns`` fresh engines (phase 6's settings),
    telemetry on (the defaults) and off (``tracing=False, slo=False,
    flight_recorder=False``) in the turns on, off, off, on, ...;
    ``inspect(engine, mode, replies)`` runs after each turn, before its
    engine stops. Returns each turn's numbers, the medians of each mode
    and their on / off ratios."""
    from mmlspark_tpu_torch.profile_serving import drive, latency_numbers
    from mmlspark_tpu_torch.serving import serve_model
    order = [("on", "off", "off", "on")[k % 4] for k in range(turns)]
    runs = []
    for mode in order:
        kw = {} if mode == "on" else dict(
            tracing=False, slo=False, flight_recorder=False)
        engine = serve_model(scorer, port=0, batch_size=256, workers=2,
                             max_wait_ms=5, **kw)
        try:
            replies, lat, wall, errors = drive(engine, bodies, CLIENTS,
                                               traceparents)
            if errors:
                raise RuntimeError(f"serving errors: {errors[:3]}")
            m = engine.metrics()
            if inspect is not None:
                inspect(engine, mode, replies)
        finally:
            engine.stop()
        runs.append({"mode": mode, **latency_numbers(lat, wall),
                     "pipeline_p50_ms": m["pipeline_ms"]["p50"],
                     "rows_per_batch": m["batch_rows"]["mean"]})
    keys = ("rps", "p50_ms", "p99_ms", "pipeline_p50_ms")
    med = {m: {k: float(np.median([r[k] for r in runs if r["mode"] == m]))
               for k in keys} for m in ("on", "off")}
    return {"turns": runs, "median": med,
            **{f"{k}_ratio": med["on"][k] / med["off"][k] for k in keys}}


def onoff_part(turns: int) -> dict:
    """``--turns``: serving with telemetry on and off, in turns."""
    import torch

    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.gbdt.estimators import TPUBoostClassifier
    from mmlspark_tpu_torch.profile_fit import higgs_shape
    from mmlspark_tpu_torch.serving import json_scoring_pipeline

    X, y = higgs_shape(ROWS + REQUESTS)
    model = TPUBoostClassifier(numIterations=ITERS, numLeaves=LEAVES,
                               maxBin=MAX_BIN, seed=7).fit(
        DataTable({"features": X[:ROWS], "label": y[:ROWS]}))
    torch.cuda.synchronize()
    pred = model.transform(DataTable({"features": X[ROWS:]}))["prediction"]
    bodies = [json.dumps({"features": r.tolist()}).encode()
              for r in X[ROWS:]]
    tps = [f"00-c0ffee{i:026x}-{i + 1:016x}-01"
           for i in range(REQUESTS)]
    return onoff_turns(json_scoring_pipeline(model), bodies, tps, turns,
                       lambda engine, mode, replies:
                       _check_replies(replies, pred))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=0)
    ap.add_argument("--rows", type=int, default=ROWS,
                    help="training rows of the GBDT part")
    ap.add_argument("--requests", type=int, default=REQUESTS,
                    help="one-row requests of the serving part")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_telemetry: no CUDA device available",
              file=sys.stderr)
        return 1
    out: Dict[str, Any] = {"card": torch.cuda.get_device_name(0)}
    if args.turns:
        out["onoff"] = onoff_part(args.turns)
        for r in out["onoff"]["turns"]:
            print(f"telemetry {r['mode']}: {r['rps']:.1f} requests/s, p50 "
                  f"{r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms, "
                  f"pipeline p50 {r['pipeline_p50_ms']} ms, "
                  f"{r['rows_per_batch']:.2f} rows a batch")
        print(f"medians {out['onoff']['median']}; on / off requests/s "
              f"{out['onoff']['rps_ratio']:.4f}, p50 "
              f"{out['onoff']['p50_ms_ratio']:.4f}")
        print(json.dumps(out))
        return 0
    t0 = time.perf_counter()
    out["gbdt"], model, rows = gbdt_part(args.rows, args.requests)
    g = out["gbdt"]
    on = [round(x, 3) for x in g["fit_s_tracer_on"]]
    off = [round(x, 3) for x in g["fit_s_tracer_off"]]
    print(f"gbdt: fit s tracer on {on} / off {off} (gap "
          f"{g['fit_gap_s']:+.3f} s, {g['fit_gap_pct']:+.2f} %); spans "
          f"{g['spans']}; boost {g['boost_s']:.3f} s, chunks sum "
          f"{g['boost_chunks_sum_s']:.3f} s; {g['launches']} launches, "
          f"{g['profile_hist_partial']} hist_partial in the profile; worst "
          f"kernel outside a boost span {g['kernel_outside_boost_us']:.1f}"
          f" us (marker width {g['marker_half_width_us']:.1f} us); checks "
          f"{g['checks']}")
    out["serving"] = serving_part(model, rows)
    s = out["serving"]
    print(f"serving: {s['requests']} requests from {CLIENTS} client "
          f"threads of a second process, replies equal transform's; "
          f"device span {s['device_span_ms_mean_unprofiled']:.3f} ms "
          f"({s['rows_mean_unprofiled']:.1f} rows) without the profiler; "
          f"under it {s['device_spans']} device spans of "
          f"{s['rows_mean']:.1f} rows: span {s['device_span_ms_mean']:.3f}"
          f" ms, device work launched in it "
          f"{s['device_time_ms_mean']:.3f} ms "
          f"({100 * s['device_share_of_span']:.1f} % of the span)")
    del model
    torch.cuda.empty_cache()
    out["lm"] = lm = lm_part()
    samples = [(m["step"], m["bytes_in_use"]) for m in lm["memory_samples"]]
    print(f"lm: {lm['steps']} step spans, mean after the first "
          f"{lm['step_span_ms_mean_after_first_unprofiled']:.3f} ms "
          f"without the profiler, "
          f"{lm['step_span_ms_mean_after_first']:.3f} ms under it, "
          f"against "
          f"{lm['step_device_ms_mean_after_first']:.3f} ms of device "
          f"time launched in them; flash launches {lm['launches']}; "
          f"memory samples {samples}; checks {lm['checks']}")
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    failed = [k for part in ("gbdt", "lm")
              for k, v in out[part]["checks"].items() if not v]
    if failed:
        print(f"profile_telemetry: checks failed: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
