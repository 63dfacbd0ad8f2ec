"""Where a served GBDT request's time goes on a CUDA card (the PyTorch port).

    python3 -m mmlspark_tpu_torch.profile_serving [--clients 16] [--requests 2000]

Fits ``TPUBoostClassifier`` at the configuration of ``chip_smoke.py``
phase 3 (1M rows x 28 features, 5 rounds, 63 leaves, max_bin 255) on the
card and serves it through ``json_scoring_pipeline``:
  1. unloaded: the scorer's ``prepare_batch`` + ``execute_prepared`` on
     micro-batches of 1, 8, 64 and 256 one-row JSON requests, median of
     50 calls on the host clock; at 8 rows, ``torch.profiler`` over 20
     calls gives the device time and the kernel launches of one call;
  2. loaded: ``serve_model(json_scoring_pipeline(model), port=0,
     batch_size=256, workers=2, max_wait_ms=5)`` driven by ``--clients``
     client threads on keep-alive connections, first in this process,
     then in a second process (spawned, as ``chip_smoke.py`` phase 6
     drives it), so that the clients no longer share the engine's
     interpreter lock. For each: requests/s, client p50 / p99, rows per
     batch and the engine's p50 queue_wait / decode / pipeline / respond.
Every reply is checked against ``transform``. Exits 1 without a card, or
if the profiler records no device activity.
"""

from __future__ import annotations

import argparse
import atexit
import http.client
import json
import multiprocessing
import sys
import threading
import time
import urllib.parse

import numpy as np

ROWS, ITERS, LEAVES = 1_000_000, 5, 63


def higgs_shape(n: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 28)).astype(np.float32)
    logit = (X[:, 0] + 0.6 * X[:, 1] * X[:, 2]
             + 0.4 * np.sin(2 * X[:, 3]) - 0.3 * X[:, 4] ** 2 + 0.3)
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return X, y


def post_json(bodies, address: str, n_threads: int, traceparents=None):
    """POST each body (bytes) to ``address`` from ``n_threads`` client
    threads, each on its own keep-alive connection with a 60 s timeout;
    ``traceparents[i]``, when given, rides request i as its
    ``traceparent`` header. Returns (replies in body order as parsed
    JSON or None, per-request seconds, wall seconds, errors)."""
    url = urllib.parse.urlsplit(address)
    replies = [None] * len(bodies)
    lat = [0.0] * len(bodies)
    errors = []

    def client(k):
        conn = http.client.HTTPConnection(url.hostname, url.port,
                                          timeout=60)
        try:
            for i in range(k, len(bodies), n_threads):
                headers = {"Content-Type": "application/json"}
                if traceparents is not None:
                    headers["traceparent"] = traceparents[i]
                t0 = time.perf_counter()
                conn.request("POST", "/", body=bodies[i], headers=headers)
                r = conn.getresponse()
                data = r.read()
                lat[i] = time.perf_counter() - t0
                if r.status != 200:
                    errors.append(f"request {i}: HTTP {r.status} {data!r}")
                    return
                replies[i] = json.loads(data)
        except Exception as e:  # noqa: BLE001 — returned to the caller
            errors.append(f"client {k}: {type(e).__name__}: {e}")
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        errors.append("a client thread hung")
    return replies, lat, wall, errors


def _client_loop(in_q, out_q) -> None:
    """Spawned child: the same clients, outside the engine's process,
    for each job it is sent until it gets None."""
    while True:
        job = in_q.get()
        if job is None:
            return
        out_q.put(post_json(*job))


# the spawned client process, started at the first drive() and reused by
# the next ones: a spawn (a fresh interpreter importing the package)
# costs seconds, more than a driven run; closed at exit
_CLIENT = None


def close_client() -> None:
    """Stop the reused client process, if one runs."""
    global _CLIENT
    if _CLIENT is None:
        return
    proc, in_q, _ = _CLIENT
    _CLIENT = None
    try:
        in_q.put(None)
        proc.join(timeout=10)
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join()


def _client():
    global _CLIENT
    if _CLIENT is None or not _CLIENT[0].is_alive():
        close_client()
        ctx = multiprocessing.get_context("spawn")
        in_q, out_q = ctx.Queue(), ctx.Queue()
        proc = ctx.Process(target=_client_loop, args=(in_q, out_q),
                           daemon=True)
        proc.start()
        _CLIENT = (proc, in_q, out_q)
    return _CLIENT


atexit.register(close_client)


def drive(engine, bodies, n_threads: int, traceparents=None):
    """POST ``bodies`` to ``engine`` from ``n_threads`` client threads of
    a spawned process (as ``post_json`` does), so that the clients do
    not share the engine's interpreter lock; then wait, polling for at
    most 30 s, until the engine's source has counted every reply.
    Returns what ``post_json`` returns. The client process is started
    once and reused by later calls (``close_client`` stops it). A client
    process that sends no result within 300 s or dies is reported among
    the errors, and the next call starts a fresh one."""
    import queue
    n0 = engine.source.requests_answered
    proc, in_q, out_q = _client()
    in_q.put((bodies, engine.source.address, n_threads, traceparents))
    replies, lat, wall, errors = [None] * len(bodies), [], 0.0, []
    try:
        replies, lat, wall, errors = out_q.get(timeout=300)
    except queue.Empty:
        errors = ["the client process sent no result"]
        close_client()
    if not proc.is_alive():
        errors = errors + [f"client process exit code {proc.exitcode}"]
        close_client()
    wait_answered(engine, n0 + len(bodies))
    return replies, lat, wall, errors


def wait_answered(engine, n: int) -> None:
    """Poll, for at most 30 s, until the engine's source has counted
    ``n`` replies: the handler counts a reply just after sending it."""
    deadline = time.monotonic() + 30
    while engine.source.requests_answered < n and \
            time.monotonic() < deadline:
        time.sleep(0.01)


def _percentile_ms(lat, q: float) -> float:
    ms = np.sort(np.asarray(lat)) * 1e3
    return float(ms[int(q * (len(ms) - 1))])


def latency_numbers(lat, wall: float) -> dict:
    """requests/s and client p50 / p99 (ms) of one driven run."""
    return {"rps": len(lat) / wall, "p50_ms": _percentile_ms(lat, 0.50),
            "p99_ms": _percentile_ms(lat, 0.99)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--requests", type=int, default=2000)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device available", file=sys.stderr)
        return 1
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.gbdt.estimators import TPUBoostClassifier
    from mmlspark_tpu_torch.serving import json_scoring_pipeline, serve_model

    print(f"card: {torch.cuda.get_device_name(0)}")
    X, y = higgs_shape(ROWS + args.requests)
    Xtr, ytr, Xte = X[:ROWS], y[:ROWS], X[ROWS:]
    model = TPUBoostClassifier(numIterations=ITERS, numLeaves=LEAVES,
                               device="cuda").fit(
        DataTable({"features": Xtr, "label": ytr}))
    pred = model.transform(DataTable({"features": Xte}))["prediction"]
    bodies = [json.dumps({"features": row.tolist()}).encode()
              for row in Xte]
    scorer = json_scoring_pipeline(model)

    def batch(n):
        return DataTable({"id": [str(i) for i in range(n)],
                          "request": [{"headers": {}, "entity": b}
                                      for b in bodies[:n]]})

    # -- 1. unloaded --------------------------------------------------------
    for n in (1, 8, 64, 256):
        table = batch(n)
        for _ in range(5):
            scorer.execute_prepared(table, scorer.prepare_batch(table))
        dec, exe = [], []
        for _ in range(50):
            t0 = time.perf_counter()
            prepped = scorer.prepare_batch(table)
            t1 = time.perf_counter()
            out = scorer.execute_prepared(table, prepped)
            exe.append(time.perf_counter() - t1)
            dec.append(t1 - t0)
        want = [{"prediction": int(p)} for p in pred[:n]]
        if list(out["reply"]) != want:
            print(f"profile_serving: {n}-row replies differ from "
                  "transform", file=sys.stderr)
            return 1
        print(f"unloaded {n:3d} rows: decode {np.median(dec) * 1e3:.3f} "
              f"ms, execute (transform + replies) "
              f"{np.median(exe) * 1e3:.3f} ms (median of 50)")
    from torch.profiler import ProfilerActivity, profile
    table = batch(8)
    prepped = scorer.prepare_batch(table)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            scorer.execute_prepared(table, prepped)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print("profile_serving: the profiler saw no device activity",
              file=sys.stderr)
        return 1
    dev_us = sum(e.device_time for e in dev) / 20
    kinds = {}
    for e in dev:
        kinds[e.name] = kinds.get(e.name, 0) + 1
    print(f"unloaded 8 rows under the profiler: {len(dev) / 20:.1f} device "
          f"ops a call, {dev_us:.1f} us of device time a call; by name "
          f"(count in 20 calls): "
          f"{dict(sorted(kinds.items(), key=lambda kv: -kv[1])[:8])}")

    # -- 2. loaded: clients in this process, then in another ---------------
    for where in ("same process", "second process"):
        engine = serve_model(json_scoring_pipeline(model), port=0,
                             batch_size=256, workers=2, max_wait_ms=5)
        try:
            if where == "same process":
                replies, lat, wall, errors = post_json(
                    bodies, engine.source.address, args.clients)
                wait_answered(engine, len(bodies))
            else:
                replies, lat, wall, errors = drive(
                    engine, bodies, args.clients)
            m = engine.metrics()
        finally:
            engine.stop()
        if errors or any(r != {"prediction": int(p)}
                         for r, p in zip(replies, pred)):
            print(f"profile_serving: {where}: errors {errors[:3]} or "
                  "replies differ from transform", file=sys.stderr)
            return 1
        n = len(bodies)
        print(f"loaded, {args.clients} clients in the {where}: {n} "
              f"requests in {wall:.3f} s ({n / wall:.1f} requests/s), "
              f"client p50 {_percentile_ms(lat, 0.50):.3f} ms, p99 "
              f"{_percentile_ms(lat, 0.99):.3f} ms; "
              f"{m['batches_processed']} batches of "
              f"{m['batch_rows'].get('mean', 0):.2f} rows; p50 ms: "
              f"queue_wait {m['queue_wait_ms'].get('p50')}, decode "
              f"{m['decode_ms'].get('p50')}, pipeline "
              f"{m['pipeline_ms'].get('p50')}, respond "
              f"{m['respond_ms'].get('p50')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
