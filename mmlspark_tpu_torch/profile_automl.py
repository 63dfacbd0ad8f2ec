"""Where the time of the AutoML path goes on a CUDA card (the PyTorch port).

    python3 -m mmlspark_tpu_torch.profile_automl [--rows 1000000]
        [--trace-dir DIR]

Builds the JAX package's AutoML benchmark table (``bench.py``'s
``bench_automl``, copied here as ``automl_table`` since the port may not
import ``bench.py``): ``--rows`` rows from seed 0 of ``x1`` (normal, 1 %
NaN), ``x2`` (uniform), ``color`` (12 levels), ``toks`` (token lists of
5-12 words drawn from 2,000) and the label ``(x1 + x2) > 0.5``. Prints:
  - which hashing path runs here (pyarrow, or the numpy fallback where
    pyarrow is not installed), ``Featurize.fit`` and ``transform`` walls
    at hash width 64, the transform again with pyarrow blocked (the
    numpy path), and ``transform_rowloop`` on the first 100,000 rows;
  - the batched tune of ``bench_automl`` (8 candidates of
    ``TPULogisticRegression(maxIter=20)``, 3 folds, accuracy) on the
    first 200,000 featurized rows, then the same tune with
    ``batchTrials='off'``: walls, ``search_info``, the ``tune_*``
    histograms, and one candidate x fold's host scoring (the scores and
    ``ComputeModelStatistics``) timed alone;
  - under ``torch.profiler``: a dense logistic fit (default ``maxIter``
    300) on those rows, a sparse one over ``Featurize(sparse=True)`` (the
    reference's 262,144 width), and ``TrainClassifier``'s default GBDT
    on 200,000 rows. For each, the card's busy and idle shares of the
    host-timed window and device time by kernel; with ``--trace-dir`` a
    chrome trace of each.
Exits 1 without a card, or if the profiler records no device activity.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

AUTOML_N = 1_000_000
AUTOML_HASH_WIDTH = 64       # dense hashed block: 1M x 64 f32 = 256 MB
AUTOML_CANDIDATES = 8
AUTOML_TUNE_ROWS = 200_000   # the CV sweep runs on a subsample
FEATURE_COLUMNS = ["x1", "x2", "color", "toks"]


def automl_table(n: int = AUTOML_N, seed: int = 0):
    """``bench_automl``'s table, the same draws from ``seed``: returns
    (DataTable with a float64 ``label``, the label array)."""
    from mmlspark_tpu_torch.core.table import DataTable
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n)
    x1[rng.random(n) < 0.01] = np.nan       # NaN-imputation path engaged
    x2 = rng.uniform(size=n)
    colors = [f"c{i:02d}" for i in range(12)]
    color = [colors[i] for i in rng.integers(0, 12, n)]
    words = [f"token{i:04d}" for i in range(2000)]
    lens = rng.integers(5, 13, n)
    tok_ids = rng.integers(0, len(words), int(lens.sum()))
    toks, pos = [], 0
    for ln in lens:
        toks.append([words[j] for j in tok_ids[pos:pos + ln]])
        pos += int(ln)
    label = ((np.nan_to_num(x1) + x2) > 0.5).astype(np.float64)
    return DataTable({"x1": x1, "x2": x2, "color": color, "toks": toks,
                      "label": label}), label


def hashing_path() -> str:
    """The token-hashing path of ``stages/text`` here: ``pyarrow`` when
    it imports, else ``numpy`` (the fallback; both give the same
    arrays)."""
    try:
        import pyarrow  # noqa: F401
    except ImportError:
        return "numpy"
    return "pyarrow"


def transform_without_pyarrow(model, table):
    """``model.transform(table)`` with pyarrow blocked (the numpy hashing
    path, whatever is installed): (output table, seconds)."""
    saved = sys.modules.get("pyarrow")
    sys.modules["pyarrow"] = None
    try:
        t0 = time.perf_counter()
        out = model.transform(table)
        return out, time.perf_counter() - t0
    finally:
        if saved is None:
            del sys.modules["pyarrow"]
        else:
            sys.modules["pyarrow"] = saved


def tune_space():
    """``bench_automl``'s search space: stepSize 0.05-1.0 and regParam
    1e-5-1e-2, both log-uniform."""
    from mmlspark_tpu_torch.automl import HyperparamBuilder, RangeHyperParam
    return (HyperparamBuilder()
            .add_hyperparam("stepSize", RangeHyperParam(0.05, 1.0, log=True))
            .add_hyperparam("regParam",
                            RangeHyperParam(1e-5, 1e-2, log=True))
            .build())


def tuner(batch_trials: str, device: str = "cuda"):
    """``bench_automl``'s tune: 8 candidates of
    ``TPULogisticRegression(maxIter=20)``, 3 folds, accuracy, seed 0."""
    from mmlspark_tpu_torch.automl import RandomSpace, TuneHyperparameters
    from mmlspark_tpu_torch.models.linear import TPULogisticRegression
    return TuneHyperparameters(
        models=[TPULogisticRegression(maxIter=20, device=device)],
        paramSpace=RandomSpace(tune_space(), seed=0),
        evaluationMetric="accuracy", numFolds=3,
        numRuns=AUTOML_CANDIDATES, seed=0, batchTrials=batch_trials)


def profiled(label: str, fn, trace_dir: str = ""):
    """Run fn() under torch.profiler; print the card's busy / idle share
    of the host-timed window and the top device kernels. Returns fn()'s
    result, or raises if the profiler saw no device activity."""
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
        raise RuntimeError(f"{label}: the profiler recorded no device "
                           "activity")
    n_kernels = sum(v[0] for v in busy["by_name"].values())
    print(f"{label}: window {window_us / 1e3:.3f} ms, card busy "
          f"{busy['busy_us'] / 1e3:.3f} ms, idle "
          f"{100 * busy['idle_share']:.1f} %, {n_kernels} device kernels")
    total = sum(v[1] for v in busy["by_name"].values())
    for name, (count, us) in sorted(busy["by_name"].items(),
                                    key=lambda kv: -kv[1][1])[:6]:
        print(f"  {us / 1e3:10.3f} ms  {100 * us / total:5.1f} %  "
              f"x{count:<6d} {name}")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, label.replace(" ", "_") + ".json")
        prof.export_chrome_trace(path)
        print(f"  trace written to {path}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=AUTOML_N)
    ap.add_argument("--trace-dir", default="")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_automl: no CUDA device available", file=sys.stderr)
        return 1
    from mmlspark_tpu_torch.automl import Featurize, TrainClassifier
    from mmlspark_tpu_torch.core.metrics import automl_histograms
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.models.linear import TPULogisticRegression

    print(f"card: {torch.cuda.get_device_name(0)}; host cores "
          f"{os.cpu_count()}; hashing path {hashing_path()}")
    t0 = time.perf_counter()
    table, label = automl_table(args.rows)
    print(f"table: {args.rows} rows made in {time.perf_counter() - t0:.3f} s")
    feat = Featurize(featureColumns=FEATURE_COLUMNS,
                     numberOfFeatures=AUTOML_HASH_WIDTH)
    t0 = time.perf_counter()
    fm = feat.fit(table)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    X = fm.transform(table)["features"]
    tr_s = time.perf_counter() - t0
    np_s = transform_without_pyarrow(fm, table)[1]
    head = table.slice(0, 100_000)
    t0 = time.perf_counter()
    fm.transform_rowloop(head)
    loop_s = time.perf_counter() - t0
    print(f"Featurize: fit {fit_s:.3f} s, transform {tr_s:.3f} s "
          f"({X.shape}), with pyarrow blocked {np_s:.3f} s, "
          f"transform_rowloop of 100,000 rows {loop_s:.3f} s")

    k = min(AUTOML_TUNE_ROWS, args.rows)
    tune_t = DataTable({"features": X[:k], "label": label[:k]})
    for mode in ("auto", "off"):
        for h in automl_histograms().values():
            h.reset()
        t0 = time.perf_counter()
        tuned = tuner(mode).fit(tune_t)
        secs = time.perf_counter() - t0
        print(f"tune batchTrials={mode!r}: {secs:.3f} s, "
              f"{tuned.search_info}, bestParams "
              f"{tuned.get('bestParams')}, bestMetric "
              f"{tuned.get('bestMetric')}")
        for name in ("tune_fold_build", "tune_trials", "tune_refit"):
            print(f"  {name}: {automl_histograms()[name].summary()}")
    # one candidate x fold's host scoring, of which a tune does 24
    from mmlspark_tpu_torch.automl.tuning import _evaluate_scored
    from mmlspark_tpu_torch.core.table import features_matrix
    val = tune_t.slice(0, k // 3)
    Xv = features_matrix(val, "features")
    model = tuned.get("bestModel")
    t0 = time.perf_counter()
    scored = model.transform_from_matrix(val, Xv)
    score_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    _evaluate_scored(scored, "accuracy")
    eval_ms = 1e3 * (time.perf_counter() - t0)
    print(f"one candidate x fold's host scoring ({len(val)} rows): "
          f"transform_from_matrix {score_ms:.3f} ms, "
          f"ComputeModelStatistics {eval_ms:.3f} ms")

    profiled("dense logistic fit (maxIter 300)",
             lambda: TPULogisticRegression().fit(tune_t), args.trace_dir)
    head_t = table.slice(0, k)
    sparse_t = Featurize(featureColumns=FEATURE_COLUMNS,
                         sparse=True).fit(head_t).transform(head_t)
    profiled("sparse logistic fit (width 262144, maxIter 300)",
             lambda: TPULogisticRegression().fit(sparse_t), args.trace_dir)
    profiled("TrainClassifier default GBDT fit",
             lambda: TrainClassifier(featureColumns=FEATURE_COLUMNS,
                                     numFeatures=AUTOML_HASH_WIDTH
                                     ).fit(head_t), args.trace_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
