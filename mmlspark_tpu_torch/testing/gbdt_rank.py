"""One rank of a distributed GBDT group, as a process of its own.

It imports nothing of JAX. Spawn WORLD of them with the same coordinator
PORT; each joins the ``torch.distributed`` group
(``parallel.distributed.initialize``: the bounded barrier, then gloo),
runs the whole sweep of fits on its own device, one after another, and
prints lines a parent reads (``<name>`` is ``<dataset>/<tag>``):

    READY <rank> <world> <device> <seconds to join> <epoch seconds>
    BINS <rank> <name> <sha of the agreed cuts>
    DIGEST <rank> <name> <model sha> <forest sha> <structure sha> <bins sha>
    FIT <rank> <name> <fit s> <collective s> <hist launches> <histograms>
        <holdout AUC> <psum bytes> <psum_scatter bytes> <all_gather bytes>
    QREF 0 <dataset> <structure and counts equal 0/1> <max relative
        leaf-value difference> <fit s> <holdout AUC>
    VOTE 0 <dataset> <root splits equal 0/1> <nodes that differ> <nodes>
    OK <rank>

The shas are the first 16 hex digits of: the model string; the forest's
arrays; its feature, bin_threshold, left, right and count; the cuts. The
collective seconds and bytes are the boosting loop's
(``train_info['collective_s']``, ``['comm_bytes']``); the launches are
the hist kernel's (``hist_kernels.LAUNCHES``). ``--out DIR`` writes
each fit's model string to ``DIR/<dataset>.<tag>.rank<r>.txt``.

``--sweep`` is ``dataset:tag,tag,...`` parts joined by ``;``. Datasets:

- ``fabric``: the JAX package's fabric drill — 400 x 6 normal rows
  (seed 11), label x0 + 0.5 x1 > 0; each rank streams its rows as two
  shards; 5 rounds, 7 leaves, max_bin 15, min_data_in_leaf 5,
  ``bin_fit='sketch'``.
- ``higgs``: the HIGGS-shaped table of ``chip_smoke.py`` (28 float32
  features, seed 7): ``--rows`` training rows then ``--holdout`` rows;
  5 rounds, ``--leaves`` leaves, ``--max-bin``.
- ``vote`` and ``fp``: the voting and feature-parallel contracts'
  tables of ``tests/test_gbdt.py`` (2400 x 24, seed 3; 2000 x 37, seed
  0); 6 rounds, 15 leaves, max_bin 31.

Row-sharded fits give each rank its contiguous 1 / WORLD of the training
rows; ``feature`` gives every rank the whole table. Tags: ``f32_psum``,
``f32_rs``, ``q16_psum``, ``q16_rs`` (data-parallel, hist_comm psum /
reduce_scatter, hist_bits 32 / 16), ``vote_all`` (voting, top_k = F),
``vote_3``, ``vote_3_long`` (top_k 3; the latter 20 rounds at max_bin
63), ``vote_q16`` (voting at 16 bits, top_k = F), ``feature``,
``sketch`` (f32 psum with ``bin_fit='sketch'``) and ``qref`` (rank 0
alone, after the dataset's fits: a one-process q16 fit of the whole
table with ``q16_psum``'s agreed cuts frozen). With ``f32_psum`` and
``vote_all`` in a dataset, rank 0 compares their structures (``VOTE``).

``--die-before-rendezvous`` makes a rank other than 0 exit (code 3,
``DIED <rank>``) without joining: the member-death drill, where rank 0
must print ``GROUP_ERROR 0 <seconds> <type>`` and exit 7 within its
``--timeout-s``.

Usage::

    python -m mmlspark_tpu_torch.testing.gbdt_rank PORT RANK WORLD
        [--device cpu|cuda] [--sweep SPEC] [--rows N] [--holdout N]
        [--leaves L] [--max-bin B] [--timeout-s T] [--out DIR]
        [--die-before-rendezvous]
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

import numpy as np

FITS = {
    "f32_psum": {"parallelism": "data", "hist_comm": "psum"},
    "f32_rs": {"parallelism": "data", "hist_comm": "reduce_scatter"},
    "q16_psum": {"parallelism": "data", "hist_bits": 16,
                 "hist_comm": "psum"},
    "q16_rs": {"parallelism": "data", "hist_bits": 16,
               "hist_comm": "reduce_scatter"},
    "vote_all": {"parallelism": "voting", "top_k": None},
    "vote_3": {"parallelism": "voting", "top_k": 3},
    "vote_q16": {"parallelism": "voting", "hist_bits": 16, "top_k": None},
    "feature": {"parallelism": "feature"},
    "sketch": {"parallelism": "data", "hist_comm": "psum",
               "bin_fit": "sketch"},
    # the small-k voting contract: 20 rounds at max_bin 63
    "vote_3_long": {"parallelism": "voting", "top_k": 3,
                    "num_iterations": 20, "max_bin": 63},
}
STRUCT_KEYS = ("feature", "bin_threshold", "left", "right", "count")


def higgs_shape(n: int, seed: int = 7):
    """The HIGGS-shaped synthetic task of chip_smoke.py and
    tests/test_gbdt_dist_quant.py: 28 dense float32 features."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 28)).astype(np.float32)
    logit = (X[:, 0] + 0.6 * X[:, 1] * X[:, 2]
             + 0.4 * np.sin(2 * X[:, 3]) - 0.3 * X[:, 4] ** 2 + 0.3)
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return X, y


def vote_table():
    """The voting contract's table of tests/test_gbdt.py: 2400 x 24,
    seed 3."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(2400, 24))
    return X, (X[:, 0] * 2 + X[:, 1] * X[:, 2] + 0.5 * X[:, 5] > 0
               ).astype(float)


def fp_table():
    """The feature-parallel contract's table of tests/test_gbdt.py:
    2000 x 37 (F not a multiple of the group), seed 0."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2000, 37))
    return X, (X[:, 0] * 2 + X[:, 1] * X[:, 2] > 0).astype(float)


def fabric_table():
    """The JAX package's fabric-drill table: 400 x 6, seed 11."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(400, 6))
    return X, (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)


def auc(y, p) -> float:
    order = np.argsort(p, kind="stable")
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    n_pos = int((y == 1).sum())
    n_neg = len(y) - n_pos
    return float((ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2)
                 / max(n_pos * n_neg, 1))


def _sha(*chunks: bytes) -> str:
    h = hashlib.sha256()
    for c in chunks:
        h.update(c)
    return h.hexdigest()[:16]


def forest_sha(trees, keys=None) -> str:
    keys = sorted(trees) if keys is None else keys
    return _sha(*(np.ascontiguousarray(trees[k]).tobytes() for k in keys))


def bins_sha(mapper) -> str:
    return _sha(*(np.asarray(u).tobytes() for u in mapper.upper_bounds))


def dataset(name: str, rank: int, world: int, args):
    """(local rows, full table, holdout, base params, F) of a preset:
    local rows are this rank's contiguous 1 / world of the training rows
    (a list of two shard tuples for ``fabric``)."""
    if name == "fabric":
        X, y = fabric_table()
        per = len(X) // world
        lo = rank * per
        local = [(X[k:k + per // 2], y[k:k + per // 2])
                 for k in (lo, lo + per // 2)]
        base = {"objective": "binary", "num_iterations": 5,
                "num_leaves": 7, "max_bin": 15, "min_data_in_leaf": 5,
                "bin_fit": "sketch"}
        return local, (X, y), (X, y), base, X.shape[1]
    if name == "higgs":
        X, y = higgs_shape(args.rows + args.holdout)
        Xte, yte = X[args.rows:], y[args.rows:]
        X, y = X[:args.rows], y[:args.rows]
        base = {"objective": "binary", "num_iterations": 5,
                "num_leaves": args.leaves, "max_bin": args.max_bin,
                "min_data_in_leaf": 20}
    elif name == "vote":
        X, y = vote_table()
        Xte, yte = X, y
        base = {"objective": "binary", "num_iterations": 6,
                "num_leaves": 15, "max_bin": 31, "min_data_in_leaf": 5}
    elif name == "fp":
        X, y = fp_table()
        Xte, yte = X, y
        base = {"objective": "binary", "num_iterations": 6,
                "num_leaves": 15, "max_bin": 31, "min_data_in_leaf": 5}
    else:
        raise ValueError(f"unknown dataset {name!r}")
    per = len(X) // world
    local = (X[rank * per:(rank + 1) * per],
             y[rank * per:(rank + 1) * per])
    return local, (X, y), (Xte, yte), base, X.shape[1]


def run_dataset(args, rank, world, data, tags, train, HK, torch) -> None:
    """Every fit of one dataset of the sweep, in order."""
    local, full, (Xte, yte), base, n_feat = dataset(data, rank, world,
                                                    args)
    boosters = {}
    for tag in tags:
        if tag == "qref":
            continue
        over = dict(FITS[tag])
        if over.get("top_k", 0) is None:
            over["top_k"] = n_feat
        params = {**base, **over}
        rows = full if tag == "feature" else local
        HK.reset_launches()
        t_fit = time.perf_counter()
        if isinstance(rows, list):
            booster = train(params, rows, device=args.device)
        else:
            booster = train(params, rows[0], rows[1], device=args.device)
        if args.device == "cuda":
            torch.cuda.synchronize()
        fit_s = time.perf_counter() - t_fit
        launches = sum(HK.LAUNCHES.values())
        boosters[tag] = booster
        mstr = booster.model_to_string()
        comm = booster.train_info.get("comm_bytes", {})
        a = auc(yte, booster.predict(Xte))
        bsha = bins_sha(booster.bin_mapper)
        name = f"{data}/{tag}"
        print(f"BINS {rank} {name} {bsha}", flush=True)
        print(f"DIGEST {rank} {name} {_sha(mstr.encode())} "
              f"{forest_sha(booster.trees)} "
              f"{forest_sha(booster.trees, STRUCT_KEYS)} {bsha}",
              flush=True)
        print(f"FIT {rank} {name} {fit_s:.4f} "
              f"{booster.train_info.get('collective_s', 0.0):.4f} "
              f"{launches} {booster.train_info['histograms']} {a:.6f} "
              f"{comm.get('psum', 0)} {comm.get('psum_scatter', 0)} "
              f"{comm.get('all_gather', 0)}", flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"{data}.{tag}.rank{rank}"
                                   ".txt"), "w") as fh:
                fh.write(mstr)
    if "qref" in tags and rank == 0:
        # a one-process q16 fit of the whole table with the group's cuts
        # frozen: rows round by the same global ids, so the integer
        # histograms, hence structure and counts, are the group's
        dist_b = boosters["q16_psum"]
        t_fit = time.perf_counter()
        ref = train({**base, "hist_bits": 16}, full[0], full[1],
                    device=args.device, bin_mapper=dist_b.bin_mapper)
        ref_s = time.perf_counter() - t_fit
        same = all(np.array_equal(ref.trees[k], dist_b.trees[k])
                   for k in STRUCT_KEYS)
        v_ref, v_dist = ref.trees["value"], dist_b.trees["value"]
        rel = float(np.max(np.abs(v_ref - v_dist)
                           / np.maximum(np.abs(v_ref), 1e-30)))
        print(f"QREF 0 {data} {int(same)} {rel:.3e} {ref_s:.4f} "
              f"{auc(yte, ref.predict(Xte)):.6f}", flush=True)
    if "f32_psum" in boosters and "vote_all" in boosters and rank == 0:
        # voting at top_k >= F against data-parallel: root splits, and
        # the nodes that differ (near-tie flips) of the whole structure
        bd, bv = boosters["f32_psum"].trees, boosters["vote_all"].trees
        root = all(np.array_equal(bd[k][:, 0], bv[k][:, 0])
                   for k in ("feature", "bin_threshold"))
        keys = ("feature", "bin_threshold", "left", "right")
        diff = sum(int(np.sum(bd[k] != bv[k])) for k in keys)
        print(f"VOTE 0 {data} {int(root)} {diff} "
              f"{sum(bd[k].size for k in keys)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("port", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--holdout", type=int, default=2048)
    ap.add_argument("--leaves", type=int, default=15)
    ap.add_argument("--max-bin", type=int, default=63)
    ap.add_argument("--sweep", default="fabric:f32_psum,f32_rs,q16_psum,"
                    "q16_rs")
    ap.add_argument("--timeout-s", type=float, default=60.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--die-before-rendezvous", action="store_true")
    args = ap.parse_args(argv)
    rank, world = args.rank, args.world

    from mmlspark_tpu_torch.parallel import distributed as dist

    if args.die_before_rendezvous and rank != 0:
        print(f"DIED {rank}", flush=True)
        return 3
    t0 = time.monotonic()
    try:
        info = dist.initialize(f"127.0.0.1:{args.port}",
                               num_processes=world, process_id=rank,
                               timeout_s=args.timeout_s)
    except dist.ProcessGroupError as e:
        print(f"GROUP_ERROR {rank} {time.monotonic() - t0:.1f} "
              f"{type(e).__name__}", flush=True)
        return 7
    assert info.process_count == world and info.process_index == rank, info
    assert dist.in_process_group() == (world > 1)
    dist.require_process_group(world)

    import torch
    from mmlspark_tpu_torch.gbdt import hist_kernels as HK
    from mmlspark_tpu_torch.gbdt.booster import train

    if args.device == "cuda":
        torch.cuda.set_device(0)
    print(f"READY {rank} {world} {args.device} "
          f"{time.monotonic() - t0:.2f} {time.time():.3f}", flush=True)

    sweep = []
    for part in args.sweep.split(";"):
        data, _, fits = part.partition(":")
        sweep.append((data, [t for t in fits.split(",") if t]))
    for data, tags in sweep:
        run_dataset(args, rank, world, data, tags, train, HK, torch)
    print(f"OK {rank}", flush=True)
    dist.shutdown()
    return 0


if __name__ == "__main__":
    # a rank imports nothing of JAX (the package never does; this makes
    # it certain)
    sys.modules["jax"] = None
    sys.exit(main())
