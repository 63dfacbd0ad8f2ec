"""The shared bucket-warmup loop of the serving models: the port's copy
of ``mmlspark_tpu/core/warmup.py``.

``TPUModel.warmup`` runs every pow-2 shape bucket once before traffic;
this module is the one implementation of that loop, and it records each
bucket's wall time into the process-wide ``model_warmup_ms`` histogram.
In the port a bucket's first run is the first time the model meets that
padded (rows, dtype) shape (``TPUModel.jit_cache_misses``): the kernels
of the cuBLAS and caching-allocator paths it warms are what a live
request would otherwise pay for.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, List, Optional

import numpy as np

from mmlspark_tpu_torch.core import metrics as MC
from mmlspark_tpu_torch.core.logging_utils import get_logger

log = get_logger("warmup")


def check_warmup_example(table,
                         live_columns: Optional[List[str]] = None
                         ) -> List[str]:
    """Validate a warmup example against what live traffic will look
    like; returns actionable problem descriptions (empty = clean).

    The footgun this closes: an
    **all-None nullable column** in a 1-row warmup example infers
    OBJECT dtype, so every bucket compiles against a schema no live
    request will ever match — the first live batch carrying a real
    value replans and recompiles ON the hot path, silently paying
    exactly the compile the warmup promised to pre-pay. (A column
    mixing None with real values infers the value dtype and is fine.)

    ``live_columns`` — when the caller has already seen live traffic
    (the fused scorer's pinned request-key order) — additionally
    cross-checks the example's column set against it: a missing column
    means the warmed programs lack a field live batches carry (one
    replan per new field), an extra one means the example warms a
    schema wider than live traffic uses."""
    msgs: List[str] = []
    for name in table.column_names:
        col = table[name]
        if isinstance(col, np.ndarray):
            continue                   # typed column: dtype is explicit
        vals = list(col)
        if vals and all(v is None for v in vals):
            msgs.append(
                f"warmup example column {name!r} is all-None: it "
                f"infers OBJECT dtype, so the warmed programs are "
                f"specialized to a schema no live request will match "
                f"— the first live batch with a real value recompiles "
                f"on the hot path. Put one representative non-null "
                f"value in the example (float('nan') for a missing "
                f"numeric, '' for a missing string).")
    if live_columns:
        example = set(table.column_names)
        live = set(live_columns)
        missing = sorted(live - example)
        extra = sorted(example - live)
        if missing:
            msgs.append(
                f"warmup example is missing live request column(s) "
                f"{missing}: warmed programs will replan/recompile on "
                f"the first live batch that carries them.")
        if extra:
            msgs.append(
                f"warmup example carries column(s) {extra} never seen "
                f"in live requests: the warmed schema will not match "
                f"live batches.")
    return msgs


def warn_warmup_example(table,
                        live_columns: Optional[List[str]] = None
                        ) -> List[str]:
    """``check_warmup_example`` + emit each problem as a
    ``RuntimeWarning`` (and a log line) — called by every warmup hook,
    so the mismatch is announced AT warmup time instead of discovered
    as a mystery recompile on the first live batch."""
    msgs = check_warmup_example(table, live_columns)
    for m in msgs:
        warnings.warn(m, RuntimeWarning, stacklevel=3)
        log.warning("%s", m)
    return msgs


def warmup_buckets(run_bucket: Callable[[int], None],
                   sizes: List[int],
                   miss_count: Callable[[], int]) -> int:
    """Drive ``run_bucket(b)`` for every serving bucket size, timing
    each into ``model_warmup_ms``. Returns the number of first-time
    shapes met (``miss_count`` delta; 0 = everything was already warm)."""
    hist = MC.warmup_histograms()["model_warmup_ms"]
    before = miss_count()
    for b in sizes:
        t0 = time.perf_counter()
        run_bucket(b)
        hist.observe((time.perf_counter() - t0) * 1e3)
    return miss_count() - before


def warmup_transform(model, example, sizes: Optional[List[int]] = None
                     ) -> int:
    """The table-tiling warmup of ``TPUModel``: ``example`` (a DataTable
    or column->array dict with >= 1 representative row) tiles up to each
    bucket size and pushes through ``model.transform``; the model's
    ``jit_cache_misses`` counter is the first-run probe."""
    from mmlspark_tpu_torch.core.table import DataTable
    table = example if isinstance(example, DataTable) \
        else DataTable(dict(example))
    if len(table) == 0:
        raise ValueError("warmup needs at least one example row")
    warn_warmup_example(table)

    def run_bucket(b: int) -> None:
        idx = np.resize(np.arange(len(table)), b)
        model.transform(table._take_indices(idx))

    return warmup_buckets(run_bucket, sizes or model.bucket_sizes(),
                          lambda: model.jit_cache_misses)
