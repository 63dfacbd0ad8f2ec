"""The standard model-behind-HTTP scorers: the part of
``mmlspark_tpu/serving/fleet.py`` the port holds so far.

``json_scoring_pipeline`` wraps one fitted model (a ``TPUModel``, or a
GBDT / other estimator model that emits one prediction per row) and
``json_row_scoring_pipeline`` any tabular pipeline; both return a stage
that ``serve_model`` serves. Serving a ``PipelineModel`` through
``json_scoring_pipeline`` compiles it to a fused device program in the
reference; here it raises (ROADMAP.md, 'Device pipeline and serving
compilation') — ``json_row_scoring_pipeline`` serves one unfused. The
multi-engine client ``ServingFleet`` and ``PartitionConsolidator`` are
not ported yet (ROADMAP.md, 'The rest of the serving plane').
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List

import numpy as np

from mmlspark_tpu_torch.core.table import DataTable


class ServingUnavailable(RuntimeError):
    """Every candidate engine failed at the transport level (or was
    skipped by an open circuit). ``attempts`` is the per-engine log:
    ``[{"engine": i, "address": ..., "error": ..., "skipped": bool}]`` —
    the typed replacement for leaking raw urllib errors to callers."""

    def __init__(self, attempts: List[Dict[str, Any]]):
        self.attempts = list(attempts)
        detail = "; ".join(
            f"{a['address']}: {a['error']}" for a in self.attempts)
        super().__init__(
            f"no serving engine available after "
            f"{len(self.attempts)} attempt(s): {detail or 'none tried'}")


def json_scoring_pipeline(model, field: str = "features",
                          reply_field: str = "prediction",
                          drift_monitor=None, reply_col: str = None,
                          batch_size: int = 256):
    """The standard model-behind-HTTP pipeline: decode JSON request
    bodies ``{field: [floats]}``, score the micro-batch through
    ``model`` (a TPUModel whose inputCol is ``field``, or an estimator
    model whose featuresCol is), reply ``{reply_field: value}`` per row —
    the argmax class of a TPUModel's score matrix, or the model's own
    prediction column.

    The COLUMNAR ingress protocol rides alongside JSON (io/columnar.py):
    a request whose Content-Type negotiates msgpack-columns or Arrow IPC
    carries typed column buffers for any number of rows, and its reply
    carries one value per row. A body that fails its negotiated codec is
    400d alone while batch-mates proceed.

    The returned stage exposes the ServingEngine two-stage split:
    ``prepare_batch`` (codec negotiate + decode + column assembly, host
    work the batcher thread runs while the card executes the previous
    batch) and ``execute_prepared`` (model forward + reply build, run by
    a worker). ``transform`` remains the single-stage fallback — the
    per-row poison-isolation retry uses it.

    ``drift_monitor`` (a ``core.metrics.DriftMonitor``) makes the stage
    observe every scored feature batch, so per-feature drift vs the
    fit-time statistics rides along in ``metrics()`` and /healthz. The
    stage also forwards the model's ``warmup``, ``histograms``,
    ``bucket_for`` and first-run shape counter."""
    from mmlspark_tpu_torch.core.metrics import (
        ingress_decode_histogram, ingress_histograms,
    )
    from mmlspark_tpu_torch.core.quantize import stage_precision
    from mmlspark_tpu_torch.core.stage import PipelineModel
    from mmlspark_tpu_torch.io import columnar as CIN
    from mmlspark_tpu_torch.stages.basic import Lambda

    if isinstance(model, PipelineModel):
        raise NotImplementedError(
            "serving a PipelineModel through its fused device program is "
            "not ported yet: ROADMAP.md, 'Device pipeline and serving "
            "compilation' (json_row_scoring_pipeline serves it unfused)")

    # feature dim confirmed by the last SUCCESSFUL score: columnar
    # requests with a mismatching width 400 instead of poisoning the
    # micro-batch. Learned only after success, so a bad first request
    # can never teach the scorer the wrong width.
    _state = {"dim": None}

    def decode(table: DataTable) -> CIN.PreparedBatch:
        """Per-request codec negotiation + decode + column assembly:
        JSON bodies stay the parity oracle (same parse, same f32 cast);
        columnar bodies become zero-copy (rows, dim) views concatenated
        without any per-row Python object. Requests that fail their
        negotiated codec land in ``rejects``."""
        reqs = table["request"]
        ids = (list(table["id"]) if "id" in table.column_names
               else [str(i) for i in range(len(reqs))])
        hists = ingress_histograms()
        t_neg = time.perf_counter()
        codecs = [CIN.negotiate(r.get("headers")) for r in reqs]
        hists["negotiate"].observe(
            (time.perf_counter() - t_neg) * 1e3)
        segs: List[np.ndarray] = []
        spans: List[tuple] = []
        rejects: Dict[str, str] = {}
        counts: Dict[str, int] = {}
        pos = 0
        ref_dim = _state["dim"]
        for rid, r, codec in zip(ids, reqs, codecs):
            t0 = time.perf_counter()
            try:
                if codec == "json":
                    row = json.loads(r["entity"].decode())
                    feat = np.asarray(row[field], dtype=np.float32)
                    if feat.ndim != 1:
                        raise CIN.CodecError(
                            f"{field!r} must be a flat number list")
                    seg = feat[None, :]
                else:
                    batch = CIN.decode_columnar(codec, r["entity"])
                    col = batch.columns.get(field)
                    if col is None:
                        raise CIN.CodecError(
                            f"missing column {field!r}")
                    col = np.asarray(col)
                    if col.ndim != 2:
                        raise CIN.CodecError(
                            f"{field!r} must be (rows, dim); "
                            f"got shape {col.shape}")
                    seg = np.asarray(col, dtype=np.float32)
                d = seg.shape[1]
                if ref_dim is None:
                    ref_dim = d       # within-batch reference
                elif d != ref_dim:
                    raise CIN.CodecError(
                        f"feature dim {d} != expected {ref_dim}")
            except Exception as e:  # noqa: BLE001 — reject THIS request
                rejects[rid] = f"{type(e).__name__}: {e}"
                continue
            ingress_decode_histogram(codec).observe(
                (time.perf_counter() - t0) * 1e3)
            if seg.shape[0]:
                segs.append(seg)
            spans.append((pos, pos + seg.shape[0], codec))
            pos += seg.shape[0]
            counts[codec] = counts.get(codec, 0) + 1
        t_asm = time.perf_counter()
        if not segs:
            feats = np.zeros((0, ref_dim or 0), dtype=np.float32)
        elif len(segs) == 1:
            feats = segs[0]   # zero-copy: the request-body view itself
        else:
            feats = np.concatenate(segs, axis=0)
        hists["assemble"].observe(
            (time.perf_counter() - t_asm) * 1e3)
        return CIN.PreparedBatch(feats, rejects, spans, counts)

    def execute(table: DataTable, prepped) -> DataTable:
        if isinstance(prepped, np.ndarray):
            # embedders handing a raw feature matrix
            prepped = CIN.PreparedBatch(
                prepped, spans=[(i, i + 1, "json")
                                for i in range(prepped.shape[0])])
        feats = prepped.payload
        if feats.shape[0] == 0:
            # every surviving request carried zero rows
            return table.with_column(
                "reply", [{reply_field: []} for _ in prepped.spans])
        scored = model.transform(DataTable({field: feats}))
        # drift counts SERVED batches, observed exactly once AFTER a
        # successful score (a failed batch re-runs through the per-row
        # retry, which calls transform -> execute again)
        if drift_monitor is not None:
            drift_monitor.observe(feats)
        # reply values: a TPUModel emits a score matrix (reply the
        # argmax class); a fitted estimator model (GBDT) already emits
        # one prediction per row
        try:
            out_col = model.get("outputCol")
        except Exception:  # noqa: BLE001 — not a TPUModel-style stage
            out_col = None
        if out_col is not None and out_col in scored.column_names:
            preds = np.asarray(scored[out_col]).argmax(-1)
        else:
            get_pcol = getattr(model, "get_prediction_col", None)
            pcol = get_pcol() if callable(get_pcol) else "prediction"
            preds = np.asarray(scored[pcol])
        _state["dim"] = feats.shape[1]

        def scalar(v):
            f = float(v)
            return int(f) if f.is_integer() else f

        replies = []
        for s, e, codec in prepped.spans:
            if codec == "json":
                replies.append({reply_field: scalar(preds[s])})
            else:
                # columnar requests reply one value PER ROW they carried
                replies.append(
                    {reply_field: [scalar(p) for p in preds[s:e]]})
        return table.with_column("reply", replies)

    def handle(table: DataTable) -> DataTable:
        prepped = decode(table)
        if prepped.rejects:
            # single-stage callers (per-row retry, embedders) have no
            # reject channel: surface the codec error as the row error
            raise CIN.CodecError("; ".join(prepped.rejects.values()))
        return execute(table, prepped)

    lam = Lambda.apply(handle)
    lam.prepare_batch = decode
    lam.execute_prepared = execute
    lam.model = model
    # pad/device hists + jit_cache_misses — TPUModel has the hook;
    # other Model types serve fine without it
    stage_metrics = getattr(model, "metrics", None)
    if callable(stage_metrics) or drift_monitor is not None:
        def metrics_hook():
            out = dict(stage_metrics()) if callable(stage_metrics) else {}
            if drift_monitor is not None:
                out["drift"] = drift_monitor.summary()
            return out
        lam.metrics = metrics_hook
    model_warmup = getattr(model, "warmup", None)
    if callable(model_warmup):
        lam.warmup = model_warmup
    model_hists = getattr(model, "histograms", None)
    if callable(model_hists):
        lam.histograms = model_hists
    if hasattr(model, "jit_cache_misses"):
        lam.jit_cache_miss_count = lambda: model.jit_cache_misses
    model_bucket = getattr(model, "bucket_for", None)
    if callable(model_bucket):
        lam.bucket_for = model_bucket
    if drift_monitor is not None:
        lam.drift_monitor = drift_monitor
    # the precision/aot labels ride the stage into the PipelineHandle
    lam.precision = stage_precision(model)
    lam.aot = bool(getattr(model, "aot", False))
    return lam


def json_row_scoring_pipeline(pipeline, reply_col: str = "prediction"):
    """Serve an arbitrary TABULAR pipeline behind HTTP: each request
    body is a JSON object of column values (one row); bodies batch into
    a DataTable, run through ``pipeline.transform``, and the
    ``reply_col`` value answers each request. This is what
    ``python -m mmlspark_tpu_torch.cli serve`` wraps saved models with
    (ref: ServingImplicits.scala request parsing)."""
    from mmlspark_tpu_torch.stages.basic import Lambda

    def handle(table: DataTable) -> DataTable:
        rows = [json.loads(r["entity"].decode())
                for r in table["request"]]
        data = DataTable.from_rows(rows)
        scored = pipeline.transform(data)
        if reply_col not in scored:
            raise KeyError(
                f"reply column {reply_col!r} not in scored table; "
                f"have {scored.column_names}")
        vals = scored[reply_col]
        return table.with_column(
            "reply", [v.item() if isinstance(v, np.generic) else v
                      for v in vals])

    return Lambda.apply(handle)
