"""Multi-host serving: the standard scorers, the fleet client and
partition consolidation — the port's copy of
``mmlspark_tpu/serving/fleet.py``.

``json_scoring_pipeline`` wraps one fitted model (a ``TPUModel``, or a
GBDT / other estimator model that emits one prediction per row) and
``json_row_scoring_pipeline`` any tabular pipeline; both return a stage
that ``serve_model`` serves. ``json_scoring_pipeline`` over a fitted
``PipelineModel`` (or a ``FusedPipelineModel``) serves raw JSON rows
through the fused plan (``_FusedPipelineScorer``): the batcher thread
runs the host prefix, the Feeds and the upload of the padded batch on a
side stream; a worker runs the fused segment and makes exactly one
device-to-host copy per batch.

``ServingFleet`` runs N engines over one pipeline (N ports of one host
here; one engine per host in a deployment) behind the reference's
client: a keep-alive connection pool per thread, a ``CircuitBreaker``
per engine, failover of idempotent requests, hedging after a latency
percentile, one client trace per logical post with a sibling span per
leg, and ``rolling_swap`` through the lifecycle protocol
(``serving/lifecycle.py``). ``ServingFleet.connect(addresses)`` is the
same client over engines in other processes. ``PartitionConsolidator``
keeps each process's own contiguous row range of a table.

What still raises ``NotImplementedError``, naming its ROADMAP.md item
'The rest of the serving plane': ``post_columns`` and the shm transport
('The control plane and host transports'), and the autoscaler's
membership surface ``add_engine`` / ``remove_engine`` /
``demand_rate`` / ``attach_placement`` ('The multi-model plane').
"""

from __future__ import annotations

import http.client
import io
import itertools
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from collections import deque
from concurrent.futures import (
    FIRST_COMPLETED, Future, TimeoutError as _FutureTimeout,
    wait as _futures_wait,
)
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.core.params import IntParam
from mmlspark_tpu_torch.core.schema import Schema
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.serving.server import (
    _MULTI_MODEL, HTTPSource, ServingEngine, _not_ported,
)
from mmlspark_tpu_torch.utils.resilience import CircuitBreaker

log = get_logger("serving.fleet")

_HOST_TRANSPORTS = "The control plane and host transports"


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
    ``bucket_for`` and first-run shape counter.

    ``model`` may also be a fitted **PipelineModel** (or a
    ``FusedPipelineModel``): request bodies are then RAW ROW objects
    ``{col: value, ...}`` — strings and token lists included — scored
    end to end through the fused plan (``_FusedPipelineScorer``); the
    reply is ``reply_col`` (default: the last stage's prediction
    column). ``drift_monitor`` is refused there: the fused plan never
    materializes the feature matrix."""
    from mmlspark_tpu_torch.core.metrics import (
        ingress_decode_histogram, ingress_histograms,
    )
    from mmlspark_tpu_torch.core.fusion import FusedPipelineModel
    from mmlspark_tpu_torch.core.quantize import stage_precision
    from mmlspark_tpu_torch.core.stage import PipelineModel
    from mmlspark_tpu_torch.io import columnar as CIN
    from mmlspark_tpu_torch.stages.basic import Lambda

    if isinstance(model, (PipelineModel, FusedPipelineModel)):
        if drift_monitor is not None:
            # losing drift detection silently on the pipeline path
            # would be worse than refusing: the fused plan fetches only
            # the reply column, so there is no assembled feature matrix
            # to observe. Attach monitoring to a pipeline stage instead.
            raise ValueError(
                "drift_monitor is not supported for pipeline scoring "
                "(the fused plan never materializes the feature "
                "matrix); observe drift inside the pipeline instead")
        return _FusedPipelineScorer(
            model, reply_field=reply_field, reply_col=reply_col,
            batch_size=batch_size).stage()

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
            # a sequence model's row predicts one class per position:
            # its reply is the list (the reference's scorer fails there)
            if np.ndim(v):
                return [scalar(x) for x in v]
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


class _FusedPipelineScorer:
    """Serve a fitted pipeline end to end through its fused plan (the
    pipeline branch of ``json_scoring_pipeline``).

    Request bodies are raw row objects; the engine's two-stage split
    maps onto the plan: ``prepare`` (the batcher thread) decodes JSON,
    runs the plan's host-stage prefix and the first fused segment's
    Feed kernels (string codes / token hashing), edge-pads every input
    up to the pow-2 shape bucket into reused staging buffers and, on the
    card, uploads them on a side stream; ``execute`` (a worker) waits
    for that upload, runs the fused segment and makes exactly ONE
    device-to-host copy of the reply column. The plan is pruned to the
    reply column (``final_needed``), so nothing else is fetched.

    Serving contracts forwarded to the engine: ``warmup`` runs every
    bucket through the serving path, ``jit_cache_miss_count`` is the
    first-run guard, ``bucket_for`` labels batches, and ``metrics``
    exposes the fusion plan + DeviceTable stats on /healthz. The
    pipeline is served where the ``FusedPipelineModel`` runs (a
    ``PipelineModel`` is fused on the card)."""

    # staging buffers per input: the engine's in-flight gate keeps at
    # most workers + pipeline depth batches past the batcher, below this
    _STAGING_SLOTS = 8

    def __init__(self, pipeline, reply_field: str = "prediction",
                 reply_col: str = None, batch_size: int = 256):
        from mmlspark_tpu_torch.core.fusion import (
            FusedPipelineModel, HostStaging,
        )
        self.fused = pipeline if isinstance(pipeline, FusedPipelineModel) \
            else pipeline.fused(batch_size=batch_size)
        self.device = self.fused.device
        self.reply_field = reply_field
        self.reply_col = reply_col or self._default_reply_col()
        self._row_names: List[str] = []
        self._names_lock = threading.Lock()
        on_card = self.device.type == "cuda"
        self._staging = HostStaging(self._STAGING_SLOTS, pinned=on_card)
        self._side = torch.cuda.Stream(self.device) if on_card else None
        # per-column trailing shapes CONFIRMED by the last successful
        # batch — the schema-mismatch guard's trusted reference
        self._confirmed_shapes: Dict[str, tuple] = {}
        # D2H copies per scored batch (the "at most one device round
        # trip" guarantee): bumped once per copy
        self.device_roundtrips = 0
        self.batches_scored = 0

    def _default_reply_col(self) -> str:
        for stage in reversed(self.fused.get_stages()):
            get_pred = getattr(stage, "get_prediction_col", None)
            if callable(get_pred):
                return get_pred()
        return "prediction"

    # -- decode --------------------------------------------------------------

    def _decode_requests(self, table: DataTable):
        """Per-request negotiate + decode: JSON bodies parse to row
        dicts (the oracle), columnar bodies decode to zero-copy
        ``ColumnarBatch`` views. Returns ``(decoded, spans, rejects,
        codec_counts, shapes)`` where ``decoded``/``spans`` cover only
        the SURVIVING requests (rejects keyed by request id)."""
        from mmlspark_tpu_torch.core.metrics import (
            ingress_decode_histogram, ingress_histograms,
        )
        from mmlspark_tpu_torch.io import columnar as CIN
        reqs = table["request"]
        ids = (list(table["id"]) if "id" in table.column_names
               else [str(i) for i in range(len(reqs))])
        t_neg = time.perf_counter()
        codecs = [CIN.negotiate(r.get("headers")) for r in reqs]
        ingress_histograms()["negotiate"].observe(
            (time.perf_counter() - t_neg) * 1e3)
        decoded: List[Any] = []
        spans: List[tuple] = []
        rejects: Dict[str, str] = {}
        counts: Dict[str, int] = {}
        ref_shapes: Dict[str, tuple] = dict(self._confirmed_shapes)
        pos = 0
        for rid, r, codec in zip(ids, reqs, codecs):
            t0 = time.perf_counter()
            try:
                if codec == "json":
                    item = json.loads(r["entity"].decode())
                    if not isinstance(item, dict):
                        raise CIN.CodecError(
                            "JSON request body must be a row object")
                    n = 1
                else:
                    item = CIN.decode_columnar(codec, r["entity"])
                    n = item.n_rows
                    # schema-mismatch isolation: a request whose column
                    # widths disagree with its batch-mates 400s alone
                    for name, col in item.columns.items():
                        if not isinstance(col, np.ndarray):
                            continue
                        ref = ref_shapes.get(name)
                        if ref is None:
                            ref_shapes[name] = col.shape[1:]
                        elif col.shape[1:] != ref:
                            raise CIN.CodecError(
                                f"column {name!r} shape {col.shape[1:]}"
                                f" != batch shape {ref}")
            except Exception as e:  # noqa: BLE001 — reject THIS request
                rejects[rid] = f"{type(e).__name__}: {e}"
                continue
            ingress_decode_histogram(codec).observe(
                (time.perf_counter() - t0) * 1e3)
            decoded.append(item)
            spans.append((pos, pos + n, codec))
            pos += n
            counts[codec] = counts.get(codec, 0) + 1
        return decoded, spans, rejects, counts, ref_shapes

    def _assemble(self, decoded: List[Any], total_rows: int) -> DataTable:
        """One batch table from per-request decoded items. Column ORDER
        is pinned, growing: first-seen order keeps the schema signature
        — and so the plan — from churning with clients' key ordering,
        while a key the first batch omitted is APPENDED when it first
        appears (one replan, never a silently dropped field)."""
        from mmlspark_tpu_torch.io import columnar as CIN
        with self._names_lock:
            known = set(self._row_names)
            for item in decoded:
                keys = (item.columns if isinstance(item, CIN.ColumnarBatch)
                        else item)
                for k in keys:
                    if k not in known:
                        self._row_names.append(k)
                        known.add(k)
            names = list(self._row_names)
        return DataTable({n: CIN.assemble_column(decoded, n, total_rows)
                          for n in names})

    # -- the two-stage split -------------------------------------------------

    def prepare(self, table: DataTable):
        from mmlspark_tpu_torch.core.fusion import (
            FusedSegment, Upload, load_column_f32, pipeline_histograms,
        )
        from mmlspark_tpu_torch.core.metrics import ingress_histograms
        from mmlspark_tpu_torch.io import columnar as CIN
        t0 = time.perf_counter()
        decoded, spans, rejects, codecs, shapes = \
            self._decode_requests(table)
        total = spans[-1][1] if spans else 0
        if total == 0:
            # nothing decodable (all rejected and/or zero-row batches)
            return CIN.PreparedBatch(("empty",), rejects, spans, codecs)
        t_asm = time.perf_counter()
        raw = self._assemble(decoded, total)
        ingress_histograms()["assemble"].observe(
            (time.perf_counter() - t_asm) * 1e3)
        envelope = CIN.PreparedBatch(None, rejects, spans, codecs,
                                     meta={"shapes": shapes})
        plan = self.fused.plan_for(raw.schema,
                                   final_needed={self.reply_col})
        cur = raw
        seg_idx = None
        for i, step in enumerate(plan.steps):
            if isinstance(step, FusedSegment):
                seg_idx = i
                break
            cur = step.stage.transform(cur)
        if seg_idx is None:
            # no device segment anywhere: cur IS the scored table —
            # execute() must only read the reply out of it
            envelope.payload = ("host", cur, total)
            return envelope
        seg = plan.steps[seg_idx]
        n = len(cur)
        bucket = self.fused.bucket_for(n)
        if seg_idx + 1 < len(plan.steps) and n < bucket:
            # a tail after the segment: pad the TABLE itself (edge rows)
            # so every later segment sees the bucket shape too; the
            # single-segment hot path below pads only the inputs
            idx = np.minimum(np.arange(bucket), n - 1)
            cur = cur._take_indices(idx)
        t_pad = time.perf_counter()
        up = Upload(self.device, self._staging, self._side)
        env: Dict[str, Any] = {}
        for col in seg.external_reads:
            env[col] = up.ship(col, load_column_f32(cur, col), bucket)
        for feed in seg.feeds:
            env[feed.name] = up.ship(feed.name, feed.load(cur), bucket)
        ready = up.finish()
        ingress_histograms()["pad"].observe(
            (time.perf_counter() - t_pad) * 1e3)
        pipeline_histograms()["prepare"].observe(
            (time.perf_counter() - t0) * 1e3)
        envelope.payload = ("fused", plan, cur, n, seg_idx, env, ready)
        return envelope

    def _commit_shapes(self, prepped) -> None:
        """Latch this batch's per-column shapes as the trusted
        mismatch-guard reference — only AFTER a successful score."""
        shapes = prepped.meta.get("shapes")
        if shapes:
            self._confirmed_shapes = shapes

    def execute(self, table: DataTable, prepped) -> DataTable:
        from mmlspark_tpu_torch.core.fusion import (
            FusedSegment, adopt, fetch_outputs, pipeline_histograms,
        )
        spans = prepped.spans
        payload = prepped.payload
        if payload[0] == "empty":
            # every surviving request carried zero rows
            self.batches_scored += 1
            return table.with_column(
                "reply", [{self.reply_field: []} for _ in spans])
        if payload[0] == "host":
            # prepare() already ran every (host) step — re-executing
            # the plan would double-transform non-idempotent stages
            _, cur, n = payload
            self.batches_scored += 1
            self._commit_shapes(prepped)
            return self._reply(table, np.asarray(
                cur[self.reply_col])[:n], spans)
        _, plan, cur, n, seg_idx, env, ready = payload
        prepped.payload = None      # the worker owns the inputs now
        seg = plan.steps[seg_idx]
        t0 = time.perf_counter()
        adopt(env, ready, self.device)
        consts = seg.consts_list(plan.device_table)
        out = seg.run(consts, env)
        del env
        tail = plan.steps[seg_idx + 1:]
        if not tail and self.reply_col in out:
            # the hot path: ONE device round trip — the reply column
            vals = fetch_outputs({self.reply_col: out[self.reply_col]})[
                self.reply_col][:n]
            self.device_roundtrips += 1
            self.batches_scored += 1
            pipeline_histograms()["device"].observe(
                (time.perf_counter() - t0) * 1e3)
            self._commit_shapes(prepped)
            return self._reply(table, vals, spans)
        # general tail (more segments / trailing host stages): fold the
        # segment's live outputs back at FULL bucket length (prepare()
        # padded `cur` for this case), so later segments keep seeing
        # padded shapes; one round trip per segment. The pad rows slice
        # off at the reply, exactly once.
        cur = seg.attach(cur, fetch_outputs(out), len(cur))
        self.device_roundtrips += 1
        for step in tail:
            if isinstance(step, FusedSegment):
                cur = plan._run_segment(cur, step)
                self.device_roundtrips += 1
            else:
                cur = step.stage.transform(cur)
        self.batches_scored += 1
        pipeline_histograms()["device"].observe(
            (time.perf_counter() - t0) * 1e3)
        self._commit_shapes(prepped)
        return self._reply(table, np.asarray(cur[self.reply_col])[:n],
                           spans)

    def _reply(self, table: DataTable, vals, spans) -> DataTable:
        def jsonify(v):
            if np.ndim(v) >= 1:
                # vector reply columns (probability / rawPrediction)
                return [float(x) for x in np.asarray(v).ravel()]
            v = float(v)
            return int(v) if v.is_integer() else v

        out = []
        for s, e, codec in spans:
            if codec == "json":
                # the oracle shape: one scalar reply per request row
                out.append({self.reply_field: jsonify(vals[s])})
            else:
                # columnar requests reply one value PER ROW they carried
                out.append({self.reply_field:
                            [jsonify(v) for v in vals[s:e]]})
        return table.with_column("reply", out)

    def transform(self, table: DataTable) -> DataTable:
        """Single-stage fallback (per-row poison retry, embeddings)."""
        from mmlspark_tpu_torch.io import columnar as CIN
        prepped = self.prepare(table)
        if prepped.rejects:
            # single-stage callers have no reject channel: surface the
            # codec error as the row error
            raise CIN.CodecError("; ".join(prepped.rejects.values()))
        return self.execute(table, prepped)

    # -- serving hooks -------------------------------------------------------

    def warmup(self, example, sizes: Optional[List[int]] = None) -> int:
        """Run every bucket through the EXACT serving path (prepare /
        execute with bucket padding), so live traffic meets no first-run
        shape. Each bucket's wall lands in the ``model_warmup_ms``
        histogram; returns the first-time shapes met."""
        from mmlspark_tpu_torch.core.warmup import (
            warmup_buckets, warn_warmup_example,
        )
        from mmlspark_tpu_torch.io.http import _jsonable
        table = example if isinstance(example, DataTable) \
            else DataTable(dict(example))
        if len(table) == 0:
            raise ValueError("warmup needs at least one example row")
        with self._names_lock:
            live = list(self._row_names)
        warn_warmup_example(table, live_columns=live or None)
        body = [json.dumps({k: _jsonable(v) for k, v in row.items()}
                           ).encode() for row in table.rows()]

        def run_bucket(b: int) -> None:
            reqs = [{"entity": body[i % len(body)]} for i in range(b)]
            req_table = DataTable({"id": [str(i) for i in range(b)],
                                   "request": reqs})
            self.execute(req_table, self.prepare(req_table))

        return warmup_buckets(run_bucket,
                              sizes or self.fused.bucket_sizes(),
                              lambda: self.fused.jit_cache_misses)

    def jit_cache_miss_count(self) -> int:
        return self.fused.jit_cache_misses

    def bucket_for(self, rows: int) -> int:
        return self.fused.bucket_for(rows)

    def metrics(self) -> Dict[str, Any]:
        return self.fused.metrics()

    def stage(self):
        """Package as the Lambda stage the ServingEngine consumes, with
        the duck-typed two-stage split + lifecycle/observability hooks
        attached (the same contract the TPUModel path exposes)."""
        from mmlspark_tpu_torch.stages.basic import Lambda
        lam = Lambda.apply(self.transform)
        lam.prepare_batch = self.prepare
        lam.execute_prepared = self.execute
        lam.warmup = self.warmup
        lam.metrics = self.metrics
        lam.jit_cache_miss_count = self.jit_cache_miss_count
        lam.bucket_for = self.bucket_for
        lam.resident_bytes = self.fused.resident_bytes
        lam.precision = self.fused.precision
        lam.aot = bool(self.fused.aot)
        lam.scorer = self
        return lam

# engine-reported statuses worth failing over for: overload/shedding
# (503 + Retry-After), serving timeout (504), and gateway-ish 502.
# Anything else 4xx/5xx is the REQUEST's problem (poison row -> 500) and
# must surface to the caller unchanged — retrying it on another replica
# would just poison that one too. 429 is deliberately NOT here: the
# admission layer's tenant quotas (serving/admission.py) are fleet-wide,
# so replaying an over-quota request on the next replica would only
# spend the tenant's tokens everywhere — the 429 surfaces to the caller.
_FAILOVER_CODES = frozenset({502, 503, 504})


class ServingFleet:
    """N serving engines over one pipeline — one per host in a real
    deployment, N ports on one host in simulation/tests. Replies always
    flow through the engine that accepted the request (the reference's
    reply-routing invariant, DistributedHTTPSource.scala:188-192).

    The client side (``post``) is a resilient stand-in for an external
    load balancer: round-robin with a per-engine ``CircuitBreaker`` (a
    dead or shedding engine stops receiving traffic after
    ``failure_threshold`` failures until ``breaker_cooldown`` elapses),
    failover of idempotent scoring requests onto the next replica, and
    optional request hedging (Dean & Barroso, *The Tail at Scale*): when
    ``hedge_percentile`` is set, a request still unanswered after that
    latency percentile fires a duplicate on another replica and the first
    reply wins.

    ``base_port=0`` binds every engine on a free port of the OS's
    choosing (``addresses`` carries them). ``zoo=`` / ``admission=``
    raise in the engine, and ``shm_transport=True`` here, naming their
    ROADMAP.md items."""

    def __init__(self, pipeline=None, n_engines: int = 2,
                 host: str = "127.0.0.1", base_port: int = 18700,
                 batch_size: int = 64, reply_col: str = "reply",
                 workers: int = 1,
                 failure_threshold: int = 3,
                 breaker_cooldown: float = 2.0,
                 hedge_percentile: Optional[float] = None,
                 hedge_min_s: float = 0.02,
                 max_parked: Optional[int] = None,
                 max_wait_ms: float = 5.0,
                 pipeline_depth: int = 2,
                 version: str = "v0", tracer=None,
                 tracing: Optional[bool] = None,
                 zoo=None, admission=None,
                 slo=None, flight_recorder=None,
                 shm_transport: bool = False):
        if shm_transport:
            raise _not_ported("the shared-memory transport "
                              "(shm_transport=True)", _HOST_TRANSPORTS)
        self._init_client(tracer=tracer, tracing=tracing,
                          hedge_percentile=hedge_percentile,
                          hedge_min_s=hedge_min_s)
        port = base_port
        try:
            for _ in range(n_engines):
                source = HTTPSource(host=host, port=port,
                                    max_parked=max_parked)
                if port:                    # 0 = the OS picks each port
                    port = source.port + 1  # skip whatever port-scan used
                try:
                    engine = ServingEngine(
                        source, pipeline, reply_col=reply_col,
                        batch_size=batch_size, workers=workers,
                        max_wait_ms=max_wait_ms,
                        pipeline_depth=pipeline_depth,
                        version=version, tracer=self.tracer,
                        tracing=self.tracer is not None,
                        zoo=zoo, admission=admission,
                        slo=slo, flight_recorder=flight_recorder).start()
                except Exception:
                    source.close()   # don't orphan the bound port
                    raise
                self.engines.append(engine)
        except Exception:
            # partial construction must not leak threads/bound ports
            self.stop_all()
            raise
        self._build_breakers(failure_threshold, breaker_cooldown)
        log.info("fleet of %d engines: %s", n_engines, self.addresses)

    def _init_client(self, tracer=None, tracing: Optional[bool] = None,
                     hedge_percentile: Optional[float] = None,
                     hedge_min_s: float = 0.02) -> None:
        """Client-side state shared by the in-process fleet and the
        remote-address client (``connect``)."""
        from mmlspark_tpu_torch.core import trace as trace_mod
        # ONE tracer across the fleet: every engine's completed traces
        # land in the same tail-sampled buffer, so fleet.traces() is
        # the whole fleet's story (default: the process-wide tracer)
        if tracing is None:
            from mmlspark_tpu_torch.core import config as _config
            tracing = bool(_config.get("trace.enabled", True))
        self.tracer = (tracer if tracer is not None
                       else trace_mod.get_tracer()) if tracing else None
        if self.tracer is not None and not self.tracer.enabled:
            self.tracer = None
        self.engines: List[ServingEngine] = []
        self._remote_addresses: Optional[List[str]] = None
        self.transport_errors = 0
        self.hedged_requests = 0
        self._stats_lock = threading.Lock()
        self.hedge_percentile = hedge_percentile
        self.hedge_min_s = hedge_min_s
        self._latencies: "deque[float]" = deque(maxlen=256)
        self._probe_lock = threading.Lock()   # single-flight all-open probe
        # itertools.count: next() is atomic under the GIL, so
        # concurrent client threads can't tear the round-robin
        self._next = itertools.count()
        self.breakers: List[CircuitBreaker] = []

    def _build_breakers(self, failure_threshold: int,
                        breaker_cooldown: float) -> None:
        self.breakers = [
            CircuitBreaker(failure_threshold=failure_threshold,
                           cooldown=breaker_cooldown,
                           name=f"engine{i}@{addr}")
            for i, addr in enumerate(self.addresses)]
        # an opening circuit is exactly the moment evidence matters:
        # auto-capture a flight-recorder bundle (rate-limited) on the
        # closed->open transition of any engine's breaker. on_open is
        # a single slot, so ONE recorder gets the hook — the fleet's
        # engines share one (the constructor arg or the process-wide
        # default), so take the first engine's.
        rec = next((e.flight_recorder for e in self.engines
                    if getattr(e, "flight_recorder", None) is not None),
                   None)
        if rec is not None:
            for breaker in self.breakers:
                breaker.on_open = (
                    lambda b, _rec=rec: _rec.trigger(
                        f"circuit_open:{b.name}"))

    @classmethod
    def connect(cls, addresses: List[str],
                failure_threshold: int = 3,
                breaker_cooldown: float = 2.0,
                hedge_percentile: Optional[float] = None,
                hedge_min_s: float = 0.02,
                tracer=None,
                tracing: Optional[bool] = None,
                wait_ready_s: float = 0.0,
                ready_poll_timeout_s: float = 1.0,
                shm_transport: bool = False) -> "ServingFleet":
        """A CLIENT-ONLY fleet over engines that live in OTHER
        processes (or hosts): the same round-robin + circuit-breaking
        + failover + hedging client, pointed at explicit addresses
        instead of in-process engines. This is the multi-process
        deployment shape (one OS process per engine — the ROADMAP
        sharded-serving direction): each leg injects the traceparent
        context, so a request that retries/hedges across processes
        still reassembles into ONE trace from the engines' exported
        buffers (``core.trace.merge_chrome_traces``).

        ``wait_ready_s`` > 0 runs a STARTUP probe: poll each address's
        ``/healthz`` with backoff until it answers or the budget runs
        out. Engine processes spawn slowly (a replica pays its Python/
        torch import before it listens), and without the probe the first
        real requests against a not-yet-listening worker burn the
        breaker's whole failure budget — the fleet opens the circuit
        of an engine that was never down, then serves degraded until
        the cooldown. Probe failures touch NO breaker (breakers are
        built after the wait); addresses still unreachable when the
        budget ends just log — the normal breaker/failover path owns
        them from there.

        Engine-management surfaces (``rolling_swap``, ``metrics``,
        ``kill_engine``) are inert on a connected client — scrape the
        remote engines' own ``/metrics``/``/healthz`` instead."""
        if shm_transport:
            raise _not_ported("the shared-memory transport "
                              "(shm_transport=True)", _HOST_TRANSPORTS)
        fleet = cls.__new__(cls)
        fleet._init_client(tracer=tracer, tracing=tracing,
                           hedge_percentile=hedge_percentile,
                           hedge_min_s=hedge_min_s)
        fleet._remote_addresses = [str(a).rstrip("/") for a in addresses]
        if not fleet._remote_addresses:
            raise ValueError("connect() needs at least one address")
        if wait_ready_s > 0:
            fleet._wait_ready(wait_ready_s, ready_poll_timeout_s)
        fleet._build_breakers(failure_threshold, breaker_cooldown)
        log.info("fleet client connected to %d remote engines: %s",
                 len(fleet._remote_addresses), fleet.addresses)
        return fleet

    def _wait_ready(self, budget_s: float,
                    probe_timeout_s: float = 1.0,
                    addresses: Optional[List[str]] = None) -> List[str]:
        """Bounded startup probe: poll every address's /healthz under
        ONE shared deadline with jittered backoff (utils/resilience
        discipline) until each answers anything at all — an HTTP
        status means the process is listening, which is all the probe
        establishes. Returns the addresses that never came up (logged;
        callers' breakers take over)."""
        from mmlspark_tpu_torch.utils.resilience import Deadline, RetryPolicy
        deadline = Deadline.after(float(budget_s))
        policy = RetryPolicy(max_attempts=1_000_000, base_delay=0.05,
                             multiplier=1.5, max_delay=0.5,
                             name="fleet.wait_ready")
        pending = list(addresses if addresses is not None
                       else self._remote_addresses)
        not_ready: List[str] = []
        for addr in pending:

            def probe(_addr=addr):
                timeout = max(0.05,
                              deadline.clamp(float(probe_timeout_s)))
                try:
                    with urllib.request.urlopen(f"{_addr}/healthz",
                                                timeout=timeout):
                        pass
                except urllib.error.HTTPError:
                    pass   # an HTTP status = listening; ready enough

            try:
                if deadline.expired:
                    # budget spent on earlier addresses: one immediate
                    # probe each, no backoff — a worker that came up
                    # meanwhile must not be written off unprobed
                    probe()
                else:
                    policy.call(probe, deadline=deadline)
            except Exception:  # noqa: BLE001 — budget spent / refused
                not_ready.append(addr)
        if not_ready:
            log.warning(
                "fleet.connect: %d/%d engines not listening after "
                "%.1fs startup probe (%s); their breakers will own "
                "them from here", len(not_ready), len(pending),
                budget_s, ", ".join(not_ready))
        return not_ready

    @property
    def addresses(self) -> List[str]:
        if self._remote_addresses is not None:
            return list(self._remote_addresses)
        return [e.source.address for e in self.engines]

    # -- transport ---------------------------------------------------------

    # keep-alive connection pool: one persistent HTTPConnection per
    # (thread, engine address). thread-local => no locking, and a
    # connection is never shared across concurrent requests
    _conn_pool = threading.local()

    @classmethod
    def _pooled_conn(cls, addr: str,
                     timeout: float) -> "http.client.HTTPConnection":
        conns = getattr(cls._conn_pool, "conns", None)
        if conns is None:
            conns = cls._conn_pool.conns = {}
        conn = conns.get(addr)
        if conn is None:
            u = urllib.parse.urlsplit(addr)
            conn = http.client.HTTPConnection(u.hostname, u.port,
                                              timeout=timeout)
            conns[addr] = conn
        conn.timeout = timeout
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        return conn

    @classmethod
    def _drop_conn(cls, addr: str) -> None:
        conns = getattr(cls._conn_pool, "conns", {})
        conn = conns.pop(addr, None)
        if conn is not None:
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass

    @classmethod
    def _http_post(cls, addr: str, body: bytes, timeout: float,
                   replayable: bool = True, pooled: bool = True,
                   content_type: str = "application/json",
                   extra_headers: Optional[Dict[str, str]] = None,
                   ) -> Dict[str, Any]:
        """POST over a pooled keep-alive connection (HTTP/1.1): the
        serving hot path pays no TCP handshake and spawns no server
        thread per request. App-level statuses surface as
        ``urllib.error.HTTPError`` (the breaker/failover contract).

        A pooled connection the server closed while idle fails either
        on the SEND or — when the buffered write slips through before
        the RST — as RemoteDisconnected on the response; both retry
        once on a fresh connection, else a whole healthy fleet looks
        down after an idle gap (every thread-local conn went stale at
        once). The response-phase retry could re-execute a request the
        engine processed but never answered, so it is gated on
        ``replayable`` (post's ``idempotent`` flag). ``pooled=False``
        uses a one-shot connection closed before return — for spawned
        hedge threads, whose thread-local pool would otherwise leak
        one connection per call. Other failures propagate — the
        caller's failover policy decides."""
        import time as _time
        t0 = _time.perf_counter()
        headers = {"Content-Type": content_type, **(extra_headers or {})}
        for attempt in (0, 1):
            if pooled:
                conn = cls._pooled_conn(addr, timeout)
            else:
                u = urllib.parse.urlsplit(addr)
                conn = http.client.HTTPConnection(u.hostname, u.port,
                                                  timeout=timeout)
                headers = dict(headers, Connection="close")

            def _discard():
                if pooled:
                    cls._drop_conn(addr)
                else:
                    try:
                        conn.close()
                    except Exception:  # noqa: BLE001
                        pass

            fresh = conn.sock is None
            try:
                conn.request("POST", "/", body, headers)
            except Exception:
                _discard()
                if fresh or attempt:
                    raise
                continue   # stale keep-alive socket: one fresh retry
            try:
                resp = conn.getresponse()
                data = resp.read()
                if not pooled or resp.will_close:
                    _discard()
            except (http.client.RemoteDisconnected,
                    http.client.BadStatusLine):
                _discard()
                if fresh or attempt or not replayable:
                    raise
                continue   # idle-closed socket ate the send: retry
            except Exception:
                _discard()
                raise
            if resp.status >= 400:
                if (resp.status == 503 and resp.will_close
                        and not fresh and not attempt):
                    # a closed source draining its old persistent
                    # connections (shed + Connection: close): nothing
                    # was processed — reconnect once; a fresh connect
                    # reaches whatever now owns the port
                    continue
                raise urllib.error.HTTPError(
                    addr, resp.status, resp.reason,
                    dict(resp.getheaders()), io.BytesIO(data))
            return {"body": json.loads(data),
                    "latency": _time.perf_counter() - t0}
        raise RuntimeError("unreachable")   # loop always returns/raises

    @staticmethod
    def _submit(fn, *args) -> "Future":
        """Run ``fn`` on a fresh DAEMON thread, returning a Future.
        Deliberately not a ThreadPoolExecutor: its non-daemon workers
        are joined by the atexit hook, so an abandoned hedge leg stuck
        against a stalled engine would block interpreter exit for its
        whole transport timeout; daemon threads also can't starve each
        other the way a fixed-size pool full of zombie legs can."""
        fut: "Future" = Future()

        def run():
            if not fut.set_running_or_notify_cancel():
                return
            try:
                fut.set_result(fn(*args))
            except BaseException as e:  # noqa: BLE001 — future protocol
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True,
                         name="fleet-hedge").start()
        return fut

    def _hedge_threshold(self) -> Optional[float]:
        if self.hedge_percentile is None:
            return None
        with self._stats_lock:
            if len(self._latencies) < 16:
                return None
            lat = sorted(self._latencies)
        idx = min(len(lat) - 1,
                  int(self.hedge_percentile / 100.0 * len(lat)))
        return max(self.hedge_min_s, lat[idx])

    def _record_latency(self, dt: float) -> None:
        with self._stats_lock:
            self._latencies.append(dt)

    def _classify_and_record(self, breaker: CircuitBreaker,
                             err: Optional[BaseException]) -> None:
        """Breaker bookkeeping for one transport outcome: success, or an
        app-level HTTP status (engine alive and answering — e.g. a
        poison row's 500), counts as healthy; failover statuses and
        transport failures count against the engine."""
        if err is None or (isinstance(err, urllib.error.HTTPError)
                           and err.code not in _FAILOVER_CODES):
            breaker.record_success()
        else:
            breaker.record_failure()

    # -- client-side tracing -------------------------------------------------

    def _client_trace(self, name: str):
        """One trace per logical client call. Inside an active span
        (``core.trace.use_span``) the new root CONTINUES that trace as
        a child, so an embedder's own spans, the client legs, and the
        remote engines' server spans all share one trace id."""
        if self.tracer is None:
            return None
        from mmlspark_tpu_torch.core.trace import current_span
        cur = current_span()
        return self.tracer.new_trace(
            name,
            trace_id=cur.trace_id if cur is not None else None,
            parent_id=cur.span_id if cur is not None else None)

    def _leg_span(self, trace, i: int, hedge: bool = False,
                  probe: bool = False):
        """One client leg span + the propagation headers it must carry.
        Every leg of one logical post — retries, failovers, hedges —
        is a SIBLING under the same root, so the fan-out renders as one
        trace; the remote engine parents its server span on the leg's
        span id (Tracer.inject/extract)."""
        if trace is None:
            return None, None
        span = self.tracer.start_span("client.post", trace,
                                      parent=trace.root)
        span.set("engine", i)
        span.set("address", self.addresses[i])
        if hedge:
            span.set("hedge", True)
        if probe:
            span.set("probe", True)
        return span, self.tracer.inject(span)

    @staticmethod
    def _merged_headers(extra_headers: Optional[Dict[str, str]],
                        inject: Optional[Dict[str, str]]
                        ) -> Optional[Dict[str, str]]:
        if not inject:
            return extra_headers
        return {**(extra_headers or {}), **inject}

    # serializes leg-span verdicts: a hedge winner cancelling the
    # loser races the loser's own done-callback (they run on different
    # threads); without the lock the same span could be labeled BOTH
    # cancelled and error, or a genuinely failed leg could lose its
    # error to a concurrent cancel. Critical sections are a few
    # attribute stores — one class-wide lock is cheap and sufficient.
    _leg_lock = threading.Lock()

    @staticmethod
    def _mark_root_http(trace, code: int) -> None:
        """The client root's verdict for an app-level HTTP status —
        the server-side shed-vs-error discipline (the shared
        ``core.trace.SHED_STATUSES`` policy): back-pressure statuses
        are shed=true, only real 5xx are errors. A hot tenant's quota
        429s must not flood the client tracer's protected tail ring."""
        if trace is None:
            return
        from mmlspark_tpu_torch.core.trace import SHED_STATUSES
        trace.root.set("http_status", code)
        if code in SHED_STATUSES:
            trace.root.set("shed", True)
        elif code >= 500:
            trace.root.error()

    def _finish_leg(self, span, err: Optional[BaseException]) -> None:
        """Close one leg span for its own outcome — UNLESS the leg was
        already marked cancelled (it lost a hedge race: the winner
        closed it; its late real outcome must not rewrite the
        verdict). Quota/shed HTTP statuses mark the leg shed, not
        error (the root discipline, per leg)."""
        if span is None:
            return
        from mmlspark_tpu_torch.core.trace import SHED_STATUSES
        with self._leg_lock:
            if span.end is not None or span.attrs.get("cancelled"):
                return
            if isinstance(err, urllib.error.HTTPError) and \
                    err.code in SHED_STATUSES:
                span.set("shed", True)
                span.set("http_status", err.code)
            elif err is not None:
                span.error(err)
            span.finish()

    @classmethod
    def _cancel_leg(cls, span) -> None:
        """Mark a hedge loser: ``cancelled=true``, NOT error — the leg
        was abandoned because its sibling answered first, which is the
        hedge working as designed, not a failure (the shed-vs-error
        distinction applied to client spans: 'cancelled' must not
        flood error dashboards or the protected tail ring)."""
        if span is None:
            return
        with cls._leg_lock:
            if span.end is None:
                span.set("cancelled", True)
                span.finish()

    def _attempt(self, i: int, body: bytes, timeout: float, tried: set,
                 allow_hedge: bool,
                 content_type: str = "application/json",
                 extra_headers: Optional[Dict[str, str]] = None,
                 trace=None) -> Dict[str, Any]:
        """One logical attempt against engine ``i``, hedged onto another
        replica if allowed and the reply is slower than the hedge
        threshold. ALL breaker recording happens here — for a hedged
        primary the outcome is recorded when its leg actually finishes
        (a stalled primary must still open its circuit even though the
        hedge rescued the request). Raises the (winning) transport
        error on failure. Each leg carries its own traceparent headers
        (per-leg client spans under ``trace``)."""
        breaker = self.breakers[i]
        addr = self.addresses[i]
        threshold = self._hedge_threshold() if allow_hedge else None
        if threshold is None or threshold >= timeout:
            span, inj = self._leg_span(trace, i)
            try:
                # allow_hedge carries post()'s idempotent flag: only
                # idempotent requests may transparently replay a
                # response-phase stale-connection failure
                result = self._http_post(
                    addr, body, timeout, replayable=allow_hedge,
                    content_type=content_type,
                    extra_headers=self._merged_headers(extra_headers,
                                                       inj))
            except Exception as e:
                self._classify_and_record(breaker, e)
                self._finish_leg(span, e)
                raise
            self._classify_and_record(breaker, None)
            self._finish_leg(span, None)
            return result
        import time as _time
        start = _time.monotonic()
        # hedge legs run on spawned one-shot threads: pooled=False, or
        # each call would strand a keep-alive conn in a dead thread's
        # local storage (hedging only runs for idempotent requests)
        span1, inj1 = self._leg_span(trace, i)
        f1 = self._submit(self._http_post, addr, body, timeout,
                          True, False, content_type,
                          self._merged_headers(extra_headers, inj1))
        f1.add_done_callback(
            lambda f: (self._classify_and_record(breaker, f.exception()),
                       self._finish_leg(span1, f.exception())))
        try:
            return f1.result(timeout=threshold)
        except _FutureTimeout:
            pass                       # slow — fire the hedge
        # allow() (not a bare state check) so a half-open replica's
        # probe budget also gates hedge traffic — a barely-recovered
        # engine must not get a thundering herd of hedges
        j = next((k for k in range(len(self.breakers))
                  if k != i and k not in tried
                  and self.breakers[k].allow()),
                 None)
        if j is None:
            return f1.result(
                timeout=max(0.001, start + timeout - _time.monotonic()))
        with self._stats_lock:
            self.hedged_requests += 1
        tried.add(j)   # the hedge consumed replica j for this request
        span2, inj2 = self._leg_span(trace, j, hedge=True)
        f2 = self._submit(self._http_post, self.addresses[j], body,
                          timeout, True, False, content_type,
                          self._merged_headers(extra_headers, inj2))
        f2.add_done_callback(
            lambda f: (self._classify_and_record(self.breakers[j],
                                                 f.exception()),
                       self._finish_leg(span2, f.exception())))
        pending = {f1, f2}
        first_error: Optional[BaseException] = None
        while pending:
            remaining = start + timeout - _time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"hedged request to {addr} timed out after {timeout}s")
            done, pending = _futures_wait(
                pending, timeout=remaining, return_when=FIRST_COMPLETED)
            if not done:
                raise TimeoutError(
                    f"hedged request to {addr} timed out after {timeout}s")
            for f in done:
                err = f.exception()
                if err is None:
                    # the sibling leg LOSES: mark it cancelled (not
                    # error) — but only while it is genuinely still in
                    # flight. A leg that already COMPLETED (e.g. both
                    # futures landed in one wait round) gets its real
                    # verdict from its own done-callback; cancelling
                    # it would erase a true transport error.
                    loser_f, loser_span = ((f2, span2) if f is f1
                                           else (f1, span1))
                    if not loser_f.done():
                        self._cancel_leg(loser_span)
                    return f.result()
                first_error = first_error or err
        raise first_error  # both legs failed — surface the primary's

    # -- the client --------------------------------------------------------

    @staticmethod
    def _route_headers(model: Optional[str], tenant: Optional[str],
                       priority: Optional[int],
                       headers: Optional[Dict[str, str]]
                       ) -> Optional[Dict[str, str]]:
        """The model-routing/admission headers (the reference's
        serving/zoo.py + serving/admission.py read them) as one merged
        extra-header dict."""
        out = dict(headers or {})
        if model is not None:
            out["X-Model"] = str(model)
        if tenant is not None:
            out["X-Tenant"] = str(tenant)
        if priority is not None:
            out["X-Priority"] = str(int(priority))
        return out or None

    def post(self, payload: Any, timeout: float = 30.0,
             idempotent: bool = True,
             content_type: str = "application/json",
             model: Optional[str] = None,
             tenant: Optional[str] = None,
             priority: Optional[int] = None,
             headers: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        """Failover-aware round-robin client — the stand-in for an
        external load balancer in tests/examples.

        Engines whose circuit is open are skipped; transport failures
        and overload statuses (502/503/504) fail over to the next
        replica when ``idempotent`` (scoring requests are). When every
        candidate fails, raises ``ServingUnavailable`` carrying the
        per-engine attempt log. Application-level HTTP errors (e.g. a
        poison row's 500) propagate unchanged — as do admission 429s
        (a tenant's empty quota is fleet-wide; replaying the request
        on another replica would just spend it there too).

        ``model``/``tenant``/``priority`` ride as the multi-model
        plane's routing headers (``X-Model``/``X-Tenant``/
        ``X-Priority``); ``headers`` adds arbitrary extras."""
        body = payload if isinstance(payload, bytes) \
            else json.dumps(payload).encode()
        extra_headers = self._route_headers(model, tenant, priority,
                                            headers)
        n = len(self.addresses)
        start = next(self._next)
        order = [(start + k) % n for k in range(n)]
        max_tries = n if idempotent else 1
        attempts: List[Dict[str, Any]] = []
        tried: set = set()
        # the client-side trace of this LOGICAL request: every leg
        # (failover, hedge, probe) is a sibling client span under this
        # root, and each leg's traceparent headers make the remote
        # engine's server spans children of that leg — one trace id
        # across processes
        trace = self._client_trace("fleet.post")
        try:
            for i in order:
                if len(tried) >= max_tries:
                    break
                if i in tried:
                    continue   # already consumed as a hedge leg
                breaker = self.breakers[i]
                if not breaker.allow():
                    attempts.append(
                        {"engine": i, "address": self.addresses[i],
                         "error": "circuit open", "skipped": True})
                    continue
                tried.add(i)
                try:
                    # _attempt owns ALL breaker recording (incl. hedges)
                    result = self._attempt(i, body, timeout, tried,
                                           allow_hedge=idempotent,
                                           content_type=content_type,
                                           extra_headers=extra_headers,
                                           trace=trace)
                except urllib.error.HTTPError as e:
                    if e.code in _FAILOVER_CODES:
                        attempts.append(
                            {"engine": i, "address": self.addresses[i],
                             "error": f"HTTP {e.code}", "skipped": False})
                        continue
                    # app-level error: the engine is alive and
                    # answering — the request itself is at fault.
                    # Surface it unchanged.
                    self._mark_root_http(trace, e.code)
                    raise
                except Exception as e:  # noqa: BLE001 — URLError/...
                    with self._stats_lock:
                        self.transport_errors += 1
                    attempts.append(
                        {"engine": i, "address": self.addresses[i],
                         "error": f"{type(e).__name__}: {e}",
                         "skipped": False})
                    continue
                self._record_latency(result["latency"])
                if trace is not None:
                    # failovers = legs that actually RAN and failed
                    # before this one; circuit-open skips produced no
                    # client leg and must not inflate the count the
                    # perfetto walkthrough pairs with sibling legs
                    failovers = len([a for a in attempts
                                     if not a.get("skipped")])
                    if failovers:
                        trace.root.set("failovers", failovers)
                return result["body"]
            if not tried and order:
                # every circuit open: last-resort probe of the
                # round-robin head so the fleet can rediscover a
                # recovered engine even before the breaker cooldown
                # elapses. SINGLE-FLIGHT: only one caller at a time
                # pays the probe's timeout against a possibly-stalled
                # engine; everyone else fails fast — the whole point of
                # an open circuit during a total outage.
                if not self._probe_lock.acquire(blocking=False):
                    attempts.append(
                        {"engine": order[0],
                         "address": self.addresses[order[0]],
                         "error": "circuit open (probe in flight)",
                         "skipped": True})
                    raise ServingUnavailable(attempts)
                try:
                    return self._probe(order[0], body, timeout, attempts,
                                       idempotent, content_type,
                                       extra_headers, trace=trace)
                finally:
                    self._probe_lock.release()
            raise ServingUnavailable(attempts)
        except ServingUnavailable:
            if trace is not None:
                trace.root.error("no serving engine available")
            raise
        finally:
            if trace is not None:
                self.tracer.finish(trace)

    def _probe(self, i: int, body: bytes, timeout: float,
               attempts: List[Dict[str, Any]],
               replayable: bool = True,
               content_type: str = "application/json",
               extra_headers: Optional[Dict[str, str]] = None,
               trace=None) -> Dict[str, Any]:
        """The all-circuits-open last-resort probe of engine ``i``."""
        span, inj = self._leg_span(trace, i, probe=True)
        extra_headers = self._merged_headers(extra_headers, inj)
        try:
            result = self._http_post(self.addresses[i], body, timeout,
                                     replayable=replayable,
                                     content_type=content_type,
                                     extra_headers=extra_headers)
        except urllib.error.HTTPError as e:
            self._finish_leg(span, e)
            if e.code not in _FAILOVER_CODES:
                # engine alive and answering: the post() contract —
                # app-level errors (a poison row's 500) propagate
                # unchanged — holds on the probe path too, and an
                # answering engine force-closes its breaker
                self._mark_root_http(trace, e.code)
                self.breakers[i].reset()
                raise
            self.breakers[i].record_failure()
            attempts.append(
                {"engine": i, "address": self.addresses[i],
                 "error": f"HTTP {e.code}", "skipped": False})
            raise ServingUnavailable(attempts) from e
        except Exception as e:  # noqa: BLE001 — URLError/timeout/...
            self._finish_leg(span, e)
            with self._stats_lock:
                self.transport_errors += 1
            attempts.append(
                {"engine": i, "address": self.addresses[i],
                 "error": f"{type(e).__name__}: {e}", "skipped": False})
            raise ServingUnavailable(attempts) from e
        # a real scored reply while OPEN: force the breaker closed
        self._finish_leg(span, None)
        self.breakers[i].reset()
        self._record_latency(result["latency"])
        return result["body"]

    def post_columns(self, columns: Dict[str, Any], *args, **kwargs):
        """The pooled columnar client: its JSON fallback needs
        ``io/columnar.py::columns_to_rows``, which waits with the host
        transports."""
        raise _not_ported("the columnar fleet client (post_columns)",
                          _HOST_TRANSPORTS)

    # -- dynamic membership (the autoscaler's join/leave surface) -----------

    def demand_rate(self, window_s: float = 30.0) -> float:
        raise _not_ported("the fleet's demand signal (demand_rate)",
                          _MULTI_MODEL)

    def add_engine(self, address: str, wait_ready_s: float = 0.0) -> int:
        raise _not_ported("fleet membership (add_engine)", _MULTI_MODEL)

    def remove_engine(self, address: str) -> None:
        raise _not_ported("fleet membership (remove_engine)", _MULTI_MODEL)

    def attach_placement(self, controller=None, **kwargs):
        raise _not_ported("the placement plane (attach_placement)",
                          _MULTI_MODEL)

    # -- observability -----------------------------------------------------

    def health(self, timeout: float = 2.0) -> List[Dict[str, Any]]:
        """Poll every engine's /healthz (in-process or remote);
        unreachable engines report ``{"reachable": False, ...}``."""
        out = []
        for addr in self.addresses:
            url = f"{addr}/healthz"
            try:
                with urllib.request.urlopen(url, timeout=timeout) as r:
                    out.append({"reachable": True,
                                **json.loads(r.read())})
            except urllib.error.HTTPError as err:
                try:
                    out.append({"reachable": True,
                                **json.loads(err.read())})
                except Exception:  # noqa: BLE001
                    out.append({"reachable": True,
                                "status": f"HTTP {err.code}"})
            except Exception as err:  # noqa: BLE001
                out.append({"reachable": False,
                            "error": f"{type(err).__name__}: {err}"})
        return out

    def metrics(self) -> Dict[str, Any]:
        """Fleet-wide latency breakdown: per-engine snapshots plus an
        aggregate merging every engine's histograms (the bench/ops
        view). Engine histograms merge exactly (same bucket layout);
        the pipeline-stage metrics come from engine 0 — fleet engines
        share one pipeline object, so its counters are already
        fleet-wide."""
        from mmlspark_tpu_torch.core.metrics import LatencyHistogram
        per_engine = [e.metrics() for e in self.engines]
        aggregate: Dict[str, Any] = {}
        if self.engines:
            for key in self.engines[0].hists:
                aggregate[key] = LatencyHistogram.merged(
                    [e.hists[key] for e in self.engines]).summary()
            stage = per_engine[0].get("pipeline_stage")
            if stage is not None:
                aggregate["pipeline_stage"] = stage
        aggregate["batches_processed"] = sum(
            m["batches_processed"] for m in per_engine)
        # lifecycle rollup: per-engine versions/states plus the fleet
        # swap counters (the ops view of a rolling upgrade in flight)
        aggregate["model_versions"] = [
            m.get("model_version") for m in per_engine]
        aggregate["precisions"] = [
            m.get("precision") for m in per_engine]
        aggregate["aot"] = [m.get("aot") for m in per_engine]
        aggregate["swap_states"] = [
            m.get("swap_state") for m in per_engine]
        aggregate["swaps_completed"] = sum(
            m.get("swaps_completed", 0) for m in per_engine)
        aggregate["swaps_rolled_back"] = sum(
            m.get("swaps_rolled_back", 0) for m in per_engine)
        return {"engines": per_engine, "aggregate": aggregate}

    def traces(self, limit: Optional[int] = None,
               raw: bool = False) -> Any:
        """The fleet's completed (tail-sampled) traces. Default: Chrome
        trace-event JSON (save to a file, open in Perfetto); pass
        ``raw=True`` for the Trace objects. Engines share one tracer,
        so this is every engine's traffic on one timeline."""
        if self.tracer is None:
            from mmlspark_tpu_torch.core.trace import to_chrome_trace
            return [] if raw else to_chrome_trace([])
        traces = self.tracer.buffer.traces(limit)
        if raw:
            return traces
        from mmlspark_tpu_torch.core.trace import to_chrome_trace
        return to_chrome_trace(traces)

    def metrics_text(self) -> str:
        """Fleet-wide Prometheus text exposition: per-engine counters
        and SLO families (labeled ``engine="<i>"``), the merged
        cross-engine latency histograms, fleet client counters
        (failover/hedging), and the process-wide phase/trace families.
        Each engine also serves its own ``/metrics``; this is the
        aggregate the ops view scrapes. (The reference's zoo,
        placement, autoscale, admission and shm families wait with
        their planes.)"""
        from mmlspark_tpu_torch.core.metrics import LatencyHistogram
        from mmlspark_tpu_torch.core.prometheus import (
            PromRenderer, pipeline_families, process_families,
            slo_families,
        )
        r = PromRenderer()
        for i, e in enumerate(self.engines):
            src = e.source
            with src._lock:
                seen, answered, rejected = (
                    src.requests_seen, src.requests_answered,
                    src.requests_rejected)
            labels = {"engine": str(i)}
            r.counter("serving_requests_seen_total",
                      "requests hitting the HTTP source", seen, labels)
            r.counter("serving_requests_answered_total",
                      "requests answered", answered, labels)
            r.counter("serving_requests_rejected_total",
                      "requests shed", rejected, labels)
            _, snap = e._lifecycle_snapshot()
            r.counter("serving_batches_processed_total",
                      "micro-batches executed",
                      snap["batches_processed"], labels)
            r.counter("serving_swaps_completed_total",
                      "model swaps completed",
                      snap["swaps_completed"], labels)
            r.counter("serving_swaps_rolled_back_total",
                      "model swaps rolled back",
                      snap["swaps_rolled_back"], labels)
            r.info("serving_model_info",
                   "active model version, precision, aot, swap state "
                   "per engine",
                   {**labels, "version": snap["model_version"],
                    "precision": snap["precision"],
                    "aot": "true" if snap["aot"] else "false",
                    "swap_state": snap["swap_state"]})
            if e.slo is not None:
                try:
                    # per-engine SLO families (engine label): each
                    # engine's burn state is its own — a fleet is
                    # degraded engine by engine
                    slo_families(r, e.slo, labels)
                except Exception:  # noqa: BLE001 — stats stay partial
                    pass
        if self.engines:
            for key in self.engines[0].hists:
                merged = LatencyHistogram.merged(
                    [e.hists[key] for e in self.engines])
                r.histogram(f"serving_{key}",
                            "fleet-merged hot-path stage distribution",
                            merged)
            # fleet engines share one pipeline object, so its hooks
            # (model hists, first-run shapes, drift) are already
            # fleet-wide
            pipeline_families(r, self.engines[0].pipeline)
        with self._stats_lock:
            transport, hedged = self.transport_errors, self.hedged_requests
        r.counter("serving_fleet_transport_errors_total",
                  "client-side transport failures", transport)
        r.counter("serving_fleet_hedged_requests_total",
                  "tail-latency hedge requests fired", hedged)
        r.gauge("serving_fleet_engines",
                "engines currently in the routing rotation",
                len(self.addresses))
        process_families(r, tracer=self.tracer)
        return r.render()

    def counters(self) -> Dict[str, int]:
        return {
            "seen": sum(e.source.requests_seen for e in self.engines),
            "accepted": sum(e.source.requests_accepted
                            for e in self.engines),
            "answered": sum(e.source.requests_answered
                            for e in self.engines),
            "rejected": sum(e.source.requests_rejected
                            for e in self.engines),
            "transport_errors": self.transport_errors,
            "hedged": self.hedged_requests,
            "workers_restarted": sum(e.workers_restarted
                                     for e in self.engines),
            "swaps_completed": sum(e.swaps_completed
                                   for e in self.engines),
            "swaps_rolled_back": sum(e.swaps_rolled_back
                                     for e in self.engines),
        }

    # -- model lifecycle ---------------------------------------------------

    def _failover_pressure(self) -> bool:
        """True while the fleet looks stressed: any ALIVE engine's
        circuit is open (dead engines' circuits stay open by design and
        must not stall a rolling upgrade forever)."""
        for e, b in zip(self.engines, self.breakers):
            if e.is_alive() and b.state == CircuitBreaker.OPEN:
                return True
        return False

    def rolling_swap(self, pipeline, version: str,
                     warmup_example=None, policy=None,
                     pressure_timeout_s: float = 30.0,
                     ) -> Dict[str, Any]:
        """Upgrade the fleet to ``pipeline``@``version`` one engine at a
        time (zero downtime: each engine keeps serving through its own
        warmup/canary/cutover — see serving/lifecycle.py).

        Between engines the rollout PAUSES while the fleet shows
        failover pressure (an alive engine's circuit open), bounded by
        ``pressure_timeout_s`` per engine. Dead engines are skipped. A
        rollback anywhere STOPS the rollout — a version that breached
        one engine's canary must not march across the rest. Returns a
        per-engine outcome report plus the aggregate verdict."""
        outcomes: List[Dict[str, Any]] = []
        completed = rolled_back = 0
        for i, engine in enumerate(self.engines):
            if not engine.is_alive():
                outcomes.append({"engine": i,
                                 "address": engine.source.address,
                                 "outcome": "skipped_dead"})
                continue
            deadline = time.monotonic() + pressure_timeout_s
            while self._failover_pressure() and \
                    time.monotonic() < deadline:
                time.sleep(0.05)   # pause the rollout, keep serving
            if self._failover_pressure():
                log.warning("rolling_swap: proceeding on engine %d "
                            "despite failover pressure (%.1fs budget "
                            "spent)", i, pressure_timeout_s)
            try:
                res = engine.swap(pipeline, version,
                                  warmup_example=warmup_example,
                                  policy=policy)
            except Exception as e:  # noqa: BLE001 — e.g. engine died
                # between the liveness check and the swap
                outcomes.append({"engine": i,
                                 "address": engine.source.address,
                                 "outcome": "error",
                                 "reason": f"{type(e).__name__}: {e}"})
                continue
            if res.completed:
                completed += 1
                outcomes.append({"engine": i,
                                 "address": engine.source.address,
                                 "outcome": "completed"})
            else:
                rolled_back += 1
                outcomes.append({"engine": i,
                                 "address": engine.source.address,
                                 "outcome": "rolled_back",
                                 "reason": res.reason})
                log.warning("rolling_swap: %s rolled back on engine %d "
                            "(%s); halting the rollout", version, i,
                            res.reason)
                break
        return {"version": version, "completed": completed,
                "rolled_back": rolled_back, "engines": outcomes,
                "ok": rolled_back == 0 and completed > 0}

    def kill_engine(self, index: int, close_source: bool = True) -> None:
        """Chaos hook: crash (or stall, with ``close_source=False``) one
        engine mid-load; the breaker + failover path must absorb it."""
        self.engines[index].kill(close_source=close_source)

    def stop_all(self) -> None:
        for e in self.engines:
            e.stop()


class PartitionConsolidator(Transformer):
    """Funnel a table to one stream per host
    (ref: PartitionConsolidator.scala:17 — many partitions feeding one
    connection-holding consumer per executor).

    In a multi-process ``torch.distributed`` job each process keeps only
    its own contiguous row range (consolidating that host's partitions
    into one table); single-process it coalesces the table's shards into
    one. ``hostCount``/``hostIndex`` override auto-detection for tests."""

    hostCount = IntParam("total hosts (0 = auto from torch.distributed)",
                         default=0)
    hostIndex = IntParam("this host's index (-1 = auto)", default=-1)

    def transform(self, table: DataTable) -> DataTable:
        count = self.get("hostCount")
        index = self.get("hostIndex")
        if count <= 0 or index < 0:
            auto_index, auto_count = _process_group_position()
            if count <= 0:
                count = auto_count
            if index < 0:
                index = auto_index
        if index >= count:
            raise ValueError(
                f"hostIndex {index} out of range for hostCount {count}")
        if count <= 1:
            # consolidate: downstream shard-aware consumers must see ONE
            # logical partition (that is this stage's whole purpose)
            return table.repartition(1)
        return _shard_table_for_host(table, index, count).repartition(1)

    def transform_schema(self, schema: Schema) -> Schema:
        return schema


def _process_group_position() -> Tuple[int, int]:
    """(process index, process count): the initialized
    ``torch.distributed`` group's rank and world size, else one
    process."""
    import torch.distributed as torch_dist
    if torch_dist.is_available() and torch_dist.is_initialized():
        return torch_dist.get_rank(), torch_dist.get_world_size()
    return 0, 1


def _shard_table_for_host(table: DataTable, index: int,
                          count: int) -> DataTable:
    """Each host keeps only its contiguous row range (the reference's
    ``parallel/distributed.py::shard_table_for_host``)."""
    if count <= 1:
        return table
    return table.shards(count)[index]
