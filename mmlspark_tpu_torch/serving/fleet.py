"""The standard model-behind-HTTP scorers: the part of
``mmlspark_tpu/serving/fleet.py`` the port holds so far.

``json_scoring_pipeline`` wraps one fitted model (a ``TPUModel``, or a
GBDT / other estimator model that emits one prediction per row) and
``json_row_scoring_pipeline`` any tabular pipeline; both return a stage
that ``serve_model`` serves. ``json_scoring_pipeline`` over a fitted
``PipelineModel`` (or a ``FusedPipelineModel``) serves raw JSON rows
through the fused plan (``_FusedPipelineScorer``): the batcher thread
runs the host prefix, the Feeds and the upload of the padded batch on a
side stream; a worker runs the fused segment and makes exactly one
device-to-host copy per batch. The multi-engine client ``ServingFleet``
and ``PartitionConsolidator`` are not ported yet (ROADMAP.md, 'The rest
of the serving plane').
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

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
