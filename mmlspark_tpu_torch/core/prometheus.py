"""Prometheus text-exposition rendering (format version 0.0.4): the port's
copy of ``mmlspark_tpu/core/prometheus.py``.

Renders the serving engine's counters and ``LatencyHistogram``s, the
process-wide training-phase families, the trace buffer, the card's
memory and the SLO monitor in the Prometheus text format, so a standard
scraper can read ``/metrics`` on an engine. Stdlib only; the histogram
renderer reads the raw bucket snapshot (exact cumulative counts). The
multi-model plane's families (the model zoo, variants, autoscaling and
placement), a served pipeline's ``DriftMonitor`` (``drift_families``),
the continuous-training loop (``controlplane_families``) and the
serving ingress phases render here too;
``mmlspark_tpu_torch.testing.metrics_check`` audits what is rendered
here.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional

# the scrape Content-Type the text format mandates
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_OK = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def sanitize_name(name: str) -> str:
    """Coerce an arbitrary key into a legal metric/label name."""
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", str(name))
    if not out or not re.match(r"[a-zA-Z_:]", out[0]):
        out = "_" + out
    return out


def escape_label_value(value: Any) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def escape_help(text: str) -> str:
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def format_value(value: Any) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    v = float(value)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _labels_str(labels: Optional[Dict[str, Any]]) -> str:
    if not labels:
        return ""
    parts = [f'{sanitize_name(k)}="{escape_label_value(v)}"'
             for k, v in labels.items()]
    return "{" + ",".join(parts) + "}"


class PromRenderer:
    """Accumulates metric families and renders the text exposition.
    ``# HELP``/``# TYPE`` headers emit once per family regardless of how
    many label sets sample into it (e.g. one histogram family with a
    ``phase`` label fed by seven phase histograms)."""

    def __init__(self):
        self._lines: List[str] = []
        self._seen: set = set()

    def _header(self, name: str, mtype: str, help_text: str) -> None:
        if name in self._seen:
            return
        self._seen.add(name)
        self._lines.append(f"# HELP {name} {escape_help(help_text)}")
        self._lines.append(f"# TYPE {name} {mtype}")

    def sample(self, name: str, value: Any,
               labels: Optional[Dict[str, Any]] = None) -> None:
        self._lines.append(
            f"{name}{_labels_str(labels)} {format_value(value)}")

    def counter(self, name: str, help_text: str, value: Any,
                labels: Optional[Dict[str, Any]] = None) -> None:
        name = sanitize_name(name)
        self._header(name, "counter", help_text)
        self.sample(name, value, labels)

    def gauge(self, name: str, help_text: str, value: Any,
              labels: Optional[Dict[str, Any]] = None) -> None:
        name = sanitize_name(name)
        self._header(name, "gauge", help_text)
        self.sample(name, value, labels)

    def info(self, name: str, help_text: str,
             labels: Dict[str, Any]) -> None:
        """The `*_info` idiom: constant 1 gauge whose labels carry the
        metadata (model version, swap state, …)."""
        self.gauge(name, help_text, 1, labels)

    def histogram(self, name: str, help_text: str, hist: Any,
                  labels: Optional[Dict[str, Any]] = None) -> None:
        """Render one ``LatencyHistogram`` (or anything exposing its
        ``snapshot()`` contract: bounds/counts/count/sum) as a
        Prometheus histogram family — cumulative ``_bucket{le=...}``
        series ending at ``+Inf``, plus ``_sum`` and ``_count``."""
        name = sanitize_name(name)
        self._header(name, "histogram", help_text)
        snap = hist.snapshot() if hasattr(hist, "snapshot") else dict(hist)
        bounds = snap["bounds"]
        counts = snap["counts"]
        total = snap.get("count", sum(counts))
        cum = 0
        base = dict(labels or {})
        for bound, c in zip(bounds, counts):
            cum += c
            le = "+Inf" if math.isinf(bound) else format_value(bound)
            self.sample(f"{name}_bucket", cum, {**base, "le": le})
        self.sample(f"{name}_sum", snap.get("sum", 0.0), base)
        self.sample(f"{name}_count", total, base)

    def render(self) -> str:
        return "\n".join(self._lines) + "\n"


def process_families(r: PromRenderer, tracer: Any = None) -> None:
    """The process-wide (non-engine) families every exposition carries:
    GBDT, AutoML, fusion and out-of-core phase histograms, trace-buffer
    tail sampling stats, and the card's memory when this process has a
    CUDA context — so one scrape correlates serving load, training
    phases, and device memory. ``tracer`` is the tracer whose buffer
    the caller actually traces into (an engine constructed with its own
    Tracer must report THAT buffer, not the process-global one)."""
    from mmlspark_tpu_torch.core import metrics as MC
    for phase, hist in MC.gbdt_train_histograms().items():
        r.histogram("gbdt_train_phase_ms",
                    "GBDT train() per-phase wall milliseconds",
                    hist, {"phase": phase})
    for phase, hist in MC.gbdt_hist_histograms().items():
        r.histogram("gbdt_hist_phase_ms",
                    "distributed-GBDT histogram hot-loop per-phase "
                    "wall milliseconds (build/reduce/split)",
                    hist, {"phase": phase})
    for coll, val in MC.gbdt_comm_counters().items():
        r.counter("gbdt_comm_bytes_total",
                  "per-device collective payload bytes each rank "
                  "sent while boosting distributed GBDT (zero in a "
                  "one-process fit)",
                  val, {"collective": coll})
    for phase, hist in MC.automl_histograms().items():
        r.histogram("automl_phase_ms",
                    "AutoML hot-path per-phase wall milliseconds",
                    hist, {"phase": phase})
    for phase, hist in MC.pipeline_histograms().items():
        r.histogram("pipeline_fusion_phase_ms",
                    "fused-pipeline per-phase wall milliseconds "
                    "(core/fusion.py)", hist, {"phase": phase})
    for phase, hist in MC.ooc_histograms().items():
        r.histogram("ooc_ingest_phase_ms",
                    "out-of-core chunked ingest per-phase wall "
                    "milliseconds (io/ooc.py)", hist, {"phase": phase})
    for phase, hist in MC.ingress_histograms().items():
        r.histogram("serving_ingress_phase_ms",
                    "serving ingress per-phase wall milliseconds "
                    "(io/columnar.py; decode carries a codec label)",
                    hist, {"phase": phase})
    for codec, hist in MC.ingress_decode_histograms().items():
        r.histogram("serving_ingress_phase_ms",
                    "serving ingress per-phase wall milliseconds "
                    "(io/columnar.py; decode carries a codec label)",
                    hist, {"phase": "decode", "codec": codec})
    for name, hist in MC.warmup_histograms().items():
        r.histogram(f"serving_{name}",
                    "per-bucket serving warmup wall (core/warmup.py)",
                    hist)
    if tracer is None:
        from mmlspark_tpu_torch.core.trace import get_tracer
        tracer = get_tracer()
    stats = tracer.buffer.stats()
    r.gauge("trace_buffer_traces", "completed traces currently buffered",
            stats["buffered"])
    r.counter("trace_traces_added_total",
              "traces ever offered to the buffer", stats["added"])
    r.counter("trace_traces_error_kept_total",
              "error traces tail-kept", stats["errors_kept"])
    r.counter("trace_traces_slow_kept_total",
              "slow-percentile traces tail-kept", stats["slow_kept"])
    from mmlspark_tpu_torch.utils.profiling import device_memory_stats
    mem = device_memory_stats()
    if mem:
        for key in ("bytes_in_use", "bytes_limit", "peak_bytes_in_use"):
            if key in mem:
                r.gauge(f"device_memory_{key}",
                        "accelerator memory stats (device 0)", mem[key])


def pipeline_families(r: PromRenderer, pipeline: Any,
                      labels: Optional[Dict[str, Any]] = None) -> None:
    """The duck-typed pipeline surface (model histograms, first-run
    shape misses, drift monitor) rendered once — shared by the engine's
    and the fleet's expositions so a new pipeline hook is wired in ONE
    place."""
    model_hists = getattr(pipeline, "histograms", None)
    if callable(model_hists):
        try:
            for name, hist in model_hists().items():
                r.histogram(f"serving_model_{sanitize_name(name)}",
                            "model-stage latency distribution", hist,
                            labels)
        except Exception:  # noqa: BLE001 — stats stay partial
            pass
    miss_fn = getattr(pipeline, "jit_cache_miss_count", None)
    if callable(miss_fn):
        try:
            r.counter("serving_jit_cache_misses_total",
                      "first-run input shapes met by the serving forward "
                      "(steady state should be flat)", miss_fn(), labels)
        except Exception:  # noqa: BLE001 — stats stay partial
            pass
    monitor = getattr(pipeline, "drift_monitor", None)
    if monitor is not None:
        try:
            drift_families(r, monitor, labels)
        except Exception:  # noqa: BLE001 — stats stay partial
            pass


def zoo_families(r: PromRenderer, zoo: Any,
                 labels: Optional[Dict[str, Any]] = None) -> None:
    """The multi-model serving plane's families (serving/zoo.py):
    state counts + lifecycle counters (always full totals), per-model
    ``serving_model_info`` rows, and per-model latency histograms.
    The per-model label space is HARD-CAPPED at the zoo's
    ``label_cardinality_cap`` — info rows are resident-first
    most-recent-first, latency overflow folds into ``model="_other"``
    — so a 256-model zoo scrapes like a 64-model one."""
    s = zoo.stats()
    base = dict(labels or {})
    for state in sorted(s["by_state"]):
        r.gauge("serving_zoo_models",
                "registered zoo models by lifecycle state",
                s["by_state"][state], {**base, "state": state})
    r.gauge("serving_zoo_registered_models",
            "total models registered in the zoo", s["registered"], base)
    r.gauge("serving_zoo_resident_bytes",
            "estimated bytes held by resident models",
            s["resident_bytes"], base)
    r.counter("serving_zoo_activations_total",
              "lazy model activations (AOT load + warmup)",
              s["activations"], base)
    r.counter("serving_zoo_evictions_total",
              "LRU evictions under the memory/count budget",
              s["evictions"], base)
    r.counter("serving_zoo_load_failures_total",
              "model activations that raised", s["load_failures"], base)
    for m in s["models"]:
        r.info("serving_model_info",
               "per-model metadata (cardinality-capped: resident-first "
               "most-recent rows up to the zoo's label cap)",
               {**base, "model": m["model"], "version": m["version"],
                "precision": m["precision"],
                "aot": "true" if m["aot"] else "false",
                "state": m["state"],
                "cost_source": m.get("cost_source", "estimate")})
    for label, hist in sorted(zoo.model_histograms().items()):
        r.histogram("serving_model_latency_ms",
                    "per-model batch execution latency (cardinality-"
                    'capped: overflow models fold into model="_other")',
                    hist, {**base, "model": label})


def variant_families(r: PromRenderer, selector: Any,
                     labels: Optional[Dict[str, Any]] = None) -> None:
    """The SLO-adaptive variant plane's families (serving/variants.py):
    selection/degradation counters (full totals), a fleet-wide
    degraded gauge, and per-model rung/floor gauges plus ONE info row
    carrying the routed variant, the last step-down reason, and the
    active rung's cost provenance. The per-model label space is
    HARD-CAPPED at ``VARIANT_LABEL_CAP`` ladders (declaration order)
    — the serving_model_latency_ms discipline."""
    from mmlspark_tpu_torch.serving.variants import VARIANT_LABEL_CAP
    base = dict(labels or {})
    s = selector.stats()
    r.gauge("serving_variant_ladders",
            "logical models with a declared variant ladder",
            s["declared"], base)
    r.gauge("serving_variant_degraded",
            "ladders currently running below their preferred rung",
            s["degraded"], base)
    r.counter("serving_variant_step_downs_total",
              "degradation steps (burn/pressure opened a cheaper rung)",
              s["step_downs"], base)
    r.counter("serving_variant_step_ups_total",
              "recovery steps (sustained clean air closed a rung)",
              s["step_ups"], base)
    r.counter("serving_variant_selects_total",
              "active-variant changes applied by the selector",
              s["selects"], base)
    for i, (name, st) in enumerate(sorted(selector.status().items())):
        if i >= VARIANT_LABEL_CAP:
            break
        ml = {**base, "model": name}
        r.gauge("serving_variant_rung",
                "active rung on the variant ladder (0 = preferred; "
                "cardinality-capped per-model series)",
                st["rung"], ml)
        r.gauge("serving_variant_floor",
                "lowest rung the degradation state has opened "
                "(cardinality-capped per-model series)",
                st["floor"], ml)
        active = next((v for v in st["variants"]
                       if v["variant"] == st["active"]), None)
        r.info("serving_variant_info",
               "per-model routing metadata (cardinality-capped: first "
               "declared ladders up to VARIANT_LABEL_CAP)",
               {**ml, "active": st["active"],
                "last_step_down_reason":
                    st["last_step_down_reason"] or "",
                "cost_source": (active or {}).get("cost_source",
                                                  "unprofiled")})


def autoscale_families(r: PromRenderer, autoscaler: Any,
                       labels: Optional[Dict[str, Any]] = None) -> None:
    """The fleet autoscaler's families (serving/autoscale.py): the
    width band and live demand rate as gauges, scale actions and
    failure modes as counters. No per-engine labels — addresses are
    unbounded; the fleet's own gauges carry the width."""
    base = dict(labels or {})
    s = autoscaler.stats()
    r.gauge("serving_autoscale_engines",
            "engines in the routing rotation", s["engines"], base)
    r.gauge("serving_autoscale_owned_engines",
            "engines the autoscaler spawned (its retire candidates)",
            s["owned"], base)
    r.gauge("serving_autoscale_min_engines",
            "configured fleet-width floor", s["min_engines"], base)
    r.gauge("serving_autoscale_max_engines",
            "configured fleet-width ceiling", s["max_engines"], base)
    r.gauge("serving_autoscale_demand_rate",
            "windowed client demand rate (rows/s) driving decisions",
            s["demand_rate"], base)
    r.counter("serving_autoscale_scale_ups_total",
              "engines spawned + joined by the autoscaler",
              s["scale_ups"], base)
    r.counter("serving_autoscale_scale_downs_total",
              "engines retired through the drain path",
              s["scale_downs"], base)
    r.counter("serving_autoscale_drain_timeouts_total",
              "retirements that hit the drain deadline",
              s["drain_timeouts"], base)
    r.counter("serving_autoscale_spawn_failures_total",
              "spawner or startup-probe failures (fleet width "
              "unchanged)", s["spawn_failures"], base)


def placement_families(r: PromRenderer, placement: Any,
                       labels: Optional[Dict[str, Any]] = None) -> None:
    """The fleet placement plane's families (serving/placement.py):
    plan size and churn (full totals), per-model replica counts — the
    label space HARD-CAPPED at ``REPLICA_LABEL_CAP`` highest-replica
    models, overflow summed into ``model="_other"`` (the
    serving_model_latency_ms discipline) — the plan-rebuild latency
    histogram, and stale-route fallbacks."""
    from mmlspark_tpu_torch.serving.placement import REPLICA_LABEL_CAP
    base = dict(labels or {})
    s = placement.stats()
    r.gauge("serving_placement_models",
            "models in the current placement plan", s["models"], base)
    r.gauge("serving_placement_assignments",
            "total (model, engine) assignment pairs in the plan",
            s["assignments"], base)
    r.counter("serving_placement_rebuilds_total",
              "placement plan rebuilds", s["rebuilds"], base)
    r.counter("serving_placement_stale_routes_total",
              "model-keyed requests routed without a plan entry "
              "(fallback to any engine + lazy activation)",
              s["stale_routes"], base)
    replicas = sorted(placement.replica_counts().items(),
                      key=lambda kv: (-kv[1], kv[0]))
    other = 0
    for i, (model, count) in enumerate(replicas):
        if i < REPLICA_LABEL_CAP:
            r.gauge("serving_placement_replicas",
                    "engines assigned per model (cardinality-capped: "
                    'overflow models fold into model="_other")',
                    count, {**base, "model": model})
        else:
            other += count
    if other:
        r.gauge("serving_placement_replicas",
                "engines assigned per model (cardinality-capped: "
                'overflow models fold into model="_other")',
                other, {**base, "model": "_other"})
    r.histogram("serving_placement_rebuild_ms",
                "placement plan rebuild latency",
                placement.rebuild_hist, base)


def slo_families(r: PromRenderer, monitor: Any,
                 labels: Optional[Dict[str, Any]] = None) -> None:
    """The windowed SLO engine's families (core/slo.py): per-objective
    burn rates over the monitor's windows, windowed error rate and p99,
    active-alert gauges, and the alert totals. Per-model series render
    only the short-window burn rate, and only for the monitor's
    HARD-CAPPED label set (``label_cap`` + ``_other``)."""
    base = dict(labels or {})
    # the three scalars are free (no windowed aggregation): going
    # through monitor.status() here would compute every burn/error/p99
    # window just to throw it away — and the per-window gauges below
    # recompute exactly what each sample needs, once
    alert_stats = monitor.alerts.stats()
    r.gauge("serving_slo_degraded",
            "1 while any burn-rate alert is active", monitor.degraded,
            base)
    r.counter("serving_slo_alerts_fired_total",
              "burn-rate alerts ever fired", alert_stats["fired_total"],
              base)
    r.counter("serving_slo_alerts_resolved_total",
              "burn-rate alerts ever resolved",
              alert_stats["resolved_total"], base)
    for slo in monitor.slos:
        slo_labels = {**base, "slo": slo.name}
        r.gauge("serving_slo_target",
                "declared objective (good-event fraction)", slo.target,
                {**slo_labels, "kind": slo.kind})
        for w in monitor.windows:
            wl = _slo_window_label(w)
            r.gauge("serving_slo_burn_rate",
                    "error-budget burn rate over the trailing window "
                    "(1.0 = sustainable pace)",
                    monitor.burn_rate(slo, w),
                    {**slo_labels, "window": wl})
    for w in monitor.windows:
        wl = _slo_window_label(w)
        r.gauge("serving_slo_error_rate",
                "5xx fraction over the trailing window",
                monitor.error_rate(w), {**base, "window": wl})
        r.gauge("serving_slo_latency_p99_ms",
                "p99 reply latency over the trailing window",
                monitor.latency_p99(w), {**base, "window": wl})
        r.gauge("serving_slo_requests_window",
                "requests observed in the trailing window",
                monitor.requests(w), {**base, "window": wl})
    for alert in monitor.alerts.active():
        r.gauge("serving_slo_alert_active",
                "active burn-rate alert (labels carry identity)", 1,
                {**base, "slo": alert.slo, "rule": alert.rule,
                 **({"model": alert.model} if alert.model else {})})
    # per-model: ONE gauge family over the capped label set
    short_w = min((rule.short_window_s for rule in monitor.rules),
                  default=300.0)
    for model in monitor.model_labels():
        for slo in monitor.slos:
            r.gauge("serving_slo_model_burn_rate",
                    "short-window burn rate per model (cardinality-"
                    'capped: overflow folds into model="_other")',
                    monitor.burn_rate(slo, short_w, model=model),
                    {**base, "slo": slo.name, "model": model})


def _slo_window_label(window_s: float) -> str:
    from mmlspark_tpu_torch.core.slo import _window_label
    return _window_label(window_s)


def drift_families(r: PromRenderer, monitor: Any,
                   labels: Optional[Dict[str, Any]] = None) -> None:
    """``DriftMonitor`` summary as gauges (served-traffic feature drift
    vs fit-time statistics)."""
    summary = monitor.summary()
    base = dict(labels or {})
    r.gauge("serving_drift_rows", "rows folded into the drift monitor",
            summary.get("rows", 0), base)
    if summary.get("rows", 0) == 0:
        return
    r.gauge("serving_drift_max_abs_mean_delta_sigma",
            "max per-feature |mean shift| in fit-time sigma units",
            summary["max_abs_mean_delta_sigma"], base)
    r.gauge("serving_drift_max_var_ratio",
            "max per-feature served/fit variance ratio",
            summary["max_var_ratio"], base)
    r.gauge("serving_drift_null_rate",
            "NaN/inf rate across served feature cells",
            summary["null_rate"], base)
    # per-feature drift scores, cardinality-capped: only the top
    # DRIFT_FEATURE_CAP features by score get their own series (wide
    # models would otherwise mint thousands); the overflow folds into
    # feature="_other" carrying the worst remaining score, so a drift
    # outside the top set still moves a series
    import numpy as np
    snap = monitor.snapshot()
    seen = np.asarray(snap["count"]) > 0
    sigma = np.sqrt(np.asarray(snap["ref_var"], dtype=np.float64))
    scores = np.where(
        seen,
        np.abs((np.asarray(snap["mean"]) - np.asarray(snap["ref_mean"]))
               / sigma),
        0.0)
    names = monitor.feature_names
    order = np.argsort(scores)[::-1]
    top = [int(i) for i in order[:DRIFT_FEATURE_CAP]]
    for i in top:
        label = str(names[i]) if names else f"f{i}"
        r.gauge("serving_drift_score",
                "per-feature |mean shift| in fit-time sigma units "
                '(top-K by score; overflow folds into feature="_other")',
                float(scores[i]), {**base, "feature": label})
    rest = order[DRIFT_FEATURE_CAP:]
    if len(rest):
        r.sample("serving_drift_score", float(scores[rest[0]]),
                 {**base, "feature": "_other"})


# per-feature drift series cap — the "model" label discipline applied
# to features: a bounded exposition no matter how wide the model is
DRIFT_FEATURE_CAP = 16


def controlplane_families(r: PromRenderer, trainer: Any) -> None:
    """Continuous-training control-loop families (serving/
    controlplane.py): loop counters, health gauges, and the per-phase
    wall histograms of the trainer thread."""
    from mmlspark_tpu_torch.core import metrics as MC
    st = trainer.status()
    r.counter("serving_controlplane_cycles_total",
              "refit cycles triggered (drift/SLO/forced)",
              st["cycles"])
    r.counter("serving_controlplane_refits_total",
              "incremental refits completed", st["refits"])
    r.counter("serving_controlplane_refit_failures_total",
              "refit attempts that exhausted retries",
              st["refit_failures"])
    r.counter("serving_controlplane_promotions_total",
              "candidates promoted through canary cutover",
              st["promotions"])
    r.counter("serving_controlplane_quarantines_total",
              "candidates quarantined by the gate or canary rollback",
              st["quarantines"])
    r.gauge("serving_controlplane_degraded",
            "1 while training is unhealthy (circuit open or trainer "
            "thread dead) and serving runs the frozen model",
            1 if st["degraded"] else 0)
    r.gauge("serving_controlplane_circuit_open",
            "1 while the refit circuit breaker is open",
            1 if st["circuit_open"] else 0)
    r.gauge("serving_controlplane_window_rows",
            "labeled rows currently held in the replay window",
            st["window"]["rows"])
    r.info("serving_controlplane_info",
           "control-loop state + last trigger (labels)",
           {"state": st["state"],
            "last_trigger": str(st["last_trigger"] or "")})
    for phase, hist in MC.controlplane_histograms().items():
        r.histogram("serving_controlplane_phase_ms",
                    "continuous-training per-phase wall milliseconds "
                    "on the dedicated trainer thread",
                    hist, {"phase": phase})
