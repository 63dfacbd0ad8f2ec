"""Windowed SLOs with multi-window burn-rate alerting: the port's copy of
``mmlspark_tpu/core/slo.py``.

Cumulative counters answer "how many errors since process start"; an SLO
wants "are we spending the error budget faster than we can afford,
RIGHT NOW" — the signal the closed-loop continuous-training item needs
to trigger refits and rollbacks, and the one an operator pages on. This
module implements the multi-window multi-burn-rate pattern from the
Google SRE workbook (Beyer et al., *The Site Reliability Workbook*,
ch. 5) over the windowed primitives in ``core.metrics``:

- an **SLO** declares a target over a unit of "good events":
  availability (good = non-5xx reply) or latency (good = reply faster
  than ``latency_threshold_ms``). The error budget is ``1 - target``.
- the **burn rate** over a window is
  ``observed_bad_fraction / error_budget``: burn 1.0 spends the budget
  exactly at the sustainable pace; burn 14.4 exhausts a 30-day budget
  in 2 days.
- a **BurnRateRule** fires when the burn rate exceeds its factor over
  BOTH a long and a short window (the short window makes the alert
  reset quickly once the incident ends; the long window keeps a brief
  blip from paging). Defaults follow the workbook: fast burn 14.4x
  over 1h/5m, slow burn 6x over 6h/30m (clamped to the monitor's
  horizon).
- alerts land in a bounded **AlertLog** and surface on ``/healthz``
  (degraded + active alerts), ``/metrics`` (``serving_slo_*``
  families), an event timeline through ``record_event`` (``AlertEvent``;
  the reference wires it to its model zoo, which the port has not
  ported), and the flight recorder (auto-captured bundle on every
  fire).

``SLOMonitor`` is the serving-side aggregation point: engines record
one sample per answered request (plus per-model samples under the zoo's
cardinality-cap discipline) and evaluate rules on a rate-gated tick
from the batcher loop. Stdlib-only, thread-safe, O(1) per record.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.core.metrics import WindowedCounter, WindowedHistogram

log = get_logger("slo")

KIND_AVAILABILITY = "availability"
KIND_LATENCY = "latency"


class SLO:
    """One declared objective.

    - ``kind="availability"``: ``target`` is the good-reply fraction
      (e.g. 0.999); a bad event is a 5xx reply (load-shed 503s
      included — unavailability is unavailability to the caller).
    - ``kind="latency"``: ``target`` is the fraction of replies that
      must finish within ``latency_threshold_ms`` (e.g. 0.99 of
      requests under 250 ms — a p99 objective); a bad event is a
      slower reply.
    """

    def __init__(self, name: str, kind: str = KIND_AVAILABILITY,
                 target: float = 0.999,
                 latency_threshold_ms: Optional[float] = None):
        if kind not in (KIND_AVAILABILITY, KIND_LATENCY):
            raise ValueError(f"unknown SLO kind {kind!r}")
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be in (0, 1): {target}")
        if kind == KIND_LATENCY and not latency_threshold_ms:
            raise ValueError("latency SLOs need latency_threshold_ms")
        self.name = str(name)
        self.kind = kind
        self.target = float(target)
        self.latency_threshold_ms = (float(latency_threshold_ms)
                                     if latency_threshold_ms else None)

    @property
    def error_budget(self) -> float:
        return 1.0 - self.target

    def __repr__(self) -> str:
        extra = (f", <= {self.latency_threshold_ms} ms"
                 if self.kind == KIND_LATENCY else "")
        return f"SLO({self.name!r}, {self.kind}, {self.target}{extra})"


class BurnRateRule:
    """Fire when burn rate >= ``factor`` over BOTH windows.

    ``min_events`` bad events must exist in the short window before the
    rule may fire — a single error at 3 qpm must not page a 99.9%
    objective. Resolution: the rule resolves when the SHORT window's
    burn rate drops below the factor (the workbook's reset property —
    the short window drains within minutes of recovery)."""

    def __init__(self, name: str, long_window_s: float = 3600.0,
                 short_window_s: float = 300.0, factor: float = 14.4,
                 min_events: int = 4):
        if short_window_s > long_window_s:
            raise ValueError("short window must not exceed the long one")
        self.name = str(name)
        self.long_window_s = float(long_window_s)
        self.short_window_s = float(short_window_s)
        self.factor = float(factor)
        self.min_events = int(min_events)

    def __repr__(self) -> str:
        return (f"BurnRateRule({self.name!r}, {self.factor}x over "
                f"{self.long_window_s:.0f}s/{self.short_window_s:.0f}s)")


def default_rules() -> List[BurnRateRule]:
    """The SRE-workbook pair: fast burn pages in minutes, slow burn
    catches a simmering leak."""
    return [BurnRateRule("fast_burn", 3600.0, 300.0, 14.4),
            BurnRateRule("slow_burn", 21600.0, 1800.0, 6.0)]


class Alert:
    """One fired (and possibly resolved) burn-rate alert."""

    __slots__ = ("slo", "rule", "model", "fired_at", "resolved_at",
                 "burn_short", "burn_long", "details")

    def __init__(self, slo: str, rule: str, model: Optional[str],
                 burn_short: float, burn_long: float,
                 details: Optional[Dict[str, Any]] = None,
                 fired_at: Optional[float] = None):
        self.slo = slo
        self.rule = rule
        self.model = model
        self.fired_at = time.time() if fired_at is None else fired_at
        self.resolved_at: Optional[float] = None
        self.burn_short = float(burn_short)
        self.burn_long = float(burn_long)
        self.details = dict(details or {})

    @property
    def name(self) -> str:
        base = f"{self.slo}:{self.rule}"
        return f"{base}:{self.model}" if self.model else base

    @property
    def active(self) -> bool:
        return self.resolved_at is None

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "slo": self.slo, "rule": self.rule,
                "model": self.model, "fired_at": self.fired_at,
                "resolved_at": self.resolved_at,
                "active": self.active,
                "burn_short": round(self.burn_short, 3),
                "burn_long": round(self.burn_long, 3),
                "details": dict(self.details)}

    def __repr__(self) -> str:
        state = "ACTIVE" if self.active else "resolved"
        return (f"Alert({self.name}, {state}, "
                f"burn {self.burn_short:.1f}x/{self.burn_long:.1f}x)")


class AlertEvent:
    """The registry-timeline record of an alert transition — the
    ``SwapEvent``/``ZooEvent`` discipline applied to SLO alerting, so
    one interleaved event log tells the whole lifecycle story (swap,
    eviction, breach) in order."""

    def __init__(self, kind: str, alert: Alert):
        self.kind = kind            # 'alert_fired' | 'alert_resolved'
        self.alert_name = alert.name
        self.slo = alert.slo
        self.rule = alert.rule
        self.model = alert.model
        self.burn_short = alert.burn_short
        self.burn_long = alert.burn_long
        self.at = time.time()

    def __repr__(self) -> str:
        return (f"AlertEvent({self.kind}, {self.alert_name}, "
                f"burn {self.burn_short:.1f}x)")


class AlertLog:
    """Bounded history + the active-alert set. Thread-safe."""

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, int(capacity))
        self._log: List[Alert] = []
        self._active: Dict[str, Alert] = {}
        self._lock = threading.Lock()
        self.fired_total = 0
        self.resolved_total = 0

    def fire(self, alert: Alert) -> Optional[Alert]:
        """Record a newly-firing alert; returns it, or None when the
        same (slo, rule, model) identity is already active (no
        re-fire storms)."""
        with self._lock:
            if alert.name in self._active:
                return None
            self._active[alert.name] = alert
            self._log.append(alert)
            del self._log[:-self.capacity]
            self.fired_total += 1
        return alert

    def resolve(self, name: str) -> Optional[Alert]:
        with self._lock:
            alert = self._active.pop(name, None)
            if alert is None:
                return None
            alert.resolved_at = time.time()
            self.resolved_total += 1
        return alert

    def active(self) -> List[Alert]:
        with self._lock:
            return list(self._active.values())

    def history(self, limit: int = 64) -> List[Alert]:
        with self._lock:
            return list(self._log[-max(0, int(limit)):])

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"active": len(self._active),
                    "fired_total": self.fired_total,
                    "resolved_total": self.resolved_total}


class _Stream:
    """One labeled measurement stream (engine-level or one model):
    total/error counters plus the per-latency-SLO slow counters and a
    windowed latency histogram."""

    __slots__ = ("total", "errors", "latency", "slow")

    def __init__(self, bucket_s: float, horizon_s: float,
                 hist_bucket_s: float, latency_slos: Sequence[SLO],
                 clock) -> None:
        self.total = WindowedCounter(bucket_s, horizon_s, clock=clock)
        self.errors = WindowedCounter(bucket_s, horizon_s, clock=clock)
        self.latency = WindowedHistogram(hist_bucket_s, horizon_s,
                                         clock=clock)
        # exact slow-event counters (one per latency SLO): deriving
        # "slower than N ms" from histogram buckets would quantize the
        # threshold to a bucket bound
        self.slow: Dict[str, WindowedCounter] = {
            s.name: WindowedCounter(bucket_s, horizon_s, clock=clock)
            for s in latency_slos}


def default_slos() -> List[SLO]:
    return [SLO("availability", KIND_AVAILABILITY, target=0.999),
            SLO("latency_p99", KIND_LATENCY, target=0.99,
                latency_threshold_ms=250.0)]


class SLOMonitor:
    """The windowed SLO engine one serving engine (or embedder) feeds.

    ``record(ok, latency_ms, model=...)`` is the hot-path sample —
    two/three counter increments and one histogram observe. The
    per-model label space is HARD-CAPPED at ``label_cap`` (the zoo's
    cardinality discipline): the first ``label_cap`` distinct models
    get their own stream, later ones fold into ``"_other"``.

    ``evaluate()`` walks every (SLO, rule, stream) combination, firing
    and resolving alerts through the ``AlertLog``; it is rate-gated so
    the batcher loop can call it every iteration. Alert transitions
    invoke ``on_fire``/``on_resolve`` callbacks (the flight-recorder
    trigger rides ``on_fire``) and ``record_event`` with an
    ``AlertEvent`` (the registry timeline hook).
    """

    def __init__(self, slos: Optional[Sequence[SLO]] = None,
                 rules: Optional[Sequence[BurnRateRule]] = None,
                 windows: Sequence[float] = (60.0, 300.0, 3600.0),
                 label_cap: int = 16,
                 bucket_s: float = 1.0,
                 hist_bucket_s: float = 5.0,
                 horizon_s: Optional[float] = 3600.0,
                 alert_log: Optional[AlertLog] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.slos = list(slos) if slos is not None else default_slos()
        self.rules = list(rules) if rules is not None else default_rules()
        self.windows = tuple(float(w) for w in windows)
        self.label_cap = max(1, int(label_cap))
        self._clock = clock
        if horizon_s is None:
            horizon_s = max([r.long_window_s for r in self.rules]
                            + list(self.windows) + [60.0])
        # rules longer than the horizon evaluate over what the ring
        # holds (clamp, don't crash): the DEFAULT horizon is 1h — the
        # workbook's 6h slow-burn long window clamps to 1h/30m, a
        # deliberate memory/fidelity trade for an in-process monitor
        # (≈0.5 MB per stream at 1s buckets; pass horizon_s=None to
        # size from the rules instead). Clamping rebuilds COPIES: the
        # caller's rule objects (possibly a shared constant, possibly
        # feeding a second monitor whose horizon is sized FROM them)
        # must never be mutated in place.
        self.horizon_s = float(horizon_s)
        self.rules = [
            r if r.long_window_s <= self.horizon_s
            else BurnRateRule(
                r.name, self.horizon_s,
                min(r.short_window_s, self.horizon_s), r.factor,
                min_events=r.min_events)
            for r in self.rules]
        self._bucket_s = float(bucket_s)
        self._hist_bucket_s = float(hist_bucket_s)
        self._latency_slos = [s for s in self.slos
                              if s.kind == KIND_LATENCY]
        self._streams: Dict[Optional[str], _Stream] = {
            None: self._new_stream()}
        self._streams_lock = threading.Lock()
        self.alerts = alert_log if alert_log is not None else AlertLog()
        self.on_fire: Optional[Callable[[Alert], None]] = None
        self.on_resolve: Optional[Callable[[Alert], None]] = None
        self.record_event: Optional[Callable[[AlertEvent], None]] = None
        self._eval_lock = threading.Lock()
        self._last_eval = 0.0

    def _new_stream(self) -> _Stream:
        return _Stream(self._bucket_s, self.horizon_s,
                       self._hist_bucket_s, self._latency_slos,
                       self._clock)

    # -- the hot path -------------------------------------------------------

    def _stream(self, model: Optional[str]) -> _Stream:
        stream = self._streams.get(model)
        if stream is not None:
            return stream
        with self._streams_lock:
            stream = self._streams.get(model)
            if stream is None:
                named = len(self._streams) - 1 - (
                    1 if "_other" in self._streams else 0)
                if named < self.label_cap:
                    stream = self._streams[model] = self._new_stream()
                else:
                    stream = self._streams.get("_other")
                    if stream is None:
                        stream = self._streams["_other"] = \
                            self._new_stream()
        return stream

    def record(self, ok: bool, latency_ms: float,
               model: Optional[str] = None,
               now: Optional[float] = None,
               include_engine: bool = True) -> None:
        """One served-request (or served-batch, for per-model) sample.
        ``include_engine=False`` lands the sample on the model's
        stream only — the serving engine records engine-level totals
        at the HTTP handler and per-model samples at batch execution,
        and must not count a request twice in the engine stream."""
        targets: List[_Stream] = []
        if include_engine or model is None:
            targets.append(self._streams[None])
        if model is not None:
            targets.append(self._stream(str(model)))
        for stream in targets:
            stream.total.inc(1.0, now=now)
            if not ok:
                stream.errors.inc(1.0, now=now)
            stream.latency.observe(latency_ms, now=now)
            for slo in self._latency_slos:
                if not ok or latency_ms > slo.latency_threshold_ms:
                    # an errored reply spends the latency budget too:
                    # the client did not get a fast good answer
                    stream.slow[slo.name].inc(1.0, now=now)

    # -- burn-rate math -----------------------------------------------------

    def _bad_counter(self, stream: _Stream, slo: SLO) -> WindowedCounter:
        return (stream.errors if slo.kind == KIND_AVAILABILITY
                else stream.slow[slo.name])

    def burn_rate(self, slo: SLO, window_s: float,
                  model: Optional[str] = None,
                  now: Optional[float] = None) -> float:
        """``bad_fraction(window) / error_budget``; 0.0 with no
        traffic in the window (an idle service burns nothing — this is
        also what lets an alert resolve once the window drains)."""
        stream = self._streams.get(model)
        if stream is None:
            return 0.0
        total = stream.total.total(window_s, now=now)
        if total <= 0:
            return 0.0
        bad = self._bad_counter(stream, slo).total(window_s, now=now)
        return (bad / total) / max(slo.error_budget, 1e-12)

    def error_rate(self, window_s: float, model: Optional[str] = None,
                   now: Optional[float] = None) -> float:
        stream = self._streams.get(model)
        if stream is None:
            return 0.0
        total = stream.total.total(window_s, now=now)
        if total <= 0:
            return 0.0
        return stream.errors.total(window_s, now=now) / total

    def latency_p99(self, window_s: float,
                    model: Optional[str] = None,
                    now: Optional[float] = None) -> float:
        """p99 reply latency (ms) over the trailing window — the
        public accessor exporters render through."""
        stream = self._streams.get(model)
        if stream is None:
            return 0.0
        return stream.latency.percentile(99, window_s, now=now)

    def requests(self, window_s: float, model: Optional[str] = None,
                 now: Optional[float] = None) -> float:
        """Requests observed in the trailing window."""
        stream = self._streams.get(model)
        if stream is None:
            return 0.0
        return stream.total.total(window_s, now=now)

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, min_interval_s: float = 0.0,
                 now: Optional[float] = None) -> List[Alert]:
        """Walk every (SLO, rule, stream), firing/resolving alerts.
        Returns the alerts that FIRED this pass. Rate-gated by
        ``min_interval_s`` (single-flight: concurrent callers skip)."""
        t = self._clock() if now is None else now
        if not self._eval_lock.acquire(blocking=False):
            return []
        try:
            if min_interval_s > 0 and \
                    t - self._last_eval < min_interval_s:
                return []
            self._last_eval = t
            fired: List[Alert] = []
            with self._streams_lock:
                labels = list(self._streams)
            # ONE active-set snapshot per pass (fire/resolve below
            # mutate the log, but alert identities are disjoint per
            # (slo, rule, label), so the snapshot stays correct)
            active = {a.name for a in self.alerts.active()}
            for label in labels:
                stream = self._streams.get(label)
                if stream is None:
                    continue
                for slo in self.slos:
                    bad = self._bad_counter(stream, slo)
                    for rule in self.rules:
                        self._eval_one(slo, rule, label, stream, bad,
                                       now, fired, active)
            return fired
        finally:
            self._eval_lock.release()

    def _eval_one(self, slo: SLO, rule: BurnRateRule,
                  label: Optional[str], stream: _Stream,
                  bad: WindowedCounter, now: Optional[float],
                  fired: List[Alert], active: set) -> None:
        burn_short = self.burn_rate(slo, rule.short_window_s, label,
                                    now=now)
        name = f"{slo.name}:{rule.name}"
        if label:
            name = f"{name}:{label}"
        if name in active:
            # resolution: the short window recovered below the factor
            if burn_short < rule.factor:
                alert = self.alerts.resolve(name)
                if alert is not None:
                    log.info("SLO alert resolved: %s", alert)
                    self._notify("alert_resolved", alert,
                                 self.on_resolve)
            return
        if burn_short < rule.factor:
            return
        if bad.total(rule.short_window_s, now=now) < rule.min_events:
            return
        burn_long = self.burn_rate(slo, rule.long_window_s, label,
                                   now=now)
        if burn_long < rule.factor:
            return
        alert = Alert(
            slo.name, rule.name, label, burn_short, burn_long,
            details={
                "target": slo.target,
                "kind": slo.kind,
                "factor": rule.factor,
                "short_window_s": rule.short_window_s,
                "long_window_s": rule.long_window_s,
                "error_rate_short": round(
                    self.error_rate(rule.short_window_s, label,
                                    now=now), 6),
            })
        if self.alerts.fire(alert) is not None:
            log.warning("SLO alert FIRED: %s", alert)
            fired.append(alert)
            self._notify("alert_fired", alert, self.on_fire)

    def _notify(self, kind: str, alert: Alert,
                callback: Optional[Callable[[Alert], None]]) -> None:
        if self.record_event is not None:
            try:
                self.record_event(AlertEvent(kind, alert))
            except Exception:  # noqa: BLE001 — audit is best-effort
                pass
        if callback is not None:
            try:
                callback(alert)
            except Exception as e:  # noqa: BLE001 — a sick hook must
                log.error("SLO %s hook failed: %s", kind, e)

    # -- read surfaces ------------------------------------------------------

    @property
    def degraded(self) -> bool:
        return bool(self.alerts.active())

    def status(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The /healthz surface: degraded flag, active alerts, and the
        engine-level windowed view per SLO."""
        out: Dict[str, Any] = {
            "degraded": self.degraded,
            "active_alerts": [a.to_dict() for a in self.alerts.active()],
            **self.alerts.stats(),
        }
        objectives = []
        stream = self._streams[None]
        for slo in self.slos:
            entry: Dict[str, Any] = {
                "slo": slo.name, "kind": slo.kind, "target": slo.target,
            }
            if slo.latency_threshold_ms is not None:
                entry["latency_threshold_ms"] = slo.latency_threshold_ms
            for w in self.windows:
                key = _window_label(w)
                entry[f"burn_rate_{key}"] = round(
                    self.burn_rate(slo, w, now=now), 3)
            objectives.append(entry)
        for w in self.windows:
            key = _window_label(w)
            out[f"error_rate_{key}"] = round(
                self.error_rate(w, now=now), 6)
            out[f"p99_ms_{key}"] = round(
                stream.latency.percentile(99, w, now=now), 3)
            out[f"requests_{key}"] = stream.total.total(w, now=now)
        out["objectives"] = objectives
        return out

    def series(self, window_s: Optional[float] = None,
               now: Optional[float] = None) -> Dict[str, Any]:
        """Machine-readable recent time series (the flight-recorder
        payload): per-bucket request/error counts plus the windowed
        latency snapshot, engine-level."""
        w = float(window_s) if window_s else min(
            300.0, self.horizon_s)
        stream = self._streams[None]
        return {
            "window_s": w,
            "bucket_s": self._bucket_s,
            "requests": stream.total.series(w, now=now),
            "errors": stream.errors.series(w, now=now),
            "latency": stream.latency.snapshot(w, now=now),
        }

    def model_labels(self) -> List[str]:
        with self._streams_lock:
            return [m for m in self._streams if m is not None]


def _window_label(window_s: float) -> str:
    """``60.0 -> "1m"``, ``300 -> "5m"``, ``3600 -> "1h"`` (generic
    fallback ``"<n>s"``) — the window label on /metrics and /healthz."""
    w = int(window_s)
    if w % 3600 == 0:
        return f"{w // 3600}h"
    if w % 60 == 0:
        return f"{w // 60}m"
    return f"{w}s"
