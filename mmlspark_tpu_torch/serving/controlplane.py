"""Closed-loop continuous training: drift -> refit -> shadow -> canary —
the port's copy of ``mmlspark_tpu/serving/controlplane.py``.

Models live behind live traffic indefinitely, so a model fit once is a
model drifting forever. Every mechanism this loop needs already exists
in the package —
``DriftMonitor`` (core/metrics.py), incremental refits via
``partial_fit``/``boost_more``, the canary swap protocol with
auto-rollback (serving/lifecycle.py), SLO burn-rate alerts + the
flight recorder (core/slo.py, core/flightrecorder.py), and the bounded
``ReplayWindow`` over chunked ingest (io/ooc.py). This module is the
*control plane* that connects them into one supervised loop
(the TFX production lesson, Baylor et al. KDD'17: continuous training
is only safe with automated validation gates and rollback on EVERY
path):

::

            +--------------------- idle <--------------------+
            | trigger (drift breach | SLO burn alert)        |
            v                                                |
        refitting --(retries exhausted)--> idle/degraded     |
            | partial_fit / boost_more on the replay window  |
            v                                                |
        shadowing --(gate FAIL)--> quarantine (+ bundle) ----+
            | candidate vs baseline on the freshest traffic  |
            v                                                |
        promoting --(canary breach)--> quarantine (+ bundle)-+
            | execute_swap: warmup -> canary -> cutover      |
            +--- promoted ----------------------------------+

On the card the loop's GBDT refit is ``Booster.boost_more`` over the
replay window, one hist-kernel launch per split (``csrc/hist.cu``), and
its shadow gate scores both forests with the card's forest walk. A refit
that fails to launch its kernel fails the cycle (``refit_failed``): no
fallback is taken here.

Design rules (audited by ``testing/fusion_check.py``'s
``check_control_loop``):

- **One transition funnel.** Every ``self.state`` write goes through
  ``_transition``, and ``_transition`` records a timeline event — the
  registry event log (next to ``SwapEvent``/``ZooEvent``/
  ``AlertEvent``) is a complete, ordered record of every decision the
  loop ever made.
- **Dedicated trainer thread.** Refits and shadow validation run ONLY
  on the ``controlplane-trainer`` thread — never on the engine's
  batcher or worker threads. Training work on the serving hot path is
  the failure mode this loop exists to prevent.
- **Training death never takes serving down.** Repeated refit failures
  open a circuit (state ``degraded``); a dead trainer thread degrades
  ``/healthz`` (still HTTP 200) — in both cases the engine keeps
  serving the frozen model untouched.
- **Quarantine keeps the evidence.** A candidate that fails the gate
  (or rolls back in canary) is never promoted; its gate verdict and a
  flight-recorder bundle are retained on the trainer
  (``quarantined[version]``) and a ``QuarantineEvent`` lands on the
  timeline.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.core.metrics import controlplane_histograms
from mmlspark_tpu_torch.io.ooc import ChunkedTable, ReplayWindow
from mmlspark_tpu_torch.serving.lifecycle import (
    CanaryPolicy, ModelRegistry, execute_swap,
)

log = get_logger("serving.controlplane")

# loop states (trainer.state / healthz controlplane.state)
IDLE = "idle"
REFITTING = "refitting"
SHADOWING = "shadowing"
PROMOTING = "promoting"
DEGRADED = "degraded"
STOPPED = "stopped"

_TRAINER_THREAD_NAME = "controlplane-trainer"


class _ControlEvent:
    """Base typed record for one control-loop decision. Shares the
    ``SwapEvent``/``ZooEvent`` duck-typed shape (``kind``/``at``/
    ``version``/``reason``/``stats``) so the flight recorder and the
    registry timeline render all five families side by side."""

    def __init__(self, kind: str, version: str = "",
                 reason: str = "",
                 stats: Optional[Dict[str, Any]] = None):
        self.kind = kind
        self.version = version
        self.reason = reason
        self.stats = dict(stats or {})
        self.at = time.time()

    def __repr__(self) -> str:
        extra = f", reason={self.reason!r}" if self.reason else ""
        v = f", {self.version!r}" if self.version else ""
        return f"{type(self).__name__}({self.kind}{v}{extra})"


class RetrainEvent(_ControlEvent):
    """Loop + refit lifecycle: ``loop_started``/``loop_stopped``,
    ``triggered``, ``refit_ok``/``refit_failed``, ``circuit_open``/
    ``circuit_closed``, ``trainer_error``."""


class ShadowEvent(_ControlEvent):
    """Shadow validation: ``shadow_pass``/``shadow_fail`` with the full
    gate verdict in ``stats``."""


class PromoteEvent(_ControlEvent):
    """Promotion: ``promote_started`` (gate passed, canary launching)
    and ``promoted`` (cutover complete)."""


class QuarantineEvent(_ControlEvent):
    """A candidate rejected by the gate or rolled back in canary —
    never promoted; ``stats`` carries the verdict summary and the
    evidence bundle stays on ``trainer.quarantined[version]``."""


class TriggerPolicy:
    """When the loop launches a refit.

    - drift floors: a ``DriftMonitor`` summary breaching
      ``max_mean_delta_sigma`` (|mean shift| in fit-time sigma units),
      ``max_var_ratio``, or ``max_null_rate`` triggers.
    - ``watch_slo_alerts``: an active SLO burn-rate alert triggers.
    - ``min_drift_rows``: drift verdicts on fewer observed rows are
      noise, not a trigger.
    - ``min_window_rows``: no refit until the replay window holds at
      least this many labeled rows.
    - ``cooldown_s``: quiet period after any completed cycle (promoted,
      quarantined, or failed) before the next trigger fires.
    """

    def __init__(self, max_mean_delta_sigma: float = 3.0,
                 max_var_ratio: Optional[float] = 16.0,
                 max_null_rate: float = 0.01,
                 watch_slo_alerts: bool = True,
                 min_drift_rows: int = 64,
                 min_window_rows: int = 64,
                 cooldown_s: float = 5.0):
        self.max_mean_delta_sigma = float(max_mean_delta_sigma)
        self.max_var_ratio = (None if max_var_ratio is None
                              else float(max_var_ratio))
        self.max_null_rate = float(max_null_rate)
        self.watch_slo_alerts = bool(watch_slo_alerts)
        self.min_drift_rows = int(min_drift_rows)
        self.min_window_rows = int(min_window_rows)
        self.cooldown_s = float(cooldown_s)


class GatePolicy:
    """The shadow-validation floors a candidate must clear before it
    may even *canary* (the verifyResult discipline applied to refits).

    - ``shadow_rows``: freshest window rows to score both sides on.
    - ``min_rows``: fewer shadow rows than this fails the gate (no
      promote on thin evidence — the decision-timeout discipline).
    - ``max_nan_rate``: non-finite candidate predictions above this
      fraction fail (a NaN-poisoned refit dies here).
    - ``max_divergence``: candidate-vs-baseline disagreement rate
      (classification) or normalized mean absolute delta (regression)
      above this fails — a candidate that rewrites most answers is a
      different model, not a refresh, and needs a human.
    - ``min_quality_delta``: candidate quality minus baseline quality
      (accuracy, or negative RMSE) must be at least this (default
      allows a small regression; a label-flipped refit craters it).
    """

    def __init__(self, shadow_rows: int = 512, min_rows: int = 32,
                 max_nan_rate: float = 0.0,
                 max_divergence: float = 0.5,
                 min_quality_delta: float = -0.02):
        self.shadow_rows = int(shadow_rows)
        self.min_rows = int(min_rows)
        self.max_nan_rate = float(max_nan_rate)
        self.max_divergence = float(max_divergence)
        self.min_quality_delta = float(min_quality_delta)


class RefitPolicy:
    """Fault tolerance of the refit step itself.

    - ``max_attempts`` / ``backoff_s`` (doubling): transient refit
      failures retry with backoff inside one cycle.
    - ``circuit_after``: consecutive FAILED CYCLES that open the
      circuit — the loop stops trying (state ``degraded``, serving
      continues frozen) until ``circuit_reset_s`` elapses, then
      half-opens for one probe cycle.
    """

    def __init__(self, max_attempts: int = 3, backoff_s: float = 0.2,
                 circuit_after: int = 3,
                 circuit_reset_s: float = 30.0):
        self.max_attempts = max(1, int(max_attempts))
        self.backoff_s = float(backoff_s)
        self.circuit_after = max(1, int(circuit_after))
        self.circuit_reset_s = float(circuit_reset_s)


class IngestDriver:
    """Feeds micro-batches from a chunk source into a ``ReplayWindow``
    on its own daemon thread — the live labeled-data stream of the
    continuous loop (labels arrive out of band of serving traffic).

    ``source`` is a zero-arg factory of chunks (the ``ChunkedTable``
    factory contract) or a ``ChunkedTable``; ``interval_s`` paces the
    feed. The driver loops the source when ``loop=True`` (soak
    harnesses) and stops at stream end otherwise."""

    def __init__(self, source: Any, window: ReplayWindow,
                 interval_s: float = 0.0, loop: bool = False,
                 on_chunk: Optional[Callable[[Any], None]] = None):
        if isinstance(source, ChunkedTable):
            self._factory = source._factory
        elif callable(source):
            self._factory = source
        else:
            raise TypeError("IngestDriver needs a ChunkedTable or a "
                            "zero-arg chunk factory")
        self.window = window
        self.interval_s = float(interval_s)
        self.loop = bool(loop)
        self.on_chunk = on_chunk
        self.chunks_fed = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "IngestDriver":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="controlplane-ingest")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            for chunk in self._factory():
                if self._stop.is_set():
                    return
                self.window.append(chunk)
                self.chunks_fed += 1
                if self.on_chunk is not None:
                    try:
                        self.on_chunk(chunk)
                    except Exception:  # noqa: BLE001 — observer only
                        pass
                if self.interval_s > 0:
                    self._stop.wait(self.interval_s)
            if not self.loop:
                return

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)


class ContinuousTrainer:
    """The long-running control loop on one ``ServingEngine``.

    ``refit`` is the model-family hook: a callable
    ``(window: ChunkedTable, active_pipeline) -> candidate_pipeline``
    that runs the incremental update (``partial_fit`` for linear
    models, ``boost_more`` for GBDT) over the replay window and wraps
    the result for serving (e.g. ``json_scoring_pipeline``). It runs
    ONLY on the trainer thread.

    Recovery is idempotent: version names are derived from the
    registry (``{prefix}-N`` past the highest already registered), so
    a trainer restarted after an engine crash resumes the sequence
    instead of colliding; ``state_dict()``/``load_state()`` carry the
    counters and quarantine verdicts across restarts.
    """

    history_cap = 1024

    def __init__(self, engine, refit: Callable[[ChunkedTable, Any], Any],
                 window: Optional[ReplayWindow] = None,
                 registry: Optional[ModelRegistry] = None,
                 drift_monitor: Any = None,
                 triggers: Optional[TriggerPolicy] = None,
                 gate: Optional[GatePolicy] = None,
                 refit_policy: Optional[RefitPolicy] = None,
                 canary: Optional[CanaryPolicy] = None,
                 warmup_example: Any = None,
                 version_prefix: str = "ct",
                 poll_interval_s: float = 0.25,
                 features_col: str = "features",
                 label_col: str = "label",
                 predict_fn: Optional[Callable] = None,
                 quality_fn: Optional[Callable] = None,
                 state: Optional[Dict[str, Any]] = None):
        self.engine = engine
        self.refit = refit
        self.window = window if window is not None else ReplayWindow()
        self.registry = registry if registry is not None \
            else ModelRegistry()
        # None = resolve dynamically from the ACTIVE pipeline at every
        # check (serving/fleet.py attaches the monitor the serving path
        # observes into) — so a promoted candidate carrying a fresh
        # monitor rebuilt from the window takes over the watch
        self.drift_monitor = drift_monitor
        self.triggers = triggers or TriggerPolicy()
        self.gate = gate or GatePolicy()
        self.refit_policy = refit_policy or RefitPolicy()
        self.canary = canary or CanaryPolicy()
        self.warmup_example = warmup_example
        self.version_prefix = str(version_prefix)
        self.poll_interval_s = float(poll_interval_s)
        self.features_col = features_col
        self.label_col = label_col
        self.predict_fn = predict_fn
        self.quality_fn = quality_fn

        self.state = IDLE
        self.history: List[_ControlEvent] = []
        self.quarantined: Dict[str, Dict[str, Any]] = {}
        self.refits = 0
        self.refit_failures = 0
        self.promotions = 0
        self.quarantines = 0
        self.cycles = 0
        self.consecutive_failures = 0
        self.circuit_open = False
        self.last_trigger: Optional[str] = None
        self._version_counter = 0
        self._cooldown_until = 0.0
        self._circuit_opened_at = 0.0
        self._forced_trigger: Optional[str] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._die = threading.Event()    # chaos: abrupt thread death
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self._stopped = False
        self._hists = controlplane_histograms()
        if state:
            self.load_state(state)

    # -- state persistence / idempotent recovery ----------------------------

    def state_dict(self) -> Dict[str, Any]:
        """Loop state that survives an engine restart (verdicts only —
        bundles and pipelines stay with the process that made them)."""
        with self._lock:
            return {
                "version_counter": self._version_counter,
                "refits": self.refits,
                "refit_failures": self.refit_failures,
                "promotions": self.promotions,
                "quarantines": self.quarantines,
                "cycles": self.cycles,
                "consecutive_failures": self.consecutive_failures,
                "circuit_open": self.circuit_open,
                "quarantined": {v: {"verdict": q.get("verdict"),
                                    "at": q.get("at")}
                                for v, q in self.quarantined.items()},
            }

    def load_state(self, state: Dict[str, Any]) -> None:
        with self._lock:
            self._version_counter = max(
                self._version_counter,
                int(state.get("version_counter", 0)))
            self.refits = int(state.get("refits", self.refits))
            self.refit_failures = int(
                state.get("refit_failures", self.refit_failures))
            self.promotions = int(
                state.get("promotions", self.promotions))
            self.quarantines = int(
                state.get("quarantines", self.quarantines))
            self.cycles = int(state.get("cycles", self.cycles))
            self.consecutive_failures = int(
                state.get("consecutive_failures",
                          self.consecutive_failures))
            self.circuit_open = bool(
                state.get("circuit_open", self.circuit_open))
            if self.circuit_open:
                self._circuit_opened_at = time.monotonic()
            for v, q in dict(state.get("quarantined", {})).items():
                self.quarantined.setdefault(v, dict(q))

    def _sync_version_counter(self) -> None:
        """Fast-forward the version counter past every ``{prefix}-N``
        already in the registry — restart-idempotent version naming."""
        prefix = self.version_prefix + "-"
        highest = 0
        for v in self.registry.versions():
            if v.startswith(prefix):
                try:
                    highest = max(highest, int(v[len(prefix):]))
                except ValueError:
                    continue
        with self._lock:
            self._version_counter = max(self._version_counter, highest)

    def _next_version(self) -> str:
        with self._lock:
            self._version_counter += 1
            n = self._version_counter
        return f"{self.version_prefix}-{n}"

    # -- lifecycle ----------------------------------------------------------

    def _recorder_key(self) -> str:
        return f"controlplane@{self.engine.source.address}"

    def start(self) -> "ContinuousTrainer":
        if self._started:
            return self
        self._started = True
        self._sync_version_counter()
        # register the baseline version so previous()/rollback anchors
        # exist even before the first promote
        base = self.engine._active
        if base.version not in self.registry.versions():
            try:
                self.registry.register(base.version, base.pipeline,
                                       metadata={"baseline": True})
            except ValueError:
                pass    # registered concurrently — fine
        self.engine.controlplane = self
        self.engine.source.controlplane_probe = self.status
        rec = getattr(self.engine, "flight_recorder", None)
        if rec is not None:
            key = self._recorder_key()
            # quarantine/rollback bundles carry the loop's own decision
            # timeline + status (the gate verdict travels in both)
            rec.add_event_source(f"{key}:events", lambda: self.history)
            rec.add_stats_source(key, self.status)
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=_TRAINER_THREAD_NAME)
        self._transition(IDLE, RetrainEvent(
            "loop_started", reason="continuous training loop up",
            stats={"window_rows": self.window.rows}))
        self._thread.start()
        return self

    def stop(self) -> None:
        if not self._started or self._stopped:
            return
        self._stopped = True
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
        rec = getattr(self.engine, "flight_recorder", None)
        if rec is not None:
            try:
                rec.detach(self._recorder_key())
            except Exception:  # noqa: BLE001 — best-effort detach
                pass
        self._transition(STOPPED, RetrainEvent(
            "loop_stopped", stats={"cycles": self.cycles,
                                   "promotions": self.promotions,
                                   "quarantines": self.quarantines}))

    def kill_trainer(self) -> None:
        """Chaos hook: make the trainer thread die abruptly (no
        transition, no cleanup) — the training-death drill. Serving
        must continue frozen; ``/healthz`` shows the control plane
        degraded."""
        self._die.set()

    # -- ingest -------------------------------------------------------------

    def ingest(self, chunk: Any) -> None:
        """Append one labeled micro-batch to the replay window (the
        inline alternative to an ``IngestDriver``)."""
        self.window.append(chunk)

    # -- the transition funnel (audited) ------------------------------------

    def _transition(self, state: str, event: _ControlEvent) -> None:
        """THE single state-write funnel: every loop state change lands
        its typed event on the registry timeline in the same breath.
        ``check_control_loop`` (testing/fusion_check.py) rejects
        any ``self.state`` write outside this method and any
        ``_transition`` body that stops recording."""
        with self._lock:
            self.state = state
        self._record(event)

    def _record(self, event: _ControlEvent) -> None:
        self.history.append(event)
        if len(self.history) > self.history_cap:
            del self.history[:len(self.history) - self.history_cap]
        try:
            self.registry.record_event(event)
        except Exception:  # noqa: BLE001 — the loop never dies on a
            pass           # full/broken audit log

    # -- triggers -----------------------------------------------------------

    def trigger_now(self, reason: str = "manual") -> None:
        """Queue one cycle regardless of drift/SLO state (the loop
        still runs it on the trainer thread, through the same gate)."""
        self._forced_trigger = reason

    def _monitor(self) -> Any:
        if self.drift_monitor is not None:
            return self.drift_monitor
        return getattr(self.engine._active.pipeline,
                       "drift_monitor", None)

    def _check_triggers(self) -> Optional[str]:
        forced = self._forced_trigger
        if forced is not None:
            self._forced_trigger = None
            return f"forced:{forced}"
        tp = self.triggers
        mon = self._monitor()
        if mon is not None:
            try:
                s = mon.summary()
            except Exception:  # noqa: BLE001 — a sick monitor must not
                s = {"rows": 0}  # kill the loop
            if s.get("rows", 0) >= tp.min_drift_rows:
                delta = s.get("max_abs_mean_delta_sigma", 0.0)
                if delta >= tp.max_mean_delta_sigma:
                    return (f"drift:mean_delta_sigma={delta:.2f}"
                            f">={tp.max_mean_delta_sigma:.2f}"
                            f" (feature={s.get('worst_feature')})")
                ratio = s.get("max_var_ratio", 1.0)
                if tp.max_var_ratio is not None and \
                        ratio >= tp.max_var_ratio:
                    return (f"drift:var_ratio={ratio:.2f}"
                            f">={tp.max_var_ratio:.2f}")
                nulls = s.get("null_rate", 0.0)
                if nulls >= tp.max_null_rate > 0:
                    return (f"drift:null_rate={nulls:.4f}"
                            f">={tp.max_null_rate:.4f}")
        slo = getattr(self.engine, "slo", None)
        if tp.watch_slo_alerts and slo is not None:
            try:
                active = slo.alerts.active()
            except Exception:  # noqa: BLE001
                active = []
            if active:
                a = active[0]
                return (f"slo:{a.name} burn_short={a.burn_short:.1f} "
                        f"burn_long={a.burn_long:.1f}")
        return None

    # -- the loop (trainer thread only) -------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            if self._die.is_set():
                return    # chaos: abrupt death, no cleanup
            try:
                self._tick()
            except Exception as e:  # noqa: BLE001 — the loop survives
                # anything a cycle throws past its own handling
                log.warning("controlplane tick error: %s", e)
                self._record(RetrainEvent(
                    "trainer_error", reason=f"{type(e).__name__}: {e}"))
            self._stop.wait(self.poll_interval_s)

    def _tick(self) -> None:
        now = time.monotonic()
        if self.circuit_open:
            rp = self.refit_policy
            if now - self._circuit_opened_at < rp.circuit_reset_s:
                return
            # half-open: allow one probe cycle
            self.circuit_open = False
            self._transition(IDLE, RetrainEvent(
                "circuit_closed",
                reason=f"half-open probe after "
                       f"{rp.circuit_reset_s:.0f}s"))
        if now < self._cooldown_until:
            return
        if self.window.rows < self.triggers.min_window_rows:
            return
        reason = self._check_triggers()
        if reason is None:
            return
        self.last_trigger = reason
        self._cycle(reason)
        self._cooldown_until = time.monotonic() + \
            self.triggers.cooldown_s

    def _cycle(self, reason: str) -> None:
        """One full drift->refit->shadow->canary cycle. Runs on the
        trainer thread only (allowlisted in check_control_loop)."""
        self.cycles += 1
        version = self._next_version()
        snapshot = self.window.snapshot()
        self._transition(REFITTING, RetrainEvent(
            "triggered", version=version, reason=reason,
            stats={"window_rows": snapshot.num_rows}))
        baseline = self.engine._active
        t0 = time.perf_counter()
        try:
            candidate = self._run_refit(snapshot, baseline.pipeline)
        except Exception as e:  # noqa: BLE001 — a refit that exhausted
            # its retries fails the CYCLE, not the loop (and never
            # touches serving)
            self.refit_failures += 1
            self.consecutive_failures += 1
            fail = RetrainEvent(
                "refit_failed", version=version,
                reason=f"{type(e).__name__}: {e}",
                stats={"attempts": self.refit_policy.max_attempts,
                       "consecutive_failures":
                           self.consecutive_failures})
            if self.consecutive_failures >= \
                    self.refit_policy.circuit_after:
                self.circuit_open = True
                self._circuit_opened_at = time.monotonic()
                self._record(fail)
                self._transition(DEGRADED, RetrainEvent(
                    "circuit_open",
                    reason=f"{self.consecutive_failures} consecutive "
                           f"refit failures; serving frozen model "
                           f"{baseline.version}",
                    stats={"frozen_version": baseline.version}))
            else:
                self._transition(IDLE, fail)
            return
        self.refits += 1
        self.consecutive_failures = 0
        refit_ms = (time.perf_counter() - t0) * 1000.0
        self._hists["refit"].observe(refit_ms)
        self._transition(SHADOWING, RetrainEvent(
            "refit_ok", version=version,
            stats={"refit_ms": round(refit_ms, 2),
                   "window_rows": snapshot.num_rows}))
        verdict = self._shadow_and_gate(candidate, baseline.pipeline,
                                        version)
        if not verdict["pass"]:
            # the failing verdict lands on the timeline as its own
            # ShadowEvent before the quarantine that follows it
            self._record(ShadowEvent("shadow_fail", version=version,
                                     stats=verdict))
            self._quarantine(version, verdict)
            return
        self._record(ShadowEvent("shadow_pass", version=version,
                                 stats=verdict))
        # gate passed: register + canary. Registration happens BEFORE
        # the swap so the registry can answer previous() for rollback
        # and the timeline shows intent even if the canary breaches.
        try:
            self.registry.register(version, candidate,
                                   metadata={"trigger": reason,
                                             "gate": verdict})
        except ValueError:
            pass    # already registered (restart replay) — idempotent
        self._transition(PROMOTING, PromoteEvent(
            "promote_started", version=version, reason="gate_pass",
            stats={"divergence": verdict["divergence"],
                   "quality_delta": verdict["quality_delta"]}))
        t1 = time.perf_counter()
        result = execute_swap(self.engine, candidate, version,
                              warmup_example=self.warmup_example,
                              policy=self.canary,
                              registry=self.registry)
        self._hists["promote"].observe(
            (time.perf_counter() - t1) * 1000.0)
        if result.completed:
            self.promotions += 1
            # restart the drift watch: if the refit hook attached a
            # fresh monitor to the candidate this resets a clean slate;
            # if the old monitor is still active, clearing its running
            # stats stops the SAME shift re-triggering every cooldown
            mon = self._monitor()
            if mon is not None and callable(getattr(mon, "reset",
                                                    None)):
                mon.reset()
            self._transition(IDLE, PromoteEvent(
                "promoted", version=version,
                stats={"swap": result.event.stats}))
        else:
            # the canary's auto-rollback already restored the stable
            # version; quarantine the candidate with the swap evidence
            verdict = dict(verdict)
            verdict.update({"pass": False,
                            "reason": f"canary:{result.reason}",
                            "swap_stats": result.event.stats})
            self._quarantine(version, verdict)

    def _run_refit(self, snapshot: ChunkedTable,
                   active_pipeline: Any) -> Any:
        """The incremental refit with bounded retries + backoff.
        Trainer thread only (allowlisted)."""
        rp = self.refit_policy
        delay = rp.backoff_s
        last: Optional[BaseException] = None
        for attempt in range(rp.max_attempts):
            if self._stop.is_set() or self._die.is_set():
                break
            try:
                candidate = self.refit(snapshot, active_pipeline)
                if candidate is None:
                    raise ValueError("refit returned None")
                return candidate
            except Exception as e:  # noqa: BLE001 — retried, then
                last = e            # surfaced to _cycle
                log.warning("refit attempt %d/%d failed: %s",
                            attempt + 1, rp.max_attempts, e)
                if attempt + 1 < rp.max_attempts:
                    self._stop.wait(delay)
                    delay *= 2
        raise last if last is not None else \
            RuntimeError("refit aborted")

    # -- shadow scoring + the gate ------------------------------------------

    def _predict(self, pipeline: Any, X: np.ndarray) -> np.ndarray:
        if self.predict_fn is not None:
            return np.asarray(self.predict_fn(pipeline, X))
        model = getattr(pipeline, "model", None)
        if model is not None:
            p = getattr(model, "predict", None)
            if callable(p):
                return np.asarray(p(X))
            tr = getattr(model, "transform", None)
            if callable(tr):
                from mmlspark_tpu_torch.core.table import DataTable
                fcol = self.features_col
                get_f = getattr(model, "get_features_col", None)
                if callable(get_f):
                    try:
                        fcol = get_f()
                    except Exception:  # noqa: BLE001
                        pass
                out = tr(DataTable({fcol: np.asarray(X)}))
                pcol = "prediction"
                get_p = getattr(model, "get_prediction_col", None)
                if callable(get_p):
                    try:
                        pcol = get_p()
                    except Exception:  # noqa: BLE001
                        pass
                return np.asarray(out[pcol])
        p = getattr(pipeline, "predict", None)
        if callable(p):
            return np.asarray(p(X))
        raise ValueError(
            "cannot shadow-score this pipeline: expose .model with "
            "predict/transform, a .predict, or pass predict_fn=")

    def _quality(self, pred: np.ndarray, y: np.ndarray,
                 classification: bool) -> float:
        if self.quality_fn is not None:
            return float(self.quality_fn(pred, y))
        pred = np.asarray(pred, dtype=np.float64).ravel()[:len(y)]
        finite = np.isfinite(pred)
        if classification:
            # non-finite predictions count as wrong, not as absent
            return float(np.mean((pred == y) & finite))
        err = np.where(finite, pred - y, np.inf)
        return -float(np.sqrt(np.mean(err ** 2)))

    def _shadow_and_gate(self, candidate: Any, baseline: Any,
                         version: str) -> Dict[str, Any]:
        """Score candidate vs baseline on the freshest window rows and
        compute the gate verdict. Trainer thread only (allowlisted).
        Never raises: an exception IS a failing verdict."""
        g = self.gate
        t0 = time.perf_counter()
        tracer = getattr(self.engine, "tracer", None)
        try:
            from mmlspark_tpu_torch.core.table import DataTable
            chunks = self.window.tail(g.shadow_rows)
            if not chunks:
                return {"pass": False, "reason": "gate:no_shadow_rows",
                        "shadow_rows": 0, "divergence": None,
                        "nan_rate": None, "quality_delta": None}
            tail = chunks[0] if len(chunks) == 1 \
                else DataTable.concat(chunks)
            from mmlspark_tpu_torch.core.table import features_matrix
            X = features_matrix(tail, self.features_col)
            y = np.asarray(tail[self.label_col], dtype=np.float64) \
                if self.label_col in tail else None
            if len(X) > g.shadow_rows:
                X = X[-g.shadow_rows:]
                if y is not None:
                    y = y[-g.shadow_rows:]

            def score() -> Dict[str, Any]:
                pc = np.asarray(self._predict(candidate, X),
                                dtype=np.float64).ravel()[:len(X)]
                pb = np.asarray(self._predict(baseline, X),
                                dtype=np.float64).ravel()[:len(X)]
                return {"pc": pc, "pb": pb}

            if tracer is not None:
                with tracer.trace_block(
                        "controlplane.shadow",
                        attrs={"candidate": version,
                               "rows": int(len(X))}):
                    preds = score()
            else:
                preds = score()
            pc, pb = preds["pc"], preds["pb"]
            self._hists["shadow"].observe(
                (time.perf_counter() - t0) * 1000.0)

            t1 = time.perf_counter()
            nan_rate = float(np.mean(~np.isfinite(pc))) if len(pc) \
                else 1.0
            classification = bool(
                y is not None and
                np.allclose(y, np.round(y), atol=1e-9))
            finite_both = np.isfinite(pc) & np.isfinite(pb)
            if classification:
                # disagreement rate; a non-finite candidate answer
                # disagrees by definition
                divergence = float(np.mean(
                    (pc != pb) | ~np.isfinite(pc)))
            else:
                scale = float(np.std(pb[finite_both])) if \
                    finite_both.any() else 0.0
                diff = np.abs(np.where(np.isfinite(pc), pc, np.inf)
                              - pb)
                divergence = float(np.mean(diff)) / (scale + 1e-9)
            verdict: Dict[str, Any] = {
                "shadow_rows": int(len(X)),
                "nan_rate": round(nan_rate, 6),
                "divergence": round(divergence, 6),
                "classification": classification,
            }
            if y is not None:
                qc = self._quality(pc, y, classification)
                qb = self._quality(pb, y, classification)
                verdict.update(
                    quality_candidate=round(qc, 6),
                    quality_baseline=round(qb, 6),
                    quality_delta=round(qc - qb, 6))
            else:
                verdict.update(quality_candidate=None,
                               quality_baseline=None,
                               quality_delta=None)
            # floors, most-specific first — the verdict names exactly
            # which floor failed with observed-vs-threshold values (the
            # rollback-reason discipline)
            if len(X) < g.min_rows:
                verdict.update(
                    **{"pass": False},
                    reason=f"gate:thin_evidence rows={len(X)}"
                           f"<{g.min_rows}")
            elif nan_rate > g.max_nan_rate:
                verdict.update(
                    **{"pass": False},
                    reason=f"gate:nan_rate={nan_rate:.4f}"
                           f">{g.max_nan_rate:.4f}")
            elif verdict["quality_delta"] is not None and \
                    verdict["quality_delta"] < g.min_quality_delta:
                verdict.update(
                    **{"pass": False},
                    reason=f"gate:quality_delta="
                           f"{verdict['quality_delta']:.4f}"
                           f"<{g.min_quality_delta:.4f} (candidate "
                           f"{verdict['quality_candidate']} vs "
                           f"baseline {verdict['quality_baseline']})")
            elif divergence > g.max_divergence:
                verdict.update(
                    **{"pass": False},
                    reason=f"gate:divergence={divergence:.4f}"
                           f">{g.max_divergence:.4f}")
            else:
                verdict.update(**{"pass": True}, reason="gate:pass")
            self._hists["gate"].observe(
                (time.perf_counter() - t1) * 1000.0)
            return verdict
        except Exception as e:  # noqa: BLE001 — a shadow that cannot
            # score is a FAILING verdict, never a promoted unknown
            return {"pass": False,
                    "reason": f"gate:shadow_error "
                              f"{type(e).__name__}: {e}",
                    "shadow_rows": 0, "divergence": None,
                    "nan_rate": None, "quality_delta": None}

    # -- quarantine ---------------------------------------------------------

    def _quarantine(self, version: str,
                    verdict: Dict[str, Any]) -> None:
        """Reject the candidate, keep the evidence: QuarantineEvent on
        the timeline (verdict in ``stats``), then a flight-recorder
        bundle captured AFTER the event lands so the bundle's own
        timeline contains the verdict it documents."""
        self.quarantines += 1
        reason = str(verdict.get("reason", "gate:fail"))
        stats = {k: v for k, v in verdict.items()
                 if isinstance(v, (int, float, str, bool))
                 or v is None}
        self._transition(IDLE, QuarantineEvent(
            "quarantined", version=version, reason=reason,
            stats=stats))
        bundle = None
        rec = getattr(self.engine, "flight_recorder", None)
        if rec is not None:
            try:
                bundle = rec.dump_bundle(
                    reason=f"quarantine:{version}:{reason}")
            except Exception:  # noqa: BLE001 — evidence is
                bundle = None  # best-effort
            try:
                rec.trigger(f"quarantine:{version}:{reason}")
            except Exception:  # noqa: BLE001
                pass
        self.quarantined[version] = {
            "verdict": verdict, "bundle": bundle, "at": time.time()}
        log.warning("candidate %s QUARANTINED: %s", version, reason)

    # -- observability ------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """The /healthz ``controlplane`` block: loop state, health, and
        counters. ``degraded`` is True while training is unhealthy —
        circuit open or trainer thread dead — with serving frozen."""
        t = self._thread
        alive = bool(t is not None and t.is_alive())
        with self._lock:
            state = self.state
            counter = self._version_counter
        degraded = bool(
            self._started and not self._stopped
            and (self.circuit_open or not alive))
        now = time.monotonic()
        return {
            "state": state,
            "degraded": degraded,
            "trainer_alive": alive,
            "circuit_open": self.circuit_open,
            "cycles": self.cycles,
            "refits": self.refits,
            "refit_failures": self.refit_failures,
            "consecutive_failures": self.consecutive_failures,
            "promotions": self.promotions,
            "quarantines": self.quarantines,
            "version_counter": counter,
            "last_trigger": self.last_trigger,
            "cooldown_remaining_s": round(
                max(0.0, self._cooldown_until - now), 3),
            "window": self.window.stats(),
        }
