"""Versioned model lifecycle: registry, hot swap, canary, rollback.

The port's copy of ``mmlspark_tpu/serving/lifecycle.py``: a
``ModelRegistry`` of version-tagged pipelines and an atomic swap
protocol on ``ServingEngine`` / ``ServingFleet``, so a model refreshed
by ``Booster.boost_more`` replaces the live one without dropping
traffic. Host Python over the port's scorers; the incoming pipeline's
``warmup`` hook runs its device work (the scorers' bucket warm-up) on a
daemon thread beside the engine's workers.

Swap state machine (exported as ``engine.swap_state``):

    idle -> warming -> canary -> draining -> idle      (completed)
                 \\         \\
                  +-> rolled_back (warmup failed/stalled, canary breach,
                      decision timeout, engine death)

- **warming**: the incoming pipeline's ``warmup`` hook runs every
  serving shape bucket OFF the hot path (on a sacrificial thread with a
  timeout — a stalled warmup rolls the swap back instead of wedging
  it). No bucket is first seen on the hot path after cutover.
- **canary**: the batcher routes ``CanaryPolicy.fraction`` of
  micro-batches to the incoming version. Every batch carries its
  ``PipelineHandle``, so no reply batch ever mixes versions. A failing
  canary batch is *rescued* — re-executed on the stable version — so
  clients never eat a canary's faults; the failure still counts against
  the canary through a ``CircuitBreaker`` (consecutive-failure AND
  window-failure-rate breach, the same machinery the fleet client uses
  per engine). Latency is watched through per-version
  ``LatencyHistogram``s: a canary p50 beyond ``latency_ratio`` x the
  stable p50 is also a breach.
- **draining**: cutover is ONE attribute store (``engine._active``);
  batches already dispatched on the old handle drain on the old
  version (its ``outstanding`` count reaching zero ends the phase).
- **rolled_back** surfaces a typed ``SwapEvent`` carrying the reason
  and the canary stats at the moment of the decision, and triggers the
  engine's flight recorder (``swap_rollback:...``).

``ServingFleet.rolling_swap`` runs the protocol engine-by-engine,
pausing while the fleet shows failover pressure (open circuits), and
stops marching a version that rolled back anywhere. Shadow validation
lives in ``serving/controlplane.py``, which drives ``execute_swap``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.core.metrics import LatencyHistogram
from mmlspark_tpu_torch.serving.server import PipelineHandle, ServingEngine
from mmlspark_tpu_torch.utils.resilience import CircuitBreaker

log = get_logger("serving.lifecycle")

# swap_state values (engine.swap_state / healthz)
IDLE = "idle"
WARMING = "warming"
CANARY = "canary"
DRAINING = "draining"
ROLLED_BACK = "rolled_back"


class SwapInProgress(RuntimeError):
    """A second swap was requested while one is already running."""


class SwapEvent:
    """Typed lifecycle event: one completed or rolled-back swap.

    Carries each side's serving precision (f32/int8) and the incoming
    model's AOT flag, so a rollout to a quantized or AOT-loaded model
    is auditable from the event log alone — and a canary that compared
    int8 against f32 is visible as exactly that."""

    def __init__(self, kind: str, from_version: str, to_version: str,
                 reason: str = "", stats: Optional[Dict[str, Any]] = None,
                 from_precision: str = "f32", to_precision: str = "f32",
                 from_aot: bool = False, to_aot: bool = False):
        self.kind = kind                    # 'completed' | 'rolled_back'
        self.from_version = from_version
        self.to_version = to_version
        self.reason = reason
        self.stats = dict(stats or {})
        self.from_precision = str(from_precision)
        self.to_precision = str(to_precision)
        self.from_aot = bool(from_aot)
        self.to_aot = bool(to_aot)
        self.at = time.time()

    def __repr__(self) -> str:
        extra = f", reason={self.reason!r}" if self.reason else ""
        if (self.from_precision != self.to_precision
                or self.from_aot != self.to_aot):
            extra += (f", {self.from_precision}"
                      f"{'+aot' if self.from_aot else ''} -> "
                      f"{self.to_precision}"
                      f"{'+aot' if self.to_aot else ''}")
        return (f"SwapEvent({self.kind}, {self.from_version!r} -> "
                f"{self.to_version!r}{extra})")


class SwapResult:
    """What ``engine.swap`` returns: the outcome plus its event."""

    def __init__(self, completed: bool, event: SwapEvent):
        self.completed = completed
        self.rolled_back = not completed
        self.event = event
        self.reason = event.reason

    def __repr__(self) -> str:
        state = "completed" if self.completed else "rolled_back"
        return f"SwapResult({state}, {self.event!r})"


class CanaryPolicy:
    """Rollback-policy knobs for one swap.

    - ``fraction``: share of micro-batches routed to the incoming
      version during the canary phase (0 disables the canary — direct
      cutover after warmup).
    - ``min_batches``: clean canary batches required to promote.
    - ``consecutive_failures`` / ``error_rate`` (+ ``min_calls``,
      ``window``): the CircuitBreaker breach thresholds — either
      N failures in a row, or the windowed failure rate, rolls back.
    - ``latency_ratio``: canary p50 beyond this multiple of the stable
      p50 (after ``min_batches`` canary observations AND at least as
      many stable ones) is a breach; ``None`` disables the check.
    - ``decision_timeout_s``: no promote/breach decision within this
      wall budget rolls back (the safe default — e.g. an engine killed
      mid-swap stops producing canary observations).
    - ``warmup_timeout_s``: warmup hook budget; a stalled warmup rolls
      back instead of wedging the swap.
    - ``drain_timeout_s``: bound on waiting for old-version in-flight
      batches after cutover (expiry logs; cutover already happened).
    """

    def __init__(self, fraction: float = 0.25, min_batches: int = 8,
                 consecutive_failures: int = 3,
                 error_rate: float = 0.34, min_calls: int = 3,
                 window: int = 20,
                 latency_ratio: Optional[float] = None,
                 decision_timeout_s: float = 30.0,
                 warmup_timeout_s: float = 60.0,
                 drain_timeout_s: float = 30.0):
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1]: {fraction}")
        self.fraction = float(fraction)
        self.min_batches = int(min_batches)
        self.consecutive_failures = int(consecutive_failures)
        self.error_rate = float(error_rate)
        self.min_calls = int(min_calls)
        self.window = int(window)
        self.latency_ratio = latency_ratio
        self.decision_timeout_s = float(decision_timeout_s)
        self.warmup_timeout_s = float(warmup_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)


class ModelRegistry:
    """Version-tagged model store feeding the swap protocol.

    Versions are insertion-ordered; ``previous(v)`` answers "what do we
    roll back to" and the registry records every ``SwapEvent`` handed
    to ``record_event`` so ops can audit the lifecycle history.
    ``events`` keeps the newest ``events_cap`` records — swaps alone
    would never fill it, but the model zoo logs every
    activate/evict on the same timeline, and a churning cache in an
    always-on process must not grow the audit log forever.
    Thread-safe."""

    events_cap = 4096

    def __init__(self):
        self._versions: Dict[str, Any] = {}
        self._order: List[str] = []
        self._meta: Dict[str, Dict[str, Any]] = {}
        self.events: List[SwapEvent] = []
        self._lock = threading.Lock()

    def register(self, version: str, pipeline: Any,
                 metadata: Optional[Dict[str, Any]] = None) -> None:
        from mmlspark_tpu_torch.core.quantize import stage_precision
        meta = dict(metadata or {})
        # precision/aot recorded at registration (explicit metadata
        # wins): the registry is the audit trail a quantized/AOT
        # rollout is traced back through
        meta.setdefault("precision", stage_precision(pipeline))
        meta.setdefault("aot", bool(getattr(pipeline, "aot", False)))
        with self._lock:
            if version in self._versions:
                raise ValueError(f"version {version!r} already registered")
            self._versions[version] = pipeline
            self._order.append(version)
            self._meta[version] = meta

    def get(self, version: str) -> Any:
        with self._lock:
            if version not in self._versions:
                raise KeyError(f"unknown model version {version!r}; "
                               f"have {self._order}")
            return self._versions[version]

    def _entry_locked(self, version: str
                      ) -> "Tuple[Any, str, Dict[str, Any]]":
        """(served object, state, metadata) for one version — caller
        holds ``self._lock``. Base registries hold materialized
        pipelines, so state is always ``"registered"``; ``ModelZoo``
        overrides this with its load/evict lifecycle (and a
        ``PipelineHandle`` in the first slot when resident)."""
        return (self._versions[version], "registered",
                dict(self._meta.get(version, {})))

    def lookup(self, version: str) -> "Tuple[Any, str, Dict[str, Any]]":
        """ONE consistent ``(handle, state, metadata)`` triple under
        the registry lock — the ``engine._lifecycle_snapshot``
        discipline applied to registry reads. A reader racing a
        concurrent register/load/evict must never see a half-updated
        entry (e.g. state ``resident`` with no handle, or metadata
        from a different lifecycle step than the state)."""
        with self._lock:
            if version not in self._versions:
                raise KeyError(f"unknown model version {version!r}; "
                               f"have {self._order}")
            return self._entry_locked(version)

    def list(self) -> List[Dict[str, Any]]:
        """Every version's ``{version, state, metadata, loaded}`` as
        ONE consistent snapshot under the registry lock, in insertion
        order (the ``lookup`` consistency contract, registry-wide)."""
        with self._lock:
            out = []
            for v in self._order:
                obj, state, meta = self._entry_locked(v)
                out.append({"version": v, "state": state,
                            "metadata": meta,
                            "loaded": obj is not None})
            return out

    def metadata(self, version: str) -> Dict[str, Any]:
        with self._lock:
            return dict(self._meta.get(version, {}))

    def versions(self) -> List[str]:
        with self._lock:
            return list(self._order)

    def latest(self) -> str:
        with self._lock:
            if not self._order:
                raise KeyError("registry is empty")
            return self._order[-1]

    def previous(self, version: str) -> Optional[str]:
        with self._lock:
            if version not in self._order:
                return None
            i = self._order.index(version)
            return self._order[i - 1] if i > 0 else None

    def record_event(self, event: SwapEvent) -> None:
        with self._lock:
            self.events.append(event)
            if len(self.events) > self.events_cap:
                del self.events[:len(self.events) - self.events_cap]


class SwapController:
    """The canary-phase brain: routes a fraction of batches to the
    incoming handle, scores every canary outcome through a
    CircuitBreaker + per-version latency histograms, and resolves to
    'promote' or 'breach:<reason>'. Installed on the engine as
    ``_swap_ctl`` for the duration of the canary phase only."""

    def __init__(self, stable: PipelineHandle, canary: PipelineHandle,
                 policy: CanaryPolicy):
        self.stable = stable
        self.canary = canary
        self.policy = policy
        # breach detector: consecutive failures OR windowed failure
        # rate — identical machinery to the fleet's per-engine breakers
        self.breaker = CircuitBreaker(
            failure_threshold=policy.consecutive_failures,
            failure_rate=policy.error_rate,
            window=policy.window, min_calls=policy.min_calls,
            cooldown=3600.0,          # a tripped canary never half-opens
            name=f"canary:{canary.version}")
        self.canary_hist = LatencyHistogram()
        self.stable_hist = LatencyHistogram()
        self.canary_ok = 0
        self.canary_failed = 0
        self.canary_row_errors = 0
        self.last_error: Optional[str] = None
        # deterministic fractional pacing (error-diffusion accumulator):
        # the long-run canary share equals ``fraction`` EXACTLY for any
        # value in (0, 1] — a rounded stride would send 100% of traffic
        # to the canary for any fraction above 2/3, and a random draw
        # could starve a low-fraction canary for a long unlucky streak
        self._acc = 0.0
        self._lock = threading.Lock()
        self._decided = threading.Event()
        self.decision: Optional[str] = None    # 'promote' | 'breach:...'
        canary.controller = self
        canary.rescue_to = stable

    # -- routing (batcher thread) -------------------------------------------

    def route(self, active: PipelineHandle) -> PipelineHandle:
        if self._decided.is_set() or self.policy.fraction <= 0:
            return active
        with self._lock:
            self._acc += self.policy.fraction
            take = self._acc >= 1.0
            if take:
                self._acc -= 1.0
        return self.canary if take else active

    # -- outcome scoring (worker threads) -----------------------------------

    def observe(self, handle: PipelineHandle, ok: bool,
                latency_ms: float, row_errors: int = 0,
                error: Optional[BaseException] = None) -> None:
        if handle is self.stable or not handle.is_canary:
            self.stable_hist.observe(latency_ms)
            return
        if handle is not self.canary or self._decided.is_set():
            return                    # stale handle / already resolved
        self.canary_hist.observe(latency_ms)
        failed = (not ok) or row_errors > 0
        with self._lock:
            if failed:
                self.canary_failed += 1
                self.canary_row_errors += int(row_errors)
                if error is not None:
                    self.last_error = f"{type(error).__name__}: {error}"
        if failed:
            self.breaker.record_failure()
            if self.breaker.state != CircuitBreaker.CLOSED:
                # the reason carries observed-vs-threshold so the
                # SwapEvent / rollback line / quarantine bundle is
                # self-explanatory without cross-referencing the policy
                with self._lock:
                    nf, ok = self.canary_failed, self.canary_ok
                calls = nf + ok
                rate = nf / max(calls, 1)
                self._resolve(
                    f"breach:error_rate observed={rate:.2f} "
                    f"({nf}/{calls} failed) >= "
                    f"threshold={self.policy.error_rate:.2f} or "
                    f"{self.policy.consecutive_failures} consecutive")
            return
        self.breaker.record_success()
        with self._lock:
            self.canary_ok += 1
            enough = self.canary_ok >= self.policy.min_batches
        latency_reason = self._latency_breached()
        if latency_reason is not None:
            self._resolve(latency_reason)
        elif enough:
            self._resolve("promote")

    def _latency_breached(self) -> Optional[str]:
        """None while healthy, else the full ``breach:latency ...``
        reason with observed p50s vs the allowed ratio."""
        ratio = self.policy.latency_ratio
        if ratio is None:
            return None
        c, s = self.canary_hist.summary(), self.stable_hist.summary()
        if c.get("count", 0) < self.policy.min_batches or \
                s.get("count", 0) < self.policy.min_batches:
            return None
        if c["p50"] > ratio * max(s["p50"], 1e-9):
            return (f"breach:latency canary_p50={c['p50']:.2f}ms > "
                    f"allowed={ratio:.2f}x stable_p50="
                    f"{s['p50']:.2f}ms")
        return None

    def _resolve(self, decision: str) -> None:
        with self._lock:
            if self.decision is None:
                self.decision = decision
        self._decided.set()

    def wait_decision(self, timeout: float) -> str:
        """Block until promote/breach, else a timeout breach (the safe
        default: an engine that stopped producing canary observations
        — killed mid-swap, starved of traffic — must not promote)."""
        if not self._decided.wait(timeout):
            with self._lock:
                ok, nf = self.canary_ok, self.canary_failed
            self._resolve(
                f"breach:decision_timeout after {timeout:.0f}s "
                f"(canary_ok={ok}/{self.policy.min_batches} needed, "
                f"failed={nf})")
        return self.decision or "breach:decision_timeout"

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "canary_version": self.canary.version,
                "stable_version": self.stable.version,
                "canary_ok": self.canary_ok,
                "canary_failed": self.canary_failed,
                "canary_row_errors": self.canary_row_errors,
                "decision": self.decision,
            }
        out["canary_p50_ms"] = self.canary_hist.summary().get("p50")
        out["stable_p50_ms"] = self.stable_hist.summary().get("p50")
        # the policy thresholds the decision was judged against, so the
        # SwapEvent stats pair every observed value with its limit
        out["thresholds"] = {
            "error_rate": self.policy.error_rate,
            "consecutive_failures": self.policy.consecutive_failures,
            "min_batches": self.policy.min_batches,
            "latency_ratio": self.policy.latency_ratio,
            "decision_timeout_s": self.policy.decision_timeout_s,
        }
        if self.last_error:
            out["last_error"] = self.last_error
        return out


def _run_warmup(pipeline: Any, example: Any, timeout_s: float,
                ) -> Optional[str]:
    """Run the pipeline's duck-typed ``warmup`` hook on a sacrificial
    daemon thread with a wall budget. Returns None on success, else the
    failure reason. A hung warmup leaks its (daemon) thread — the price
    of not wedging the swap on a stalled compile."""
    hook: Optional[Callable] = getattr(pipeline, "warmup", None)
    if hook is None:
        return None
    if example is None:
        # hooks that need an example can't run without one; treat a
        # missing example as "skip warmup" only when the hook accepts
        # zero arguments, else fail loudly — a silent skip would let
        # the first live batch pay the compile the swap promised to
        # pre-pay
        import inspect
        try:
            sig = inspect.signature(hook)
            required = [p for p in sig.parameters.values()
                        if p.default is inspect.Parameter.empty
                        and p.kind in (p.POSITIONAL_ONLY,
                                       p.POSITIONAL_OR_KEYWORD)]
        except (TypeError, ValueError):
            required = []
        if required:
            return ("warmup_failed: pipeline.warmup requires an example "
                    "but none was passed to swap()")
    outcome: Dict[str, Any] = {}
    done = threading.Event()

    def run():
        try:
            outcome["result"] = (hook(example) if example is not None
                                 else hook())
        except Exception as e:  # noqa: BLE001 — reported as the reason
            outcome["error"] = f"{type(e).__name__}: {e}"
        finally:
            done.set()

    threading.Thread(target=run, daemon=True,
                     name="lifecycle-warmup").start()
    if not done.wait(timeout_s):
        return f"warmup_timeout: no result within {timeout_s}s"
    if "error" in outcome:
        return f"warmup_failed: {outcome['error']}"
    return None


def execute_swap(engine: ServingEngine, pipeline: Any, version: str,
                 warmup_example: Any = None,
                 policy: Optional[CanaryPolicy] = None,
                 registry: Optional[ModelRegistry] = None) -> SwapResult:
    """The swap protocol on one engine (see module docstring). Blocks
    until the swap completes or rolls back."""
    policy = policy or CanaryPolicy()
    if not engine._swap_lock.acquire(blocking=False):
        raise SwapInProgress(
            f"engine {engine.source.address} is already mid-swap "
            f"(state {engine.swap_state})")
    try:
        old = engine._active
        from_version = old.version
        from mmlspark_tpu_torch.core.quantize import stage_precision
        precisions = {"from_precision": old.precision,
                      "to_precision": stage_precision(pipeline),
                      "from_aot": old.aot,
                      "to_aot": bool(getattr(pipeline, "aot", False))}

        def rolled_back(reason: str,
                        stats: Optional[Dict[str, Any]] = None
                        ) -> SwapResult:
            # state + counter move together under the stats lock, so a
            # concurrent metrics()/healthz scrape can never see
            # rolled_back state with the old rollback count (the
            # consistent-snapshot contract of engine._lifecycle_snapshot)
            with engine._stats_lock:
                engine.swap_state = ROLLED_BACK
                engine.swaps_rolled_back += 1
            event = SwapEvent("rolled_back", from_version, version,
                              reason=reason, stats=stats, **precisions)
            engine.swap_events.append(event)
            if registry is not None:
                registry.record_event(event)
            log.warning("swap %s -> %s ROLLED BACK on %s: %s",
                        from_version, version, engine.source.address,
                        reason)
            recorder = getattr(engine, "flight_recorder", None)
            if recorder is not None:
                # a rollback is exactly the moment the evidence matters:
                # auto-capture a post-mortem bundle (rate-limited) with
                # the canary's traces, the alert/event timeline, and the
                # windowed series at the decision point
                try:
                    recorder.trigger(
                        f"swap_rollback:{from_version}->{version}:"
                        f"{reason}")
                except Exception:  # noqa: BLE001 — capture is
                    pass           # best-effort, never blocks rollback
            return SwapResult(False, event)

        if not engine.is_alive():
            return rolled_back("engine_dead")

        # -- warming: compile every bucket OFF the hot path -----------------
        with engine._stats_lock:
            engine.swap_state = WARMING
        reason = _run_warmup(pipeline, warmup_example,
                             policy.warmup_timeout_s)
        if reason is not None:
            return rolled_back(reason)

        # -- canary: a fraction of live batches on the new version ----------
        stats: Dict[str, Any] = {}
        if policy.fraction > 0 and policy.min_batches > 0:
            canary = PipelineHandle(pipeline, version, is_canary=True)
            ctl = SwapController(old, canary, policy)
            engine._swap_ctl = ctl
            with engine._stats_lock:
                engine.swap_state = CANARY
            try:
                decision = ctl.wait_decision(policy.decision_timeout_s)
                stats = ctl.stats()
            finally:
                engine._swap_ctl = None
            if decision != "promote":
                return rolled_back(decision, stats)

        # -- draining: atomic cutover, old version drains -------------------
        new_handle = PipelineHandle(pipeline, version)
        with engine._stats_lock:
            # THE cutover: handle + state flip in one locked block —
            # batchers read _active lock-free (a plain ref load), but a
            # metrics()/healthz snapshot sees version and swap_state
            # move together instead of piecemeal
            engine._active = new_handle
            engine.swap_state = DRAINING
        deadline = time.monotonic() + policy.drain_timeout_s
        while old.outstanding > 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        if old.outstanding > 0:
            log.warning(
                "swap %s -> %s: %d old-version batch(es) still in "
                "flight after %.1fs drain budget (cutover already "
                "done; they will answer on %s)", from_version, version,
                old.outstanding, policy.drain_timeout_s, from_version)
        with engine._stats_lock:
            engine.swap_state = IDLE
            engine.swaps_completed += 1
        event = SwapEvent("completed", from_version, version, stats=stats,
                          **precisions)
        engine.swap_events.append(event)
        if registry is not None:
            registry.record_event(event)
        log.info("swap %s -> %s completed on %s", from_version, version,
                 engine.source.address)
        return SwapResult(True, event)
    finally:
        engine._swap_lock.release()
