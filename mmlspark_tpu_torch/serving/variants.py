"""SLO-adaptive variant selection: route each logical model to the
cheapest physical variant that still meets its latency objective — the
port's copy of ``mmlspark_tpu/serving/variants.py`` (host-only).

The zoo (serving/zoo.py) stores multiple physical variants of one
logical model — f32 vs int8 (core/quantize.py), AOT-loaded vs eager —
and a request named ``model@version`` would always get that one. This
module makes the runtime pick (INFaaS; Romero et al., ATC '21):

- **Declared ladder.** ``declare(logical, variants=[...], slo_ms=...)``
  registers an ordered variant ladder for one logical model: rung 0 is
  the preferred/full-fidelity variant, later rungs are the cheaper
  tiers the operator is willing to degrade onto (int8). The ladder
  order IS the degradation policy — written down once, by a human,
  instead of inferred per incident.
- **Windowed profiles.** Every scored batch feeds a per-variant
  windowed latency/cost profile (``observe``, wired from the engine's
  existing per-model batch-latency feed): p99 over a trailing window,
  measured device-ms/row as the default cost signal, and the variant's
  cold-start cost from the zoo's activation timing. A declared
  ``cost`` (chip-seconds, $/1k rows — whatever the operator's unit is)
  overrides the measured signal; ``cost_source`` records which one a
  decision used.
- **Selection.** Among the OPEN rungs (0..floor), serve the cheapest
  variant whose profiled p99 meets ``slo_ms`` — preferring resident
  variants on ties (activating a cold variant mid-incident spends the
  cold-start exactly when there is no headroom for it).
- **Graceful degradation.** When the SLO engine reports a fast burn or
  admission reports queue pressure, the floor opens one cheaper rung
  per decide tick — load degrades onto cheaper variants BEFORE
  priority shedding fires. When the burn resolves and pressure clears,
  the floor closes one rung per ``hold_s`` (hysteresis: a flapping
  burn must not flap the fleet's executables).
- **Decisions are rate-gated and cached.** ``tick`` (the batcher's
  rate-gated control tick, next to ``slo.evaluate`` and
  ``zoo.enforce``) recomputes the route table; the per-request path is
  one dict lookup (``route``). ``testing/fusion_check.py
  check_adaptive_serving`` proves statically that no selection ever
  runs in the HTTP handler.

Every transition lands as a ``VariantEvent`` on the registry timeline
(``zoo.record_event``), interleaved with Swap/Zoo/Placement events by
time, and the active variant + last step-down reason surface on
``/healthz`` and ``serving_variant_*`` Prometheus families.

Eviction safety is inherited, not re-implemented: routing to a variant
goes through the zoo's ``acquire`` (outstanding bumped under the
registry lock) and the engine's pending-group waiter holds, so a
variant carrying traffic is never an eviction victim.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.core.metrics import WindowedCounter, WindowedHistogram

log = get_logger("serving.variants")

# variant-labeled Prometheus series rendered per declared logical
# model; declarations are operator-made and small, but the render cap
# keeps a scripted declare-loop from exploding the scrape
VARIANT_LABEL_CAP = 16


class VariantEvent:
    """One variant-plane decision on the registry timeline (the
    SwapEvent / ZooEvent / PlacementEvent discipline). ``declare``
    records the ladder, ``step_down``/``step_up`` move the degradation
    floor (reason carries why), ``select`` is a cost/profile-driven
    re-route within the open rungs."""

    def __init__(self, kind: str, model: str, variant: str = "",
                 reason: str = "",
                 stats: Optional[Dict[str, Any]] = None):
        self.kind = kind      # 'declare'|'step_down'|'step_up'|'select'
        self.model = model    # the LOGICAL model name
        self.variant = variant            # the chosen variant key
        self.reason = reason
        self.stats = dict(stats or {})
        self.at = time.time()

    def __repr__(self) -> str:
        extra = f", reason={self.reason!r}" if self.reason else ""
        return (f"VariantEvent({self.kind}, {self.model!r} -> "
                f"{self.variant!r}{extra})")


class VariantProfile:
    """Windowed latency/cost profile of ONE physical variant. Fed a
    (batch latency ms, rows) sample per scored batch; answers p99 and
    measured ms/row over a trailing window."""

    __slots__ = ("key", "declared_cost", "hist", "ms_sum", "rows_sum",
                 "batches")

    def __init__(self, key: str, declared_cost: Optional[float] = None):
        self.key = key
        self.declared_cost = (float(declared_cost)
                              if declared_cost is not None else None)
        # 1 s buckets: profile windows are tens of seconds, and the
        # selector must see a load ramp within a tick or two
        self.hist = WindowedHistogram(bucket_s=1.0, horizon_s=600.0)
        self.ms_sum = WindowedCounter(bucket_s=1.0, horizon_s=600.0)
        self.rows_sum = WindowedCounter(bucket_s=1.0, horizon_s=600.0)
        self.batches = 0

    def observe(self, ms: float, rows: int,
                now: Optional[float] = None) -> None:
        self.hist.observe(float(ms), now=now)
        self.ms_sum.inc(float(ms), now=now)
        self.rows_sum.inc(float(max(1, rows)), now=now)
        self.batches += 1

    def p99(self, window_s: float,
            now: Optional[float] = None) -> Optional[float]:
        """Profiled p99 batch latency, or None with no samples in the
        window (an unprofiled variant is a DIFFERENT fact than a fast
        one — the policy treats them differently)."""
        if self.hist.count(window_s, now=now) <= 0:
            return None
        return self.hist.percentile(99, window_s, now=now)

    def ms_per_row(self, window_s: float,
                   now: Optional[float] = None) -> Optional[float]:
        rows = self.rows_sum.total(window_s, now=now)
        if rows <= 0:
            return None
        return self.ms_sum.total(window_s, now=now) / rows

    def cost(self, window_s: float,
             now: Optional[float] = None
             ) -> "tuple[Optional[float], str]":
        """(cost, source): the declared cost when the operator pinned
        one, else the measured ms/row, else None (unprofiled)."""
        if self.declared_cost is not None:
            return self.declared_cost, "declared"
        measured = self.ms_per_row(window_s, now=now)
        if measured is not None:
            return measured, "measured"
        return None, "unprofiled"


class _Ladder:
    """Mutable selector state for one logical model (selector lock)."""

    __slots__ = ("name", "variants", "slo_ms", "floor", "active_idx",
                 "last_reason", "last_change_at", "clear_since",
                 "step_downs", "step_ups", "selects")

    def __init__(self, name: str, variants: List[str], slo_ms: float):
        self.name = name
        self.variants = list(variants)     # rung 0 = preferred
        self.slo_ms = float(slo_ms)
        self.floor = 0                     # open rungs: 0..floor
        self.active_idx = 0
        self.last_reason = ""
        self.last_change_at = 0.0
        self.clear_since: Optional[float] = None
        self.step_downs = 0
        self.step_ups = 0
        self.selects = 0


class VariantSelector:
    """Cached, rate-gated variant routing over a zoo's variant sets
    (see module docstring).

    Hot-path contract: ``route`` and ``observe`` are O(1) dict/counter
    operations safe on the batcher thread; ``tick`` (the decision
    pass) is rate-gated like ``zoo.enforce`` and runs ONLY on the
    batcher's control tick — never in the per-request HTTP handler
    (enforced by the ``check_adaptive_serving`` audit)."""

    def __init__(self, zoo, slo=None,
                 window_s: float = 30.0,
                 decide_interval_s: float = 0.5,
                 hold_s: float = 3.0,
                 pressure_limit: int = 32,
                 record_event=None):
        self.zoo = zoo
        self.slo = slo
        self.window_s = float(window_s)
        self.decide_interval_s = float(decide_interval_s)
        self.hold_s = float(hold_s)
        self.pressure_limit = int(pressure_limit)
        # default: the zoo's registry timeline — one audit trail
        self.record_event = (record_event if record_event is not None
                             else getattr(zoo, "record_event", None))
        self._lock = threading.Lock()
        self._ladders: Dict[str, _Ladder] = {}
        self._profiles: Dict[str, VariantProfile] = {}
        # the CACHE the hot path reads: every declared variant key (and
        # the logical bare name) -> the active variant key. Replaced
        # wholesale under the lock; reads are lock-free dict lookups.
        self._routes: Dict[str, str] = {}
        self._last_tick = 0.0
        self.events: List[VariantEvent] = []

    # -- declaration --------------------------------------------------------

    def declare(self, logical: str, variants: List[str], slo_ms: float,
                costs: Optional[List[Optional[float]]] = None) -> None:
        """Declare one logical model's variant ladder. ``variants`` are
        zoo specs (``name@version``; bare names resolve) ordered from
        the preferred/full-fidelity rung down to the cheapest tier the
        operator will degrade onto. ``slo_ms`` is the model's latency
        objective (profiled p99 must stay under it). ``costs``
        optionally pins per-variant declared costs (one unit for the
        whole ladder) — a list aligned with ``variants`` or a mapping
        keyed by spec; unpinned variants use their measured ms/row."""
        if len(variants) < 1:
            raise ValueError("a variant ladder needs at least one rung")
        if isinstance(costs, dict):
            costs = [costs.get(spec) for spec in variants]
        if costs is not None and len(costs) != len(variants):
            raise ValueError("costs must align with variants")
        keys: List[str] = []
        for spec in variants:
            key = self.zoo.resolve(spec) if self.zoo is not None else spec
            if key is None:
                raise KeyError(f"variant {spec!r} is not registered")
            keys.append(key)
        with self._lock:
            if logical in self._ladders:
                raise ValueError(
                    f"ladder for {logical!r} already declared")
            ladder = _Ladder(logical, keys, slo_ms)
            self._ladders[logical] = ladder
            for i, key in enumerate(keys):
                self._profiles.setdefault(
                    key, VariantProfile(
                        key, costs[i] if costs is not None else None))
            self._rebuild_routes_locked()
        self._emit(VariantEvent(
            "declare", logical, keys[0],
            stats={"variants": list(keys), "slo_ms": float(slo_ms)}))

    def declared(self) -> List[str]:
        with self._lock:
            return list(self._ladders)

    # -- hot-path feeds (batcher thread; O(1)) ------------------------------

    def route(self, key: Optional[str]) -> Optional[str]:
        """The per-request lookup: a declared variant key (or logical
        name) maps to the ladder's ACTIVE variant; anything else passes
        through unchanged. Pure cache read — decisions happen in
        ``tick``."""
        if key is None:
            return None
        return self._routes.get(key, key)

    def observe(self, key: str, ms: float, rows: int = 1,
                now: Optional[float] = None) -> None:
        """One scored batch on variant ``key`` (the engine's per-model
        batch-latency feed). Unknown keys are ignored — only declared
        variants carry profiles."""
        prof = self._profiles.get(key)
        if prof is not None:
            prof.observe(ms, rows, now=now)

    # -- the rate-gated decision tick ---------------------------------------

    def tick(self, pressure: int = 0,
             now: Optional[float] = None,
             min_interval_s: Optional[float] = None) -> bool:
        """One control-tick decision pass (the batcher calls this next
        to ``slo.evaluate``/``zoo.enforce``). Rate-gated by
        ``decide_interval_s``; returns True when a pass actually ran."""
        t = time.monotonic() if now is None else now
        gate = (self.decide_interval_s if min_interval_s is None
                else float(min_interval_s))
        with self._lock:
            if gate > 0 and t - self._last_tick < gate:
                return False
            self._last_tick = t
            burn_reason = self._burn_reason_locked()
            changed = False
            for ladder in self._ladders.values():
                changed |= self._decide_locked(ladder, pressure,
                                               burn_reason, t)
            if changed:
                self._rebuild_routes_locked()
        return True

    def _burn_reason_locked(self) -> Optional[str]:
        """The SLO engine's degradation signal: any active FAST-burn
        alert (engine-level or on a declared variant's stream). Slow
        burns do not move executables — they page humans."""
        if self.slo is None:
            return None
        try:
            active = self.slo.alerts.active()
        except Exception:  # noqa: BLE001 — a sick monitor must never
            return None    # take the variant plane down
        for alert in active:
            if "fast" in alert.rule:
                return f"fast_burn:{alert.slo}"
        return None

    def _decide_locked(self, ladder: _Ladder, pressure: int,
                       burn_reason: Optional[str], now: float) -> bool:
        degraded = burn_reason is not None \
            or pressure >= self.pressure_limit
        reason = burn_reason or "queue_pressure"
        changed = False
        if degraded:
            ladder.clear_since = None
            if ladder.floor < len(ladder.variants) - 1:
                # one rung per decide tick: bounded degradation rate
                ladder.floor += 1
                ladder.last_reason = reason
                ladder.last_change_at = now
                ladder.step_downs += 1
                changed = True
                self._emit(VariantEvent(
                    "step_down", ladder.name,
                    ladder.variants[ladder.floor], reason=reason,
                    stats={"floor": ladder.floor,
                           "pressure": int(pressure)}))
        else:
            if ladder.clear_since is None:
                ladder.clear_since = now
            elif now - ladder.clear_since >= self.hold_s \
                    and ladder.floor > 0:
                # hysteretic recovery: one rung per hold_s of clean air
                ladder.floor -= 1
                ladder.clear_since = now
                ladder.last_change_at = now
                ladder.step_ups += 1
                changed = True
                self._emit(VariantEvent(
                    "step_up", ladder.name,
                    ladder.variants[ladder.floor], reason="recovered",
                    stats={"floor": ladder.floor}))
        best = self._choose_locked(ladder, now)
        if best != ladder.active_idx:
            ladder.active_idx = best
            ladder.selects += 1
            ladder.last_change_at = now
            changed = True
            prof = self._profiles[ladder.variants[best]]
            cost, src = prof.cost(self.window_s)
            self._emit(VariantEvent(
                "select", ladder.name, ladder.variants[best],
                reason=ladder.last_reason or "cost",
                stats={"rung": best, "cost": cost,
                       "cost_source": src}))
        return changed

    def _choose_locked(self, ladder: _Ladder, now: float) -> int:
        """Pick the active rung among the open ones (0..floor): the
        cheapest variant whose profiled p99 meets the SLO. Unprofiled
        rungs count as meeting (they only become reachable when the
        floor opened — degradation is how a cheaper tier first earns a
        profile), but rank after profiled ones on cost ties; cold
        (non-resident) rungs rank last — paying an activation
        mid-incident is the wrong moment."""
        meeting: List[tuple] = []
        fallback: List[tuple] = []
        for i in range(ladder.floor + 1):
            key = ladder.variants[i]
            prof = self._profiles[key]
            p99 = prof.p99(self.window_s)
            cost, src = prof.cost(self.window_s)
            resident = self._resident(key)
            # sort key: cost first (None = unprofiled ranks after any
            # measured/declared cost), then warm-before-cold, then the
            # ladder's declared preference
            rank = (cost if cost is not None else float("inf"),
                    0 if resident else 1, i)
            if p99 is None or p99 <= ladder.slo_ms:
                meeting.append(rank)
            else:
                fallback.append((p99, 0 if resident else 1, i))
        if meeting:
            return min(meeting)[-1]
        if fallback:
            return min(fallback)[-1]     # best-effort: lowest p99
        return ladder.floor

    def _resident(self, key: str) -> bool:
        if self.zoo is None:
            return True
        try:
            status = self.zoo.entry_status(key)
        except Exception:  # noqa: BLE001 — residency is advisory
            return True
        return bool(status) and status.get("state") == "resident"

    def _rebuild_routes_locked(self) -> None:
        routes: Dict[str, str] = {}
        for ladder in self._ladders.values():
            active = ladder.variants[ladder.active_idx]
            routes[ladder.name] = active       # bare logical name
            for key in ladder.variants:
                routes[key] = active
        self._routes = routes   # atomic swap: readers never see a mix

    def _emit(self, event: VariantEvent) -> None:
        self.events.append(event)
        if self.record_event is not None:
            try:
                self.record_event(event)
            except Exception:  # noqa: BLE001 — the timeline is
                pass           # best-effort; routing must not die

    # -- observability ------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """The /healthz payload: per-logical active variant, rung,
        degradation floor, last step-down reason, and each rung's
        profile (p99, cost + cost_source, residency, cold-start ms)."""
        with self._lock:
            ladders = list(self._ladders.values())
        out: Dict[str, Any] = {}
        for ladder in ladders:
            rungs = []
            for i, key in enumerate(ladder.variants):
                prof = self._profiles[key]
                p99 = prof.p99(self.window_s)
                cost, src = prof.cost(self.window_s)
                entry = None
                if self.zoo is not None:
                    try:
                        entry = self.zoo.entry_status(key)
                    except Exception:  # noqa: BLE001
                        entry = None
                rungs.append({
                    "variant": key, "rung": i,
                    "open": i <= ladder.floor,
                    "p99_ms": (round(p99, 2)
                               if p99 is not None else None),
                    "cost": (round(cost, 4)
                             if cost is not None else None),
                    "cost_source": src,
                    "state": (entry or {}).get("state", "unknown"),
                    "activation_ms": (entry or {}).get("activation_ms"),
                })
            out[ladder.name] = {
                "active": ladder.variants[ladder.active_idx],
                "rung": ladder.active_idx,
                "floor": ladder.floor,
                "slo_ms": ladder.slo_ms,
                "last_step_down_reason": ladder.last_reason,
                "step_downs": ladder.step_downs,
                "step_ups": ladder.step_ups,
                "selects": ladder.selects,
                "variants": rungs,
            }
        return out

    def stats(self) -> Dict[str, Any]:
        """Counter totals for the ``serving_variant_*`` families."""
        with self._lock:
            ladders = list(self._ladders.values())
        return {
            "declared": len(ladders),
            "step_downs": sum(x.step_downs for x in ladders),
            "step_ups": sum(x.step_ups for x in ladders),
            "selects": sum(x.selects for x in ladders),
            "degraded": sum(1 for x in ladders if x.active_idx > 0),
        }
