"""Fleet-wide zoo placement plane: which engine processes serve which
``model@version`` — the port's copy of
``mmlspark_tpu/serving/placement.py`` (host-only).

``ModelZoo`` makes each engine a demand-driven cache; this module adds
the FLEET-level controller above it. One
``PlacementController`` watches per-model request demand (windowed
rates, ``core.metrics.WindowedCounter``) and each model's residency
cost (the zoo's ``cost_bytes`` accounting, itself fed by the duck-typed
``resident_bytes()`` hook), and assigns every demanded model to a set
of engine indices:

- **hot models get replicas** — a model carrying a dominant share of
  the windowed demand is assigned to proportionally many engines (at
  least 2 once it clears ``hot_share`` of traffic, up to the fleet
  size);
- **cold models get exactly one** — a model with a trickle of demand
  stays servable without spending residency on every engine;
- **assignment is residency-aware** — replicas land on the engines
  with the least assigned bytes (balanced packing), and sticky: a
  model keeps its current engines while the plan still wants that many
  replicas (minimal churn per rebuild);
- **one loader activation feeds N engines** — the fleet's engines
  share ONE zoo, so assigning a model to more engines never re-loads
  it; the plan only spreads the TRAFFIC.

``ServingFleet.attach_placement`` wires the controller into the
client: model-keyed requests route to the model's assigned engines
first, with the full round-robin order BEHIND them — a stale plan
(new model, engine death, pre-first-rebuild) falls back to any engine,
where the zoo's lazy activation takes over; those fallbacks are
counted (``serving_placement_stale_routes_total``).

Eviction sees FLEET-GLOBAL demand: ``evict_coldest`` offers the zoo
the least-demanded victims first, and the zoo's own invariants (never
a model with outstanding batches, parked waiters, or a pin — anywhere
in the fleet, since the zoo is shared) arbitrate each offer.

Every placement decision lands as an ordered ``PlacementEvent`` on the
registry timeline (``zoo.record_event``), interleaved with the Swap
and Zoo events by time — one audit trail tells the whole story.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from mmlspark_tpu_torch.core.metrics import LatencyHistogram, WindowedCounter
from mmlspark_tpu_torch.core.logging_utils import get_logger

log = get_logger("serving.placement")

# per-model replica series rendered with their own label; overflow
# folds into model="_other" (the LabelledHistograms cap discipline)
REPLICA_LABEL_CAP = 16


class PlacementEvent:
    """One placement decision on the registry timeline (the SwapEvent /
    ZooEvent discipline): ``assign`` / ``unassign`` carry the engine
    delta for one model, ``rebuild`` summarizes a whole plan pass."""

    def __init__(self, kind: str, model: str, version: str = "",
                 reason: str = "",
                 stats: Optional[Dict[str, Any]] = None):
        self.kind = kind          # 'assign' | 'unassign' | 'rebuild'
        self.model = model
        self.version = version
        self.reason = reason
        self.stats = dict(stats or {})
        self.at = time.time()

    def __repr__(self) -> str:
        extra = f", reason={self.reason!r}" if self.reason else ""
        if "engines" in self.stats:
            extra += f", engines={self.stats['engines']}"
        return f"PlacementEvent({self.kind}, {self.model!r}{extra})"


class PlacementController:
    """Demand- and residency-aware assignment of models to engine
    indices (see module docstring).

    ``record_request`` is the hot-path hook (one windowed-counter inc);
    ``rebuild`` recomputes the plan (called by the fleet opportunistically
    or by an ops loop); ``engines_for`` answers routing. All methods
    are thread-safe."""

    def __init__(self, zoo, n_engines: int,
                 demand_window_s: float = 60.0,
                 hot_share: float = 0.5,
                 max_replicas: Optional[int] = None,
                 rebuild_min_interval_s: float = 1.0):
        if n_engines < 1:
            raise ValueError("placement needs at least one engine")
        self.zoo = zoo
        self.n_engines = int(n_engines)
        self.demand_window_s = float(demand_window_s)
        self.hot_share = float(hot_share)
        self.max_replicas = (int(max_replicas) if max_replicas
                             else self.n_engines)
        self.rebuild_min_interval_s = float(rebuild_min_interval_s)
        self._lock = threading.Lock()
        self._demand: Dict[str, WindowedCounter] = {}
        self._assignments: Dict[str, Tuple[int, ...]] = {}
        self._dead: set = set()          # engines excluded from plans
        self._last_rebuild = 0.0
        self.rebuilds = 0
        self.stale_routes = 0
        self.rebuild_hist = LatencyHistogram(unit="ms")

    # -- demand -------------------------------------------------------------

    def record_request(self, model: str) -> None:
        """One model-keyed request arrived (the fleet client calls this
        on every routed post)."""
        key = str(model)
        with self._lock:
            c = self._demand.get(key)
            if c is None:
                c = self._demand[key] = WindowedCounter(bucket_s=1.0)
        c.inc()

    def demand_rate(self, model: str) -> float:
        """Requests/s for ``model`` over the demand window."""
        with self._lock:
            c = self._demand.get(str(model))
        return c.rate(self.demand_window_s) if c is not None else 0.0

    # -- engine liveness ----------------------------------------------------

    def mark_engine_dead(self, index: int) -> None:
        """Exclude an engine from future plans (and rebuild now so its
        replicas reassign). The fleet's breakers still own short-term
        failover; this is the placement-plane reaction to a confirmed
        death (SIGKILL chaos, decommission)."""
        with self._lock:
            self._dead.add(int(index))
        self.rebuild(force=True, reason=f"engine{index}_dead")

    def mark_engine_alive(self, index: int) -> None:
        with self._lock:
            self._dead.discard(int(index))

    def set_n_engines(self, n: int, reason: str = "resize") -> None:
        """Resize the engine universe (the autoscaler's join/leave
        hook) and rebuild the plan NOW: after a join, hot models fan
        out onto the new replica; after a leave, its assignments
        reassign before the next routed post. A default-capped
        ``max_replicas`` (== the old width) follows the resize; an
        explicit cap is the operator's and stays. Liveness marks for
        engines beyond the new width are dropped — index ``i`` of a
        future fleet is a different process."""
        n = int(n)
        if n < 1:
            raise ValueError("placement needs at least one engine")
        with self._lock:
            if n == self.n_engines:
                return
            if self.max_replicas == self.n_engines:
                self.max_replicas = n
            self.n_engines = n
            self._dead = {i for i in self._dead if i < n}
        self.rebuild(force=True, reason=reason)

    # -- the plan -----------------------------------------------------------

    def _zoo_costs(self) -> Dict[str, int]:
        """model and model@version -> residency cost (the zoo's
        ``cost_bytes``, fed by artifact sizes / metadata / duck-typed
        ``resident_bytes()``)."""
        costs: Dict[str, int] = {}
        if self.zoo is None:
            return costs
        try:
            rows = self.zoo.stats().get("models", [])
        except Exception:  # noqa: BLE001 — stats stay best-effort
            return costs
        for row in rows:
            cost = int(row.get("cost_bytes", 0))
            costs[f"{row['model']}@{row['version']}"] = cost
            # bare-name routing resolves to the latest version; keep
            # the first (most-recently-used-ordered) row's cost
            costs.setdefault(row["model"], cost)
        return costs

    def _replicas_wanted(self, rate: float, total_rate: float,
                         alive: int) -> int:
        """Demand share -> replica count: every demanded model gets
        one; a model above ``hot_share`` of the windowed demand gets at
        least two; shares scale proportionally up to the alive-engine
        count (and ``max_replicas``)."""
        cap = max(1, min(alive, self.max_replicas))
        if total_rate <= 0 or rate <= 0:
            return 1
        share = rate / total_rate
        wanted = max(1, round(share * alive))
        if share >= self.hot_share:
            wanted = max(2, wanted)
        return min(cap, wanted)

    def rebuild(self, force: bool = False,
                reason: str = "demand") -> Dict[str, Tuple[int, ...]]:
        """Recompute the fleet plan. Rate-limited by
        ``rebuild_min_interval_s`` unless ``force``. Returns the new
        assignment map (model -> engine indices). Emits the per-model
        assign/unassign deltas and one rebuild summary onto the
        registry timeline."""
        now = time.monotonic()
        t0 = time.perf_counter()
        with self._lock:
            if not force and now < self._last_rebuild \
                    + self.rebuild_min_interval_s:
                return dict(self._assignments)
            self._last_rebuild = now
            alive_engines = [i for i in range(self.n_engines)
                             if i not in self._dead]
            if not alive_engines:
                alive_engines = list(range(self.n_engines))
            rates = {key: c.rate(self.demand_window_s)
                     for key, c in self._demand.items()}
            old = dict(self._assignments)
        costs = self._zoo_costs()
        total_rate = sum(rates.values())
        # residency-aware balanced packing: engines accumulate the
        # bytes of what they're assigned; each model's replicas land on
        # the least-loaded engines, sticky to their current homes
        load = {i: 0.0 for i in alive_engines}
        plan: Dict[str, Tuple[int, ...]] = {}
        for key in sorted(rates, key=lambda k: (-rates[k], k)):
            wanted = self._replicas_wanted(rates[key], total_rate,
                                           len(alive_engines))
            cost = float(costs.get(key, 0)) or 1.0
            current = [i for i in old.get(key, ()) if i in load]
            chosen = current[:wanted]
            for i in sorted(load, key=lambda e: (load[e], e)):
                if len(chosen) >= wanted:
                    break
                if i not in chosen:
                    chosen.append(i)
            chosen = sorted(chosen)
            for i in chosen:
                load[i] += cost
            plan[key] = tuple(chosen)
        with self._lock:
            self._assignments = dict(plan)
            self.rebuilds += 1
        ms = (time.perf_counter() - t0) * 1e3
        self.rebuild_hist.observe(ms)
        self._record_deltas(old, plan, reason, ms, total_rate)
        return dict(plan)

    def _record_deltas(self, old: Dict[str, Tuple[int, ...]],
                       new: Dict[str, Tuple[int, ...]],
                       reason: str, ms: float,
                       total_rate: float) -> None:
        record = getattr(self.zoo, "record_event", None)
        if record is None:
            return
        for key in sorted(set(old) | set(new)):
            before, after = set(old.get(key, ())), set(new.get(key, ()))
            if before == after:
                continue
            name, _, version = key.partition("@")
            gained, lost = sorted(after - before), sorted(before - after)
            if gained:
                record(PlacementEvent(
                    "assign", name, version, reason=reason,
                    stats={"engines": gained,
                           "replicas": len(after)}))
            if lost:
                record(PlacementEvent(
                    "unassign", name, version, reason=reason,
                    stats={"engines": lost,
                           "replicas": len(after)}))
        record(PlacementEvent(
            "rebuild", "_fleet", reason=reason,
            stats={"models": len(new), "ms": ms,
                   "demand_rps": round(total_rate, 3)}))

    # -- routing ------------------------------------------------------------

    def engines_for(self, model: str) -> List[int]:
        """The model's assigned engine indices (empty = not in the
        plan: the caller routes to any engine and the zoo lazily
        activates; counted as a stale route)."""
        with self._lock:
            assigned = self._assignments.get(str(model))
            if assigned:
                return list(assigned)
            self.stale_routes += 1
            return []

    def replica_counts(self) -> Dict[str, int]:
        with self._lock:
            return {k: len(v) for k, v in self._assignments.items()}

    def assignments(self) -> Dict[str, Tuple[int, ...]]:
        with self._lock:
            return dict(self._assignments)

    # -- fleet-global eviction ----------------------------------------------

    def evict_coldest(self, keep: int = 1,
                      reason: str = "placement_cold") -> Optional[str]:
        """Offer the zoo the least-demanded models as eviction victims
        (coldest first), keeping at least ``keep`` assigned models
        untouched. The ZOO arbitrates every offer — a model with
        outstanding batches, parked waiters, or a pin anywhere in the
        fleet refuses (returns False) and the next-coldest is offered.
        Returns the evicted spec, or None when nothing was evictable."""
        if self.zoo is None:
            return None
        with self._lock:
            rates = {key: c.rate(self.demand_window_s)
                     for key, c in self._demand.items()}
        candidates = sorted(rates, key=lambda k: (rates[k], k))
        if keep > 0:
            candidates = candidates[:max(0, len(candidates) - keep)]
        for spec in candidates:
            try:
                if self.zoo.evict(spec, reason=reason):
                    log.info("placement: evicted cold model %s "
                             "(%.3f req/s fleet-wide)", spec,
                             rates[spec])
                    return spec
            except KeyError:
                continue       # demand for a never-registered spec
        return None

    # -- observability ------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "models": len(self._assignments),
                "assignments": sum(len(v) for v in
                                   self._assignments.values()),
                "rebuilds": self.rebuilds,
                "stale_routes": self.stale_routes,
                "dead_engines": sorted(self._dead),
                "demand_rps": {
                    k: round(c.rate(self.demand_window_s), 3)
                    for k, c in self._demand.items()},
            }
