"""Load-driven fleet autoscaling: spawn and retire engine processes
off windowed demand, with bounded scale rates and a drain-before-
retire discipline — the port's copy of
``mmlspark_tpu/serving/autoscale.py`` (host-only).

A connected fleet's width is set at ``connect`` time; this module moves
it with the load. A
``FleetAutoscaler`` watches the client-observed demand rate
(``ServingFleet.demand_rate`` — a windowed counter fed by every
``post``/``post_columns``) and keeps per-engine demand inside a
watermark band:

- **Scale up** when demand/engine exceeds ``up_rate`` — the
  ``spawner`` callback starts one engine process (a serving-worker
  script in the tests), the
  new address passes the fleet's STARTUP PROBE before joining the
  rotation (the ``connect`` discipline: a slow starter must not burn
  its fresh breaker's failure budget), and the placement controller
  rebalances over the new width (``set_n_engines``) so hot models fan
  out onto the new replica.
- **Scale down** when demand/engine falls under ``down_rate`` —
  always through ``_drain_and_stop``: the engine leaves the routing
  rotation FIRST, then its ``/healthz`` is polled until parked
  connections and queue depth hit zero (bounded by
  ``drain_timeout_s``), and only then does the process stop. The
  ``check_adaptive_serving`` audit proves statically that rotation
  removal and process stop happen nowhere else — a scale-down can
  shed capacity, never in-flight requests.
- **Bounded rates + hysteresis.** At most one engine joins or leaves
  per decision, decisions are separated by ``cooldown_s`` (joins) /
  ``down_cooldown_s`` (leaves, longer by default), and the fleet
  width stays inside [``min_engines``, ``max_engines``]. Engines the
  autoscaler did not spawn are never retired — the operator's
  baseline capacity is not the controller's to take.

Every decision lands as an ``AutoscaleEvent`` (on the registry
timeline too when a zoo's ``record_event`` is wired), and
``serving_autoscale_*`` Prometheus families render through the
fleet's ``metrics_text``.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

from mmlspark_tpu_torch.core.logging_utils import get_logger

log = get_logger("serving.autoscale")


class AutoscaleEvent:
    """One autoscaler decision on the timeline (the VariantEvent /
    PlacementEvent discipline)."""

    def __init__(self, kind: str, address: str = "", reason: str = "",
                 stats: Optional[Dict[str, Any]] = None):
        self.kind = kind    # 'scale_up'|'scale_down'|'drain_timeout'
        self.address = address
        self.reason = reason
        self.stats = dict(stats or {})
        self.at = time.time()

    def __repr__(self) -> str:
        return (f"AutoscaleEvent({self.kind}, {self.address!r}, "
                f"reason={self.reason!r})")


class FleetAutoscaler:
    """Watermark controller over a CONNECTED ``ServingFleet``.

    ``spawner()`` starts one engine process and returns
    ``(address, stop_handle)`` — the handle is a zero-arg callable, or
    an object with ``terminate``/``kill`` (a ``subprocess.Popen``).
    The autoscaler owns the processes it spawned (retires newest
    first) and ONLY those."""

    def __init__(self, fleet, spawner: Callable[[], Tuple[str, Any]],
                 min_engines: int = 1,
                 max_engines: int = 4,
                 up_rate: float = 100.0,
                 down_rate: Optional[float] = None,
                 window_s: float = 10.0,
                 cooldown_s: float = 5.0,
                 down_cooldown_s: Optional[float] = None,
                 startup_probe_s: float = 60.0,
                 drain_timeout_s: float = 10.0,
                 record_event=None):
        if min_engines < 1:
            raise ValueError("min_engines must be >= 1")
        if max_engines < min_engines:
            raise ValueError("max_engines must be >= min_engines")
        self.fleet = fleet
        self.spawner = spawner
        self.min_engines = int(min_engines)
        self.max_engines = int(max_engines)
        self.up_rate = float(up_rate)
        # default low watermark well under half the high one: a fleet
        # that just scaled up must not immediately qualify for scale-
        # down (the hysteresis band)
        self.down_rate = (float(down_rate) if down_rate is not None
                          else self.up_rate * 0.3)
        if self.down_rate >= self.up_rate:
            raise ValueError("down_rate must sit below up_rate "
                             "(the hysteresis band)")
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self.down_cooldown_s = (float(down_cooldown_s)
                                if down_cooldown_s is not None
                                else self.cooldown_s * 2)
        self.startup_probe_s = float(startup_probe_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.record_event = record_event
        self._lock = threading.Lock()
        # addresses this autoscaler spawned, join order; only these
        # are retire candidates (newest-first)
        self._owned: List[str] = []
        self._stoppers: Dict[str, Any] = {}
        self._last_change = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self.scale_ups = 0
        self.scale_downs = 0
        self.drain_timeouts = 0
        self.spawn_failures = 0
        self.events: List[AutoscaleEvent] = []
        # the fleet's /metrics renders serving_autoscale_* through us
        fleet.autoscaler = self

    # -- the control loop ---------------------------------------------------

    def start(self, interval_s: float = 1.0) -> "FleetAutoscaler":
        """Run ``tick`` on a daemon thread every ``interval_s``."""
        if self._thread is not None:
            return self
        self._stop_evt.clear()

        def loop():
            while not self._stop_evt.wait(interval_s):
                try:
                    self.tick()
                except Exception as e:  # noqa: BLE001 — a sick
                    # controller must not take the fleet down
                    log.error("autoscaler tick failed (continuing): %s",
                              e)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fleet-autoscaler")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the control loop (spawned engines keep serving; use
        ``close`` to also retire them)."""
        self._stop_evt.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    def close(self, drain: bool = True) -> None:
        """Stop the loop AND retire every spawned engine (newest
        first), each through the drain path unless ``drain=False``
        (teardown in tests where the fleet is going away anyway)."""
        self.stop()
        with self._lock:
            owned = list(reversed(self._owned))
        for addr in owned:
            try:
                self._drain_and_stop(addr, reason="close",
                                     drain=drain)
            except Exception as e:  # noqa: BLE001 — keep retiring
                log.warning("close: retiring %s failed: %s", addr, e)

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One control decision: compare windowed demand/engine to the
        watermark band, move the fleet width AT MOST one engine, and
        respect the cooldowns. Returns 'scale_up'/'scale_down'/None
        (what happened), for tests and manual driving."""
        t = time.monotonic() if now is None else now
        n = len(self.fleet.addresses)
        demand = self.fleet.demand_rate(self.window_s)
        per_engine = demand / max(1, n)
        with self._lock:
            since_change = t - self._last_change
        if per_engine > self.up_rate and n < self.max_engines:
            if since_change < self.cooldown_s:
                return None         # bounded scale rate
            return self._scale_up(demand, per_engine, t)
        if per_engine < self.down_rate and n > self.min_engines:
            if since_change < self.down_cooldown_s:
                return None
            with self._lock:
                victim = self._owned[-1] if self._owned else None
            if victim is None or victim not in self.fleet.addresses:
                return None         # nothing of ours to retire
            self._drain_and_stop(
                victim,
                reason=f"demand {per_engine:.1f}/engine < "
                       f"{self.down_rate:.1f}")
            with self._lock:
                self._last_change = t
            return "scale_down"
        return None

    # -- scale up -----------------------------------------------------------

    def _scale_up(self, demand: float, per_engine: float,
                  t: float) -> Optional[str]:
        try:
            address, stopper = self.spawner()
        except Exception as e:  # noqa: BLE001 — spawn failed; the
            # fleet keeps serving at its current width
            self.spawn_failures += 1
            log.error("autoscaler spawn failed: %s", e)
            return None
        try:
            # startup probe BEFORE rotation (fleet.add_engine probes):
            # first real traffic must not eat the new breaker's budget
            self.fleet.add_engine(address,
                                  wait_ready_s=self.startup_probe_s)
        except Exception as e:  # noqa: BLE001 — never-joined process
            # must not leak
            self.spawn_failures += 1
            self._stop_proc(stopper)
            log.error("autoscaler join of %s failed: %s", address, e)
            return None
        with self._lock:
            self._owned.append(address)
            self._stoppers[address] = stopper
            self._last_change = t
            self.scale_ups += 1
        self._emit(AutoscaleEvent(
            "scale_up", address,
            reason=f"demand {per_engine:.1f}/engine > "
                   f"{self.up_rate:.1f}",
            stats={"demand_rate": round(demand, 1),
                   "engines": len(self.fleet.addresses)}))
        log.info("autoscaler: %s joined (demand %.1f/engine)",
                 address, per_engine)
        return "scale_up"

    # -- scale down: THE drain path -----------------------------------------

    def _drain_and_stop(self, address: str, reason: str,
                        drain: bool = True) -> None:
        """Retire ONE engine safely: out of the rotation first (no new
        requests route to it), wait for its parked connections and
        queue to empty, then stop the process. This is the only place
        the autoscaler removes an engine or stops a process — enforced
        statically by ``check_adaptive_serving``."""
        try:
            self.fleet.remove_engine(address)
        except ValueError:
            pass    # already out of the rotation (e.g. double close)
        if drain and not self._wait_drained(address):
            self.drain_timeouts += 1
            self._emit(AutoscaleEvent(
                "drain_timeout", address,
                reason=f"not drained after {self.drain_timeout_s:.0f}s;"
                       " stopping anyway (requests already answered or"
                       " timed out)"))
        with self._lock:
            stopper = self._stoppers.pop(address, None)
            if address in self._owned:
                self._owned.remove(address)
            self.scale_downs += 1
        self._stop_proc(stopper)
        self._emit(AutoscaleEvent(
            "scale_down", address, reason=reason,
            stats={"engines": len(self.fleet.addresses)}))
        log.info("autoscaler: %s drained + retired (%s)", address,
                 reason)

    def _wait_drained(self, address: str) -> bool:
        """Poll the engine's own /healthz until it holds no parked
        connections and its queue is empty (it is out of the rotation,
        so the counts only fall), bounded by ``drain_timeout_s``."""
        deadline = time.monotonic() + self.drain_timeout_s
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(f"{address}/healthz",
                                            timeout=2.0) as resp:
                    health = json.loads(resp.read())
                if health.get("parked", 1) == 0 \
                        and health.get("queue_depth", 1) == 0:
                    return True
            except Exception:  # noqa: BLE001 — engine already gone
                return True    # counts as drained: nothing listening
            time.sleep(0.05)
        return False

    @staticmethod
    def _stop_proc(stopper: Any) -> None:
        """Stop one spawned engine's process handle: a callable, or a
        Popen-shaped object (terminate, bounded wait, then kill)."""
        if stopper is None:
            return
        if callable(stopper):
            stopper()
            return
        stopper.terminate()
        try:
            stopper.wait(timeout=5)
        except Exception:  # noqa: BLE001 — stuck in shutdown
            stopper.kill()

    # -- observability ------------------------------------------------------

    def _emit(self, event: AutoscaleEvent) -> None:
        self.events.append(event)
        if self.record_event is not None:
            try:
                self.record_event(event)
            except Exception:  # noqa: BLE001 — timeline best-effort
                pass

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            owned = len(self._owned)
        return {
            "engines": len(self.fleet.addresses),
            "owned": owned,
            "min_engines": self.min_engines,
            "max_engines": self.max_engines,
            "up_rate": self.up_rate,
            "down_rate": self.down_rate,
            "demand_rate": self.fleet.demand_rate(self.window_s),
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "drain_timeouts": self.drain_timeouts,
            "spawn_failures": self.spawn_failures,
        }
