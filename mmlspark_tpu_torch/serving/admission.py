"""SLO-aware admission control for the multi-model serving plane: the
port's copy of ``mmlspark_tpu/serving/admission.py`` (host-only).

The source's bounded parked-table/queue shedding protects the
*process*; this layer protects *tenants and tiers from each other* on
top of it: one hot tenant, or a burst of requests for a cold model
mid-activation, must not starve everyone else's SLO.

Two mechanisms, both decided per request on the batcher thread before
any model work happens:

- **Per-tenant quotas** — a token bucket per tenant (``X-Tenant``
  header; absent = ``"default"``): sustained ``rate_per_s`` with a
  ``burst`` allowance. Over-quota requests answer **429** with
  ``Retry-After`` — the tenant's problem, not back-pressure, so the
  fleet client does NOT fail them over to another replica (which would
  just spend the tenant's quota fleet-wide).
- **Priority-tiered shedding** — requests carry ``X-Priority`` (0 =
  high, 1 = normal, 2 = low; absent = 1, values clamp into [0, 2]).
  When the engine shows pressure (prepared batches queued behind busy
  workers plus the source-queue backlog — cold-activation storms and
  hot-model bursts both surface here), tiers shed lowest-first at
  their configured pressure limits,
  answering **503 + Retry-After** exactly like the existing load
  shedding. Default: only priority 2 sheds (above pressure 8); tiers
  0/1 never shed here — the source's own bounds still protect the
  process.

The controller is shared across a fleet's engines (quotas are
fleet-wide, like the model zoo) and thread-safe.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

DEFAULT_TENANT = "default"

PRIORITY_HIGH = 0
PRIORITY_NORMAL = 1
PRIORITY_LOW = 2

# pressure limit per priority tier: a request sheds when the engine's
# dispatch pressure EXCEEDS its tier's limit (None = never shed here)
DEFAULT_PRESSURE_LIMITS: Dict[int, Optional[int]] = {
    PRIORITY_HIGH: None, PRIORITY_NORMAL: None, PRIORITY_LOW: 8}


def header_get(request: Optional[Dict[str, Any]], name: str
               ) -> Optional[str]:
    """Case-insensitive header lookup on a request struct — the ONE
    header-scan implementation (model routing, tenant identity, and
    trace propagation all route through ``core.trace.header_get``, so
    header handling cannot diverge between carriers). This wrapper
    adds the request-struct unwrap and the str() coercion admission
    callers rely on."""
    from mmlspark_tpu_torch.core.trace import header_get as _scan
    value = _scan((request or {}).get("headers") or {}, name)
    return None if value is None else str(value)


def request_identity(request: Optional[Dict[str, Any]]
                     ) -> Tuple[str, int]:
    """(tenant, priority) from a request struct's headers
    (case-insensitive ``X-Tenant`` / ``X-Priority``)."""
    tenant = (header_get(request, "x-tenant") or "").strip() \
        or DEFAULT_TENANT
    priority = PRIORITY_NORMAL
    raw = header_get(request, "x-priority")
    if raw is not None:
        try:
            priority = int(raw.strip())
        except ValueError:
            pass                     # malformed header: keep the default
    return tenant, max(PRIORITY_HIGH, min(PRIORITY_LOW, priority))


class TenantQuota:
    """Token bucket: ``rate_per_s`` sustained, ``burst`` peak (defaults
    to max(1, rate)). Thread-safe; no release bookkeeping — admission
    spends a token, time refills them."""

    def __init__(self, rate_per_s: float, burst: Optional[float] = None):
        self.rate = float(rate_per_s)
        self.burst = float(burst) if burst is not None \
            else max(1.0, self.rate)
        self._tokens = self.burst
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def try_take(self) -> bool:
        with self._lock:
            # clock read INSIDE the lock: a stale `now` from a racing
            # caller would apply a negative refill delta and regress
            # the bucket clock
            now = time.monotonic()
            self._tokens = min(
                self.burst, self._tokens + (now - self._t) * self.rate)
            self._t = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False


class AdmissionController:
    """Per-tenant quotas + priority-tiered shedding (module docstring).

    ``quotas`` maps tenant -> ``TenantQuota`` (or a plain number,
    taken as rate_per_s); ``default_quota`` applies to tenants not
    listed (None = unlimited). ``priority_pressure_limits`` overrides
    ``DEFAULT_PRESSURE_LIMITS`` per tier.
    """

    # bounded per-tenant stats: beyond this many distinct tenants the
    # rest aggregate under "_other" (the metric-cardinality discipline)
    MAX_TENANT_STATS = 64

    def __init__(self,
                 quotas: Optional[Dict[str, Any]] = None,
                 default_quota: Optional[Any] = None,
                 priority_pressure_limits:
                 Optional[Dict[int, Optional[int]]] = None):
        def as_quota(q):
            return q if isinstance(q, TenantQuota) or q is None \
                else TenantQuota(q)

        self.quotas: Dict[str, TenantQuota] = {
            t: as_quota(q) for t, q in (quotas or {}).items()}
        self.default_quota = as_quota(default_quota)
        self.priority_pressure_limits = dict(DEFAULT_PRESSURE_LIMITS)
        if priority_pressure_limits:
            self.priority_pressure_limits.update(priority_pressure_limits)
        self.admitted = 0
        self.shed: Dict[str, int] = {}          # reason -> count
        self._tenant_shed: Dict[str, int] = {}  # tenant -> count (capped)
        self._lock = threading.Lock()

    def decide(self, tenant: str, priority: int,
               pressure: int) -> Optional[str]:
        """Admission verdict for one request: None (admitted),
        ``"priority"`` (tier sheds at this pressure -> 503), or
        ``"quota"`` (tenant bucket empty -> 429)."""
        limit = self.priority_pressure_limits.get(
            priority, self.priority_pressure_limits.get(PRIORITY_LOW))
        if limit is not None and pressure > limit:
            self._record_shed("priority", tenant)
            return "priority"
        quota = self.quotas.get(tenant, self.default_quota)
        if quota is not None and not quota.try_take():
            self._record_shed("quota", tenant)
            return "quota"
        with self._lock:
            self.admitted += 1
        return None

    def _record_shed(self, reason: str, tenant: str) -> None:
        with self._lock:
            self.shed[reason] = self.shed.get(reason, 0) + 1
            if tenant not in self._tenant_shed \
                    and len(self._tenant_shed) >= self.MAX_TENANT_STATS:
                tenant = "_other"
            self._tenant_shed[tenant] = \
                self._tenant_shed.get(tenant, 0) + 1

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"admitted": self.admitted,
                    "shed": dict(self.shed),
                    "shed_by_tenant": dict(self._tenant_shed)}
