"""Unified fault-tolerance primitives: RetryPolicy and Deadline — the
port's copy of ``mmlspark_tpu/utils/resilience.py``, without the
``CircuitBreaker`` (and ``RetryPolicy.call``'s ``breaker=``), which only
the serving fleet uses (ROADMAP item 15, 'The rest of the serving plane').

The single retry implementation of the port (ref: FaultToleranceUtils
ModelDownloader.scala:37-50 and HandlingUtils HTTPClients.scala:47-98):
the HTTP client transformer (``io/http.py::advanced_handler``) routes
through ``RetryPolicy``, so backoff, jitter, exception classification
and deadline budgets behave as in the JAX package. Under the same
seeded ``random.Random`` both draw the same backoff schedule.

Design follows Dean & Barroso, *The Tail at Scale* (hedging/failover over
slow replicas) for the jitter and budget semantics: exponential backoff
with FULL jitter (delay ~ U[0, base * mult^i]) so synchronized retry
storms decorrelate, and a ``Deadline`` object that threads one total
request budget through nested retry loops instead of multiplying
worst-case timeouts.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Optional, Sequence, Tuple, Type

from mmlspark_tpu_torch.core.logging_utils import get_logger

log = get_logger("resilience")


class DeadlineExceeded(TimeoutError):
    """The total request budget ran out (possibly mid-backoff)."""


class Deadline:
    """A total time budget propagated through retry loops.

    ``Deadline.after(2.0)`` gives the whole operation — all attempts AND
    the backoff sleeps between them — two seconds. ``clamp()`` bounds
    per-attempt timeouts and backoff sleeps to what is left, so a retry
    loop can never overshoot the caller's budget.
    """

    def __init__(self, budget_s: Optional[float],
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.budget = budget_s
        self._expires = None if budget_s is None else clock() + budget_s

    @classmethod
    def after(cls, budget_s: float, *,
              clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(budget_s, clock=clock)

    @classmethod
    def none(cls) -> "Deadline":
        """The unbounded deadline (remaining() is +inf, never expires)."""
        return cls(None)

    def remaining(self) -> float:
        if self._expires is None:
            return float("inf")
        return self._expires - self._clock()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0

    def clamp(self, duration: float) -> float:
        """Bound a sleep/timeout to the remaining budget (never < 0)."""
        return max(0.0, min(duration, self.remaining()))

    def check(self) -> None:
        if self.expired:
            raise DeadlineExceeded(
                f"deadline exceeded (budget {self.budget}s)")


class RetryPolicy:
    """Exponential backoff + full jitter with exception classification.

    - ``max_attempts`` total calls of ``fn`` (>= 1).
    - backoff before attempt ``i+1`` is drawn from
      ``U[0, min(base_delay * multiplier**i, max_delay)]`` (full jitter);
      ``jitter="none"`` keeps the deterministic upper bound (the
      pre-unification behavior, still used where tests pin wall-clock).
    - ``schedule`` (seconds) overrides the exponential curve with an
      explicit per-gap list (the HTTPClients.scala fixed-schedule shape);
      jitter still applies to each entry.
    - ``no_retry`` exception types re-raise immediately — deterministic
      failures (4xx client errors, bad input) must not burn the budget.
    - ``retry_on`` limits which exceptions are retried at all (others
      propagate immediately).
    - ``deadline`` (seconds) is a default total budget per ``call``; a
      ``Deadline`` passed to ``call`` wins. Budget exhaustion mid-loop
      raises ``DeadlineExceeded`` (or the last real error if one exists).

    ``call`` also supports *result-classified* retries for clients that
    return error values instead of raising (the HTTP response-struct
    path): pass ``retry_result`` returning True when the result should be
    retried; after the budget is spent the last result is returned as-is.
    """

    def __init__(self, max_attempts: int = 3, base_delay: float = 0.5,
                 multiplier: float = 2.0, max_delay: float = 30.0,
                 jitter: str = "full",
                 no_retry: Tuple[Type[BaseException], ...] = (),
                 retry_on: Tuple[Type[BaseException], ...] = (Exception,),
                 schedule: Optional[Sequence[float]] = None,
                 deadline: Optional[float] = None,
                 rng: Optional[random.Random] = None,
                 name: str = "retry"):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        if jitter not in ("full", "none"):
            raise ValueError(f"jitter must be 'full' or 'none': {jitter!r}")
        self.max_attempts = (len(schedule) + 1 if schedule is not None
                             else max_attempts)
        self.base_delay = base_delay
        self.multiplier = multiplier
        self.max_delay = max_delay
        self.jitter = jitter
        # accept a bare exception class anywhere `except` would
        self.no_retry = (no_retry,) if isinstance(no_retry, type) \
            else tuple(no_retry)
        self.retry_on = (retry_on,) if isinstance(retry_on, type) \
            else tuple(retry_on)
        self.schedule = list(schedule) if schedule is not None else None
        self.deadline_s = deadline
        self._rng = rng or random
        self.name = name

    # -- backoff curve ------------------------------------------------------

    def backoff(self, attempt: int) -> float:
        """Delay before attempt ``attempt + 1`` (0-based), jittered."""
        if self.schedule is not None:
            upper = self.schedule[min(attempt, len(self.schedule) - 1)]
        else:
            upper = min(self.base_delay * self.multiplier ** attempt,
                        self.max_delay)
        if self.jitter == "none":
            return upper
        return self._rng.uniform(0.0, upper)

    # -- the loop -----------------------------------------------------------

    def call(self, fn: Callable[[], Any], *,
             deadline: Optional[Deadline] = None,
             on_retry: Optional[Callable[[Exception, int], None]] = None,
             retry_result: Optional[Callable[[Any], bool]] = None,
             sleep: Optional[Callable[[float], None]] = None) -> Any:
        """Run ``fn`` under this policy. ``sleep`` is injectable for
        deterministic tests (defaults to ``time.sleep``)."""
        dl = deadline if deadline is not None else Deadline(self.deadline_s)
        do_sleep = sleep if sleep is not None else time.sleep
        last_exc: Optional[Exception] = None
        result: Any = None
        for attempt in range(self.max_attempts):
            dl.check()
            try:
                result = fn()
            except self.no_retry:
                # deterministic client-side failure (a 4xx means "you
                # asked wrong", not "I'm down"): no backoff budget burnt
                raise
            except self.retry_on as e:
                last_exc = e
                if attempt == self.max_attempts - 1:
                    raise
                delay = dl.clamp(self.backoff(attempt))
                log.warning("%s: attempt %d/%d failed: %s (backoff %.3fs)",
                            self.name, attempt + 1, self.max_attempts, e,
                            delay)
                if on_retry is not None:
                    on_retry(e, attempt)
                if dl.remaining() <= delay:
                    # sleeping would spend the whole budget — fail now
                    # with the real error rather than a fruitless wait
                    raise
                do_sleep(delay)
                continue
            if retry_result is not None and retry_result(result):
                if attempt == self.max_attempts - 1:
                    return result      # HTTP semantics: hand back the error
                delay = dl.clamp(self.backoff(attempt))
                if dl.remaining() <= delay:
                    return result
                do_sleep(delay)
                continue
            return result
        # only reachable when max_attempts exhausted via retry_result
        if last_exc is not None:
            raise last_exc
        return result
