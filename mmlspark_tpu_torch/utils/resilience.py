"""Unified fault-tolerance primitives: RetryPolicy, CircuitBreaker and
Deadline — the port's copy of ``mmlspark_tpu/utils/resilience.py``.
``CircuitBreaker.on_open`` is the flight recorder's trigger on a
closed-to-open transition.

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
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type

from mmlspark_tpu_torch.core.logging_utils import get_logger

log = get_logger("resilience")


class DeadlineExceeded(TimeoutError):
    """The total request budget ran out (possibly mid-backoff)."""


class CircuitOpenError(RuntimeError):
    """A call was refused because the circuit breaker is open."""

    def __init__(self, name: str, retry_after: float):
        super().__init__(
            f"circuit {name!r} open; retry after {retry_after:.2f}s")
        self.name = name
        self.retry_after = retry_after


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
             breaker: Optional["CircuitBreaker"] = None,
             sleep: Optional[Callable[[float], None]] = None) -> Any:
        """Run ``fn`` under this policy.

        ``breaker`` (optional) gates every attempt: an open circuit
        raises ``CircuitOpenError`` without calling ``fn``, and each
        attempt's outcome is recorded. ``sleep`` is injectable for
        deterministic tests (defaults to ``time.sleep``).
        """
        dl = deadline if deadline is not None else Deadline(self.deadline_s)
        do_sleep = sleep if sleep is not None else time.sleep
        last_exc: Optional[Exception] = None
        result: Any = None
        for attempt in range(self.max_attempts):
            dl.check()
            if breaker is not None and not breaker.allow():
                raise CircuitOpenError(breaker.name, breaker.retry_after())
            try:
                result = fn()
            except self.no_retry:
                # deterministic client-side failure: the backend is
                # answering (a 4xx means "you asked wrong", not "I'm
                # down") — it must not burn the circuit any more than
                # it burns the backoff budget
                if breaker is not None:
                    breaker.record_success()
                raise
            except self.retry_on as e:
                if breaker is not None:
                    breaker.record_failure()
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
                if breaker is not None:
                    breaker.record_failure()
                if attempt == self.max_attempts - 1:
                    return result      # HTTP semantics: hand back the error
                delay = dl.clamp(self.backoff(attempt))
                if dl.remaining() <= delay:
                    return result
                do_sleep(delay)
                continue
            if breaker is not None:
                breaker.record_success()
            return result
        # only reachable when max_attempts exhausted via retry_result
        if last_exc is not None:
            raise last_exc
        return result


class CircuitBreaker:
    """closed → open → half-open breaker with failure-rate threshold.

    - CLOSED: calls flow; ``failure_threshold`` CONSECUTIVE failures, or
      a failure rate >= ``failure_rate`` over the last ``window``
      outcomes (once at least ``min_calls`` are recorded), trips OPEN.
    - OPEN: ``allow()`` is False until ``cooldown`` elapses, then the
      breaker moves to HALF_OPEN.
    - HALF_OPEN: up to ``half_open_max`` concurrent probe calls are let
      through; a success closes the breaker, a failure re-opens it with
      a fresh cooldown.

    Thread-safe; the serving fleet keeps one per engine.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 5,
                 failure_rate: Optional[float] = None,
                 window: int = 20, min_calls: int = 5,
                 cooldown: float = 5.0, half_open_max: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "breaker"):
        self.failure_threshold = failure_threshold
        self.failure_rate = failure_rate
        self.window = window
        self.min_calls = min_calls
        self.cooldown = cooldown
        self.half_open_max = half_open_max
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._outcomes: List[bool] = []   # sliding window, True = failure
        self._opened_at = 0.0
        self._half_open_inflight = 0
        self.times_opened = 0
        # optional closed->open transition hook (the flight recorder's
        # auto-capture trigger rides it): called OUTSIDE the breaker
        # lock, exceptions swallowed — a sick observer must never wedge
        # the breaker
        self.on_open: Optional[Callable[["CircuitBreaker"], None]] = None

    # -- state --------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def retry_after(self) -> float:
        """Seconds until an open breaker will admit a probe (0 if it
        already would)."""
        with self._lock:
            if self._state != self.OPEN:
                return 0.0
            return max(0.0, self._opened_at + self.cooldown - self._clock())

    def _maybe_half_open(self) -> None:
        if self._state == self.OPEN and \
                self._clock() - self._opened_at >= self.cooldown:
            self._state = self.HALF_OPEN
            self._half_open_inflight = 0

    def _trip(self) -> None:
        self._state = self.OPEN
        self._opened_at = self._clock()
        self.times_opened += 1
        log.warning("circuit %s OPEN (consecutive=%d, window=%s)",
                    self.name, self._consecutive_failures,
                    self._outcomes[-self.window:])

    # -- the gate -----------------------------------------------------------

    def allow(self) -> bool:
        """True if a call may proceed now. Half-open admissions count
        against ``half_open_max`` until an outcome is recorded."""
        with self._lock:
            self._maybe_half_open()
            if self._state == self.CLOSED:
                return True
            if self._state == self.HALF_OPEN:
                if self._half_open_inflight < self.half_open_max:
                    self._half_open_inflight += 1
                    return True
                return False
            return False

    def reset(self) -> None:
        """Force CLOSED — an out-of-band success observation (e.g. a
        last-resort probe answered while the breaker was still OPEN)."""
        with self._lock:
            self._state = self.CLOSED
            self._consecutive_failures = 0
            self._half_open_inflight = 0

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._outcomes.append(False)
            del self._outcomes[:-self.window]
            if self._state == self.HALF_OPEN:
                self._state = self.CLOSED
                self._half_open_inflight = 0
                log.info("circuit %s CLOSED after successful probe",
                         self.name)

    def record_failure(self) -> None:
        # ``tripped`` drives on_open and is set ONLY on the
        # closed->open transition: a half-open probe failing during a
        # sustained outage re-trips every cooldown, and firing the
        # hook each time would churn the flight recorder's bounded
        # bundle deque until the ORIGINAL incident's bundle — the
        # evidence the hook exists to capture — is evicted
        tripped = False
        with self._lock:
            self._consecutive_failures += 1
            self._outcomes.append(True)
            del self._outcomes[:-self.window]
            if self._state == self.HALF_OPEN:
                self._trip()
            elif self._state == self.CLOSED:
                if self._consecutive_failures >= self.failure_threshold:
                    self._trip()
                    tripped = True
                elif (self.failure_rate is not None
                      and len(self._outcomes) >= self.min_calls
                      and (sum(self._outcomes) / len(self._outcomes)
                           >= self.failure_rate)):
                    self._trip()
                    tripped = True
        if tripped and self.on_open is not None:
            try:
                self.on_open(self)
            except Exception as e:  # noqa: BLE001 — observer only
                log.error("circuit %s on_open hook failed: %s",
                          self.name, e)

    def call(self, fn: Callable[[], Any]) -> Any:
        """One gated call: open circuit raises CircuitOpenError; the
        outcome (exception vs return) is recorded."""
        if not self.allow():
            raise CircuitOpenError(self.name, self.retry_after())
        try:
            result = fn()
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            self._maybe_half_open()
            n = len(self._outcomes)
            return {"state": self._state,
                    "consecutive_failures": self._consecutive_failures,
                    "window_failure_rate":
                        (sum(self._outcomes) / n) if n else 0.0,
                    "times_opened": self.times_opened}
