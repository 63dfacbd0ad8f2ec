"""Async/concurrency helpers: the port's copy of
``mmlspark_tpu/utils/async_utils.py`` (ref:
src/core/utils/src/main/scala/AsyncUtils.scala).

``buffered_map`` reproduces the reference's bounded-concurrency buffered
futures pattern used by the HTTP AsyncClient
(ref: src/io/http/src/main/scala/Clients.scala:102-116): results stream in
input order while at most ``concurrency`` tasks are in flight.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")
U = TypeVar("U")


def buffered_map(fn: Callable[[T], U], items: Iterable[T],
                 concurrency: int = 8,
                 timeout: Optional[float] = None) -> Iterator[U]:
    """Map ``fn`` over ``items`` with a sliding window of futures,
    yielding results in input order."""
    items = iter(items)
    with ThreadPoolExecutor(max_workers=concurrency) as pool:
        window: list[Future] = []
        try:
            for _ in range(concurrency):
                window.append(pool.submit(fn, next(items)))
        except StopIteration:
            pass
        while window:
            fut = window.pop(0)
            try:
                window.append(pool.submit(fn, next(items)))
            except StopIteration:
                pass
            yield fut.result(timeout=timeout)


def retry_with_backoff(fn: Callable[[], U],
                       retries: int = 3,
                       initial_delay: float = 0.1,
                       backoff: float = 2.0,
                       exceptions=(Exception,),
                       on_retry: Optional[Callable[[Exception, int], None]] = None
                       ) -> U:
    """ref: downloader FaultToleranceUtils.retryWithTimeout
    (ModelDownloader.scala:37-50) and HTTP retry
    (HTTPClients.scala:47-97).

    Back-compat shim over the unified ``utils.resilience.RetryPolicy``
    (``retries`` is the number of RE-tries, so ``retries + 1`` total
    attempts; exceptions outside ``exceptions`` propagate immediately)."""
    from mmlspark_tpu_torch.utils.resilience import RetryPolicy
    if not isinstance(exceptions, tuple):    # bare class, like `except`
        exceptions = (exceptions,)
    return RetryPolicy(max_attempts=retries + 1, base_delay=initial_delay,
                       multiplier=backoff, retry_on=exceptions,
                       name="async_utils").call(fn, on_retry=on_retry)
