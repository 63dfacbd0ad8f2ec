"""Threaded host -> device input prefetching of the PyTorch port (see
``mmlspark_tpu/utils/prefetch.py``).

A background thread builds the next minibatch (slice, pad, pinned host
copy, ``non_blocking`` upload) while the current one runs on the card.
The upload is queued on the card's stream in order with the compute, so
depth 2 keeps the stream fed.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

import torch

_SENTINEL = object()


class ThreadedPrefetcher:
    """Wrap an iterable, applying ``prepare`` in a background thread and
    buffering up to ``depth`` prepared items ahead of the consumer.
    Exceptions in the worker are re-raised at the consuming ``__next__``.
    """

    def __init__(self, source: Iterable[Any],
                 prepare: Callable[[Any], Any], depth: int = 2):
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=max(depth, 1))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

        def put_or_abort(item) -> bool:
            """Stop-aware put: never blocks forever once close() ran."""
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in source:
                    if self._stop.is_set():
                        return
                    if not put_or_abort(prepare(item)):
                        return
            except BaseException as e:  # noqa: BLE001 — forwarded to consumer
                self._err = e
            finally:
                put_or_abort(_SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the worker and drain until it has exited, so no prepared
        batch lingers on the card."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                self._thread.join(timeout=0.05)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break


class SyncPrefetcher:
    """Same interface, no thread: prepare each item inline."""

    def __init__(self, source: Iterable[Any],
                 prepare: Callable[[Any], Any], depth: int = 2):
        self._it = iter(source)
        self._prepare = prepare

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        return self._prepare(next(self._it))

    def close(self) -> None:
        pass


def make_prefetcher(source: Iterable[Any], prepare: Callable[[Any], Any],
                    device: torch.device, depth: int = 2):
    """The threaded prefetcher for a CUDA device, where the host's batch
    assembly overlaps the card's work; inline on the CPU, where both
    would compete for the same cores."""
    cls = ThreadedPrefetcher if device.type == "cuda" else SyncPrefetcher
    return cls(source, prepare, depth=depth)
