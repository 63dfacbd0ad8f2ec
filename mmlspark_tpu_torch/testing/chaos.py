"""Deterministic, seedable chaos-injection harness for the serving fleet.

The port's copy of ``mmlspark_tpu/testing/chaos.py``; a fault decision
is the same pure function of ``(seed, kind, key)`` in both packages.

Chaos engineering (Basiri et al., *Chaos Engineering*, IEEE Software
2016) verifies an availability property by injecting the faults that
threaten it and measuring the property under load. This module is the
injection side: a ``FaultInjector`` that wraps any serving pipeline to
inject exceptions, added latency, and dropped replies, plus engine-level
faults (hard kills, stalls, worker-thread kills) aimed at a
``ServingFleet``. The availability assertions live in
``tests/test_torch_chaos.py``.

Determinism: per-row fault decisions are a pure hash of
``(seed, fault kind, request key)`` where the key is the request body
(falling back to the request id). The same seed + the same payloads give
the same faults regardless of batching, worker count, client
concurrency, or the engine's per-row poison-isolation retry — a poison
row re-raises when retried alone, exactly like a real deterministic
failure.

The wrapper is deliberately NOT a registered pipeline stage: it
duck-types ``transform`` / ``transform_schema`` so the chaos harness
stays out of the framework's stage registry (and its fuzzing-coverage
contract).
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Dict, Optional

from mmlspark_tpu_torch.core.logging_utils import get_logger

log = get_logger("testing.chaos")


class ChaosError(RuntimeError):
    """The exception injected into wrapped pipelines."""


class _ChaosPipeline:
    """Duck-typed pipeline wrapper: consult the injector, then delegate.

    Injected faults, in order:
    - armed worker kills raise ``SystemExit`` (escapes the engine loop's
      ``except Exception`` guard — the worker thread dies, which is the
      supervisor-restart scenario);
    - added latency sleeps before the inner transform;
    - injected errors raise ``ChaosError`` (batch-level first, then
      deterministically again when the engine retries the row alone —
      the poison-row path);
    - dropped replies remove rows from the output table (the engine
      answers those requests "row dropped by pipeline").
    """

    def __init__(self, inner, injector: "FaultInjector"):
        self.inner = inner
        self.injector = injector

    def _keys(self, table):
        if "request" in table.column_names:
            return [self.injector.request_key(r) for r in table["request"]]
        return [str(i).encode() for i in range(len(table))]

    def transform(self, table):
        inj = self.injector
        inj._consume_worker_kill()
        keys = self._keys(table)
        if inj.latency_s > 0:
            # latency decisions are PER ROW (like error/drop), so the
            # total injected delay over a run is batching-independent;
            # the sleep itself is necessarily batch-granular, so which
            # batchmates share a given stall still depends on arrival
            slow_rows = sum(inj.decide("latency", k) for k in keys)
            if slow_rows:
                with inj._lock:
                    inj.injected_latency_rows += slow_rows
                time.sleep(inj.latency_s * slow_rows)
        poison = [k for k in keys if inj.decide("error", k)]
        if poison:
            with inj._lock:
                inj.injected_errors += 1
            raise ChaosError(
                f"injected failure for {len(poison)} row(s) "
                f"(seed {inj.seed})")
        out = self.inner.transform(table)
        if inj.drop_rate > 0 and keys:
            keep = [not inj.decide("drop", k) for k in keys]
            if not all(keep):
                with inj._lock:
                    inj.injected_drops += keep.count(False)
                # rows in the INPUT order; output may reorder, so match
                # by id when present (the serving contract keys on id)
                if "id" in out.column_names and "id" in table.column_names:
                    dropped = {rid for rid, k in zip(table["id"], keep)
                               if not k}
                    out = out.filter(
                        lambda row: row["id"] not in dropped)
                else:
                    import numpy as np
                    out = out.filter(np.asarray(keep[:len(out)]))
        return out

    def transform_schema(self, schema):
        return self.inner.transform_schema(schema)


class FaultInjector:
    """Seeded fault source for chaos tests.

    - ``error_rate``: probability a request's row raises ``ChaosError``.
    - ``drop_rate``: probability a row's reply is dropped from the
      output (the engine then 500s that request only).
    - ``latency_s`` + ``latency_rate``: per-row probability of adding
      ``latency_s`` of stall before scoring (tail-latency injection);
      the batch sleeps once per selected row.

    All decisions are pure functions of ``(seed, kind, request key)`` —
    see ``decide`` — so a run is reproducible end-to-end. Engine-level
    faults (``kill_engine``, ``stall_engine``, ``arm_worker_kill``) model
    crashed processes, wedged processes, and dead drainer threads.
    """

    def __init__(self, seed: int = 0, error_rate: float = 0.0,
                 drop_rate: float = 0.0, latency_s: float = 0.0,
                 latency_rate: float = 0.0):
        self.seed = int(seed)
        self.error_rate = float(error_rate)
        self.drop_rate = float(drop_rate)
        self.latency_s = float(latency_s)
        self.latency_rate = float(latency_rate)
        self.injected_errors = 0
        self.injected_drops = 0
        self.injected_latency_rows = 0
        self.worker_kills_fired = 0
        self._armed_worker_kills = 0
        self._lock = threading.Lock()

    # -- deterministic decisions -------------------------------------------

    @staticmethod
    def request_key(request: Optional[Dict[str, Any]]) -> bytes:
        """Stable identity of a request: its body bytes (the payload is
        what a test controls), falling back to empty."""
        if not request:
            return b""
        entity = request.get("entity")
        if isinstance(entity, str):
            return entity.encode("utf-8")
        return bytes(entity or b"")

    def _unit(self, kind: str, key: bytes) -> float:
        h = hashlib.sha256(
            f"{self.seed}:{kind}:".encode() + key).digest()
        return int.from_bytes(h[:8], "big") / 2.0 ** 64

    def decide(self, kind: str, key: bytes) -> bool:
        rate = {"error": self.error_rate, "drop": self.drop_rate,
                "latency": self.latency_rate}[kind]
        return rate > 0 and self._unit(kind, key) < rate

    # -- pipeline-level faults ---------------------------------------------

    def wrap(self, pipeline) -> _ChaosPipeline:
        """Wrap a pipeline (anything with ``transform``) so every
        serving micro-batch consults this injector first."""
        return _ChaosPipeline(pipeline, self)

    # -- engine-level faults -----------------------------------------------

    def arm_worker_kill(self, n: int = 1) -> None:
        """The next ``n`` wrapped-transform calls raise ``SystemExit``,
        killing the engine worker thread that ran them (supervisor
        restart drill)."""
        with self._lock:
            self._armed_worker_kills += n

    def _consume_worker_kill(self) -> None:
        with self._lock:
            if self._armed_worker_kills <= 0:
                return
            self._armed_worker_kills -= 1
            self.worker_kills_fired += 1
        log.warning("chaos: killing serving worker thread (SystemExit)")
        raise SystemExit("chaos worker kill")

    @staticmethod
    def kill_engine(fleet, index: int) -> None:
        """Crash one engine: listener gone, clients see
        connection-refused (the killed-process shape)."""
        log.warning("chaos: killing engine %d", index)
        fleet.kill_engine(index, close_source=True)

    @staticmethod
    def kill_engine_after(fleet, index: int, delay_s: float
                          ) -> threading.Thread:
        """Arm a delayed engine kill on a daemon timer — the
        mid-swap-crash drill: start a rolling swap, have this fire
        while it is in flight, and the lifecycle layer must roll the
        dead engine's swap back (decision timeout) while the rest of
        the fleet completes."""
        def fire():
            time.sleep(delay_s)
            try:
                FaultInjector.kill_engine(fleet, index)
            except Exception:  # noqa: BLE001 — already stopped
                pass
        t = threading.Thread(target=fire, daemon=True,
                             name="chaos-delayed-kill")
        t.start()
        return t

    @staticmethod
    def stall_engine(fleet, index: int) -> None:
        """Wedge one engine: it keeps ACCEPTING requests but never
        replies — clients burn their timeout (the stalled-process shape
        that circuit breakers exist for)."""
        log.warning("chaos: stalling engine %d", index)
        fleet.kill_engine(index, close_source=False)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {"injected_errors": self.injected_errors,
                    "injected_drops": self.injected_drops,
                    "injected_latency_rows":
                        self.injected_latency_rows,
                    "worker_kills_fired": self.worker_kills_fired}


# ---------------------------------------------------------------------------
# swap-phase faults (the model-lifecycle chaos drills)
# ---------------------------------------------------------------------------


class PoisonedModel:
    """A model that passes warmup but errors on live batches — the
    looks-fine-until-production canary shape. ``fail_batches`` bounds
    the poison (float('inf') = always); after that many failed batches
    it behaves (the transient-poison variant).

    Deliberately duck-typed like _ChaosPipeline (transform /
    transform_schema / warmup), so the lifecycle layer sees a normal
    pipeline: ``warmup`` succeeds (delegating to the inner hook when
    present), then the first ``fail_batches`` transform calls raise.
    The canary controller must catch this and roll back without the
    fleet's error floor breaching (failed canary batches rescue onto
    the stable version)."""

    def __init__(self, inner, fail_batches: float = float("inf")):
        self.inner = inner
        self.fail_batches = fail_batches
        self.batches_poisoned = 0
        self.warmup_calls = 0
        self._lock = threading.Lock()

    def warmup(self, example=None, *a, **kw):
        """Passes — poison only manifests under live traffic."""
        with self._lock:
            self.warmup_calls += 1
        hook = getattr(self.inner, "warmup", None)
        if callable(hook) and example is not None:
            return hook(example, *a, **kw)
        return 0

    def transform(self, table):
        with self._lock:
            if self.batches_poisoned < self.fail_batches:
                self.batches_poisoned += 1
                raise ChaosError(
                    f"poisoned model: batch {self.batches_poisoned}")
        return self.inner.transform(table)

    def transform_schema(self, schema):
        return self.inner.transform_schema(schema)


class StalledWarmupModel:
    """A model whose ``warmup`` never returns within any sane budget —
    the wedged-compile shape. The swap protocol must time the warmup
    out and roll back WITHOUT the engine ever routing traffic to this
    model (its transform still works; the stall is purely in warmup)."""

    def __init__(self, inner, stall_s: float = 3600.0):
        self.inner = inner
        self.stall_s = float(stall_s)
        self.warmup_started = threading.Event()

    def warmup(self, example=None, *a, **kw):
        self.warmup_started.set()
        time.sleep(self.stall_s)
        return 0

    def transform(self, table):
        return self.inner.transform(table)

    def transform_schema(self, schema):
        return self.inner.transform_schema(schema)
