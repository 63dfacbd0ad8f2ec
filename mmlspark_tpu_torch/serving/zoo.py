"""Multi-model serving plane: a zoo of versioned models behind one fleet
— the port's copy of ``mmlspark_tpu/serving/zoo.py``.

``ModelZoo`` follows Clipper's model-abstraction layer (Crankshaw et
al., NSDI'17) and INFaaS's automated model placement (Romero et al.,
ATC'21): many versioned models, one fleet, bounded tail latency.

- **Distribution format = the AOT artifact store** (serving/aot.py).
  ``register_artifact``/``scan`` point at ``<root>/<name>/<version>/``
  directories; activation is ``load_model`` + the weights to the
  device + warmup, with no export or tracing on the way, so a cold
  model can activate while the fleet serves. Factories and eager
  pipelines are also accepted (tests, non-AOT models).
- **Device-memory-aware cache.** Models load lazily on FIRST request
  (a daemon loader thread, never the serving hot path) and evict LRU
  under pressure: a resident-count cap, an estimated-bytes cap, and —
  when the backend reports them — ``utils.profiling.mesh_memory_stats``
  as the live signal (``bytes_in_use`` — the caching allocator's
  ALLOCATED bytes, not its reserved ones, so an eviction relieves the
  signal at once — over ``memory_headroom`` x ``bytes_limit``).
  Eviction NEVER touches a model with outstanding batches: the victim
  scan and the hot path's ``acquire`` run under one lock, so a batch
  routed to a handle pins it until the worker releases. An evicted
  stage's ``unload`` hook drops its card tensors (``AOTTPUModel`` and
  ``FusedPipelineModel`` have one), so the memory comes back even
  while something still references the stage object.
- **Model-routed hot path.** Requests carry ``model=name@version`` (an
  ``X-Model`` header, a ``/models/<name@version>`` URL path, or a
  ``?model=`` query — see ``model_key_of``); the engine's batcher keys
  micro-batches by (model, bucket) so a batch never mixes models, and
  every reply echoes ``X-Model`` so clients can audit the routing.
- **Audit + observability.** Every register/activate/evict/load-failure
  lands a ``ZooEvent`` in the registry event log (the ``SwapEvent``
  discipline); per-model metadata rides ``serving_model_info{model,
  version,precision,aot,state}`` and per-model latency histograms ride
  ``serving_model_latency_ms{model=...}`` under a hard
  label-cardinality cap (overflow models fold into ``model="_other"``
  — docs/model_zoo.md). A zoo-attached engine's SLO monitor
  (core/slo.py) also records its burn-rate ``AlertEvent``s into the
  SAME inherited event log, so swaps, evictions, and SLO breaches read
  as one interleaved timeline — and its per-model SLO streams follow
  this module's cardinality-cap discipline (overflow models share the
  ``"_other"`` stream).

``ModelZoo`` *is* a ``ModelRegistry``: the version-ordered bookkeeping,
``lookup``/``list`` consistent-snapshot reads, and the event log are
inherited, with keys of the form ``"name@version"``.

What the port does differently:

- ``ModelZoo(device=...)`` is the device artifacts load on (None = the
  card, as every entry point of the port; the CPU tests pass
  ``"cpu"``); the reference loads onto its default backend.
- An activation on the card runs on the loader's own
  ``torch.cuda.Stream``: the weights' upload and the warmup forward
  queue there, not in front of resident models' batches on the
  default stream, and the stream is synchronized before the entry
  turns ``RESIDENT``.
- A model's measured ``resident_bytes`` is one device's sum (the port
  has no mesh).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import queue
import threading
import time
import urllib.parse
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.core.metrics import LabelledHistograms
from mmlspark_tpu_torch.serving.lifecycle import ModelRegistry
from mmlspark_tpu_torch.serving.server import PipelineHandle

log = get_logger("serving.zoo")

# entry lifecycle states (reported by lookup()/list()/stats())
UNLOADED = "unloaded"     # registered, not resident (never loaded/evicted)
LOADING = "loading"       # a loader thread is activating it
RESIDENT = "resident"     # live handle, serving
FAILED = "failed"         # last activation raised (retried after cooldown)

# acquire() verdicts that are not entry states
UNKNOWN = "unknown"


def model_key_of(request: Optional[Dict[str, Any]]) -> Optional[str]:
    """The ``name@version`` (or bare ``name``) a request routes to, or
    None for the engine's default pipeline. Three carriers, checked in
    order: the ``X-Model`` header (case-insensitive), a
    ``/models/<spec>`` URL path, a ``?model=<spec>`` query param."""
    if not request:
        return None
    from mmlspark_tpu_torch.serving.admission import header_get
    header = header_get(request, "x-model")
    if header is not None:
        spec = header.strip()
        return spec or None
    uri = (request.get("requestLine") or {}).get("uri", "") or ""
    parts = urllib.parse.urlsplit(uri)
    path = parts.path or ""
    if path.startswith("/models/"):
        spec = urllib.parse.unquote(path[len("/models/"):]).strip("/")
        if spec:
            return spec
    if parts.query:
        q = urllib.parse.parse_qs(parts.query)
        if q.get("model"):
            spec = q["model"][0].strip()
            return spec or None
    return None


class ZooEvent:
    """Typed audit record: one zoo lifecycle decision (the ``SwapEvent``
    discipline applied to the multi-model plane). Recorded into the
    inherited registry event log, so one audit trail tells the whole
    lifecycle story — swaps and zoo churn interleaved by time."""

    def __init__(self, kind: str, model: str, version: str,
                 reason: str = "",
                 stats: Optional[Dict[str, Any]] = None):
        self.kind = kind      # 'register'|'activate'|'evict'|'load_failed'
        self.model = model
        self.version = version
        self.reason = reason
        self.stats = dict(stats or {})
        self.at = time.time()

    def __repr__(self) -> str:
        extra = f", reason={self.reason!r}" if self.reason else ""
        if "ms" in self.stats:
            extra += f", {self.stats['ms']:.0f}ms"
        return (f"ZooEvent({self.kind}, {self.model!r}@"
                f"{self.version!r}{extra})")


class ZooEntry:
    """One registered (name, version): its source, lifecycle state, and
    (when resident) the live ``PipelineHandle``. All fields are guarded
    by the zoo's registry lock."""

    __slots__ = ("name", "version", "key", "kind", "source", "metadata",
                 "state", "handle", "cost_bytes", "last_used", "loads",
                 "evictions", "pinned", "failure", "failed_at",
                 "loading_since", "waiters")

    def __init__(self, name: str, version: str, kind: str, source: Any,
                 metadata: Optional[Dict[str, Any]] = None):
        self.name = str(name)
        self.version = str(version)
        self.key = f"{self.name}@{self.version}"
        self.kind = kind              # 'artifact' | 'factory' | 'pipeline'
        self.source = source
        self.metadata = dict(metadata or {})
        self.state = UNLOADED
        self.handle: Optional[PipelineHandle] = None
        self.cost_bytes = int(self.metadata.get("cost_bytes", 0))
        self.last_used = 0
        self.loads = 0
        self.evictions = 0
        self.pinned = False
        self.failure: Optional[str] = None
        self.failed_at = 0.0
        self.loading_since = 0.0
        # engines parked on this model (requests waiting for its
        # activation): eviction must not touch an awaited model, or
        # demand > capacity becomes a load/evict livelock — the model
        # would evict between its activation and the batcher's flush
        # poll, reload, and starve its requests forever
        self.waiters = 0


# default for ModelZoo(memory_probe=...): "use device_memory_stats".
# A sentinel, NOT None — explicit None must mean "live signal OFF"
# (tests/benches on CPU, hosts where JAX preallocation makes
# bytes_in_use meaningless), and a default of None could never be
# told apart from that.
_DEFAULT_PROBE = object()


class ModelZoo(ModelRegistry):
    """A ``ModelRegistry`` grown into a device-memory-aware lazy cache
    of serving-ready models (see module docstring).

    Budget knobs (any subset; unset = unbounded on that axis):

    - ``max_resident``: hard cap on resident model count (LRU beyond).
    - ``max_resident_bytes``: cap on the sum of per-model cost
      estimates (artifact weight/program file sizes; ``cost_bytes``
      metadata or a duck-typed ``resident_bytes`` hook override).
    - ``memory_probe`` + ``memory_headroom``: live signal — when the
      probe (default ``utils.profiling.mesh_memory_stats``; None turns
      the live signal off) reports ``bytes_in_use`` above ``headroom`` x
      ``bytes_limit``, LRU models evict down to (but never below) one
      resident — full eviction would just thrash reloads.

    ``label_cardinality_cap`` bounds the per-model metric label space:
    at most that many models get their own ``serving_model_info`` /
    ``serving_model_latency_ms`` series; latency overflow folds into
    ``model="_other"`` (``serving_zoo_models{state=...}`` always counts
    everything). Thread-safe throughout; loads run on a daemon loader
    thread so activation storms never block the serving hot path.
    ``device`` is where artifacts load (None = the card).
    """

    def __init__(self, artifact_root: Optional[str] = None,
                 max_resident: Optional[int] = None,
                 max_resident_bytes: Optional[int] = None,
                 memory_probe: Any = _DEFAULT_PROBE,
                 memory_headroom: float = 0.9,
                 label_cardinality_cap: int = 64,
                 failure_cooldown_s: float = 30.0,
                 loading_requeue_s: float = 10.0,
                 device: Any = None):
        super().__init__()
        # the device artifacts load on (None = the card); factories and
        # pipelines bring their own
        self.device = device
        self._load_stream = None       # the loader's CUDA stream (lazy)
        self._entries: Dict[str, ZooEntry] = {}
        self._by_name: Dict[str, List[str]] = {}
        self.max_resident = max_resident
        self.max_resident_bytes = max_resident_bytes
        if memory_probe is _DEFAULT_PROBE:
            # the allocator's allocated bytes summed over the process's
            # cards (utils/profiling): None until CUDA is initialised
            from mmlspark_tpu_torch.utils.profiling import mesh_memory_stats
            memory_probe = mesh_memory_stats
        self.memory_probe = memory_probe   # None = live signal OFF
        self.memory_headroom = float(memory_headroom)
        self.failure_cooldown_s = float(failure_cooldown_s)
        self.loading_requeue_s = float(loading_requeue_s)
        self.label_cardinality_cap = int(label_cardinality_cap)
        self._model_hists = LabelledHistograms(cap=label_cardinality_cap)
        # monotone recency ticks (itertools.count: atomic under the GIL)
        self._tick = itertools.count(1)
        self._load_q: "queue.Queue[Optional[str]]" = queue.Queue()
        self._loader: Optional[threading.Thread] = None
        self._loader_lock = threading.Lock()
        self._last_enforce = 0.0
        self.activations = 0
        self.evictions = 0
        self.load_failures = 0
        # the chaos drill's invariant probe: bumped if an eviction ever
        # observes outstanding batches on its victim (must stay 0 — the
        # victim scan and acquire share the registry lock)
        self.evictions_with_outstanding = 0
        self.artifact_root = artifact_root
        if artifact_root:
            self.scan(artifact_root)

    # -- registration -------------------------------------------------------

    def _register_entry(self, entry: ZooEntry) -> None:
        with self._lock:
            if entry.key in self._entries:
                raise ValueError(f"model {entry.key!r} already registered")
            self._entries[entry.key] = entry
            self._by_name.setdefault(entry.name, []).append(entry.version)
            # keep the inherited registry bookkeeping coherent:
            # versions()/latest()/previous() see zoo keys; the pipeline
            # slot holds the RESIDENT object (None while unloaded)
            self._versions[entry.key] = None
            self._order.append(entry.key)
            self._meta[entry.key] = entry.metadata
        self.record_event(ZooEvent("register", entry.name, entry.version,
                                   stats={"kind": entry.kind}))

    def register_artifact(self, name: str, version: str, art_dir: str,
                          metadata: Optional[Dict[str, Any]] = None
                          ) -> None:
        """Register an AOT artifact directory (serving/aot.py
        ``export_model`` output) as a lazily-activated model. The
        manifest is read now (cheap) for precision/aot/bucket metadata;
        weights/programs load on first request."""
        from mmlspark_tpu_torch.serving.aot import read_manifest
        manifest = read_manifest(art_dir)
        meta = dict(metadata or {})
        meta.setdefault("precision", manifest.get("precision", "f32"))
        meta.setdefault("aot", True)
        meta.setdefault("buckets", manifest.get("buckets"))
        meta.setdefault("artifact_kind", manifest.get("kind"))
        entry = ZooEntry(name, version, "artifact", art_dir, meta)
        if not entry.cost_bytes:
            entry.cost_bytes = _artifact_bytes(art_dir)
        self._register_entry(entry)

    def register_factory(self, name: str, version: str,
                         factory: Callable[[], Any],
                         metadata: Optional[Dict[str, Any]] = None
                         ) -> None:
        """Register a zero-arg factory returning a serving stage (the
        ``json_scoring_pipeline`` contract). ``metadata``'s optional
        ``warmup_example`` runs the stage's warmup hook at activation;
        ``cost_bytes`` feeds the bytes budget."""
        entry = ZooEntry(name, version, "factory", factory, metadata)
        self._register_entry(entry)

    def register_pipeline(self, name: str, version: str, pipeline: Any,
                          metadata: Optional[Dict[str, Any]] = None
                          ) -> None:
        """Register an already-built serving stage (loads instantly —
        the eager path for models that are already in memory)."""
        entry = ZooEntry(name, version, "pipeline", pipeline, metadata)
        self._register_entry(entry)

    def scan(self, artifact_root: Optional[str] = None) -> List[str]:
        """Discover ``<root>/<name>/<version>/manifest.json`` artifact
        directories and register every (name, version) not yet known.
        Returns the newly registered keys — the zoo's pull-based analog
        of the reference's model downloader."""
        root = artifact_root or self.artifact_root
        if not root or not os.path.isdir(root):
            return []
        added: List[str] = []
        for name in sorted(os.listdir(root)):
            name_dir = os.path.join(root, name)
            if not os.path.isdir(name_dir):
                continue
            # NATURAL version order, not lexicographic: plain sorted()
            # would register v9 after v12 and bare-name resolution
            # (latest = last registered) would serve the wrong model
            for version in sorted(os.listdir(name_dir),
                                  key=_natural_key):
                art_dir = os.path.join(name_dir, version)
                if not os.path.isfile(
                        os.path.join(art_dir, "manifest.json")):
                    continue
                key = f"{name}@{version}"
                with self._lock:
                    known = key in self._entries
                if known:
                    continue
                try:
                    self.register_artifact(name, version, art_dir)
                    added.append(key)
                except Exception as e:  # noqa: BLE001 — skip bad dirs
                    log.warning("zoo scan: skipping %s (%s)", art_dir, e)
        return added

    # -- resolution + the hot-path acquire ----------------------------------

    def _resolve_locked(self, spec: str) -> Optional[str]:
        spec = str(spec).strip()
        if spec in self._entries:
            return spec
        versions = self._by_name.get(spec)
        if versions:
            return f"{spec}@{versions[-1]}"    # bare name -> latest
        return None

    def resolve(self, spec: str) -> Optional[str]:
        """``name`` or ``name@version`` -> the full key (bare names
        resolve to the latest registered version), or None."""
        with self._lock:
            return self._resolve_locked(spec)

    def registered_names(self) -> List[str]:
        """Sorted model names (ops/introspection; error paths use the
        capped ``names_preview`` instead)."""
        with self._lock:
            names = list(self._by_name)
        return sorted(names)

    def _names_preview_locked(self, cap: int = 20) -> str:
        """Short registered-names string (registry lock held). Capped:
        a 404 body must not embed a 256-name list, and the batcher
        must not sort the whole registry per bad request."""
        n = len(self._by_name)
        names = sorted(itertools.islice(self._by_name, cap + 1))[:cap]
        if n > cap:
            names.append(f"... ({n} total)")
        return ", ".join(names) if names else "(none)"

    def names_preview(self, cap: int = 20) -> str:
        """``_names_preview_locked`` with the lock taken (the server's
        unknown-model 404 body)."""
        with self._lock:
            return self._names_preview_locked(cap)

    def add_waiter(self, spec: str) -> None:
        """An engine parked requests awaiting this model's activation:
        until ``remove_waiter``, eviction will not touch it (the
        outstanding-batches rule extended to queued demand — without
        it, demand > capacity livelocks: an awaited model evicts
        between activation and the batcher's flush poll, reloads, and
        its requests starve to the activation timeout)."""
        with self._lock:
            key = self._resolve_locked(spec)
            if key is not None:
                self._entries[key].waiters += 1

    def remove_waiter(self, spec: str) -> None:
        """Release one ``add_waiter`` hold (flush, timeout, or load
        failure — every parked key removes its waiter exactly once)."""
        with self._lock:
            key = self._resolve_locked(spec)
            if key is not None:
                e = self._entries[key]
                if e.waiters > 0:
                    e.waiters -= 1

    def acquire(self, spec: str
                ) -> Tuple[Optional[PipelineHandle], str, str]:
        """The batcher's non-blocking resolve: returns
        ``(handle, state, message)``.

        - ``resident``: the handle, ALREADY acquired (outstanding
          bumped under the registry lock — atomic with the eviction
          scan, so the victim can never be a model with batches in
          flight). The caller must eventually ``release()`` it (the
          engine's worker does, like any batch handle).
        - ``loading``: activation scheduled/running on the loader
          thread; park the requests and poll again.
        - ``failed``: the last activation raised (message carries the
          reason); retried automatically after ``failure_cooldown_s``.
        - ``unknown``: no such model.
        """
        schedule = False
        with self._lock:
            key = self._resolve_locked(spec)
            if key is None:
                return None, UNKNOWN, (
                    f"unknown model {spec!r}; registered: "
                    f"{self._names_preview_locked()}")
            e = self._entries[key]
            if e.state == RESIDENT:
                e.handle.acquire()
                e.last_used = next(self._tick)
                return e.handle, RESIDENT, ""
            if e.state == FAILED:
                if time.monotonic() < e.failed_at + self.failure_cooldown_s:
                    return None, FAILED, e.failure or "load failed"
                e.state = UNLOADED          # cooldown over: retry
            if e.state == UNLOADED:
                e.state = LOADING
                e.loading_since = time.monotonic()
                schedule = True
            elif e.state == LOADING and time.monotonic() \
                    > e.loading_since + self.loading_requeue_s:
                # lost-load watchdog: a queued load can vanish (loader
                # killed by a BaseException, close() racing a submit);
                # without this the entry is LOADING forever and every
                # request 503s with no recovery path. Requeueing is
                # idempotent — _load_one no-ops unless still LOADING.
                e.loading_since = time.monotonic()
                schedule = True
        if schedule:
            self._submit_load(key)
        return None, LOADING, ""

    def get(self, spec: str, timeout: float = 120.0):
        """Blocking fetch of a resident serving stage: triggers the
        lazy activation if needed and waits for it (embedders, tests,
        warm-ahead scripts — the hot path uses ``acquire``)."""
        deadline = time.monotonic() + timeout
        while True:
            handle, state, msg = self.acquire(spec)
            if state == RESIDENT:
                handle.release()      # get() hands out no outstanding
                return handle.pipeline
            if state == UNKNOWN:
                raise KeyError(msg)
            if state == FAILED:
                raise RuntimeError(
                    f"model {spec!r} failed to load: {msg}")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"model {spec!r} still {state} after {timeout}s")
            time.sleep(0.005)

    def pin(self, spec: str, pinned: bool = True) -> None:
        """Exempt a model from eviction (un-pin with ``pinned=False``)."""
        with self._lock:
            key = self._resolve_locked(spec)
            if key is None:
                raise KeyError(f"unknown model {spec!r}")
            self._entries[key].pinned = bool(pinned)

    # -- the loader thread --------------------------------------------------

    def _submit_load(self, key: str) -> None:
        with self._loader_lock:
            if self._loader is None or not self._loader.is_alive():
                self._loader = threading.Thread(
                    target=self._loader_loop, daemon=True,
                    name="zoo-loader")
                self._loader.start()
            # put INSIDE the lock: close() holds it while enqueueing
            # the shutdown sentinel, so a racing submit can't land its
            # key behind the sentinel of an exiting loader (the lost
            # load would leave the entry LOADING until the watchdog)
            self._load_q.put(key)

    def _loader_loop(self) -> None:
        while True:
            key = self._load_q.get()
            if key is None:
                return
            try:
                self._load_one(key)
            except Exception as e:  # noqa: BLE001 — keep loading others
                log.error("zoo loader error on %s (continuing): %s",
                          key, e)

    def _load_one(self, key: str) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.state != LOADING:
                return
        t0 = time.perf_counter()
        try:
            stream = self._loader_stream()
            ctx = contextlib.nullcontext() if stream is None \
                else torch.cuda.stream(stream)
            with ctx:
                stage, example, extra_meta, cost = self._build(e)
                warm = None
                hook = getattr(stage, "warmup", None)
                if callable(hook) and example is not None:
                    warm = hook(example)
                # MEASURED device residency (the stage's duck-typed
                # resident_bytes: warmup / the build just shipped the
                # weights, so the reading is live)
                measured = _duck_bytes(stage)
            if stream is not None:
                # everything queued on the loader's stream (upload,
                # warmup) has run before any worker sees the handle
                stream.synchronize()
        except Exception as exc:  # noqa: BLE001 — FAILED, not crashed
            reason = f"{type(exc).__name__}: {exc}"
            with self._lock:
                e.state = FAILED
                e.failure = reason
                e.failed_at = time.monotonic()
                self.load_failures += 1
            self.record_event(ZooEvent("load_failed", e.name, e.version,
                                       reason=reason))
            log.warning("zoo: activation of %s FAILED: %s", key, reason)
            return
        ms = (time.perf_counter() - t0) * 1e3
        handle = PipelineHandle(stage, e.version)
        handle.model_name = e.name
        handle.model_key = e.key
        # the measured residency replaces the static estimate (manifest
        # file bytes) unless the registrant pinned cost_bytes
        # explicitly — eviction pressure then reflects what the model
        # actually holds on the device, not its disk size
        cost_source = "estimate"
        with self._lock:
            e.metadata.update(extra_meta)
            if warm is not None:
                e.metadata["warmup_compiles"] = int(warm)
            if e.metadata.get("cost_bytes"):
                cost_source = "metadata"
            elif measured:
                e.cost_bytes = int(measured)
                cost_source = "device"
            elif cost and not e.cost_bytes:
                e.cost_bytes = int(cost)
            e.metadata["cost_source"] = cost_source
            # cold-start cost: the variant plane prices activating a
            # non-resident variant against serving a warm one
            e.metadata["activation_ms"] = round(ms, 1)
            e.state = RESIDENT
            e.handle = handle
            e.failure = None
            e.loads += 1
            e.last_used = next(self._tick)
            self._versions[e.key] = stage
            self.activations += 1
        self.record_event(ZooEvent(
            "activate", e.name, e.version,
            stats={"ms": round(ms, 1), "kind": e.kind,
                   "aot": bool(extra_meta.get("aot")),
                   "cost_bytes": e.cost_bytes,
                   "cost_source": cost_source}))
        log.info("zoo: activated %s in %.0f ms (%s)", key, ms, e.kind)
        self.enforce()

    def _loader_stream(self):
        """The loader thread's own CUDA stream when the zoo's device is
        the card (created on first use), else None."""
        if self.device is None:
            if not torch.cuda.is_available():
                return None    # factories on a host without a card
            dev = torch.device("cuda")
        else:
            dev = torch.device(self.device)
        if dev.type != "cuda":
            return None
        if self._load_stream is None:
            self._load_stream = torch.cuda.Stream(dev)
        return self._load_stream

    def _build(self, e: ZooEntry
               ) -> Tuple[Any, Any, Dict[str, Any], int]:
        """Materialize one entry's serving stage (NO lock held):
        returns (stage, warmup_example, metadata_updates, cost_bytes).
        An artifact's weights go to the device here (on the loader's
        stream when one is current)."""
        from mmlspark_tpu_torch.core.quantize import stage_precision
        if e.kind == "artifact":
            from mmlspark_tpu_torch.serving import aot as AOT
            from mmlspark_tpu_torch.serving.fleet import json_scoring_pipeline
            manifest = AOT.read_manifest(e.source)
            model = AOT.load_model(e.source, device=self.device)
            if manifest["kind"] == "tpu_model":
                model._weights_on_device()
            kwargs = {} if manifest["kind"] == "pipeline" \
                else {"field": manifest["serve"]["field"]}
            stage = json_scoring_pipeline(model, **kwargs)
            example = _artifact_example(e.source, manifest)
            extra = {"precision": manifest.get("precision", "f32"),
                     "aot": True, "buckets": manifest.get("buckets")}
            return stage, example, extra, _artifact_bytes(e.source)
        stage = e.source() if e.kind == "factory" else e.source
        example = e.metadata.get("warmup_example")
        extra = {"precision": stage_precision(stage),
                 "aot": bool(getattr(stage, "aot", False))}
        return stage, example, extra, _duck_bytes(stage)

    # -- eviction -----------------------------------------------------------

    def _pressure_reason(self) -> Optional[str]:
        """Why the cache must shrink right now, or None. The memory
        probe runs OUTSIDE the registry lock (it may touch the
        backend)."""
        with self._lock:
            resident = [e for e in self._entries.values()
                        if e.state == RESIDENT]
            n = len(resident)
            total = sum(e.cost_bytes for e in resident)
        if self.max_resident is not None and n > self.max_resident:
            return "count_cap"
        if self.max_resident_bytes is not None \
                and total > self.max_resident_bytes:
            return "bytes_cap"
        if self.memory_probe is not None and n > 1:
            # memory-pressure evictions stop at ONE resident model:
            # evicting the last one would reload it on the next request
            # — pure thrash, no relief the caps wouldn't give better
            try:
                stats = self.memory_probe()
            except Exception:  # noqa: BLE001 — a sick probe never
                stats = None   # takes the serving plane down
            if stats:
                in_use = stats.get("bytes_in_use")
                limit = stats.get("bytes_limit")
                if in_use is not None and limit:
                    if in_use > self.memory_headroom * limit:
                        return "memory_pressure"
        return None

    def enforce(self, min_interval_s: float = 0.0) -> int:
        """Evict LRU resident models while over budget. Cheap enough to
        call from the batcher loop (``min_interval_s`` rate-gates it);
        also runs after every activation. Returns the eviction count.

        The victim scan requires ``outstanding == 0`` and runs under
        the same lock ``acquire`` bumps outstanding under — an eviction
        can NEVER hit a model with batches in flight."""
        now = time.monotonic()
        if min_interval_s > 0.0 and now < self._last_enforce \
                + min_interval_s:
            return 0
        self._last_enforce = now
        evicted = 0
        while True:
            reason = self._pressure_reason()
            if reason is None:
                return evicted
            with self._lock:
                residents = [e for e in self._entries.values()
                             if e.state == RESIDENT]
                # the sole resident is never a victim: a single model
                # whose cost exceeds a cap would otherwise evict
                # itself right after every activation — a load/evict
                # livelock that never serves the request that
                # triggered the load. Brief overshoot beats thrash
                # (the memory-pressure signal already stops at one).
                if len(residents) <= 1:
                    return evicted
                # ... and the MRU resident is never a victim while
                # others exist, for the same reason: with a tight
                # budget the just-activated model would be its own
                # post-load eviction's only candidate.
                mru = max(residents, key=lambda e: e.last_used)
                victims = [e for e in residents
                           if not e.pinned and e is not mru
                           and e.waiters == 0
                           and e.handle is not None
                           and e.handle.outstanding == 0]
                if not victims:
                    return evicted     # nothing evictable right now
                victim = min(victims, key=lambda e: e.last_used)
                event, pipeline = self._evict_locked(
                    victim, f"lru:{reason}")
            self._unload(pipeline)
            self.record_event(event)
            log.info("zoo: evicted %s@%s (%s)", event.model,
                     event.version, event.reason)
            evicted += 1

    def _evict_locked(self, e: ZooEntry, reason: str
                      ) -> Tuple[ZooEvent, Any]:
        """Detach one RESIDENT entry (registry lock held). Returns the
        event AND the detached pipeline — the caller runs its
        ``unload`` hook AFTER releasing the lock (a slow backend
        release must not stall every ``acquire`` on the hot path)."""
        if e.handle is not None and e.handle.outstanding != 0:
            # unreachable by the lock discipline; counted so the chaos
            # drill can assert the invariant held
            self.evictions_with_outstanding += 1
        pipeline = e.handle.pipeline if e.handle is not None else None
        e.state = UNLOADED
        e.handle = None
        e.evictions += 1
        self.evictions += 1
        self._versions[e.key] = None
        event = ZooEvent("evict", e.name, e.version, reason=reason,
                         stats={"cost_bytes": e.cost_bytes,
                                "loads": e.loads})
        return event, pipeline

    @staticmethod
    def _unload(pipeline: Any) -> None:
        unload = getattr(pipeline, "unload", None)
        if callable(unload):
            try:
                unload()
            except Exception:  # noqa: BLE001 — best-effort release
                pass

    def evict(self, spec: str, reason: str = "manual") -> bool:
        """Explicit eviction (ops hook). Refuses — returns False — when
        the model has outstanding batches or is pinned."""
        with self._lock:
            key = self._resolve_locked(spec)
            if key is None:
                raise KeyError(f"unknown model {spec!r}")
            e = self._entries[key]
            if e.state != RESIDENT or e.pinned or e.waiters != 0 \
                    or e.handle is None or e.handle.outstanding != 0:
                return False
            event, pipeline = self._evict_locked(e, reason)
        self._unload(pipeline)
        self.record_event(event)
        return True

    # -- consistent reads (the ModelRegistry lookup/list contract) ----------

    def _entry_locked(self, key: str) -> Tuple[Any, str, Dict[str, Any]]:
        e = self._entries.get(key)
        if e is None:       # registered through the base API
            return super()._entry_locked(key)
        handle = e.handle if e.state == RESIDENT else None
        return handle, e.state, dict(e.metadata)

    # -- observability ------------------------------------------------------

    def entry_status(self, spec: str) -> Optional[Dict[str, Any]]:
        """One entry's advisory snapshot for the variant plane:
        state, residency cost + source, and the last measured
        activation (cold-start) ms. None for unknown specs."""
        with self._lock:
            key = self._resolve_locked(spec)
            e = self._entries.get(key) if key is not None else None
            if e is None:
                return None
            return {
                "key": e.key, "state": e.state,
                "cost_bytes": e.cost_bytes,
                "cost_source": str(
                    e.metadata.get("cost_source", "estimate")),
                "activation_ms": e.metadata.get("activation_ms"),
                "precision": str(e.metadata.get("precision", "f32")),
                "outstanding": (e.handle.outstanding
                                if e.handle is not None else 0),
                "waiters": e.waiters,
            }

    def observe_latency(self, model: str, ms: float) -> None:
        """Per-model batch latency (the engine observes after every
        scored batch); cardinality-capped — see LabelledHistograms."""
        self._model_hists.observe(model, ms)

    def model_histograms(self) -> Dict[str, Any]:
        """The per-model latency histogram family (label -> histogram;
        overflow models share ``_other``)."""
        return self._model_hists.snapshot()

    def stats(self) -> Dict[str, Any]:
        """ONE consistent snapshot: counts by state, budget usage, and
        per-model metadata rows (resident-first, most-recently-used
        first, capped at ``label_cardinality_cap``)."""
        with self._lock:
            entries = list(self._entries.values())
            by_state: Dict[str, int] = {}
            for e in entries:
                by_state[e.state] = by_state.get(e.state, 0) + 1
            resident = [e for e in entries if e.state == RESIDENT]
            resident.sort(key=lambda e: -e.last_used)
            rest = [e for e in entries if e.state != RESIDENT]
            rows = []
            for e in (resident + rest)[:self.label_cardinality_cap]:
                rows.append({
                    "model": e.name, "version": e.version,
                    "state": e.state,
                    "precision": str(e.metadata.get("precision", "f32")),
                    "aot": bool(e.metadata.get("aot", False)),
                    "pinned": e.pinned, "loads": e.loads,
                    "evictions": e.evictions,
                    "cost_bytes": e.cost_bytes,
                    "cost_source": str(
                        e.metadata.get("cost_source", "estimate")),
                    "outstanding": (e.handle.outstanding
                                    if e.handle is not None else 0),
                    "waiters": e.waiters,
                })
            return {
                "registered": len(entries),
                "by_state": by_state,
                "resident_bytes": sum(e.cost_bytes for e in resident),
                "activations": self.activations,
                "evictions": self.evictions,
                "load_failures": self.load_failures,
                "evictions_with_outstanding":
                    self.evictions_with_outstanding,
                "label_cardinality_cap": self.label_cardinality_cap,
                "models": rows,
            }

    def close(self) -> None:
        """Stop the loader thread (queued loads finish first)."""
        with self._loader_lock:
            if self._loader is not None and self._loader.is_alive():
                self._load_q.put(None)
                self._loader.join(timeout=5)
            self._loader = None


def _natural_key(s: str) -> Tuple:
    """Sort key treating digit runs as numbers: v2 < v10 (plain string
    sort would put v10 first)."""
    import re
    return tuple(int(part) if part.isdigit() else part
                 for part in re.split(r"(\d+)", s))


def _artifact_bytes(art_dir: str) -> int:
    """Cost estimate for an AOT artifact: weights + serialized
    programs on disk (the device-resident footprint's proxy)."""
    total = 0
    for fname in ("weights.pkl", "programs.pkl"):
        try:
            total += os.path.getsize(os.path.join(art_dir, fname))
        except OSError:
            pass
    return total


def _artifact_example(art_dir: str, manifest: Dict[str, Any]):
    """The artifact's warmup example (example.pkl, read through the
    restricted unpickler), shaped for the stage's warmup hook."""
    from mmlspark_tpu_torch.serving import aot as AOT
    if not os.path.exists(os.path.join(art_dir, "example.pkl")):
        return None
    example = AOT._read_pickle(art_dir, "example.pkl")
    if manifest.get("kind") == "pipeline":
        from mmlspark_tpu_torch.core.table import DataTable
        return DataTable(dict(example))
    return example



def _duck_bytes(stage: Any) -> int:
    """Duck-typed cost estimate: a ``resident_bytes`` attr/callable on
    the stage, else 0 (count-cap and the live memory probe still
    bound the cache)."""
    rb = getattr(stage, "resident_bytes", None)
    try:
        if callable(rb):
            return int(rb())
        if rb is not None:
            return int(rb)
    except Exception:  # noqa: BLE001 — estimate only
        pass
    return 0
