"""Whole-pipeline fusion on one torch device: the port of
``mmlspark_tpu/core/fusion.py``.

``PipelineModel.transform`` runs stage-at-a-time: every stage reads its
host columns, computes, and materializes a full host column before the
next stage. A fused plan instead keeps a run of device-capable stages on
the device: the stages' ops run one after another on device tensors,
the intermediates never leave the card, and the live outputs come back
in ONE device-to-host copy per segment.

Three layers, as in the reference:

- **DeviceOp** — one stage's computation as data: ``fn(consts, env) ->
  {col: Tensor}`` over an environment of named device tensors, plus
  host-side ``Feed`` loaders for inputs that need host work first
  (string codes, token hashing) and a ``make_consts`` hook for the
  stage's device-resident constants (weights, fills, forests). Stages
  advertise fusion support through a duck-typed ``device_op(schema)``.
- **FusionPlan** — groups maximal runs of device-capable stages into
  ``FusedSegment``s, keeps host-only stages between them, and runs the
  column-liveness pass so dead intermediates are pruned from the host
  tables too.
- **DeviceTable** — the device-resident cache: table columns and feeds
  ship ONCE per (table, column) (weakly keyed by the host table);
  per-stage constants are keyed by ``(stage uid, param epoch)``.

Where the reference jits a segment into one XLA program, the port runs
the ops eagerly, in order, on device tensors: there is no host round
trip between ops and no ``torch.compile``. ``jit_cache_misses`` /
``trace_count`` keep their names and count a segment's distinct (bucket
rows, env signature) at first run — the port's analog of an XLA compile,
as ``models/tpu_model.py`` counts its shapes. The env's references are
dropped after a segment, so the caching allocator reuses its blocks (the
counterpart of the reference's donated buffers).

``FusedPipelineModel`` packages a plan behind the PipelineModel API with
the serving discipline (pow-2 shape buckets, ``warmup()``,
``jit_cache_misses``); ``json_scoring_pipeline`` scores raw rows through
it with one device round trip per batch.

Numerics contract: fused segments compute in float32 (the device
boundary dtype). ``transform_staged`` — the same op functions dispatched
one stage at a time with a host round trip between stages — issues the
same torch ops on the same shapes, so it is bitwise the fused path; the
host path differs only by its float64 numpy arithmetic (predictions
agree, probabilities agree to f32 rounding).

AOT: ``FusedSegment.install_aot`` takes programs exported by
``serving/aot.py`` (one per bucket and segment of the serving plan),
keyed by env signature; ``run`` calls a program whose signature matches
instead of the ops, and counts no first run for it.

The parts that wait for later items raise ``NotImplementedError``
naming them: ``SegmentSharding`` and ``FusedPipelineModel.shard``
(ROADMAP.md, 'Device pipeline and serving compilation' — mesh placement).
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import (
    Any, Callable, Dict, List, Optional, Sequence, Set, Tuple,
)

import numpy as np
import torch

from mmlspark_tpu_torch.core import metrics as MC
from mmlspark_tpu_torch.core.schema import (
    Field, Schema, BOOL, F32, F64, I8, I16, I32, I64, TENSOR, VECTOR,
)
from mmlspark_tpu_torch.core.sparse import CSRMatrix
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.device import DeviceLike, resolve_device

_NUMERIC_TAGS = {F32, F64, I8, I16, I32, I64, BOOL}

_PIPELINE_ITEM = "Device pipeline and serving compilation"

# every DeviceOp fn registers its code object here — the port's static
# check (testing/fusion_check.py) audits these sources, so kernel code
# cannot silently grow a host sync (.cpu(), .item(), np.asarray, ...)
KERNEL_REGISTRY: Dict[Any, str] = {}


def register_kernel(fn: Callable, name: str) -> Callable:
    KERNEL_REGISTRY[fn.__code__] = name
    return fn


pipeline_histograms = MC.pipeline_histograms


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md, '{_PIPELINE_ITEM}'")


# ---------------------------------------------------------------------------
# column liveness (the pruning pass shared by PipelineModel + the planner)
# ---------------------------------------------------------------------------


def stage_io(stage, schema: Optional[Schema]
             ) -> Tuple[Optional[Set[str]], Optional[Set[str]], Optional[Set[str]]]:
    """A stage's declared (reads, writes, removes) column sets; any
    ``None`` means unknown — the stage must be treated as reading and
    writing everything (no pruning across it)."""
    reads_fn = getattr(stage, "reads_columns", None)
    writes_fn = getattr(stage, "writes_columns", None)
    removes_fn = getattr(stage, "removes_columns", None)
    if reads_fn is None or writes_fn is None or removes_fn is None:
        return None, None, None
    try:
        reads = reads_fn(schema)
        writes = writes_fn(schema)
        removes = removes_fn(schema)
    except Exception:  # noqa: BLE001 — undeclarable: stay conservative
        return None, None, None
    return (None if reads is None else set(reads),
            None if writes is None else set(writes),
            None if removes is None else set(removes))


def column_liveness(stages: Sequence[Any], in_schema: Schema,
                    final_needed: Optional[Set[str]] = None,
                    ) -> List[Optional[Set[str]]]:
    """``needed[i]`` = columns that must exist ENTERING stage ``i``
    (``needed[len(stages)]`` = columns required in the final output);
    ``None`` = everything (no pruning at that boundary).

    ``final_needed=None`` means the caller keeps the whole final table
    (``transform``); a set restricts it (``Pipeline.fit`` passes ``{}``
    — intermediate tables only feed later stages; serving passes the
    reply column). Unknown stages (no reads/writes declaration, e.g. a
    Lambda) poison every boundary upstream of themselves to ``None``,
    and schema propagation is only trusted while every stage seen so
    far declares itself — a Lambda that invents columns its
    ``transform_schema`` does not mention can never cause a wrong drop."""
    n = len(stages)
    schemas: List[Optional[Schema]] = [in_schema]
    names_valid = [True]
    cur_schema: Optional[Schema] = in_schema
    valid = True
    for stage in stages:
        r, w, rm = stage_io(stage, cur_schema)
        if r is None or w is None or rm is None:
            valid = False
        if cur_schema is not None:
            try:
                cur_schema = stage.transform_schema(cur_schema)
            except Exception:  # noqa: BLE001 — schema walk is best-effort
                cur_schema = None
        if cur_schema is None:
            valid = False
        elif valid and w:
            # the recovery branch below rebuilds needed-sets from these
            # schemas, so they are only trustworthy while every stage's
            # declared writes actually appear in its transform_schema
            # output — an Estimator whose transform_schema is the
            # identity (e.g. Featurize) would otherwise make its model's
            # output column invisible and get it wrongly pruned
            if not set(w) <= set(cur_schema.names):
                valid = False
        schemas.append(cur_schema)
        names_valid.append(valid)

    needed: List[Optional[Set[str]]] = [None] * (n + 1)
    if final_needed is not None:
        needed[n] = set(final_needed)
    elif names_valid[n] and schemas[n] is not None:
        needed[n] = set(schemas[n].names)
    cur = needed[n]
    for i in reversed(range(n)):
        reads, writes, removes = stage_io(stages[i], schemas[i])
        if reads is None or writes is None or removes is None:
            cur = None
        elif cur is None:
            if names_valid[i] and schemas[i] is not None:
                # everything flowing out is needed: pass-through =
                # (in-names - removes - writes); plus the stage's reads
                cur = (set(schemas[i].names) - removes - writes) | reads
            else:
                cur = None
        else:
            cur = (cur - writes) | reads
        needed[i] = cur
    return needed


def prune_table(table: DataTable,
                keep: Optional[Set[str]]) -> DataTable:
    """Drop dead columns (those not in ``keep``); no-op when liveness is
    unknown or nothing is dead."""
    if keep is None:
        return table
    dead = [c for c in table.column_names if c not in keep]
    return table.drop(*dead) if dead else table


# ---------------------------------------------------------------------------
# device ops
# ---------------------------------------------------------------------------


class Feed:
    """One derived host-computed device input of a DeviceOp: ``load``
    runs on the host (the serving batcher thread, the chunked prefetch
    worker) and its array ships to the device under ``name`` in the op
    environment. This is how host-only work (string codes, token
    hashing) feeds the fused segment directly."""

    __slots__ = ("name", "load")

    def __init__(self, name: str, load: Callable[[DataTable], np.ndarray]):
        self.name = name
        self.load = load


class DeviceOp:
    """One stage's device computation.

    - ``reads``: environment keys consumed — table column names,
      satisfied either by an upstream op's writes (device-resident) or
      by shipping the host column through the standard f32 loader.
    - ``feeds``: derived host-computed inputs (see ``Feed``).
    - ``writes``: environment keys produced.
    - ``fn(consts, env) -> {name: Tensor}``: torch ops on the env's
      device. It must not leave the device (audited by
      ``testing/fusion_check.py``).
    - ``make_consts()``: the constants (weights, fills, forests) read
      from the stage AT CALL TIME, shipped once per (uid, epoch) by
      DeviceTable. Scalars travel as 0-dim device tensors, never as
      Python floats.
    - ``out_fields`` / ``out_dtypes``: schema Field and readback dtype
      per written column, so fused materialization matches the staged
      host path's column types exactly.
    """

    __slots__ = ("stage", "name", "reads", "feeds", "writes", "fn",
                 "make_consts", "out_fields", "out_dtypes")

    def __init__(self, stage, reads: Sequence[str], writes: Sequence[str],
                 fn: Callable, make_consts: Callable[[], Any],
                 feeds: Sequence[Feed] = (),
                 out_fields: Optional[Dict[str, Field]] = None,
                 out_dtypes: Optional[Dict[str, Any]] = None,
                 name: Optional[str] = None):
        self.stage = stage
        self.name = name or f"{type(stage).__name__}:{stage.uid}"
        self.reads = tuple(reads)
        self.feeds = tuple(feeds)
        self.writes = tuple(writes)
        self.fn = register_kernel(fn, self.name)
        self.make_consts = make_consts
        self.out_fields = dict(out_fields or {})
        self.out_dtypes = dict(out_dtypes or {})


def load_column_f32(table: DataTable, name: str) -> np.ndarray:
    """The standard host->device loader: numeric/vector column as a
    dense float32 array (the same cast the staged host kernels apply,
    so fused and staged consume identical bits)."""
    col = table.column(name)
    if isinstance(col, CSRMatrix):
        raise TypeError(f"column {name!r} is sparse; not device-loadable")
    if isinstance(col, np.ndarray):
        return np.asarray(col, dtype=np.float32)
    return np.stack([np.asarray(v, dtype=np.float32) for v in col])


def fusable_field(field: Optional[Field]) -> bool:
    """Whether the standard loader can ship this column."""
    if field is None:
        return False
    if field.tag in _NUMERIC_TAGS:
        return True
    if field.tag == VECTOR and not field.meta.get("sparse"):
        return True
    return False


def stage_device_op(stage, schema: Schema) -> Optional[DeviceOp]:
    """A stage's DeviceOp, or None when it must run on the host. A hook
    returns None itself for a config it cannot fuse; an error it raises
    is a fault and propagates, so a stage never leaves the fused path
    unseen."""
    hook = getattr(stage, "device_op", None)
    if hook is None:
        return None
    return hook(schema)


def stage_epoch(stage) -> int:
    """The stage's param-mutation epoch (bumped by ``set``); the
    DeviceTable consts key and the plan-cache key both include it, so a
    mutated stage re-ships its consts / replans and nothing else."""
    return int(getattr(stage, "_param_epoch", 0))


def stage_device(stage) -> Optional[torch.device]:
    """The device a stage's own ``device`` param names, when it is set;
    None when the stage has no such param or leaves it unset."""
    try:
        param = stage.param("device")
    except (AttributeError, KeyError):
        return None
    if not stage.is_set(param) or stage.get(param) is None:
        return None
    return torch.device(stage.get(param))


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


# ---------------------------------------------------------------------------
# mesh sharding of fused serving programs (waits for its item)
# ---------------------------------------------------------------------------


class SegmentSharding:
    """Mesh placement of fused serving programs. The port runs on one
    card; the mesh placement is not ported yet."""

    def __init__(self, mesh, data_axis: str = "data",
                 const_specs: Optional[Dict[str, Any]] = None):
        raise _not_ported("SegmentSharding (mesh-sharded fused segments)")


# ---------------------------------------------------------------------------
# host staging: bounded pinned buffers for the side-stream uploads
# ---------------------------------------------------------------------------


_TORCH_DTYPES: Dict[np.dtype, torch.dtype] = {}


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    got = _TORCH_DTYPES.get(dt)
    if got is None:
        got = torch.from_numpy(np.empty(0, dt)).dtype
        _TORCH_DTYPES[dt] = got
    return got


class HostStaging:
    """A bounded ring of reused host buffers per key (column / feed
    name), for uploads that run on a thread other than the dispatching
    one.

    ``put`` copies a host array into the key's next buffer (edge-padding
    its rows up to ``rows`` when asked: padded rows stay valid inputs)
    and returns it as a tensor. On the card the buffers are pinned and
    the caller uploads from them with ``non_blocking=True`` on a side
    stream, then hands ``mark`` the event recorded after that copy: a
    buffer is not written again until its event has completed, so a
    buffer reused ``slots`` uploads later can never hand the device a
    previous upload's rows. ``slots`` bounds the host bytes: at most
    ``slots`` buffers per key (``prefetch_depth + 2`` chunks for the
    chunked executor). On the CPU the ring holds plain buffers and the
    caller computes on them directly."""

    def __init__(self, slots: int, pinned: bool):
        self.slots = max(2, int(slots))
        self.pinned = bool(pinned)
        self._rings: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self.puts = 0
        self.reuses = 0

    def put(self, key: str, host: np.ndarray, rows: Optional[int] = None
            ) -> Tuple[torch.Tensor, Tuple[Dict[str, Any], int]]:
        host = np.ascontiguousarray(host)
        n = host.shape[0]
        rows = n if rows is None else int(rows)
        if rows > n == 0:
            raise ValueError("cannot edge-pad an empty batch")
        shape = (rows,) + host.shape[1:]
        nbytes = int(np.prod(shape, dtype=np.int64)) * host.dtype.itemsize
        with self._lock:
            ring = self._rings.get(key)
            if ring is None:
                ring = {"bufs": [None] * self.slots,
                        "events": [None] * self.slots, "next": 0}
                self._rings[key] = ring
            i = ring["next"]
            ring["next"] = (i + 1) % self.slots
            event = ring["events"][i]
            ring["events"][i] = None
            self.puts += 1
        if event is not None:
            event.synchronize()     # the previous upload from it is done
        buf = ring["bufs"][i]
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              pin_memory=self.pinned)
            ring["bufs"][i] = buf
        else:
            with self._lock:
                self.reuses += 1
        view = buf[:nbytes].view(_torch_dtype(host.dtype)).view(shape)
        out = view.numpy()
        out[:n] = host
        if rows > n:
            out[n:] = host[-1]
        return view, (ring, i)

    @staticmethod
    def mark(handle: Tuple[Dict[str, Any], int], event) -> None:
        ring, i = handle
        ring["events"][i] = event

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"puts": self.puts, "reuses": self.reuses,
                    "buffers": sum(sum(b is not None for b in r["bufs"])
                                   for r in self._rings.values())}


class Upload:
    """Host arrays shipped to ``device`` from the calling thread: on the
    card, through ``staging``'s pinned buffers on ``stream`` with
    ``non_blocking`` copies; ``finish()`` records the event the consumer
    waits on. On the CPU the tensors are the staged buffers (or the
    arrays themselves) and ``finish()`` returns None."""

    def __init__(self, device: torch.device,
                 staging: Optional[HostStaging] = None,
                 stream=None):
        self.device = device
        self.staging = staging
        self.stream = stream
        self._handles: List[Tuple[Dict[str, Any], int]] = []

    def ship(self, key: str, host: np.ndarray,
             rows: Optional[int] = None) -> torch.Tensor:
        """``host`` on the device (its rows edge-padded up to ``rows``,
        which needs ``staging``)."""
        if self.staging is None:
            t = torch.from_numpy(np.ascontiguousarray(host))
            return t if self.device.type == "cpu" else t.to(self.device)
        staged, handle = self.staging.put(key, host, rows)
        if self.device.type == "cpu":
            return staged
        self._handles.append(handle)
        with torch.cuda.stream(self.stream):
            return staged.to(self.device, non_blocking=True)

    def finish(self):
        if self.stream is None or self.device.type == "cpu":
            return None
        event = torch.cuda.Event()
        event.record(self.stream)
        for h in self._handles:
            HostStaging.mark(h, event)
        self._handles = []
        return event


def adopt(env: Dict[str, torch.Tensor], ready, device: torch.device
          ) -> None:
    """Make tensors uploaded on a side stream safe for the current
    stream: wait for their copy event, and record the current stream on
    each so the caching allocator does not hand their blocks out again
    before it has used them."""
    if ready is None or device.type != "cuda":
        return
    cur = torch.cuda.current_stream(device)
    cur.wait_event(ready)
    for t in env.values():
        t.record_stream(cur)


def fetch_outputs(outs: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The live outputs as host arrays, in ONE device-to-host copy: on
    the card the tensors' bytes are packed into one buffer, copied into
    pinned host memory and split there. CPU tensors are already host
    memory."""
    if not outs:
        return {}
    items = list(outs.items())
    if items[0][1].device.type != "cuda":
        return {k: v.detach().numpy() for k, v in items}
    # widest elements first: every part then starts at a byte offset
    # its own element size divides, so the host views stay aligned
    items.sort(key=lambda kv: -kv[1].element_size())
    flat = [v.detach().contiguous().reshape(-1).view(torch.uint8)
            for _, v in items]
    packed = flat[0] if len(flat) == 1 else torch.cat(flat)
    host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    torch.cuda.current_stream(packed.device).synchronize()
    got: Dict[str, np.ndarray] = {}
    pos = 0
    for (k, v), f in zip(items, flat):
        part = host[pos:pos + f.numel()]
        pos += f.numel()
        got[k] = part.view(v.dtype).view(v.shape).numpy()
    return got


def _tree_to(node: Any, device: torch.device) -> Any:
    """A const tree (dicts / lists / tuples of arrays, scalars and
    tensors) on ``device``; array and scalar leaves become tensors (a
    Python or numpy scalar a 0-dim tensor), other leaves stay."""
    if isinstance(node, dict):
        return {k: _tree_to(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_tree_to(v, device) for v in node)
    if isinstance(node, torch.Tensor):
        return node.to(device)
    if isinstance(node, (np.ndarray, np.generic, float, int, bool)):
        return torch.as_tensor(np.asarray(node), device=device)
    return node


def _tree_leaves(node: Any) -> List[Any]:
    if isinstance(node, dict):
        return [x for v in node.values() for x in _tree_leaves(v)]
    if isinstance(node, (list, tuple)):
        return [x for v in node for x in _tree_leaves(v)]
    return [node]


# ---------------------------------------------------------------------------
# DeviceTable — device-resident columns + per-stage consts
# ---------------------------------------------------------------------------


class DeviceTable:
    """Device-resident cache with two keyed stores:

    - **columns/feeds**: weakly keyed by the host DataTable; each
      (table, key) ships exactly once, so repeated transforms of the
      same table (CV folds, chained fused pipelines) pay one H2D per
      column total. DataTables are immutable, making identity a sound
      cache key; dropping the table frees the device tensors.
    - **consts**: keyed by ``(stage uid, param epoch)`` — a stage
      mutation (new weights, changed fill) invalidates exactly that
      stage's device constants, nothing else. The previous epoch's
      entry is evicted eagerly so swapped-out weights do not pin memory.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self._tables: "weakref.WeakKeyDictionary[DataTable, Dict]" = \
            weakref.WeakKeyDictionary()
        self._consts: Dict[str, Tuple[int, Any]] = {}
        self._lock = threading.Lock()
        self.column_ships = 0     # H2D transfers actually paid
        self.column_hits = 0      # cache hits (no reship)
        self.const_ships = 0

    def column(self, table: DataTable, key: str,
               load: Callable[[DataTable], np.ndarray],
               upload: Optional[Upload] = None) -> torch.Tensor:
        with self._lock:
            per = self._tables.get(table)
            if per is None:
                per = {}
                self._tables[table] = per
            arr = per.get(key)
            if arr is not None:
                self.column_hits += 1
                return arr
        host = load(table)
        up = upload if upload is not None else Upload(self.device)
        dev = up.ship(key, host)
        with self._lock:
            per[key] = dev
            self.column_ships += 1
        return dev

    def consts(self, op: DeviceOp) -> Any:
        epoch = stage_epoch(op.stage)
        key = f"{op.stage.uid}:{op.name}"
        with self._lock:
            hit = self._consts.get(key)
            if hit is not None and hit[0] == epoch:
                return hit[1]
        dev = _tree_to(op.make_consts(), self.device)
        with self._lock:
            self._consts[key] = (epoch, dev)   # evicts the stale epoch
            self.const_ships += 1
        return dev

    def resident_bytes(self) -> int:
        """Device bytes of everything this table holds (consts + cached
        columns)."""
        with self._lock:
            trees = [tree for _, tree in self._consts.values()]
            cols = [arr for per in self._tables.values()
                    for arr in per.values()]
        total = 0
        for leaf in [x for t in trees for x in _tree_leaves(t)] + cols:
            if isinstance(leaf, torch.Tensor):
                total += leaf.numel() * leaf.element_size()
        return total

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"column_ships": self.column_ships,
                    "column_hits": self.column_hits,
                    "const_ships": self.const_ships,
                    "tables_cached": len(self._tables),
                    "consts_cached": len(self._consts)}


# ---------------------------------------------------------------------------
# fused segments
# ---------------------------------------------------------------------------


def env_signature(env: Dict[str, torch.Tensor]) -> Tuple:
    """The shape/dtype signature a segment's first runs are counted by."""
    return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                        for k, v in env.items()))


class FusedSegment:
    """A maximal run of device ops run as one segment.

    ``external_reads`` ship from the host table; everything an op reads
    that an earlier op in the run wrote flows device-to-device (the
    intermediates are never materialized). ``writes_live`` is the subset
    of writes anything outside the segment still needs; only those come
    back, in ONE device-to-host copy per segment.
    """

    def __init__(self, ops: List[DeviceOp], writes_live: List[str]):
        self.ops = list(ops)
        all_writes: Set[str] = set()
        ext: List[str] = []
        for op in self.ops:
            for r in op.reads:
                if r not in all_writes and r not in ext:
                    ext.append(r)
            all_writes.update(op.writes)
        self.external_reads = tuple(ext)
        self.feeds = tuple(f for op in self.ops for f in op.feeds)
        self.writes_live = tuple(w for w in writes_live
                                 if w in all_writes)
        self.name = "+".join(type(op.stage).__name__ for op in self.ops)
        self._lock = threading.Lock()
        self._seen: Set[Tuple] = set()
        self.trace_count = 0      # distinct env signatures run so far
        # env signature -> exported program (consts, env) -> live writes
        self._aot: Dict[Tuple, Callable] = {}

    def install_aot(self, programs: Dict[Tuple, Callable]) -> None:
        """Install AOT programs (``serving/aot.py``) keyed by env
        signature; ``run`` dispatches to them."""
        self._aot.update(programs)

    # -- execution -----------------------------------------------------------

    def run(self, consts: List[Any], env: Dict[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
        """The fused path: every op in order on the device, the live
        writes returned. Counts the env signature on its first run; a
        signature with an installed AOT program runs the program and
        counts nothing."""
        sig = env_signature(env)
        prog = self._aot.get(sig)
        if prog is not None:
            with torch.inference_mode():
                return prog(consts, env)
        if sig not in self._seen:
            with self._lock:
                if sig not in self._seen:
                    self._seen.add(sig)
                    self.trace_count += 1
        with torch.inference_mode():
            return self.apply_ops(consts, env)

    def apply_ops(self, consts: List[Any], env: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """Every op in order on ``env``, the live writes returned: the
        segment's computation, uncounted (what ``serving/aot.py``
        exports)."""
        e = dict(env)
        for op, c in zip(self.ops, consts):
            e.update(op.fn(c, e))
        return {k: e[k] for k in self.writes_live}

    def op_compiled(self, i: int) -> Callable:
        """Op ``i`` alone as ``fn(consts, env) -> dict`` — the
        stage-at-a-time baseline (one dispatch per stage, a host round
        trip between stages). Not counted: the serving first-run guard
        watches the fused path only."""
        op = self.ops[i]

        def run(consts, env):
            with torch.inference_mode():
                return dict(op.fn(consts, env))

        return run

    def build_env(self, table: DataTable, device_table: DeviceTable,
                  upload: Optional[Upload] = None
                  ) -> Dict[str, torch.Tensor]:
        """Ship the segment's external inputs: cached table columns +
        derived feeds (host kernels) — the H2D half of the round trip.
        Plain column casts/uploads land under the ``ship`` phase; the
        Feed kernels (string codes, token hashing) under ``prepare``."""
        hists = pipeline_histograms()
        env: Dict[str, torch.Tensor] = {}
        t0 = time.perf_counter()
        for col in self.external_reads:
            env[col] = device_table.column(
                table, col, lambda t, c=col: load_column_f32(t, c), upload)
        t1 = time.perf_counter()
        hists["ship"].observe((t1 - t0) * 1e3)
        for feed in self.feeds:
            env[feed.name] = device_table.column(
                table, f"feed:{feed.name}", feed.load, upload)
        hists["prepare"].observe((time.perf_counter() - t1) * 1e3)
        return env

    def consts_list(self, device_table: DeviceTable) -> List[Any]:
        return [device_table.consts(op) for op in self.ops]

    def out_field(self, col: str, value: np.ndarray) -> Field:
        for op in self.ops:
            if col in op.out_fields:
                return op.out_fields[col]
        # inference mirrors TPUModel.transform's readback tagging
        tag = VECTOR if value.ndim == 2 else \
            TENSOR if value.ndim > 2 else F32
        return Field(col, tag)

    def out_cast(self, col: str):
        for op in self.ops:
            if col in op.out_dtypes:
                return op.out_dtypes[col]
        return None

    def attach(self, table: DataTable, host: Dict[str, np.ndarray],
               rows: Optional[int] = None) -> DataTable:
        """Fold fetched outputs into ``table`` with the staged path's
        dtypes and fields (the first ``rows`` rows when given)."""
        for col in self.writes_live:
            val = host[col] if rows is None else host[col][:rows]
            cast = self.out_cast(col)
            if cast is not None:
                val = val.astype(cast)
            table = table.with_column(col, val, self.out_field(col, val))
        return table


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


class _HostStep:
    __slots__ = ("stage",)

    def __init__(self, stage):
        self.stage = stage


class FusionPlan:
    """The execution plan for one (stage list, input schema) on one
    device: an alternating sequence of host steps and fused segments,
    plus the per-boundary liveness sets used to prune dead host
    columns. A stage whose own ``device`` param names another device
    than the plan's raises: the plan never moves a stage silently."""

    def __init__(self, stages: Sequence[Any], in_schema: Schema,
                 final_needed: Optional[Set[str]] = None,
                 device: DeviceLike = None):
        self.stages = list(stages)
        self.in_schema = in_schema
        self.device = resolve_device(device)
        self.final_needed = (set(final_needed)
                             if final_needed is not None else None)
        self.needed = column_liveness(self.stages, in_schema, final_needed)
        self.steps: List[Any] = []          # _HostStep | FusedSegment
        self.step_boundaries: List[int] = []  # stage index AFTER each step
        self.device_table = DeviceTable(self.device)
        self.last_roundtrips = 0            # D2H copies of the last run
        self._build()

    # -- planning ------------------------------------------------------------

    def _build(self) -> None:
        schema: Optional[Schema] = self.in_schema
        run: List[Tuple[int, DeviceOp]] = []

        def flush(end_idx: int) -> None:
            if not run:
                return
            ops = [op for _, op in run]
            live = self._live_writes(run, end_idx)
            self.steps.append(FusedSegment(ops, live))
            self.step_boundaries.append(end_idx)
            run.clear()

        for i, stage in enumerate(self.stages):
            op = stage_device_op(stage, schema) if schema is not None \
                else None
            if op is not None:
                own = stage_device(stage)
                if own is not None and not _same_device(own, self.device):
                    raise ValueError(
                        f"stage {type(stage).__name__} ({stage.uid}) is on "
                        f"device {own}, the fused plan on {self.device}: "
                        f"set the stage's device or fuse on its device")
            if op is not None and self._reads_satisfiable(op, schema, run):
                run.append((i, op))
            else:
                flush(i)
                self.steps.append(_HostStep(stage))
                self.step_boundaries.append(i + 1)
            if schema is not None:
                try:
                    schema = stage.transform_schema(schema)
                except Exception:  # noqa: BLE001
                    schema = None
        flush(len(self.stages))

    def _reads_satisfiable(self, op: DeviceOp, schema: Schema,
                           run: List[Tuple[int, DeviceOp]]) -> bool:
        written = {w for _, prev in run for w in prev.writes}
        for r in op.reads:
            if r in written:
                continue
            if not fusable_field(schema.get(r)):
                return False
        return True

    def _live_writes(self, run: List[Tuple[int, DeviceOp]],
                     end_idx: int) -> List[str]:
        """Writes of a fused run that anything AFTER the run still
        needs (later host stages / segments, or the final output) —
        everything else stays a device intermediate and is never
        fetched."""
        needed_after = self.needed[end_idx] if end_idx < len(self.needed) \
            else None
        writes: List[str] = []
        for _, op in run:
            writes.extend(op.writes)
        if needed_after is None:
            return writes
        return [w for w in writes if w in needed_after]

    @property
    def segments(self) -> List[FusedSegment]:
        return [s for s in self.steps if isinstance(s, FusedSegment)]

    def describe(self) -> str:
        """Compact plan string: ``[A+B+C]`` for a fused segment."""
        bits = []
        for step in self.steps:
            if isinstance(step, FusedSegment):
                bits.append(f"[{step.name}]")
            else:
                bits.append(type(step.stage).__name__)
        return " -> ".join(bits)

    @property
    def jit_cache_misses(self) -> int:
        return sum(s.trace_count for s in self.segments)

    # -- execution -----------------------------------------------------------

    def _needed_after(self, end_idx: int) -> Optional[Set[str]]:
        return self.needed[end_idx] if end_idx < len(self.needed) else None

    def _materialize(self, table: DataTable, segment: FusedSegment,
                     out: Dict[str, torch.Tensor]) -> DataTable:
        hists = pipeline_histograms()
        t0 = time.perf_counter()
        table = segment.attach(table, fetch_outputs(out))
        self.last_roundtrips += 1
        hists["fetch"].observe((time.perf_counter() - t0) * 1e3)
        return table

    def _run_segment(self, table: DataTable, segment: FusedSegment,
                     env: Optional[Dict[str, torch.Tensor]] = None
                     ) -> DataTable:
        hists = pipeline_histograms()
        if env is None:
            env = segment.build_env(table, self.device_table)
        consts = segment.consts_list(self.device_table)
        t1 = time.perf_counter()
        out = segment.run(consts, env)
        del env
        table = self._materialize(table, segment, out)
        hists["device"].observe((time.perf_counter() - t1) * 1e3)
        return table

    def execute(self, table: DataTable, staged: bool = False) -> DataTable:
        """Run the plan. ``staged=False`` — fused: one segment run + one
        fetch per segment. ``staged=True`` — the stage-at-a-time
        baseline: every op runs alone and materializes ALL its writes to
        the host before the next op ships them back (bitwise the same
        outputs, N round trips — what fusion deletes)."""
        from mmlspark_tpu_torch.core.trace import get_tracer
        hists = pipeline_histograms()
        tracer = get_tracer()
        self.last_roundtrips = 0
        cur = table
        for step, end_idx in zip(self.steps, self.step_boundaries):
            t0 = time.perf_counter()
            if isinstance(step, _HostStep):
                cur = step.stage.transform(cur)
                hists["host_stage"].observe(
                    (time.perf_counter() - t0) * 1e3)
            elif staged:
                cur = self._execute_segment_staged(cur, step)
            else:
                env = step.build_env(cur, self.device_table)
                misses0 = step.trace_count
                t1 = time.perf_counter()
                cur = self._run_segment(cur, step, env)
                del env
                if tracer.enabled:
                    # jit_cache_miss: this run met a new input signature,
                    # the first-run flag the serving device spans carry
                    tracer.emit("pipeline.fused_segment", t1,
                                attrs={"segment": step.name,
                                       "rows": len(cur),
                                       "outputs": len(step.writes_live),
                                       "jit_cache_miss":
                                           step.trace_count > misses0})
            cur = prune_table(cur, self._needed_after(end_idx))
        return cur

    def execute_chunked(self, chunk_iter, prefetch_depth: int = 2):
        """Run the plan chunk-at-a-time over an iterator of DataTable
        chunks, overlapping host ingest with the card's work: a prefetch
        worker runs each chunk's host prefix stages, Feed kernels and
        the upload of the first segment's inputs — on a side CUDA
        stream, from pinned buffers bounded at ``prefetch_depth + 2``
        per input — while the consumer thread runs and fetches the
        PREVIOUS chunk's segment. Per-chunk walls land in the
        ``ooc_histograms`` phases (prepare = worker side, wait =
        consumer blocked, dispatch = consumer side); yields one output
        DataTable per chunk, so peak host residency is the chunks in
        flight, never the whole table."""
        hists = MC.ooc_histograms()
        dev = self.device
        side = None
        staging = None
        if prefetch_depth > 0 and dev.type == "cuda":
            side = torch.cuda.Stream(dev)
            staging = HostStaging(prefetch_depth + 2, pinned=True)

        def prepare(table: DataTable):
            t0 = time.perf_counter()
            cur = table
            pos = 0
            env = ready = None
            while pos < len(self.steps):
                step = self.steps[pos]
                if not isinstance(step, _HostStep):
                    up = Upload(dev, staging, side) if side is not None \
                        else None
                    env = step.build_env(cur, self.device_table, up)
                    ready = up.finish() if up is not None else None
                    break
                cur = step.stage.transform(cur)
                cur = prune_table(cur,
                                  self._needed_after(
                                      self.step_boundaries[pos]))
                pos += 1
            hists["prepare"].observe((time.perf_counter() - t0) * 1e3)
            return cur, pos, env, ready

        def finish(cur: DataTable, pos: int, env, ready) -> DataTable:
            for i in range(pos, len(self.steps)):
                step = self.steps[i]
                if isinstance(step, _HostStep):
                    cur = step.stage.transform(cur)
                else:
                    if env is not None:
                        adopt(env, ready, dev)
                    cur = self._run_segment(cur, step, env)
                    env = ready = None
                cur = prune_table(cur, self._needed_after(
                    self.step_boundaries[i]))
            return cur

        if prefetch_depth <= 0:
            for chunk in chunk_iter:
                item = prepare(chunk)
                t1 = time.perf_counter()
                result = finish(*item)
                del item
                hists["dispatch"].observe(
                    (time.perf_counter() - t1) * 1e3)
                yield result
            return

        from mmlspark_tpu_torch.utils.prefetch import ThreadedPrefetcher
        feed = ThreadedPrefetcher(chunk_iter, prepare,
                                  depth=prefetch_depth)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(feed)
                except StopIteration:
                    return
                t1 = time.perf_counter()
                hists["wait"].observe((t1 - t0) * 1e3)
                result = finish(*item)
                del item
                hists["dispatch"].observe(
                    (time.perf_counter() - t1) * 1e3)
                yield result
        finally:
            feed.close()

    def _execute_segment_staged(self, table: DataTable,
                                segment: FusedSegment) -> DataTable:
        """One op at a time with a FULL host round trip between ops —
        the measured baseline for the fusion speedup claim."""
        for i, op in enumerate(segment.ops):
            up = Upload(self.device)
            env: Dict[str, torch.Tensor] = {}
            for r in op.reads:
                env[r] = up.ship(r, load_column_f32(table, r))
            for feed in op.feeds:
                env[feed.name] = up.ship(feed.name, feed.load(table))
            consts = self.device_table.consts(op)
            out = segment.op_compiled(i)(consts, env)
            del env
            host = fetch_outputs({c: out[c] for c in op.writes})
            self.last_roundtrips += 1    # one D2H per op — the point
            for col in op.writes:
                val = host[col]
                cast = op.out_dtypes.get(col)
                if cast is not None:
                    val = val.astype(cast)
                field = op.out_fields.get(col)
                if field is None:
                    field = segment.out_field(col, val)
                table = table.with_column(col, val, field)
        return table


# ---------------------------------------------------------------------------
# FusedPipelineModel
# ---------------------------------------------------------------------------

# smallest serving bucket (shared discipline with models/tpu_model.py;
# duplicated constant to avoid importing the model layer from core)
MIN_BUCKET = 8


class FusedPipelineModel:
    """A fitted pipeline compiled for fused execution on one device.

    Not a registered PipelineStage: it wraps a fitted ``PipelineModel``
    (or stage list) and exposes the same ``transform`` surface plus the
    serving discipline — ``warmup()``/``bucket_sizes``/``bucket_for``/
    ``jit_cache_misses``/``metrics()``. Persistence goes through the
    wrapped PipelineModel (``.pipeline.save``); re-fuse after load.
    ``device=None`` means the card; ``'cpu'`` must be asked for.
    """

    def __init__(self, stages: Sequence[Any], batch_size: int = 256,
                 device: DeviceLike = None):
        self.stages = list(stages)
        self.batch_size = int(batch_size)
        self.device = resolve_device(device)
        # True once serving/aot.py installed exported segment programs
        # (the serving_model_info 'aot' label)
        self.aot = False
        self._plans: Dict[Tuple, FusionPlan] = {}
        self._plan_lock = threading.Lock()
        # trace counts of evicted (stale-epoch) plans, folded into
        # jit_cache_misses so the counter stays MONOTONIC
        self._retired_traces = 0

    @staticmethod
    def _schema_sig(schema: Schema) -> Tuple:
        # numeric tags collapse to one bucket: i64-vs-f64 raw columns
        # load identically (standard f32 loader), so they must not key
        # distinct plans (serving JSON ints/floats would churn plans)
        return tuple((f.name, "num" if f.tag in _NUMERIC_TAGS else f.tag,
                      bool(f.meta.get("sparse"))) for f in schema)

    def _plan_key(self, schema: Schema,
                  final_needed: Optional[Set[str]]) -> Tuple:
        return (self._schema_sig(schema),
                None if final_needed is None else frozenset(final_needed),
                tuple((s.uid, stage_epoch(s)) for s in self.stages))

    def shard(self, mesh, data_axis: str = "data",
              const_specs: Optional[Dict[str, Any]] = None,
              ) -> "FusedPipelineModel":
        raise _not_ported("FusedPipelineModel.shard (mesh-sharded fused "
                          "serving)")

    def plan_for(self, schema: Schema,
                 final_needed: Optional[Set[str]] = None) -> FusionPlan:
        key = self._plan_key(schema, final_needed)
        plan = self._plans.get(key)
        if plan is None:
            with self._plan_lock:
                plan = self._plans.get(key)
                if plan is None:
                    plan = FusionPlan(self.stages, schema, final_needed,
                                      device=self.device)
                    # param-epoch bumps leave stale keys behind; drop
                    # them so swapped-out weights do not pin device
                    # state — but retire their counts first
                    # (jit_cache_misses must never go backwards)
                    stale = [k for k in self._plans if k[2] != key[2]]
                    for k in stale:
                        old = self._plans.pop(k, None)
                        if old is not None:
                            self._retired_traces += old.jit_cache_misses
                    self._plans[key] = plan
        return plan

    # -- PipelineModel surface ----------------------------------------------

    def get_stages(self) -> List[Any]:
        return list(self.stages)

    @property
    def pipeline(self):
        from mmlspark_tpu_torch.core.stage import PipelineModel
        return PipelineModel(stages=self.stages)

    def transform(self, table: DataTable) -> DataTable:
        return self.plan_for(table.schema).execute(table)

    def transform_staged(self, table: DataTable) -> DataTable:
        """The stage-at-a-time baseline over the SAME op functions (one
        dispatch + host round trip per stage) — bitwise ``transform``;
        what the fused speedup is measured against."""
        return self.plan_for(table.schema).execute(table, staged=True)

    def transform_chunked(self, chunked,
                          prefetch_depth: Optional[int] = None):
        """Out-of-core transform: run an ``io.ooc.ChunkedTable`` through
        the fused plan chunk-at-a-time (``FusionPlan.execute_chunked`` —
        host decode/feeds/uploads of chunk k+1 overlap the card's work
        on chunk k). Returns a lazy ChunkedTable of transformed chunks,
        bitwise per chunk ``transform(chunk)``; nothing materializes the
        whole table. ``prefetch_depth`` defaults to the source's."""
        from mmlspark_tpu_torch.io.ooc import ChunkedTable
        if not isinstance(chunked, ChunkedTable):
            raise TypeError(
                "transform_chunked expects an io.ooc.ChunkedTable; "
                "use transform() for in-memory DataTables")
        depth = (chunked.prefetch_depth if prefetch_depth is None
                 else max(0, int(prefetch_depth)))
        model = self
        try:
            out_schema: Optional[Schema] = \
                self.transform_schema(chunked.schema)
        except Exception:  # noqa: BLE001 — schema-opaque stage: peek
            out_schema = None

        def factory():
            # re-resolve per pass: a stage mutation between passes must
            # hit the epoch-keyed plan cache, not a stale plan
            plan = model.plan_for(chunked.schema)
            it = chunked.chunks(prefetch_depth=0)
            # the raw source records depth 0, but execute_chunked's OWN
            # prefetcher holds `depth` prepared chunks in flight — put
            # the effective depth on the source stats so its
            # tracked_peak_bytes() bounded-memory certificate counts
            # every buffered chunk
            chunked.stats.depth = max(chunked.stats.depth, depth)
            return plan.execute_chunked(it, prefetch_depth=depth)

        # the inner pipeline already prefetches; depth 0 on the result
        # avoids a third buffering layer when callers iterate it
        return ChunkedTable(factory, schema=out_schema,
                            num_rows=chunked.num_rows,
                            prefetch_depth=0,
                            label=f"{chunked.label}|fused",
                            instrument=False)

    def transform_schema(self, schema: Schema) -> Schema:
        for stage in self.stages:
            schema = stage.transform_schema(schema)
        return schema

    def __call__(self, table: DataTable) -> DataTable:
        return self.transform(table)

    # -- serving discipline ---------------------------------------------------

    def bucket_sizes(self) -> List[int]:
        cap = self.batch_size
        sizes: List[int] = []
        b = MIN_BUCKET
        while b < cap:
            sizes.append(b)
            b *= 2
        sizes.append(cap)
        return sizes

    def bucket_for(self, rows: int) -> int:
        b = MIN_BUCKET
        while b < rows:
            b *= 2
        return min(b, self.batch_size)

    @property
    def jit_cache_misses(self) -> int:
        return self._retired_traces + sum(
            p.jit_cache_misses for p in list(self._plans.values()))

    def jit_cache_miss_count(self) -> int:
        return self.jit_cache_misses

    def warmup(self, example, sizes: Optional[List[int]] = None) -> int:
        """Run every serving bucket once (tile the example rows up to
        each bucket and transform; core/warmup.py — per-bucket wall in
        the ``model_warmup_ms`` histogram). Returns the first-time
        shapes met (0 = already warm)."""
        from mmlspark_tpu_torch.core.warmup import warmup_transform
        return warmup_transform(self, example, sizes)

    # -- post-training quantization -------------------------------------------

    @property
    def precision(self) -> str:
        """'int8' when any stage carries quantized weights, else 'f32'
        (the serving_model_info precision label)."""
        from mmlspark_tpu_torch.core.quantize import stage_precision
        if any(stage_precision(s) == "int8" for s in self.stages):
            return "int8"
        return "f32"

    def quantize(self, calib: DataTable,
                 percentile: float = 100.0) -> "FusedPipelineModel":
        """Int8-quantize the model stages of this pipeline: walk the
        fitted stage list with the ``calib`` rows flowing through the
        f32 path, hand each quantizable stage (linear models, TPUModel —
        the duck-typed ``quantize(calib_table)`` hook) ITS OWN input
        table, and return a NEW ``FusedPipelineModel`` over the
        quantized clones. Featurization/scaler stages pass through
        unchanged. This model stays the f32 oracle."""
        from mmlspark_tpu_torch.core.quantize import quantize_stage
        table = calib if isinstance(calib, DataTable) \
            else DataTable(dict(calib))
        if len(table) == 0:
            raise ValueError("quantize needs at least one calibration row")
        stages: List[Any] = []
        quantized = 0
        cur = table
        for i, stage in enumerate(self.stages):
            q, did = quantize_stage(stage, cur, percentile=percentile)
            stages.append(q)
            quantized += int(did)
            if i + 1 < len(self.stages):
                # the f32 path feeds the NEXT stage's calibration; the
                # last stage's output feeds nothing — skip its forward
                cur = stage.transform(cur)
        if quantized == 0:
            raise ValueError(
                "no quantizable stage in the pipeline (nothing exposes "
                "a quantize(calib) hook)")
        return FusedPipelineModel(stages, batch_size=self.batch_size,
                                  device=self.device)

    def resident_bytes(self) -> int:
        """Device residency of every plan's DeviceTable (consts + cached
        columns). 0 before the first plan ships anything."""
        with self._plan_lock:
            plans = list(self._plans.values())
        return sum(p.device_table.resident_bytes() for p in plans)

    def metrics(self) -> Dict[str, Any]:
        plans = list(self._plans.values())
        out: Dict[str, Any] = {
            "jit_cache_misses": self.jit_cache_misses,
            "plans": len(plans),
            "precision": self.precision,
            "device": str(self.device),
        }
        if plans:
            agg: Dict[str, int] = {}
            for p in plans:
                for k, v in p.device_table.stats().items():
                    agg[k] = agg.get(k, 0) + int(v)
            out["device_table"] = agg
            out["fusion_plan"] = plans[0].describe()
        return out

    def describe(self) -> str:
        for p in list(self._plans.values()):
            return p.describe()
        return "(unplanned)"


def fuse(pipeline, batch_size: int = 256,
         device: DeviceLike = None) -> FusedPipelineModel:
    """Compile a fitted PipelineModel (or plain stage list / single
    fitted model) for fused execution on ``device`` (None = the card)."""
    stages = pipeline
    get_stages = getattr(pipeline, "get_stages", None)
    if callable(get_stages):
        stages = get_stages()
    elif not isinstance(pipeline, (list, tuple)):
        stages = [pipeline]
    return FusedPipelineModel(stages, batch_size=batch_size, device=device)
