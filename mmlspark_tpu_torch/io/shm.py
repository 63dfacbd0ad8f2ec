"""Shared-memory columnar transport: the port's copy of
``mmlspark_tpu/io/shm.py``, the zero-copy columnar discipline of
``io/columnar.py`` extended ACROSS process boundaries.

Co-located fleet processes (client and engine on one machine) stop
paying HTTP body bytes + msgpack framing for the columnar hot path:
the MCOL frame's raw buffers are placed directly in a
``multiprocessing.shared_memory`` segment (a ring of generation-tagged
slots), and only a tiny JSON control message — segment name, slot,
offset, length, generation — rides the existing HTTP connection. The
engine decodes the frame as zero-copy ``np.frombuffer`` views over the
SHARED segment (the exact ``_decode_msgpack_columns`` kernel the
in-body msgpack codec uses), feeding the donated staging-pool dispatch
unchanged.

Wire negotiation: the control message posts with Content-Type
``application/x-shm-columns``; ``io.columnar.negotiate`` maps it to the
``"shm"`` codec and any engine that cannot attach the segment (remote
machine, dead segment, stale generation) answers 400 for that request —
the client falls back to HTTP+msgpack under the ``_columnar_ok``
cooldown discipline (serving/fleet.py).

The wire format is the reference's: the same slot header, control
message and MCOL frame layout, so a frame written by either package
decodes in the other. The port writes the frame header as JSON (flag 0,
the reference's own encoding when the ``msgpack`` package is absent);
with ``msgpack`` absent both packages write the same bytes.

Crash-safety protocol:

- **Generation tags.** Every slot carries ``[generation, length]`` in
  the segment itself; the control message repeats the generation. A
  reader that arrives after the slot was overwritten (client restarted,
  stale retry) sees a mismatch and 400s cleanly — it NEVER blocks: shm
  is pull-only, readers wait on nothing.
- **Ownership.** The CLIENT creates, and normally unlinks, its ring
  segment. A SIGKILL'd engine costs nothing (it only held an
  attachment); the client just stops offering shm to that address.
- **Survivor unlink.** If the CLIENT is SIGKILL'd, the engine is the
  survivor: attachments are cached with the owner pid from the control
  message, and ``reap_dead_owners`` (run opportunistically on the
  decode path) unlinks segments whose owner process is gone. The
  client's own ``resource_tracker`` process provides a second layer —
  it outlives a SIGKILL and unlinks leaked segments at cleanup.
- **Slot quarantine.** A slot whose request did not complete cleanly
  (timeout, connection drop) is not reused until a cooldown elapses, so
  an engine still chewing on the old frame can never observe a
  half-overwritten buffer passing its generation check.

Honest what-still-copies list (same contract as io/columnar.py):

- the client stages each numeric column ONCE into the shared slot
  (``np.copyto`` — the single memcpy that replaces encode+send+recv);
- string/token columns materialize Python strings on both sides by
  contract (host featurization kernels consume ``List[str]``);
- the engine's batch assembly concatenates per-request views into the
  batch column (the same one copy the in-body columnar path pays).
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from mmlspark_tpu_torch.io.columnar import (
    CT_SHM_COLUMNS, CodecError, ColumnarBatch, _align8,
    _decode_msgpack_columns, _encode_strings, _BufWriter, _MAGIC,
    _HDR_JSON, register_ingress_kernel,
)

# per-slot header, stored IN the segment: little-endian u64 generation +
# u64 frame length. The generation in the control message must match.
_SLOT_HDR = struct.Struct("<QQ")

DEFAULT_SLOT_BYTES = 1 << 20
DEFAULT_NSLOTS = 8
# a not-cleanly-released slot (timeout / dropped connection) stays out
# of the free list this long — bounds the overwrite-while-reading race
# to requests older than any serving timeout
SLOT_QUARANTINE_S = 60.0
_REAP_INTERVAL_S = 5.0


# code object -> registered name: the shm hot paths
# testing/fusion_check.py check_shm_transport audits — no
# unacknowledged copies (``.tobytes()``/``bytes()``/``np.copy``/
# ``.tolist()`` need a ``# shm:copy-ok`` tag) and every slot/segment
# acquire paired with a release/unlink on all exit paths
SHM_REGISTRY: Dict[Any, str] = {}


def register_shm_kernel(fn, name: str):
    SHM_REGISTRY[fn.__code__] = name
    return fn


class ShmBackpressure(RuntimeError):
    """No free slot: every ring slot is in flight (or quarantined).
    The caller falls back to HTTP+msgpack for this batch."""


class ShmCapacity(RuntimeError):
    """The frame does not fit one slot. The caller falls back to
    HTTP+msgpack for this batch (and may size the next ring larger)."""


def shm_available() -> bool:
    """POSIX shared memory usable on this host?"""
    try:
        from multiprocessing import shared_memory  # noqa: F401
    except Exception:  # noqa: BLE001 — platform without shm
        return False
    return os.path.isdir("/dev/shm") or os.name != "posix"


# ---------------------------------------------------------------------------
# counters (rendered as serving_shm_* by serving/fleet.py metrics_text)
# ---------------------------------------------------------------------------

_stats_lock = threading.Lock()
_STATS: Dict[str, float] = {
    "segments_created": 0, "segments_attached": 0, "segments_unlinked": 0,
    "batches": 0, "bytes": 0, "gen_mismatch": 0, "reaped": 0,
}


def _bump(key: str, n: float = 1) -> None:
    with _stats_lock:
        _STATS[key] = _STATS.get(key, 0) + n


def stats() -> Dict[str, float]:
    with _stats_lock:
        return dict(_STATS)


# ---------------------------------------------------------------------------
# writer: the client-side ring
# ---------------------------------------------------------------------------


class _FramePlan:
    """Buffer table for one frame: numeric columns are REMEMBERED (the
    array itself — no intermediate bytes), small string/offset buffers
    are bytes. Offsets are payload-relative, 8-byte aligned — the MCOL
    layout of io/columnar.py exactly."""

    def __init__(self):
        self.bufs: List[List[int]] = []
        self.srcs: List[Any] = []
        self._off = 0

    def add_array(self, arr: np.ndarray) -> int:
        idx = len(self.bufs)
        self.bufs.append([self._off, int(arr.nbytes)])
        self.srcs.append(arr)
        self._off += _align8(int(arr.nbytes))
        return idx

    def add_bytes(self, data: bytes) -> int:
        idx = len(self.bufs)
        self.bufs.append([self._off, len(data)])
        self.srcs.append(data)
        self._off += _align8(len(data))
        return idx

    @property
    def payload_bytes(self) -> int:
        return self._off


def _plan_columns(columns: Mapping[str, Any]) -> Tuple[dict, _FramePlan]:
    """The encode_columns column walk, but numeric buffers stay as
    arrays until the single copy into the shared slot."""
    n_rows: Optional[int] = None
    plan = _FramePlan()
    cols: List[Dict[str, Any]] = []
    for name, data in columns.items():
        if isinstance(data, np.ndarray) and data.dtype != object:
            if data.dtype.hasobject:
                raise CodecError(
                    f"column {name!r}: object arrays have no typed "
                    f"buffer encoding")
            arr = np.ascontiguousarray(data)  # shm:copy-ok — only when
            #                                   the input is strided
            cols.append({"name": name, "k": "num", "dt": arr.dtype.str,
                         "sh": list(arr.shape),
                         "b": plan.add_array(arr)})
            m = arr.shape[0] if arr.ndim else 1
            n_rows = m if n_rows is None else n_rows
            if m != n_rows:
                raise CodecError(
                    f"column {name!r} has {m} rows; expected {n_rows}")
            continue
        data = list(data)                     # shm:copy-ok — string col
        m = len(data)
        n_rows = m if n_rows is None else n_rows
        if m != n_rows:
            raise CodecError(
                f"column {name!r} has {m} rows; expected {n_rows}")
        first = next((v for v in data if v is not None), None)
        w = _BufWriter()
        if first is None or isinstance(first, str):
            entry = {"name": name, "k": "str", **_encode_strings(data, w)}
        elif isinstance(first, (list, tuple, np.ndarray)) and (
                len(first) == 0 or isinstance(first[0], str)):
            list_offsets = np.zeros(m + 1, dtype=np.int32)
            flat: List[str] = []
            pos = 0
            for i, toks in enumerate(data):   # shm:copy-ok — token col
                toks = [] if toks is None else list(toks)
                flat.extend(toks)
                pos += len(toks)
                list_offsets[i + 1] = pos
            entry = {"name": name, "k": "tok",
                     "lo": w.add(list_offsets.tobytes())}  # shm:copy-ok
            entry.update(_encode_strings(flat, w))
        elif isinstance(first, (bool, int, float, np.generic)):
            try:
                arr = np.asarray(data)
            except ValueError as e:
                raise CodecError(
                    f"column {name!r}: not encodable as a rectangular "
                    f"numeric array ({e})") from e
            if arr.dtype.hasobject:
                raise CodecError(
                    f"column {name!r}: mixed/None numeric values need "
                    f"a float array with NaN for missing cells")
            entry = {"name": name, "k": "num", "dt": arr.dtype.str,
                     "sh": list(arr.shape), "b": plan.add_array(arr)}
        else:
            raise CodecError(
                f"column {name!r}: unsupported value type "
                f"{type(first).__name__} for columnar encoding")
        # merge the string sub-writer's buffers into the frame plan,
        # remapping this entry's buffer indices
        if w.bufs:
            remap = {i: plan.add_bytes(part)
                     for i, part in _iter_writer_bufs(w)}
            for key in ("o", "d", "valid", "lo"):
                if key in entry:
                    entry[key] = remap[entry[key]]
        cols.append(entry)
    return ({"v": 1, "n": int(n_rows or 0), "cols": cols,
             "bufs": plan.bufs}, plan)


def _iter_writer_bufs(w: _BufWriter):
    """(index, unpadded bytes) for each buffer a _BufWriter collected —
    its parts list interleaves payload bytes with alignment padding."""
    part_i = 0
    for idx, (off, nbytes) in enumerate(w.bufs):
        data = w.parts[part_i]
        part_i += 1
        if _align8(nbytes) != nbytes:
            part_i += 1   # skip the padding part
        yield idx, data


def _write_frame(mv: memoryview, columns: Mapping[str, Any]) -> int:
    """Write one MCOL frame into ``mv`` (a slot's payload window).
    Numeric column data goes HOST ARRAY -> SHARED SEGMENT in one
    ``np.copyto`` — no intermediate body bytes exist. Returns the frame
    length. Raises ShmCapacity when the frame doesn't fit."""
    header, plan = _plan_columns(columns)
    hdr = json.dumps(header).encode("utf-8")
    flag = _HDR_JSON
    prefix = _MAGIC + struct.pack("<BI", flag, len(hdr)) + hdr
    payload = _align8(len(prefix))
    frame_len = payload + plan.payload_bytes
    if frame_len > len(mv):
        raise ShmCapacity(
            f"frame needs {frame_len} bytes; slot holds {len(mv)}")
    mv[:len(prefix)] = prefix
    if payload > len(prefix):
        mv[len(prefix):payload] = b"\x00" * (payload - len(prefix))
    for (off, nbytes), src in zip(plan.bufs,      # ingress:row-ok —
                                  plan.srcs):     # per-BUFFER loop
        if isinstance(src, np.ndarray):
            dst = np.frombuffer(mv, dtype=src.dtype,
                                count=src.size,
                                offset=payload + off)
            np.copyto(dst, src.reshape(-1))
        else:
            mv[payload + off:payload + off + nbytes] = src
    return frame_len


class ShmRing:
    """Client-side ring of generation-tagged slots in ONE shared
    segment. ``write()`` places a columnar frame into a free slot and
    returns the control message to post over HTTP; ``release(token)``
    returns the slot once the reply (or failure) lands."""

    def __init__(self, nslots: int = DEFAULT_NSLOTS,
                 slot_bytes: int = DEFAULT_SLOT_BYTES):
        from multiprocessing import shared_memory
        self.nslots = int(nslots)
        self.slot_bytes = int(slot_bytes)
        self._stride = _SLOT_HDR.size + self.slot_bytes
        self._shm = shared_memory.SharedMemory(
            create=True, size=self.nslots * self._stride)
        self.name = self._shm.name
        self._lock = threading.Lock()
        self._free = list(range(self.nslots))
        self._quarantine: List[Tuple[int, float]] = []
        self._gen = 0
        self._closed = False
        _bump("segments_created")

    # -- slot lifecycle ----------------------------------------------------

    def _claim_slot(self) -> int:
        with self._lock:
            if self._closed:
                raise ShmBackpressure("ring is closed")
            now = time.monotonic()
            while self._quarantine and self._quarantine[0][1] <= now:
                self._free.append(self._quarantine.pop(0)[0])
            if not self._free:
                raise ShmBackpressure(
                    f"all {self.nslots} shm slots in flight")
            return self._free.pop()

    def release(self, token: int, clean: bool = True) -> None:
        """Return a slot. ``clean=False`` (timeout, dropped connection)
        quarantines it instead — the engine might still hold views into
        the old frame."""
        with self._lock:
            if self._closed:
                return
            if clean:
                self._free.append(token)
            else:
                self._quarantine.append(
                    (token, time.monotonic() + SLOT_QUARANTINE_S))

    # -- the hot write path ------------------------------------------------

    def write(self, columns: Mapping[str, Any]) -> Tuple[bytes, str, int]:
        """Frame ``columns`` into a free slot. Returns ``(control_body,
        content_type, token)`` — post the body with the content type,
        then ``release(token)`` when the reply lands. Raises
        ShmBackpressure / ShmCapacity for the caller's HTTP fallback."""
        slot = self._claim_slot()
        base = slot * self._stride
        try:
            view = memoryview(self._shm.buf)[
                base + _SLOT_HDR.size:base + self._stride]
            try:
                frame_len = _write_frame(view, columns)
            finally:
                view.release()
        except Exception:
            self.release(slot, clean=True)
            raise
        with self._lock:
            self._gen += 1
            gen = self._gen
        _SLOT_HDR.pack_into(self._shm.buf, base, gen, frame_len)
        control = json.dumps({
            "v": 1, "seg": self.name, "slot": slot,
            "off": base + _SLOT_HDR.size, "len": frame_len,
            "gen": gen, "pid": os.getpid(),
        }).encode("ascii")
        _bump("batches")
        _bump("bytes", frame_len)
        return control, CT_SHM_COLUMNS, slot

    # -- teardown ----------------------------------------------------------

    def close(self, unlink: bool = True) -> None:
        """Close (and by default unlink) the segment. Safe to call
        twice; tolerates readers that still hold views."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if unlink:
            try:
                self._shm.unlink()
                _bump("segments_unlinked")
            except FileNotFoundError:
                pass
            except Exception:  # noqa: BLE001 — already reaped
                pass
        try:
            self._shm.close()
        except BufferError:
            pass   # a decode view is still alive somewhere local

    def __del__(self):  # pragma: no cover — belt and braces
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


register_ingress_kernel(_write_frame, "shm.write_frame")
register_shm_kernel(_plan_columns, "shm.plan_columns")
register_shm_kernel(_write_frame, "shm.write_frame")
register_shm_kernel(ShmRing.write, "shm.ring_write")


# ---------------------------------------------------------------------------
# reader: the engine-side attach cache + decoder
# ---------------------------------------------------------------------------

_attach_lock = threading.Lock()
# name -> (SharedMemory, owner_pid)
_ATTACHED: Dict[str, Tuple[Any, int]] = {}
_zombies: List[Any] = []
_last_reap = 0.0


def _attach(name: str, owner_pid: int):
    with _attach_lock:
        hit = _ATTACHED.get(name)
        if hit is not None:
            return hit[0]
    from multiprocessing import shared_memory
    try:
        seg = shared_memory.SharedMemory(name=name, create=False)
    except (FileNotFoundError, OSError) as e:
        raise CodecError(
            f"shm segment {name!r} is not attachable here ({e}); "
            f"client should fall back to HTTP") from e
    # CPython <= 3.12 registers ATTACHMENTS with the resource tracker
    # too, which would unlink the client's live segment when this
    # process exits — the owner (or its tracker) unlinks, not us. An
    # in-process attach (owner == us, tests) keeps the registration:
    # it IS the owner's.
    if owner_pid and int(owner_pid) != os.getpid():
        try:
            from multiprocessing import resource_tracker
            resource_tracker.unregister(seg._name, "shared_memory")
        except Exception:  # noqa: BLE001 — tracker API drift
            pass
    with _attach_lock:
        if name in _ATTACHED:          # racing attach: keep the first
            extra = seg
            seg = _ATTACHED[name][0]
            try:
                extra.close()
            except BufferError:  # pragma: no cover
                pass
        else:
            _ATTACHED[name] = (seg, int(owner_pid or 0))
            _bump("segments_attached")
    return seg


def attached_count() -> int:
    with _attach_lock:
        return len(_ATTACHED)


def reap_dead_owners(force: bool = False) -> int:
    """Survivor unlink: drop cached attachments whose owner process is
    gone, unlinking the orphaned segment. Runs opportunistically from
    the decode path (every ``_REAP_INTERVAL_S``); returns the number of
    segments reaped."""
    global _last_reap
    now = time.monotonic()
    if not force and now - _last_reap < _REAP_INTERVAL_S:
        return 0
    with _attach_lock:
        _last_reap = now
        dead = []
        for name, (seg, pid) in list(_ATTACHED.items()):
            if pid <= 0:
                continue
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                dead.append((name, seg))
                del _ATTACHED[name]
            except PermissionError:
                pass   # alive, different uid
        still = []
        for seg in _zombies:
            try:
                seg.close()
            except BufferError:
                still.append(seg)
        _zombies[:] = still
    for name, seg in dead:
        try:
            seg.unlink()
            _bump("segments_unlinked")
        except FileNotFoundError:
            pass
        except Exception:  # noqa: BLE001
            pass
        try:
            seg.close()
        except BufferError:
            with _attach_lock:
                _zombies.append(seg)
        _bump("reaped")
    return len(dead)


def close_attachments() -> None:
    """Engine teardown: drop every cached attachment (never unlinks a
    live owner's segment)."""
    with _attach_lock:
        segs = [seg for seg, _ in _ATTACHED.values()]
        _ATTACHED.clear()
    for seg in segs:
        try:
            seg.close()
        except BufferError:
            with _attach_lock:
                _zombies.append(seg)
        except Exception:  # noqa: BLE001
            pass


def decode_control(body) -> ColumnarBatch:
    """Decode one shm control message into zero-copy column views over
    the shared segment. Any failure — unattachable segment, bounds,
    stale generation — raises CodecError: the engine 400s THAT request
    and the client falls back to HTTP (never a hang: readers pull, they
    don't wait)."""
    try:
        ctrl = json.loads(bytes(body))  # shm:copy-ok — the ~150-byte
        #                                 control message, not the frame
        name = ctrl["seg"]
        slot = int(ctrl["slot"])
        off = int(ctrl["off"])
        length = int(ctrl["len"])
        gen = int(ctrl["gen"])
        pid = int(ctrl.get("pid", 0))
    except CodecError:
        raise
    except Exception as e:  # noqa: BLE001 — malformed control
        raise CodecError(f"malformed shm control message: {e}") from e
    seg = _attach(name, pid)
    hdr_off = off - _SLOT_HDR.size
    if hdr_off < 0 or off + length > seg.size:
        raise CodecError(
            f"shm frame [{off}:{off + length}] exceeds segment "
            f"{name!r} ({seg.size} bytes)")
    stored_gen, stored_len = _SLOT_HDR.unpack_from(seg.buf, hdr_off)
    if stored_gen != gen or stored_len != length:
        _bump("gen_mismatch")
        raise CodecError(
            f"stale shm slot {slot}: generation {stored_gen} != "
            f"{gen} (client restarted or slot reused)")
    mv = memoryview(seg.buf)[off:off + length]
    batch = _decode_msgpack_columns(mv)
    batch.codec = "shm"
    _bump("batches")
    _bump("bytes", length)
    reap_dead_owners()
    return batch


register_ingress_kernel(decode_control, "shm.decode_control")
register_shm_kernel(decode_control, "shm.decode_control")
