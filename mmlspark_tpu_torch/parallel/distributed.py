"""Multi-process groups and the collectives distributed GBDT runs over.

Port of ``mmlspark_tpu/parallel/distributed.py`` onto ``torch.distributed``.
One rank is one process with one device (a CUDA card or the CPU); the
ranks of the default process group are the port's data axis, where the
JAX package has a mesh axis spanning every process's devices.

The rendezvous recipe: every process calls ``initialize()`` with the same
coordinator address (rank 0 hosts the group's TCP store there), the group
size and its own rank, as arguments or from the environment::

    MMLSPARK_TPU_TORCH_COORDINATOR_ADDRESS=10.0.0.1:9377 \\
    MMLSPARK_TPU_TORCH_NUM_PROCESSES=2 \\
    MMLSPARK_TPU_TORCH_PROCESS_ID=<rank> python train.py

The group runs on gloo whatever the device: NCCL refuses two ranks on one
card, and gloo runs on any host. Card tensors are staged through pinned
host memory for each collective.

The rendezvous is BOUNDED: a pure-Python liveness barrier
(``_rendezvous_barrier``) runs before ``init_process_group``, so a member
that never shows up raises ``ProcessGroupError`` after ``timeout_s``, and
the group itself carries ``timeout=`` (``DEFAULT_RENDEZVOUS_TIMEOUT_S``)
for its store and every collective, so a peer that stops answering
surfaces as an error and not as a hang.

``Axis`` is the data axis's collectives, as the tree grower calls them:
``psum`` (an ordered sum on every rank), ``psum_scatter`` (each rank gets
the ordered sum of its slice), ``all_gather`` and ``broadcast``. Every
one moves BYTES (``all_gather`` / ``all_to_all_single`` / ``broadcast``
of a ``uint8`` view) and sums on each rank in rank order, so:

  - any dtype crosses bit for bit (gloo's ``all_reduce`` and
    ``reduce_scatter_tensor`` refuse int16; the quantized histograms keep
    the JAX package's int16 wire, widened to exact int32 sums);
  - a sum is the same on every rank and the same in ``psum`` and
    ``psum_scatter`` (a0 + a1 + ... in rank order), whatever the group
    size.

Each rank counts the bytes it hands to the wire per collective kind
(``Axis.sent``): ``all_gather`` of a P-byte payload sends P x (D - 1),
``all_to_all_single`` of T bytes T x (D - 1) / D, ``broadcast`` of P
bytes P x (D - 1) / D (the group's mean share); ``Axis.seconds`` is the
wall time spent inside the collectives, staging included.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as tdist

_initialized = False

# bounded rendezvous and collectives: how long initialize() waits for the
# whole group, and the group's timeout for its store and each collective
# (env override: MMLSPARK_TPU_TORCH_RENDEZVOUS_TIMEOUT_S). torch's own
# default for gloo is 30 minutes, far too long to notice a dead member.
DEFAULT_RENDEZVOUS_TIMEOUT_S = 60.0

_ENV = "MMLSPARK_TPU_TORCH_"


class ProcessGroupError(RuntimeError):
    """Rendezvous failed: a group member is missing or dead, the
    coordinator is unreachable, or the group timed out assembling."""


@dataclass
class HostInfo:
    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0


def _barrier_address(coordinator_address: str) -> tuple:
    """The pre-rendezvous barrier's address: the coordinator host, one
    port above the coordinator port (env override:
    MMLSPARK_TPU_TORCH_BARRIER_PORT)."""
    host, _, port = coordinator_address.rpartition(":")
    bport = int(os.environ.get(_ENV + "BARRIER_PORT", int(port) + 1))
    return host or "127.0.0.1", bport


def _rendezvous_barrier(coordinator_address: str, nproc: int, pid: int,
                        timeout_s: float) -> None:
    """Liveness barrier BEFORE ``init_process_group``: the coordinator
    binds a plain server socket and every other member checks in with its
    rank; only when all ``nproc`` members are accounted for does anyone
    enter the group's rendezvous. A missing member raises a clean,
    catchable ``ProcessGroupError`` within ``timeout_s`` on every
    survivor."""
    host, port = _barrier_address(coordinator_address)
    deadline = time.monotonic() + timeout_s
    if pid == 0:
        try:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((host, port))
            srv.listen(max(1, nproc - 1))
        except OSError as e:
            raise ProcessGroupError(
                f"coordinator could not bind the rendezvous barrier at "
                f"{host}:{port}: {e}. Set {_ENV}BARRIER_PORT to a free "
                f"port (default: coordinator port + 1).") from e
        conns, seen = [], set()
        try:
            while len(seen) < nproc - 1:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    missing = sorted(set(range(1, nproc)) - seen)
                    raise ProcessGroupError(
                        f"rendezvous barrier timed out after "
                        f"{timeout_s:.0f}s: member(s) {missing} of "
                        f"{nproc} never checked in at {host}:{port} — "
                        f"likely dead or unlaunched.")
                srv.settimeout(remain)
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                conn.settimeout(max(1.0, deadline - time.monotonic()))
                try:
                    hello = conn.recv(64).decode().strip()
                    seen.add(int(hello))
                    conns.append(conn)
                except (ValueError, OSError):
                    conn.close()
            for conn in conns:
                try:
                    conn.sendall(b"GO\n")
                except OSError:
                    pass
        finally:
            for conn in conns:
                conn.close()
            srv.close()
    else:
        last_err: Optional[Exception] = None
        while True:
            remain = deadline - time.monotonic()
            if remain <= 0:
                raise ProcessGroupError(
                    f"rendezvous barrier timed out after "
                    f"{timeout_s:.0f}s: process {pid} could not reach "
                    f"the coordinator barrier at {host}:{port} "
                    f"({last_err}) — the coordinator is likely dead.")
            try:
                with socket.create_connection(
                        (host, port), timeout=min(remain, 5.0)) as conn:
                    conn.sendall(f"{pid}\n".encode())
                    conn.settimeout(max(1.0,
                                        deadline - time.monotonic()))
                    if conn.recv(8).strip() == b"GO":
                        return
                    raise OSError("barrier closed without GO")
            except OSError as e:
                last_err = e
                time.sleep(0.1)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: Optional[float] = None,
               barrier: bool = True) -> HostInfo:
    """Join this process to the default ``torch.distributed`` group (gloo).

    Arguments fall back to the environment
    (MMLSPARK_TPU_TORCH_COORDINATOR_ADDRESS / _NUM_PROCESSES /
    _PROCESS_ID). Without a coordinator address it is a no-op returning
    the one-process view. ``timeout_s`` (default
    ``DEFAULT_RENDEZVOUS_TIMEOUT_S``, env override
    MMLSPARK_TPU_TORCH_RENDEZVOUS_TIMEOUT_S) bounds the rendezvous and is
    the group's timeout for every later collective. ``barrier`` runs the
    Python liveness barrier first (see ``_rendezvous_barrier``)."""
    global _initialized
    coordinator_address = coordinator_address or os.environ.get(
        _ENV + "COORDINATOR_ADDRESS")
    if coordinator_address and not _initialized \
            and not tdist.is_initialized():
        nproc = (num_processes if num_processes is not None
                 else int(os.environ.get(_ENV + "NUM_PROCESSES", "1")))
        pid = (process_id if process_id is not None
               else int(os.environ.get(_ENV + "PROCESS_ID", "0")))
        if timeout_s is None:
            timeout_s = float(os.environ.get(
                _ENV + "RENDEZVOUS_TIMEOUT_S", DEFAULT_RENDEZVOUS_TIMEOUT_S))
        if barrier and nproc > 1:
            _rendezvous_barrier(coordinator_address, nproc, pid, timeout_s)
        try:
            tdist.init_process_group(
                "gloo", init_method=f"tcp://{coordinator_address}",
                world_size=nproc, rank=pid,
                timeout=datetime.timedelta(seconds=max(1.0, timeout_s)))
        except Exception as e:  # noqa: BLE001 — surface actionably
            raise ProcessGroupError(
                f"torch.distributed rendezvous failed for process {pid}/"
                f"{nproc} at coordinator {coordinator_address!r} within "
                f"{timeout_s:.0f}s: {type(e).__name__}: {e}. A group "
                f"member is likely dead or unreachable — every process "
                f"must call initialize() with the same coordinator "
                f"address and a distinct process_id.") from e
        _initialized = True
    return host_info()


def host_info() -> HostInfo:
    """This process's view of the group: one device per rank."""
    if tdist.is_available() and tdist.is_initialized():
        rank, size = tdist.get_rank(), tdist.get_world_size()
    else:
        rank, size = 0, 1
    return HostInfo(process_index=rank, process_count=size,
                    local_device_count=1, global_device_count=size)


def in_process_group() -> bool:
    """True when this process joined a group of two or more processes."""
    return host_info().process_count > 1


def require_process_group(min_processes: int = 2) -> HostInfo:
    """Assert this process runs inside a group of at least
    ``min_processes`` — multi-process code paths call this instead of
    measuring a one-process run and labelling it distributed."""
    info = host_info()
    if info.process_count < min_processes:
        raise ProcessGroupError(
            f"requires a torch.distributed group of >= {min_processes} "
            f"processes; this process sees process_count="
            f"{info.process_count}. Launch via initialize() with "
            f"{_ENV}COORDINATOR_ADDRESS / {_ENV}NUM_PROCESSES / "
            f"{_ENV}PROCESS_ID set.")
    return info


def shutdown() -> None:
    """Leave the group (test teardown); no-op outside one."""
    global _initialized
    if tdist.is_available() and tdist.is_initialized():
        try:
            tdist.destroy_process_group()
        except Exception:  # noqa: BLE001 — already torn down
            pass
    _initialized = False


def shard_table_for_host(table, info: Optional[HostInfo] = None):
    """Each process keeps only its row range of ``table``."""
    info = info or host_info()
    if info.process_count <= 1:
        return table
    return table.shards(info.process_count)[info.process_index]


# ---------------------------------------------------------------------------
# the data axis's collectives
# ---------------------------------------------------------------------------

COLLECTIVES = ("psum", "psum_scatter", "all_gather")


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """A flat uint8 view of ``t``'s bytes on the host (card tensors are
    staged through pinned memory)."""
    t = t.contiguous()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if t.is_cuda:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        t = h
    return t.reshape(-1).view(torch.uint8)


def _ordered_sum(parts: torch.Tensor, dtype) -> torch.Tensor:
    """Sum of ``parts`` (D, ...) along dim 0 in rank order: integers
    widen to exact int32, floats add one rank at a time."""
    acc = parts[0].to(torch.int32 if not dtype.is_floating_point
                      else dtype).clone()
    for r in range(1, parts.shape[0]):
        acc += parts[r]
    return acc


class Axis:
    """The data axis of distributed GBDT: the ranks of the default
    process group, or this process alone (``size`` 1, where every
    collective is the identity and sends nothing)."""

    def __init__(self):
        info = host_info()
        self.rank = info.process_index
        self.size = info.process_count
        self.sent: Dict[str, float] = {c: 0.0 for c in COLLECTIVES}
        self.seconds = 0.0

    def _count(self, label: str, nbytes: float, t0: float) -> None:
        self.sent[label] += float(nbytes)
        self.seconds += time.perf_counter() - t0

    def all_gather(self, t: torch.Tensor,
                   label: str = "all_gather") -> torch.Tensor:
        """(D, *t.shape): every rank's ``t`` in rank order, bit for bit,
        on ``t``'s device."""
        if self.size == 1:
            return t[None].clone()
        t0 = time.perf_counter()
        b = _bytes_of(t)
        out = [torch.empty_like(b) for _ in range(self.size)]
        tdist.all_gather(out, b)
        dt = torch.uint8 if t.dtype == torch.bool else t.dtype
        g = torch.stack(out).view(dt).reshape((self.size,) + tuple(t.shape))
        if t.dtype == torch.bool:
            g = g.to(torch.bool)
        g = g.to(t.device, non_blocking=True)
        self._count(label, b.numel() * (self.size - 1), t0)
        return g

    def psum(self, t: torch.Tensor, wire_dtype=None) -> torch.Tensor:
        """The sum of ``t`` over the ranks, in rank order, on every rank.
        Integer tensors sum to exact int32; ``wire_dtype`` (int16) narrows
        an integer tensor on the wire."""
        if self.size == 1:
            return (t.to(torch.int32) if not t.dtype.is_floating_point
                    else t)
        if wire_dtype is not None and not t.dtype.is_floating_point:
            t = t.to(wire_dtype)
        return _ordered_sum(self.all_gather(t, label="psum"), t.dtype)

    def psum_scatter(self, t: torch.Tensor, dim: int = 1,
                     wire_dtype=None) -> torch.Tensor:
        """Rank r's slice r (of D equal slices along ``dim``) of the sum
        of ``t`` over the ranks, summed in rank order as ``psum`` sums."""
        if self.size == 1:
            return (t.to(torch.int32) if not t.dtype.is_floating_point
                    else t)
        if wire_dtype is not None and not t.dtype.is_floating_point:
            t = t.to(wire_dtype)
        D = self.size
        if t.shape[dim] % D:
            raise ValueError(f"psum_scatter: dim {dim} of {tuple(t.shape)} "
                             f"is not a multiple of {D}")
        t0 = time.perf_counter()
        moved = t.movedim(dim, 0)
        chunk_shape = (moved.shape[0] // D,) + tuple(moved.shape[1:])
        b = _bytes_of(moved)
        out = torch.empty_like(b)
        tdist.all_to_all_single(out, b)
        parts = out.view(t.dtype).reshape((D,) + chunk_shape)
        parts = parts.to(t.device, non_blocking=True)
        self._count("psum_scatter", b.numel() * (D - 1) / D, t0)
        return _ordered_sum(parts, t.dtype).movedim(0, dim)

    def broadcast(self, t: torch.Tensor, src: int,
                  label: str = "psum") -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, bit for bit (``t`` must
        have the same shape and dtype on every rank)."""
        if self.size == 1:
            return t
        t0 = time.perf_counter()
        b = _bytes_of(t).clone()
        tdist.broadcast(b, src=src)
        dt = torch.uint8 if t.dtype == torch.bool else t.dtype
        out = b.view(dt).reshape(t.shape)
        if t.dtype == torch.bool:
            out = out.to(torch.bool)
        out = out.to(t.device, non_blocking=True)
        self._count(label, b.numel() * (self.size - 1) / self.size, t0)
        return out


def as_axis(axis_name) -> Axis:
    """``axis_name`` as an ``Axis``: an ``Axis`` itself, or (any other
    value, the JAX package's mesh-axis name) the default group's."""
    return axis_name if isinstance(axis_name, Axis) else Axis()


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(N,) bool -> (ceil(N / 8),) uint8, bit i of byte j = mask[8j + i]."""
    n = mask.shape[0]
    m = torch.nn.functional.pad(mask.to(torch.uint8), (0, (-n) % 8))
    w = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                     device=mask.device)
    return (m.reshape(-1, 8) * w).sum(1, dtype=torch.uint8)


def unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of ``pack_bits``: (N,) bool."""
    w = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                     device=packed.device)
    return ((packed[:, None] & w) != 0).reshape(-1)[:n]
