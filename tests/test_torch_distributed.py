"""PyTorch port: the process group and its collectives
(``mmlspark_tpu_torch/parallel/distributed.py``).

Ported drills of ``tests/test_multihost_fabric.py``: a member that dies
before the rendezvous makes the survivor raise ``ProcessGroupError``
within its bounded timeout (``test_member_death_raises_cleanly_within_
timeout``), and the one-process gate (``TestProcessGroupGate``). Two
real gloo ranks check the collectives the tree grower runs: int16 rides
the wire as bytes and sums to the exact int32 sum (gloo's own int16
reduction refuses), psum_scatter's slices are psum's bitwise, and the
counted bytes follow the documented rule. Every wait is bounded.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.parallel import distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_ports(n: int):
    """``n`` distinct free ports (all bound at once, then released)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _env(barrier_port: int):
    """The ranks' environment: no inherited group settings, and the
    liveness barrier on a free port of its own (its default, the store's
    port + 1, may be taken)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "MMLSPARK_TPU_TORCH_"))}
    env["MMLSPARK_TPU_TORCH_BARRIER_PORT"] = str(barrier_port)
    return env


def _rank_cmd(port, rank, *extra):
    return [sys.executable, "-m", "mmlspark_tpu_torch.testing.gbdt_rank",
            str(port), str(rank), "2", "--device", "cpu", *extra]


# each rank sums the same seeded tensors through every collective and
# prints what it got; the parent compares the ranks and the exact sums
_COLLECTIVES = r"""
import sys
sys.modules["jax"] = None
import torch
from mmlspark_tpu_torch.parallel import distributed as dist
port, rank = int(sys.argv[1]), int(sys.argv[2])
dist.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=rank,
                timeout_s=30)
ax = dist.Axis()
g = torch.Generator().manual_seed(10 + rank)
i16 = torch.randint(-16000, 16000, (3, 6, 5), generator=g,
                    dtype=torch.int16)
f32 = torch.randn((3, 6, 5), generator=g)
ps = ax.psum(i16, wire_dtype=torch.int16)
sc = ax.psum_scatter(i16, dim=1, wire_dtype=torch.int16)
pf = ax.psum(f32)
sf = ax.psum_scatter(f32, dim=1)
gat = ax.all_gather(torch.tensor([rank, 7 * rank], dtype=torch.int32))
bits = dist.pack_bits(torch.arange(13) % (rank + 2) == 0)
bc = dist.unpack_bits(ax.broadcast(bits, src=1), 13)
print("DTYPES", ps.dtype, sc.dtype, pf.dtype)
print("PSUM", ps.flatten().tolist())
print("SCATTER", sc.flatten().tolist())
print("FSUM", pf.flatten().tolist())
print("FSCATTER", sf.flatten().tolist())
print("GATHER", gat.flatten().tolist())
print("BCAST", bc.int().tolist())
print("SENT", ax.sent["psum"], ax.sent["psum_scatter"], ax.sent["all_gather"])
dist.shutdown()
"""


@pytest.fixture(scope="module", autouse=True)
def _started():
    """Both two-process drills start at once, before the first test, so
    their interpreters start side by side: the collectives' two ranks,
    and the member-death pair (a survivor bounded to 10 s and a member
    that dies before joining)."""
    port, bport, port2, bport2 = _free_ports(4)
    coll = [subprocess.Popen(
        [sys.executable, "-c", _COLLECTIVES, str(port), str(r)], cwd=REPO,
        env=_env(bport), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    death = (time.monotonic(), [subprocess.Popen(
        _rank_cmd(port2, r, *extra), cwd=REPO, env=_env(bport2),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r, extra in ((0, ("--timeout-s", "10")),
                         (1, ("--die-before-rendezvous",)))])
    yield {"collectives": coll, "death": death}
    for p in coll + death[1]:
        if p.poll() is None:
            p.kill()
            p.communicate(timeout=30)


@pytest.fixture(scope="module")
def two_ranks(_started):
    procs = _started["collectives"]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, f"{out}\n{err[-3000:]}"
            outs.append({ln.split()[0]: ln.split(None, 1)[1]
                         for ln in out.splitlines() if ln.strip()})
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("collective ranks hung")
    return outs


def _inputs(rank):
    g = torch.Generator().manual_seed(10 + rank)
    i16 = torch.randint(-16000, 16000, (3, 6, 5), generator=g,
                        dtype=torch.int16)
    return i16, torch.randn((3, 6, 5), generator=g)


def test_int16_wire_sums_exactly_to_int32(two_ranks):
    a, b = _inputs(0)[0], _inputs(1)[0]
    want = (a.to(torch.int32) + b.to(torch.int32)).flatten().tolist()
    for out in two_ranks:
        assert out["DTYPES"].split()[:2] == ["torch.int32", "torch.int32"]
        assert eval(out["PSUM"]) == want


def test_psum_scatter_slices_are_psums_bitwise(two_ranks):
    for r, out in enumerate(two_ranks):
        ps = torch.tensor(eval(out["PSUM"])).reshape(3, 6, 5)
        sc = torch.tensor(eval(out["SCATTER"])).reshape(3, 3, 5)
        assert torch.equal(sc, ps[:, 3 * r:3 * r + 3])
        pf = torch.tensor(eval(out["FSUM"])).reshape(3, 6, 5)
        sf = torch.tensor(eval(out["FSCATTER"])).reshape(3, 3, 5)
        assert torch.equal(sf, pf[:, 3 * r:3 * r + 3])
        # float sums in rank order: rank 0's values plus rank 1's
        f0, f1 = _inputs(0)[1], _inputs(1)[1]
        assert torch.equal(pf, f0 + f1)


def test_all_gather_and_bitmap_broadcast(two_ranks):
    want_bits = (torch.arange(13) % 3 == 0).int().tolist()
    for out in two_ranks:
        assert eval(out["GATHER"]) == [0, 0, 1, 7]
        assert eval(out["BCAST"]) == want_bits
        assert two_ranks[0]["PSUM"] == out["PSUM"]
        assert two_ranks[0]["FSUM"] == out["FSUM"]


def test_sent_bytes_follow_the_counting_rule(two_ranks):
    # psum: int16 (180 cells) and f32 (90 x 4) all-gathered once each,
    # plus the broadcast's 2 packed bytes at half; psum_scatter: half of
    # each all-to-all; all_gather: two int32
    for out in two_ranks:
        psum, scat, gat = map(float, out["SENT"].split())
        assert psum == 180 + 360 + 1
        assert scat == 180 / 2 + 360 / 2
        assert gat == 8


def test_member_death_raises_cleanly_within_timeout(_started):
    """A member that never joins: the survivor raises ProcessGroupError
    (exit 7, ``GROUP_ERROR 0``) within its 10 s bound — never a hang."""
    t0, (survivor, dead) = _started["death"]
    try:
        d_out, _ = dead.communicate(timeout=30)
        s_out, s_err = survivor.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        survivor.kill()
        dead.kill()
        pytest.fail("member-death rendezvous hung past the bounded timeout")
    wall = time.monotonic() - t0
    assert dead.returncode == 3 and "DIED 1" in d_out
    assert survivor.returncode == 7, f"{s_out}\n{s_err[-3000:]}"
    line = [ln for ln in s_out.splitlines() if ln.startswith("GROUP_ERROR")]
    assert line and line[0].split()[1] == "0", s_out
    assert line[0].split()[3] == "ProcessGroupError"
    assert 9.0 <= float(line[0].split()[2]) <= 15.0, line
    assert wall < 45, f"took {wall:.1f}s"


class TestProcessGroupGate:
    def test_single_process_gate(self):
        assert not dist.in_process_group()
        with pytest.raises(dist.ProcessGroupError,
                           match="process_count=1"):
            dist.require_process_group(2)
        info = dist.require_process_group(1)
        assert info.process_count == 1 and info.is_coordinator

    def test_initialize_without_an_address_is_the_local_view(self):
        info = dist.initialize()
        assert (info.process_index, info.process_count,
                info.global_device_count) == (0, 1, 1)
        dist.shutdown()     # a no-op outside a group

    def test_shard_table_for_host(self):
        t = DataTable({"x": np.arange(10.0)})
        assert dist.shard_table_for_host(t) is t
        two = dist.HostInfo(1, 2, 1, 2)
        np.testing.assert_array_equal(
            dist.shard_table_for_host(t, two)["x"],
            t.shards(2)[1]["x"])

    def test_barrier_address_follows_the_coordinator(self, monkeypatch):
        monkeypatch.delenv("MMLSPARK_TPU_TORCH_BARRIER_PORT", raising=False)
        assert dist._barrier_address("10.0.0.1:9377") == ("10.0.0.1", 9378)
        monkeypatch.setenv("MMLSPARK_TPU_TORCH_BARRIER_PORT", "5000")
        assert dist._barrier_address(":9377") == ("127.0.0.1", 5000)


@pytest.mark.parametrize("n", [1, 7, 8, 13, 64])
def test_pack_bits_round_trip(n):
    m = torch.from_numpy(np.random.default_rng(n).random(n) < 0.4)
    packed = dist.pack_bits(m)
    assert packed.dtype == torch.uint8 and packed.numel() == -(-n // 8)
    assert torch.equal(dist.unpack_bits(packed, n), m)


def test_group_of_one_collectives_are_the_identity():
    ax = dist.Axis()
    t = torch.arange(12, dtype=torch.int16).reshape(3, 4)
    assert ax.psum(t).dtype == torch.int32
    assert torch.equal(ax.psum(t), t.to(torch.int32))
    assert torch.equal(ax.psum_scatter(t, dim=1), t.to(torch.int32))
    assert torch.equal(ax.all_gather(t), t[None])
    assert ax.broadcast(t, src=0) is t
    assert ax.sent == {"psum": 0.0, "psum_scatter": 0.0, "all_gather": 0.0}
