"""PyTorch port: the shared-memory columnar transport (``io/shm.py``),
the columnar codecs' new parts (``columns_to_rows``, ``StagingPool``,
the ingress registry) and the fleet's ``post_columns`` ladder, against
the JAX package, on the CPU.

Held against the JAX package: a frame written by the port's ``ShmRing``
decodes through ``mmlspark_tpu.io.shm.decode_control`` to the same
columns bitwise, and the reverse; with the ``msgpack`` package absent
from the reference the two rings write the same frame bytes;
``columns_to_rows`` and ``StagingPool`` are equal. The reference's ring
cases (``tests/test_shm_transport.py``) run over the port's ring, the
fleet cases over port engines on free ports (``post_columns`` bitwise
the per-row JSON oracle, the old-engine ladder, the cooldown,
backpressure riding HTTP without one), and the survivor reap over an
owner process that imports the port with JAX blocked. The reference's
SIGKILL-an-engine drill runs as ``slow``: it spawns three long-lived
engine processes (``mmlspark_tpu_torch.testing.serving_worker``).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from mmlspark_tpu.io import columnar as JC
from mmlspark_tpu.io import shm as JS

from mmlspark_tpu_torch.io import columnar as C
from mmlspark_tpu_torch.io import shm as S
from mmlspark_tpu_torch.testing import fusion_check

pytestmark = pytest.mark.skipif(
    not S.shm_available(), reason="no POSIX shared memory on this host")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COLS = {
    "f32": np.array([[1.5, -2.25], [np.nan, np.inf], [-np.inf, 0.0]],
                    dtype=np.float32),
    "f64": np.array([1.0, np.nan, -1e300]),
    "i64": np.array([1, -2, 2**40], dtype=np.int64),
    "flag": np.array([True, False, True]),
    "s": ["héllo", None, "𝔘nicode\n\"quoted\""],
    "toks": [["a", "bb"], [], ["𝔠", ""]],
}


@pytest.fixture()
def ring():
    r = S.ShmRing(nslots=2, slot_bytes=1 << 16)
    yield r
    r.close()
    S.close_attachments()


def _assert_same_columns(got, want):
    assert got.n_rows == want.n_rows
    assert sorted(got.columns) == sorted(want.columns)
    for k, v in want.columns.items():
        g = got.columns[k]
        if isinstance(v, np.ndarray):
            assert g.dtype == v.dtype and g.shape == v.shape
            assert g.tobytes() == v.tobytes(), k
        else:
            assert [list(x) if isinstance(x, list) else x for x in g] == \
                [list(x) if isinstance(x, list) else x for x in v], k


def _tpu_model(dim=8, classes=4):
    from mmlspark_tpu_torch.models.tpu_model import TPUModel
    rng = np.random.default_rng(3)
    W = rng.normal(size=(dim, classes)).astype(np.float32)
    return TPUModel.from_fn(
        lambda w, ins: list(ins.values())[0] @ w["W"], {"W": W},
        inputCol="features", outputCol="scores", batchSize=32,
        device="cpu")


# ---------------------------------------------------------------------------
# the wire format, both ways
# ---------------------------------------------------------------------------


class TestCrossPackageFrames:
    def test_port_frame_decodes_in_reference(self, ring):
        ctrl, _, token = ring.write(COLS)
        try:
            got = JS.decode_control(ctrl)
            want = S.decode_control(ctrl)
            assert got.codec == want.codec == "shm"
            _assert_same_columns(got, want)
            oracle = JC.decode_columnar(
                "msgpack", JC.encode_columns(COLS)[0])
            _assert_same_columns(got, oracle)
        finally:
            ring.release(token)
            JS.close_attachments()

    def test_reference_frame_decodes_in_port(self):
        jring = JS.ShmRing(nslots=2, slot_bytes=1 << 16)
        try:
            ctrl, ct, token = jring.write(COLS)
            assert ct == C.CT_SHM_COLUMNS
            got = S.decode_control(ctrl)
            _assert_same_columns(got, JS.decode_control(ctrl))
            got = C.decode_columnar(C.negotiate({"Content-Type": ct}), ctrl)
            assert got.codec == "shm"
            jring.release(token)
        finally:
            jring.close()
            JS.close_attachments()
            S.close_attachments()

    def test_same_frame_bytes_without_msgpack(self, monkeypatch):
        """The reference writes a JSON frame header when ``msgpack`` is
        absent, as the port always does: the slots then hold the same
        bytes, header and generation included."""
        monkeypatch.setattr(JS, "_msgpack", lambda: None)
        r = S.ShmRing(nslots=2, slot_bytes=1 << 16)
        jr = JS.ShmRing(nslots=2, slot_bytes=1 << 16)
        try:
            ctrl, _, tok = r.write(COLS)
            jctrl, _, jtok = jr.write(COLS)
            c, jc = json.loads(ctrl), json.loads(jctrl)
            assert {k: v for k, v in c.items() if k != "seg"} == \
                {k: v for k, v in jc.items() if k != "seg"}
            lo, hi = c["off"] - S._SLOT_HDR.size, c["off"] + c["len"]
            assert bytes(r._shm.buf[lo:hi]) == bytes(jr._shm.buf[lo:hi])
            r.release(tok)
            jr.release(jtok)
        finally:
            r.close()
            jr.close()

    def test_stale_reference_generation_refused_by_port(self):
        jring = JS.ShmRing(nslots=1, slot_bytes=1 << 12)
        try:
            old, _, tok = jring.write({"x": np.ones(3)})
            jring.release(tok)
            new, _, tok = jring.write({"y": np.zeros(5)})
            with pytest.raises(C.CodecError, match="stale shm slot"):
                S.decode_control(old)
            assert S.decode_control(new).n_rows == 5
            jring.release(tok)
        finally:
            jring.close()
            S.close_attachments()


class TestColumnarParts:
    @pytest.mark.parametrize("cols", [
        COLS,
        {"features": np.arange(12, dtype=np.float32).reshape(4, 3),
         "n": np.array([1, 2, 3, 4])},
        {"a": [1.5, 2.5], "b": np.array([np.float32(3), np.float32(4)])},
    ])
    def test_columns_to_rows_matches_reference(self, cols):
        got = C.columns_to_rows(cols)
        want = JC.columns_to_rows(cols)
        assert json.dumps(got, sort_keys=True, allow_nan=True) == \
            json.dumps(want, sort_keys=True, allow_nan=True)

    def test_staging_pool_matches_reference(self):
        rng = np.random.default_rng(5)
        pool, jpool = C.StagingPool(depth=2), JC.StagingPool(depth=2)
        for n, bucket in ((3, 8), (5, 8), (8, 8), (2, 8), (1, 4), (7, 8)):
            x = rng.normal(size=(n, 3)).astype(np.float32)
            got = pool.pad("f", x, bucket)
            want = jpool.pad("f", x, bucket)
            assert got.tobytes() == want.tobytes() and \
                got.shape == want.shape
        assert pool.stats() == jpool.stats()
        with pytest.raises(ValueError):
            pool.pad("f", np.zeros((0, 3), np.float32), 4)

    def test_powerbi_writer_posts_like_reference(self):
        """``io/http.py::PowerBIWriter`` posts the same JSON batches as
        the reference's to a push endpoint and returns its statuses."""
        import http.server
        from mmlspark_tpu.core.table import DataTable as JTable
        from mmlspark_tpu.io.http import PowerBIWriter as JWriter
        from mmlspark_tpu_torch.core.table import DataTable
        from mmlspark_tpu_torch.io.http import PowerBIWriter
        bodies = []

        class Push(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 (http.server API)
                n = int(self.headers["Content-Length"])
                bodies.append(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Push)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}/push"
        cols = {"x": np.arange(5.0), "s": ["a", "b", "c", "d", "e"]}
        try:
            got = PowerBIWriter.write(DataTable(cols), url, batch_size=2)
            ours = list(bodies)
            bodies.clear()
            want = JWriter.write(JTable(cols), url, batch_size=2)
            assert got == want == [200, 200, 200]
            assert ours == bodies and [len(b) for b in ours] == [2, 2, 1]
        finally:
            srv.shutdown()
            srv.server_close()

    def test_ingress_registry_names_match_reference(self):
        names = set(C.INGRESS_REGISTRY.values())
        jnames = set(JC.INGRESS_REGISTRY.values())
        assert names == jnames, (names ^ jnames)


# ---------------------------------------------------------------------------
# the reference's ring cases over the port's ring
# ---------------------------------------------------------------------------


class TestShmRing:
    def test_roundtrip_parity_all_types(self, ring):
        ctrl, ct, token = ring.write(COLS)
        assert ct == C.CT_SHM_COLUMNS
        try:
            got = S.decode_control(ctrl)
            oracle = C.decode_columnar("msgpack", C.encode_columns(COLS)[0])
            assert got.codec == "shm"
            _assert_same_columns(got, oracle)
        finally:
            ring.release(token)

    def test_numeric_columns_are_views_into_the_segment(self, ring):
        arr = np.arange(64, dtype=np.float32).reshape(8, 8)
        ctrl, _, token = ring.write({"f": arr})
        try:
            dec = S.decode_control(ctrl).columns["f"]
            assert dec.base is not None and not dec.flags.owndata
            np.testing.assert_array_equal(dec, arr)
        finally:
            ring.release(token)

    def test_content_type_negotiates_to_shm_codec(self, ring):
        ctrl, ct, token = ring.write({"x": np.ones(2)})
        try:
            assert C.negotiate({"Content-Type": ct}) == "shm"
            b = C.decode_columnar("shm", ctrl)
            assert b.codec == "shm" and b.n_rows == 2
        finally:
            ring.release(token)

    def test_stale_generation_raises(self, ring):
        ctrl_old, _, token = ring.write({"x": np.ones(3)})
        ring.release(token)
        ctrl_new, _, token2 = ring.write({"y": np.zeros(5)})
        try:
            with pytest.raises(C.CodecError, match="stale shm slot"):
                S.decode_control(ctrl_old)
            assert S.decode_control(ctrl_new).n_rows == 5
            assert S.stats()["gen_mismatch"] >= 1
        finally:
            ring.release(token2)

    def test_backpressure_when_all_slots_in_flight(self, ring):
        t1 = ring.write({"x": np.ones(1)})[2]
        t2 = ring.write({"x": np.ones(1)})[2]
        with pytest.raises(S.ShmBackpressure):
            ring.write({"x": np.ones(1)})
        ring.release(t1)
        t3 = ring.write({"x": np.ones(1)})[2]
        ring.release(t2)
        ring.release(t3)

    def test_capacity_failure_returns_the_slot(self, ring):
        with pytest.raises(S.ShmCapacity):
            ring.write({"x": np.zeros(1 << 18)})
        tokens = [ring.write({"x": np.ones(1)})[2] for _ in range(2)]
        for t in tokens:
            ring.release(t)

    def test_unclean_release_quarantines_the_slot(self):
        r = S.ShmRing(nslots=1, slot_bytes=1 << 12)
        try:
            r.release(r.write({"x": np.ones(1)})[2], clean=False)
            with pytest.raises(S.ShmBackpressure):
                r.write({"x": np.ones(1)})
            with r._lock:
                r._quarantine[:] = [(t, 0.0) for t, _ in r._quarantine]
            r.release(r.write({"x": np.ones(1)})[2])
        finally:
            r.close()
            S.close_attachments()

    def test_nonexistent_segment_raises_codec_error(self):
        ctrl = json.dumps({"v": 1, "seg": "psm_does_not_exist_xyz",
                           "slot": 0, "off": 16, "len": 64, "gen": 1,
                           "pid": 0}).encode()
        with pytest.raises(C.CodecError, match="not attachable"):
            S.decode_control(ctrl)

    @pytest.mark.parametrize("bad", [b"", b"not json", b"{}",
                                     b'{"seg": 7}'])
    def test_malformed_control_raises_codec_error(self, bad):
        with pytest.raises(C.CodecError):
            S.decode_control(bad)

    def test_out_of_bounds_frame_refused(self, ring):
        ctrl, _, token = ring.write({"x": np.ones(2)})
        try:
            c = json.loads(ctrl)
            c["len"] = ring.nslots * (S._SLOT_HDR.size
                                      + ring.slot_bytes) + 64
            with pytest.raises(C.CodecError, match="exceeds segment"):
                S.decode_control(json.dumps(c).encode())
        finally:
            ring.release(token)

    def test_close_unlinks_the_segment(self):
        r = S.ShmRing(nslots=1, slot_bytes=1 << 12)
        name = r.name
        assert os.path.exists(f"/dev/shm/{name}")
        r.close()
        r.close()      # twice is safe
        assert not os.path.exists(f"/dev/shm/{name}")


# ---------------------------------------------------------------------------
# the audits: the shipped sources are clean, seeded violations flagged
# ---------------------------------------------------------------------------


class TestAudits:
    def test_shipped_ingress_kernels_clean(self):
        assert C.INGRESS_REGISTRY
        assert fusion_check.check_ingress_kernels() == []

    def test_ingress_audit_flags_row_loop_and_boxing(self):
        def bad_decode(body):
            out = []
            for i in range(len(body)):
                out.append(float(body[i]))
            return out

        def boxy(arr):
            return arr.tolist()

        def ok_loop(cols):
            out = {}
            for name in cols:  # ingress:row-ok — per-column
                out[name] = cols[name]
            return out

        for fn, name in ((bad_decode, "test.bad_decode"),
                         (boxy, "test.boxy"), (ok_loop, "test.ok_loop")):
            C.register_ingress_kernel(fn, name)
        try:
            v = fusion_check.check_ingress_kernels()
            assert any("test.bad_decode" in x and "iteration" in x
                       for x in v), v
            assert any("test.boxy" in x and "boxing" in x for x in v), v
            assert not any("test.ok_loop" in x for x in v), v
        finally:
            for fn in (bad_decode, boxy, ok_loop):
                C.INGRESS_REGISTRY.pop(fn.__code__, None)

    def test_ingress_source_form(self):
        src = "def k(b):\n    return [x for x in b]\n"
        v = fusion_check.check_ingress_source(
            "seeded", src, 1, src.splitlines(True))
        assert v and "iteration" in v[0]

    def test_shipped_shm_hot_paths_clean(self):
        assert S.SHM_REGISTRY
        assert fusion_check.check_shm_transport() == []

    def test_shm_audit_flags_copies_and_leaked_slots(self):
        def copying_path(arr, mv):
            mv[:arr.nbytes] = arr.tobytes()

        def sanctioned_path(body):
            return bytes(body)  # shm:copy-ok — control message

        def leaky(self, columns):
            slot = self._claim_slot()
            return self.encode(slot, columns)

        def paired(self, columns):
            slot = self._claim_slot()
            try:
                return self.encode(slot, columns)
            except Exception:
                self.release(slot)
                raise

        fns = ((copying_path, "test.copying_path"),
               (sanctioned_path, "test.sanctioned_path"),
               (leaky, "test.leaky"), (paired, "test.paired"))
        for fn, name in fns:
            S.register_shm_kernel(fn, name)
        try:
            v = fusion_check.check_shm_transport()
            assert any("test.copying_path" in x and ".tobytes" in x
                       for x in v), v
            assert any("test.leaky" in x and "leaks the slot" in x
                       for x in v), v
            assert not any("test.sanctioned_path" in x or "test.paired" in x
                           for x in v), v
        finally:
            for fn, _ in fns:
                S.SHM_REGISTRY.pop(fn.__code__, None)

    def test_shm_source_form(self):
        src = ("def w(self, c):\n    s = self._claim_slot()\n"
               "    return bytes(c)\n")
        v = fusion_check.check_shm_source("seeded", src, 1,
                                          src.splitlines(True))
        assert any("bytes()" in x for x in v), v
        assert any("leaks the slot" in x for x in v), v


# ---------------------------------------------------------------------------
# the fleet's ladder over port engines
# ---------------------------------------------------------------------------


class TestShmFleetTransport:
    def test_fleet_shm_bit_parity_and_slot_recycling(self):
        from mmlspark_tpu_torch.serving.fleet import (
            ServingFleet, json_scoring_pipeline,
        )
        fleet = ServingFleet(json_scoring_pipeline(_tpu_model()),
                             n_engines=2, base_port=0, batch_size=8,
                             workers=1, shm_transport=True)
        rng = np.random.default_rng(0)
        x = rng.normal(size=(5, 8))
        x[0, 0] = np.nan
        try:
            out = fleet.post_columns({"features": x})
            assert fleet._shm_ok is True
            ring = fleet._shm_ring
            assert sorted(ring._free) == list(range(ring.nslots))
            ref = [fleet.post({"features": list(map(float, row))})
                   for row in x]
            assert out["prediction"] == [r["prediction"] for r in ref]
            # the same rows over HTTP+msgpack: the same replies
            fleet.shm_transport = False
            assert fleet.post_columns({"features": x}) == out
            text = fleet.metrics_text()
            assert "serving_shm_batches_total" in text
            assert 'codec="shm"' in text
            assert fleet._shm_fallbacks == 0
            name = ring.name
        finally:
            fleet.stop_all()
        assert fleet._shm_ring is None
        assert not os.path.exists(f"/dev/shm/{name}")

    def test_old_engine_falls_down_the_whole_ladder(self):
        from mmlspark_tpu_torch.serving.fleet import ServingFleet
        from mmlspark_tpu_torch.stages.basic import Lambda

        def old_handle(table):   # the pre-columnar protocol, verbatim
            rows = [json.loads(r["entity"].decode())
                    for r in table["request"]]
            return table.with_column(
                "reply", [{"prediction": float(sum(r["features"]))}
                          for r in rows])

        fleet = ServingFleet(Lambda.apply(old_handle), n_engines=1,
                             base_port=0, batch_size=8, workers=1,
                             shm_transport=True)
        try:
            out = fleet.post_columns({"features": np.ones((3, 4))})
            assert out["prediction"] == [4.0, 4.0, 4.0]
            assert fleet._shm_ok is False and fleet._columnar_ok is False
            assert fleet._shm_fallbacks >= 1
            src = fleet.engines[0].source
            seen0 = src.requests_seen
            out = fleet.post_columns({"features": np.ones((3, 4))})
            assert out["prediction"] == [4.0, 4.0, 4.0]
            assert src.requests_seen - seen0 == 3
        finally:
            fleet.stop_all()

    def test_shm_pin_is_a_cooldown_not_a_life_sentence(self):
        from mmlspark_tpu_torch.serving.fleet import (
            ServingFleet, json_scoring_pipeline,
        )
        fleet = ServingFleet(json_scoring_pipeline(_tpu_model()),
                             n_engines=1, base_port=0, batch_size=8,
                             workers=1, shm_transport=True)
        x = np.random.default_rng(1).normal(size=(2, 8))
        try:
            fleet._shm_ok = False
            fleet._shm_retry_at = time.monotonic() + 999
            fleet.post_columns({"features": x})
            assert fleet._shm_ring is None and fleet._shm_ok is False
            fleet._shm_retry_at = 0.0
            out = fleet.post_columns({"features": x})
            assert len(out["prediction"]) == 2
            assert fleet._shm_ok is True and fleet._shm_ring is not None
        finally:
            fleet.stop_all()

    def test_backpressure_rides_http_without_a_cooldown(self):
        from mmlspark_tpu_torch.serving.fleet import (
            ServingFleet, json_scoring_pipeline,
        )
        fleet = ServingFleet(json_scoring_pipeline(_tpu_model()),
                             n_engines=1, base_port=0, batch_size=8,
                             workers=1, shm_transport=True)
        x = np.random.default_rng(2).normal(size=(2, 8))
        try:
            ring = S.ShmRing(nslots=1, slot_bytes=1 << 12)
            ring._claim_slot()          # every slot in flight
            fleet._shm_ring = ring
            out = fleet.post_columns({"features": x})
            assert len(out["prediction"]) == 2
            assert fleet._shm_fallbacks == 1
            assert fleet._shm_ok is True and fleet._shm_retry_at == 0.0
        finally:
            fleet.stop_all()

    def test_stale_control_message_400s_alone(self):
        """An engine that cannot attach one request's frame answers 400
        for that request; its batch-mates are scored."""
        import urllib.error
        from mmlspark_tpu_torch.serving.fleet import (
            ServingFleet, json_scoring_pipeline,
        )
        fleet = ServingFleet(json_scoring_pipeline(_tpu_model()),
                             n_engines=1, base_port=0, batch_size=8,
                             workers=1)
        r = S.ShmRing(nslots=1, slot_bytes=1 << 14)
        x = np.random.default_rng(4).normal(size=(3, 8))
        try:
            old, ct, tok = r.write({"features": x})
            r.release(tok)
            new, ct, tok = r.write({"features": x})
            with pytest.raises(urllib.error.HTTPError) as ei:
                fleet.post(old, content_type=ct)
            assert ei.value.code == 400
            assert len(fleet.post(new, content_type=ct)["prediction"]) == 3
            r.release(tok)
        finally:
            fleet.stop_all()
            r.close()


# ---------------------------------------------------------------------------
# the failure envelope across OS processes
# ---------------------------------------------------------------------------

_OWNER_SCRIPT = """
import sys, time
sys.modules["jax"] = None
import numpy as np
sys.path.insert(0, {repo!r})
from mmlspark_tpu_torch.io import shm as S
r = S.ShmRing(nslots=2, slot_bytes=1 << 14)
ctrl, ct, tok = r.write({{"x": np.arange(8.0)}})
print(ctrl.decode("ascii"), flush=True)
time.sleep(120)
"""


def test_survivor_reaps_dead_owner_segment():
    """The client is SIGKILL'd mid-flight: the engine (survivor) still
    decodes the in-flight frame, and the reaper unlinks the orphaned
    segment once the owner is gone."""
    p = subprocess.Popen(
        [sys.executable, "-c", _OWNER_SCRIPT.format(repo=ROOT)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ctrl = p.stdout.readline().strip().encode()
        assert ctrl, p.stderr.read()
        name = json.loads(ctrl)["seg"]
        assert os.path.exists(f"/dev/shm/{name}")
        batch = S.decode_control(ctrl)
        np.testing.assert_array_equal(batch.columns["x"], np.arange(8.0))
        del batch
        reaped0 = S.stats()["reaped"]
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=30)
        deadline = time.monotonic() + 30
        while os.path.exists(f"/dev/shm/{name}") and \
                time.monotonic() < deadline:
            S.reap_dead_owners(force=True)
            time.sleep(0.05)
        assert not os.path.exists(f"/dev/shm/{name}")
        assert S.stats()["reaped"] >= reaped0 + 1
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)
        S.close_attachments()


def _fd_count() -> int:
    return len(os.listdir("/proc/self/fd"))


@pytest.mark.slow
def test_sigkill_engine_under_shm_load():
    """Kill one of three engine processes mid-shm-load: requests fail
    over to the survivors, availability holds >= 99 % with no wrong
    reply, no fd leak in the client, and the ring is unlinked at
    stop_all."""
    from mmlspark_tpu_torch.serving.fleet import ServingFleet
    dim = 16
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mmlspark_tpu_torch.testing.serving_worker",
         "0", str(wid), "--scorer", "linear", "--batch-size", "32",
         "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=ROOT) for wid in range(3)]
    fleet = None
    try:
        addrs = []
        for p in procs:
            parts = p.stdout.readline().split()
            assert parts and parts[0] == "READY", parts
            addrs.append(parts[2])
        fleet = ServingFleet.connect(addrs, wait_ready_s=60.0,
                                     failure_threshold=2,
                                     breaker_cooldown=1.0, tracing=False,
                                     shm_transport=True)
        rows = np.random.default_rng(3).normal(size=(4, dim)) \
            .astype(np.float32)
        expected = fleet.post_columns({"features": rows})
        assert len(expected["prediction"]) == 4 and fleet._shm_ok
        fd0 = _fd_count()
        results = {"ok": 0, "failed": 0, "wrong": 0}
        lock = threading.Lock()
        stop = threading.Event()

        def client():
            while not stop.is_set():
                try:
                    rep = fleet.post_columns({"features": rows}, timeout=30)
                    with lock:
                        results["ok" if rep == expected else "wrong"] += 1
                except Exception:  # noqa: BLE001
                    with lock:
                        results["failed"] += 1

        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        procs[0].send_signal(signal.SIGKILL)
        time.sleep(3.0)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        total = sum(results.values())
        assert total > 20, results
        assert results["ok"] / total >= 0.99, results
        assert results["wrong"] == 0, results
        assert fleet._shm_ok is True
        assert _fd_count() - fd0 < 20
        ring_name = fleet._shm_ring.name
        fleet.stop_all()
        fleet = None
        assert not os.path.exists(f"/dev/shm/{ring_name}")
    finally:
        if fleet is not None:
            fleet.stop_all()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
