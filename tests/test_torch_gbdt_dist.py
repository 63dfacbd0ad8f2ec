"""PyTorch port: distributed GBDT over torch.distributed against JAX.

Two real ranks of the port (``mmlspark_tpu_torch.testing.gbdt_rank``,
gloo, one process each, on the CPU) run one sweep of fits, spawned once
for the file. They are held against the JAX package's in-process
2-device mesh (``make_mesh({"data": 2}, devices=jax.devices()[:2])``,
as ``tests/test_multihost_fabric.py``'s single-group oracle replays a
2-process group):

  - the two ranks' forests are bitwise equal in every fit, and
    hist_comm='reduce_scatter' grows psum's forest bitwise, in f32 and
    at 16 bits (``tests/test_gbdt_dist_quant.py::TestReduceScatter``);
  - sketch bins: the cuts the ranks agree on through all-gathered
    quantile-sketch summaries are bitwise the oracle's merged sketches';
  - quantized forests (psum and reduce_scatter) against the oracle:
    structure, counts, thresholds, params and the first tree bitwise,
    later leaf values within rtol 1e-5 (their L1 scale sums and score
    updates round in another order than XLA's, ROADMAP.md §3, so the
    model strings differ in those last bits); f32 forests follow the
    forest rule of ROADMAP.md §3 (first tree and structure bitwise,
    leaves rtol 1e-5);
  - a q16 group forest against a one-process q16 fit with the group's
    cuts frozen: structure and counts bitwise, values rtol 1e-5
    (``test_q16_sharded_matches_serial``);
  - voting and feature modes follow ``tests/test_gbdt.py``'s contracts
    (root splits bitwise and near-tie flips only at top_k >= F; AUC
    above 0.95 at top_k 3; feature-parallel structure equal to serial);
  - the bytes each rank sends per collective, against the JAX package's
    ring model (``TestCommModel``).
"""

import contextlib
import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax

from mmlspark_tpu.gbdt.binning import BinMapper as JBinMapper
from mmlspark_tpu.gbdt.booster import comm_payload_model as jcomm_model
from mmlspark_tpu.gbdt.booster import train as jtrain
from mmlspark_tpu.gbdt.sketch import QuantileSketch as JSketch
from mmlspark_tpu.gbdt.sketch import merge_sketch_lists as jmerge
from mmlspark_tpu.parallel import mesh as mesh_lib

from mmlspark_tpu_torch.gbdt.booster import Booster, comm_payload_model
from mmlspark_tpu_torch.gbdt.booster import train as ttrain
from mmlspark_tpu_torch.gbdt.sketch import QuantileSketch as TSketch
from mmlspark_tpu_torch.gbdt.sketch import merge_sketch_lists as tmerge
from mmlspark_tpu_torch.testing import gbdt_rank

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRUCT = ("feature", "bin_threshold", "left", "right", "count")
SWEEP = ("fabric:f32_psum,f32_rs,q16_psum,q16_rs,vote_all,vote_q16,"
         "feature,qref;vote:f32_psum,vote_all,vote_3_long;"
         "fp:feature,f32_psum,f32_rs,q16_psum,q16_rs")


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


def start_ranks(extra, world=2):
    """Start ``world`` ranks of gbdt_rank; ``wait_ranks`` collects them.
    The liveness barrier gets a free port of its own (its default, the
    store's + 1, may be taken)."""
    port, bport = _free_ports(2)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "MMLSPARK_TPU_TORCH_"))}
    env["MMLSPARK_TPU_TORCH_BARRIER_PORT"] = str(bport)
    return [subprocess.Popen(
        [sys.executable, "-m", "mmlspark_tpu_torch.testing.gbdt_rank",
         str(port), str(r), str(world), *extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]


def wait_ranks(procs, timeout=120):
    """[(rc, stdout, stderr)] of started ranks. Every wait is bounded:
    on a timeout every rank is killed."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate(timeout=30)
        pytest.fail(f"gbdt ranks hung past {timeout} s; got {outs}")
    return outs


def parse(outs):
    """{(kind, rank, name): fields} from the ranks' lines."""
    lines = {}
    for rc, out, err in outs:
        assert rc == 0, f"rank failed (rc={rc}):\n{out}\n{err[-3000:]}"
        for ln in out.splitlines():
            parts = ln.split()
            if parts and parts[0] in ("DIGEST", "FIT", "BINS", "QREF",
                                      "VOTE"):
                lines[(parts[0], int(parts[1]), parts[2])] = parts[3:]
    return lines


@pytest.fixture(scope="module")
def _started(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    return start_ranks(["--device", "cpu", "--sweep", SWEEP, "--out",
                        str(out)]), out


@pytest.fixture(scope="module", autouse=True)
def _ranks_beside_the_oracle(_started, oracle):
    """Start the ranks first, so that they run while the JAX oracle
    fits in this process."""


@pytest.fixture(scope="module")
def group(_started):
    procs, out = _started
    lines = parse(wait_ranks(procs))

    def forest(name, rank=0):
        data, tag = name.split("/")
        with open(out / f"{data}.{tag}.rank{rank}.txt") as fh:
            return Booster.from_string(fh.read(), device="cpu")
    return lines, forest


FITS = ["fabric/" + t for t in ("f32_psum", "f32_rs", "q16_psum", "q16_rs",
                                "vote_all", "vote_q16", "feature")] + \
    ["vote/f32_psum", "vote/vote_all", "vote/vote_3_long", "fp/feature",
     "fp/f32_psum", "fp/f32_rs", "fp/q16_psum", "fp/q16_rs"]


# -- the JAX package's 2-device oracle -----------------------------------

def _sketch_mapper_oracle():
    """The fabric drill's merged-sketch cuts, as tests/
    test_multihost_fabric.py replays them: each rank's two 100-row shards
    into per-feature sketches, through the to_wire / from_wire round
    trip, merged in rank order."""
    GX, GY = gbdt_rank.fabric_table()
    wires = []
    for pid in range(2):
        lo, hi = pid * 200, (pid + 1) * 200
        sks = [JSketch() for _ in range(6)]
        for blk in (GX[lo:lo + 100], GX[lo + 100:hi]):
            for j, sk in enumerate(sks):
                sk.update(blk[:, j])
        wires.append(np.stack([sk.to_wire(512) for sk in sks]))
    merged = [JSketch.from_wire(wires[0][j]) for j in range(6)]
    for j, sk in enumerate(merged):
        sk.merge(JSketch.from_wire(wires[1][j]))
    return JBinMapper.fit_streaming([], max_bin=15, sketches=merged)


@pytest.fixture(scope="module")
def oracle(cpu_mesh_devices):
    GX, GY = gbdt_rank.fabric_table()
    mapper = _sketch_mapper_oracle()
    shards = [(GX[k:k + 100], GY[k:k + 100]) for k in range(0, 400, 100)]
    mesh = mesh_lib.make_mesh({"data": 2}, devices=jax.devices()[:2])
    params = {"objective": "binary", "num_iterations": 5, "num_leaves": 7,
              "max_bin": 15, "min_data_in_leaf": 5, "parallelism": "data",
              "hist_method": "scatter", "bin_fit": "sketch"}
    X, y = gbdt_rank.fp_table()
    fits = {
        # the feature mode at F = 37 (a padded dummy feature on 2 devices)
        "feature": jtrain({"objective": "binary", "num_iterations": 6,
                           "num_leaves": 15, "max_bin": 31,
                           "min_data_in_leaf": 5, "parallelism": "feature",
                           "hist_method": "scatter"}, X, y, mesh=mesh),
        "f32_psum": jtrain({**params, "hist_comm": "psum"}, shards,
                           bin_mapper=mapper, mesh=mesh),
        "q16_psum": jtrain({**params, "hist_bits": 16, "hist_comm": "psum"},
                           shards, bin_mapper=mapper, mesh=mesh),
        "q16_rs": jtrain({**params, "hist_bits": 16,
                          "hist_comm": "reduce_scatter"}, shards,
                         bin_mapper=mapper, mesh=mesh),
    }
    return mapper, fits


@contextlib.contextmanager
def _one_thread():
    """One torch thread for a small in-process fit: the ranks and the
    other test workers already hold the cores (these tensors sit below
    torch's grain size, so the results do not change)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _bins_digest(mapper) -> str:
    return hashlib.sha256(b"".join(
        np.asarray(u).tobytes() for u in mapper.upper_bounds)
    ).hexdigest()[:16]


# -- the group's own contracts ---------------------------------------------

@pytest.mark.parametrize("name", FITS)
def test_ranks_grow_bitwise_equal_forests(group, name):
    lines, _ = group
    assert lines[("DIGEST", 0, name)] == lines[("DIGEST", 1, name)]
    assert lines[("BINS", 0, name)] == lines[("BINS", 1, name)]


@pytest.mark.parametrize("data", ["fabric", "fp"])
@pytest.mark.parametrize("bits", ["f32", "q16"])
def test_reduce_scatter_grows_the_psum_forest_bitwise(group, bits, data):
    """Also at F = 37 (``fp``), where the feature axis pads to the group
    size and rank 1 owns a phantom feature."""
    lines, forest = group
    # the forest's arrays: everything but the params' hist_comm
    assert lines[("DIGEST", 0, f"{data}/{bits}_rs")][1] == \
        lines[("DIGEST", 0, f"{data}/{bits}_psum")][1]
    assert forest(f"{data}/{bits}_rs").params["hist_comm"] == \
        "reduce_scatter"


def test_every_fit_builds_its_histograms_with_no_launch_on_the_cpu(group):
    lines, _ = group
    for name in FITS:
        for r in (0, 1):
            fit = lines[("FIT", r, name)]
            assert int(fit[2]) == 0, (name, fit)     # CPU: plain version
            assert int(fit[3]) > 0, (name, fit)


# -- against the JAX package's 2-device oracle -----------------------------

def test_sketch_bins_bitwise_the_oracles(group, oracle):
    lines, forest = group
    mapper, _ = oracle
    assert lines[("BINS", 0, "fabric/f32_psum")][0] == _bins_digest(mapper)
    got = forest("fabric/f32_psum")
    # the cut thresholds the forest carries are the oracle's
    want = oracle[1]["f32_psum"]
    np.testing.assert_array_equal(got.trees["threshold"][:, 0],
                                  want.trees["threshold"][:, 0])


@pytest.mark.parametrize("tag", ["q16_psum", "q16_rs"])
def test_quantized_forest_matches_the_oracle(group, oracle, tag):
    _, forest = group
    got, want = forest(f"fabric/{tag}"), oracle[1][tag]
    for k in STRUCT + ("threshold", "is_leaf"):
        np.testing.assert_array_equal(got.trees[k], want.trees[k],
                                      err_msg=k)
    np.testing.assert_array_equal(got.trees["value"][0],
                                  want.trees["value"][0])
    np.testing.assert_allclose(got.trees["value"], want.trees["value"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(got.init_score, want.init_score)
    assert got.params == want.params


def test_f32_forest_follows_the_forest_rule(group, oracle):
    _, forest = group
    got, want = forest("fabric/f32_psum"), oracle[1]["f32_psum"]
    for k in ("feature", "bin_threshold", "left", "right", "value",
              "count"):
        np.testing.assert_array_equal(got.trees[k][0], want.trees[k][0],
                                      err_msg=f"first tree {k}")
    for k in ("feature", "bin_threshold", "left", "right"):
        np.testing.assert_array_equal(got.trees[k], want.trees[k],
                                      err_msg=k)
    np.testing.assert_allclose(got.trees["value"], want.trees["value"],
                               rtol=1e-5, atol=1e-7)


def test_q16_group_matches_a_one_process_fit_with_its_cuts(group):
    lines, _ = group
    same, rel, _, _ = lines[("QREF", 0, "fabric")]
    assert same == "1" and float(rel) <= 1e-5, (same, rel)


def test_voting_with_quantized_wire_matches_data_parallel_structure(group):
    lines, forest = group
    bd, bv = forest("fabric/q16_psum"), forest("fabric/vote_q16")
    for k in STRUCT:
        np.testing.assert_array_equal(bd.trees[k], bv.trees[k], err_msg=k)
    np.testing.assert_allclose(bd.trees["value"], bv.trees["value"],
                               rtol=1e-4, atol=1e-6)


def test_voting_covering_every_feature_matches_data_parallel(group):
    """tests/test_gbdt.py's contract at top_k >= F: root splits bitwise,
    near-tie flips only (<= 2 % of the nodes), predictions close to the
    serial fit's."""
    _, forest = group
    bd, bv = forest("vote/f32_psum"), forest("vote/vote_all")
    np.testing.assert_array_equal(bd.trees["feature"][:, 0],
                                  bv.trees["feature"][:, 0])
    np.testing.assert_array_equal(bd.trees["bin_threshold"][:, 0],
                                  bv.trees["bin_threshold"][:, 0])
    total = mismatched = 0
    for k in ("feature", "bin_threshold", "left", "right"):
        total += bd.trees[k].size
        mismatched += int(np.sum(bd.trees[k] != bv.trees[k]))
    assert mismatched <= 0.02 * total, f"{mismatched}/{total}"
    # the rank's own comparison line, which chip_smoke.py reads
    assert group[0][("VOTE", 0, "vote")] == ["1", str(mismatched),
                                             str(total)]
    X, y = gbdt_rank.vote_table()
    with _one_thread():
        bs = ttrain({"objective": "binary", "num_iterations": 6,
                     "num_leaves": 15, "max_bin": 31,
                     "min_data_in_leaf": 5}, X, y, device="cpu")
    np.testing.assert_allclose(bs.predict(X), bv.predict(X), rtol=5e-2,
                               atol=5e-3)


def test_voting_quality_at_small_k(group):
    lines, _ = group
    assert float(lines[("FIT", 0, "vote/vote_3_long")][4]) > 0.95


def test_feature_parallel_matches_serial(group):
    """tests/test_gbdt.py's contract (F = 37, not a multiple of the
    group: a padded dummy feature): structure of the serial fit, and
    predictions within rtol 1e-5."""
    _, forest = group
    X, y = gbdt_rank.fp_table()
    with _one_thread():
        bs = ttrain({"objective": "binary", "num_iterations": 6,
                     "num_leaves": 15, "max_bin": 31,
                     "min_data_in_leaf": 5}, X, y, device="cpu")
    bf = forest("fp/feature")
    for k in ("feature", "bin_threshold", "left", "right"):
        np.testing.assert_array_equal(bs.trees[k], bf.trees[k], err_msg=k)
    np.testing.assert_allclose(bs.predict(X), bf.predict(X), rtol=1e-5,
                               atol=1e-6)


def test_feature_parallel_matches_the_jax_feature_mode(group, oracle):
    _, forest = group
    X, _ = gbdt_rank.fp_table()
    jf = oracle[1]["feature"]
    bf = forest("fp/feature")
    for k in ("feature", "bin_threshold", "left", "right"):
        np.testing.assert_array_equal(jf.trees[k], bf.trees[k], err_msg=k)
    # the JAX feature mode sums its leaves over rows (segment_sum), the
    # port takes rank 0's feature-0 histogram sums (serial's): the
    # contract of tests/test_gbdt.py holds predictions to rtol 1e-5
    np.testing.assert_allclose(jf.predict(X), bf.predict(X), rtol=1e-5,
                               atol=1e-6)


# -- the wire ----------------------------------------------------------------

@pytest.mark.parametrize("name,hist_comm,bits", [
    ("fabric/f32_psum", "psum", 32), ("fabric/q16_psum", "psum", 16),
    ("fabric/f32_rs", "reduce_scatter", 32),
    ("fabric/q16_rs", "reduce_scatter", 16)])
def test_sent_bytes_equal_the_ring_model_at_two_ranks(group, name,
                                                      hist_comm, bits):
    """Every fabric tree grows all 7 leaves, so each rank's psum and
    psum_scatter bytes are the JAX package's two-device model exactly;
    its candidate all-gathers send a rank's payload once, twice the
    model's S (D - 1) / D."""
    lines, _ = group
    fit = lines[("FIT", 0, name)]
    assert int(fit[3]) == 5 * 7
    sent = dict(zip(("psum", "psum_scatter", "all_gather"),
                    map(float, fit[5:8])))
    # 5 trees of 7 leaves, 6 features, 15 bins, 2 ranks
    model = comm_payload_model("data", hist_comm, bits, 5, 7, 6, 15, 2,
                               20, 200)
    assert sent["psum"] == model["psum"]
    assert sent["psum_scatter"] == model["psum_scatter"]
    assert sent["all_gather"] == 2 * model["all_gather"]


def test_quantized_wire_sends_at_least_2x_fewer_bytes(group):
    lines, _ = group

    def total(name):
        return sum(float(v) for v in lines[("FIT", 0, name)][5:8])
    assert total("fabric/f32_psum") >= 2.0 * total("fabric/q16_rs")
    assert total("fabric/f32_psum") >= 1.9 * total("fabric/q16_psum")


@pytest.mark.parametrize("args", [
    ("data", "psum", 32, 10, 31, 28, 255, 4, 20, 10000),
    ("data", "psum", 16, 10, 31, 28, 255, 4, 20, 10000),
    ("data", "reduce_scatter", 16, 10, 31, 28, 255, 4, 20, 10000),
    ("data", "reduce_scatter", 32, 10, 31, 32, 255, 4, 20, 10000),
    ("voting", "psum", 16, 7, 15, 24, 31, 2, 3, 1000),
    ("feature", "psum", 32, 7, 15, 37, 31, 2, 20, 2000),
    ("data", "psum", 16, 10, 31, 28, 255, 1, 20, 10000)])
def test_comm_model_is_the_jax_packages(args):
    assert comm_payload_model(*args) == jcomm_model(*args)


def test_comm_model_contracts():
    """tests/test_gbdt_dist_quant.py::TestCommModel over the port's
    model."""
    a32 = comm_payload_model("data", "psum", 32, 10, 31, 28, 255, 4, 20,
                             10000)
    a16 = comm_payload_model("data", "psum", 16, 10, 31, 28, 255, 4, 20,
                             10000)
    assert a32["psum"] == pytest.approx(2 * (a16["psum"]
                                             - 10 * 2 * 12 * 3 / 4))
    ps = comm_payload_model("data", "psum", 32, 10, 31, 32, 255, 4, 20,
                            10000)
    rs = comm_payload_model("data", "reduce_scatter", 32, 10, 31, 32, 255,
                            4, 20, 10000)
    assert rs["psum_scatter"] == pytest.approx(ps["psum"] / 2)
    q16 = sum(comm_payload_model("data", "reduce_scatter", 16, 10, 31, 28,
                                 255, 4, 20, 10000).values())
    assert sum(a32.values()) / q16 >= 2.0
    assert sum(comm_payload_model("data", "psum", 16, 10, 31, 28, 255, 1,
                                  20, 10000).values()) == 0


# -- the sketch state across processes ---------------------------------------

def _sketched(cls, X, b=64):
    sks = [cls(b=b) for _ in range(X.shape[1])]
    for blk in np.array_split(X, 4):
        for j, sk in enumerate(sks):
            sk.update(blk[:, j])
    return sks


def test_sketch_state_round_trip_matches_jax():
    X = np.random.default_rng(4).normal(size=(3000, 3))
    for t, j in zip(_sketched(TSketch, X), _sketched(JSketch, X)):
        st, sj = t.to_state(), j.to_state()
        assert json.dumps(st) == json.dumps(sj)
        back = TSketch.from_state(json.loads(json.dumps(st)))
        np.testing.assert_array_equal(back.cuts(15), t.cuts(15))
        assert back.eps() == t.eps() and back.count == t.count


def test_merge_sketch_lists_matches_jax():
    rng = np.random.default_rng(5)
    parts = [rng.normal(size=(800, 3)) for _ in range(3)]
    tm = tmerge([_sketched(TSketch, p) for p in parts])
    jm = jmerge([_sketched(JSketch, p) for p in parts])
    for t, j in zip(tm, jm):
        np.testing.assert_array_equal(t.cuts(31), j.cuts(31))
        assert t.eps() == j.eps()
    with pytest.raises(ValueError, match="feature-count mismatch"):
        tmerge([_sketched(TSketch, parts[0]),
                _sketched(TSketch, parts[1][:, :2])])
    with pytest.raises(ValueError, match="no sketches"):
        tmerge([])
