"""PyTorch port: out-of-core and streamed GBDT ingest against the JAX
package, on the CPU.

The same numpy streams, made from a seed, go through the JAX package's
``QuantileSketch``, ``BinMapper.fit_streaming``, ``ChunkedTable`` and
``train`` on shard streams, and through the port's (``device="cpu"``;
the JAX side on its scatter path). Held: sketch summaries, rank bounds,
certificates, cuts and wire vectors bitwise; streaming cuts and
``sketch_eps`` bitwise; ChunkedTable replays chunk for chunk; forests by
ROADMAP.md §3's rule; the JAX package's errors for ambiguous input.
Also: the port's host binning library (``csrc/bins.cpp``, built by the
host compiler) bitwise against its plain numpy version.

The scenarios of ``tests/test_ooc.py``'s ``TestChunkedPipelines`` and
``TestOOCChecker`` run through the port: the fused chunked transform
bitwise per chunk to the fused ``transform`` (prefetch depth 0 and 3),
the streamed Featurize / StandardScaler / ValueIndexer fits equal to the
JAX package's streamed fits and to the in-memory ones (specs and levels
exactly, impute means within 1e-12, scaler statistics within 1e-6
relative), ``SummarizeData`` on a chunk stream (counts and moments
within 1e-6 relative of the JAX package's chunked summary, percentiles
within the sketch's rank certificate), the learner's fit of a
ChunkedTable bitwise the fit of the list of its chunks, and the port's
no-materialize audit (``testing/fusion_check.py``).
"""

import logging

import numpy as np
import pytest

from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.gbdt import booster as jbooster
from mmlspark_tpu.gbdt.binning import BinMapper as JBinMapper
from mmlspark_tpu.gbdt.booster import train as jtrain
from mmlspark_tpu.gbdt.sketch import QuantileSketch as JSketch
from mmlspark_tpu.io import ooc as jooc

import mmlspark_tpu_torch as mtt
from mmlspark_tpu_torch.core.sparse import CSRMatrix
from mmlspark_tpu_torch.gbdt import booster as tbooster
from mmlspark_tpu_torch.gbdt import native_bins
from mmlspark_tpu_torch.gbdt.binning import BinMapper as TBinMapper
from mmlspark_tpu_torch.gbdt.booster import train as ttrain
from mmlspark_tpu_torch.gbdt.sketch import QuantileSketch as TSketch
from mmlspark_tpu_torch.io import ooc as tooc

STRUCTURE = ("feature", "bin_threshold", "left", "right", "is_leaf")
SUMMARY = ("v", "lmin", "lmax", "rmin", "rmax")


def _assert_summary_equal(t, j):
    a, b = t.summary(), j.summary()
    for k in SUMMARY:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    assert a.w == b.w
    assert (t.count, t.dropped, t.exact) == (j.count, j.dropped, j.exact)
    assert t.eps() == j.eps()


def _stream(seed=0, n=60_000, heavy=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    if heavy:
        x[rng.random(n) < 0.4] = 0.0          # a heavy value, as CSR zeros
        x[::101] = np.nan
        x[::997] = np.inf
    return x


# ---------------------------------------------------------------------------
# QuantileSketch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["exact", "compacted", "heavy_nonfinite",
                                  "small_buffer"])
def test_sketch_matches_jax(case):
    x = _stream(seed=1, heavy=case == "heavy_nonfinite")
    # buffers below the stream's length, so that summaries compact
    kw = ({"b": 64, "buffer_rows": 4096} if case == "small_buffer"
          else {"buffer_rows": 16384})
    if case == "exact":
        x = np.round(x * 20) / 20            # ~160 distinct: no compaction
    t, j = TSketch(**kw), JSketch(**kw)
    for i in range(0, len(x), 7_000):
        t.update(x[i:i + 7_000])
        j.update(x[i:i + 7_000])
    _assert_summary_equal(t, j)
    assert t.exact == (case == "exact")
    for mb in (15, 63, 255):
        np.testing.assert_array_equal(t.cuts(mb), j.cuts(mb))
    for width in (128, 2048):
        np.testing.assert_array_equal(t.to_wire(width), j.to_wire(width))
        # wire round trips, each package reading the other's
        _assert_summary_equal(TSketch.from_wire(j.to_wire(width)),
                              JSketch.from_wire(t.to_wire(width)))


@pytest.mark.parametrize("order", ["ab", "ba"])
def test_sketch_merge_matches_jax(order):
    x, z = _stream(seed=2, n=50_000), _stream(seed=3, n=30_000) * 2 + 1
    ta, tb_ = TSketch(b=128).update(x), TSketch(b=128).update(z)
    ja, jb_ = JSketch(b=128).update(x), JSketch(b=128).update(z)
    if order == "ab":
        ta.merge(tb_)
        ja.merge(jb_)
        t, j = ta, ja
    else:
        tb_.merge(ta)
        jb_.merge(ja)
        t, j = tb_, jb_
    _assert_summary_equal(t, j)
    np.testing.assert_array_equal(t.cuts(63), j.cuts(63))
    assert t.count == 80_000


def test_sketch_rejects_a_narrow_width():
    with pytest.raises(ValueError, match="too small"):
        TSketch(b=4)


# ---------------------------------------------------------------------------
# BinMapper.fit_streaming
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rows", [3_000, 150_000])
def test_fit_streaming_matches_jax(dtype, rows):
    rng = np.random.default_rng(7)
    X = np.column_stack([rng.normal(size=rows), rng.lognormal(size=rows),
                         rng.integers(0, 5, size=rows)]).astype(dtype)
    X[::53, 0] = np.nan
    chunks = [X[i:i + 20_000] for i in range(0, rows, 20_000)]
    tm = TBinMapper.fit_streaming(iter(chunks), max_bin=127)
    jm = JBinMapper.fit_streaming(iter(chunks), max_bin=127)
    for a, b in zip(tm.upper_bounds, jm.upper_bounds):
        np.testing.assert_array_equal(a, b)
    assert tm.sketch_eps == jm.sketch_eps
    assert (tm.f32_cuts_exact, tm.f32_values_safe) == (
        jm.f32_cuts_exact, jm.f32_values_safe)
    assert tm.f32_cuts_exact == (dtype == np.float32)
    if rows == 3_000:
        # one exact summary: bitwise the all-rows dense fit
        assert tm.sketch_eps == 0.0
        exact = TBinMapper.fit(X, max_bin=127, sample_cnt=rows)
        for a, b in zip(tm.upper_bounds, exact.upper_bounds):
            np.testing.assert_array_equal(a, b)
    else:
        assert 0 < tm.sketch_eps < 0.01
    with pytest.raises(ValueError, match="empty chunk stream"):
        TBinMapper.fit_streaming(iter([]))
    with pytest.raises(ValueError, match="features; expected"):
        TBinMapper.fit_streaming([X[:10], X[:10, :2]])


def test_binmapper_json_with_sketch_eps_crosses_packages():
    X = np.random.default_rng(10).normal(size=(300_000, 2))
    tm = TBinMapper.fit_streaming([X[:150_000], X[150_000:]], max_bin=63)
    assert tm.sketch_eps > 0
    jm = JBinMapper.from_json(tm.to_json())
    back = TBinMapper.from_json(jm.to_json())
    assert back.sketch_eps == jm.sketch_eps == tm.sketch_eps
    for a, b, c in zip(tm.upper_bounds, jm.upper_bounds, back.upper_bounds):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert tm.to_json() == jm.to_json()


# ---------------------------------------------------------------------------
# ChunkedTable
# ---------------------------------------------------------------------------


def _table_cols(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    return {"features": rng.normal(size=(n, 4)).astype(np.float32),
            "label": (rng.random(n) < 0.5).astype(np.float64),
            "w": rng.random(n) + 0.5,
            "cat": [f"l{int(i)}" for i in rng.integers(0, 5, n)]}


def _assert_chunks_equal(tc, jc):
    tparts, jparts = list(tc.chunks()), list(jc.chunks())
    assert len(tparts) == len(jparts)
    for a, b in zip(tparts, jparts):
        assert a.column_names == b.column_names
        assert a.schema.to_json() == b.schema.to_json()
        for name in a.column_names:
            np.testing.assert_array_equal(np.asarray(a[name]),
                                          np.asarray(b[name]))


@pytest.mark.parametrize("source", ["from_table", "from_npy",
                                    "from_generator"])
def test_chunked_table_replays_like_jax(tmp_path, source):
    cols = _table_cols()
    if source == "from_table":
        tc = tooc.ChunkedTable.from_table(mtt.DataTable(cols), chunk_rows=700)
        jc = jooc.ChunkedTable.from_table(JTable(cols), chunk_rows=700)
    elif source == "from_npy":
        paths = {}
        for k in ("features", "label", "w"):
            paths[k] = str(tmp_path / f"{k}.npy")
            np.save(paths[k], cols[k])
        tc = tooc.ChunkedTable.from_npy(paths, chunk_rows=700)
        jc = jooc.ChunkedTable.from_npy(paths, chunk_rows=700)
    else:
        def factory(mod):
            def gen():
                for i in range(0, 3000, 900):
                    yield {k: v[i:i + 900] for k, v in cols.items()}
            return gen
        tc = tooc.ChunkedTable.from_generator(factory(tooc))
        jc = jooc.ChunkedTable.from_generator(factory(jooc))
    _assert_chunks_equal(tc, jc)
    _assert_chunks_equal(tc, jc)          # replayable
    assert tc.stats.snapshot()["rows"] == jc.stats.snapshot()["rows"]
    assert tc.stats.snapshot()["chunks"] == jc.stats.snapshot()["chunks"]
    assert tc.stats.peak_chunk_bytes == jc.stats.peak_chunk_bytes
    assert tc.stats.tracked_peak_bytes() == jc.stats.tracked_peak_bytes()
    # the port's from_npy reads its row count from the .npy headers; the
    # reference's knows it only after a counting pass
    assert tc.num_rows == (3000 if source == "from_npy" else jc.num_rows)
    assert tc.count_rows() == jc.count_rows() == 3000
    assert tc.peek().column_names == jc.peek().column_names
    assert tc.schema.to_json() == jc.schema.to_json()
    # (X, y, w) shards for train(): chunk-local densification
    for (xt, yt, wt), (xj, yj, wj) in zip(tc.as_xy(weight_col="w")(),
                                          jc.as_xy(weight_col="w")()):
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)
        np.testing.assert_array_equal(wt, wj)
    m = tc.map(lambda t: t.with_column("label", 1 - t["label"]))
    np.testing.assert_array_equal(m.materialize()["label"],
                                  1 - cols["label"])
    np.testing.assert_array_equal(tc.materialize()["features"],
                                  cols["features"])
    assert tooc.table_nbytes(mtt.DataTable(cols)) == jooc.table_nbytes(
        JTable(cols))


def test_chunked_table_tracks_a_sparse_column_and_decodes_ahead():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(500, 6)).astype(np.float32)
    X[rng.random(X.shape) < 0.7] = 0
    t = mtt.DataTable({"features": CSRMatrix.from_dense(X),
                       "label": np.zeros(500)})
    c = CSRMatrix.from_dense(X)
    assert tooc.table_nbytes(t) == (c.data.nbytes + c.indices.nbytes
                                    + c.indptr.nbytes + 500 * 8)
    tc = tooc.ChunkedTable.from_table(t, chunk_rows=100, prefetch_depth=3)
    got = list(tc.chunks())
    assert [len(p) for p in got] == [100] * 5
    assert tc.stats.depth == 3
    assert tc.stats.tracked_peak_bytes() == 5 * tc.stats.peak_chunk_bytes
    with pytest.raises(TypeError, match="ZERO-ARG factory"):
        tooc.ChunkedTable(iter([]))
    with pytest.raises(TypeError, match="column-dict"):
        list(tooc.ChunkedTable(lambda: iter([3])).chunks(prefetch_depth=0))


def test_arrow_ipc_round_trip_across_packages(tmp_path):
    pytest.importorskip("pyarrow")
    cols = _table_cols(n=1000)
    tpath, jpath = str(tmp_path / "t.arrow"), str(tmp_path / "j.arrow")
    assert tooc.write_arrow_ipc(mtt.DataTable(cols), tpath,
                                chunk_rows=300) == 1000
    assert jooc.write_arrow_ipc(JTable(cols), jpath, chunk_rows=300) == 1000
    for path in (tpath, jpath):
        _assert_chunks_equal(tooc.ChunkedTable.from_arrow_ipc(
                                 path, chunk_rows=250),
                             jooc.ChunkedTable.from_arrow_ipc(
                                 path, chunk_rows=250))
    back = tooc.ChunkedTable.from_arrow_ipc(jpath).materialize()
    np.testing.assert_array_equal(back["features"], cols["features"])
    assert list(back["cat"]) == cols["cat"]


# ---------------------------------------------------------------------------
# train() on ChunkedTables and shard streams
# ---------------------------------------------------------------------------


def _gbdt_data(n=4000, seed=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    logit = X[:, 0] + 0.7 * X[:, 1] * X[:, 2] + 0.5 * X[:, 3]
    y = (logit + rng.normal(scale=0.7, size=n) > 0).astype(np.float64)
    return X, y


_KW = {"objective": "binary", "num_iterations": 6, "num_leaves": 15,
       "max_bin": 63}


def _assert_forest_rule(tb, jb, weighted=False):
    """ROADMAP.md §3's rule: every tree's structure equal, tree 0's
    thresholds and (unweighted) row counts bitwise, leaf values to rtol
    1e-5. Weighted counts are float32 sums, which XLA orders its own
    way: rtol 1e-5 too."""
    assert tb.num_trees == jb.num_trees
    for k in STRUCTURE:
        np.testing.assert_array_equal(tb.trees[k], jb.trees[k], err_msg=k)
    np.testing.assert_array_equal(tb.trees["threshold"][0],
                                  jb.trees["threshold"][0])
    if weighted:
        np.testing.assert_allclose(tb.trees["count"], jb.trees["count"],
                                   rtol=1e-5)
    else:
        np.testing.assert_array_equal(tb.trees["count"][0],
                                      jb.trees["count"][0])
    np.testing.assert_allclose(tb.trees["value"], jb.trees["value"],
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("bin_fit", ["sample", "sketch"])
@pytest.mark.parametrize("source", ["chunked", "list", "factory",
                                    "weighted"])
def test_train_on_streams_matches_jax(bin_fit, source):
    X, y = _gbdt_data()
    w = np.random.default_rng(1).random(len(y)) + 0.5
    if source == "chunked":
        tX = tooc.ChunkedTable.from_table(
            mtt.DataTable({"features": X, "label": y}), chunk_rows=1000)
        jX = jooc.ChunkedTable.from_table(
            JTable({"features": X, "label": y}), chunk_rows=1000)
    else:
        shards = [(X[i:i + 1000], y[i:i + 1000]) + (
            (w[i:i + 1000],) if source == "weighted" else ())
            for i in range(0, len(y), 1000)]
        tX = jX = (lambda: iter(shards)) if source == "factory" else shards
    kw = {**_KW, "bin_fit": bin_fit}
    jb = jtrain({**kw, "hist_method": "scatter"}, jX)
    tb = ttrain(kw, tX, device="cpu")
    _assert_forest_rule(tb, jb, weighted=source == "weighted")
    assert tb.train_info["bin_path"] == "host"
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=1e-5,
                               atol=1e-6)


def test_reservoir_sample_and_stream_bins_match_jax():
    X, y = _gbdt_data(n=9000)
    shards = [(X[i:i + 2000], y[i:i + 2000]) for i in range(0, 9000, 2000)]
    np.testing.assert_array_equal(
        tbooster._reservoir_rows(iter(shards), 3000, 11),
        jbooster._reservoir_rows(iter(shards), 3000, 11))
    for bin_fit in ("sample", "sketch"):
        tm, tbins, ty, tw = tbooster._bin_stream(shards, 63, 3,
                                                 bin_fit=bin_fit)
        jm, jbins, jy, jw = jbooster._bin_stream(shards, 63, 3,
                                                 bin_fit=bin_fit)
        for a, b in zip(tm.upper_bounds, jm.upper_bounds):
            np.testing.assert_array_equal(a, b)
        assert tbins.dtype == np.uint8
        np.testing.assert_array_equal(tbins, jbins.T)
        np.testing.assert_array_equal(ty, jy)
        np.testing.assert_array_equal(tw, jw)


def test_one_shot_stream_warns_of_drift_like_jax():
    X, y = _gbdt_data(n=6000)
    order = np.argsort(X[:, 0])            # sorted shards: skewed order
    Xs, ys = X[order], y[order]

    def one_shot():
        return iter([(Xs[i:i + 1000], ys[i:i + 1000])
                     for i in range(0, 6000, 1000)])

    # both packages' logger roots stop propagating once configured, so
    # read each logger through a handler of its own
    seen = {"mmlspark_tpu_torch.gbdt": [], "mmlspark_tpu.gbdt": []}

    class Keep(logging.Handler):
        def emit(self, record):
            if "streaming binning drift" in record.getMessage():
                seen[record.name].append(record.getMessage())

    keep = Keep(logging.WARNING)
    loggers = [logging.getLogger(name) for name in seen]
    for lg in loggers:
        lg.addHandler(keep)
    try:
        tb = ttrain({**_KW, "num_iterations": 2}, one_shot(), device="cpu")
        jb = jtrain({**_KW, "num_iterations": 2, "hist_method": "scatter"},
                    one_shot())
    finally:
        for lg in loggers:
            lg.removeHandler(keep)
    port, ref = seen.values()
    assert len(port) == len(ref) == 1 and port == ref
    for k in STRUCTURE:
        np.testing.assert_array_equal(tb.trees[k], jb.trees[k])


def _ambiguous_inputs():
    X, y = _gbdt_data(n=300)
    shards = [(X[:150], y[:150]), (X[150:], y[150:])]
    t = {"features": X, "label": y}
    return {
        "iterator X with y": (lambda m: iter(shards), y, {}),
        "streaming with init_model": (lambda m: shards, None,
                                      {"init_model": "{}"}),
        "streaming with sample_weight": (lambda m: shards, None,
                                         {"sample_weight": y}),
        "dense X without y": (lambda m: X, None, {}),
        "CSR without y": (lambda m: m[0].from_dense(X), None, {}),
        "ChunkedTable with y": (
            lambda m: m[1].ChunkedTable.from_table(m[2](t)), y, {}),
    }


@pytest.mark.parametrize("case", sorted(_ambiguous_inputs()))
def test_ambiguous_input_raises_as_in_jax(case):
    from mmlspark_tpu.core.sparse import CSRMatrix as JCSR
    make, y, extra = _ambiguous_inputs()[case]
    with pytest.raises(ValueError) as je:
        jtrain(_KW, make((JCSR, jooc, JTable)), y, **extra)
    with pytest.raises(ValueError) as te:
        ttrain(_KW, make((CSRMatrix, tooc, mtt.DataTable)), y,
               device="cpu", **extra)
    assert str(te.value) == str(je.value)


def test_estimators_fit_a_chunked_table_like_jax():
    from mmlspark_tpu.gbdt.estimators import (
        TPUBoostClassifier as JClassifier, TPUBoostRegressor as JRegressor)
    X, y = _gbdt_data()
    kw = dict(numIterations=5, numLeaves=15, maxBin=63, binFit="sketch")
    tt = mtt.DataTable({"features": X, "label": y})
    jt = JTable({"features": X, "label": y})
    tm = mtt.TPUBoostClassifier(device="cpu", **kw).fit(
        tooc.ChunkedTable.from_table(tt, chunk_rows=1000))
    jm = JClassifier(histMethod="scatter", **kw).fit(
        jooc.ChunkedTable.from_table(jt, chunk_rows=1000))
    _assert_forest_rule(tm.get_booster(), jm.get_booster())
    np.testing.assert_array_equal(tm.transform(tt)["prediction"],
                                  jm.transform(jt)["prediction"])
    tr = mtt.TPUBoostRegressor(device="cpu", **kw).fit(
        tooc.ChunkedTable.from_table(tt, chunk_rows=1000))
    jr = JRegressor(histMethod="scatter", **kw).fit(
        jooc.ChunkedTable.from_table(jt, chunk_rows=1000))
    _assert_forest_rule(tr.get_booster(), jr.get_booster())
    with pytest.raises(ValueError, match="in-memory table"):
        mtt.TPUBoostRegressor(device="cpu", initModelString="{}").fit(
            tooc.ChunkedTable.from_table(tt, chunk_rows=1000))


# ---------------------------------------------------------------------------
# the host binning library (csrc/bins.cpp) against its plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("max_bin", [63, 255, 1023])
def test_host_binning_library_equals_numpy(dtype, max_bin):
    rng = np.random.default_rng(12)
    X = np.column_stack([rng.normal(size=20_000),
                         rng.exponential(size=20_000) * 1e3,
                         rng.integers(0, 7, size=20_000),
                         np.full(20_000, 2.0)]).astype(dtype)
    X[rng.random(20_000) < 0.03, 0] = np.nan
    X[5, 1], X[6, 1] = np.inf, -np.inf
    m = TBinMapper.fit(X, max_bin=max_bin)
    ref = m._numpy_bin_block(X, 0, 4)
    got = m.transform_fm(X, native=True)
    assert got.dtype == (np.uint8 if max_bin <= 255 else np.int32)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(m.transform_fm_range(X, 1, 3, native=True),
                                  ref[1:3])
    np.testing.assert_array_equal(m.transform(X, native=True), ref.T)
    assert native_bins.threads() >= 1
    if max_bin > 255:
        with pytest.raises(ValueError, match="at most 256 bins"):
            native_bins.apply_bins_t_u8(X, m.upper_bounds)


# ---------------------------------------------------------------------------
# TestChunkedPipelines: fused and streamed pipelines over a ChunkedTable
# ---------------------------------------------------------------------------


def _pipeline_cols(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.normal(size=n).astype(np.float32),
        "b": np.where(rng.random(n) < 0.2, np.nan, rng.normal(size=n)),
        "cat": [f"l{int(i)}" for i in rng.integers(0, 8, n)],
        "toks": [[f"w{int(x)}" for x in rng.integers(0, 30, 4)]
                 for _ in range(n)],
        "label": rng.integers(0, 2, n).astype(np.float64),
    }


def _fitted_pipeline(n=2048, seed=0):
    from mmlspark_tpu_torch.automl.featurize import Featurize
    from mmlspark_tpu_torch.models.linear import TPULogisticRegression
    from mmlspark_tpu_torch.stages.dataprep import StandardScaler
    t = mtt.DataTable(_pipeline_cols(n, seed))
    pm = mtt.Pipeline(stages=[
        Featurize(featureColumns=["a", "b", "cat", "toks"],
                  numberOfFeatures=16),
        StandardScaler(inputCol="features"),
        TPULogisticRegression(featuresCol="features", labelCol="label",
                              maxIter=5, device="cpu"),
    ]).fit(t)
    return t, pm


@pytest.mark.parametrize("depth", [0, 3])
def test_fused_chunked_bitwise_per_chunk(depth):
    t, pm = _fitted_pipeline()
    fused = pm.fused(device="cpu")
    raw = t.drop("label")
    full = fused.transform(raw)
    ct = tooc.ChunkedTable.from_table(raw, chunk_rows=256)
    parts = list(fused.transform_chunked(ct, prefetch_depth=depth))
    assert len(parts) == 8
    for col in ("prediction", "probability", "rawPrediction"):
        got = np.concatenate([np.asarray(p[col]) for p in parts])
        np.testing.assert_array_equal(got, np.asarray(full[col]))
    np.testing.assert_array_equal(
        parts[0]["probability"],
        fused.transform(raw.slice(0, 256))["probability"])
    from mmlspark_tpu_torch.core.metrics import ooc_histograms
    assert ooc_histograms()["dispatch"].summary()["count"] > 0


def test_fused_chunked_zero_recompiles_on_replay():
    t, pm = _fitted_pipeline()
    fused = pm.fused(device="cpu")
    out = fused.transform_chunked(
        tooc.ChunkedTable.from_table(t.drop("label"), chunk_rows=512))
    for _ in out:
        pass
    misses = fused.jit_cache_misses
    assert misses == 1
    for _ in out:      # replay: same shapes, no first runs
        pass
    assert fused.jit_cache_misses == misses


def test_pipeline_model_chunked_transform():
    t, pm = _fitted_pipeline()
    full = pm.transform(t.drop("label"))
    got = pm.transform(tooc.ChunkedTable.from_table(
        t.drop("label"), chunk_rows=777)).materialize()
    np.testing.assert_array_equal(got["prediction"], full["prediction"])
    # the host head is a float64 BLAS product: a chunk's row count may
    # change its summation order in the last bit
    np.testing.assert_allclose(got["probability"], full["probability"],
                               rtol=1e-12, atol=1e-15)


def test_featurize_streaming_fit_matches_jax_and_in_memory():
    from mmlspark_tpu.automl.featurize import Featurize as JFeaturize
    from mmlspark_tpu_torch.automl.featurize import Featurize
    cols = _pipeline_cols(seed=3)
    kw = dict(featureColumns=["a", "b", "cat", "toks"], numberOfFeatures=16)
    pt, jt = mtt.DataTable(cols), JTable(cols)
    streamed = Featurize(**kw).fit(
        tooc.ChunkedTable.from_table(pt, chunk_rows=600))
    jstreamed = JFeaturize(**kw).fit(
        jooc.ChunkedTable.from_table(jt, chunk_rows=600))
    assert streamed.get("specs") == jstreamed.get("specs")
    mem = Featurize(**kw).fit(pt)
    for e, s in zip(mem.get("specs"), streamed.get("specs")):
        assert e["kind"] == s["kind"]
        assert e.get("levels") == s.get("levels")
        if "fill" in e:
            assert abs(e["fill"] - s["fill"]) < 1e-12
    out = streamed.transform(
        tooc.ChunkedTable.from_table(pt, chunk_rows=600)).materialize()
    np.testing.assert_array_equal(out["features"],
                                  mem.transform(pt)["features"])


def test_scaler_and_indexer_streaming_fits_match_jax():
    from mmlspark_tpu.automl.featurize import Featurize as JFeaturize
    from mmlspark_tpu.stages import dataprep as JD
    from mmlspark_tpu_torch.automl.featurize import Featurize
    from mmlspark_tpu_torch.stages import dataprep as PD
    cols = _pipeline_cols(seed=4)
    pt, jt = mtt.DataTable(cols), JTable(cols)
    feat = Featurize(featureColumns=["a", "b", "cat"]).fit(pt).transform(pt)
    jfeat = JFeaturize(featureColumns=["a", "b", "cat"]).fit(jt).transform(jt)
    sc = PD.StandardScaler(inputCol="features")
    ms = sc.fit(tooc.ChunkedTable.from_table(feat, chunk_rows=500))
    me = sc.fit(feat)
    js = JD.StandardScaler(inputCol="features").fit(
        jooc.ChunkedTable.from_table(jfeat, chunk_rows=500))
    for k in ("mu", "sd"):
        np.testing.assert_allclose(ms.get(k), me.get(k), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(ms.get(k), js.get(k))
    vi = PD.ValueIndexer(inputCol="cat", outputCol="ix")
    assert vi.fit(tooc.ChunkedTable.from_table(pt, chunk_rows=300)).get(
        "levels") == vi.fit(pt).get("levels") == JD.ValueIndexer(
        inputCol="cat", outputCol="ix").fit(jooc.ChunkedTable.from_table(
            jt, chunk_rows=300)).get("levels")


def test_learner_fit_chunked_equals_shard_list():
    """A ChunkedTable IS a replayable shard stream for TPULearner: the
    same batches in the same order as the list of its chunks, so the
    same losses bit for bit; no counting pass when num_rows is known."""
    rng = np.random.default_rng(5)
    n = 256
    t = mtt.DataTable({
        "features": rng.normal(size=(n, 8)).astype(np.float32),
        "label": rng.integers(0, 2, n).astype(np.int64)})
    decoded = []
    ct = tooc.ChunkedTable.from_generator(
        lambda: (decoded.append(i) or t.slice(i, i + 64)
                 for i in range(0, n, 64)), num_rows=n, prefetch_depth=2)

    def learner():
        return mtt.TPULearner(
            networkSpec={"type": "mlp", "features": [8], "num_classes": 2,
                         "in_features": 8},
            batchSize=64, epochs=2, logEvery=1, device="cpu",
            computeDtype="float32")

    streamed, listed = learner(), learner()
    model = streamed.fit(ct)
    listed.fit([t.slice(i, i + 64) for i in range(0, n, 64)])
    assert [h["loss"] for h in streamed.history] == \
        [h["loss"] for h in listed.history]
    # one peek of the first chunk, then one pass per epoch
    assert len(decoded) == 1 + 2 * 4
    assert len(np.asarray(model.transform(t)["scores"])) == n


def test_learner_fit_from_npy_reads_rows_from_headers(tmp_path):
    """``from_npy`` knows its row count from the ``.npy`` headers, so a
    learner's fit decodes the stream once per epoch and never counts."""
    rng = np.random.default_rng(6)
    n = 192
    paths = {"features": str(tmp_path / "features.npy"),
             "label": str(tmp_path / "label.npy")}
    np.save(paths["features"], rng.normal(size=(n, 8)).astype(np.float32))
    np.save(paths["label"], rng.integers(0, 2, n).astype(np.int64))
    ct = tooc.ChunkedTable.from_npy(paths, chunk_rows=64)
    assert ct.num_rows == n
    assert ct.stats.snapshot()["chunks"] == 0
    mtt.TPULearner(
        networkSpec={"type": "mlp", "features": [8], "num_classes": 2,
                     "in_features": 8},
        batchSize=64, epochs=2, logEvery=1, device="cpu",
        computeDtype="float32").fit(ct)
    assert ct.stats.snapshot()["chunks"] == 2 * 3


def _cdf(xs, v):
    return np.searchsorted(xs, v, side="right") / len(xs)


def test_summarize_chunked_matches_jax_and_exact():
    from mmlspark_tpu.stages.dataprep import SummarizeData as JSummarize
    from mmlspark_tpu_torch.stages.dataprep import SummarizeData
    rng = np.random.default_rng(7)
    n = 50_000
    cols = {"x": rng.lognormal(size=n),
            "s": [f"v{i % 3}" for i in range(n)]}
    pt, jt = mtt.DataTable(cols), JTable(cols)
    exact = SummarizeData().transform(pt)
    chunked = SummarizeData().transform(
        tooc.ChunkedTable.from_table(pt, chunk_rows=8_000))
    jchunked = JSummarize().transform(
        jooc.ChunkedTable.from_table(jt, chunk_rows=8_000))
    ix = list(exact["Feature"]).index("x")
    for k in ("Count", "Mean", "Min", "Max", "Sample_Variance",
              "Sample_Skewness", "Sample_Kurtosis",
              "Unique_Value_Count", "Missing_Value_Count"):
        a, b = float(exact[k][ix]), float(chunked[k][ix])
        assert abs(a - b) <= 1e-6 * (1.0 + abs(a)), (k, a, b)
        c = float(jchunked[k][ix])
        assert abs(c - b) <= 1e-6 * (1.0 + abs(c)), (k, c, b)
    xs = np.sort(np.asarray(cols["x"]))
    for label, q in (("Median", 0.5), ("P25", 0.25), ("P75", 0.75),
                     ("P5", 0.05), ("P95", 0.95)):
        v = float(chunked[label][ix])
        assert abs(_cdf(xs, v) - q) < 0.005, (label, v)
        assert v == float(jchunked[label][ix])


def test_summarize_chunked_nan_unique_count_matches_exact():
    from mmlspark_tpu_torch.stages.dataprep import SummarizeData
    t = mtt.DataTable({"x": np.asarray(
        [1.0, np.nan, 2.0, np.nan, 3.0, np.nan, 4.0, np.nan])})
    sd = SummarizeData()
    exact = float(sd.transform(t)["Unique_Value_Count"][0])
    chunked = float(sd.transform(tooc.ChunkedTable.from_table(
        t, chunk_rows=2))["Unique_Value_Count"][0])
    assert chunked == exact == 5.0


def test_transform_chunked_tracks_prefetch_depth():
    t, pm = _fitted_pipeline(n=1024, seed=9)
    ct = tooc.ChunkedTable.from_table(t.drop("label"), chunk_rows=128,
                                      prefetch_depth=3)
    for _ in pm.fused(device="cpu").transform_chunked(ct):
        pass
    assert ct.stats.depth == 3
    s = ct.stats.snapshot()
    assert s["tracked_peak_bytes"] == 5 * s["peak_chunk_bytes"]


@pytest.mark.parametrize("col", [
    ["a", "bcd", "", "ééé"],
    [["x", "yy"], [], ["z"], ("t", "uu")],
    ["a", None, "bcd", "e"],
    [["x", 3], ["q"], None, []],
    [b"ab", "c", np.arange(3.0), 7],
], ids=["strings", "token_lists", "strings_none", "mixed_lists",
        "mixed"])
def test_table_nbytes_matches_jax(col):
    """The port's C-level fast path over string and token columns gives
    the JAX package's per-value estimate exactly."""
    cols = {"c": col, "x": np.arange(len(col), dtype=np.float32)}
    assert tooc.table_nbytes(mtt.DataTable(cols)) == \
        jooc.table_nbytes(JTable(cols))


# ---------------------------------------------------------------------------
# TestOOCChecker: the port's no-materialize audit
# ---------------------------------------------------------------------------


def test_shipped_streamed_paths_are_clean():
    from mmlspark_tpu_torch.testing import fusion_check as CHK
    assert CHK.check_ooc_ingest() == []


def test_checker_catches_materialization():
    from mmlspark_tpu_torch.testing import fusion_check as CHK
    bad = ("def hot(chunked):\n"
           "    rows = list(chunked.chunks())\n"
           "    big = np.concatenate([c['x'] for c in rows])\n"
           "    return chunked.materialize()\n")
    kinds = "\n".join(CHK.check_ooc_source("bad", bad, 1,
                                           bad.splitlines()))
    assert "list()" in kinds
    assert "np.concatenate" in kinds
    assert ".materialize()" in kinds


def test_checker_honors_acknowledgment():
    from mmlspark_tpu_torch.testing import fusion_check as CHK
    ok = ("def hot(chunked):\n"
          "    return chunked.materialize()  # ooc:materialize-ok\n")
    assert CHK.check_ooc_source("ok", ok, 1, ok.splitlines()) == []
