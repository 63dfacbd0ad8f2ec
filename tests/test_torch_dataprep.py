"""PyTorch port: the utility stages (``stages/basic.py``), the data-prep
stages (``stages/dataprep.py``) and the ``DataTable`` methods they call,
against the JAX package, on the CPU.

Each scenario of ``tests/test_stages_util.py`` runs through both
packages on the same inputs (a scenario takes the package's namespace
and returns its result). Tolerance, stated: bitwise (host numpy in both
packages: level order, imputed values, casts, ``SummarizeData``'s
moments and quantiles, the seeded samples, ``StandardScaler``'s f32
statistics). ``Timer``'s ``traceDir`` writes a ``torch.profiler`` trace
where the JAX package writes a ``jax.profiler`` xplane: the port's test
checks its own trace file. A ``ChunkedTable`` given to the streamed
fits raises (ROADMAP.md, 'Out-of-core ingest').
"""

import json
import os
import types

import numpy as np
import pytest

from mmlspark_tpu.core import table as JT
from mmlspark_tpu.core.stage import Pipeline as JPipeline
from mmlspark_tpu.core.stage import load_stage as jload_stage
from mmlspark_tpu.stages import basic as JB, dataprep as JD, text as JX

from mmlspark_tpu_torch.core import table as PT
from mmlspark_tpu_torch.core.stage import Pipeline as PPipeline
from mmlspark_tpu_torch.core.stage import load_stage as pload_stage
from mmlspark_tpu_torch.io.ooc import ChunkedTable
from mmlspark_tpu_torch.stages import basic as PB, dataprep as PD, text as PX


def _ns(table_mod, basic, dataprep, text, pipeline):
    ns = types.SimpleNamespace(DataTable=table_mod.DataTable,
                               Pipeline=pipeline)
    for mod in (basic, dataprep, text):
        for k, v in vars(mod).items():
            if isinstance(v, type) or callable(v):
                setattr(ns, k, v)
    return ns


J = _ns(JT, JB, JD, JX, JPipeline)
P = _ns(PT, PB, PD, PX, PPipeline)


def _equal(a, b, where):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, float) and isinstance(b, float) and np.isnan(a):
        assert np.isnan(b), where
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    else:
        assert a == b and type(a) == type(b), (where, a, b)


def assert_same(p, j, where="result"):
    """Bitwise equality of two results: tables column by column (with
    their schemas), else values."""
    if hasattr(j, "column_names"):
        assert p.column_names == j.column_names, where
        assert p.schema.to_json() == j.schema.to_json(), where
        assert p.num_shards == j.num_shards, where
        for c in j.column_names:
            _equal(p[c], j[c], f"{where}:{c}")
    else:
        _equal(p, j, where)


def basic_table(ns):
    return ns.DataTable({"a": [1.0, 2.0, np.nan, 4.0],
                         "b": ["x", "y", "x", "z"],
                         "lists": [[1, 2], [3], [4, 5, 6], [7]]})


def numeric_table(ns, n=300, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n) * 3 + 1
    x[rng.random(n) < 0.05] = np.nan
    x[rng.random(n) < 0.02] = np.inf
    return ns.DataTable({
        "x": x, "i": rng.integers(-5, 5, n).astype(np.int64),
        "s": [["p", "q", None, "r"][k] for k in rng.integers(0, 4, n)],
        "v": rng.normal(size=(n, 3)).astype(np.float32)})


# ---------------------------------------------------------------------------
# scenarios: ns -> result, run once per package
# ---------------------------------------------------------------------------

SCENARIOS = {
    "drop": lambda ns: ns.DropColumns(cols=["lists"]).transform(
        basic_table(ns)),
    "select": lambda ns: ns.SelectColumns(cols=["b"]).transform(
        basic_table(ns)),
    "rename": lambda ns: ns.RenameColumn(
        inputCol="a", outputCol="alpha").transform(basic_table(ns)),
    "cacher": lambda ns: ns.Cacher().transform(basic_table(ns)),
    "repartition": lambda ns: [
        len(s) for s in ns.Repartition(n=3).transform(
            numeric_table(ns)).shards()],
    "explode": lambda ns: ns.Explode(
        inputCol="lists", outputCol="item").transform(basic_table(ns)),
    "explode_in_place": lambda ns: ns.Explode(
        inputCol="lists", outputCol="lists").transform(basic_table(ns)),
    "explode_empty": lambda ns: ns.Explode(
        inputCol="lists", outputCol="item").transform(
        ns.DataTable({"lists": [[], []], "k": [1.0, 2.0]})),
    "lambda": lambda ns: ns.Lambda.apply(lambda t: t.filter(
        np.asarray([True, False, True, False]))).transform(basic_table(ns)),
    "udf_single": lambda ns: ns.UDFTransformer(
        inputCol="b", outputCol="b_up", udf=str.upper).transform(
        basic_table(ns)),
    "udf_multi": lambda ns: ns.UDFTransformer(
        inputCols=["a", "b"], outputCol="joined",
        udf=lambda a, b: f"{b}{a}").transform(basic_table(ns)),
    "class_balancer": lambda ns: ns.ClassBalancer(inputCol="b").fit(
        basic_table(ns)).transform(basic_table(ns)),
    "class_balancer_numeric": lambda ns: ns.ClassBalancer(
        inputCol="i", outputCol="w").fit(numeric_table(ns)).transform(
        numeric_table(ns, seed=1)),
    "text_preprocessor": lambda ns: ns.TextPreprocessor(
        inputCol="s", outputCol="s", map={"ab": "1", "abc": "2"},
        normFunc="lower").transform(ns.DataTable({"s": ["ABCd", "ab",
                                                         None]})),
    "timer_transformer": lambda ns: ns.Timer(
        stage=ns.DropColumns(cols=["lists"])).transform(basic_table(ns)),
    "timer_estimator": lambda ns: ns.Timer(
        stage=ns.ClassBalancer(inputCol="b")).fit(basic_table(ns))
    .transform(basic_table(ns)),
    "timer_in_pipeline": lambda ns: ns.Pipeline([ns.Timer(
        stage=ns.ValueIndexer(inputCol="b", outputCol="bi"))]).fit(
        basic_table(ns)).transform(ns.DataTable({"b": ["z", "x"]})),
    "value_indexer": lambda ns: ns.ValueIndexer(
        inputCol="b", outputCol="b_idx").fit(basic_table(ns)).transform(
        basic_table(ns)),
    "value_indexer_nulls_unseen": lambda ns: ns.ValueIndexer(
        inputCol="s", outputCol="si").fit(numeric_table(ns)).transform(
        ns.DataTable({"s": ["q", None, "zz", "p"]})),
    "value_indexer_numeric": lambda ns: ns.ValueIndexer(
        inputCol="i", outputCol="ii").fit(numeric_table(ns)).transform(
        numeric_table(ns, seed=2)),
    "unindex": lambda ns: (lambda m: m.unindex(
        m.transform(basic_table(ns)), "b_idx", "b_back"))(
        ns.ValueIndexer(inputCol="b", outputCol="b_idx").fit(
            basic_table(ns))),
    "unindex_codes": lambda ns: ns.unindex_codes(
        np.asarray([0.0, 2.0, -1.0, 7.0, 1.0]), ["x", "y", "z"]),
    "clean_mean": lambda ns: ns.CleanMissingData(
        inputCols=["a"], outputCols=["a"], cleaningMode="Mean").fit(
        basic_table(ns)).transform(basic_table(ns)),
    "clean_median": lambda ns: ns.CleanMissingData(
        inputCols=["x"], outputCols=["x"], cleaningMode="Median").fit(
        numeric_table(ns)).transform(numeric_table(ns)),
    "clean_custom": lambda ns: ns.CleanMissingData(
        inputCols=["a"], outputCols=["a_c"], cleaningMode="Custom",
        customValue=-1.0).fit(basic_table(ns)).transform(basic_table(ns)),
    "convert_integer": lambda ns: ns.DataConversion(
        cols=["x"], convertTo="integer").transform(
        ns.DataTable({"x": [1.5, 2.5, -3.7]})),
    "convert_casts": lambda ns: [ns.DataConversion(
        cols=["i"], convertTo=to).transform(numeric_table(ns))
        for to in ("boolean", "byte", "short", "long", "float", "double",
                   "string")],
    "convert_categorical": lambda ns: ns.DataConversion(
        cols=["x"], convertTo="toCategorical").transform(
        ns.DataTable({"x": ["b", "a", "b"]})),
    "convert_clear_categorical": lambda ns: ns.DataConversion(
        cols=["x"], convertTo="clearCategorical").transform(
        ns.DataConversion(cols=["x"], convertTo="toCategorical").transform(
            ns.DataTable({"x": ["b", "a", "b"]}))),
    "convert_date": lambda ns: ns.DataConversion(
        cols=["d"], convertTo="date").transform(
        ns.DataTable({"d": ["2026-07-29 10:00:00", None]})),
    "summarize": lambda ns: ns.SummarizeData().transform(basic_table(ns)),
    "summarize_numeric": lambda ns: ns.SummarizeData().transform(
        numeric_table(ns).drop("v")),
    "summarize_subset": lambda ns: ns.SummarizeData(
        percentiles=False, sample=False).transform(basic_table(ns)),
    "sample_head": lambda ns: ns.PartitionSample(
        mode="Head", count=2).transform(basic_table(ns)),
    "sample_random": lambda ns: ns.PartitionSample(
        mode="RandomSample", percent=0.3, rs_seed=1).transform(
        ns.DataTable({"x": np.arange(1000).astype(float)})),
    "sample_assign": lambda ns: ns.PartitionSample(
        mode="AssignToPartition", numParts=3, rs_seed=4).transform(
        numeric_table(ns)),
    "ensemble_scalar": lambda ns: ns.EnsembleByKey(
        keys=["k"], cols=["v"]).transform(
        ns.DataTable({"k": ["a", "a", "b"], "v": [1.0, 3.0, 5.0]})),
    "ensemble_vector": lambda ns: ns.EnsembleByKey(
        keys=["k"], cols=["v"], collapseGroup=False).transform(
        ns.DataTable({"k": ["a", "a", "b"],
                      "v": np.asarray([[1.0, 2.0], [3.0, 4.0],
                                       [5.0, 6.0]])})),
    "multi_column_transformer": lambda ns: ns.MultiColumnAdapter(
        baseStage=ns.Tokenizer(), inputCols=["s1", "s2"],
        outputCols=["t1", "t2"]).transform(
        ns.DataTable({"s1": ["a b", "c d"], "s2": ["e f", "g h"]})),
    "multi_column_estimator": lambda ns: ns.MultiColumnAdapter(
        baseStage=ns.ValueIndexer(), inputCols=["c"],
        outputCols=["ci"]).fit(ns.DataTable({"c": ["a", "b", "c", "a"]}))
    .transform(ns.DataTable({"c": ["c", "c", "b", "x"]})),
    "assembler": lambda ns: ns.FastVectorAssembler(
        inputCols=["x", "v", "i"]).transform(numeric_table(ns)),
    "scaler_vector": lambda ns: ns.StandardScaler(
        inputCol="v", outputCol="vs").fit(numeric_table(ns)).transform(
        numeric_table(ns, seed=3)),
    "scaler_in_place": lambda ns: ns.StandardScaler(inputCol="v").fit(
        numeric_table(ns)).transform(numeric_table(ns)),
    "scaler_scalar_no_mean": lambda ns: ns.StandardScaler(
        inputCol="i", outputCol="is", withMean=False).fit(
        numeric_table(ns)).transform(numeric_table(ns)),
    "scaler_constant_feature": lambda ns: ns.StandardScaler(
        inputCol="v", outputCol="vs", withStd=True).fit(ns.DataTable(
            {"v": np.ones((5, 2), np.float32)})).transform(ns.DataTable(
                {"v": np.ones((5, 2), np.float32)})),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    fn = SCENARIOS[name]
    p, j = fn(P), fn(J)
    if isinstance(j, list) and j and hasattr(j[0], "column_names"):
        for i, (pp, jj) in enumerate(zip(p, j)):
            assert_same(pp, jj, f"{name}[{i}]")
    else:
        assert_same(p, j, name)


# ---------------------------------------------------------------------------
# the reference's expectations, on the port alone
# ---------------------------------------------------------------------------

def test_reference_expectations_hold_in_the_port():
    t = basic_table(P)
    assert SCENARIOS["drop"](P).column_names == ["a", "b"]
    assert len(SCENARIOS["explode"](P)) == 7
    np.testing.assert_allclose(SCENARIOS["class_balancer"](P)["weight"],
                               [1.0, 2.0, 1.0, 2.0])
    assert list(SCENARIOS["text_preprocessor"](P)["s"]) == ["2d", "1", None]
    np.testing.assert_allclose(SCENARIOS["timer_in_pipeline"](P)["bi"],
                               [2.0, 0.0])
    out = SCENARIOS["value_indexer"](P)
    assert out.schema["b_idx"].meta["levels"] == ["x", "y", "z"]
    np.testing.assert_allclose(out["b_idx"], [0, 1, 0, 2])
    np.testing.assert_allclose(SCENARIOS["multi_column_estimator"](P)["ci"],
                               [2, 2, 1, -1])
    assert SCENARIOS["clean_median"](P).row(0)["x"] == \
        SCENARIOS["clean_median"](J).row(0)["x"]
    s = SCENARIOS["summarize"](P)
    assert list(s["Feature"]) == ["a", "b", "lists"]
    assert s.to_rows()[0]["Missing_Value_Count"] == 1.0
    assert 200 < len(SCENARIOS["sample_random"](P)) < 400
    assert len(P.Repartition(n=2).transform(t).shards()) == 2


def test_multi_column_adapter_estimator_transform_raises():
    with pytest.raises(TypeError, match="fit"):
        P.MultiColumnAdapter(baseStage=P.ValueIndexer(), inputCols=["c"],
                             outputCols=["ci"]).transform(
            P.DataTable({"c": ["a"]}))


def test_assembler_requires_input_cols():
    with pytest.raises(ValueError, match="inputCols"):
        P.FastVectorAssembler().transform(P.DataTable({"a": [1.0]}))


def test_scaler_output_follows_input_until_set():
    s = P.StandardScaler(inputCol="v")
    assert s.get("outputCol") == "v"
    s.set("inputCol", "w")
    assert s.get("outputCol") == "w"
    s.set("outputCol", "out").set("inputCol", "z")
    assert s.get("outputCol") == "out"


def test_streaming_moments_match_jax():
    """``_StreamingMoments``, the chunked summary's accumulator: the same
    merges give bitwise the same moments."""
    rng = np.random.default_rng(5)
    chunks = [rng.normal(size=n) * 2 + 1 for n in (7, 100, 1, 53)]
    pm, jm = P._StreamingMoments(), J._StreamingMoments()
    for c in chunks:
        pm.update(c)
        jm.update(c)
    for k in ("n", "min", "max", "mean", "variance", "std", "skewness",
              "kurtosis"):
        assert getattr(pm, k) == getattr(jm, k), k
    x = np.concatenate(chunks)
    np.testing.assert_allclose(pm.variance, x.var(ddof=1), rtol=1e-12)


@pytest.mark.parametrize("fit", [
    lambda t: P.ValueIndexer(inputCol="b", outputCol="o").fit(t),
    lambda t: P.StandardScaler(inputCol="a").fit(t),
    lambda t: P.SummarizeData().transform(t),
    lambda t: P.StandardScalerModel(mu=np.zeros(1, np.float32),
                                    sd=np.ones(1, np.float32),
                                    inputCol="a").transform(t),
], ids=["value_indexer", "scaler", "summarize", "scaler_model"])
def test_chunked_tables_raise_naming_the_roadmap_item(fit):
    t = P.DataTable({"a": np.arange(10.0), "b": ["x"] * 10})
    with pytest.raises(NotImplementedError, match="Out-of-core ingest"):
        fit(ChunkedTable.from_table(t, chunk_rows=4))


def test_timer_writes_a_torch_profiler_trace(tmp_path):
    """The reference's Timer writes a jax.profiler xplane; the port's
    writes a torch.profiler chrome trace of the wrapped stage."""
    import torch

    class _Work(P.DropColumns):
        def transform(self, table):
            torch.ones(64).mul_(2).sum()
            return super().transform(table)

    trace_dir = str(tmp_path / "trace")
    out = P.Timer(stage=_Work(cols=["lists"]), traceDir=trace_dir
                  ).transform(basic_table(P))
    assert out.column_names == ["a", "b"]
    files = os.listdir(trace_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mul" in e.get("name", "") for e in events)


def test_checkpoint_data_writes_a_table_both_packages_load(tmp_path):
    stage = P.CheckpointData(diskIncluded=True, checkpointDir=str(tmp_path))
    out = stage.transform(numeric_table(P))
    assert len(out) == 300
    (name,) = [p for p in os.listdir(tmp_path) if p.startswith("checkpoint_")]
    assert_same(J.DataTable.load(str(tmp_path / name)), numeric_table(J))
    assert P.CheckpointData(removeCheckpoint=True).transform(out) is out


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("stage", ["scaler", "value_indexer", "clean"])
def test_fitted_models_cross_packages(tmp_path, direction, stage):
    fit = {"scaler": lambda ns: ns.StandardScaler(
               inputCol="v", outputCol="vs").fit(numeric_table(ns)),
           "value_indexer": lambda ns: ns.ValueIndexer(
               inputCol="s", outputCol="si").fit(numeric_table(ns)),
           "clean": lambda ns: ns.CleanMissingData(
               inputCols=["x"], outputCols=["xc"]).fit(numeric_table(ns))}
    src, dst, load = ((J, P, pload_stage) if direction == "jax_to_port"
                      else (P, J, jload_stage))
    path = str(tmp_path / stage)
    fit[stage](src).save(path)
    loaded = load(path)
    assert_same(loaded.transform(numeric_table(dst, seed=9)),
                fit[stage](dst).transform(numeric_table(dst, seed=9)))


def test_table_methods_match_jax():
    """The DataTable methods the stages call: seeded shuffle and sample
    draw the JAX package's rows."""
    pt, jt = numeric_table(P), numeric_table(J)
    for f in (lambda t: t.shuffle(3), lambda t: t.sample(0.4, seed=2),
              lambda t: t.sort_by("i"),
              lambda t: t.sort_by("i", ascending=False),
              lambda t: t.rename({"x": "xx"}), lambda t: t.repartition(4),
              lambda t: t.with_field_meta("x", role="f"),
              lambda t: t.cache()):
        assert_same(f(pt), f(jt))
    for a, b in zip(pt.shards(4), jt.shards(4)):
        assert_same(a, b)
    assert pt.head(2)[1]["i"] == jt.head(2)[1]["i"]
    assert pt.distinct_values("s") == jt.distinct_values("s")
    assert [float(v) for v in pt.distinct_values("i")] == \
        [float(v) for v in jt.distinct_values("i")]
    rows = [{"x": 1.0, "i": np.int64(2), "s": "p",
             "v": np.zeros(3, np.float32)}]
    assert_same(pt.append_rows(rows), jt.append_rows(rows))
    assert_same(pt.map_rows(lambda r: {"y": r["x"] * 2}),
                jt.map_rows(lambda r: {"y": r["x"] * 2}))
