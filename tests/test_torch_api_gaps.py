"""PyTorch port: public calls of the reference that modules counted as
ported lacked, against the JAX package, on the CPU.

- ``PipelineStage.is_defined`` / ``clear`` (``clear`` bumps the param
  epoch that keys the fusion planner's plans and cached consts);
- ``DataTable.from_pandas`` / ``to_pandas`` and the fluent
  ``ml_transform`` / ``ml_fit`` (the cases of ``tests/test_table.py``);
- ``BinMapper.f32_safe`` / ``bin_threshold_value`` (bitwise to the
  reference on the same fitted mapper);
- ``QuantileSketch.min`` / ``max`` (equal to the reference's).
"""

import numpy as np
import pytest

from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.gbdt.binning import BinMapper as JBinMapper
from mmlspark_tpu.gbdt.sketch import QuantileSketch as JSketch
from mmlspark_tpu.stages import basic as JB
from mmlspark_tpu.stages import dataprep as JD

from mmlspark_tpu_torch.core import fusion as FZ
from mmlspark_tpu_torch.core.stage import PipelineModel
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.gbdt.binning import BinMapper
from mmlspark_tpu_torch.gbdt.sketch import QuantileSketch
from mmlspark_tpu_torch.stages import basic as PB
from mmlspark_tpu_torch.stages import dataprep as PD


def _basic(Table):
    return Table({
        "numbers": np.array([0, 1, 2, 3], dtype=np.int64),
        "words": ["guitars", "drums", "bass", "keys"],
        "more": ["apples", "oranges", "bananas", "grapes"],
    })


# ---------------------------------------------------------------------------
# PipelineStage.is_defined / clear
# ---------------------------------------------------------------------------


def _stage_class(stage_mod, params_mod):
    class Probe(stage_mod.Transformer):
        required = params_mod.IntParam("a param without a default")
        optional = params_mod.IntParam("a param with one", default=3)

        def transform(self, table):
            return table
    return Probe


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_is_defined_and_clear(pkg):
    if pkg == "torch":
        from mmlspark_tpu_torch.core import params, stage
    else:
        from mmlspark_tpu.core import params, stage
    st = _stage_class(stage, params)(required=1)
    assert st.is_defined("required") and st.is_set("required")
    assert st.is_defined("optional") and not st.is_set("optional")
    epoch = getattr(st, "_param_epoch", 0)
    assert st.clear("required") is st
    assert not st.is_set("required") and not st.is_defined("required")
    assert st._param_epoch == epoch + 1
    st.clear(type(st).optional)                # never set: still bumps
    assert st._param_epoch == epoch + 2
    assert st.get("optional") == 3


def test_is_defined_matches_jax_over_stage_params():
    for name in ("StandardScaler", "ValueIndexer", "CleanMissingData"):
        port, ref = getattr(PD, name)(), getattr(JD, name)()
        for p in type(ref).params():
            assert port.is_defined(p.name) == ref.is_defined(p.name), \
                (name, p.name)


def test_clear_rekeys_the_fused_plan_and_consts():
    x = np.random.default_rng(0).normal(size=(64, 3))
    t = DataTable({"features": x})
    model = PD.StandardScaler(inputCol="features", outputCol="scaled"
                              ).fit(t)
    fused = PipelineModel(stages=[model]).fused(device="cpu")
    out1 = fused.transform(t)
    plan = fused.plan_for(t.schema)
    e0 = FZ.stage_epoch(model)
    key0 = fused._plan_key(t.schema, None)
    model.clear("outputCol")         # back to its default, "features"
    assert FZ.stage_epoch(model) == e0 + 1
    assert fused._plan_key(t.schema, None) != key0
    assert fused.plan_for(t.schema) is not plan
    out2 = fused.transform(t)
    assert "scaled" in out1.column_names and "scaled" not in \
        out2.column_names
    np.testing.assert_array_equal(np.asarray(out2["features"]),
                                  np.asarray(out1["scaled"]))


# ---------------------------------------------------------------------------
# DataTable: pandas and the fluent sugar (tests/test_table.py)
# ---------------------------------------------------------------------------


def test_pandas_roundtrip_matches_jax():
    pytest.importorskip("pandas")
    t, jt = _basic(DataTable), _basic(JTable)
    df, jdf = t.to_pandas(), jt.to_pandas()
    assert df.equals(jdf)
    t2, jt2 = DataTable.from_pandas(df), JTable.from_pandas(jdf)
    assert t2.column_names == jt2.column_names == t.column_names
    for c in t.column_names:
        assert list(t2[c]) == list(jt2[c]) == list(t[c])
        assert t2.schema[c].tag == jt2.schema[c].tag
    v = DataTable({"vec": np.arange(8.0).reshape(4, 2)})
    back = DataTable.from_pandas(v.to_pandas())
    assert [list(r) for r in back["vec"]] == [list(r) for r in v["vec"]]


class TestFluentAPI:
    def test_ml_transform_chain(self):
        t = DataTable({"a": np.arange(4.0), "b": np.arange(4.0) * 2})
        out = t.ml_transform(PB.RenameColumn(inputCol="a", outputCol="a2"),
                             PB.DropColumns(cols=["b"]))
        assert out.column_names == ["a2"]
        jt = JTable({"a": np.arange(4.0), "b": np.arange(4.0) * 2})
        jout = jt.ml_transform(
            JB.RenameColumn(inputCol="a", outputCol="a2"),
            JB.DropColumns(cols=["b"]))
        assert list(out["a2"]) == list(jout["a2"])

    def test_ml_transform_fits_estimators_inline(self):
        cats = ["x", "y", "x", "z"]
        out = DataTable({"cat": cats}).ml_transform(
            PD.ValueIndexer(inputCol="cat", outputCol="ci"))
        jout = JTable({"cat": cats}).ml_transform(
            JD.ValueIndexer(inputCol="cat", outputCol="ci"))
        assert sorted(set(out["ci"])) == [0.0, 1.0, 2.0]
        assert list(out["ci"]) == list(jout["ci"])

    def test_ml_fit(self):
        t = DataTable({"cat": ["x", "y"]})
        model = t.ml_fit(PD.ValueIndexer(inputCol="cat", outputCol="ci"))
        assert len(model.transform(t)) == 2


# ---------------------------------------------------------------------------
# BinMapper and QuantileSketch
# ---------------------------------------------------------------------------


def _mapper_inputs():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(3000, 6))
    X[:, 1] = np.round(X[:, 1] * 3)            # few distinct values
    X[:, 2] = 1.0                              # constant
    X[:, 3] = 1.6e9 + rng.integers(0, 10**6, 3000)   # timestamp-like
    X[rng.random(3000) < 0.1, 4] = np.nan
    return X


@pytest.mark.parametrize("max_bin", [15, 63, 255])
def test_bin_threshold_value_and_f32_safe_bitwise(max_bin):
    X = _mapper_inputs()
    ref = JBinMapper.fit(X, max_bin=max_bin)
    port = BinMapper.from_json(ref.to_json())
    fitted = BinMapper.fit(X, max_bin=max_bin)
    assert port.f32_safe() is ref.f32_safe()
    assert fitted.f32_safe() is ref.f32_safe()
    for f in range(X.shape[1]):
        for b in list(range(max_bin + 2)) + [10**6]:
            got = port.bin_threshold_value(f, b)
            want = ref.bin_threshold_value(f, b)
            assert np.float64(got).tobytes() == np.float64(want).tobytes()
            assert np.float64(fitted.bin_threshold_value(f, b)).tobytes() \
                == np.float64(want).tobytes()
        # the lookup table agrees with the per-(feature, bin) call
        lut = port.threshold_matrix(max_bin)
        assert [port.bin_threshold_value(f, b) for b in range(max_bin)] \
            == list(lut[f])


def test_sketch_min_max_match_jax():
    rng = np.random.default_rng(3)
    port, ref = QuantileSketch(b=64), JSketch(b=64)
    assert np.isnan(port.min) and np.isnan(port.max)
    for _ in range(5):
        chunk = rng.standard_cauchy(4000)
        port.update(chunk)
        ref.update(chunk)
    assert port.min == ref.min and port.max == ref.max
    assert port.min <= port.query(0.01) <= port.query(0.99) <= port.max
