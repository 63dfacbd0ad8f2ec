"""PyTorch port: ``udfs.py``, ``plot.py`` and ``FastVectorAssembler``
against the JAX package, on the CPU.

The scenarios of ``tests/test_udfs_plot.py`` run through both packages.
Tolerance, stated: bitwise (host numpy in both). The plots are images:
both packages draw the same figure from the same table, so the saved
PNGs are compared as files of nonzero size, and the confusion matrix's
counts read back from the figure's text are equal.
"""

import os

import numpy as np
import pytest

from mmlspark_tpu import plot as jplot, udfs as judfs
from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.stages import FastVectorAssembler as JAssembler
from mmlspark_tpu.stages import UDFTransformer as JUDF

from mmlspark_tpu_torch import plot as pplot, udfs as pudfs
from mmlspark_tpu_torch.core.table import DataTable as PTable
from mmlspark_tpu_torch.stages import FastVectorAssembler as PAssembler
from mmlspark_tpu_torch.stages import UDFTransformer as PUDF


def test_to_vector_and_get_value_at():
    v = pudfs.to_vector([1, 2, 3])
    assert v.dtype == np.float64 and list(v) == [1, 2, 3]
    np.testing.assert_array_equal(v, judfs.to_vector([1, 2, 3]))
    assert pudfs.get_value_at(1)([5.0, 7.0, 9.0]) == 7.0
    assert pudfs.get_value_at(-1)(np.arange(4.0)) == \
        judfs.get_value_at(-1)(np.arange(4.0))


def test_udf_transformer_with_get_value_at():
    vec = np.asarray([[1.0, 2.0], [3.0, 4.0]])
    p = PUDF(inputCol="vec", outputCol="second",
             udf=pudfs.get_value_at(1)).transform(PTable({"vec": vec}))
    j = JUDF(inputCol="vec", outputCol="second",
             udf=judfs.get_value_at(1)).transform(JTable({"vec": vec}))
    assert list(p["second"]) == list(j["second"]) == [2.0, 4.0]


@pytest.mark.parametrize("arr", [[[1.0, 2.0], [3.0, 4.0]],
                                 np.asarray([[1.0, 2.0], [3.0, 4.0]])],
                         ids=["list", "matrix"])
def test_table_helpers(arr):
    p = pudfs.table_get_value_at(
        pudfs.table_to_vector(PTable({"arr": arr}), "arr", "vec"),
        "vec", "v0", 0)
    j = judfs.table_get_value_at(
        judfs.table_to_vector(JTable({"arr": arr}), "arr", "vec"),
        "vec", "v0", 0)
    assert p["vec"].shape == (2, 2)
    for c in ("vec", "v0"):
        np.testing.assert_array_equal(p[c], j[c])
        assert p[c].dtype == j[c].dtype
    assert list(p["v0"]) == [1.0, 3.0]


def _cm_texts(fig):
    return sorted(t.get_text() for t in fig.axes[0].texts)


@pytest.mark.parametrize("labels", [None, [1.0, 0.0]],
                         ids=["inferred", "explicit"])
def test_confusion_matrix_matches_jax(tmp_path, labels):
    pytest.importorskip("matplotlib")
    y = np.asarray([0, 0, 1, 1, 1.0])
    yhat = np.asarray([0, 1, 1, 1, 0.0])
    pp, jp = str(tmp_path / "p.png"), str(tmp_path / "j.png")
    pf = pplot.confusion_matrix(PTable({"y": y, "yhat": yhat}), "y", "yhat",
                                labels=labels, path=pp)
    jf = jplot.confusion_matrix(JTable({"y": y, "yhat": yhat}), "y", "yhat",
                                labels=labels, path=jp)
    assert os.path.getsize(pp) > 0 and os.path.getsize(jp) > 0
    assert _cm_texts(pf) == _cm_texts(jf)
    assert "Accuracy = 60.0%" in _cm_texts(pf)


def test_roc_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 200).astype(float)
    score = y * 0.6 + rng.random(200) * 0.4
    p = str(tmp_path / "roc.png")
    pf = pplot.roc(PTable({"y": y, "score": score}), "y", "score", path=p)
    jf = jplot.roc(JTable({"y": y, "score": score}), "y", "score")
    assert os.path.getsize(p) > 0
    np.testing.assert_array_equal(pf.axes[0].lines[0].get_xydata(),
                                  jf.axes[0].lines[0].get_xydata())


def test_plot_imports_without_matplotlib(monkeypatch):
    """matplotlib is imported inside the functions, as in the JAX
    package: the module imports where it is missing, a call raises."""
    import importlib
    import sys
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    mod = importlib.reload(pplot)
    with pytest.raises(ImportError):
        mod.roc(PTable({"y": [0.0, 1.0], "s": [0.1, 0.9]}), "y", "s")


def test_assembler_matches_jax():
    cols = {"a": np.asarray([1.0, 2.0]),
            "v": np.asarray([[3.0, 4.0], [5.0, 6.0]]),
            "l": [[7.0], [8.0]],
            "b": np.asarray([np.nan, 8.0])}
    p = PAssembler(inputCols=["a", "v", "l", "b"], outputCol="features"
                   ).transform(PTable(cols))["features"]
    j = JAssembler(inputCols=["a", "v", "l", "b"], outputCol="features"
                   ).transform(JTable(cols))["features"]
    assert p.dtype == np.float32 and p.shape == (2, 5)
    np.testing.assert_array_equal(p, j)     # NaN passes through in both
    np.testing.assert_array_equal(p[1], [2, 5, 6, 8, 8])


def test_assembler_schema_and_required_cols():
    t = PTable({"a": np.asarray([1.0]), "b": np.asarray([2.0])})
    stage = PAssembler(inputCols=["a", "b"])
    assert "features" in stage.transform_schema(t.schema).names
    with pytest.raises(ValueError, match="inputCols"):
        PAssembler().transform(t)
    with pytest.raises(Exception):
        PAssembler(inputCols=["nope"]).transform_schema(t.schema)
