"""PyTorch port: the testing helpers copied from the JAX package
(``testing/{equality,datagen,benchmarks,torch_models}.py``) against the
originals: the same tables from the same seeds, the same equality
verdicts, the same benchmark CSV handling, the same torch twin."""

import numpy as np
import pytest

from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.testing import benchmarks as jbench
from mmlspark_tpu.testing import datagen as jdatagen
from mmlspark_tpu.testing import equality as jeq
from mmlspark_tpu.testing.torch_models import (
    build_torch_resnet18 as jresnet18,
)

from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.testing import benchmarks, datagen, equality
from mmlspark_tpu_torch.testing.torch_models import build_torch_resnet18


def _same_table(got, want):
    assert got.column_names == want.column_names
    for c in want.column_names:
        g, w = got[c], want[c]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert list(g) == list(w)


@pytest.mark.parametrize("make,kw", [
    ("generate_table", {"n_rows": 30, "seed": 3}),
    ("generate_table", {"n_rows": 30, "seed": 4, "missing_fraction": 0.3,
                        "spec": {"a": "f32", "b": "i32", "v": "vector"}}),
    ("generate_classification_table", {"n_rows": 50, "n_classes": 3}),
    ("generate_regression_table", {"n_rows": 50, "seed": 2}),
    ("make_basic_table", {}),
])
def test_datagen_matches_the_reference(make, kw):
    _same_table(getattr(datagen, make)(**kw), getattr(jdatagen, make)(**kw))


def test_datagen_refuses_unknown_tags():
    with pytest.raises(ValueError, match="unsupported tag"):
        datagen.generate_table(spec={"x": "nope"})


@pytest.mark.parametrize("a,b", [
    (1.0, 1.0 + 1e-9), (1.0, 1.1), (float("nan"), float("nan")),
    (None, None), (None, 0.0), ([1, 2], [1, 2]), ([1, 2], [1, 3]),
    ({"a": 1.0}, {"a": 1.0}), ({"a": 1.0}, {"b": 1.0}),
    (np.array([1.0, 2.0]), np.array([1.0, 2.0 + 1e-9])),
    (np.array([1, 2]), np.array([1, 2, 3])), ("x", "x"), ("x", "y"),
])
def test_values_equal_matches_the_reference(a, b):
    assert equality.values_equal(a, b) == jeq.values_equal(a, b)


def test_table_equality_matches_the_reference():
    cols = {"x": np.arange(4.0), "s": ["a", "b", "c", "d"]}
    other = {"x": np.arange(4.0)[::-1].copy(), "s": ["d", "c", "b", "a"]}
    for ignore_order in (False, True):
        assert equality.tables_equal(
            DataTable(cols), DataTable(other), ignore_order=ignore_order) \
            == jeq.tables_equal(JTable(cols), JTable(other),
                                ignore_order=ignore_order)
    equality.assert_table_equal(DataTable(cols), DataTable(dict(cols)))
    with pytest.raises(AssertionError, match="row counts differ"):
        equality.assert_table_equal(DataTable(cols),
                                    DataTable({"x": np.arange(3.0),
                                               "s": ["a", "b", "c"]}))


def test_benchmark_comparer_matches_the_reference(tmp_path):
    for mod, name in ((benchmarks, "port"), (jbench, "ref")):
        path = tmp_path / f"{name}.csv"
        path.write_text("# metric,value\nauc,0.91\n")
        ok = mod.BenchmarkComparer(str(path), precision=2)
        ok.record("auc", 0.912)
        ok.verify()
        bad = mod.BenchmarkComparer(str(path), precision=2)
        bad.record("auc", 0.80)
        bad.record("loss", 1.0)
        with pytest.raises(AssertionError, match="benchmark regression"):
            bad.verify()
    assert (tmp_path / "port.csv.observed").read_text() == \
        (tmp_path / "ref.csv.observed").read_text()


def test_torch_twin_matches_the_reference():
    import torch
    torch.manual_seed(0)
    got = build_torch_resnet18(num_classes=10).state_dict()
    torch.manual_seed(0)
    want = jresnet18(num_classes=10).state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
