"""Structural fuzzing harness: the port's copy of
``mmlspark_tpu/testing/fuzzing.py``.

The analog of the reference's generic fuzzing layer
(ref: src/core/test/fuzzing/src/test/scala/Fuzzing.scala:19-140 and
FuzzingTest.scala:13): every stage registers a ``TestObject`` with tables
for fit/transform; generic code then runs

- *experiment fuzzing*: fit+transform and sanity-check the result
  (ref: Fuzzing.scala:78), and
- *serialization fuzzing*: save/load the stage (and fitted model),
  re-run, and compare outputs (ref: Fuzzing.scala:108).

Coverage is enforced structurally: ``tests/test_torch_fuzzing.py`` enumerates
every registered stage class and fails if one lacks a TestObject and is not
on the exemption list (ref: FuzzingTest.scala:26-35).
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Dict, List, Optional, Type

from mmlspark_tpu_torch.core.stage import Estimator, PipelineStage, Transformer
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.testing.equality import assert_table_equal

# stage class name -> list of TestObject factories. Factories (not instances)
# so tables are built lazily inside tests.
FUZZING_REGISTRY: Dict[str, List[Callable[[], "TestObject"]]] = {}


class TestObject:
    """ref: Fuzzing.scala:19 TestObject(stage, fitDF, transDF, validateDF)."""

    __test__ = False  # not a pytest class

    def __init__(self, stage: PipelineStage,
                 fit_table: Optional[DataTable] = None,
                 transform_table: Optional[DataTable] = None,
                 validate_table: Optional[DataTable] = None,
                 tol: float = 1e-5,
                 skip_serialization: bool = False):
        self.stage = stage
        self.fit_table = fit_table
        self.transform_table = (transform_table if transform_table is not None
                                else fit_table)
        self.validate_table = validate_table
        self.tol = tol
        self.skip_serialization = skip_serialization


def register_test_object(factory: Callable[[], TestObject],
                         stage_cls: Optional[Type[PipelineStage]] = None) -> None:
    """Register a TestObject factory for a stage class. If ``stage_cls`` is
    omitted, it's resolved by building one instance eagerly."""
    if stage_cls is None:
        stage_cls = type(factory().stage)
    FUZZING_REGISTRY.setdefault(stage_cls.__name__, []).append(factory)


def fuzzing_decorator(factory: Callable[[], TestObject]):
    register_test_object(factory)
    return factory


def run_experiment_fuzzing(obj: TestObject) -> DataTable:
    """Fit (if estimator) + transform; optionally compare to validation
    table (ref: Fuzzing.scala ExperimentFuzzing :78)."""
    stage = obj.stage
    if isinstance(stage, Estimator):
        assert obj.fit_table is not None, \
            f"{type(stage).__name__}: estimator TestObject needs fit_table"
        model = stage.fit(obj.fit_table)
        assert isinstance(model, Transformer)
        result = model.transform(obj.transform_table)
    elif isinstance(stage, Transformer):
        assert obj.transform_table is not None
        result = stage.transform(obj.transform_table)
    else:
        raise TypeError(f"{stage!r} is neither Transformer nor Estimator")
    assert isinstance(result, DataTable)
    if obj.validate_table is not None:
        assert_table_equal(result, obj.validate_table, tol=obj.tol,
                           check_schema=False)
    return result


def run_serialization_fuzzing(obj: TestObject) -> None:
    """Save/load round-trip for the stage and (for estimators) the fitted
    model; outputs must match (ref: Fuzzing.scala SerializationFuzzing :108)."""
    stage = obj.stage
    with tempfile.TemporaryDirectory() as tmp:
        stage_path = os.path.join(tmp, "stage")
        stage.save(stage_path)
        reloaded = PipelineStage.load(stage_path)
        assert type(reloaded) is type(stage)

        if isinstance(stage, Estimator):
            model = stage.fit(obj.fit_table)
            model2 = reloaded.fit(obj.fit_table)
            out1 = model.transform(obj.transform_table)
            out2 = model2.transform(obj.transform_table)
            assert_table_equal(out1, out2, tol=obj.tol, check_schema=False)

            model_path = os.path.join(tmp, "model")
            model.save(model_path)
            model3 = PipelineStage.load(model_path)
            out3 = model3.transform(obj.transform_table)
            assert_table_equal(out1, out3, tol=obj.tol, check_schema=False)
        else:
            out1 = stage.transform(obj.transform_table)
            out2 = reloaded.transform(obj.transform_table)
            assert_table_equal(out1, out2, tol=obj.tol, check_schema=False)


def run_schema_fuzzing(obj: TestObject) -> None:
    """transform_schema must agree with the actual output schema on names."""
    stage = obj.stage
    table = obj.transform_table
    if isinstance(stage, Estimator):
        model = stage.fit(obj.fit_table)
        predicted = model.transform_schema(table.schema)
        actual = model.transform(table).schema
    else:
        predicted = stage.transform_schema(table.schema)
        actual = stage.transform(table).schema
    missing = [n for n in predicted.names if n not in actual.names]
    assert not missing, (
        f"{type(stage).__name__}.transform_schema predicted columns "
        f"{missing} that transform did not produce (actual: {actual.names})")
