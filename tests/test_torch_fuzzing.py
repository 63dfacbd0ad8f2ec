"""PyTorch port: structural fuzzing coverage — every registered stage of
the port has a TestObject (``mmlspark_tpu_torch/testing/fuzz_objects.py``)
or a reasoned exemption, and every TestObject passes experiment,
serialization and schema fuzzing on the CPU (the port's copy of the JAX
package's ``tests/test_fuzzing.py``).
"""

import pytest

from mmlspark_tpu_torch.codegen import load_all_stages
from mmlspark_tpu_torch.core.stage import STAGE_REGISTRY, Model
from mmlspark_tpu_torch.testing import fuzz_objects as FO
from mmlspark_tpu_torch.testing.fuzzing import (
    FUZZING_REGISTRY, run_experiment_fuzzing, run_schema_fuzzing,
    run_serialization_fuzzing,
)

FO.register_all()
load_all_stages()       # every stage-defining module imported
STAGES = STAGE_REGISTRY


def test_every_stage_has_fuzzer_or_exemption():
    missing = []
    for name, cls in sorted(STAGES.items()):
        if not cls.__module__.startswith("mmlspark_tpu_torch."):
            continue  # test-/user-defined stages aren't framework API
        if name in FO.EXEMPT:
            continue
        if issubclass(cls, Model) and name not in FUZZING_REGISTRY:
            continue  # FO.MODEL_EXEMPT_REASON
        if name not in FUZZING_REGISTRY:
            missing.append(name)
    assert not missing, (
        f"stages without TestObjects (add one in testing/fuzz_objects.py "
        f"or document an exemption): {missing}")


def test_exemptions_are_not_stale():
    stale = [n for n in FO.EXEMPT if n not in STAGES]
    assert not stale, f"exempted stages no longer exist: {stale}"
    assert all(reason for reason in FO.EXEMPT.values())


def test_objects_are_built_for_the_cpu_and_move():
    """Every object whose stage has a device param is built on the CPU;
    ``on_device`` reaches the stages it holds."""
    for name, factories in FUZZING_REGISTRY.items():
        for factory in factories:
            stage = factory().stage
            if FO.has_device_param(stage):
                assert stage.get("device") == "cpu", name
    obj = next(f() for f in FUZZING_REGISTRY["TrainClassifier"])
    FO.on_device(obj.stage, "cuda")
    assert obj.stage.get("device") == "cuda"
    assert obj.stage.get("model").get("device") == "cuda"


def _all_objects():
    for name, factories in sorted(FUZZING_REGISTRY.items()):
        for i, f in enumerate(factories):
            yield pytest.param(f, id=f"{name}_{i}")


@pytest.mark.parametrize("factory", list(_all_objects()))
def test_experiment_fuzzing(factory):
    run_experiment_fuzzing(factory())


@pytest.mark.parametrize("factory", list(_all_objects()))
def test_serialization_fuzzing(factory):
    obj = factory()
    if obj.skip_serialization:
        pytest.skip("TestObject opted out of serialization fuzzing")
    run_serialization_fuzzing(obj)


@pytest.mark.parametrize("factory", list(_all_objects()))
def test_schema_fuzzing(factory):
    run_schema_fuzzing(factory())
