"""PyTorch port: Pipeline and stage persistence against the JAX package.

``Pipeline`` fit / transform through both packages on the same seeded
numpy inputs; save -> load round trips inside the port (GBDT models, an
MLP ``TPUModel``, pipelines); models and pytree files crossing between
the two packages in both directions, with bf16 leaves; and the restricted
unpickler that keeps JAX-package objects out of the port. A model the
JAX package saved is loaded by the port in a fresh process where
``jax`` and ``mmlspark_tpu`` cannot be imported.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import jax.numpy as jnp

from mmlspark_tpu.core import serialize as jser
from mmlspark_tpu.core.stage import Pipeline as JPipeline
from mmlspark_tpu.core.stage import load_stage as jload_stage
from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.gbdt.estimators import (
    TPUBoostClassificationModel as JClassModel,
    TPUBoostClassifier as JClassifier,
)
from mmlspark_tpu.stages.basic import Lambda as JLambda

import mmlspark_tpu_torch as mtt
from mmlspark_tpu_torch.core import serialize as tser
from mmlspark_tpu_torch.stages.basic import Lambda

REPO = Path(__file__).resolve().parent.parent
GBDT_KW = dict(numIterations=8, numLeaves=15, maxBin=63)


def _higgs_shape(n=6000, seed=7):
    """The HIGGS-shaped fixture of tests/test_torch_gbdt.py (after
    tests/test_gbdt_dist_quant.py): 28 dense f32 features."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 28)).astype(np.float32)
    logit = (X[:, 0] + 0.6 * X[:, 1] * X[:, 2]
             + 0.4 * np.sin(2 * X[:, 3]) - 0.3 * X[:, 4] ** 2 + 0.3)
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return X[:4096], y[:4096], X[4096:], y[4096:]


@pytest.fixture(scope="module")
def higgs():
    return _higgs_shape()


@pytest.fixture(scope="module")
def jax_model(higgs):
    Xtr, ytr, _, _ = higgs
    return JClassifier(**GBDT_KW).fit(JTable({"features": Xtr,
                                              "label": ytr}))


def _cols(out):
    return {c: np.asarray(out[c])
            for c in ("rawPrediction", "probability", "prediction")}


def _assert_scores_match(got, want):
    """The cross-package contract of the forest: rawPrediction bitwise,
    probability within an ulp-scale 2.5e-7 (the two packages' exp round
    differently), prediction exact."""
    np.testing.assert_array_equal(got["rawPrediction"],
                                  want["rawPrediction"])
    np.testing.assert_allclose(got["probability"], want["probability"],
                               rtol=0, atol=2.5e-7)
    np.testing.assert_array_equal(got["prediction"], want["prediction"])


def _scale(table):
    return table.with_column(
        "features", np.asarray(table["features"]) * np.float32(0.5))


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


def test_pipeline_fit_transform_matches_jax(higgs):
    """The pipeline against the JAX package's, at the tolerances of
    tests/test_torch_gbdt.py::test_classifier_fit_transform_matches_jax
    (the two fits sum f32 histograms in different orders), and against
    the port's own stages run one by one, bitwise."""
    Xtr, ytr, Xte, yte = higgs
    jpm = JPipeline([JLambda.apply(_scale), JClassifier(**GBDT_KW)]).fit(
        JTable({"features": Xtr, "label": ytr}))
    tpm = mtt.Pipeline([Lambda.apply(_scale), mtt.TPUBoostClassifier(
        device="cpu", **GBDT_KW)]).fit(
        mtt.DataTable({"features": Xtr, "label": ytr}))
    assert isinstance(tpm, mtt.PipelineModel)
    assert [type(s).__name__ for s in tpm.get_stages()] == \
        [type(s).__name__ for s in jpm.get_stages()]
    jo = jpm.transform(JTable({"features": Xte, "label": yte}))
    to = tpm.transform(mtt.DataTable({"features": Xte, "label": yte}))
    assert to.column_names == jo.column_names
    np.testing.assert_array_equal(to["features"], jo["features"])
    for col in ("rawPrediction", "probability"):
        np.testing.assert_allclose(to[col], jo[col], atol=1e-5)
    np.testing.assert_array_equal(to["prediction"], jo["prediction"])
    # one stage at a time, by hand
    direct = mtt.TPUBoostClassifier(device="cpu", **GBDT_KW).fit(
        _scale(mtt.DataTable({"features": Xtr, "label": ytr})))
    assert direct.get("modelString") == \
        tpm.get_stages()[1].get("modelString")
    _assert_scores_match(_cols(to), _cols(direct.transform(
        _scale(mtt.DataTable({"features": Xte})))))


def test_pipeline_transform_schema_and_fused_raise(higgs):
    pm = mtt.PipelineModel(stages=[Lambda.apply(_scale)])
    t = mtt.DataTable({"features": higgs[2]})
    assert pm.transform_schema(t.schema) == t.schema
    # fused() is ported ('Device pipeline and serving compilation'): a
    # host-only stage runs as a host step; mesh sharding still raises
    fused = pm.fused(device="cpu")
    np.testing.assert_array_equal(fused.transform(t)["features"],
                                  pm.transform(t)["features"])
    assert fused.describe() == "Lambda"
    with pytest.raises(NotImplementedError,
                       match="Device pipeline and serving compilation"):
        fused.shard(None)


# ---------------------------------------------------------------------------
# port -> port round trips
# ---------------------------------------------------------------------------


def test_gbdt_models_round_trip_in_the_port(higgs, tmp_path):
    Xtr, ytr, Xte, _ = higgs
    cls = mtt.TPUBoostClassifier(device="cpu", rawPredictionCol="raw",
                                 **GBDT_KW).fit(
        mtt.DataTable({"features": Xtr, "label": ytr}))
    reg = mtt.TPUBoostRegressor(device="cpu", numIterations=4,
                                numLeaves=7, objective="huber").fit(
        mtt.DataTable({"features": Xtr, "label": Xtr[:, 0] * 2}))
    test = mtt.DataTable({"features": Xte})
    for model in (cls, reg):
        path = str(tmp_path / type(model).__name__)
        model.save(path)
        back = type(model).load(path)
        assert type(back) is type(model) and back.uid == model.uid
        assert back.get("device") == "cpu"
        assert back._paramMap == model._paramMap
        a, b = model.transform(test), back.transform(test)
        for col in a.column_names:
            np.testing.assert_array_equal(np.asarray(b[col]),
                                          np.asarray(a[col]))
    with pytest.raises(TypeError, match="expected TPUBoostRegressionModel"):
        mtt.TPUBoostRegressionModel.load(str(tmp_path / type(cls).__name__))


def test_mlp_tpumodel_round_trips_in_the_port(tmp_path):
    net = mtt.build_network({"type": "mlp", "features": [16, 8],
                             "num_classes": 3, "in_features": 12},
                            device="cpu", seed=3)
    model = mtt.TPUModel.from_module(net, device="cpu", inputCol="x",
                                     outputCol="y", batchSize=8)
    x = np.random.default_rng(1).normal(size=(13, 12)).astype(np.float32)
    path = str(tmp_path / "mlp")
    model.save(path)
    meta = json.loads(open(os.path.join(path, "metadata.json")).read())
    assert meta["complex_params"] == {"modelFn": "callable",
                                      "weights": "pytree"}
    back = mtt.load_stage(path)
    assert isinstance(back, mtt.TPUModel)
    # the module travels as structure only: its values come from weights
    assert all(p.device.type == "meta"
               for p in back.get("modelFn").module.parameters())
    assert set(back.get("weights")) == set(model.get("weights"))
    np.testing.assert_array_equal(
        back.transform(mtt.DataTable({"x": x}))["y"],
        model.transform(mtt.DataTable({"x": x}))["y"])


def test_pipeline_model_round_trips_with_nested_stages(higgs, tmp_path):
    Xtr, ytr, Xte, _ = higgs
    pm = mtt.Pipeline([mtt.TPUBoostClassifier(device="cpu", **GBDT_KW)]
                      ).fit(mtt.DataTable({"features": Xtr, "label": ytr}))
    path = str(tmp_path / "pm")
    pm.save(path)
    meta = json.loads(open(os.path.join(path, "metadata.json")).read())
    assert meta["class"] == "PipelineModel"
    assert meta["complex_params"] == {"stages": "stage_list"}
    back = mtt.load_stage(path)
    test = mtt.DataTable({"features": Xte})
    _assert_scores_match(_cols(back.transform(test)),
                         _cols(pm.transform(test)))


def test_table_round_trips_and_crosses_packages(tmp_path):
    t = mtt.DataTable({"x": np.arange(4, dtype=np.float32),
                       "s": ["a", "b", None, "d"],
                       "v": np.ones((4, 3))})
    t.save(str(tmp_path / "port"))
    for back in (mtt.DataTable.load(str(tmp_path / "port")),
                 JTable.load(str(tmp_path / "port"))):
        assert back.column_names == t.column_names
        np.testing.assert_array_equal(back["v"], t["v"])
        assert list(back["s"]) == list(t["s"])
    JTable({"x": np.arange(3)}).save(str(tmp_path / "jax"))
    np.testing.assert_array_equal(
        mtt.DataTable.load(str(tmp_path / "jax"))["x"], np.arange(3))


# ---------------------------------------------------------------------------
# models across the two packages
# ---------------------------------------------------------------------------


def test_jax_saved_gbdt_model_loads_in_port_with_jax_blocked(
        higgs, jax_model, tmp_path):
    _, _, Xte, _ = higgs
    path = str(tmp_path / "jax_model")
    jax_model.save(path)
    assert json.loads(open(os.path.join(path, "metadata.json")).read()
                      )["module"] == "mmlspark_tpu.gbdt.estimators"
    np.save(str(tmp_path / "x.npy"), Xte)
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["mmlspark_tpu"] = None
import numpy as np
import mmlspark_tpu_torch as mtt
m = mtt.load_stage({path!r})
assert type(m).__module__ == "mmlspark_tpu_torch.gbdt.estimators", type(m)
m.set("device", "cpu")
out = m.transform(mtt.DataTable({{"features": np.load({str(tmp_path / 'x.npy')!r})}}))
np.savez({str(tmp_path / 'port_out.npz')!r}, **{{c: np.asarray(out[c]) for c in
         ("rawPrediction", "probability", "prediction")}})
bad = [k for k, v in sys.modules.items() if v is not None
       and k.split(".")[0] in ("jax", "jaxlib", "flax", "mmlspark_tpu")]
assert not bad, bad
print("OK")
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(REPO), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OK" in r.stdout
    got = dict(np.load(str(tmp_path / "port_out.npz")))
    _assert_scores_match(got, _cols(jax_model.transform(
        JTable({"features": Xte}))))


def test_port_saved_gbdt_model_loads_in_jax(higgs, tmp_path):
    Xtr, ytr, Xte, _ = higgs
    tm = mtt.TPUBoostClassifier(device="cpu", **GBDT_KW).fit(
        mtt.DataTable({"features": Xtr, "label": ytr}))
    path = str(tmp_path / "port_model")
    tm.save(path)
    back = jload_stage(path)
    assert isinstance(back, JClassModel)
    assert back.get("modelString") == tm.get("modelString")
    _assert_scores_match(
        _cols(back.transform(JTable({"features": Xte}))),
        _cols(tm.transform(mtt.DataTable({"features": Xte}))))


def test_port_load_never_imports_an_unknown_module(tmp_path):
    path = tmp_path / "odd"
    path.mkdir()
    (path / "metadata.json").write_text(json.dumps({
        "class": "NoSuchStage", "module": "os.path", "uid": "x",
        "params": {}, "complex_params": {}}))
    assert tser.port_module("os.path") == ""
    assert tser.port_module("mmlspark_tpu.gbdt.estimators") == \
        "mmlspark_tpu_torch.gbdt.estimators"
    with pytest.raises(KeyError, match="NoSuchStage"):
        mtt.load_stage(str(path))


def _saved_meta(tmp_path, module):
    path = tmp_path / "stage"
    path.mkdir()
    (path / "metadata.json").write_text(json.dumps({
        "class": "NoSuchStage", "module": module, "uid": "x",
        "params": {}, "complex_params": {}}))
    return str(path)


@pytest.mark.parametrize("module", [
    "mmlspark_tpu.no_such_pkg.estimators",
    "mmlspark_tpu.gbdt.no_such_module",
])
def test_port_load_of_a_module_the_port_lacks_is_a_registry_miss(
        tmp_path, module):
    with pytest.raises(KeyError, match="NoSuchStage"):
        mtt.load_stage(_saved_meta(tmp_path, module))


@pytest.mark.parametrize("fault", [
    ModuleNotFoundError("No module named 'lost_dep'", name="lost_dep"),
    ImportError("cannot import name 'x' from 'mmlspark_tpu_torch.gbdt'"),
])
def test_port_load_keeps_an_import_fault_inside_the_declaring_module(
        tmp_path, monkeypatch, fault):
    imported = []

    def import_module(name):
        imported.append(name)
        raise fault

    monkeypatch.setattr(tser.importlib, "import_module", import_module)
    with pytest.raises(ImportError) as ei:
        mtt.load_stage(_saved_meta(tmp_path, "mmlspark_tpu.gbdt.estimators"))
    assert ei.value is fault
    assert imported == ["mmlspark_tpu_torch.gbdt.estimators"]


# ---------------------------------------------------------------------------
# pytrees and pickles
# ---------------------------------------------------------------------------


def _tree_values():
    rng = np.random.default_rng(5)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    b16 = rng.normal(size=(5,)).astype(np.float32)
    return w, b16


def test_port_pytree_loads_in_jax_with_bf16_leaves(tmp_path):
    w, b16 = _tree_values()
    tree = {"layer": {"w": torch.from_numpy(w),
                      "b": torch.from_numpy(b16).to(torch.bfloat16)},
            "meta": (3, 0.5, True, None), "arr": np.arange(3),
            "seq": [np.float32(2.0)]}
    tser._save_pytree(tree, str(tmp_path))
    ref = jser._load_pytree(str(tmp_path))
    np.testing.assert_array_equal(ref["layer"]["w"], w)
    # bf16 rides widened to f32: the reference reads the rounded values
    np.testing.assert_array_equal(
        ref["layer"]["b"],
        torch.from_numpy(b16).to(torch.bfloat16).float().numpy())
    assert ref["meta"] == (3, 0.5, True, None)
    back = tser._load_pytree(str(tmp_path))
    assert back["layer"]["b"].dtype == torch.bfloat16
    assert torch.equal(back["layer"]["b"], tree["layer"]["b"])
    assert torch.equal(back["layer"]["w"], tree["layer"]["w"])
    assert back["meta"] == (3, 0.5, True, None)
    np.testing.assert_array_equal(back["arr"], np.arange(3))
    assert isinstance(back["seq"], list)


def test_jax_pytree_loads_in_port_with_bf16_leaves(tmp_path):
    w, b16 = _tree_values()
    tree = {"params": {"kernel": jnp.asarray(w),
                       "bias": jnp.asarray(b16, dtype=jnp.bfloat16)},
            "step": 7}
    jser._save_pytree(tree, str(tmp_path))
    back = tser._load_pytree(str(tmp_path))
    np.testing.assert_array_equal(back["params"]["kernel"], w)
    bias = back["params"]["bias"]
    assert isinstance(bias, torch.Tensor) and bias.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bias.float().numpy(),
        np.asarray(jnp.asarray(b16, dtype=jnp.bfloat16), np.float32))
    assert back["step"] == 7


def test_restricted_unpickler_refuses_the_jax_package(jax_model, tmp_path):
    with pytest.raises(pickle.UnpicklingError,
                       match="mmlspark_tpu_torch.gbdt.estimators"):
        tser.restricted_loads(pickle.dumps(jax_model))
    with pytest.raises(pickle.UnpicklingError, match="module_from_flax"):
        tser.restricted_loads(pickle.dumps(flax_nn.Dense))
    with pytest.raises(pickle.UnpicklingError, match="numpy arrays"):
        tser.restricted_loads(pickle.dumps(jnp.float32))
    assert tser.restricted_loads(pickle.dumps({"a": [1, 2.5]})) == \
        {"a": [1, 2.5]}
    # a saved stage whose callable param is a JAX-package object
    stage = Lambda.apply(jax_model.transform)
    path = str(tmp_path / "lam")
    stage.save(path)
    with pytest.raises(pickle.UnpicklingError, match="JAX package"):
        mtt.load_stage(path)
