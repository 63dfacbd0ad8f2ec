"""PyTorch port: the CLI's registry commands (``stages``, ``describe``,
``codegen``) and ``run`` of a JSON pipeline spec, against the JAX
package's CLI on the same spec and the same ``.npz``.

The two fitted pipelines are held to ROADMAP.md §3's parity limits: a
forest's predictions equal and its probabilities within rtol 1e-5; a
logistic head's probabilities within rtol 1e-4 / atol 1e-5 of their
largest magnitude and its predictions equal but on near ties. The
error texts of an unknown stage, of "did you mean" and of a bad param
are the reference's, with the port's program name in the hint.
"""

import json

import numpy as np
import pytest

from mmlspark_tpu import cli as jcli
from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu_torch import cli
from mmlspark_tpu_torch.core.table import DataTable

REF_PROG = "mmlspark-tpu"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_data")
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 4)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    path = str(d / "data.npz")
    np.savez(path, features=X, label=y, x1=X[:, 2], x2=X[:, 3])
    return d, path


def _spec(d, name, stages):
    path = str(d / f"{name}.json")
    with open(path, "w") as f:
        json.dump({"pipeline": stages}, f)
    return path


def _run_both(d, data_path, spec_path, name):
    ref_out, port_out = str(d / f"{name}_ref"), str(d / f"{name}_port")
    assert jcli.main(["run", spec_path, "--data", data_path, "--save",
                      str(d / f"{name}_ref_model"), "--score-out",
                      ref_out]) == 0
    assert cli.main(["run", spec_path, "--data", data_path, "--save",
                     str(d / f"{name}_port_model"), "--score-out",
                     port_out, "--device", "cpu"]) == 0
    return JTable.load(ref_out), DataTable.load(port_out)


def test_stages_lists_every_registered_stage(capsys):
    from mmlspark_tpu_torch.codegen import stage_manifest
    assert cli.main(["stages"]) == 0
    text = capsys.readouterr().out
    n = len(stage_manifest()["stages"])
    assert f"\n{n} stages (v" in text
    assert "TPUBoostClassifier" in text and "Estimator" in text


def test_stages_json_is_the_manifest(capsys):
    from mmlspark_tpu_torch.codegen import stage_manifest
    assert cli.main(["stages", "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == json.loads(json.dumps(stage_manifest()))


def test_describe_prints_the_param_table(capsys):
    assert cli.main(["describe", "TPUBoostClassifier"]) == 0
    md = capsys.readouterr().out
    assert md.startswith("# TPUBoostClassifier")
    assert "| `numLeaves` |" in md and "| `device` |" in md


def test_describe_unknown_stage_matches_the_reference():
    with pytest.raises(SystemExit) as got:
        cli.main(["describe", "NoSuchStage"])
    with pytest.raises(SystemExit) as want:
        jcli.main(["describe", "NoSuchStage"])
    assert str(got.value).replace(cli.PROG, REF_PROG) == str(want.value)


def test_codegen_writes_docs_manifest_and_tests(tmp_path, capsys):
    assert cli.main(["codegen", str(tmp_path)]) == 0
    counts = json.loads(capsys.readouterr().out)
    assert counts["stages"] == counts["docs"] > 50
    for name in ("manifest.json", "test_generated_smoke.py",
                 "docs/index.md", "docs/TPUBoostClassifier.md"):
        assert (tmp_path / name).exists(), name


@pytest.mark.parametrize("stage,why", [
    ("NoSuchStage", "unknown"),
    ("boost", "did you mean"),
])
def test_unknown_stage_errors_match_the_reference(tmp_path, stage, why):
    spec = {"pipeline": [{"stage": stage, "params": {}}]}
    with pytest.raises(SystemExit) as got:
        cli.build_pipeline(spec, "cpu")
    with pytest.raises(SystemExit) as want:
        jcli.build_pipeline(spec)
    assert str(got.value).replace(cli.PROG, REF_PROG) == str(want.value)
    if why == "did you mean":
        assert "did you mean: TPUBoostClassificationModel" in str(got.value)


@pytest.mark.parametrize("params", [
    {"numLeaves": "many"},
    {"noSuchParam": 1},
])
def test_param_errors_match_the_reference(params):
    spec = {"pipeline": [{"stage": "TPUBoostClassifier", "params": params}]}
    with pytest.raises(SystemExit) as got:
        cli.build_pipeline(spec, "cpu")
    with pytest.raises(SystemExit) as want:
        jcli.build_pipeline(spec)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("pipeline[0] (TPUBoostClassifier): ")


def test_empty_and_unreadable_specs(tmp_path):
    with pytest.raises(SystemExit, match="no 'pipeline' list"):
        cli.build_pipeline({}, "cpu")
    with pytest.raises(SystemExit, match="cannot read pipeline spec"):
        cli._read_spec(str(tmp_path / "missing.json"))


def test_run_sets_the_device_on_every_stage():
    pipe = cli.build_pipeline({"pipeline": [
        {"stage": "Featurize", "params": {"featureColumns": ["x1"]}},
        {"stage": "TPULogisticRegression", "params": {"maxIter": 5}}]},
        "cpu")
    stages = pipe.get("stages")
    assert stages[1].get("device") == "cpu"
    assert not any(p.name == "device" for p in type(stages[0]).params())


def test_run_defaults_to_the_card(data, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d, path = data
    spec = _spec(d, "card", [{"stage": "TPUBoostClassifier",
                              "params": {"numIterations": 2}}])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["run", spec, "--data", path])


def test_run_forest_spec_matches_the_reference(data):
    d, path = data
    spec = _spec(d, "forest", [{"stage": "TPUBoostClassifier", "params": {
        "numIterations": 4, "numLeaves": 7, "minDataInLeaf": 5}}])
    ref, got = _run_both(d, path, spec, "forest")
    assert got.column_names == ref.column_names
    np.testing.assert_array_equal(np.asarray(got["prediction"]),
                                  np.asarray(ref["prediction"]))
    np.testing.assert_allclose(np.asarray(got["probability"]),
                               np.asarray(ref["probability"]), rtol=1e-5)


def test_run_featurize_logistic_spec_matches_the_reference(data):
    d, path = data
    spec = _spec(d, "linear", [
        {"stage": "Featurize", "params": {"featureColumns": ["x1", "x2"],
                                          "outputCol": "feats"}},
        {"stage": "TPULogisticRegression", "params": {
            "featuresCol": "feats", "maxIter": 50}}])
    ref, got = _run_both(d, path, spec, "linear")
    assert got.column_names == ref.column_names
    np.testing.assert_array_equal(np.asarray(got["feats"]),
                                  np.asarray(ref["feats"]))
    p_got = np.asarray(got["probability"])
    p_ref = np.asarray(ref["probability"])
    scale = float(np.abs(p_ref).max())
    np.testing.assert_allclose(p_got, p_ref, rtol=1e-4, atol=1e-5 * scale)
    differ = np.asarray(got["prediction"]) != np.asarray(ref["prediction"])
    # predictions part only on near ties
    assert np.all(np.abs(p_ref[differ, 1] - 0.5) < 1e-4)
