"""PyTorch port: the stage registry's manifest, docs and generated smoke
tests (``mmlspark_tpu_torch/codegen.py``) against the JAX package's
``codegen.py``.

The port's manifest lists the same stages as the reference's, each with
the same kind and the same param names, types, defaults and choices,
apart from the differences listed here with the reason for each. The
generated smoke tests run in this process through ``importlib`` (a
nested pytest run is not used).
"""

import importlib.util
import json
import os

import pytest

from mmlspark_tpu import codegen as jcodegen
from mmlspark_tpu_torch import codegen
from mmlspark_tpu_torch.codegen import (
    generate_artifacts, load_all_stages, param_manifest, stage_manifest,
    stage_markdown,
)

# stages one package lists and the other does not. None today: every
# stage of the reference is ported. AOTTPUModel registers in either
# package only once an AOT artifact has loaded in the process, so it is
# left out of the comparison on both sides.
STAGE_DIFFERENCES = {}
LOAD_TIME_ONLY = {"AOTTPUModel"}
# params the port has and the reference does not
PORT_ONLY_PARAMS = {
    "device": "the port's entry points run on the card unless asked for "
              "the CPU (ROADMAP.md, 'Entry points run on the card')",
}
PARAM_FIELDS = ("type", "has_default", "default", "is_complex", "choices")


@pytest.fixture(scope="module")
def manifests():
    port = stage_manifest()["stages"]
    ref = jcodegen.stage_manifest()["stages"]
    return ({k: v for k, v in port.items() if k not in LOAD_TIME_ONLY},
            {k: v for k, v in ref.items() if k not in LOAD_TIME_ONLY})


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("generated"))
    counts = generate_artifacts(out)
    return out, counts


@pytest.fixture(scope="module")
def smoke_module(artifacts):
    out, _ = artifacts
    spec = importlib.util.spec_from_file_location(
        "torch_generated_smoke", os.path.join(out, "test_generated_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestManifestAgainstReference:
    def test_same_stage_names(self, manifests):
        port, ref = manifests
        assert set(port) ^ set(ref) == set(STAGE_DIFFERENCES)

    def test_same_kinds(self, manifests):
        port, ref = manifests
        kinds = {n: (port[n]["kind"], ref[n]["kind"])
                 for n in set(port) & set(ref)}
        assert {n: k for n, k in kinds.items() if k[0] != k[1]} == {}

    @pytest.mark.parametrize("name", sorted(
        n for n in jcodegen.stage_manifest()["stages"]
        if n not in LOAD_TIME_ONLY))
    def test_same_params(self, manifests, name):
        port, ref = manifests
        pp = {p["name"]: p for p in port[name]["params"]}
        rp = {p["name"]: p for p in ref[name]["params"]}
        assert set(rp) <= set(pp)
        assert set(pp) - set(rp) <= set(PORT_ONLY_PARAMS)
        for pname in rp:
            got = {f: pp[pname].get(f) for f in PARAM_FIELDS}
            want = {f: rp[pname].get(f) for f in PARAM_FIELDS}
            assert got == want, (name, pname)

    def test_device_param_defaults_to_the_card(self, manifests):
        port, _ = manifests
        with_device = [n for n, info in port.items()
                       for p in info["params"] if p["name"] == "device"]
        assert "TPUBoostClassifier" in with_device
        for name in with_device:
            p = next(p for p in port[name]["params"]
                     if p["name"] == "device")
            # None and "cuda" both name the card
            assert p["has_default"] and p["default"] in (None, "cuda"), name


class TestManifest:
    def test_manifest_covers_all_registered_stages(self):
        manifest = stage_manifest()
        expected = {n for n, cls in load_all_stages().items()
                    if n not in ("Transformer", "Estimator", "Model")
                    and cls.__module__.startswith("mmlspark_tpu_torch.")}
        assert set(manifest["stages"]) == expected
        # the forests' private base registers, and is no part of it
        from mmlspark_tpu_torch.core.stage import STAGE_REGISTRY
        assert "_BoosterModel" in STAGE_REGISTRY
        assert "_BoosterModel" not in load_all_stages()

    def test_stage_modules_are_the_ports(self):
        assert all(m.startswith("mmlspark_tpu_torch.")
                   for m in codegen.STAGE_MODULES)
        assert [m.split(".", 1)[1] for m in codegen.STAGE_MODULES] == \
            [m.split(".", 1)[1] for m in jcodegen.STAGE_MODULES]

    def test_param_manifest_structure(self):
        from mmlspark_tpu_torch.gbdt import TPUBoostClassifier
        params = {p["name"]: p for p in param_manifest(TPUBoostClassifier)}
        assert params["numIterations"]["type"] == "IntParam"
        assert params["numIterations"]["default"] == 100
        assert "choices" in params["objective"]
        assert params["validationData"]["is_complex"]

    def test_manifest_is_json_serializable(self):
        json.dumps(stage_manifest())


class TestGeneratedArtifacts:
    def test_doc_per_stage(self, artifacts):
        out, counts = artifacts
        docs = os.listdir(os.path.join(out, "docs"))
        assert counts["docs"] == counts["stages"] == len(
            stage_manifest()["stages"])
        assert "index.md" in docs
        assert len([d for d in docs if d != "index.md"]) == counts["docs"]

    @pytest.mark.parametrize("name", sorted(
        n for n in stage_manifest()["stages"]))
    def test_doc_names_every_param(self, artifacts, name):
        out, _ = artifacts
        md = open(os.path.join(out, "docs", f"{name}.md")).read()
        assert md.startswith(f"# {name}\n")
        for p in stage_manifest()["stages"][name]["params"]:
            assert f"| `{p['name']}` |" in md

    def test_doc_contains_param_table(self, artifacts):
        out, _ = artifacts
        md = open(os.path.join(out, "docs", "ValueIndexer.md")).read()
        assert "| `inputCol` |" in md
        assert "*Estimator*" in md

    def test_markdown_escapes_pipes(self):
        stages = load_all_stages()
        md = stage_markdown("DataConversion", stages["DataConversion"])
        assert "# DataConversion" in md

    def test_one_smoke_test_per_constructible_stage(self, artifacts,
                                                    smoke_module):
        _, counts = artifacts
        tests = [n for n in dir(smoke_module) if n.startswith("test_")]
        assert len(tests) == counts["tests"] > 50

    @pytest.mark.parametrize("name", sorted(
        n for n in stage_manifest()["stages"]))
    def test_generated_smoke_test_passes(self, smoke_module, name):
        fn = getattr(smoke_module, f"test_{name.lower()}_smoke", None)
        if fn is None:
            # only stages constructible with defaults get one; the
            # reference skips the same stages
            with pytest.raises(Exception):
                load_all_stages()[name]()
            return
        fn()
