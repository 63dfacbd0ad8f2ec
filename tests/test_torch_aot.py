"""PyTorch port: AOT serving artifacts (``mmlspark_tpu_torch/serving/
aot.py``) and the flash forward as a torch custom op, on the CPU.

The AOT scenarios of the JAX package's ``tests/test_quantize.py``: the
artifact layout, every exported bucket of the loaded model bitwise the
in-process model's with zero first runs, an unseen shape that falls back
to the model fn and counts, the int8 kind and the pipeline kind served
end to end. Then: an artifact of the JAX package refused; the custom op
``mmlspark_tpu_torch::flash_fwd`` equal to ``flash_forward_plain`` and
present as a node of an exported program; a small Transformer whose flax
weights reach the port through ``convert.py``, exported and loaded in
each package, the two outputs within the LM parity tests' tolerance;
and fresh-process cold starts with no request-time first run (no speed
floor: an eager model has no compile to retire).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.models.networks import build_network as jbuild
from mmlspark_tpu.models.tpu_model import TPUModel as JTPUModel
from mmlspark_tpu.serving import aot as jaot

from mmlspark_tpu_torch import _build, convert
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.models.networks import build_network
from mmlspark_tpu_torch.models.tpu_model import TPUModel
from mmlspark_tpu_torch.ops import flash_attention as FA
from mmlspark_tpu_torch.serving import aot
from mmlspark_tpu_torch.serving.fleet import json_scoring_pipeline

REPO = Path(__file__).resolve().parent.parent
MLP = {"type": "mlp", "features": [64, 32], "num_classes": 10,
       "in_features": 16}
SMALL = {"type": "transformer", "vocab_size": 64, "dim": 32, "depth": 2,
         "heads": 4, "max_len": 512, "head_dtype": "float32"}


def _mlp_model(batch_size=64, seed=0, **spec):
    module = build_network(dict(MLP, **spec), device="cpu", seed=seed)
    return TPUModel.from_module(module, device="cpu", inputCol="features",
                                outputCol="scores", batchSize=batch_size)


@pytest.fixture(scope="module")
def aot_artifact(tmp_path_factory):
    """One exported f32 MLP artifact shared by the AOT tests."""
    m = _mlp_model()
    art = str(tmp_path_factory.mktemp("aot") / "model_v1")
    manifest = aot.export_model(
        m, {"features": np.zeros((1, 16), np.float32)}, art, version="v1")
    return m, art, manifest


class TestAOTExportLoad:
    def test_manifest_and_artifact_layout(self, aot_artifact):
        _, art, manifest = aot_artifact
        assert manifest["kind"] == "tpu_model"
        assert manifest["format"] == "torch_export"
        assert manifest["precision"] == "f32"
        assert manifest["buckets"] == [8, 16, 32, 64]
        assert manifest["programs"] == 4
        assert manifest["backend"] == "cpu"
        # the plain versions run on the CPU: no kernel library to carry
        assert manifest["kernels"] == {}
        assert aot.read_manifest(art) == manifest
        for name in ("manifest.json", "programs.pkl", "weights.pkl",
                     "model_fn.pkl", "example.pkl",
                     "example_request.json"):
            assert os.path.exists(os.path.join(art, name)), name
        req = json.load(open(os.path.join(art, "example_request.json")))
        assert list(req) == ["features"] and len(req["features"]) == 16

    def test_programs_carry_no_weights(self, tmp_path):
        """The weights travel once, in weights.pkl: a program holds the
        graph, not its example inputs."""
        m = _mlp_model(batch_size=8, features=[512, 512])
        art = str(tmp_path / "wide")
        aot.export_model(m, {"features": np.zeros((1, 16), np.float32)},
                         art)
        w_bytes = sum(t.numel() * t.element_size()
                      for t in m.get("weights").values())
        assert os.path.getsize(os.path.join(art, "weights.pkl")) > w_bytes
        assert os.path.getsize(os.path.join(art, "programs.pkl")) \
            < w_bytes / 4

    def test_loaded_bit_identical_zero_first_runs(self, aot_artifact):
        """Per-bucket outputs bitwise the in-process model's, with no
        first run on the loaded model: at load, at warmup, at request
        time."""
        m, art, _ = aot_artifact
        loaded = aot.load_model(art, device="cpu")
        assert loaded.aot is True
        assert loaded.jit_cache_misses == 0
        rng = np.random.default_rng(3)
        for b in (3, 8, 16, 32, 64, 100):
            X = rng.normal(size=(b, 16)).astype(np.float32)
            t = DataTable({"features": X})
            a = np.asarray(loaded.transform(t)["scores"])
            r = np.asarray(m.transform(t)["scores"])
            assert np.array_equal(a, r), f"{b} rows diverged"
        assert loaded.warmup(
            {"features": np.zeros((1, 16), np.float32)}) == 0
        assert loaded.jit_cache_misses == 0, \
            "the AOT-loaded model met a shape at request time"

    def test_unseen_shape_falls_back_and_counts(self, aot_artifact):
        """A shape the artifact never exported still serves (the model
        fn, unpickled lazily) and COUNTS as a miss."""
        m, art, _ = aot_artifact
        loaded = aot.load_model(art, device="cpu")
        loaded.set("batchSize", 128)
        m.set("batchSize", 128)
        try:
            X = np.random.default_rng(4).normal(size=(100, 16)).astype(
                np.float32)
            out = loaded.transform(DataTable({"features": X}))
            want = m.transform(DataTable({"features": X}))
            assert np.array_equal(out["scores"], want["scores"])
            assert loaded.jit_cache_misses == 1
        finally:
            m.set("batchSize", 64)

    def test_quantized_model_roundtrip(self, tmp_path):
        m = _mlp_model(batch_size=16)
        calib = np.random.default_rng(0).normal(size=(64, 16)).astype(
            np.float32)
        q = m.quantize({"features": calib})
        art = str(tmp_path / "q_v1")
        manifest = aot.export_model(q, {"features": calib[:1]}, art,
                                    version="v1-int8")
        assert manifest["precision"] == "int8"
        loaded = aot.load_model(art, device="cpu")
        assert loaded.get("precision") == "int8"
        t = DataTable({"features": calib})
        assert np.array_equal(np.asarray(loaded.transform(t)["scores"]),
                              np.asarray(q.transform(t)["scores"]))
        assert loaded.jit_cache_misses == 0

    def test_pipeline_artifact_serves_end_to_end(self, tmp_path):
        """Pipeline kind: every serving bucket's program installed on the
        rebuilt plan, the scorer warms with no first run, every bucket
        and every reply equal to the in-process pipeline's."""
        from mmlspark_tpu_torch.core.stage import Pipeline
        from mmlspark_tpu_torch.models.linear import TPULogisticRegression
        from mmlspark_tpu_torch.stages.dataprep import StandardScaler
        rng = np.random.default_rng(0)
        X = rng.normal(size=(1024, 6))
        y = (X[:, 0] > 0).astype(np.float64)
        t = DataTable({"features": X, "label": y})
        pm = Pipeline(stages=[
            StandardScaler(inputCol="features", outputCol="features"),
            TPULogisticRegression(featuresCol="features", labelCol="label",
                                  maxIter=30, device="cpu"),
        ]).fit(t)
        fused = pm.fused(batch_size=32, device="cpu")
        example = DataTable({"features": X[:1]})
        art = str(tmp_path / "pipe_v1")
        manifest = aot.export_model(fused, example, art, version="v1")
        assert manifest["kind"] == "pipeline"
        assert manifest["programs"] == len(manifest["buckets"]) == 3
        assert os.path.exists(os.path.join(art, "pipeline.pkl"))
        loaded = aot.load_model(art, device="cpu")
        assert loaded.aot is True
        meta = aot._read_pickle(art, "pipeline.pkl")
        plan = loaded.plan_for(meta["in_schema"], meta["final_needed"])
        want_plan = fused.plan_for(meta["in_schema"], meta["final_needed"])
        for b in manifest["buckets"]:
            sub = DataTable({"features": X[:b]})
            col = meta["reply_col"]
            assert np.array_equal(np.asarray(plan.execute(sub)[col]),
                                  np.asarray(want_plan.execute(sub)[col]))
        assert loaded.jit_cache_misses == 0
        stage = json_scoring_pipeline(loaded)
        assert stage.aot is True
        assert stage.warmup(example) == 0
        ref_stage = json_scoring_pipeline(fused)
        for i in range(1, 4):
            body = json.dumps({"features": [float(v) for v in X[i]]}
                              ).encode()
            req = DataTable({"id": [f"r{i}"], "request": [{"entity": body}]})
            assert stage.transform(req)["reply"][0] == \
                ref_stage.transform(req)["reply"][0]
        assert loaded.jit_cache_misses == 0, \
            "the AOT pipeline met a shape at request time"

    def test_export_refuses_what_it_cannot_export(self, tmp_path):
        with pytest.raises(TypeError, match="cannot AOT-export"):
            aot.export_model(object(), {}, str(tmp_path / "x"))
        with pytest.raises(ValueError, match="at least one example row"):
            aot.export_model(_mlp_model(), {"features": np.zeros((0, 16))},
                             str(tmp_path / "y"))


@pytest.fixture
def jax_registry_kept():
    """The JAX package's stage registry as it was: its load_model
    registers the AOTTPUModel class it builds, which the reference's own
    codegen tests would then list (and fail to import) in this worker."""
    from mmlspark_tpu.core.stage import STAGE_REGISTRY
    before = dict(STAGE_REGISTRY)
    yield
    STAGE_REGISTRY.clear()
    STAGE_REGISTRY.update(before)


class TestAcrossPackages:
    def test_jax_artifact_is_refused(self, tmp_path):
        module = jbuild({"type": "mlp", "features": [8], "num_classes": 2})
        x0 = np.zeros((1, 4), np.float32)
        jm = JTPUModel.from_flax(
            module, module.init(jax.random.PRNGKey(0), x0),
            inputCol="features", outputCol="scores", batchSize=8)
        art = str(tmp_path / "jax_art")
        manifest = jaot.export_model(jm, {"features": x0}, art)
        assert manifest["format"] in ("jax_export", "trace_cache")
        with pytest.raises(ValueError, match="written by the JAX package"):
            aot.load_model(art, device="cpu")

    def test_artifact_exported_on_another_device_is_refused(
            self, aot_artifact, tmp_path):
        _, art, manifest = aot_artifact
        other = tmp_path / "other"
        other.mkdir()
        with open(other / "manifest.json", "w") as f:
            json.dump(dict(manifest, backend="cuda"), f)
        with pytest.raises(ValueError, match="exported on cuda"):
            aot.load_model(str(other), device="cpu")

    def test_transformer_exported_in_both_packages(self, tmp_path,
                                                   jax_registry_kept):
        """Flax weights carried into the port by convert.py; each package
        exports and loads its own artifact; the loaded outputs agree
        within the LM parity tests' f32 tolerance, and the port's loaded
        program is bitwise its in-process model."""
        toks = np.random.default_rng(5).integers(
            0, SMALL["vocab_size"], size=(10, 512)).astype(np.int32)
        variables = jbuild(SMALL).init(jax.random.key(1),
                                       jnp.asarray(toks[:1]))
        variables = jax.tree_util.tree_map(np.asarray, variables)
        jm = JTPUModel.from_flax(jbuild(SMALL), variables,
                                 inputCol="tokens", outputCol="logits",
                                 batchSize=8)
        jart = str(tmp_path / "jax_lm")
        jaot.export_model(jm, {"tokens": toks[:1]}, jart)
        want = np.asarray(jaot.load_model(jart).transform(
            JTable({"tokens": toks}))["logits"])

        module = convert.module_from_flax(SMALL, variables, device="cpu")
        pm = TPUModel.from_module(module, device="cpu", inputCol="tokens",
                                  outputCol="logits", batchSize=8)
        art = str(tmp_path / "port_lm")
        aot.export_model(pm, {"tokens": toks[:1]}, art)
        loaded = aot.load_model(art, device="cpu")
        got = np.asarray(loaded.transform(DataTable({"tokens": toks}))[
            "logits"])
        assert np.array_equal(got, pm.transform(DataTable(
            {"tokens": toks}))["logits"])
        assert loaded.jit_cache_misses == 0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-4)


class TestFlashCustomOp:
    def test_cpu_op_equals_the_plain_version(self):
        g = torch.Generator().manual_seed(0)
        for causal, lq, lk in ((True, 300, 300), (False, 130, 520)):
            q = torch.randn(2, lq, 3, 16, generator=g)
            k, v = (torch.randn(2, lk, 3, 16, generator=g)
                    for _ in range(2))
            out, lse = torch.ops.mmlspark_tpu_torch.flash_fwd(
                q, k, v, causal, 0, 0)
            want_out, want_lse = FA.flash_forward_plain(q, k, v, causal)
            assert torch.equal(out, want_out)
            assert torch.equal(lse, want_lse)
            assert out.is_contiguous() and lse.shape == (2, 3, lq)
            got = FA.flash_forward(q, k, v, causal)
            assert torch.equal(got[0], want_out)
        assert FA.LAUNCHES["_fwd_kernel"] == 0

    def test_opcheck(self):
        g = torch.Generator().manual_seed(1)
        q, k, v = (torch.randn(1, 40, 2, 8, generator=g) for _ in range(3))
        result = torch.library.opcheck(
            torch.ops.mmlspark_tpu_torch.flash_fwd.default,
            (q, k, v, True, 0, 0))
        assert set(result.values()) == {"SUCCESS"}

    def test_node_present_in_the_exported_graph(self):
        module = build_network(SMALL, device="cpu", seed=0).eval()
        weights = {k: t.detach() for k, t in module.state_dict().items()}
        fn = TPUModel.from_module(module, device="cpu").get("modelFn")

        class Forward(torch.nn.Module):
            def forward(self, w, inputs):
                return fn(w, inputs)

        toks = torch.randint(0, SMALL["vocab_size"], (2, 512))
        ep = torch.export.export(Forward(), (weights, {"input": toks}),
                                 strict=False)
        nodes = [n for n in ep.graph.nodes
                 if str(n.target) == "mmlspark_tpu_torch.flash_fwd.default"]
        assert len(nodes) == SMALL["depth"]
        with torch.inference_mode():
            assert torch.equal(ep.module()(weights, {"input": toks}),
                               fn(weights, {"input": toks}))

    def test_training_path_is_unchanged(self):
        """The autograd Function still runs the forward through the op
        and the backward kernels' plain version on the CPU."""
        g = torch.Generator().manual_seed(2)
        q, k, v = (torch.randn(1, 64, 2, 8, generator=g, requires_grad=True)
                   for _ in range(3))
        out = FA.flash_attention(q, k, v, causal=True)
        out.sum().backward()
        want_out, lse = FA.flash_forward_plain(q.detach(), k.detach(),
                                               v.detach(), True)
        dq, dk, dv = FA.flash_backward_plain(
            q.detach(), k.detach(), v.detach(), want_out, lse,
            torch.ones_like(want_out), True)
        assert torch.equal(out.detach(), want_out)
        for got, want in ((q.grad, dq), (k.grad, dk), (v.grad, dv)):
            assert torch.equal(got, want)


class TestKernelLibraries:
    def test_copy_and_adopt_by_source_hash(self, tmp_path, monkeypatch):
        """kernels/ carries a built library under _build's name for it;
        a copy whose name is not the tree's hash is never loaded."""
        fake = tmp_path / "build" / "libflash_fwd-0123456789abcdef.so"
        fake.parent.mkdir()
        fake.write_bytes(b"\x7fELF not a real library")
        monkeypatch.setattr(_build, "library_path", lambda name: fake)
        out = tmp_path / "art"
        out.mkdir()
        assert aot._copy_kernels(str(out), ["flash_fwd", "flash_fwd"]) == \
            {"flash_fwd": fake.name}
        assert (out / "kernels" / fake.name).read_bytes() == \
            fake.read_bytes()
        monkeypatch.undo()
        # the tree's own hash differs from the copy's name: not loaded
        assert not _build.adopt("flash_fwd", out / "kernels" / fake.name)
        assert "flash_fwd" not in _build._LIBS

    def test_adopt_loads_a_library_whose_name_matches(self, monkeypatch):
        path = _build.library_path("bins")
        if not path.exists():
            _build.build_all(["bins"])
        monkeypatch.delitem(_build._LIBS, "bins", raising=False)
        assert _build.adopt("bins", path)
        assert _build._LIBS["bins"]._name == str(path)
        assert not _build.adopt("bins", path)       # loaded already


@pytest.mark.parametrize("mode", ["aot", "trace"])
def test_cold_start_in_a_fresh_process(aot_artifact, mode):
    _, art, _ = aot_artifact
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-m", "mmlspark_tpu_torch.serving.aot",
                        art, "--mode", mode, "--port", "0", "--device",
                        "cpu"], capture_output=True, text=True, timeout=300,
                       cwd=str(REPO), env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["mode"] == mode
    assert out["jit_traces_at_request_time"] == 0
    assert out["jit_traces_total"] == (0 if mode == "aot" else 4)
    assert out["format"] == "torch_export" and out["backend"] == "cpu"
    assert out["cold_start_to_first_200_ms"] >= out["model_ready_ms"] \
        + out["first_request_ms"] - 1
    # the clock starts at the process's start, before any import
    assert out["phases_ms"]["imports"] > 0


def test_loaded_model_class_is_importable_for_codegen():
    """The class load_model builds registers as a stage; codegen's
    generated smoke test imports it from serving/aot.py and passes."""
    from mmlspark_tpu_torch.codegen import generated_smoke_test
    from mmlspark_tpu_torch.core.stage import STAGE_REGISTRY
    from mmlspark_tpu_torch.serving.aot import AOTTPUModel
    assert STAGE_REGISTRY["AOTTPUModel"] is AOTTPUModel
    assert issubclass(AOTTPUModel, TPUModel)
    scope = {}
    exec(generated_smoke_test("AOTTPUModel", AOTTPUModel), scope)
    scope["test_aottpumodel_smoke"]()
    with pytest.raises(AttributeError):
        aot.NoSuchName
