"""PyTorch port: the model zoo (flax msgpack blobs, LocalRepo,
ModelDownloader), the torch checkpoint importers and ImageFeaturizer
against the JAX package, on the CPU.

The scenarios of ``tests/test_downloader_featurizer.py`` and
``tests/test_torchvision_import.py`` run through both packages, and both
flows of ``examples/305_transfer_learning.py`` run on the port at the
example's sizes. The flax variables are drawn from numpy over
``jax.eval_shape`` of the flax module's init (an eager flax init of a
ResNet takes seconds); the ResNet-18 checkpoint is the port's
torch twin (``mmlspark_tpu_torch/testing/torch_models.py``).

Tolerances, stated:
- bitwise: blobs either package publishes, decoded by the other; a blob
  re-encoded by the port (same sha256); the imported flax-layout trees
  of f32 checkpoints (.pth, dict, f32 .safetensors).
- ImageFeaturizer features: rtol 1e-5 and atol 1e-5 of the output's
  scale (its largest magnitude), as ``tests/test_torch_zoo.py`` holds
  f32 forwards; the images are resized on the float path, within 5e-4
  of jax.image.resize on 0-255 (measured: 4e-7 of the scale).
- the imported ResNet-18 against the torch twin: rtol / atol 2e-4, as
  ``tests/test_torchvision_import.py`` holds the flax forward.
"""

import functools
import hashlib
import json
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import msgpack
from flax import serialization

from mmlspark_tpu.core.schema import ImageSchema as JImageSchema
from mmlspark_tpu.core.stage import load_stage as jload_stage
from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.downloader import LocalRepo as JRepo
from mmlspark_tpu.downloader import ModelDownloader as JDownloader
from mmlspark_tpu.importers import torch_import as JI
from mmlspark_tpu.models.networks import build_network as jbuild
from mmlspark_tpu.stages.featurizer import ImageFeaturizer as JFeaturizer
from mmlspark_tpu_torch.testing.torch_models import build_torch_resnet18

import mmlspark_tpu_torch as mtt
from mmlspark_tpu_torch import convert
from mmlspark_tpu_torch.core import flax_msgpack
from mmlspark_tpu_torch.core.metrics import automl_histograms
from mmlspark_tpu_torch.core.schema import ImageSchema
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.downloader import (
    HTTPRepo, LocalRepo, ModelDownloader,
)
from mmlspark_tpu_torch.importers import torch_import as PI
from mmlspark_tpu_torch.stages.featurizer import ImageFeaturizer

SPEC = {"type": "resnet", "stage_sizes": [1, 1, 1], "width": 8,
        "num_classes": 10}
MLP = {"type": "mlp", "features": [4], "num_classes": 2}


def _drawn(shapes, seed=1):
    """Flax variables of the given shapes from a numpy seed: kernels
    normal over their fan-in, BatchNorm scales around 1, running
    variances in [0.5, 2], biases and means around 0."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "var":
            a = rng.uniform(0.5, 2.0, shape)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "kernel":
            a = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            a = 0.1 * rng.normal(size=shape)
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _flax_vars(spec, row_shape, seed=1):
    module = jbuild(spec)
    shapes = jax.eval_shape(functools.partial(module.init, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1,) + row_shape))
    return module, _drawn(shapes, seed)


def _leaves(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_same_tree(got, want):
    g, w = _leaves(got), _leaves(want)
    assert list(g) == list(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _assert_f32_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """The reference fixture's tiny ResNet, published by the JAX package;
    the port downloads it into its own cache."""
    tmp = tmp_path_factory.mktemp("zoo")
    module, variables = _flax_vars(SPEC, (32, 32, 3))
    jrepo = JRepo(str(tmp / "repo"))
    schema = jrepo.publish("ResNet_tiny", SPEC, variables, dataset="CIFAR",
                           model_type="image", input_shape=[32, 32, 3],
                           layer_names=module.feature_layers())
    dl = ModelDownloader(str(tmp / "cache"), repo=LocalRepo(str(tmp / "repo")))
    return {"tmp": tmp, "schema": schema, "dl": dl, "variables": variables,
            "jrepo": jrepo}


def _tables(n=6, hw=(32, 32), seed=0):
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 255, (*hw, 3)).astype(np.uint8) for _ in range(n)]
    jt = JTable({"image": [JImageSchema.make_row(f"img{i}", im, "RGB")
                           for i, im in enumerate(imgs)]})
    pt = DataTable({"image": [ImageSchema.make_row(f"img{i}", im, "RGB")
                              for i, im in enumerate(imgs)]})
    return jt, pt


def _jax_featurizer(zoo, **kw):
    """The JAX package's featurizer of the zoo's model: what its
    ``from_model_schema`` builds, with the weights as published (its
    ``load_variables`` would init the flax module first, for seconds)."""
    return JFeaturizer(networkSpec=SPEC, weights=zoo["variables"],
                       modelName="ResNet_tiny", inputHeight=32,
                       inputWidth=32, inputChannels=3, **kw)


def _port_featurizer(zoo, **kw):
    kw.setdefault("device", "cpu")
    return ImageFeaturizer.from_model_schema(zoo["schema"], zoo["dl"], **kw)


# ---------------------------------------------------------------------------
# flax msgpack blobs across the packages
# ---------------------------------------------------------------------------


def test_jax_blob_decodes_bitwise_and_reencodes_to_the_same_bytes(zoo):
    blob = zoo["jrepo"].read_blob(zoo["schema"])
    dec = flax_msgpack.unpackb(blob)
    _assert_same_tree(dec, serialization.msgpack_restore(blob))
    _assert_same_tree(dec, zoo["variables"])
    again = flax_msgpack.packb(dec)
    assert hashlib.sha256(again).hexdigest() == zoo["schema"].sha256
    # the port's encoder on the JAX package's tree writes flax's bytes
    assert flax_msgpack.packb(zoo["variables"]) == blob


def test_port_blob_loads_in_the_jax_package(zoo, tmp_path):
    repo = LocalRepo(str(tmp_path / "port_repo"))
    schema = repo.publish("ResNet_tiny", SPEC, zoo["variables"],
                          input_shape=[32, 32, 3])
    assert schema.sha256 == zoo["schema"].sha256
    blob = repo.read_blob(schema)
    _assert_same_tree(serialization.from_bytes(zoo["variables"], blob),
                      zoo["variables"])
    # through the JAX package's own downloader (its load_variables inits
    # the flax module; an MLP keeps that cheap)
    mlp_module, mlp_vars = _flax_vars(MLP, (8,))
    repo.publish("mlp", MLP, mlp_vars, input_shape=[8])
    got = JDownloader(str(tmp_path / "jcache"), repo=JRepo(
        str(tmp_path / "port_repo"))).load_variables("mlp")
    _assert_same_tree(got, mlp_vars)


def test_codec_scalars_strings_and_lengths_match_msgpack():
    values = [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33,
              -129, -32769, -2 ** 31 - 1, 1.5, None, True, False, "x" * 31,
              "y" * 32, "z" * 300, "w" * 70000, b"", b"a" * 300,
              b"b" * 70000, list(range(20)), list(range(70000)),
              {str(i): i for i in range(20)}]
    for v in values:
        assert flax_msgpack.packb(v) == msgpack.packb(v, use_bin_type=True)
        assert flax_msgpack.unpackb(msgpack.packb(v, use_bin_type=True)) == v
    scalars = {"f": np.float32(2.5), "i": np.int64(-3)}
    blob = serialization.to_bytes(scalars)
    assert flax_msgpack.packb(flax_msgpack.unpackb(blob)) == blob
    bf16 = {"w": torch.randn(3, 5).to(torch.bfloat16)}
    blob = flax_msgpack.packb(bf16)
    assert torch.equal(flax_msgpack.unpackb(blob)["w"], bf16["w"])
    assert serialization.msgpack_restore(blob)["w"].dtype.name == "bfloat16"
    for bad in (b"\xc1", b"\x92\x01", b"\x01\x02"):
        with pytest.raises(ValueError):
            flax_msgpack.unpackb(bad)
    with pytest.raises(TypeError):
        flax_msgpack.packb({"x": object()})


# ---------------------------------------------------------------------------
# the downloader (test_downloader_featurizer's TestModelDownloader)
# ---------------------------------------------------------------------------


class TestModelDownloader:
    def test_download_and_verify(self, zoo):
        s2 = zoo["dl"].download_by_name("ResNet_tiny")
        assert s2.sha256 == zoo["schema"].sha256
        assert s2.network_spec["type"] == "resnet"
        assert s2.to_json() == {**zoo["schema"].to_json(),
                                "uri": s2.uri}

    def test_cached_fetch_without_repo(self, zoo):
        zoo["dl"].download_by_name("ResNet_tiny")
        dl2 = ModelDownloader(zoo["dl"].local.path, repo=None)
        assert dl2.download_by_name("ResNet_tiny").name == "ResNet_tiny"
        with pytest.raises(KeyError):
            dl2.download_by_name("NoSuchModel")

    def test_unknown_model_raises(self, zoo):
        with pytest.raises(KeyError):
            zoo["dl"].download_by_name("NoSuchModel")

    def test_load_variables_matches_the_jax_packages(self, zoo):
        v = zoo["dl"].load_variables("ResNet_tiny")
        assert set(v) == {"params", "batch_stats"}
        _assert_same_tree(v, zoo["variables"])

    def test_corruption_detected(self, tmp_path):
        repo = LocalRepo(str(tmp_path / "r2"))
        _, variables = _flax_vars(MLP, (8,))
        schema = repo.publish("m", MLP, variables, input_shape=[8])
        with open(repo.blob_path(schema), "r+b") as f:
            f.seek(0)
            f.write(b"corrupted!")
        with pytest.raises(IOError, match="sha256"):
            repo.read_blob(schema)

    def test_mismatched_weights_refused(self, tmp_path):
        repo = LocalRepo(str(tmp_path / "r3"))
        _, variables = _flax_vars(MLP, (8,))
        repo.publish("m", MLP, variables, input_shape=[9])
        with pytest.raises(ValueError, match="shape mismatches"):
            ModelDownloader(str(tmp_path / "c3"), repo=repo
                            ).load_variables("m")

    def test_list_models_and_http_repo(self, zoo, tmp_path):
        """The JAX-published repo lists through LocalRepo, and through
        HTTPRepo over the port's WebDAV server, where a download verifies
        the blob's sha256 as a local one does."""
        from mmlspark_tpu_torch.testing.webdav import serve_webdav
        assert "ResNet_tiny" in [s.name for s in zoo["dl"].list_models()]
        server, base = serve_webdav(str(zoo["tmp"] / "repo"))
        try:
            repo = HTTPRepo(base)
            assert [s.name for s in repo.list_schemas()] == ["ResNet_tiny"]
            dl = ModelDownloader(str(tmp_path / "cache"), repo=repo)
            schema = dl.download_by_name("ResNet_tiny")
            assert schema.sha256 == zoo["schema"].sha256
            assert dl.local.read_blob(schema) == \
                zoo["jrepo"].read_blob(zoo["schema"])
        finally:
            server.shutdown()


# ---------------------------------------------------------------------------
# ImageFeaturizer (test_downloader_featurizer's TestImageFeaturizer and
# TestImageFeaturizerPipeline, against the JAX package)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cut,hw,width", [(1, (32, 32), 32),
                                         (2, (32, 32), 2048),
                                         (0, (32, 32), 10),
                                         (1, (48, 64), 32)])
def test_featurizer_matches_jax(zoo, cut, hw, width):
    jt, pt = _tables(hw=hw)
    want = _jax_featurizer(zoo, cutOutputLayers=cut,
                           batchSize=4).transform(jt)["features"]
    got = _port_featurizer(zoo, cutOutputLayers=cut,
                           batchSize=4).transform(pt)["features"]
    assert got.shape == want.shape == (6, width)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    _assert_f32_close(got, want)


def test_featurizer_schema_and_cut_too_deep(zoo):
    feat = _port_featurizer(zoo)
    _, pt = _tables(2)
    assert "features" in feat.transform_schema(pt.schema).names
    with pytest.raises(TypeError, match="not an image column"):
        feat.transform_schema(DataTable({"image": [1, 2]}).schema)
    with pytest.raises(ValueError, match="feature layers"):
        _port_featurizer(zoo, cutOutputLayers=99).transform(pt)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        feat.set_mesh(None)


def test_featurizer_refuses_the_cpu_unless_asked(zoo, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pt = _tables(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _port_featurizer(zoo, device=None).transform(pt)


def test_featurizer_mixed_sizes_build_once(zoo):
    """Partial batches pad to batchSize: one forward shape, one module
    built and kept on the device across transforms of mixed sizes, and
    both histograms observe every batch."""
    hists = automl_histograms()
    before = {k: hists[k].summary().get("count", 0)
              for k in ("image_resize", "image_forward")}
    feat = _port_featurizer(zoo, batchSize=4)
    feat.transform(_tables(6)[1])
    module = feat._device_module
    assert feat.jit_cache_misses == 1 and module is not None
    batches = 2
    for n in (3, 7, 4, 1, 9):
        out = feat.transform(_tables(n, seed=n)[1])
        assert out["features"].shape[0] == n
        batches += -(-n // 4)
    assert feat.jit_cache_misses == 1
    assert feat._device_module is module
    for k in before:
        assert hists[k].summary()["count"] - before[k] == batches
    feat.set("weights", feat.get("weights"))
    assert feat._device_module is None       # a param change rebuilds
    feat.transform(_tables(2)[1])
    assert feat.jit_cache_misses == 1        # same network, same shape
    feat.set("cutOutputLayers", 2)
    feat.transform(_tables(2)[1])
    assert feat.jit_cache_misses == 2        # another forward


def test_featurizer_partial_batch_matches_single_batch(zoo):
    _, pt = _tables(6, seed=11)
    split = _port_featurizer(zoo, batchSize=4).transform(pt)["features"]
    whole = _port_featurizer(zoo, batchSize=8).transform(pt)["features"]
    _assert_f32_close(split, whole)
    empty = _port_featurizer(zoo, batchSize=4).transform(_tables(0)[1])
    assert empty["features"].shape[0] == 0


def test_featurizer_save_load_across_packages(zoo, tmp_path):
    """A featurizer saved by either package loads in the other and gives
    the same features."""
    jt, pt = _tables(3)
    port = _port_featurizer(zoo, batchSize=4)
    ref = _jax_featurizer(zoo, batchSize=4)
    want = ref.transform(jt)["features"]
    port.save(str(tmp_path / "port"))
    ref.save(str(tmp_path / "ref"))
    again = ImageFeaturizer.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(again.transform(pt)["features"],
                                  port.transform(pt)["features"])
    from_ref = mtt.load_stage(str(tmp_path / "ref"))
    assert isinstance(from_ref, ImageFeaturizer)
    from_ref.set("device", "cpu")
    _assert_f32_close(from_ref.transform(pt)["features"], want)
    from_port = jload_stage(str(tmp_path / "port"))
    assert isinstance(from_port, JFeaturizer)
    _assert_f32_close(from_port.transform(jt)["features"], want)


# ---------------------------------------------------------------------------
# torch checkpoint import (test_torchvision_import's scenarios, and the
# five importers of the JAX package's _IMPORTERS)
# ---------------------------------------------------------------------------


def _write_safetensors(path, tensors, dtype="F32"):
    """Minimal safetensors writer: F32, or BF16 (torch's bits)."""
    header, blobs, off = {}, [], 0
    for name, t in tensors.items():
        if t.dtype == torch.int64:
            raw, dt = t.numpy().tobytes(), "I64"
        elif dtype == "BF16":
            raw = t.to(torch.bfloat16).view(torch.int16).numpy().tobytes()
            dt = "BF16"
        else:
            raw, dt = t.float().numpy().tobytes(), "F32"
        header[name] = {"dtype": dt, "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    hj = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hj)) + hj + b"".join(blobs))


@pytest.fixture(scope="module")
def twin():
    torch.manual_seed(0)
    model = build_torch_resnet18()
    model.train()
    with torch.no_grad():          # non-trivial BatchNorm running stats
        for _ in range(2):
            model(torch.randn(2, 3, 64, 64))
    return model.eval()


def test_torchvision_manifest_and_wrong_checkpoint(twin):
    sd = twin.state_dict()
    manifest = PI._torchvision_manifest([2, 2, 2, 2], 1000)
    assert manifest == JI._torchvision_manifest([2, 2, 2, 2], 1000)
    assert {k: tuple(v.shape) for k, v in sd.items()
            if not k.endswith("num_batches_tracked")} == manifest
    assert PI.TORCHVISION_RESNET18_SPEC == JI.TORCHVISION_RESNET18_SPEC
    bad = dict(sd)
    bad.pop("layer3.0.downsample.0.weight")
    bad["unexpected.weight"] = torch.zeros(3)
    with pytest.raises(ValueError) as e:
        PI.import_torchvision_resnet(bad)
    assert "layer3.0.downsample.0.weight" in str(e.value)
    assert "unexpected.weight" in str(e.value)


def test_torchvision_import_bitwise_across_formats(twin, tmp_path):
    sd = twin.state_dict()
    want = JI.import_torch_checkpoint(sd, JI.TORCHVISION_RESNET18_SPEC)
    pth, sft = str(tmp_path / "r18.pth"), str(tmp_path / "r18.safetensors")
    torch.save(sd, pth)
    _write_safetensors(sft, sd)
    for source in (sd, pth, sft):
        _assert_same_tree(PI.import_torchvision_resnet(source), want)
    # BF16 safetensors: torch's decode equals ml_dtypes', and the import
    # equals the f32 one rounded to bfloat16
    bf = str(tmp_path / "r18_bf16.safetensors")
    _write_safetensors(bf, sd, "BF16")
    a, b = PI.load_safetensors_file(bf), JI.load_safetensors_file(bf)
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    got = _leaves(PI.import_torchvision_resnet(bf))
    for k, w in _leaves(want).items():
        rounded = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got[k], rounded, err_msg=k)


def test_imported_resnet18_matches_the_torch_twin(twin):
    variables = PI.import_torchvision_resnet(twin.state_dict())
    module = convert.module_from_flax(PI.TORCHVISION_RESNET18_SPEC,
                                      variables, device="cpu")
    x = np.random.default_rng(0).normal(size=(2, 224, 224, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = twin(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        got = module(torch.from_numpy(x)).numpy()
        emb = module(torch.from_numpy(x), capture="pool").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert emb.shape == (2, 512)
    head = variables["params"]["head"]
    np.testing.assert_allclose(emb @ head["kernel"] + head["bias"], got,
                               rtol=2e-3, atol=2e-3)


def _state_dicts():
    """(spec, torch state_dict, validate_input_shape) for the other
    families of the JAX package's _IMPORTERS, with its name conventions."""
    g = torch.Generator().manual_seed(3)

    def t(*shape):
        return torch.randn(shape, generator=g)

    resnet = {"type": "resnet", "stage_sizes": [1, 1], "width": 4,
              "num_classes": 3}
    sd_res = {"conv1.weight": t(4, 3, 3, 3)}
    for tag, c in (("bn1", 4),):
        sd_res.update({f"{tag}.weight": t(c), f"{tag}.bias": t(c),
                       f"{tag}.running_mean": t(c),
                       f"{tag}.running_var": t(c).abs() + 0.5})
    for s, (cin, cout) in enumerate(((4, 4), (4, 8))):
        p = f"layer{s + 1}.0"
        sd_res[f"{p}.conv1.weight"] = t(cout, cin, 3, 3)
        sd_res[f"{p}.conv2.weight"] = t(cout, cout, 3, 3)
        bns = ["bn1", "bn2"]
        if s:
            sd_res[f"{p}.downsample.0.weight"] = t(cout, cin, 1, 1)
            bns.append("downsample.1")
        for bn in bns:
            sd_res.update({f"{p}.{bn}.weight": t(cout),
                           f"{p}.{bn}.bias": t(cout),
                           f"{p}.{bn}.running_mean": t(cout),
                           f"{p}.{bn}.running_var": t(cout).abs() + 0.5,
                           f"{p}.{bn}.num_batches_tracked":
                               torch.tensor(3)})
    sd_res.update({"fc.weight": t(3, 8), "fc.bias": t(3)})
    convnet = {"type": "convnet", "conv_features": [4, 8],
               "dense_features": [16], "num_classes": 3}
    sd_conv = {"conv0.weight": t(4, 3, 3, 3), "conv0.bias": t(4),
               "conv1.weight": t(8, 4, 3, 3), "conv1.bias": t(8),
               "dense0.weight": t(16, 8 * 2 * 2), "dense0.bias": t(16),
               "head.weight": t(3, 16), "head.bias": t(3)}
    mlp = {"type": "mlp", "features": [8, 4], "num_classes": 3}
    sd_mlp = {"dense0.weight": t(8, 6), "dense0.bias": t(8),
              "dense1.weight": t(4, 8), "dense1.bias": t(4),
              "head.weight": t(3, 4), "head.bias": t(3)}
    bilstm = {"type": "bilstm", "vocab_size": 20, "embed_dim": 8,
              "hidden": 6, "num_tags": 3}
    sd_lstm = {"embed.weight": t(20, 8), "head.weight": t(3, 12),
               "head.bias": t(3)}
    for sfx in ("", "_reverse"):
        sd_lstm.update({f"lstm.weight_ih_l0{sfx}": t(24, 8),
                        f"lstm.weight_hh_l0{sfx}": t(24, 6),
                        f"lstm.bias_ih_l0{sfx}": t(24),
                        f"lstm.bias_hh_l0{sfx}": t(24)})
    lm = {"type": "transformer", "vocab_size": 50, "dim": 16, "depth": 2,
          "heads": 2, "max_len": 8}
    sd_lm = {"embed.weight": t(50, 16), "pos_embed": t(8, 16),
             "ln_f.weight": t(16), "ln_f.bias": t(16),
             "lm_head.weight": t(50, 16), "lm_head.bias": t(50)}
    for i in range(2):
        for ln in ("ln1", "ln2"):
            sd_lm.update({f"block_{i}.{ln}.weight": t(16),
                          f"block_{i}.{ln}.bias": t(16)})
        for name, (o, n_in) in (("qkv", (48, 16)), ("proj", (16, 16)),
                                ("mlp_up", (64, 16)),
                                ("mlp_down", (16, 64))):
            sd_lm.update({f"block_{i}.{name}.weight": t(o, n_in),
                          f"block_{i}.{name}.bias": t(o)})
    return {"resnet": (resnet, sd_res, [8, 8, 3]),
            "convnet": (convnet, sd_conv, [8, 8, 3]),
            "mlp": (mlp, sd_mlp, [6]),
            "bilstm": (bilstm, sd_lstm, [12]),
            "transformer": (lm, sd_lm, [8])}


@pytest.mark.parametrize("kind", ["resnet", "convnet", "mlp", "bilstm",
                                  "transformer"])
def test_every_importer_matches_the_jax_packages(kind):
    spec, sd, shape = _state_dicts()[kind]
    # the JAX importer itself (its _validate inits a flax module; the
    # port's check is exercised below)
    want = JI._IMPORTERS[kind](sd, spec, True, shape)
    got = PI.import_torch_checkpoint(sd, spec, validate_input_shape=shape)
    _assert_same_tree(got, want)
    convert.module_from_flax(spec, got, device="cpu")   # every leaf lands
    extra = dict(sd, **{"extra.weight": torch.zeros(2)})
    with pytest.raises(ValueError, match="not consumed"):
        PI.import_torch_checkpoint(extra, spec, validate_input_shape=shape)
    if kind in ("mlp", "resnet"):
        with pytest.raises(ValueError, match="shape mismatches"):
            PI.import_torch_checkpoint(
                sd, spec, validate_input_shape=[7] if kind == "mlp"
                else [8, 8, 1])


# ---------------------------------------------------------------------------
# examples/305_transfer_learning.py on the port, at the example's sizes
# ---------------------------------------------------------------------------


def _flowers(n, seed=0):
    """make_images of the example: two classes of 32 x 32 images, pixel
    means 60 and 180."""
    rng = np.random.default_rng(seed)
    rows, labels = [], []
    for i in range(n):
        base = 60 if i % 2 == 0 else 180
        img = np.clip(rng.normal(base, 35, (32, 32, 3)), 0, 255)
        rows.append(ImageSchema.make_row(f"img{i}", img.astype(np.uint8),
                                         "RGB"))
        labels.append(float(i % 2))
    return DataTable({"image": rows, "label": np.asarray(labels)})


def _accuracy(feats, table, **kw):
    head = mtt.TPUBoostClassifier(device="cpu", **kw).fit(feats)
    return float((head.transform(feats)["prediction"]
                  == table["label"]).mean())


def test_example_305_main_on_the_port(tmp_path):
    spec = {"type": "resnet", "stage_sizes": [1, 1, 1], "width": 8,
            "num_classes": 10}
    module, variables = _flax_vars(spec, (32, 32, 3), seed=0)
    repo = LocalRepo(str(tmp_path / "repo"))
    schema = repo.publish("ResNet_backbone", spec, variables,
                          input_shape=[32, 32, 3],
                          layer_names=module.feature_layers())
    downloader = ModelDownloader(str(tmp_path / "cache"), repo=repo)
    table = _flowers(80)
    feats = ImageFeaturizer.from_model_schema(
        schema, downloader, cutOutputLayers=1, device="cpu").transform(table)
    assert feats["features"].shape == (80, 32)
    assert _accuracy(feats, table, numIterations=20, maxBin=32) > 0.9


def test_example_305_imagenet_checkpoint_on_the_port(tmp_path):
    torch.manual_seed(0)
    twin = build_torch_resnet18().eval()
    ckpt = str(tmp_path / "resnet18.pth")
    torch.save(twin.state_dict(), ckpt)
    variables = PI.import_torchvision_resnet(ckpt)
    repo = LocalRepo(str(tmp_path / "repo"))
    schema = repo.publish(
        "ResNet18_ImageNet", PI.TORCHVISION_RESNET18_SPEC, variables,
        dataset="ImageNet", model_type="vision/classification",
        input_shape=[224, 224, 3],
        layer_names=mtt.build_network(PI.TORCHVISION_RESNET18_SPEC,
                                      device="cpu").feature_layers())
    downloader = ModelDownloader(str(tmp_path / "cache"), repo=repo)
    featurizer = ImageFeaturizer.from_model_schema(
        schema, downloader, cutOutputLayers=1, device="cpu")
    table = _flowers(24)
    feats = featurizer.transform(table)
    assert feats["features"].shape == (24, 512)
    assert _accuracy(feats, table, numIterations=15, maxBin=32,
                     minDataInLeaf=2) > 0.9
