"""PyTorch port: the flows of three of the JAX package's examples, run over
the port on the CPU.

- ``examples/301_pretrained_inference.py``: a ResNet trained in torch
  (weights the framework did not produce) imported to the flax layout,
  published to the model zoo, downloaded sha256-verified and run over an
  image table by ``ImageFeaturizer``, its logits held to torch's own.
- ``examples/serving.py``: a fitted forest behind an HTTP endpoint, every
  reply held to ``transform``; a malformed request gets its own 500 and
  the server stays up.
- ``examples/remote_storage.py``: training with ``checkpointDir`` on a
  WebDAV store and resuming from the remote step, a remote zoo publish
  fetched back verified, binary files read off the store.
"""

import json
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import torch.nn as tnn

from mmlspark_tpu_torch.core import flax_msgpack
from mmlspark_tpu_torch.core.schema import ImageSchema
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.downloader import HTTPRepo, LocalRepo, ModelDownloader
from mmlspark_tpu_torch.gbdt import TPUBoostClassifier
from mmlspark_tpu_torch.importers import import_torch_checkpoint
from mmlspark_tpu_torch.io.binary import read_binary_files
from mmlspark_tpu_torch.models import learner as PLM
from mmlspark_tpu_torch.models.learner import TPULearner
from mmlspark_tpu_torch.models.networks import build_network
from mmlspark_tpu_torch.serving.server import serve_model
from mmlspark_tpu_torch.stages.basic import Lambda
from mmlspark_tpu_torch.stages.featurizer import ImageFeaturizer
from mmlspark_tpu_torch.testing.webdav import serve_webdav
from mmlspark_tpu_torch.utils.filesystem import write_bytes

SPEC = {"type": "resnet", "stage_sizes": [1, 1, 1], "width": 16,
        "num_classes": 10}


class _TorchBlock(tnn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(cout)
        self.conv2 = tnn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = tnn.Sequential(
                tnn.Conv2d(cin, cout, 1, stride, bias=False),
                tnn.BatchNorm2d(cout))

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(idt + self.bn2(self.conv2(y)))


class _TorchResNet(tnn.Module):
    """torchvision-style naming, as the example's, so the importer maps
    it directly."""

    def __init__(self, width=16, classes=10):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, width, 3, 1, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(width)
        self.layer1 = tnn.Sequential(_TorchBlock(width, width, 1))
        self.layer2 = tnn.Sequential(_TorchBlock(width, width * 2, 2))
        self.layer3 = tnn.Sequential(_TorchBlock(width * 2, width * 4, 2))
        self.fc = tnn.Linear(width * 4, classes)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.fc(x.mean(dim=(2, 3)))


def test_example_301_pretrained_inference_on_the_port(tmp_path):
    torch.manual_seed(0)
    tmodel = _TorchResNet()
    xb = torch.randn(64, 3, 32, 32)
    yb = torch.randint(0, 10, (64,))
    opt = torch.optim.SGD(tmodel.parameters(), lr=0.05)
    for _ in range(5):
        opt.zero_grad()
        tnn.functional.cross_entropy(tmodel(xb), yb).backward()
        opt.step()
    tmodel.eval()

    variables = import_torch_checkpoint(
        tmodel.state_dict(), SPEC, validate_input_shape=[32, 32, 3])
    repo = LocalRepo(str(tmp_path / "repo"))
    schema = repo.publish(
        "ResNet_pretrained", SPEC, variables, dataset="CIFAR",
        model_type="image", input_shape=[32, 32, 3],
        layer_names=build_network(SPEC, device="cpu").feature_layers())
    downloader = ModelDownloader(str(tmp_path / "cache"), repo=repo)
    rng = np.random.default_rng(0)
    rows = [ImageSchema.make_row(
        f"img{i}", rng.integers(0, 255, (32, 32, 3)).astype(np.uint8),
        "RGB") for i in range(16)]
    table = DataTable({"image": rows})
    model = ImageFeaturizer.from_model_schema(
        schema, downloader, cutOutputLayers=0, outputCol="scores",
        device="cpu")
    out = model.transform(table)
    assert np.asarray(out["scores"]).shape == (16, 10)

    xs = np.stack([r[ImageSchema.DATA] for r in rows]).astype(np.float32)
    with torch.no_grad():
        ref = tmodel(torch.tensor(xs).permute(0, 3, 1, 2) / 255.0).numpy()
    np.testing.assert_allclose(out["scores"], ref, rtol=1e-3, atol=1e-4)


def _post(address, body: bytes):
    req = urllib.request.Request(address, data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_example_serving_on_the_port():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 4))
    y = (X[:, 0] + X[:, 1] > 0).astype(float)
    model = TPUBoostClassifier(numIterations=20, maxBin=32, device="cpu"
                               ).fit(DataTable({"features": X, "label": y}))

    def handle(table):
        feats = np.stack([
            np.asarray(json.loads(r["entity"].decode())["features"],
                       dtype=np.float64)
            for r in table["request"]])
        scored = model.transform(DataTable({"features": feats}))
        return table.with_column("reply", [
            {"probability": float(p[1])} for p in scored["probability"]])

    engine = serve_model(Lambda.apply(handle), port=0, batch_size=32)
    try:
        cases = ([2.0, 2.0, 0.0, 0.0], [-2.0, -2.0, 0.0, 0.0])
        replies = [_post(engine.source.address,
                         json.dumps({"features": f}).encode())
                   for f in cases]
        want = model.transform(DataTable(
            {"features": np.asarray(cases)}))["probability"][:, 1]
        assert [r["probability"] for r in replies] == [float(p)
                                                       for p in want]
        assert want[0] > 0.5 > want[1]
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(engine.source.address, b"not json")
        assert err.value.code == 500
        # the server is still up after the poison request
        assert _post(engine.source.address,
                     json.dumps({"features": cases[0]}).encode()) \
            == replies[0]
        deadline = time.time() + 10
        while engine.source.requests_answered < 4 \
                and time.time() < deadline:
            time.sleep(0.01)
        assert engine.source.requests_answered == 4
    finally:
        engine.stop()


def test_example_remote_storage_on_the_port():
    store = tempfile.mkdtemp(prefix="remote_store_")
    server, base = serve_webdav(store)
    try:
        # 1) checkpoint / resume over the remote scheme
        rng = np.random.default_rng(0)
        x = rng.normal(size=(128, 8)).astype(np.float32)
        y = (x[:, 0] - x[:, 3] > 0).astype(np.int64)
        table = DataTable({"features": x, "label": y})
        ck = f"{base}/run1/ckpt"

        def learner(epochs):
            return TPULearner(
                networkSpec={"type": "mlp", "features": [16],
                             "num_classes": 2},
                epochs=epochs, batchSize=32, learningRate=0.1,
                computeDtype="float32", logEvery=1000, device="cpu",
                checkpointDir=ck, checkpointEvery=4, resume=True)

        learner(2).fit(table)
        latest = PLM._checkpoint_candidates(ck)[0]
        assert latest.startswith("webdav://"), latest
        assert int(latest.rsplit("step_", 1)[1]) == 8
        model = learner(5).fit(table)              # resumes, continues
        acc = (np.asarray(model.transform(table)["scores"]).argmax(-1)
               == y).mean()
        assert acc > 0.85, acc

        # 2) remote zoo publish + verified fetch
        blob = flax_msgpack.packb(
            {k: v.detach().numpy() for k, v in model.get("weights").items()})
        schema = HTTPRepo(f"{base}/zoo").publish(
            "mlp_parity", {"type": "mlp", "features": [16],
                           "num_classes": 2},
            blob=blob, model_type="classification")
        cache = tempfile.mkdtemp(prefix="zoo_cache_")
        fetched = ModelDownloader(
            local_path=cache, repo=HTTPRepo(f"{base}/zoo")
        ).download_by_name("mlp_parity")
        assert ModelDownloader(local_path=cache).local.read_blob(
            fetched) == blob
        assert fetched.sha256 == schema.sha256

        # 3) binary reads off the remote store
        for i in range(3):
            write_bytes(f"{base}/blobs/part-{i}.bin", bytes([i]) * 64)
        blobs = read_binary_files(f"{base}/blobs", pattern="*.bin")
        assert blobs.num_rows == 3
    finally:
        server.shutdown()
        server.server_close()
