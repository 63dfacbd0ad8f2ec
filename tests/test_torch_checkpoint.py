"""PyTorch port: the learner's checkpoint/resume (``checkpointDir``,
``checkpointEvery``, ``resume``) on local and WebDAV directories, held to
the JAX learner's layout and tree: a checkpoint written by either
package resumes in the other.

Within the port an interrupted fit resumed from its checkpoint equals
the uninterrupted fit bit for bit (losses and weights), with both feeds
and every optimizer; across the packages, the next steps' losses agree
within rtol 1e-5 (the two learners' arithmetic, as in
``tests/test_torch_learner.py``). Mirrors ``tests/test_learner.py``'s
resume and corrupt-checkpoint tests and ``tests/test_remote_fs.py``'s
remote ones.
"""

import json
import os
import shutil
import urllib.error

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.models.learner import TPULearner as JLearner
from mmlspark_tpu.testing.datagen import generate_classification_table

import mmlspark_tpu_torch as mtt
from mmlspark_tpu_torch.models import learner as PLM
from mmlspark_tpu_torch.models.learner import TPULearner
from mmlspark_tpu_torch.testing.webdav import serve_webdav

MLP = {"type": "mlp", "features": [16], "num_classes": 4}


def _toy(n=256, seed=4):
    jt = generate_classification_table(n, 16, 4, seed=seed)
    x = np.asarray(jt["features"], np.float32)
    y = np.asarray(jt["label"]).astype(np.int64)
    return x, y


def _learner(pkg="port", **kw):
    common = dict(networkSpec=MLP, batchSize=64, learningRate=0.05,
                  computeDtype="float32", schedule="constant", seed=9,
                  logEvery=1)
    common.update(kw)
    if pkg == "port":
        return TPULearner(device="cpu", **common)
    return JLearner(**common)


def _fit(learner, x, y, pkg="port"):
    t = (mtt.DataTable if pkg == "port" else JTable)(
        {"features": x, "label": y})
    return learner.fit(t)


def _losses(learner):
    return [h["loss"] for h in learner.history]


@pytest.fixture()
def dav(tmp_path):
    server, base = serve_webdav(str(tmp_path / "store"))
    yield base
    server.shutdown()
    server.server_close()


# ---------------------------------------------------------------------------
# interrupted versus uninterrupted, within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optimizer,feed", [
    ("sgd", "host"), ("momentum", "device"), ("adam", "host"),
    ("adamw", "device")])
def test_interrupted_fit_equals_the_full_fit_bitwise(tmp_path, optimizer,
                                                     feed):
    """tests/test_learner.py::test_checkpoint_resume's crash simulation:
    2 of 4 epochs, then a resume with the full budget; the resumed fit's
    losses and weights equal the uninterrupted fit's bit for bit."""
    x, y = _toy()
    kw = dict(optimizer=optimizer, dataFeed=feed, epochs=4,
              checkpointEvery=4)
    full = _learner(**kw)
    wf = _fit(full, x, y).get("weights")
    ck = str(tmp_path / "ckpt")
    _fit(_learner(**{**kw, "epochs": 2}, checkpointDir=ck), x, y)
    resumed = _learner(**kw, checkpointDir=ck)
    wr = _fit(resumed, x, y).get("weights")
    assert min(h["step"] for h in resumed.history) == 9
    assert _losses(resumed) == _losses(full)[8:]
    for k in wf:
        assert torch.equal(wf[k], wr[k]), k
    assert sorted(os.listdir(ck)) == ["step_00000008", "step_00000012",
                                      "step_00000016"]


def test_interrupted_mid_epoch_with_dropout_and_cosine(tmp_path):
    """A checkpoint inside an epoch: the resumed fit draws the skipped
    batches' permutation, the same dropout bits and the same cosine
    learning rates (the total step count is the same in both runs)."""
    x, y = _toy()
    kw = dict(networkSpec=dict(MLP, dropout=0.3), optimizer="adamw",
              schedule="cosine", epochs=2, checkpointEvery=3)
    full = _learner(**kw)
    wf = _fit(full, x, y).get("weights")
    ck = str(tmp_path / "ck")
    first = _learner(**kw, checkpointDir=ck)
    _fit(first, x, y)
    # drop the checkpoints after step 3: the next fit resumes mid-epoch 0
    for d in ("step_00000006", "step_00000008"):
        shutil.rmtree(os.path.join(ck, d))
    resumed = _learner(**kw, checkpointDir=ck)
    wr = _fit(resumed, x, y).get("weights")
    assert _losses(resumed) == _losses(full)[3:]
    for k in wf:
        assert torch.equal(wf[k], wr[k]), k


def test_interrupted_fit_on_webdav(dav):
    """The same on a webdav:// directory: PUTs, the 3 newest kept
    remotely, treedef.json marking each complete."""
    x, y = _toy()
    kw = dict(optimizer="adamw", epochs=4, checkpointEvery=2)
    full = _learner(**kw)
    wf = _fit(full, x, y).get("weights")
    ck = f"{dav}/runs/ckpt"
    _fit(_learner(**{**kw, "epochs": 2}, checkpointDir=ck), x, y)
    assert PLM._checkpoint_candidates(ck)[0] == f"{ck}/step_00000008"
    resumed = _learner(**kw, checkpointDir=ck)
    wr = _fit(resumed, x, y).get("weights")
    assert _losses(resumed) == _losses(full)[8:]
    for k in wf:
        assert torch.equal(wf[k], wr[k]), k
    assert PLM._remote_steps(ck) == ["step_00000012", "step_00000014",
                                     "step_00000016"]


# ---------------------------------------------------------------------------
# corrupt checkpoints and store outages
# ---------------------------------------------------------------------------

def test_corrupt_checkpoint_falls_back_to_previous(tmp_path):
    x, y = _toy()
    ck = str(tmp_path / "ckpt")
    kw = dict(epochs=2, checkpointEvery=4, checkpointDir=ck)
    _fit(_learner(**kw), x, y)                   # 8 steps: ckpts @ 4, 8
    newest = os.path.join(ck, "step_00000008", "leaves.npz")
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    resumed = _learner(**{**kw, "epochs": 4})
    assert _fit(resumed, x, y) is not None       # no raise
    assert min(h["step"] for h in resumed.history) == 5
    # every checkpoint corrupt: a fresh init, from step 1
    for d in os.listdir(ck):
        with open(os.path.join(ck, d, "leaves.npz"), "wb") as f:
            f.write(b"not-an-npz")
    fresh = _learner(**{**kw, "epochs": 1})
    _fit(fresh, x, y)
    assert min(h["step"] for h in fresh.history) == 1


def test_checkpoint_of_another_optimizer_falls_back(tmp_path):
    """A tree that does not fit the learner (a momentum checkpoint read
    by an adamw fit) is a bad checkpoint: fresh init, fit intact."""
    x, y = _toy()
    ck = str(tmp_path / "ck")
    _fit(_learner(optimizer="momentum", epochs=1, checkpointDir=ck), x, y)
    other = _learner(optimizer="adamw", epochs=1, checkpointDir=ck)
    full = _learner(optimizer="adamw", epochs=1)
    _fit(other, x, y)
    _fit(full, x, y)
    assert _losses(other) == _losses(full)


def test_corrupt_remote_checkpoint_falls_back_to_fresh_init(dav):
    from mmlspark_tpu_torch.utils.filesystem import write_bytes
    x, y = _toy(n=64)
    ck = f"{dav}/bad"
    write_bytes(f"{ck}/step_00000004/leaves.npz", b"not-an-npz")
    write_bytes(f"{ck}/step_00000004/treedef.json", b"{}")
    learner = _learner(epochs=1, batchSize=16, checkpointDir=ck)
    assert _fit(learner, x, y) is not None
    assert min(h["step"] for h in learner.history) == 1


def test_an_oserror_propagates(tmp_path, monkeypatch):
    """A store outage is not corruption: an OSError while loading, or
    while listing a remote directory, fails the fit."""
    x, y = _toy(n=64)
    ck = str(tmp_path / "ck")
    _fit(_learner(epochs=1, batchSize=16, checkpointDir=ck), x, y)

    def outage(path):
        raise ConnectionResetError("store unreachable")
    monkeypatch.setattr(PLM, "_load_checkpoint_pytree", outage)
    with pytest.raises(ConnectionResetError):
        _fit(_learner(epochs=2, batchSize=16, checkpointDir=ck), x, y)
    monkeypatch.undo()
    with pytest.raises(urllib.error.URLError):
        _fit(_learner(epochs=1, batchSize=16,
                      checkpointDir="webdav://127.0.0.1:1/ck"), x, y)


def test_resume_false_ignores_checkpoints(tmp_path):
    x, y = _toy(n=64)
    ck = str(tmp_path / "ck")
    _fit(_learner(epochs=1, batchSize=16, checkpointDir=ck), x, y)
    again = _learner(epochs=1, batchSize=16, checkpointDir=ck,
                     resume=False)
    _fit(again, x, y)
    assert min(h["step"] for h in again.history) == 1


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------

def _skeleton(path):
    with open(os.path.join(path, "treedef.json")) as f:
        meta = json.load(f)
    z = np.load(os.path.join(path, "leaves.npz"))
    return meta, [(z[f"leaf_{i}"].shape, z[f"leaf_{i}"].dtype.str)
                  for i in range(meta["n"])]


@pytest.mark.parametrize("optimizer,schedule", [
    ("adamw", "cosine"), ("adam", "constant"), ("momentum", "cosine"),
    ("sgd", "constant")])
def test_layout_equals_the_jax_learners(tmp_path, optimizer, schedule):
    """The same fit in both packages writes the same treedef.json and
    leaves of the same shapes and dtypes, in the same order."""
    x, y = _toy(n=64)
    kw = dict(optimizer=optimizer, schedule=schedule, epochs=1,
              batchSize=16, checkpointEvery=2)
    _fit(_learner(**kw, checkpointDir=str(tmp_path / "p")), x, y)
    _fit(_learner("jax", **kw, checkpointDir=str(tmp_path / "j")), x, y,
         "jax")
    assert sorted(os.listdir(tmp_path / "p")) == \
        sorted(os.listdir(tmp_path / "j"))
    for step in os.listdir(tmp_path / "p"):
        assert _skeleton(str(tmp_path / "p" / step)) == \
            _skeleton(str(tmp_path / "j" / step))


@pytest.mark.parametrize("optimizer,schedule", [
    ("adamw", "constant"), ("momentum", "cosine"), ("adam", "cosine")])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_resume_across_packages(tmp_path, direction, optimizer,
                                            schedule):
    """A checkpoint written by one package after 1 epoch resumes in the
    other; its next 4 steps' losses agree with the writer's own resumed
    fit within rtol 1e-5, and its weights within atol 1e-5."""
    x, y = _toy()
    # a small step, so the losses stay far from 0 over the 8 steps
    kw = dict(optimizer=optimizer, schedule=schedule, checkpointEvery=4,
              learningRate=0.005)
    writer, reader = (("jax", "port") if direction == "jax_to_port"
                      else ("port", "jax"))
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _fit(_learner(writer, epochs=1, checkpointDir=a, **kw), x, y, writer)
    shutil.copytree(a, b)
    own = _learner(writer, epochs=2, checkpointDir=a, **kw)
    own_model = _fit(own, x, y, writer)
    other = _learner(reader, epochs=2, checkpointDir=b, **kw)
    other_model = _fit(other, x, y, reader)
    assert [h["step"] for h in other.history] == \
        [h["step"] for h in own.history] == list(range(5, 9))
    np.testing.assert_allclose(_losses(other), _losses(own), rtol=1e-5)
    probe = x[:32]
    s_own = np.asarray(own_model.transform(
        (mtt.DataTable if writer == "port" else JTable)(
            {"features": probe}))["scores"])
    s_other = np.asarray(other_model.transform(
        (mtt.DataTable if reader == "port" else JTable)(
            {"features": probe}))["scores"])
    np.testing.assert_allclose(s_other, s_own, rtol=1e-4, atol=1e-5)


def test_batchnorm_state_resumes_across_packages(tmp_path):
    """A ResNet's BatchNorm running statistics ride in batch_stats: a
    JAX-written checkpoint resumes in the port with the JAX fit's
    statistics, and the next steps' losses agree."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(32, 8 * 8 * 3)).astype(np.float32)
    y = rng.integers(0, 2, 32).astype(np.int64)
    spec = {"type": "resnet", "stage_sizes": [1], "width": 4,
            "num_classes": 2}
    kw = dict(networkSpec=spec, inputShape=[8, 8, 3], optimizer="adamw",
              batchSize=8, checkpointEvery=4, learningRate=0.01)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _fit(_learner("jax", epochs=1, checkpointDir=a, **kw), x, y, "jax")
    shutil.copytree(a, b)
    own = _learner("jax", epochs=2, checkpointDir=a, **kw)
    _fit(own, x, y, "jax")
    other = _learner(epochs=2, checkpointDir=b, **kw)
    _fit(other, x, y)
    np.testing.assert_allclose(_losses(other), _losses(own), rtol=1e-5)
