"""PyTorch port: DNN training (``TPULearner``) against the JAX package, on
the CPU.

The JAX learner builds its initial weights as ``module.init(PRNGKey(seed),
sample, train=False)``; the test builds the same flax variables and hands
``convert.module_from_flax`` of them to the port's learner through
``moduleFactory``. Both learners then train on the same numpy table with
the host feed (the same ``default_rng(seed)`` batch order, the same
masked final batch), and every logged loss, the final weights and the
returned model's ``transform`` are compared. The Transformer runs at
L = 512, so the port's attention takes the flash route: its plain forward
and plain backward on the CPU. The schedule and optimizers are pinned
against optax step by step.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.models.learner import TPULearner as JLearner
from mmlspark_tpu.models.learner import make_optimizer as jmake_optimizer
from mmlspark_tpu.models.networks import build_network as jbuild
from mmlspark_tpu.parallel import mesh as jmesh

import mmlspark_tpu_torch as mtt
from mmlspark_tpu_torch import convert
from mmlspark_tpu_torch.models import learner as L
from mmlspark_tpu_torch.models.networks import MLP
from mmlspark_tpu_torch.ops import flash_attention as FA

REPO = Path(__file__).resolve().parent.parent
MLP_SPEC = {"type": "mlp", "features": [16, 8], "num_classes": 3}
MSE_SPEC = {"type": "mlp", "features": [16, 8], "num_classes": 1}
LM_SPEC = {"type": "transformer", "vocab_size": 64, "dim": 32, "depth": 2,
           "heads": 4, "max_len": 512}
OPTIMIZERS = ["sgd", "momentum", "adam", "adamw"]
LR = {"sgd": 0.1, "momentum": 0.05, "adam": 0.01, "adamw": 0.01}


# ---------------------------------------------------------------------------
# schedules and optimizers against optax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule,warmup", [
    ("constant", 0), ("constant", 5), ("cosine", 0), ("cosine", 4),
    ("cosine", 25)])
def test_lr_schedule_matches_optax(schedule, warmup):
    """The JAX learner's optax transform, read off its sgd updates of a
    unit gradient, against ``lr_at`` over 20 steps: the default cosine
    schedule takes its first step at lr 0, as optax evaluates the
    schedule at the count before the update."""
    lr, total = 0.3, 20
    tx = jmake_optimizer("sgd", lr, schedule=schedule, warmup_steps=warmup,
                         total_steps=total)
    params = {"w": jnp.zeros(())}
    state = tx.init(params)
    lr_at = L.lr_schedule(lr, schedule, warmup, total)
    for step in range(total):
        upd, state = tx.update({"w": jnp.ones(())}, state, params)
        # optax computes in float32: a few float32 ulps of lr apart
        np.testing.assert_allclose(lr_at(step), -float(upd["w"]),
                                   rtol=1e-6, atol=4 * 2 ** -24 * lr,
                                   err_msg=str(step))
    if schedule == "cosine" and warmup == 0:
        assert lr_at(0) == 0.0 and lr_at(1) == lr


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_steps_match_optax(name):
    """Four steps of each optimizer on the same gradients (including a
    leaf whose gradient is exactly zero): the Nesterov trace, Adam's bias
    correction and AdamW's decay of every leaf, under a warmup schedule."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": np.zeros(3, np.float32) if i == 1 else
              rng.normal(size=(3,)).astype(np.float32)} for i in range(4)]
    kw = dict(momentum=0.9, weight_decay=0.1, schedule="constant",
              warmup_steps=2, total_steps=4)
    tx = jmake_optimizer(name, 0.05, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt, lr_at = L.make_optimizer(name, tp.values(), 0.05, **kw)
    # optax takes Adam's bias corrections 1 - b**t in float32, which
    # cancels (2**-24 / (1 - 0.999**2) = 3e-5 of an update at t = 2);
    # torch takes them in float64: updates agree to 1e-4 of lr
    atol = 1e-4 * 0.05 if name.startswith("adam") else 1e-7
    for step, g in enumerate(grads):
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for group in opt.param_groups:
            group["lr"] = lr_at(step)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=atol, err_msg=f"{k} {step}")


def test_unknown_optimizer_and_schedule_raise():
    with pytest.raises(ValueError, match="optimizer"):
        L.make_optimizer("lamb", [torch.nn.Parameter(torch.zeros(1))], 0.1)
    with pytest.raises(ValueError, match="schedule"):
        L.lr_schedule(0.1, "step")


# ---------------------------------------------------------------------------
# full parity with the JAX learner
# ---------------------------------------------------------------------------


def _mlp_table(n=70, seed=0, mse=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    logits = x[:, :3] + 0.5 * x[:, 3:6]
    y = (logits.sum(1).astype(np.float32) if mse
         else logits.argmax(1).astype(np.int64))
    return {"features": x, "label": y}


def _lm_table(n=6, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, LM_SPEC["vocab_size"], size=(n, 512)).astype(np.float32)
    return {"features": toks,
            "label": np.roll(toks.astype(np.int64), -1, axis=1)}


def _fit_both(spec, cols, loss, optimizer, batch, epochs, seed=3, **kw):
    """The JAX learner and the port's on the same table and initial
    weights; returns (jax learner, jax model, port learner, port model)."""
    common = dict(loss=loss, optimizer=optimizer,
                  learningRate=LR[optimizer], batchSize=batch,
                  epochs=epochs, seed=seed, computeDtype="float32",
                  logEvery=1, **kw)
    jl = JLearner(networkSpec=spec, **common)
    jl.set_mesh(jmesh.single_device_mesh())
    jm = jl.fit(JTable(cols))
    sample = jnp.asarray(cols["features"][:1])
    if spec["type"] == "transformer":
        sample = sample.astype(jnp.int32)
    variables = jbuild(spec).init(jax.random.PRNGKey(seed), sample,
                                  train=False)
    tl = mtt.TPULearner(
        moduleFactory=lambda: convert.module_from_flax(spec, variables,
                                                       device="cpu"),
        device="cpu", **common)
    tm = tl.fit(mtt.DataTable(cols))
    return jl, jm, tl, tm


# Tolerances, stated: the two learners take the same steps on the same
# batches, so they differ only by float32 rounding in other summation
# orders (XLA vs torch kernels), ~1e-7 relative per operation, growing
# over the steps. Losses and weights under sgd / momentum: rtol 1e-5
# (measured: 4e-7). Under adam / adamw, rtol 1e-4 / atol 1e-5 (measured:
# 8e-5 relative on the smallest weights), because optax takes the bias
# corrections 1 - b**t in float32 (see test_optimizer_steps_match_optax),
# with one exception. Each update is m / (sqrt(v) + eps), so for a weight
# whose gradient is pure rounding noise the normalisation turns a 1e-7
# difference into an O(lr) one. The attention's key bias is such a
# weight: softmax is invariant to it, so its exact gradient is 0. It is
# held to the bound that holds there, lr per step (measured: 0.002 after
# 4 steps at lr 0.01).
def _assert_weights_close(spec, jm, tm, optimizer, steps):
    ref = convert.module_from_flax(spec, jm.get("weights"), device="cpu")
    ref = ref.state_dict()
    got = tm.get("weights")
    assert set(got) == set(ref)
    adam = optimizer.startswith("adam")
    for name in ref:
        a, b = got[name].numpy(), ref[name].numpy()
        if adam and name.endswith("qkv.bias"):
            dim = spec["dim"]
            np.testing.assert_array_less(
                np.abs(a[dim:2 * dim] - b[dim:2 * dim]),
                LR[optimizer] * steps)
            a = np.concatenate([a[:dim], a[2 * dim:]])
            b = np.concatenate([b[:dim], b[2 * dim:]])
        np.testing.assert_allclose(a, b, rtol=1e-4 if adam else 1e-5,
                                   atol=1e-5 if adam else 1e-6,
                                   err_msg=name)


def _assert_losses_close(jl, tl, optimizer):
    assert [h["step"] for h in tl.history] == [h["step"] for h in jl.history]
    assert [h["epoch"] for h in tl.history] == \
        [h["epoch"] for h in jl.history]
    rtol = 1e-5 if optimizer in ("sgd", "momentum") else 1e-4
    np.testing.assert_allclose([h["loss"] for h in tl.history],
                               [h["loss"] for h in jl.history], rtol=rtol)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("loss", ["cross_entropy", "mse"])
def test_mlp_training_matches_jax(loss, optimizer):
    """70 rows in batches of 16 (the fifth masked: 6 real rows), 3 epochs,
    the default cosine schedule."""
    spec = MSE_SPEC if loss == "mse" else MLP_SPEC
    cols = _mlp_table(mse=loss == "mse")
    jl, jm, tl, tm = _fit_both(spec, cols, loss, optimizer, batch=16,
                               epochs=3)
    assert len(tl.history) == 15
    _assert_losses_close(jl, tl, optimizer)
    _assert_weights_close(spec, jm, tm, optimizer, steps=15)
    got = tm.transform(mtt.DataTable(cols))["scores"]
    want = np.asarray(jm.transform(JTable(cols))["scores"])
    assert got.shape == want.shape
    tol = 1e-4 if optimizer in ("sgd", "momentum") else 1e-3
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_transformer_training_matches_jax(optimizer):
    """Token cross-entropy at L = 512 (the port's flash route and its plain
    backward), 6 rows in batches of 4 (the second masked), 2 epochs."""
    cols = _lm_table()
    FA.reset_launches()
    jl, jm, tl, tm = _fit_both(LM_SPEC, cols, "token_cross_entropy",
                               optimizer, batch=4, epochs=2)
    assert sum(FA.LAUNCHES.values()) == 0       # plain versions on the CPU
    assert len(tl.history) == 4
    _assert_losses_close(jl, tl, optimizer)
    _assert_weights_close(LM_SPEC, jm, tm, optimizer, steps=4)
    got = tm.transform(mtt.DataTable(cols))["scores"]
    want = np.asarray(jm.transform(JTable(cols))["scores"])
    assert got.shape == want.shape == (6, 512, 64)
    tol = 1e-4 if optimizer in ("sgd", "momentum") else 1e-3
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_shard_stream_training_matches_jax():
    """A sequence of DataTable shards: shuffled within shards, remainder
    rows carried across shard boundaries, in the JAX learner's order."""
    cols = _mlp_table(n=50, seed=4)
    parts = [slice(0, 23), slice(23, 41), slice(41, 50)]
    jshards = [JTable({k: v[s] for k, v in cols.items()}) for s in parts]
    tshards = [mtt.DataTable({k: v[s] for k, v in cols.items()})
               for s in parts]
    common = dict(optimizer="sgd", learningRate=0.1, batchSize=8, epochs=2,
                  seed=1, computeDtype="float32", logEvery=1)
    jl = JLearner(networkSpec=MLP_SPEC, **common)
    jl.set_mesh(jmesh.single_device_mesh())
    jl.fit(jshards)
    variables = jbuild(MLP_SPEC).init(
        jax.random.PRNGKey(1), jnp.asarray(cols["features"][:1]),
        train=False)
    tl = mtt.TPULearner(moduleFactory=lambda: convert.module_from_flax(
        MLP_SPEC, variables, device="cpu"), device="cpu", **common)
    tl.fit(tshards)
    assert len(tl.history) == len(jl.history) == 14
    np.testing.assert_allclose([h["loss"] for h in tl.history],
                               [h["loss"] for h in jl.history], rtol=1e-5)
    with pytest.raises(ValueError, match="one-shot"):
        tl.fit(iter(tshards))
    with pytest.raises(ValueError, match="dataFeed='device'"):
        mtt.TPULearner(networkSpec=dict(MLP_SPEC, in_features=12),
                       dataFeed="device", device="cpu").fit(tshards)


# ---------------------------------------------------------------------------
# the port's own behaviour
# ---------------------------------------------------------------------------


def _mlp_learner(**kw):
    args = dict(networkSpec=dict(MLP_SPEC, features=[32], in_features=12),
                epochs=8, batchSize=32, learningRate=0.05,
                computeDtype="float32", logEvery=1, device="cpu")
    args.update(kw)
    return mtt.TPULearner(**args)


def test_device_feed_learns_as_well_as_host_feed():
    cols = _mlp_table(n=300, seed=5)
    table = mtt.DataTable(cols)
    acc, ce = {}, {}
    for feed in ("host", "device"):
        learner = _mlp_learner(dataFeed=feed)
        model = learner.fit(table)
        scores = torch.from_numpy(model.transform(table)["scores"])
        acc[feed] = float(np.mean(scores.argmax(1).numpy() == cols["label"]))
        ce[feed] = float(torch.nn.functional.cross_entropy(
            scores, torch.from_numpy(cols["label"])))
        assert len(learner.history) == 80
        assert learner.timing["steps_timed"] == 79
        assert learner.timing["examples_per_sec"] > 0
    assert acc["host"] > 0.9 and acc["device"] > 0.9
    assert abs(acc["host"] - acc["device"]) < 0.05
    # the whole table's loss after training: another batch order, the
    # same quality
    assert abs(ce["device"] - ce["host"]) < 0.25 * ce["host"]


def test_masked_final_batch_weighs_real_rows_only():
    """20 rows in batches of 16 at lr 0: the second step's loss is the
    mean over its 4 real rows of the initial module's loss, not over the
    12 edge-padded copies as well."""
    cols = _mlp_table(n=20, seed=6)
    learner = _mlp_learner(optimizer="sgd", schedule="constant",
                           learningRate=0.0, epochs=1, batchSize=16, seed=2)
    module = mtt.build_network(learner.get("networkSpec"), device="cpu",
                               seed=2)
    learner.set("moduleFactory", lambda: module)
    init = {k: v.clone() for k, v in module.state_dict().items()}
    learner.fit(mtt.DataTable(cols))
    order = np.random.default_rng(2).permutation(20)
    module.load_state_dict(init)
    with torch.no_grad():
        ce = torch.nn.functional.cross_entropy(
            module(torch.from_numpy(cols["features"])),
            torch.from_numpy(cols["label"]), reduction="none").numpy()
    losses = [h["loss"] for h in learner.history]
    np.testing.assert_allclose(losses, [ce[order[:16]].mean(),
                                        ce[order[16:]].mean()], rtol=1e-5)


def test_dropout_keeps_its_fraction_in_train_mode_only():
    mlp = MLP(features=[4000], num_classes=2, dropout=0.3,
              in_features=8).eval()
    x = torch.ones((64, 8))
    with torch.no_grad():
        dense = mlp(x, capture="dense_0")          # eval mode: identity
        mlp.train()
        mlp.dropout_generator = torch.Generator().manual_seed(0)
        a = mlp(x, capture="dense_0")
        mlp.dropout_generator = torch.Generator().manual_seed(0)
        b = mlp(x, capture="dense_0")
    assert torch.equal(a, b)                       # the generator's bits
    live = dense != 0
    kept = (a != 0) & live
    frac = float(kept.sum() / live.sum())
    assert abs(frac - 0.7) < 0.01
    torch.testing.assert_close(a[kept], dense[kept] / 0.7)
    # the learner seeds the generator: two fits take the same steps
    runs = []
    for _ in range(2):
        learner = _mlp_learner(networkSpec=dict(MLP_SPEC, in_features=12,
                                                dropout=0.5), epochs=2)
        learner.fit(mtt.DataTable(_mlp_table(n=64, seed=7)))
        runs.append([h["loss"] for h in learner.history])
    assert runs[0] == runs[1]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_none_without_a_card_raises(no_card):
    learner = _mlp_learner(device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        learner.fit(mtt.DataTable(_mlp_table(n=8)))


def _chunked_table():
    from mmlspark_tpu.io.ooc import ChunkedTable
    return ChunkedTable.from_table(JTable(_mlp_table(n=8)), chunk_rows=4)


@pytest.mark.parametrize("kw,item", [
    ({"meshAxes": {"data": 2}}, "DNN training across cards"),
    ({"meshAxes": {"data": 1, "fsdp": 4}}, "DNN training across cards"),
    ({"paramSharding": "fsdp"}, "DNN training across cards"),
    ({"checkpointDir": "ckpt"}, "DNN training: checkpoint/resume"),
    ({"table": "chunked"}, "Out-of-core ingest"),
    ({"table": "multi-process"}, "DNN training across cards"),
])
def test_out_of_slice_params_raise(kw, item, monkeypatch):
    kw = dict(kw)
    table = mtt.DataTable(_mlp_table(n=8))
    what = kw.pop("table", None)
    if what == "chunked":
        table = _chunked_table()
    elif what == "multi-process":
        monkeypatch.setattr(torch.distributed, "is_initialized",
                            lambda: True)
        monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match=item):
        _mlp_learner(**kw).fit(table)
    with pytest.raises(NotImplementedError, match="across cards"):
        _mlp_learner().set_mesh(None)


def test_single_card_mesh_axes_are_accepted():
    learner = _mlp_learner(meshAxes={"data": -1, "fsdp": 1}, epochs=1)
    learner.fit(mtt.DataTable(_mlp_table(n=40)))
    assert len(learner.history) == 2


def test_profile_annotations_and_memory_stats_on_the_cpu(tmp_path):
    from mmlspark_tpu_torch.utils import profiling
    learner = _mlp_learner(epochs=1, profileDir=str(tmp_path),
                           traceAnnotations=True, memoryStatsEvery=1)
    learner.fit(mtt.DataTable(_mlp_table(n=64)))
    files = sorted(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    assert "learner_step" in Path(files[0]).read_text()
    assert learner.memory_samples == []       # no card: nothing to sample
    assert profiling.device_memory_stats() is None
    assert "mfu" not in learner.timing        # measured only on an H100


def test_returned_model_reshapes_and_scales_its_input():
    """The apply of the returned model (the JAX ``_InferApply``): a flat
    float column reshaped to ``inputShape`` and scaled (1/255 for image
    columns) before the module runs."""
    class Echo(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(()))

        def forward(self, x):
            return x * self.w
    x = np.random.default_rng(8).normal(size=(5, 12)).astype(np.float32)
    model = mtt.TPUModel.from_module(Echo(), device="cpu", input_shape=[3, 4],
                                     input_scale=0.5, inputCol="x",
                                     outputCol="y")
    out = model.transform(mtt.DataTable({"x": x}))["y"]
    np.testing.assert_allclose(out, x.reshape(5, 3, 4) * 0.5)
    learner = _mlp_learner(inputShape=[12], epochs=1)
    fitted = learner.fit(mtt.DataTable(_mlp_table(n=32)))
    assert fitted.get("modelFn").input_shape == [12]
    assert fitted.get("modelFn").input_scale == 1.0
    assert fitted.get_output_col() == "scores"


def test_learner_fits_with_jax_blocked():
    code = """
import sys
sys.modules["jax"] = None
sys.modules["mmlspark_tpu"] = None
import numpy as np
import mmlspark_tpu_torch as mtt
rng = np.random.default_rng(0)
x = rng.normal(size=(96, 6)).astype(np.float32)
y = (x[:, 0] > 0).astype(np.int64)
learner = mtt.TPULearner(
    networkSpec={"type": "mlp", "features": [16], "num_classes": 2,
                 "in_features": 6},
    epochs=6, batchSize=32, learningRate=0.1, computeDtype="float32",
    device="cpu", logEvery=1)
model = learner.fit(mtt.DataTable({"features": x, "label": y}))
out = model.transform(mtt.DataTable({"features": x}))
assert (out["scores"].argmax(1) == y).mean() > 0.9
imgs = rng.normal(size=(24, 8, 8, 3)).astype(np.float32)
labels = (imgs[..., 0].mean((1, 2)) > 0).astype(np.int64)
for spec in ({"type": "convnet", "conv_features": [4], "dense_features": [8],
              "num_classes": 2},
             {"type": "resnet", "stage_sizes": [1, 1], "width": 4,
              "num_classes": 2}):
    zoo = mtt.TPULearner(networkSpec=spec, inputShape=[8, 8, 3], epochs=2,
                         batchSize=8, computeDtype="float32", device="cpu",
                         logEvery=1)
    model = zoo.fit(mtt.DataTable({"features": imgs.reshape(24, -1),
                                   "label": labels}))
    scores = model.transform(mtt.DataTable(
        {"features": imgs.reshape(24, -1)}))["scores"]
    assert scores.shape == (24, 2) and np.isfinite(scores).all()
    assert len(zoo.history) == 6
assert not any(m.split(".")[0] in ("jax", "optax", "flax", "mmlspark_tpu")
               for m, v in sys.modules.items() if v is not None)
print("OK")
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(REPO), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OK" in r.stdout
