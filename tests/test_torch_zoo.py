"""PyTorch port: the zoo's ConvNet, ResNet and BiLSTMTagger against the JAX
package, on the CPU.

The JAX side runs the JAX package's own ``build_network(spec).init /
apply`` and ``TPULearner``; the port gets the same flax variables
(``params`` and ``batch_stats``) through ``convert.module_from_flax``.
Inputs come from numpy seeds, at small sizes: 8 x 8 to 32 x 32 images,
widths of 4-16, T <= 12.

Tolerances, stated:
- float32 forward: rtol 1e-5 and atol 1e-5 of the output's scale (its
  largest magnitude). Both run the same operations in float32 and differ
  by the order of their sums (measured: 2e-7 of the scale).
- bfloat16 forward: within 2**-7 of the output's scale, one bfloat16
  rounding at the largest magnitude. Convolutions round as flax's (the
  product, then the bias added in bfloat16) and match bitwise here; a
  Dense layer adds its bias before the one rounding (torch's
  ``F.linear``), flax after it (measured: 5e-3 of the scale).
- The BiLSTM's bfloat16 body: only the embedding is bfloat16 in flax, so
  its ``lstm`` capture is float32 and held to the float32 tolerance.
- BatchNorm's running statistics after one train-mode forward: rtol 1e-5
  with atol 1e-6.
- Learner parity: ``tests/test_torch_learner.py``'s — losses, weights and
  running statistics within rtol 1e-5 (atol 1e-6) under sgd / momentum
  and rtol 1e-4 (atol 1e-5) under adam.
"""

import functools
import json
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.core.schema import ImageSchema as JImageSchema
from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.models.learner import TPULearner as JLearner
from mmlspark_tpu.models.networks import build_network as jbuild
from mmlspark_tpu.parallel import mesh as jmesh

import mmlspark_tpu_torch as mtt
from mmlspark_tpu_torch import convert
from mmlspark_tpu_torch.core.schema import ImageSchema
from mmlspark_tpu_torch.models import networks as tnet
from mmlspark_tpu_torch.models.tpu_model import TPUModel

BF16_REL = 2.0 ** -7

CONV_K3 = {"type": "convnet", "conv_features": [4, 8], "dense_features": [16],
           "num_classes": 3}
CONV_K2 = dict(CONV_K3, kernel=[2, 2], pool_every=2)
RESNET = {"type": "resnet", "stage_sizes": [1, 1], "width": 4,
          "num_classes": 3}
RESNET_IMAGENET = {"type": "resnet", "stage_sizes": [1, 1, 1, 1], "width": 8,
                   "num_classes": 5, "stem": "imagenet"}
BILSTM = {"type": "bilstm", "vocab_size": 20, "embed_dim": 8, "hidden": 6,
          "num_tags": 3}

# (spec, one input row's shape); the odd 9 x 9 rows floor at the pools
CASES = {
    "convnet-k3-pool1": (CONV_K3, (8, 8, 3)),
    "convnet-k2-pool2": (CONV_K2, (9, 9, 3)),
    "resnet-cifar": (RESNET, (8, 8, 3)),
    "resnet-imagenet": (RESNET_IMAGENET, (32, 32, 3)),
    "bilstm": (BILSTM, (12,)),
}


def _inputs(spec, row_shape, n=4, seed=0):
    rng = np.random.default_rng(seed)
    if spec["type"] == "bilstm":
        return rng.integers(0, spec["vocab_size"],
                            size=(n,) + row_shape).astype(np.int32)
    return rng.normal(size=(n,) + row_shape).astype(np.float32)


def _drawn(shapes, seed=1):
    """Flax variables of the given shapes drawn from a numpy seed: kernels
    normal over their fan-in, embeddings normal, biases, BatchNorm scales
    and running means around 0 and 1, running variances in [0.5, 2]."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "var":
            a = rng.uniform(0.5, 2.0, shape)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "kernel":
            a = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "embedding":
            a = rng.normal(size=shape)
        else:                                   # bias, mean
            a = 0.1 * rng.normal(size=shape)
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _flax(spec, row_shape, dtype="float32", seed=1):
    """(spec, flax module, variables): the variables have the shapes
    ``module.init`` gives them (traced, not run) and seeded values."""
    spec = dict(spec, dtype=dtype)
    module = jbuild(spec)
    sample = jnp.asarray(_inputs(spec, row_shape, n=1))
    shapes = jax.eval_shape(functools.partial(module.init, train=False),
                            jax.random.PRNGKey(0), sample)
    return spec, module, _drawn(shapes, seed)


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _assert_f32_close(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max(), err_msg=msg)


# ---------------------------------------------------------------------------
# forward parity: every network, every capture layer, f32 and bf16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_captures_match_flax(case, dtype):
    spec, row_shape = CASES[case]
    spec, jm, variables = _flax(spec, row_shape, dtype)
    tm = convert.module_from_flax(spec, variables, device="cpu")
    assert tm.feature_layers() == jm.feature_layers()
    x = _inputs(spec, row_shape, n=5, seed=2)
    for capture in [None] + tm.feature_layers():
        want = np.asarray(jm.apply(variables, jnp.asarray(x),
                                   capture=capture), np.float32)
        with torch.no_grad():
            out = tm(torch.from_numpy(x), capture=capture)
        got = out.float().numpy()
        assert got.shape == want.shape, (capture, got.shape, want.shape)
        if dtype == "float32" or (spec["type"] == "bilstm"
                                  and capture == "lstm"):
            # the BiLSTM's cells run float32 under bf16 too
            assert out.dtype == torch.float32
            _assert_f32_close(got, want, f"{case} {capture}")
        else:
            assert _rel_err(got, want) <= BF16_REL, (capture,
                                                     _rel_err(got, want))


def test_convnet_flattens_nhwc_and_pads_same_at_the_end():
    """An even kernel: 'SAME' pads 0 before and 1 after; a 7 x 7 row under
    two 2 x 2 pools floors to 1 x 1. dense_0's kernel reads the NHWC
    flattening, so a flax kernel loads unpermuted."""
    spec = dict(CONV_K2, conv_features=[2, 3], pool_every=1)
    spec, jm, variables = _flax(spec, (7, 7, 1))
    tm = convert.module_from_flax(spec, variables, device="cpu")
    assert tm.conv_0.pads == ((0, 1), (0, 1))
    assert tm.dense_0.in_features == 3
    assert tnet.conv_flat_features([2, 3], 1, (7, 7, 1)) == 3
    x = _inputs(spec, (7, 7, 1), n=3)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    _assert_f32_close(got, np.asarray(jm.apply(variables, jnp.asarray(x))))


def test_resnet_padding_stems_and_projection():
    tm = tnet.build_network(RESNET_IMAGENET, device="cpu")
    assert tm.stem.pads == ((3, 3), (3, 3)) and tm.stem.stride == (2, 2)
    block = tm.stage1_block0
    assert block.Conv_0.pads == ((1, 1), (1, 1))
    assert block.Conv_0.stride == (2, 2)
    assert block.proj.pads == ((0, 0), (0, 0)) and block.proj.stride == (2, 2)
    assert tm.stage0_block0.proj is None
    assert tm.numerics_markers() == {
        "resnet_padding": "explicit11-torch-compat"}


# ---------------------------------------------------------------------------
# BatchNorm in train mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,dtype", [
    ("resnet-cifar", "float32"), ("resnet-cifar", "bfloat16"),
    ("resnet-imagenet", "float32")])
def test_batchnorm_train_mode_updates_running_stats_as_flax(case, dtype):
    """One train-mode forward on a batch whose last 3 rows are edge-padded
    copies of its fifth (the learner's final batch): the batch statistics
    include them in both packages. Output and every running buffer.

    Not the imagenet stem in bfloat16: its stem statistics sum 2048
    values per channel in float32 in another order than XLA's, a last-bit
    difference that flips single bfloat16 roundings of the normalized
    output (measured: 2.8e-3 of the scale after stage 0), and the batch
    statistics of stage 3, over 8 values per channel (1 x 1 maps),
    amplify them to 6 % of a running mean. The same network in bfloat16
    is held in eval mode by test_forward_and_captures_match_flax."""
    spec, row_shape = CASES[case]
    spec, jm, variables = _flax(spec, row_shape, dtype)
    tm = convert.module_from_flax(spec, variables, device="cpu").train()
    x = _inputs(spec, row_shape, n=5, seed=3)
    x = np.concatenate([x, np.repeat(x[-1:], 3, axis=0)])
    want, mutated = jm.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        _assert_f32_close(got, want)
    else:
        assert _rel_err(got, want) <= BF16_REL
    ref = convert.module_from_flax(
        spec, {"params": variables["params"],
               "batch_stats": mutated["batch_stats"]}, device="cpu")
    ref_state, got_state = ref.state_dict(), tm.state_dict()
    start = convert.module_from_flax(spec, variables,
                                     device="cpu").state_dict()
    names = [k for k in ref_state if ".running_" in k]
    n_bn = sum(isinstance(m, tnet.BatchNorm) for m in tm.modules())
    assert n_bn > 0 and len(names) == 2 * n_bn
    for name in names:
        assert not torch.equal(got_state[name], start[name]), name
        np.testing.assert_allclose(got_state[name].numpy(),
                                   ref_state[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    # eval mode reads the running buffers: a row alone scores as in a batch
    tm.eval()
    with torch.no_grad():
        alone = tm(torch.from_numpy(x[:2]))
        batch = tm(torch.from_numpy(x))
    torch.testing.assert_close(alone, batch[:2], rtol=1e-5, atol=1e-6)


def test_batchnorm_keeps_the_biased_fast_variance():
    """Unbiased (torch's running update) and biased variance part ways by
    n / (n - 1); flax keeps the biased E[x^2] - E[x]^2 with momentum 0.99."""
    bn = tnet.BatchNorm(3).train()
    x = torch.from_numpy(np.random.default_rng(4).normal(
        2.0, 3.0, size=(4, 3, 2, 2)).astype(np.float32))
    with torch.no_grad():
        bn(x, torch.float32)
    xs = x.double().permute(1, 0, 2, 3).reshape(3, -1)
    mean = xs.mean(1)
    var = (xs * xs).mean(1) - mean * mean
    torch.testing.assert_close(bn.running_mean.double(), 0.01 * mean,
                               rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(bn.running_var.double(), 0.99 + 0.01 * var,
                               rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# initialization and sizes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_network_has_flax_shapes_and_default_draws(case):
    spec, row_shape = CASES[case]
    sized = tnet.sized_spec(spec, row_shape)
    built = tnet.build_network(sized, device="cpu", seed=3).state_dict()
    spec_, _, variables = _flax(spec, row_shape)
    loaded = convert.module_from_flax(spec_, variables,
                                      device="cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in built.items()} == \
        {k: tuple(v.shape) for k, v in loaded.items()}
    bound = 2.0 / 0.87962566103423978
    for name, t in built.items():
        if name.endswith("running_mean"):
            assert torch.all(t == 0), name
        elif name.endswith("running_var"):
            assert torch.all(t == 1), name
        elif name.endswith("BatchNorm_1.weight") and "block" in name:
            assert torch.all(t == 0), name      # flax's zeros_init
        elif name.endswith(".weight") and "BatchNorm" in name:
            assert torch.all(t == 1), name
        elif name.endswith("bias") or name.endswith("bias_hh"):
            assert torch.all(t == 0), name
        elif name.endswith("weight_hh"):
            # orthogonal gate blocks (checked below): not truncated
            assert abs(float(t.std()) * t.shape[1] ** 0.5 - 1) < 0.5, name
        elif t.ndim == 4 or (t.ndim == 2 and "embed" not in name):
            fan_in = int(np.prod(t.shape[1:]))
            assert float(t.abs().max()) <= bound / fan_in ** 0.5 * (1 + 1e-6)
            assert abs(float(t.std()) * fan_in ** 0.5 - 1) < 0.5, name
    if spec["type"] == "bilstm":
        hidden = spec["hidden"]
        for cell in ("OptimizedLSTMCell_0", "OptimizedLSTMCell_1"):
            for q in built[f"{cell}.weight_hh"].split(hidden):
                torch.testing.assert_close(q @ q.T, torch.eye(hidden),
                                           atol=1e-5, rtol=0)


def test_sized_spec_fills_what_flax_infers():
    assert tnet.sized_spec(CONV_K3, (8, 8, 3)) == dict(
        CONV_K3, in_channels=3, flat_features=2 * 2 * 8)
    assert tnet.sized_spec(CONV_K2, (9, 9, 1))["flat_features"] == 4 * 4 * 8
    assert tnet.sized_spec(RESNET, (16, 16, 5))["in_channels"] == 5
    assert tnet.sized_spec({"type": "mlp"}, (12,))["in_features"] == 12
    assert tnet.sized_spec(BILSTM, (12,)) == BILSTM
    assert tnet.sized_spec(dict(RESNET, in_channels=2),
                           (8, 8, 3))["in_channels"] == 2
    with pytest.raises(ValueError, match="NHWC"):
        tnet.sized_spec(CONV_K3, (64,))
    # without sizes: the 32 x 32 x 3 CIFAR rows
    cifar = tnet.build_network({"type": "convnet"}, device="cpu")
    assert cifar.dense_0.in_features == 4 * 4 * 64


# ---------------------------------------------------------------------------
# convert rules
# ---------------------------------------------------------------------------


def test_convert_rejects_missing_extra_and_absent_stats():
    spec, _, variables = _flax(RESNET, (8, 8, 3))
    params, stats = variables["params"], variables["batch_stats"]
    missing = {"params": {k: v for k, v in params.items() if k != "head"},
               "batch_stats": stats}
    with pytest.raises(ValueError, match="params/head"):
        convert.module_from_flax(spec, missing, device="cpu")
    extra = {"params": dict(params, stray={"kernel": np.zeros(2)}),
             "batch_stats": stats}
    with pytest.raises(ValueError, match="stray"):
        convert.module_from_flax(spec, extra, device="cpu")
    extra_stat = {"params": params, "batch_stats": dict(
        stats, BatchNorm_9={"mean": np.zeros(4), "var": np.ones(4)})}
    with pytest.raises(ValueError, match="batch_stats/BatchNorm_9"):
        convert.module_from_flax(spec, extra_stat, device="cpu")
    with pytest.raises(ValueError, match="batch_stats/BatchNorm_0/mean"):
        convert.module_from_flax(spec, {"params": params}, device="cpu")
    with pytest.raises(ValueError, match="batch_stats/BatchNorm_0/mean"):
        convert.module_from_flax(spec, params, device="cpu")
    with pytest.raises(ValueError, match="collections"):
        convert.module_from_flax(spec, dict(variables, cache={}),
                                 device="cpu")
    # an LSTM gate kernel missing
    spec, _, variables = _flax(BILSTM, (12,))
    cell = dict(variables["params"]["OptimizedLSTMCell_1"])
    del cell["hg"]
    with pytest.raises(ValueError, match="OptimizedLSTMCell_1/hg"):
        convert.module_from_flax(spec, {"params": dict(
            variables["params"], OptimizedLSTMCell_1=cell)}, device="cpu")


def test_lstm_layout_single_bias_and_gate_order():
    spec, _, variables = _flax(BILSTM, (12,))
    tm = convert.module_from_flax(spec, variables, device="cpu")
    p = variables["params"]["OptimizedLSTMCell_0"]
    names = [n for n, _ in tm.named_parameters()]
    assert not any("bias_ih" in n for n in names)
    assert [n for n in names if "OptimizedLSTMCell_0" in n] == [
        "OptimizedLSTMCell_0.weight_ih", "OptimizedLSTMCell_0.weight_hh",
        "OptimizedLSTMCell_0.bias_hh"]
    h = spec["hidden"]
    cell = tm.OptimizedLSTMCell_0
    for k, gate in enumerate("ifgo"):
        rows = slice(k * h, (k + 1) * h)
        np.testing.assert_array_equal(cell.weight_ih[rows].detach().numpy(),
                                      np.asarray(p["i" + gate]["kernel"]).T)
        np.testing.assert_array_equal(cell.weight_hh[rows].detach().numpy(),
                                      np.asarray(p["h" + gate]["kernel"]).T)
        np.testing.assert_array_equal(cell.bias_hh[rows].detach().numpy(),
                                      np.asarray(p["h" + gate]["bias"]))


def _fit_resnet_in_port(n=24):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 3, n).astype(np.int64)
    learner = mtt.TPULearner(
        networkSpec=RESNET, inputShape=[8, 8, 3], epochs=2, batchSize=8,
        learningRate=0.05, computeDtype="float32", logEvery=1000,
        device="cpu")
    return learner.fit(mtt.DataTable({"features": x.reshape(n, -1),
                                      "label": y})), x


def test_port_trained_resnet_saves_and_loads_bitwise(tmp_path):
    model, x = _fit_resnet_in_port()
    table = mtt.DataTable({"features": x.reshape(len(x), -1)})
    before = model.transform(table)["scores"]
    path = str(tmp_path / "resnet")
    model.save(path)
    meta = json.loads(open(os.path.join(path, "metadata.json")).read())
    assert meta["numerics_markers"] == {
        "resnet_padding": "explicit11-torch-compat"}
    loaded = mtt.load_stage(path)
    loaded.set("device", "cpu")
    after = loaded.transform(table)["scores"]
    assert np.array_equal(before, after)
    weights = loaded.get("weights")
    assert any(k.endswith("running_var") for k in weights)
    assert not torch.all(weights["BatchNorm_0.running_var"] == 1)


# ---------------------------------------------------------------------------
# learner parity with the JAX learner
# ---------------------------------------------------------------------------


def _image_rows(imgs, schema):
    return [schema.make_row(f"i{i}.png", imgs[i]) for i in range(len(imgs))]


def _zoo_fit_both(spec, jcols, tcols, *, loss="cross_entropy", optimizer,
                  lr, batch, epochs, seed=3, **kw):
    """The JAX learner and the port's on the same table and the JAX
    learner's initial variables (``module.init(PRNGKey(seed), sample)``)."""
    common = dict(loss=loss, optimizer=optimizer, learningRate=lr,
                  batchSize=batch, epochs=epochs, seed=seed,
                  computeDtype="float32", logEvery=1, **kw)
    jl = JLearner(networkSpec=spec, **common)
    jl.set_mesh(jmesh.single_device_mesh())
    jm = jl.fit(JTable(jcols))
    from mmlspark_tpu.models.learner import table_to_xy
    sample = table_to_xy(JTable(jcols), "features", "label",
                         kw.get("inputShape"))[0][:1]
    sample = jnp.asarray(sample)
    if spec["type"] == "bilstm":
        sample = sample.astype(jnp.int32)
    # the JAX learner's module.init, compiled (the same draws, in a
    # fraction of the eager init's time)
    variables = jax.jit(functools.partial(jbuild(spec).init, train=False))(
        jax.random.PRNGKey(seed), sample)
    tl = mtt.TPULearner(
        moduleFactory=lambda: convert.module_from_flax(spec, variables,
                                                       device="cpu"),
        device="cpu", **common)
    tm = tl.fit(mtt.DataTable(tcols))
    return jl, jm, tl, tm


def _assert_fits_close(spec, jl, jm, tl, tm, adam):
    rtol, atol = (1e-4, 1e-5) if adam else (1e-5, 1e-6)
    assert [h["step"] for h in tl.history] == [h["step"] for h in jl.history]
    np.testing.assert_allclose([h["loss"] for h in tl.history],
                               [h["loss"] for h in jl.history], rtol=rtol)
    ref = convert.module_from_flax(spec, jm.get("weights"),
                                   device="cpu").state_dict()
    got = tm.get("weights")
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)


def test_convnet_on_an_image_column_matches_jax():
    """An image column and no inputShape: both learners size the module
    from the NHWC rows and scale them by 1/255; sgd, 20 rows in batches
    of 8 (the third masked)."""
    rng = np.random.default_rng(6)
    imgs = rng.integers(0, 256, size=(20, 8, 8, 3)).astype(np.uint8)
    y = rng.integers(0, 3, 20).astype(np.int64)
    spec = dict(CONV_K3, conv_features=[4, 4], pool_every=2)
    jcols = {"features": _image_rows(imgs, JImageSchema), "label": y}
    tcols = {"features": _image_rows(imgs, ImageSchema), "label": y}
    jl, jm, tl, tm = _zoo_fit_both(spec, jcols, tcols, optimizer="sgd",
                                   lr=0.1, batch=8, epochs=2)
    assert len(tl.history) == 6
    assert tm.get("modelFn").input_scale == 1.0 / 255.0
    assert tm.get("modelFn").module.dense_0.in_features == 4 * 4 * 4
    _assert_fits_close(spec, jl, jm, tl, tm, adam=False)
    got = tm.transform(mtt.DataTable(tcols))["scores"]
    want = np.asarray(jm.transform(JTable(jcols))["scores"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_resnet_momentum_with_a_padded_final_batch_matches_jax():
    """Nesterov momentum; 20 rows in batches of 8, so the final batch holds
    4 real rows and 4 edge-padded ones, whose rows enter the batch
    statistics in both packages. Losses, weights and running stats."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(20, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 3, 20).astype(np.int64)
    cols = {"features": x.reshape(20, -1), "label": y}
    jl, jm, tl, tm = _zoo_fit_both(RESNET, cols, cols, optimizer="momentum",
                                   lr=0.05, batch=8, epochs=2,
                                   inputShape=[8, 8, 3])
    assert len(tl.history) == 6
    _assert_fits_close(RESNET, jl, jm, tl, tm, adam=False)
    got = tm.transform(mtt.DataTable(cols))["scores"]
    want = np.asarray(jm.transform(JTable(cols))["scores"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bilstm_adam_matches_jax_with_one_bias_per_gate():
    """Token cross-entropy under adam: a second trained bias per gate
    would take two gradients a step and part from the JAX fit."""
    rng = np.random.default_rng(8)
    toks = rng.integers(0, BILSTM["vocab_size"], size=(18, 10))
    cols = {"features": toks.astype(np.float32),
            "label": (toks % 3).astype(np.int64)}
    jl, jm, tl, tm = _zoo_fit_both(BILSTM, cols, cols,
                                   loss="token_cross_entropy",
                                   optimizer="adam", lr=0.01, batch=8,
                                   epochs=2)
    assert len(tl.history) == 6
    _assert_fits_close(BILSTM, jl, jm, tl, tm, adam=True)
    got = tm.transform(mtt.DataTable(cols))["scores"]
    want = np.asarray(jm.transform(JTable(cols))["scores"])
    assert got.shape == want.shape == (18, 10, 3)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# the JAX package's own learner tests, on the port
# ---------------------------------------------------------------------------


def _accuracy(model, table, labels):
    pred = np.argmax(model.transform(table)["scores"], axis=-1)
    return float(np.mean(pred == labels))


def test_convnet_on_images_learns():
    """tests/test_learner.py::test_convnet_on_images."""
    rng = np.random.default_rng(0)
    n = 64
    labels = rng.integers(0, 2, n)
    imgs = (rng.normal(size=(n, 8, 8, 3)) + labels[:, None, None, None] * 2.0)
    imgs = np.clip((imgs + 3) * 40, 0, 255).astype(np.uint8)
    t = mtt.DataTable({"image": _image_rows(imgs, ImageSchema),
                       "label": labels.astype(np.int64)})
    learner = mtt.TPULearner(
        featuresCol="image",
        networkSpec={"type": "convnet", "conv_features": [8],
                     "dense_features": [16], "num_classes": 2},
        epochs=25, batchSize=32, learningRate=0.1,
        computeDtype="float32", logEvery=1000, device="cpu")
    acc = _accuracy(learner.fit(t), t, labels)
    assert acc > 0.9, f"accuracy {acc}"


def test_resnet_batchnorm_smoke():
    """tests/test_learner.py::test_resnet_batchnorm_smoke."""
    rng = np.random.default_rng(1)
    n = 32
    labels = rng.integers(0, 2, n)
    imgs = rng.normal(size=(n, 8, 8, 3)).astype(np.float32)
    t = mtt.DataTable({"features": imgs.reshape(n, -1), "label": labels})
    learner = mtt.TPULearner(
        networkSpec={"type": "resnet", "stage_sizes": [1], "width": 8,
                     "num_classes": 2},
        inputShape=[8, 8, 3],
        epochs=1, batchSize=16, computeDtype="float32", logEvery=1000,
        device="cpu")
    out = learner.fit(t).transform(t)
    assert out["scores"].shape == (n, 2)
    assert np.all(np.isfinite(out["scores"]))


def test_bilstm_tagger_learns():
    """tests/test_learner.py::test_bilstm_tagger_smoke."""
    rng = np.random.default_rng(0)
    n, T, V, K = 32, 12, 50, 3
    toks = rng.integers(0, V, size=(n, T)).astype(np.float32)
    tags = toks.astype(np.int64) % K
    t = mtt.DataTable({"features": toks, "label": tags})
    learner = mtt.TPULearner(
        networkSpec={"type": "bilstm", "vocab_size": V, "embed_dim": 16,
                     "hidden": 16, "num_tags": K},
        loss="token_cross_entropy",
        epochs=40, batchSize=16, learningRate=0.02, optimizer="adam",
        computeDtype="float32", logEvery=1000, device="cpu")
    scores = np.asarray(learner.fit(t).transform(t)["scores"])
    assert scores.shape == (n, T, K)
    acc = float(np.mean(np.argmax(scores, -1) == tags))
    assert acc > 0.8, f"token accuracy {acc}"


def test_int_token_model_inputs_stay_integer():
    """tests/test_tpu_model.py::test_int_token_model_inputs_stay_integer:
    token ids reach the embedding as integers under f32 and bf16."""
    spec = {"type": "bilstm", "vocab_size": 20, "embed_dim": 4,
            "hidden": 4, "num_tags": 3}
    model = TPUModel.from_module(tnet.build_network(spec, device="cpu"),
                                 device="cpu", inputCol="tokens",
                                 outputCol="tags", batchSize=4)
    toks = np.random.default_rng(0).integers(0, 20, size=(10, 6))
    out = model.transform(mtt.DataTable({"tokens": toks.astype(np.int64)}))
    assert out["tags"].shape == (10, 6, 3)
    model.set("computeDtype", "bfloat16")
    out2 = model.transform(mtt.DataTable({"tokens": toks.astype(np.int64)}))
    assert out2["tags"].shape == (10, 6, 3)
    np.testing.assert_array_equal(out["tags"], out2["tags"])


# ---------------------------------------------------------------------------
# TF32 regions
# ---------------------------------------------------------------------------


def test_strict_f32_turns_tf32_off_inside_and_restores_it():
    before = torch.backends.cudnn.allow_tf32
    seen = []
    tm = tnet.build_network(CONV_K3, device="cpu")
    tm.conv_0.register_forward_hook(lambda *a: seen.append(
        torch.backends.cudnn.allow_tf32))
    try:
        for setting in (True, False):
            torch.backends.cudnn.allow_tf32 = setting
            with torch.no_grad():
                tm(torch.zeros(1, 32, 32, 3))
            assert torch.backends.cudnn.allow_tf32 is setting
        assert seen == [False, False]
        # nested and concurrent regions: off while any is open
        torch.backends.cudnn.allow_tf32 = True
        inside = threading.Event()
        release = threading.Event()

        def hold():
            with tnet.strict_f32():
                inside.set()
                release.wait(10)
        worker = threading.Thread(target=hold)
        worker.start()
        assert inside.wait(10)
        with tnet.strict_f32():
            with tnet.strict_f32():
                assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False   # the thread's
        release.set()
        worker.join(10)
        assert not worker.is_alive()
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = before


def test_batchnorm_train_gradient_is_the_formulas():
    """The closed-form backward of ``_BatchNormTrain`` against autograd
    through flax's formula in float64, on a channels_last batch: within
    1e-6 of each gradient's scale (float32 rounding)."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(1.0, 2.0, size=(6, 3, 5, 5)).astype(
        np.float32)).contiguous(memory_format=torch.channels_last)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, 3).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=3).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(6, 3, 5, 5)).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    y, _, _ = tnet._BatchNormTrain.apply(*leaves)
    assert y.is_contiguous(memory_format=torch.channels_last)
    got = torch.autograd.grad((y * g).sum(), leaves)
    x6, w6, b6 = (t.double().requires_grad_() for t in (x, w, b))
    mean = x6.mean((0, 2, 3))
    var = (x6 * x6).mean((0, 2, 3)) - mean * mean
    y6 = ((x6 - mean[:, None, None])
          * (torch.rsqrt(var + 1e-5) * w6)[:, None, None]
          + b6[:, None, None])
    torch.testing.assert_close(y.double(), y6.detach(), rtol=0, atol=1e-5)
    want = torch.autograd.grad((y6 * g.double()).sum(), (x6, w6, b6))
    for a, r in zip(got, want):
        assert float((a.double() - r).abs().max() / r.abs().max()) < 1e-6


def test_profile_train_classes_a_step_by_its_operators():
    """profile_train's kinds on a CPU profile of one ResNet and one
    ConvNet step (the card's kernels hang off the same operators):
    BatchNorm's node owns what it launches, forward and backward, and
    convolutions, pooling and the optimizer are told apart."""
    from torch.profiler import ProfilerActivity, profile

    from mmlspark_tpu_torch import profile_train as P
    kinds = set()
    for spec in (RESNET, CONV_K3):
        learner = mtt.TPULearner(networkSpec=spec, inputShape=[8, 8, 3],
                                 epochs=1, batchSize=4, logEvery=1,
                                 computeDtype="float32", device="cpu")
        table = mtt.DataTable({
            "features": np.ones((4, 8 * 8 * 3), np.float32),
            "label": np.zeros(4, np.int64)})
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            learner.fit(table)
        for e in prof.events():
            if e.cpu_children or not e.name.startswith("aten::"):
                continue
            names, node = [], e
            while node is not None:
                names.append(node.name)
                node = node.cpu_parent
            kinds.add(P.kind_of(e.name, tuple(reversed(names))))
    assert {"BatchNorm (fwd + bwd)", "cuDNN conv forward",
            "cuDNN conv backward", "pooling", "optimizer", "cuBLAS GEMMs",
            "cross-entropy"} <= kinds
    assert P.kind_of("flash_fwd_bf16<128>") == "flash_fwd"
    assert P.kind_of("elementwise_kernel", ("learner_step", "aten::relu")) \
        == "other (elementwise, reductions, embedding)"
