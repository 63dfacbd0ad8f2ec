"""PyTorch port: the DNN inference slice against the JAX package, on the
CPU.

The JAX zoo's flax weights go through ``convert.module_from_flax`` into
the port's modules, and the same numpy inputs through both: the
``Transformer`` at L = 64 (dense attention) and L = 512 (the flash route,
whose plain version runs on the CPU), causal or not, with an f32 or bf16
head; the ``MLP``; the ``capture=`` layers; and ``TPUModel.transform``
against the JAX ``TPUModel.from_flax(...).transform``. Also pinned: the
seeded initializer draws flax's distributions, entry points refuse the
CPU unless asked, and options outside the slice raise
``NotImplementedError`` naming their ROADMAP item.
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

from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.models.networks import build_network as jbuild
from mmlspark_tpu.models.tpu_model import TPUModel as JTPUModel

import mmlspark_tpu_torch as mtt
from mmlspark_tpu_torch import convert
from mmlspark_tpu_torch.models import networks as tnet
from mmlspark_tpu_torch.models.tpu_model import TPUModel
from mmlspark_tpu_torch.parallel import ring_attention as tra

REPO = Path(__file__).resolve().parent.parent
SMALL = {"type": "transformer", "vocab_size": 64, "dim": 32, "depth": 2,
         "heads": 4, "max_len": 512}
MLP_SPEC = {"type": "mlp", "features": [16, 8], "num_classes": 3}


def _flax_vars(spec, example, seed):
    """flax init, then every leaf shifted by seeded noise so biases and
    LayerNorm parameters are not their trivial init values and the name
    map is exercised leaf by leaf."""
    variables = jbuild(spec).init(jax.random.key(seed), jnp.asarray(example))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.float32(0.1) * rng.normal(
            size=np.shape(a)).astype(np.float32), variables)


@pytest.fixture(scope="module")
def lm_vars():
    return _flax_vars(SMALL, np.zeros((1, 8), np.int32), seed=1)


def _tokens(rows, length, seed=0, vocab=64):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(rows, length)).astype(np.int32)


def _close(got, ref, head_dtype):
    if head_dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=5e-4)
    else:
        # the bf16 head rounds each logit once, each package in its own
        # accumulation order: one bf16 ulp apart at most
        np.testing.assert_allclose(got, ref, rtol=2 ** -8, atol=2e-2)


@pytest.mark.parametrize("length,causal,head_dtype", [
    (64, True, "float32"), (64, False, "float32"),
    (512, True, "float32"), (512, False, "float32"),
    (64, True, "bfloat16"), (512, True, "bfloat16"),
])
def test_transformer_matches_flax(lm_vars, length, causal, head_dtype,
                                  monkeypatch):
    spec = dict(SMALL, causal=causal, head_dtype=head_dtype)
    toks = _tokens(2, length, seed=length)
    ref = np.asarray(jbuild(spec).apply(lm_vars, jnp.asarray(toks))
                     .astype(jnp.float32))
    calls = []
    real = tra.flash_attention
    monkeypatch.setattr(tra, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    module = convert.module_from_flax(spec, lm_vars, device="cpu")
    with torch.inference_mode():
        got = module(torch.from_numpy(toks))
    assert got.dtype == getattr(torch, head_dtype)
    assert len(calls) == (SMALL["depth"] if length >= 512 else 0)
    _close(got.float().numpy(), ref, head_dtype)


def test_transformer_capture_layers_and_max_len(lm_vars):
    jm = jbuild(SMALL)
    module = convert.module_from_flax(SMALL, lm_vars, device="cpu")
    assert module.feature_layers() == jm.feature_layers()
    toks = _tokens(2, 16, seed=3)
    for name in module.feature_layers():
        ref = np.asarray(jm.apply(lm_vars, jnp.asarray(toks), capture=name))
        with torch.inference_mode():
            got = module(torch.from_numpy(toks), capture=name)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=5e-4)
    with pytest.raises(ValueError, match="exceeds max_len=512"):
        module(torch.from_numpy(_tokens(1, 513)))


def test_transformer_classifier_head():
    spec = dict(SMALL, num_classes=3, max_len=64)
    toks = _tokens(3, 24, seed=4)
    variables = _flax_vars(spec, toks, seed=2)
    ref = np.asarray(jbuild(spec).apply(variables, jnp.asarray(toks)))
    with torch.inference_mode():
        got = convert.module_from_flax(spec, variables, device="cpu")(
            torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=5e-4)


def test_mlp_matches_flax():
    x = np.random.default_rng(0).normal(size=(5, 12)).astype(np.float32)
    jm = jbuild(MLP_SPEC)
    variables = _flax_vars(MLP_SPEC, x, seed=3)
    module = convert.module_from_flax(MLP_SPEC, variables, device="cpu")
    assert module.feature_layers() == jm.feature_layers()
    for capture in [None] + module.feature_layers():
        ref = np.asarray(jm.apply(variables, jnp.asarray(x),
                                  capture=capture))
        with torch.inference_mode():
            got = module(torch.from_numpy(x), capture=capture)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_module_from_flax_refuses_leaves_without_a_place(lm_vars):
    extra = {"params": dict(lm_vars["params"],
                            stray={"kernel": np.zeros((2, 2), np.float32)})}
    with pytest.raises(ValueError, match="stray"):
        convert.module_from_flax(SMALL, extra, device="cpu")
    missing = {"params": {k: v for k, v in lm_vars["params"].items()
                          if k != "ln_f"}}
    with pytest.raises(ValueError, match="ln_f"):
        convert.module_from_flax(SMALL, missing, device="cpu")


def test_seeded_init_draws_flax_distributions():
    spec = {"type": "transformer", "vocab_size": 512, "dim": 64, "depth": 1,
            "heads": 4, "max_len": 256}
    flax_p = jbuild(spec).init(jax.random.key(0),
                               jnp.zeros((1, 8), jnp.int32))["params"]
    a = tnet.build_network(spec, device="cpu", seed=0).state_dict()
    b = tnet.build_network(spec, device="cpu", seed=0).state_dict()
    c = tnet.build_network(spec, device="cpu", seed=1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["block_0.qkv.weight"], c["block_0.qkv.weight"])
    pairs = {"embed.weight": flax_p["embed"]["embedding"],
             "pos_embed": flax_p["pos_embed"],
             "block_0.qkv.weight": flax_p["block_0"]["qkv"]["kernel"],
             "block_0.mlp_down.weight":
                 flax_p["block_0"]["mlp_down"]["kernel"],
             "lm_head.weight": flax_p["lm_head"]["kernel"]}
    for name, ref in pairs.items():
        ref = np.asarray(ref)
        got = a[name].numpy()
        assert abs(got.std() / ref.std() - 1) < 0.05, name
        if name.endswith(".weight") and "embed" not in name:
            # lecun_normal: truncated at 2 stddev, as flax's
            bound = 2 * (1 / got.shape[1]) ** 0.5 / 0.87962566103423978
            assert np.abs(got).max() <= bound * (1 + 1e-6), name
            assert np.abs(ref).max() <= bound * (1 + 1e-6), name
    for name in ("block_0.ln1.weight", "ln_f.weight"):
        assert torch.all(a[name] == 1)
    for name in ("block_0.qkv.bias", "block_0.ln2.bias", "lm_head.bias"):
        assert torch.all(a[name] == 0)


def test_unported_networks_and_options_raise():
    with pytest.raises(NotImplementedError, match="Long context"):
        tnet.build_network(dict(SMALL, seq_axis="seq"), device="cpu")
    with pytest.raises(ValueError, match="in_features"):
        tnet.build_network(MLP_SPEC, device="cpu")


def _lm_model(lm_vars, spec, **kw):
    module = convert.module_from_flax(spec, lm_vars, device="cpu")
    return TPUModel.from_module(module, device="cpu", inputCol="tokens",
                                outputCol="logits", **kw)


def test_tpumodel_transform_matches_jax(lm_vars):
    spec = dict(SMALL, head_dtype="bfloat16", max_len=64)
    variables = {"params": dict(lm_vars["params"],
                                pos_embed=lm_vars["params"]["pos_embed"][:64])}
    toks = _tokens(11, 64, seed=5).astype(np.int64)
    ref = JTPUModel.from_flax(jbuild(spec), variables, inputCol="tokens",
                              outputCol="logits", batchSize=8
                              ).transform(JTable({"tokens": toks}))
    model = _lm_model(variables, spec, batchSize=8)
    out = model.transform(mtt.DataTable({"tokens": toks}))
    got, want = out["logits"], np.asarray(ref["logits"])
    assert got.shape == want.shape == (11, 64, 64)
    assert got.dtype == want.dtype == np.float32
    _close(got, want, "bfloat16")
    assert out.schema["logits"].tag == ref.schema["logits"].tag
    m = model.metrics()
    assert m["pad_ms"]["count"] == m["device_ms"]["count"] == 2
    assert m["precision"] == "f32"
    # the last, ragged micro-batch alone: padded rows do not leak
    tail = model.transform(mtt.DataTable({"tokens": toks[8:]}))["logits"]
    np.testing.assert_array_equal(tail, got[8:])


def test_tpumodel_float_input_matches_jax():
    x = np.random.default_rng(1).normal(size=(13, 12)).astype(np.float32)
    variables = _flax_vars(MLP_SPEC, x, seed=4)
    ref = JTPUModel.from_flax(jbuild(MLP_SPEC), variables, inputCol="x",
                              outputCol="y", batchSize=8
                              ).transform(JTable({"x": x}))
    module = convert.module_from_flax(MLP_SPEC, variables, device="cpu")
    got = TPUModel.from_module(module, device="cpu", inputCol="x",
                               outputCol="y", batchSize=8
                               ).transform(mtt.DataTable({"x": x}))
    np.testing.assert_allclose(got["y"], np.asarray(ref["y"]), rtol=1e-5,
                               atol=1e-5)


def test_tpumodel_buckets_match_jax(lm_vars):
    for bs in (8, 20, 64):
        ref = JTPUModel(batchSize=bs)
        got = _lm_model(lm_vars, SMALL, batchSize=bs)
        assert got.bucket_sizes() == ref.bucket_sizes()
        assert [got.bucket_for(r) for r in range(1, bs + 1)] == \
            [ref.bucket_for(r) for r in range(1, bs + 1)]


def test_tpumodel_refuses_what_is_not_ported(lm_vars):
    model = _lm_model(lm_vars, SMALL)
    for call, item in ((lambda: model.set_mesh(None), "Device pipeline"),
                       (lambda: model.set_sharding(None), "Device pipeline"),
                       (lambda: model.device_op(None), "Device pipeline"),
                       (lambda: model.quantize({}), "DNN int8 inference"),
                       (lambda: model.set("precision", "int8"),
                        "DNN int8 inference")):
        with pytest.raises(NotImplementedError, match=item):
            call()
    with pytest.raises(ValueError, match="outside"):
        model.transform(mtt.DataTable({"tokens": _tokens(2, 8, vocab=65)
                                       + 1}))
    # warmup is ported (the serving slice); an empty example still raises
    with pytest.raises(ValueError, match="at least one example row"):
        model.warmup({})


def test_threaded_prefetcher_keeps_order_and_forwards_errors():
    """The prefetcher the card path uses (the CPU path prepares inline)."""
    from mmlspark_tpu_torch.utils.prefetch import ThreadedPrefetcher
    feed = ThreadedPrefetcher(range(20), lambda i: i * i, depth=2)
    assert list(feed) == [i * i for i in range(20)]

    def boom(i):
        if i == 3:
            raise RuntimeError("bad batch")
        return i
    feed = ThreadedPrefetcher(range(10), boom, depth=2)
    with pytest.raises(RuntimeError, match="bad batch"):
        list(feed)
    feed = ThreadedPrefetcher(range(1000), lambda i: i, depth=2)
    assert next(feed) == 0
    feed.close()                 # early exit: the worker stops
    assert not feed._thread.is_alive()


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_the_cpu_unless_asked(no_card, lm_vars):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mtt.build_network(SMALL)
    module = convert.module_from_flax(SMALL, lm_vars, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TPUModel.from_module(module)
    model = TPUModel.from_fn(lambda w, ins: ins["input"], {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.transform(mtt.DataTable({"input": np.zeros((2, 3),
                                                          np.float32)}))


def test_port_transforms_a_transformer_with_jax_blocked():
    code = """
import sys
sys.modules["jax"] = None
sys.modules["mmlspark_tpu"] = None
import numpy as np
import mmlspark_tpu_torch as mtt
spec = {"type": "transformer", "vocab_size": 50, "dim": 16, "depth": 1,
        "heads": 2, "max_len": 512}
toks = np.random.default_rng(0).integers(0, 50, size=(9, 512))
out = mtt.TPUModel.from_module(mtt.build_network(spec, device="cpu"),
                               device="cpu", inputCol="t", outputCol="y",
                               batchSize=8).transform(mtt.DataTable({"t": toks}))
assert out["y"].shape == (9, 512, 50) and np.isfinite(out["y"]).all()
assert not any(m.split(".")[0] in ("jax", "flax", "mmlspark_tpu")
               for m, v in sys.modules.items() if v is not None)
print("OK")
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(REPO), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OK" in r.stdout
