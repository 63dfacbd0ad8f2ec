"""PyTorch port: int8 post-training quantization (``core/quantize.py``,
``TPUModel.quantize``, the linear models' ``quantize``) held against the
JAX package's ``core/quantize.py`` on the same numpy inputs.

Bitwise where the contract is exact: ``quantize_weight`` / scales, the
calibrator's clip at percentile 100 and 99.9, and the int8 product's
int32 accumulator (``int8_matmul`` against ``int8_matmul_host``, NaN rows
included). The set of quantized layers equals the JAX package's for the
MLP, ConvNet, ResNet, BiLSTM tagger and Transformer, with the same int8
kernels and weight scales. ``tests/test_quantize.py``'s accuracy floors
hold on the port, and a quantized linear model saved by either package
scores bitwise equal in the other.
"""

import functools
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.core import quantize as JQ
from mmlspark_tpu.core.serialize import load_stage as jload_stage
from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.models import linear as JL
from mmlspark_tpu.models.networks import build_network as jbuild

import mmlspark_tpu_torch as mtt
from mmlspark_tpu_torch import convert
from mmlspark_tpu_torch.core import quantize as PQ
from mmlspark_tpu_torch.core.stage import load_stage as pload_stage
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.models import linear as PL
from mmlspark_tpu_torch.models.learner import TPULearner
from mmlspark_tpu_torch.models.tpu_model import TPUModel


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


# ---------------------------------------------------------------------------
# the host half: bitwise copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_weight_and_scales_bitwise(seed):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(32, 5)) * np.array([1.0, 0.1, 10.0, 1e-30, 3.0])
    for w in (W, W.astype(np.float32), W.T, rng.normal(size=(3, 4, 6))):
        for axis in (-1, 0):
            np.testing.assert_array_equal(
                PQ.per_channel_scales(w, axis), JQ.per_channel_scales(w, axis))
            pq, ps = PQ.quantize_weight(w, axis)
            jq, js = JQ.quantize_weight(w, axis)
            assert pq.dtype == np.int8 and ps.dtype == np.float32
            np.testing.assert_array_equal(pq, jq)
            np.testing.assert_array_equal(ps, js)
        if w.ndim == 2:
            tq, ts = PQ.quantize_weight_t(torch.from_numpy(np.asarray(w)))
            np.testing.assert_array_equal(tq.numpy(),
                                          JQ.quantize_weight(w)[0])
            np.testing.assert_array_equal(ts.numpy(),
                                          JQ.quantize_weight(w)[1])
    for amax in (0.0, 1e-30, 0.37, 1e6):
        assert PQ.act_scale(amax).tobytes() == JQ.act_scale(amax).tobytes()
    assert PQ.QMAX == JQ.QMAX and PQ.QUANT_KEY == JQ.QUANT_KEY


@pytest.mark.parametrize("percentile", [100.0, 99.9])
def test_calibrator_amax_equal(percentile):
    rng = np.random.default_rng(3)
    x = rng.standard_t(3, size=(64, 300)).astype(np.float32)
    x[5, 7] = -80.0
    jc = JQ.ActivationCalibrator(percentile)
    jc.observe("a", x)
    for arg in (x, torch.from_numpy(x), torch.from_numpy(x).double()):
        pc = PQ.ActivationCalibrator(percentile)
        pc.observe("a", arg)
        assert pc.amax() == jc.amax()
        assert pc.scale("a").tobytes() == jc.scale("a").tobytes()
    # a bfloat16 tensor: its values exactly, as the JAX package's f64 max
    xb = torch.from_numpy(x).to(torch.bfloat16)
    pc = PQ.ActivationCalibrator(percentile)
    pc.observe("a", xb)
    jc2 = JQ.ActivationCalibrator(percentile)
    jc2.observe("a", xb.float().numpy())
    assert pc.amax() == jc2.amax()


def test_calibrator_percentile_and_thread_safety():
    cal = PQ.ActivationCalibrator(percentile=99.0)
    x = np.zeros(1000)
    x[-1] = 100.0               # the outlier the percentile clips
    cal.observe("a", x)
    assert cal.amax()["a"] < 100.0
    exact = PQ.ActivationCalibrator()
    threads = [threading.Thread(
        target=lambda i=i: exact.observe("a", torch.full((10,), float(i))))
        for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert exact.amax()["a"] == 15.0
    with pytest.raises(ValueError, match="percentile"):
        PQ.ActivationCalibrator(0.0)
    with pytest.raises(KeyError, match="no calibration"):
        exact.scale("b")


@pytest.mark.parametrize("shape", [(64, 16, 7), (1, 20, 10), (17, 2048, 24),
                                   (3, 5, 8, 3)])
def test_int8_matmul_bitwise_to_host_mirror(shape):
    """Integer accumulation is exact: the port's int8_matmul, the
    JAX package's jitted kernel and the numpy host mirror agree bit for
    bit, NaN rows included (NaN out, the other rows finite)."""
    *lead, k, n = shape
    rng = np.random.default_rng(sum(shape))
    X = rng.normal(size=tuple(lead) + (k,)).astype(np.float32)
    X.reshape(-1, k)[0, k // 2] = np.nan
    W = rng.normal(size=(k, n))
    wq, ws = JQ.quantize_weight(W)
    xs = JQ.act_scale(np.nanmax(np.abs(X)))
    host = PQ.int8_matmul_host(X, wq, xs, ws)
    np.testing.assert_array_equal(host, JQ.int8_matmul_host(X, wq, xs, ws))
    dev = PQ.int8_matmul(torch.from_numpy(X), torch.from_numpy(wq), xs,
                         torch.from_numpy(ws)).numpy()
    np.testing.assert_array_equal(dev, host)
    jdev = np.asarray(jax.jit(JQ.int8_matmul)(X, wq, xs, ws))
    np.testing.assert_array_equal(dev, jdev)
    flat = dev.reshape(-1, n)
    assert np.isnan(flat[0]).all() and np.isfinite(flat[1:]).all()
    assert PQ.LAUNCHES["int8_mm"] == 0        # CPU products never count


def test_int8_matmul_int_product_and_approximation():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(64, 16)).astype(np.float32)
    W = rng.normal(size=(16, 7))
    wq, ws = PQ.quantize_weight(W)
    xs = PQ.act_scale(np.abs(X).max())
    xq = PQ.quantize_act(torch.from_numpy(X), xs)
    assert xq.dtype == torch.int8
    acc = PQ.int8_mm(xq, torch.from_numpy(wq))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(
        acc.numpy(), xq.numpy().astype(np.int32) @ wq.astype(np.int32))
    dev = PQ.int8_matmul(torch.from_numpy(X), torch.from_numpy(wq), xs, ws)
    rel = np.abs(dev.numpy() - X @ W).max() / np.abs(X @ W).max()
    assert rel < 0.05, rel


# ---------------------------------------------------------------------------
# the quantized layers of each zoo network equal the JAX package's
# ---------------------------------------------------------------------------

NETS = {
    "mlp": ({"type": "mlp", "features": [16, 8], "num_classes": 3}, (6,)),
    "convnet": ({"type": "convnet", "conv_features": [4, 8],
                 "dense_features": [16], "num_classes": 3}, (8, 8, 3)),
    "resnet": ({"type": "resnet", "stage_sizes": [1, 1], "width": 4,
                "num_classes": 3}, (8, 8, 3)),
    "bilstm": ({"type": "bilstm", "vocab_size": 20, "embed_dim": 8,
                "hidden": 6, "num_tags": 3}, (5,)),
    "transformer": ({"type": "transformer", "vocab_size": 40, "dim": 16,
                     "depth": 2, "heads": 2, "max_len": 8}, (8,)),
}


def _inputs(spec, row_shape, n, seed=0):
    rng = np.random.default_rng(seed)
    if spec["type"] in ("bilstm", "transformer"):
        return rng.integers(0, spec["vocab_size"],
                            size=(n,) + row_shape).astype(np.int32)
    return rng.normal(size=(n,) + row_shape).astype(np.float32)


def _flax_vars(spec, row_shape, seed=1):
    """Flax variables of ``module.init``'s shapes (traced, not run) with
    values drawn from a numpy seed."""
    module = jbuild(spec)
    shapes = jax.eval_shape(functools.partial(module.init, train=False),
                            jax.random.PRNGKey(0),
                            jnp.asarray(_inputs(spec, row_shape, 1)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "var":
            a = rng.uniform(0.5, 2.0, shape)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.normal(size=shape)
        elif name in ("kernel", "embedding"):
            a = rng.normal(size=shape) / np.sqrt(max(np.prod(shape[:-1]), 1))
        else:
            a = 0.1 * rng.normal(size=shape)
        return np.asarray(a, np.float32)
    return module, jax.tree_util.tree_map_with_path(draw, shapes)


def _to_np(tree):
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.mark.parametrize("net", sorted(NETS))
def test_quantized_layers_equal_the_jax_packages(net):
    spec, row_shape = NETS[net]
    module, variables = _flax_vars(spec, row_shape)
    x = _inputs(spec, row_shape, n=24, seed=2)
    _, jweights = JQ.quantize_flax(module, variables, [jnp.asarray(x)])
    jquant = _to_np(jweights[JQ.QUANT_KEY])
    tm = convert.module_from_flax(spec, _to_np(variables), device="cpu")
    model = TPUModel.from_module(tm, device="cpu", inputCol="x",
                                 outputCol="y", batchSize=32)
    q = model.quantize({"x": x})
    assert q.get("precision") == "int8" and model.get("precision") == "f32"
    assert q.get("computeDtype") == "float32"
    pquant = q.get("weights")[PQ.QUANT_KEY]
    assert sorted(pquant) == sorted(jquant)
    if net == "bilstm":
        assert sorted(pquant) == ["head"]
    if net == "transformer":
        assert sorted(pquant) == sorted(
            [f"block_{i}/{n}" for i in range(2)
             for n in ("qkv", "proj", "mlp_up", "mlp_down")] + ["lm_head"])
    for path, jq in jquant.items():
        pq = {k: v.numpy() for k, v in pquant[path].items()}
        np.testing.assert_array_equal(pq["wq"], jq["wq"])
        np.testing.assert_array_equal(pq["w_scale"], jq["w_scale"])
        np.testing.assert_allclose(pq["x_scale"], jq["x_scale"], rtol=1e-5)
    # the int8 forwards agree, and stay near their f32 models
    table = DataTable({"x": x})
    f32 = model.transform(table)["y"]
    i8 = q.transform(table)["y"]
    jflax = np.asarray(module.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(f32, jflax, rtol=1e-4,
                               atol=1e-4 * np.abs(jflax).max())
    scale = np.abs(f32).max()
    assert np.abs(i8 - f32).max() <= 0.1 * scale, np.abs(i8 - f32).max()
    assert (i8.argmax(-1) == f32.argmax(-1)).mean() >= 0.9


def test_quantized_module_model_saves_and_loads(tmp_path):
    spec, row_shape = NETS["mlp"]
    module, variables = _flax_vars(spec, row_shape)
    tm = convert.module_from_flax(spec, _to_np(variables), device="cpu")
    m = TPUModel.from_module(tm, device="cpu", inputCol="x", outputCol="y")
    x = _inputs(spec, row_shape, n=40)
    q = m.quantize({"x": x[:16]}, percentile=99.0)
    q.save(str(tmp_path / "q"))
    back = pload_stage(str(tmp_path / "q"))
    assert back.get("precision") == "int8"
    assert back.get("weights")[PQ.QUANT_KEY]["head"]["wq"].dtype == \
        torch.int8
    table = DataTable({"x": x})
    np.testing.assert_array_equal(back.transform(table)["y"],
                                  q.transform(table)["y"])
    assert back.metrics()["precision"] == "int8"


def test_quantize_refuses_what_it_cannot_quantize(tmp_path):
    from tests import onnx_writer as ow
    from mmlspark_tpu_torch.importers import import_onnx_model
    m = TPUModel.from_fn(lambda w, ins: list(ins.values())[0],
                         {"w": torch.ones(1)}, inputCol="x", device="cpu")
    with pytest.raises(ValueError, match="module model"):
        m.quantize({"x": np.ones((4, 2), np.float32)})
    p = tmp_path / "g.onnx"
    p.write_bytes(ow.model([ow.node("MatMul", ["input", "w"], ["output"])],
                           {"w": np.ones((2, 3), np.float32)},
                           "input", "output"))
    onnx = import_onnx_model(str(p), device="cpu")
    with pytest.raises(ValueError, match="ONNX"):
        onnx.quantize({"images": np.ones((4, 2), np.float32)})
    spec, row_shape = NETS["mlp"]
    tm = convert.module_from_flax(spec, _to_np(_flax_vars(
        spec, row_shape)[1]), device="cpu")
    f32 = TPUModel.from_module(tm, device="cpu", inputCol="x")
    with pytest.raises(ValueError, match="calibration row"):
        f32.quantize({"x": np.zeros((0, 6), np.float32)})
    with pytest.raises(ValueError, match="set by quantize"):
        f32.set("precision", "int8")
    assert f32.get("precision") == "f32"
    sparse_model = PL.TPULogisticRegressionModel(
        weights={"W": np.ones((4, 2)), "b": np.zeros(2)})
    with pytest.raises(ValueError, match="dense"):
        sparse_model.quantize(DataTable({"features": np.ones((4, 4))}))
    with pytest.raises(ValueError, match="fitted"):
        PL.TPULinearRegressionModel().quantize(
            DataTable({"features": np.ones((4, 4))}))


# ---------------------------------------------------------------------------
# tests/test_quantize.py's accuracy floors, held by the port
# ---------------------------------------------------------------------------

class TestAccuracyFloors:
    def test_logistic_breast_cancer_agreement(self):
        from sklearn.datasets import load_breast_cancer
        X, y = load_breast_cancer(return_X_y=True)
        t = DataTable({"features": X.astype(np.float64),
                       "label": y.astype(np.float64)})
        m = PL.TPULogisticRegression(maxIter=150, device="cpu").fit(t)
        q = m.quantize(t)
        assert q.get("precision") == "int8"
        assert m.get("precision") == "f32"   # oracle untouched
        pf, pq = m.transform(t), q.transform(t)
        agree = (pf["prediction"] == pq["prediction"]).mean()
        assert agree >= 0.995, agree
        perr = np.abs(pf["probability"] - pq["probability"]).max()
        assert perr <= 0.15, perr

    def test_mlp_digits_agreement(self):
        from sklearn.datasets import load_digits
        X, y = load_digits(return_X_y=True)
        X = (X / 16.0).astype(np.float32)
        learner = TPULearner(
            networkSpec={"type": "mlp", "features": [64, 32],
                         "num_classes": 10},
            optimizer="adam", learningRate=1e-2, schedule="constant",
            batchSize=len(X), epochs=60, computeDtype="float32",
            device="cpu", logEvery=60)
        m = learner.fit(DataTable({"features": X, "label": y}))
        m.set("batchSize", 256)
        q = m.quantize({"features": X[:256]})
        t = DataTable({"features": X})
        sf = m.transform(t)["scores"]
        sq = q.transform(t)["scores"]
        assert (sf.argmax(-1) == y).mean() >= 0.97   # a real model
        agree = (sf.argmax(-1) == sq.argmax(-1)).mean()
        assert agree >= 0.995, agree
        assert np.abs(_softmax(sf) - _softmax(sq)).max() <= 0.15

    def test_linear_regression_diabetes_error_bound(self):
        from sklearn.datasets import load_diabetes
        X, y = load_diabetes(return_X_y=True)
        t = DataTable({"features": X, "label": y})
        m = PL.TPULinearRegression(maxIter=200, device="cpu").fit(t)
        q = m.quantize(t)
        pf = m.transform(t)["prediction"]
        pq = q.transform(t)["prediction"]
        rel = np.abs(pf - pq).max() / np.abs(pf).max()
        assert rel <= 0.03, rel

    def test_quantized_model_save_load_roundtrip(self, tmp_path):
        from sklearn.datasets import load_breast_cancer
        X, y = load_breast_cancer(return_X_y=True)
        t = DataTable({"features": X, "label": y.astype(np.float64)})
        q = PL.TPULogisticRegression(maxIter=50, device="cpu"
                                     ).fit(t).quantize(t)
        q.save(str(tmp_path / "qmodel"))
        q2 = pload_stage(str(tmp_path / "qmodel"))
        assert q2.get("precision") == "int8"
        assert q2.get("weights")["wq"].dtype == np.int8
        np.testing.assert_array_equal(q.transform(t)["prediction"],
                                      q2.transform(t)["prediction"])


@pytest.mark.parametrize("percentile", [100.0, 99.0])
@pytest.mark.parametrize("family", ["logistic", "linear"])
def test_quantize_equals_the_jax_packages_on_equal_weights(family,
                                                           percentile):
    """Given the JAX package's fitted f32 weights, the port's quantize
    gives the same int8 weights and scales, and scores bitwise equal."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(300, 6)) * [1, 5, 0.1, 2, 1, 3]
    y = ((X[:, 0] - 0.3 * X[:, 1]) > 0).astype(np.float64) \
        if family == "logistic" else X @ rng.normal(size=6)
    jt = JTable({"features": X, "label": y})
    pt = DataTable({"features": X, "label": y})
    jest = (JL.TPULogisticRegression if family == "logistic"
            else JL.TPULinearRegression)(maxIter=40)
    jm = jest.fit(jt)
    pcls = (PL.TPULogisticRegressionModel if family == "logistic"
            else PL.TPULinearRegressionModel)
    pm = pcls(weights={k: np.asarray(v)
                       for k, v in jm.get("weights").items()})
    jq = jm.quantize(jt, percentile=percentile)
    pq = pm.quantize(pt, percentile=percentile)
    for k, v in jq.get("weights").items():
        np.testing.assert_array_equal(pq.get("weights")[k], np.asarray(v))
    for col in (["rawPrediction", "probability", "prediction"]
                if family == "logistic" else ["prediction"]):
        np.testing.assert_array_equal(pq.transform(pt)[col],
                                      np.asarray(jq.transform(jt)[col]))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("family", ["logistic", "linear"])
def test_quantized_linear_models_cross_packages(tmp_path, direction, family):
    """A quantized linear model saved by either package loads in the
    other and scores bitwise equal (int8 host path in both)."""
    from sklearn.datasets import load_breast_cancer, load_diabetes
    if family == "logistic":
        X, y = load_breast_cancer(return_X_y=True)
        y = y.astype(np.float64)
    else:
        X, y = load_diabetes(return_X_y=True)
    jt = JTable({"features": X, "label": y})
    pt = DataTable({"features": X, "label": y})
    if direction == "jax_to_port":
        est = (JL.TPULogisticRegression if family == "logistic"
               else JL.TPULinearRegression)(maxIter=50)
        src, load, src_t, dst_t = est.fit(jt).quantize(jt), pload_stage, \
            jt, pt
    else:
        est = (PL.TPULogisticRegression if family == "logistic"
               else PL.TPULinearRegression)(maxIter=50, device="cpu")
        src, load, src_t, dst_t = est.fit(pt).quantize(pt), jload_stage, \
            pt, jt
    src.save(str(tmp_path / "q"))
    loaded = load(str(tmp_path / "q"))
    assert loaded.get("precision") == "int8"
    for k, v in src.get("weights").items():
        np.testing.assert_array_equal(np.asarray(loaded.get("weights")[k]),
                                      np.asarray(v))
    col = "probability" if family == "logistic" else "prediction"
    np.testing.assert_array_equal(np.asarray(loaded.transform(dst_t)[col]),
                                  np.asarray(src.transform(src_t)[col]))


def test_quantize_stage_and_precision_label():
    X = np.random.default_rng(0).normal(size=(50, 3))
    y = (X[:, 0] > 0).astype(np.float64)
    t = DataTable({"features": X, "label": y})
    m = PL.TPULogisticRegression(maxIter=10, device="cpu").fit(t)
    q, done = PQ.quantize_stage(m, t, percentile=99.0)
    assert done and PQ.stage_precision(q) == "int8"
    assert PQ.stage_precision(m) == "f32"
    same, done = PQ.quantize_stage(mtt.DataTable, t)
    assert same is mtt.DataTable and not done
