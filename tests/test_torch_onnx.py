"""PyTorch port: ONNX ingestion (``importers/onnx_import.py``: the copied
wire parser and load validation, the torch executor, ``import_onnx_model``
and the CLI's ``import-onnx``) held against the JAX package's.

Every scenario of ``tests/test_onnx_import.py`` runs here on the same
ONNX bytes (written by ``tests/onnx_writer.py``, numpy only): each graph
goes through the port's executor and the JAX ``OnnxApply`` on the same
inputs and agrees within rtol 2e-4 / atol 2e-4, and each refusal at load
raises the same exception type with the same message in both. The one
exception is the stated BatchNormalization difference on a 1-D graph
(``test_batchnorm_1d_divergence``). Both flows of
``examples/onnx_inference.py`` (a local repo, and a WebDAV one read back
through ``HTTPRepo``) and ``import-onnx`` run on the port too.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.importers import onnx_import as J

import mmlspark_tpu_torch as mtt
from mmlspark_tpu_torch.core.stage import load_stage
from mmlspark_tpu_torch.importers import onnx_import as P
from tests import onnx_writer as ow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = ATOL = 2e-4


def _write(tmp_path, nodes, inits=None, inp="input", out="output",
           opset=17, int_names=(), name="g.onnx"):
    p = tmp_path / name
    p.write_bytes(ow.model(nodes, inits or {}, inp, out, opset=opset,
                           int_data_names=int_names))
    return str(p)


def _run_both(path, feeds, input_shape=None):
    """(port output, JAX output) of one graph on the same numpy feeds."""
    jg = J.load_onnx(path)
    want = J.OnnxApply(jg, input_shape)(
        {k: np.asarray(v) for k, v in jg.initializers.items()}, feeds)
    pg = P.load_onnx(path)
    got = P.OnnxApply(pg, input_shape)(
        {k: P._weight_tensor(v) for k, v in pg.initializers.items()},
        {k: torch.from_numpy(np.asarray(v)) for k, v in feeds.items()})
    if isinstance(want, tuple):
        return [g.numpy() for g in got], [np.asarray(w) for w in want]
    return got.numpy(), np.asarray(want)


def _agree(path, feeds, **kw):
    got, want = _run_both(path, feeds, **kw)
    for g, w in (zip(got, want) if isinstance(got, list)
                 else [(got, want)]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    return got, want


def _both_refuse(fn_name, path, match, exc=ValueError, **kw):
    """The same refusal (type and message) from both packages."""
    msgs = []
    for mod in (P, J):
        with pytest.raises(exc, match=match) as e:
            getattr(mod, fn_name)(path, **kw)
        assert type(e.value) is exc
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _models_agree(path, table_cols, port_kw=None, **kw):
    """import_onnx_model in both packages, transformed on the same
    columns: (port scores, JAX scores), within the tolerance."""
    pm = P.import_onnx_model(path, device="cpu", **{**kw, **(port_kw or {})})
    jm = J.import_onnx_model(path, **kw)
    got = pm.transform(mtt.DataTable(table_cols))["scores"]
    want = np.asarray(jm.transform(JTable(table_cols))["scores"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    return pm, got, want


@pytest.fixture(scope="module")
def resnet18_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("onnx") / "resnet18.onnx")
    weights = ow.resnet18_onnx(path, num_classes=10, width=8, seed=3)
    return path, weights


# ---------------------------------------------------------------------------
# wire parsing
# ---------------------------------------------------------------------------

class TestWireParsing:
    def test_summary(self, resnet18_file):
        path, weights = resnet18_file
        s = P.onnx_summary(path)
        assert s == J.onnx_summary(path)
        assert s["ops"]["Conv"] == 20 and s["ops"]["Gemm"] == 1
        assert s["num_initializers"] == len(weights)

    def test_initializer_roundtrip(self, resnet18_file):
        path, weights = resnet18_file
        graph, jgraph = P.load_onnx(path), J.load_onnx(path)
        assert graph.opset == jgraph.opset
        assert graph.inputs == jgraph.inputs == ["input"]
        assert [(n.op_type, n.inputs, n.outputs) for n in graph.nodes] == \
            [(n.op_type, n.inputs, n.outputs) for n in jgraph.nodes]
        for name, arr in weights.items():
            np.testing.assert_array_equal(graph.initializers[name], arr)

    def test_unsupported_op_rejected(self, tmp_path):
        p = tmp_path / "bad.onnx"
        p.write_bytes(ow.model([ow.node("Einsum", ["x"], ["y"])], {},
                               "x", "y"))
        _both_refuse("load_onnx", str(p), "Einsum")

    def test_not_onnx_rejected(self, tmp_path):
        p = tmp_path / "junk.onnx"
        p.write_bytes(b"\x00\x01\x02")
        _both_refuse("load_onnx", str(p), "ONNX")

    def test_truncated_file_fails_fast(self, resnet18_file, tmp_path):
        path, _ = resnet18_file
        with open(path, "rb") as f:
            blob = f.read()
        p = tmp_path / "trunc.onnx"
        p.write_bytes(blob[:len(blob) // 2])
        _both_refuse("load_onnx", str(p), "ONNX")

    def test_float16_bit_pattern_payload(self, tmp_path):
        """FLOAT16 int32_data carries uint16 BIT PATTERNS per spec."""
        vals = np.asarray([1.0, -2.5, 0.5], np.float16)
        body = ow._int_field(1, 3) + ow._int_field(2, 10)
        for b in vals.view(np.uint16):
            body += ow._int_field(5, int(b))
        body += ow._ld(8, b"w")
        graph = ow._ld(1, ow.node("Identity", ["input"], ["output"])) \
            + ow._ld(5, body) + ow._ld(11, ow._value_info("input")) \
            + ow._ld(12, ow._value_info("output"))
        p = tmp_path / "f16.onnx"
        p.write_bytes(ow._int_field(1, 8) + ow._ld(7, graph))
        got = P.load_onnx(str(p)).initializers["w"]
        assert got.dtype == np.float16
        np.testing.assert_array_equal(got, vals)
        np.testing.assert_array_equal(
            got, J.load_onnx(str(p)).initializers["w"])


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

class TestExecution:
    def test_resnet18_matches(self, resnet18_file):
        path, _ = resnet18_file
        x = np.random.default_rng(0).normal(size=(2, 3, 48, 48)
                                            ).astype(np.float32)
        _agree(path, {"images": x})

    def test_through_tpu_model(self, resnet18_file):
        path, _ = resnet18_file
        x = np.random.default_rng(1).normal(size=(6, 3, 32, 32)
                                            ).astype(np.float32)
        model, got, want = _models_agree(
            path, {"images": x.reshape(6, -1)}, batch_size=4,
            input_shape=[3, 32, 32])
        assert np.array_equal(got.argmax(1), want.argmax(1))
        assert model.get("computeDtype") == "float32"
        assert model.get("inputCol") == "images"

    def test_pool_variants_and_clip(self, tmp_path):
        x = np.random.default_rng(2).normal(size=(2, 3, 8, 8)
                                            ).astype(np.float32)
        nodes = [
            ow.node("AveragePool", ["input"], ["ap"], kernel_shape=[2, 2],
                    strides=[2, 2], pads=[0, 0, 0, 0]),
            ow.node("Clip", ["ap"], ["cl"], min=-0.5, max=0.5),
            ow.node("Reshape", ["cl", "shape"], ["output"]),
        ]
        p = _write(tmp_path, nodes, {"shape": np.asarray([0, -1],
                                                         np.int64)})
        _agree(p, {"images": x})
        _models_agree(p, {"images": x.reshape(2, -1)}, batch_size=2,
                      input_shape=[3, 8, 8])

    @pytest.mark.parametrize("include", [0, 1])
    def test_padded_pools(self, tmp_path, include):
        """Pads on the pools (the resnet stem's MaxPool, and an
        AveragePool counting or not counting its pads)."""
        x = np.random.default_rng(3).normal(size=(2, 3, 9, 7)
                                            ).astype(np.float32)
        nodes = [
            ow.node("MaxPool", ["input"], ["mp"], kernel_shape=[3, 3],
                    strides=[2, 2], pads=[1, 0, 1, 2]),
            ow.node("AveragePool", ["mp"], ["output"], kernel_shape=[2, 3],
                    strides=[1, 2], pads=[1, 1, 0, 1],
                    count_include_pad=include),
        ]
        _agree(_write(tmp_path, nodes), {"input": x})


class TestDownloaderPublish:
    def test_publish_and_reload(self, resnet18_file, tmp_path):
        from mmlspark_tpu_torch.downloader import LocalRepo
        path, _ = resnet18_file
        repo = LocalRepo(str(tmp_path / "repo"))
        with open(path, "rb") as f:
            blob = f.read()
        repo.publish("onnx_resnet18",
                     {"format": "onnx", "onnx_summary": P.onnx_summary(path)},
                     blob=blob, model_type="classification")
        got = repo.get_schema("onnx_resnet18")
        assert got.network_spec["onnx_summary"]["ops"]["Conv"] == 20
        blob2 = repo.read_blob(got, verify=True)
        assert blob2 == blob
        p2 = tmp_path / "reload.onnx"
        p2.write_bytes(blob2)
        assert P.import_onnx_model(str(p2), device="cpu") is not None


class TestOpVariants:
    def test_matmul_and_constant(self, tmp_path):
        rng = np.random.default_rng(5)
        nodes = [ow.node("MatMul", ["input", "w"], ["mm"]),
                 ow.node("Constant", [], ["c"],
                         value=np.asarray([1.0, 2.0, 3.0], np.float32)),
                 ow.node("Add", ["mm", "c"], ["output"])]
        p = _write(tmp_path, nodes,
                   {"w": rng.normal(size=(6, 3)).astype(np.float32)})
        _agree(p, {"images": rng.normal(size=(4, 6)).astype(np.float32)})

    @pytest.mark.parametrize("transA,transB", [(0, 0), (0, 1), (1, 0)])
    def test_gemm_transpose_variants(self, tmp_path, transA, transB):
        rng = np.random.default_rng(6)
        A = rng.normal(size=(5, 4)).astype(np.float32)
        B = rng.normal(size=(4, 3)).astype(np.float32)
        nodes = [ow.node("Gemm", ["input", "w", "b"], ["output"],
                         alpha=1.0, beta=0.5, transA=transA,
                         transB=transB)]
        p = _write(tmp_path, nodes,
                   {"w": B.T if transB else B,
                    "b": rng.normal(size=3).astype(np.float32)})
        got, _ = _agree(p, {"images": A.T if transA else A})
        np.testing.assert_allclose(
            got, A @ B + 0.5 * P.load_onnx(p).initializers["b"],
            rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the BiLSTM tagger (integer inputs, dynamic batch, int64_data reshape)
# ---------------------------------------------------------------------------

def _torch_bilstm(vocab, embed, hidden, tags, seed=0):
    torch.manual_seed(seed)

    class Tagger(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = torch.nn.Embedding(vocab, embed)
            self.lstm = torch.nn.LSTM(embed, hidden, batch_first=True,
                                      bidirectional=True)
            self.fc = torch.nn.Linear(2 * hidden, tags)

        def forward(self, ids):
            h, _ = self.lstm(self.embed(ids))
            return self.fc(h)
    return Tagger()


class TestBiLSTMImport:
    V, E, H, TAGS, T = 50, 16, 24, 7, 12

    @pytest.fixture(scope="class")
    def bilstm_file(self, tmp_path_factory):
        net = _torch_bilstm(self.V, self.E, self.H, self.TAGS)
        sd = {k: v.detach().numpy() for k, v in net.state_dict().items()}
        path = tmp_path_factory.mktemp("onnx") / "bilstm.onnx"
        ow.bilstm_onnx(str(path), sd, seq_len=self.T)
        return str(path), net

    def test_summary_and_flags(self, bilstm_file):
        path, _ = bilstm_file
        s = P.onnx_summary(path)
        assert s == J.onnx_summary(path) and s["ops"]["LSTM"] == 1
        assert P.OnnxApply(P.load_onnx(path)).int_input
        model = P.import_onnx_model(path, batch_size=4, device="cpu")
        assert model.get("modelFn").input_shape == (self.T,) == \
            J.import_onnx_model(path, batch_size=4).get(
                "modelFn").input_shape

    def test_matches(self, bilstm_file):
        path, net = bilstm_file
        ids = np.random.default_rng(7).integers(0, self.V, size=(5, self.T))
        got, _ = _agree(path, {"tokens": ids.astype(np.int32)})
        with torch.no_grad():
            ref = net(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-5)

    def test_through_tpu_model_dynamic_batch(self, bilstm_file):
        path, _ = bilstm_file
        rng = np.random.default_rng(8)
        for n in (3, 6):
            ids = rng.integers(0, self.V, size=(n, self.T)).astype(np.int32)
            _, got, want = _models_agree(path, {"images": ids},
                                         batch_size=4)
            assert np.array_equal(got.argmax(-1), want.argmax(-1))

    def test_forward_only_lstm(self, tmp_path):
        torch.manual_seed(3)
        lstm = torch.nn.LSTM(self.E, self.H, batch_first=False)
        sd = {k: v.detach().numpy() for k, v in lstm.state_dict().items()}
        nodes = [ow.node("LSTM", ["input", "W", "R", "B"],
                         ["y", "yh", "yc"], hidden_size=self.H),
                 ow.node("Squeeze", ["y", "sq_axes"], ["output"])]
        inits = {"W": ow._iofc(sd["weight_ih_l0"])[None],
                 "R": ow._iofc(sd["weight_hh_l0"])[None],
                 "B": np.concatenate([ow._iofc(sd["bias_ih_l0"]),
                                      ow._iofc(sd["bias_hh_l0"])])[None],
                 "sq_axes": np.asarray([1], np.int64)}
        X = np.random.default_rng(9).normal(
            size=(self.T, 4, self.E)).astype(np.float32)
        got, _ = _agree(_write(tmp_path, nodes, inits), {"input": X})
        with torch.no_grad():
            ref, _ = lstm(torch.from_numpy(X))
        np.testing.assert_allclose(got, ref.numpy(), rtol=2e-4, atol=1e-5)

    def test_lstm_outputs_and_initial_state(self, tmp_path):
        """All three LSTM outputs, reverse direction, with h0 / c0."""
        rng = np.random.default_rng(10)
        E, H, T, B = 5, 4, 6, 3
        inits = {"W": rng.normal(scale=0.4, size=(1, 4 * H, E)),
                 "R": rng.normal(scale=0.4, size=(1, 4 * H, H)),
                 "B": rng.normal(scale=0.1, size=(1, 8 * H)),
                 "h0": rng.normal(size=(1, B, H)),
                 "c0": rng.normal(size=(1, B, H))}
        inits = {k: v.astype(np.float32) for k, v in inits.items()}
        nodes = [ow.node("LSTM", ["input", "W", "R", "B", "", "h0", "c0"],
                         ["y", "yh", "yc"], hidden_size=H,
                         direction="reverse"),
                 ow.node("Concat", ["yh", "yc"], ["output"], axis=2)]
        X = rng.normal(size=(T, B, E)).astype(np.float32)
        _agree(_write(tmp_path, nodes, inits), {"input": X})


# ---------------------------------------------------------------------------
# the op matrix
# ---------------------------------------------------------------------------

class TestOpMatrix:
    @pytest.mark.parametrize("op", ["Sigmoid", "Tanh", "Neg", "Exp", "Sqrt",
                                    "Relu", "Erf"])
    def test_unary(self, tmp_path, op):
        x = np.random.default_rng(1).normal(size=(3, 5)).astype(np.float32)
        if op == "Sqrt":
            x = np.abs(x) + 1
        _agree(_write(tmp_path, [ow.node(op, ["input"], ["output"])]),
               {"input": x})

    @pytest.mark.parametrize("op", ["Sub", "Mul", "Div", "Pow", "Add"])
    def test_binary_broadcast(self, tmp_path, op):
        rng = np.random.default_rng(2)
        x = rng.normal(size=(4, 5)).astype(np.float32) + 3
        w = rng.normal(size=(5,)).astype(np.float32) / 4 + 2
        _agree(_write(tmp_path, [ow.node(op, ["input", "w"], ["output"])],
                      {"w": w}), {"input": x})

    def test_leaky_relu(self, tmp_path):
        x = np.random.default_rng(3).normal(size=(6,)).astype(np.float32)
        _agree(_write(tmp_path, [ow.node("LeakyRelu", ["input"], ["output"],
                                         alpha=0.1)]), {"input": x})

    @pytest.mark.parametrize("axis", [-1, 1])
    def test_softmax_modern(self, tmp_path, axis):
        x = np.random.default_rng(4).normal(size=(3, 4, 5)).astype(np.float32)
        _agree(_write(tmp_path, [ow.node("Softmax", ["input"], ["output"],
                                         axis=axis)]), {"input": x})

    def test_softmax_legacy_flattens(self, tmp_path):
        x = np.random.default_rng(5).normal(size=(2, 3, 4)).astype(np.float32)
        got, _ = _agree(_write(tmp_path, [ow.node(
            "Softmax", ["input"], ["output"], axis=1)], opset=12),
            {"input": x})
        flat = x.reshape(2, 12)
        e = np.exp(flat - flat.max(1, keepdims=True))
        np.testing.assert_allclose(
            got, (e / e.sum(1, keepdims=True)).reshape(x.shape),
            rtol=1e-5, atol=1e-6)

    def test_log_softmax(self, tmp_path):
        x = np.random.default_rng(6).normal(size=(3, 7)).astype(np.float32)
        _agree(_write(tmp_path, [ow.node("LogSoftmax", ["input"], ["output"],
                                         axis=-1)]), {"input": x})

    def test_concat_transpose(self, tmp_path):
        rng = np.random.default_rng(7)
        nodes = [ow.node("Concat", ["input", "w"], ["c"], axis=1),
                 ow.node("Transpose", ["c"], ["output"], perm=[2, 0, 1])]
        _agree(_write(tmp_path, nodes,
                      {"w": rng.normal(size=(2, 5, 4)).astype(np.float32)}),
               {"input": rng.normal(size=(2, 3, 4)).astype(np.float32)})

    def test_squeeze_unsqueeze_opset13_inputs(self, tmp_path):
        x = np.random.default_rng(8).normal(size=(3, 1, 5)).astype(np.float32)
        nodes = [ow.node("Squeeze", ["input", "sq"], ["s"]),
                 ow.node("Unsqueeze", ["s", "us"], ["output"])]
        got, _ = _agree(_write(
            tmp_path, nodes, {"sq": np.asarray([1], np.int64),
                              "us": np.asarray([0, -1], np.int64)},
            opset=13, int_names=("sq", "us")), {"input": x})
        assert got.shape == (1, 3, 5, 1)

    def test_squeeze_unsqueeze_opset11_attrs(self, tmp_path):
        x = np.random.default_rng(9).normal(size=(3, 1, 5)).astype(np.float32)
        nodes = [ow.node("Squeeze", ["input"], ["s"], axes=[1]),
                 ow.node("Unsqueeze", ["s"], ["output"], axes=[2])]
        got, _ = _agree(_write(tmp_path, nodes, opset=11), {"input": x})
        assert got.shape == (3, 5, 1)

    @pytest.mark.parametrize("case", ["opset10", "negative_reverse"])
    def test_slice_inputs(self, tmp_path, case):
        if case == "opset10":
            x = np.arange(60, dtype=np.float32).reshape(3, 4, 5)
            inits = {"st": np.asarray([1, 0], np.int64),
                     "en": np.asarray([3, (1 << 63) - 1], np.int64),
                     "ax": np.asarray([0, 2], np.int64),
                     "sp": np.asarray([1, 2], np.int64)}
            ref = x[1:3, :, ::2]
        else:
            x = np.arange(24, dtype=np.float32).reshape(4, 6)
            inits = {"st": np.asarray([-1], np.int64),
                     "en": np.asarray([-(1 << 63)], np.int64),
                     "ax": np.asarray([1], np.int64),
                     "sp": np.asarray([-2], np.int64)}
            ref = x[:, ::-2]
        nodes = [ow.node("Slice", ["input", "st", "en", "ax", "sp"],
                         ["output"])]
        got, _ = _agree(_write(tmp_path, nodes, inits,
                               int_names=("st", "en", "ax", "sp")),
                        {"input": x})
        np.testing.assert_array_equal(got, ref)

    def test_slice_opset9_attrs(self, tmp_path):
        x = np.arange(20, dtype=np.float32).reshape(4, 5)
        got, _ = _agree(_write(tmp_path, [ow.node(
            "Slice", ["input"], ["output"], starts=[1], ends=[3],
            axes=[0])], opset=9), {"input": x})
        np.testing.assert_array_equal(got, x[1:3])

    def test_gather_and_cast(self, tmp_path):
        x = np.random.default_rng(10).normal(size=(6, 3)).astype(np.float32)
        nodes = [ow.node("Gather", ["input", "idx"], ["g"], axis=0),
                 ow.node("Cast", ["g"], ["output"], to=6)]
        got, want = _agree(_write(
            tmp_path, nodes, {"idx": np.asarray([4, 0, 5], np.int64)}),
            {"input": x})
        assert got.dtype == np.int32 == want.dtype

    def test_reduce_mean(self, tmp_path):
        x = np.random.default_rng(11).normal(size=(2, 3, 4)).astype(np.float32)
        _agree(_write(tmp_path, [ow.node("ReduceMean", ["input"], ["output"],
                                         axes=[1], keepdims=0)]),
               {"input": x})

    def test_shape_gather_concat_reshape_chain(self, tmp_path):
        """The torch.onnx.export dynamic-reshape idiom: Shape -> Gather
        -> Unsqueeze -> Concat -> Reshape, through TPUModel; the chain
        stays numpy on the host."""
        x = np.random.default_rng(12).normal(size=(4, 6)).astype(np.float32)
        nodes = [ow.node("Shape", ["input"], ["sh"]),
                 ow.node("Gather", ["sh", "zero"], ["b"], axis=0),
                 ow.node("Unsqueeze", ["b", "us0"], ["b1"]),
                 ow.node("Concat", ["b1", "rest"], ["tgt"], axis=0),
                 ow.node("Reshape", ["input", "tgt"], ["r"]),
                 ow.node("Flatten", ["r"], ["output"], axis=1)]
        inits = {"zero": np.asarray(0, np.int64),
                 "us0": np.asarray([0], np.int64),
                 "rest": np.asarray([2, 3], np.int64)}
        p = tmp_path / "chain.onnx"
        p.write_bytes(ow.model(nodes, inits, ("input", 1, ["N", 6]),
                               "output", int_data_names=("us0", "rest")))
        _, got, _ = _models_agree(str(p), {"images": x}, batch_size=4)
        np.testing.assert_allclose(got, x, rtol=1e-6)

    def test_negative_int64_data_initializer(self, tmp_path):
        x = np.random.default_rng(13).normal(size=(2, 3, 4)).astype(np.float32)
        got, _ = _agree(_write(
            tmp_path, [ow.node("Reshape", ["input", "shape"], ["output"])],
            {"shape": np.asarray([0, -1], np.int64)}, int_names=("shape",)),
            {"input": x})
        assert got.shape == (2, 12)


# ---------------------------------------------------------------------------
# refusals at load: the same type and message in both packages
# ---------------------------------------------------------------------------

_Z = np.zeros

REFUSALS = {
    "auto_pad": ([ow.node("Conv", ["input", "w"], ["output"],
                          kernel_shape=[3, 3], auto_pad="SAME_UPPER")],
                 {"w": _Z((4, 3, 3, 3), np.float32)}, 17, "auto_pad"),
    "ceil_mode": ([ow.node("MaxPool", ["input"], ["output"],
                           kernel_shape=[2, 2], ceil_mode=1)], {}, 17,
                  "ceil_mode"),
    "maxpool_dilations": ([ow.node("MaxPool", ["input"], ["output"],
                                   kernel_shape=[2, 2], dilations=[2, 2])],
                          {}, 17, "dilated"),
    "lstm_activations": ([ow.node("LSTM", ["input", "W", "R"], ["output"],
                                  hidden_size=4,
                                  activations=["Relu", "Tanh", "Tanh"])],
                         {"W": _Z((1, 16, 3), np.float32),
                          "R": _Z((1, 16, 4), np.float32)}, 17,
                         "activations"),
    "lstm_layout": ([ow.node("LSTM", ["input", "W", "R"], ["output"],
                             hidden_size=4, layout=1)],
                    {"W": _Z((1, 16, 3), np.float32),
                     "R": _Z((1, 16, 4), np.float32)}, 17, "layout"),
    "opset_5": ([ow.node("Relu", ["input"], ["output"])], {}, 5, "opset"),
    "opset_40": ([ow.node("Relu", ["input"], ["output"])], {}, 40, "opset"),
    "reshape_allowzero": ([ow.node("Reshape", ["input", "s"], ["output"],
                                   allowzero=1)],
                          {"s": np.asarray([1, -1], np.int64)}, 17,
                          "allowzero"),
    "lstm_peephole": ([ow.node("LSTM", ["input", "W", "R", "", "", "", "",
                                        "P"], ["output"], hidden_size=4)],
                      {"W": _Z((1, 16, 3), np.float32),
                       "R": _Z((1, 16, 4), np.float32),
                       "P": _Z((1, 12), np.float32)}, 17, "peephole"),
    "unsqueeze_attr_axes": ([ow.node("Unsqueeze", ["input"], ["output"],
                                     axes=[0])], {}, 13, "axes"),
    "conv3d_weight_rank": ([ow.node("Conv", ["input", "w"], ["output"])],
                           {"w": _Z((4, 3, 3, 3, 3), np.float32)}, 17,
                           "rank 5"),
    "conv3d_kernel": ([ow.node("Conv", ["input", "w"], ["output"],
                               kernel_shape=[3, 3, 3])],
                      {"w": _Z((4, 3, 3, 3, 3), np.float32)}, 17, "1-D/2-D"),
    "gru_activations": ([ow.node("GRU", ["input", "W", "R"], ["output"],
                                 hidden_size=4,
                                 activations=["Relu", "Tanh"])],
                        {"W": _Z((1, 12, 3), np.float32),
                         "R": _Z((1, 12, 4), np.float32)}, 17,
                        "activations"),
    "argmax_select_last_index": ([ow.node("ArgMax", ["input"], ["output"],
                                          select_last_index=1)], {}, 17,
                                 "select_last_index"),
    "reduce_sum_attr_opset13": ([ow.node("ReduceSum", ["input"], ["output"],
                                         axes=[0])], {}, 13, "opset 13"),
    "split_attr_opset13": ([ow.node("Split", ["input"], ["a", "b"], axis=0,
                                    split=[1, 1])], {}, 13, "split"),
    "cast_target": ([ow.node("Cast", ["input"], ["output"], to=8)], {}, 17,
                    "cast target"),
    "concat_axis": ([ow.node("Concat", ["input", "input"], ["output"])], {},
                    17, "axis"),
    "lstm_sequence_lens": ([ow.node("LSTM", ["input", "W", "R", "", "sl"],
                                    ["output"], hidden_size=4)],
                           {"W": _Z((1, 16, 3), np.float32),
                            "R": _Z((1, 16, 4), np.float32),
                            "sl": _Z((2,), np.int32)}, 17, "sequence_lens"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_load_validation_refusals(tmp_path, case):
    nodes, inits, opset, match = REFUSALS[case]
    _both_refuse("load_onnx", _write(tmp_path, nodes, inits, opset=opset),
                 match)


def test_unsupported_constant_form_rejected(tmp_path):
    p = tmp_path / "bad.onnx"
    p.write_bytes(ow.model([ow.node("Constant", [], ["c"],
                                    value_string="oops")], {}, "x", "c"))
    _both_refuse("load_onnx", str(p), "constant")


def test_reduce_mean_opset18_axes_input(tmp_path):
    x = np.random.default_rng(14).normal(size=(2, 3, 4)).astype(np.float32)
    p = tmp_path / "rm18.onnx"
    p.write_bytes(ow.model([ow.node("ReduceMean", ["input", "ax"], ["output"],
                                    keepdims=0)],
                           {"ax": np.asarray([2], np.int64)}, "input",
                           "output", opset=18, int_data_names=("ax",)))
    got, _ = _agree(str(p), {"input": x})
    np.testing.assert_allclose(got, x.mean(2), rtol=1e-5, atol=1e-6)


def test_shape_start_end_attrs(tmp_path):
    nodes = [ow.node("Shape", ["input"], ["sh"], start=1, end=-1),
             ow.node("Cast", ["sh"], ["output"], to=1)]
    got, _ = _agree(_write(tmp_path, nodes),
                    {"input": np.zeros((2, 3, 4, 5), np.float32)})
    np.testing.assert_array_equal(got, [3.0, 4.0])


# ---------------------------------------------------------------------------
# GRU and 1-D convolutions
# ---------------------------------------------------------------------------

def _zrn(t):
    r, z, n = np.split(t, 3, axis=0)
    return np.concatenate([z, r, n], axis=0)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_gru_matches(tmp_path, bidirectional):
    torch.manual_seed(5)
    E, H, T, B = 12, 16, 10, 4
    gru = torch.nn.GRU(E, H, bidirectional=bidirectional)
    sd = {k: v.detach().numpy() for k, v in gru.state_dict().items()}
    sfx = ["", "_reverse"] if bidirectional else [""]
    inits = {"W": np.stack([_zrn(sd[f"weight_ih_l0{s}"]) for s in sfx]),
             "R": np.stack([_zrn(sd[f"weight_hh_l0{s}"]) for s in sfx]),
             "B": np.stack([np.concatenate([_zrn(sd[f"bias_ih_l0{s}"]),
                                            _zrn(sd[f"bias_hh_l0{s}"])])
                            for s in sfx]),
             "shape": np.asarray([0, 0, -1], np.int64)}
    nodes = [ow.node("GRU", ["input", "W", "R", "B"], ["y", "yh"],
                     hidden_size=H, linear_before_reset=1,
                     **({"direction": "bidirectional"} if bidirectional
                        else {})),
             ow.node("Transpose", ["y"], ["yt"], perm=[0, 2, 1, 3]),
             ow.node("Reshape", ["yt", "shape"], ["output"])]
    X = np.random.default_rng(20).normal(size=(T, B, E)).astype(np.float32)
    got, _ = _agree(_write(tmp_path, nodes, inits), {"input": X})
    with torch.no_grad():
        ref, _ = gru(torch.from_numpy(X))
    np.testing.assert_allclose(got, ref.numpy(), rtol=2e-4, atol=1e-5)


def test_gru_linear_before_reset_0(tmp_path):
    rng = np.random.default_rng(21)
    E = H = 6
    W = rng.normal(scale=0.3, size=(1, 3 * H, E)).astype(np.float32)
    R = rng.normal(scale=0.3, size=(1, 3 * H, H)).astype(np.float32)
    nodes = [ow.node("GRU", ["input", "W", "R"], ["y"], hidden_size=H,
                     linear_before_reset=0),
             ow.node("Squeeze", ["y", "ax"], ["output"])]
    X = rng.normal(size=(5, 3, E)).astype(np.float32)
    _agree(_write(tmp_path, nodes, {"W": W, "R": R,
                                    "ax": np.asarray([1], np.int64)}),
           {"input": X})


def test_conv1d_and_pool1d_match(tmp_path):
    rng = np.random.default_rng(22)
    x = rng.normal(size=(2, 3, 20)).astype(np.float32)
    nodes = [ow.node("Conv", ["input", "w", "b"], ["c"], kernel_shape=[4],
                     strides=[2], pads=[1, 1], dilations=[1], group=1),
             ow.node("Relu", ["c"], ["r"]),
             ow.node("MaxPool", ["r"], ["output"], kernel_shape=[2],
                     strides=[2], pads=[0, 0])]
    inits = {"w": rng.normal(scale=0.3, size=(5, 3, 4)).astype(np.float32),
             "b": rng.normal(size=5).astype(np.float32)}
    _agree(_write(tmp_path, nodes, inits), {"input": x})


def test_grouped_dilated_asymmetric_conv2d(tmp_path):
    rng = np.random.default_rng(23)
    x = rng.normal(size=(2, 4, 11, 9)).astype(np.float32)
    nodes = [ow.node("Conv", ["input", "w", "b"], ["output"],
                     kernel_shape=[3, 2], strides=[2, 1],
                     pads=[1, 0, 2, 1], dilations=[1, 2], group=2)]
    inits = {"w": rng.normal(scale=0.3, size=(6, 2, 3, 2)).astype(np.float32),
             "b": rng.normal(size=6).astype(np.float32)}
    _agree(_write(tmp_path, nodes, inits), {"input": x})


@pytest.mark.parametrize("rank", [2, 4])
def test_batchnorm_matches_on_4d_and_2d_parity_rank(tmp_path, rank):
    """BatchNormalization in the layout the JAX executor implements
    (4-D NCHW), and, at rank 2 with C = N = 1 where its 4-D broadcast
    happens to fit, the same values."""
    rng = np.random.default_rng(24)
    c = 5 if rank == 4 else 1
    shape = (2, c, 3, 4) if rank == 4 else (1, c)
    inits = {"s": rng.uniform(0.5, 1.5, c), "b": rng.normal(size=c),
             "m": rng.normal(size=c), "v": rng.uniform(0.5, 1.5, c)}
    inits = {k: v.astype(np.float32) for k, v in inits.items()}
    nodes = [ow.node("BatchNormalization", ["input", "s", "b", "m", "v"],
                     ["output"], epsilon=1e-3)]
    x = rng.normal(size=shape).astype(np.float32)
    got, want = _run_both(_write(tmp_path, nodes, inits), {"input": x})
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=RTOL,
                               atol=ATOL)


def test_batchnorm_1d_divergence(tmp_path):
    """The stated divergence: on a 1-D (N, C, L) input the port
    broadcasts BatchNormalization's per-channel parameters as (1, C, 1)
    and matches torch's BatchNorm1d; the JAX executor broadcasts them as
    (1, C, 1, 1) and returns another shape, or fails."""
    rng = np.random.default_rng(25)
    c = 3
    inits = {"s": rng.uniform(0.5, 1.5, c), "b": rng.normal(size=c),
             "m": rng.normal(size=c), "v": rng.uniform(0.5, 1.5, c)}
    inits = {k: v.astype(np.float32) for k, v in inits.items()}
    nodes = [ow.node("Conv", ["input", "w"], ["c"], kernel_shape=[3],
                     pads=[1, 1]),
             ow.node("BatchNormalization", ["c", "s", "b", "m", "v"],
                     ["output"], epsilon=1e-5)]
    inits["w"] = rng.normal(scale=0.3, size=(c, 2, 3)).astype(np.float32)
    p = _write(tmp_path, nodes, inits)
    x = rng.normal(size=(4, 2, 7)).astype(np.float32)
    pg = P.load_onnx(p)
    got = P.OnnxApply(pg)({k: P._weight_tensor(v)
                           for k, v in pg.initializers.items()},
                          {"input": torch.from_numpy(x)}).numpy()
    bn = torch.nn.BatchNorm1d(c, eps=1e-5).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inits["s"]))
        bn.bias.copy_(torch.from_numpy(inits["b"]))
        bn.running_mean.copy_(torch.from_numpy(inits["m"]))
        bn.running_var.copy_(torch.from_numpy(inits["v"]))
        ref = bn(torch.nn.functional.conv1d(
            torch.from_numpy(x), torch.from_numpy(inits["w"]),
            padding=1)).numpy()
    assert got.shape == (4, c, 7)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    jg = J.load_onnx(p)
    try:
        want = np.asarray(J.OnnxApply(jg)(
            {k: np.asarray(v) for k, v in jg.initializers.items()},
            {"input": x}))
    except (TypeError, ValueError):
        return                                   # the JAX executor fails
    assert want.shape != got.shape


# ---------------------------------------------------------------------------
# Constant spellings, multi-input graphs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["value_float_and_ints", "value_int_gather",
                                  "value_floats_list"])
def test_constant_variants(tmp_path, case):
    if case == "value_float_and_ints":
        x = np.ones((2, 3), np.float32)
        nodes = [ow.node("Constant", [], ["c"], value_float=2.5),
                 ow.node("Mul", ["input", "c"], ["m"]),
                 ow.node("Constant", [], ["shape"], value_ints=[3, 2]),
                 ow.node("Reshape", ["m", "shape"], ["output"])]
    elif case == "value_int_gather":
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        nodes = [ow.node("Constant", [], ["i"], value_int=2),
                 ow.node("Gather", ["input", "i"], ["output"], axis=0)]
    else:
        x = np.zeros((1, 3), np.float32)
        nodes = [ow.node("Constant", [], ["c"],
                         value_floats=[1.5, -2.0, 0.25]),
                 ow.node("Add", ["input", "c"], ["output"])]
    _agree(_write(tmp_path, nodes), {"input": x})


def _two_tower(tmp_path):
    rng = np.random.default_rng(30)
    wu = rng.normal(scale=0.3, size=(6, 4)).astype(np.float32)
    wi = rng.normal(scale=0.3, size=(5, 4)).astype(np.float32)
    nodes = [ow.node("MatMul", ["user", "wu"], ["eu"]),
             ow.node("MatMul", ["item", "wi"], ["ei"]),
             ow.node("Mul", ["eu", "ei"], ["prod"]),
             ow.node("ReduceMean", ["prod"], ["score"], axes=[1],
                     keepdims=1)]
    graph = b"".join(ow._ld(1, nd) for nd in nodes)
    for name, arr in (("wu", wu), ("wi", wi)):
        graph += ow._ld(5, ow.tensor(name, arr))
    graph += ow._ld(11, ow._value_info("user", 1, ["N", 6]))
    graph += ow._ld(11, ow._value_info("item", 1, ["N", 5]))
    graph += ow._ld(12, ow._value_info("score", 1, ["N", 1]))
    blob = (ow._int_field(1, 8)
            + ow._ld(8, ow._ld(1, b"") + ow._int_field(2, 17))
            + ow._ld(7, graph))
    p = tmp_path / "tower.onnx"
    p.write_bytes(blob)
    return str(p)


class TestMultiInput:
    def test_two_tower_scores(self, tmp_path):
        rng = np.random.default_rng(31)
        _models_agree(_two_tower(tmp_path),
                      {"user": rng.normal(size=(7, 6)).astype(np.float32),
                       "item": rng.normal(size=(7, 5)).astype(np.float32)},
                      batch_size=4)

    def test_feed_cols_override_and_save_load(self, tmp_path):
        path = _two_tower(tmp_path)
        model = P.import_onnx_model(
            path, feed_cols={"user": "u_feats", "item": "i_feats"},
            device="cpu")
        rng = np.random.default_rng(32)
        table = mtt.DataTable({
            "u_feats": rng.normal(size=(3, 6)).astype(np.float32),
            "i_feats": rng.normal(size=(3, 5)).astype(np.float32)})
        ref = model.transform(table)["scores"]
        model.save(str(tmp_path / "stage"))
        back = load_stage(str(tmp_path / "stage"))
        np.testing.assert_array_equal(back.transform(table)["scores"], ref)

    def test_mixed_elem_classes_rejected(self, tmp_path):
        nodes = [ow.node("Gather", ["emb", "ids"], ["g"], axis=0),
                 ow.node("Mul", ["g", "scale"], ["out"])]
        graph = b"".join(ow._ld(1, nd) for nd in nodes)
        graph += ow._ld(5, ow.tensor("emb", np.zeros((10, 4), np.float32)))
        graph += ow._ld(11, ow._value_info("ids", 7, ["N"]))
        graph += ow._ld(11, ow._value_info("scale", 1, ["N", 1]))
        graph += ow._ld(12, ow._value_info("out", 1, ["N", 4]))
        blob = (ow._int_field(1, 8)
                + ow._ld(8, ow._ld(1, b"") + ow._int_field(2, 17))
                + ow._ld(7, graph))
        p = tmp_path / "mixed.onnx"
        p.write_bytes(blob)
        _both_refuse("import_onnx_model", str(p), "element class")

    def test_partial_shape_dict_still_infers(self, tmp_path):
        model = P.import_onnx_model(_two_tower(tmp_path),
                                    input_shape={"user": (6,)}, device="cpu")
        assert model.get("modelFn").input_shape == {"user": (6,),
                                                    "item": (5,)}

    @pytest.mark.parametrize("kw,match", [
        ({"feed_cols": {"usr": "u"}}, "usr"),
        ({"input_shape": {"itm": (5,)}}, "itm"),
        ({"input_shape": (6,)}, "dict")])
    def test_bad_feeds_rejected(self, tmp_path, kw, match):
        _both_refuse("import_onnx_model", _two_tower(tmp_path), match, **kw)


# ---------------------------------------------------------------------------
# a BERT-style block; Split, Expand
# ---------------------------------------------------------------------------

def test_transformer_block_matches(tmp_path):
    D, H, T, B = 16, 4, 6, 2
    hd = D // H
    rng = np.random.default_rng(40)

    def w(shape, scale=0.25):
        return rng.normal(scale=scale, size=shape).astype(np.float32)

    inits = {
        "ln_g": np.ones(D, np.float32), "ln_b": w((D,), 0.1),
        "wqkv": w((D, 3 * D)), "bqkv": w((3 * D,), 0.05),
        "wo": w((D, D)), "bo": w((D,), 0.05),
        "ln2_g": np.ones(D, np.float32), "ln2_b": w((D,), 0.1),
        "w1": w((D, 4 * D)), "b1": w((4 * D,), 0.05),
        "w2": w((4 * D, D)), "b2": w((D,), 0.05),
        "eps": np.asarray([1e-5], np.float32),
        "half": np.asarray([0.5], np.float32),
        "one": np.asarray([1.0], np.float32),
        "sqrt2": np.asarray([np.sqrt(2.0)], np.float32),
        "scale": np.asarray([1.0 / np.sqrt(hd)], np.float32),
        "neg": np.asarray([-1e9], np.float32),
        "mask": np.tril(np.ones((T, T), bool)),
        "h_shape": np.asarray([0, 0, H, hd], np.int64),
        "m_shape": np.asarray([0, 0, D], np.int64),
        "two": np.asarray([2.0], np.float32),
    }

    def ln(x_in, g, b, pre):
        return [ow.node("ReduceMean", [x_in], [f"{pre}.mu"], axes=[-1],
                        keepdims=1),
                ow.node("Sub", [x_in, f"{pre}.mu"], [f"{pre}.c"]),
                ow.node("Pow", [f"{pre}.c", "two"], [f"{pre}.c2"]),
                ow.node("ReduceMean", [f"{pre}.c2"], [f"{pre}.v"],
                        axes=[-1], keepdims=1),
                ow.node("Add", [f"{pre}.v", "eps"], [f"{pre}.ve"]),
                ow.node("Sqrt", [f"{pre}.ve"], [f"{pre}.sd"]),
                ow.node("Div", [f"{pre}.c", f"{pre}.sd"], [f"{pre}.n"]),
                ow.node("Mul", [f"{pre}.n", g], [f"{pre}.ng"]),
                ow.node("Add", [f"{pre}.ng", b], [f"{pre}.out"])]

    nodes = ln("x", "ln_g", "ln_b", "l1") + [
        ow.node("MatMul", ["l1.out", "wqkv"], ["qkv0"]),
        ow.node("Add", ["qkv0", "bqkv"], ["qkv"]),
        ow.node("Split", ["qkv"], ["q", "k", "v"], axis=-1, num_outputs=3)]
    for nm in ("q", "k", "v"):
        nodes += [ow.node("Reshape", [nm, "h_shape"], [f"{nm}h"]),
                  ow.node("Transpose", [f"{nm}h"], [f"{nm}t"],
                          perm=[0, 2, 1, 3])]
    nodes += [
        ow.node("Transpose", ["kt"], ["ktt"], perm=[0, 1, 3, 2]),
        ow.node("MatMul", ["qt", "ktt"], ["sc0"]),
        ow.node("Mul", ["sc0", "scale"], ["sc"]),
        ow.node("Where", ["mask", "sc", "neg"], ["scm"]),
        ow.node("Softmax", ["scm"], ["attn"], axis=-1),
        ow.node("MatMul", ["attn", "vt"], ["ctx"]),
        ow.node("Transpose", ["ctx"], ["ctxt"], perm=[0, 2, 1, 3]),
        ow.node("Reshape", ["ctxt", "m_shape"], ["ctxm"]),
        ow.node("MatMul", ["ctxm", "wo"], ["proj0"]),
        ow.node("Add", ["proj0", "bo"], ["proj"]),
        ow.node("Add", ["x", "proj"], ["res1"])]
    nodes += ln("res1", "ln2_g", "ln2_b", "l2") + [
        ow.node("MatMul", ["l2.out", "w1"], ["m0"]),
        ow.node("Add", ["m0", "b1"], ["m1"]),
        ow.node("Div", ["m1", "sqrt2"], ["g0"]),
        ow.node("Erf", ["g0"], ["g1"]),
        ow.node("Add", ["g1", "one"], ["g2"]),
        ow.node("Mul", ["m1", "g2"], ["g3"]),
        ow.node("Mul", ["g3", "half"], ["gelu"]),
        ow.node("MatMul", ["gelu", "w2"], ["m2"]),
        ow.node("Add", ["m2", "b2"], ["m3"]),
        ow.node("Add", ["res1", "m3"], ["out"])]
    graph = b"".join(ow._ld(1, nd) for nd in nodes)
    for name, arr in inits.items():
        graph += ow._ld(5, ow.tensor(name, arr))
    graph += ow._ld(11, ow._value_info("x", 1, ["N", T, D]))
    graph += ow._ld(12, ow._value_info("out", 1, ["N", T, D]))
    p = tmp_path / "block.onnx"
    p.write_bytes(ow._int_field(1, 8)
                  + ow._ld(8, ow._ld(1, b"") + ow._int_field(2, 17))
                  + ow._ld(7, graph))
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    _agree(str(p), {"x": x})


@pytest.mark.parametrize("case", ["split_sizes_input", "split_uneven",
                                  "expand"])
def test_split_and_expand(tmp_path, case):
    if case == "split_sizes_input":
        x = np.arange(24, dtype=np.float32).reshape(2, 12)
        nodes = [ow.node("Split", ["input", "sizes"], ["a", "b", "c"],
                         axis=1),
                 ow.node("Concat", ["c", "b", "a"], ["output"], axis=1)]
        p = _write(tmp_path, nodes, {"sizes": np.asarray([3, 4, 5],
                                                         np.int64)},
                   int_names=("sizes",))
    elif case == "split_uneven":
        x = np.arange(20, dtype=np.float32).reshape(2, 10)
        nodes = [ow.node("Split", ["input"], ["a", "b", "c"], axis=1,
                         num_outputs=3),
                 ow.node("Concat", ["c", "a", "b"], ["output"], axis=1)]
        p = _write(tmp_path, nodes, opset=18)
    else:
        x = np.arange(3, dtype=np.float32).reshape(3, 1)
        p = _write(tmp_path, [ow.node("Expand", ["input", "shape"],
                                      ["output"])],
                   {"shape": np.asarray([2, 3, 4], np.int64)},
                   int_names=("shape",))
    got, want = _agree(p, {"input": x})
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# reductions, Min / Max, ArgMax
# ---------------------------------------------------------------------------

def test_reduce_sum_axes_input_opset13(tmp_path):
    x = np.random.default_rng(50).normal(size=(2, 3, 4)).astype(np.float32)
    _agree(_write(tmp_path, [ow.node("ReduceSum", ["input", "ax"], ["output"],
                                     keepdims=0)],
                  {"ax": np.asarray([1], np.int64)}, opset=13,
                  int_names=("ax",)), {"input": x})


def test_reduce_max_min_attr_form(tmp_path):
    x = np.random.default_rng(51).normal(size=(3, 5)).astype(np.float32)
    nodes = [ow.node("ReduceMax", ["input"], ["mx"], axes=[1], keepdims=1),
             ow.node("ReduceMin", ["input"], ["mn"], axes=[1], keepdims=1),
             ow.node("Sub", ["mx", "mn"], ["output"])]
    _agree(_write(tmp_path, nodes), {"input": x})


def test_variadic_min_max(tmp_path):
    rng = np.random.default_rng(52)
    nodes = [ow.node("Max", ["input", "b", "c"], ["hi"]),
             ow.node("Min", ["input", "b", "c"], ["lo"]),
             ow.node("Sub", ["hi", "lo"], ["output"])]
    _agree(_write(tmp_path, nodes,
                  {"b": rng.normal(size=4).astype(np.float32),
                   "c": rng.normal(size=4).astype(np.float32)}),
           {"input": rng.normal(size=4).astype(np.float32)})


def test_argmax_classifier_tail(tmp_path):
    rng = np.random.default_rng(53)
    w = rng.normal(scale=0.3, size=(6, 4)).astype(np.float32)
    nodes = [ow.node("MatMul", ["input", "w"], ["logits"]),
             ow.node("ArgMax", ["logits"], ["output"], axis=-1, keepdims=0)]
    p = tmp_path / "clf.onnx"
    p.write_bytes(ow.model(nodes, {"w": w}, ("input", 1, ["N", 6]),
                           "output"))
    x = rng.normal(size=(9, 6)).astype(np.float32)
    _, got, _ = _models_agree(str(p), {"images": x}, batch_size=4)
    np.testing.assert_array_equal(got, (x @ w).argmax(-1))
    assert got.dtype == np.int32


# ---------------------------------------------------------------------------
# examples/onnx_inference.py on the port, and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flow", ["local_repo", "webdav_http_repo"])
def test_onnx_inference_example_flows(tmp_path, flow):
    """The example: write a resnet18-architecture graph, publish it with
    its onnx_summary manifest, read it back sha256-verified, import it
    and score 16 rows at batch 8 — through a LocalRepo, and through a
    repo on the port's WebDAV server read back by HTTPRepo. The scores
    equal the JAX package's on the same file within the tolerance."""
    from mmlspark_tpu_torch.downloader import HTTPRepo, LocalRepo
    from mmlspark_tpu_torch.testing.webdav import serve_webdav
    onnx_path = str(tmp_path / "resnet18.onnx")
    ow.resnet18_onnx(onnx_path, num_classes=10, width=8, seed=7)
    summary = P.onnx_summary(onnx_path)
    assert summary["ops"]["Conv"] == 20
    with open(onnx_path, "rb") as f:
        blob = f.read()
    server = None
    try:
        if flow == "local_repo":
            repo = LocalRepo(str(tmp_path / "repo"))
        else:
            server, base = serve_webdav(str(tmp_path / "dav"))
            repo = HTTPRepo(f"{base}/zoo")
        repo.publish("onnx_resnet18", {"format": "onnx",
                                       "onnx_summary": summary},
                     blob=blob, model_type="classification")
        if flow != "local_repo":
            repo = HTTPRepo(f"{base}/zoo")          # a fresh reader
        schema = repo.get_schema("onnx_resnet18")
        assert schema.network_spec["onnx_summary"] == summary
        reload_path = tmp_path / "reload.onnx"
        reload_path.write_bytes(repo.read_blob(schema, verify=True))
    finally:
        if server is not None:
            server.shutdown()
    images = np.random.default_rng(0).normal(size=(16, 3 * 32 * 32)
                                             ).astype(np.float32)
    _, scores, _ = _models_agree(str(reload_path), {"images": images},
                                 batch_size=8, input_shape=[3, 32, 32])
    assert scores.shape == (16, 10) and np.all(np.isfinite(scores))


def test_cli_import_onnx(tmp_path, resnet18_file):
    """``import-onnx`` saves a stage that scores like the JAX package's
    import of the same file, and prints the JAX CLI's summary line (its
    ops, opset and inputs, as ``cmd_import_onnx`` builds them)."""
    path, _ = resnet18_file
    out = str(tmp_path / "stage")
    r = subprocess.run(
        [sys.executable, "-m", "mmlspark_tpu_torch.cli", "import-onnx", path,
         "--out", out, "--batch-size", "4", "--input-shape", "[3, 32, 32]",
         "--device", "cpu"], capture_output=True, text=True, cwd=REPO,
        timeout=300, env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    jm = J.import_onnx_model(path, batch_size=4, input_shape=[3, 32, 32])
    japply = jm.get("modelFn")
    ops = {}
    for node in japply.nodes:
        ops[node.op_type] = ops.get(node.op_type, 0) + 1
    assert line == {"saved": out, "ops": dict(sorted(ops.items())),
                    "opset": japply.opset, "inputs": japply.input_names}
    model = load_stage(out)
    assert model.get("device") == "cpu" and model.get("batchSize") == 4
    x = np.random.default_rng(1).normal(size=(5, 3 * 32 * 32)
                                        ).astype(np.float32)
    want = np.asarray(jm.transform(JTable({"images": x}))["scores"])
    np.testing.assert_allclose(
        model.transform(mtt.DataTable({"images": x}))["scores"], want,
        rtol=RTOL, atol=ATOL)


def test_new_modules_run_with_jax_blocked(tmp_path):
    """The slice's modules import and run where jax and the JAX package
    cannot be imported: an ONNX graph imported and scored, a quantized
    MLP, a fit checkpointed to and resumed from a WebDAV server."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["mmlspark_tpu"] = None
sys.path.insert(0, {REPO!r})
import numpy as np
import mmlspark_tpu_torch as mtt
from mmlspark_tpu_torch.importers import import_onnx_model, onnx_summary
from mmlspark_tpu_torch.models.learner import TPULearner
from mmlspark_tpu_torch.testing.webdav import serve_webdav
from mmlspark_tpu_torch.utils import filesystem
from tests import onnx_writer as ow
p = {str(tmp_path / "r.onnx")!r}
ow.resnet18_onnx(p, num_classes=3, width=4, seed=1)
assert onnx_summary(p)["ops"]["Conv"] == 20
m = import_onnx_model(p, batch_size=4, input_shape=[3, 16, 16], device="cpu")
x = np.random.default_rng(0).normal(size=(5, 768)).astype(np.float32)
assert m.transform(mtt.DataTable({{"images": x}}))["scores"].shape == (5, 3)
server, base = serve_webdav({str(tmp_path / "dav")!r})
y = (x[:, 0] > 0).astype(np.int64)
t = mtt.DataTable({{"features": x, "label": y}})
kw = dict(networkSpec={{"type": "mlp", "features": [8], "num_classes": 2}},
          batchSize=2, device="cpu", computeDtype="float32", logEvery=1,
          checkpointDir=base + "/ck", checkpointEvery=2, optimizer="adamw")
TPULearner(epochs=1, **kw).fit(t)
second = TPULearner(epochs=2, **kw)
model = second.fit(t)
server.shutdown()
assert min(h["step"] for h in second.history) == 4
q = model.quantize({{"features": x}})
assert q.get("precision") == "int8"
assert q.transform(t)["scores"].shape == (5, 2)
assert not any(k.split(".")[0] in ("jax", "mmlspark_tpu")
               for k, v in sys.modules.items() if v is not None)
print("OK")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=300,
                       env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OK" in r.stdout
