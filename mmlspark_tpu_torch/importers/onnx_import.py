"""Dependency-free ONNX ingestion of the PyTorch port: the wire-format
reader and validation of ``mmlspark_tpu/importers/onnx_import.py``
(copied: the same parser, the same checks, messages and exception
types), and a torch executor in place of the JAX one.

The reference's model zoo serves published checkpoints in a
framework-neutral way (ref: src/downloader/src/main/scala/
ModelDownloader.scala:209, Schema.scala:54), and its model stage ingests
arbitrary serialized graphs (ref: src/cntk-model/src/main/scala/
CNTKModel.scala:147). No ``onnx`` package is needed: the protobuf wire
format is walked over the public onnx.proto field numbers.

Supported operators (validated at load — unknown ops AND
semantics-changing attributes outside the supported envelope are
rejected, so a graph that loads executes faithfully):

  CNN family  : Conv (1-D and 2-D), BatchNormalization, Relu,
                MaxPool, AveragePool, GlobalAveragePool, Flatten
  linear      : Gemm, MatMul
  recurrent   : LSTM, GRU (each forward / reverse / bidirectional)
  activations : Sigmoid, Tanh, Softmax, LogSoftmax, LeakyRelu, Clip, Erf
  elementwise : Add, Sub, Mul, Div, Neg, Exp, Sqrt, Pow, Where,
                Min, Max (variadic)
  structure   : Concat, Split, Transpose, Reshape, Squeeze, Unsqueeze,
                Slice, Shape, Gather, Cast, Expand, Identity, Constant,
                ReduceMean, ReduceSum, ReduceMax, ReduceMin,
                ArgMax, ArgMin

``OnnxApply`` interprets the graph eagerly in torch, in ONNX's native
NCHW layout, on the device of its inputs, under
``networks.strict_f32()`` (cuDNN's float32 convolutions would otherwise
run in TF32). Shape-computing chains (Shape -> Gather -> Concat ->
Reshape) and small integer constants stay numpy on the host, which is
what the JAX executor's ``_lib_for`` guarantees under jit. LSTM and GRU
follow ONNX's gate orders (i, o, f, c and z, r, h), with the input
projection of the whole sequence hoisted out of the recurrence. Like the
JAX executor (with 64-bit types off), float64 initializers run as
float32. ``import_onnx_model`` builds the port's ``TPUModel``: a
single-input graph feeds from the ``images`` column, a multi-input one
from ``feed_cols``; integer inputs feed as int32; the batch axis is
dynamic.

One stated divergence: ``BatchNormalization`` broadcasts its per-channel
parameters by the input's spatial rank (``(1, C)`` plus one axis per
spatial dim). The JAX executor always broadcasts them as 4-D
``(1, C, 1, 1)``, so on a 1-D (N, C, L) or a 2-D (N, C) input it
mis-shapes or fails, though such graphs pass validation.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.device import DeviceLike, resolve_device

# ---------------------------------------------------------------------------
# protobuf wire-format primitives
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint overflow (corrupt ONNX file?)")


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message's bytes.
    Values: varint -> int, 64-bit -> 8 bytes, length-delimited -> bytes,
    32-bit -> 4 bytes. Truncated payloads raise (a short slice would
    otherwise parse into a wrong-sized tensor and fail far away, or not
    at all); groups (deprecated) are rejected."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            end = pos + 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            end = pos + ln
        elif wt == 5:
            end = pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        if wt != 0:
            if end > n:
                raise ValueError(
                    f"truncated protobuf: field {field} needs bytes "
                    f"[{pos}, {end}) of {n}")
            val, pos = buf[pos:end], end
        yield field, wt, val


def _signed(v: int) -> int:
    """proto int64 varints are two's-complement in 64 bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------------
# onnx message readers (subset)
# ---------------------------------------------------------------------------

# TensorProto.DataType (public enum values)
_DT_FLOAT, _DT_UINT8, _DT_INT8, _DT_INT32, _DT_INT64 = 1, 2, 3, 6, 7
_DT_DOUBLE, _DT_FLOAT16, _DT_BOOL = 11, 10, 9

_TENSOR_DTYPES = {
    _DT_FLOAT: np.float32,
    _DT_DOUBLE: np.float64,
    _DT_INT32: np.int32,
    _DT_INT64: np.int64,
    _DT_UINT8: np.uint8,
    _DT_INT8: np.int8,
    _DT_FLOAT16: np.float16,
    _DT_BOOL: np.bool_,
}

_INT_ELEM_TYPES = (_DT_INT32, _DT_INT64, _DT_UINT8, _DT_INT8)


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    data_type = _DT_FLOAT
    raw = b""
    float_data: List[float] = []
    double_data: List[float] = []
    int64_data: List[int] = []
    int32_data: List[int] = []
    name = ""
    for field, wt, val in _fields(buf):
        if field == 1:                      # dims (repeated int64)
            if wt == 0:
                dims.append(val)
            else:                           # packed
                pos = 0
                while pos < len(val):
                    d, pos = _read_varint(val, pos)
                    dims.append(d)
        elif field == 2:
            data_type = val
        elif field == 4:                    # float_data
            if wt == 5:
                float_data.append(struct.unpack("<f", val)[0])
            else:                           # packed
                float_data.extend(
                    struct.unpack(f"<{len(val) // 4}f", val))
        elif field == 5:                    # int32_data
            # int32 varints are sign-extended to 64 bits on the wire —
            # without _signed a negative decodes as ~2^64 and the
            # np.asarray below overflows (FLOAT16 bit patterns are
            # 0..65535, where _signed is a no-op)
            if wt == 0:
                int32_data.append(_signed(val))
            else:
                pos = 0
                while pos < len(val):
                    d, pos = _read_varint(val, pos)
                    int32_data.append(_signed(d))
        elif field == 7:                    # int64_data
            # same two's-complement rule: a Reshape shape [-1, C] or a
            # negative axis stored here (not raw_data) must decode signed
            if wt == 0:
                int64_data.append(_signed(val))
            else:
                pos = 0
                while pos < len(val):
                    d, pos = _read_varint(val, pos)
                    int64_data.append(_signed(d))
        elif field == 8:
            name = val.decode("utf-8")
        elif field == 9:
            raw = val
        elif field == 10:                   # double_data
            if wt == 1:
                double_data.append(struct.unpack("<d", val)[0])
            else:                           # packed
                double_data.extend(
                    struct.unpack(f"<{len(val) // 8}d", val))
    if data_type not in _TENSOR_DTYPES:
        raise ValueError(
            f"tensor {name!r}: unsupported ONNX data_type {data_type}")
    dtype = _TENSOR_DTYPES[data_type]
    if raw:
        arr = np.frombuffer(raw, dtype=dtype).copy()
    elif float_data:
        arr = np.asarray(float_data, dtype=dtype)
    elif double_data:
        arr = np.asarray(double_data, dtype=dtype)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=dtype)
    elif int32_data:
        if data_type == _DT_FLOAT16:
            # spec: FLOAT16 payloads in int32_data are uint16 BIT
            # patterns, not values — reinterpret, never cast
            arr = np.asarray(int32_data, dtype=np.uint16).view(np.float16)
        else:
            arr = np.asarray(int32_data, dtype=dtype)
    else:
        arr = np.zeros(0, dtype=dtype)
    if dims and arr.size != int(np.prod(dims)):
        raise ValueError(
            f"tensor {name!r}: payload has {arr.size} elements but dims "
            f"{dims} need {int(np.prod(dims))} (unsupported storage "
            f"field or corrupt file)")
    if dims:
        return name, arr.reshape(dims)
    # spec: absent dims means a 0-d scalar (dims=[] and "not written"
    # are indistinguishable on the wire)
    return name, arr.reshape(()) if arr.size == 1 else arr


def _parse_attribute(buf: bytes) -> Tuple[str, Any]:
    name = ""
    out: Any = None
    ints: List[int] = []
    floats: List[float] = []
    strings: List[str] = []
    for field, wt, val in _fields(buf):
        if field == 1:
            name = val.decode("utf-8")
        elif field == 2:                    # f (float, fixed32)
            out = struct.unpack("<f", val)[0]
        elif field == 3:                    # i (int)
            out = _signed(val)
        elif field == 4:                    # s (bytes)
            out = val.decode("utf-8", "replace")
        elif field == 5:                    # t (tensor)
            out = _parse_tensor(val)[1]
        elif field == 6:                    # g (GraphProto — subgraph)
            # subgraph-carrying ops (If/Loop/Scan) are outside the
            # supported set; the op check rejects them, so the bytes
            # are skipped here rather than mis-parsed
            pass
        elif field == 7:                    # floats (repeated fixed32)
            if wt == 5:
                floats.append(struct.unpack("<f", val)[0])
            else:                           # packed
                floats.extend(
                    struct.unpack(f"<{len(val) // 4}f", val))
        elif field == 9:                    # strings (repeated bytes)
            strings.append(val.decode("utf-8", "replace"))
        elif field == 8:                    # ints (repeated)
            if wt == 0:
                ints.append(_signed(val))
            else:
                pos = 0
                while pos < len(val):
                    d, pos = _read_varint(val, pos)
                    ints.append(_signed(d))
    if ints:
        return name, ints
    if floats:
        return name, floats
    if strings:
        return name, strings
    return name, out


class OnnxNode:
    def __init__(self, op_type: str, inputs: List[str], outputs: List[str],
                 attrs: Dict[str, Any], name: str = ""):
        self.op_type = op_type
        self.inputs = inputs
        self.outputs = outputs
        self.attrs = attrs
        self.name = name

    def __repr__(self):
        return f"OnnxNode({self.op_type}, {self.inputs} -> {self.outputs})"


def _parse_node(buf: bytes) -> OnnxNode:
    inputs: List[str] = []
    outputs: List[str] = []
    attrs: Dict[str, Any] = {}
    op_type = ""
    name = ""
    for field, _wt, val in _fields(buf):
        if field == 1:
            inputs.append(val.decode("utf-8"))
        elif field == 2:
            outputs.append(val.decode("utf-8"))
        elif field == 3:
            name = val.decode("utf-8")
        elif field == 4:
            op_type = val.decode("utf-8")
        elif field == 5:
            k, v = _parse_attribute(val)
            attrs[k] = v
    return OnnxNode(op_type, inputs, outputs, attrs, name)


def _parse_value_info(buf: bytes) -> Tuple[str, Optional[int],
                                           Optional[List[Optional[int]]]]:
    """ValueInfoProto -> (name, elem_type, dims) where a symbolic
    dim_param (the dynamic-batch convention) or absent dim parses as
    None. TypeProto.tensor_type=1 {elem_type=1, shape=2};
    TensorShapeProto.dim=1 {dim_value=1, dim_param=2}."""
    name = ""
    elem_type: Optional[int] = None
    dims: Optional[List[Optional[int]]] = None
    for field, _wt, val in _fields(buf):
        if field == 1:
            name = val.decode("utf-8")
        elif field == 2:                    # TypeProto
            for f2, _w2, v2 in _fields(val):
                if f2 != 1:                 # tensor_type only
                    continue
                for f3, _w3, v3 in _fields(v2):
                    if f3 == 1:
                        elem_type = v3
                    elif f3 == 2:           # TensorShapeProto
                        dims = []
                        for f4, _w4, v4 in _fields(v3):
                            if f4 != 1:
                                continue
                            d: Optional[int] = None
                            for f5, _w5, v5 in _fields(v4):
                                if f5 == 1:
                                    d = _signed(v5) if isinstance(
                                        v5, int) else None
                            dims.append(d)
    return name, elem_type, dims


class OnnxGraph:
    """Parsed ONNX graph: topologically-ordered nodes, initializers,
    graph input/output names (initializer-backed inputs excluded),
    per-input (elem_type, dims) info, and the default-domain opset."""

    def __init__(self, nodes: List[OnnxNode],
                 initializers: Dict[str, np.ndarray],
                 inputs: List[str], outputs: List[str],
                 input_infos: Optional[Dict[str, Tuple[
                     Optional[int], Optional[List[Optional[int]]]]]] = None,
                 opset: int = 13):
        self.nodes = nodes
        self.initializers = initializers
        self.inputs = [i for i in inputs if i not in initializers]
        self.outputs = outputs
        self.input_infos = input_infos or {}
        self.opset = opset


SUPPORTED_OPS = {
    "Conv", "BatchNormalization", "Relu", "MaxPool", "AveragePool",
    "GlobalAveragePool", "Add", "Gemm", "MatMul", "Flatten", "Reshape",
    "Identity", "Constant", "Clip",
    "Sigmoid", "Tanh", "Softmax", "LogSoftmax", "LeakyRelu",
    "Sub", "Mul", "Div", "Neg", "Exp", "Sqrt", "Pow",
    "Concat", "Transpose", "Squeeze", "Unsqueeze", "Slice", "Shape",
    "Gather", "Cast", "ReduceMean", "LSTM", "GRU",
    "Erf", "Where", "Split", "Expand",
    "Min", "Max", "ReduceSum", "ReduceMax", "ReduceMin",
    "ArgMax", "ArgMin",
}

# inclusive default-domain opset envelope this importer implements
_OPSET_MIN, _OPSET_MAX = 7, 22

_LSTM_DEFAULT_ACTS = {
    1: ["Sigmoid", "Tanh", "Tanh"],
    2: ["Sigmoid", "Tanh", "Tanh", "Sigmoid", "Tanh", "Tanh"],
}


def _node_label(node: OnnxNode) -> str:
    return f"{node.op_type} node {node.name or node.outputs[:1]}"


_CONSTANT_SPELLINGS = ("value", "value_float", "value_int",
                       "value_floats", "value_ints")


def _constant_value(attrs: Dict[str, Any]) -> Optional[np.ndarray]:
    """The numpy value of a Constant node under any of the value_*
    attribute spellings (opset 12+); None when only unsupported forms
    (sparse/string) are present. numpy, so shape-computing chains that
    consume constants stay on the host."""
    if "value" in attrs:
        return np.asarray(attrs["value"])
    if "value_float" in attrs:
        return np.asarray(attrs["value_float"], np.float32)
    if "value_int" in attrs:
        return np.asarray(attrs["value_int"], np.int64)
    if "value_floats" in attrs:
        return np.asarray(attrs["value_floats"], np.float32)
    if "value_ints" in attrs:
        return np.asarray(attrs["value_ints"], np.int64)
    return None


def _validate_recurrent_envelope(node: OnnxNode, lbl: str) -> None:
    """Checks common to every recurrent op (LSTM/GRU): cell clipping,
    batch-major layout, direction values, per-row sequence lengths."""
    a = node.attrs
    if a.get("clip") is not None:
        raise ValueError(f"{lbl}: cell clipping is not supported")
    if a.get("layout", 0):
        raise ValueError(
            f"{lbl}: layout=1 (batch-major) is not supported — "
            f"re-export with the default layout=0")
    if a.get("direction", "forward") not in (
            "forward", "reverse", "bidirectional"):
        raise ValueError(
            f"{lbl}: direction={a.get('direction')!r} invalid")
    if len(node.inputs) > 4 and node.inputs[4]:
        raise ValueError(
            f"{lbl}: per-row sequence_lens is not supported — pad "
            f"to fixed length (TPU graphs are static-shape)")


def _validate_node(node: OnnxNode, opset: int,
                   inits: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Reject semantics-changing attributes outside the implemented
    envelope — the 'fail at load, not mid-inference' contract. Without
    this, e.g. auto_pad=SAME_UPPER or ceil_mode=1 would pass the op-set
    check and execute with silently wrong padding/window math."""
    a = node.attrs
    op = node.op_type
    lbl = _node_label(node)
    if op in ("Conv", "MaxPool", "AveragePool"):
        ap = a.get("auto_pad", "NOTSET")
        if ap not in ("NOTSET", ""):
            raise ValueError(
                f"{lbl}: auto_pad={ap!r} is not supported — re-export "
                f"with explicit 'pads' (auto_pad is deprecated in ONNX)")
        # 1-D (NCW) and 2-D (NCHW) convs/pools are implemented; a 3-D
        # export would otherwise die mid-inference in lax with an
        # unrelated-looking dimension_numbers error
        ks = a.get("kernel_shape")
        if ks is not None and len(ks) not in (1, 2):
            raise ValueError(
                f"{lbl}: only 1-D/2-D spatial kernels are supported, "
                f"got kernel_shape={ks}")
        if op == "Conv" and inits is not None and len(node.inputs) > 1:
            w = inits.get(node.inputs[1])
            if w is not None and w.ndim not in (3, 4):
                raise ValueError(
                    f"{lbl}: only 1-D (OIW) / 2-D (OIHW) convolution "
                    f"weights are supported, got rank {w.ndim}")
    if op in ("MaxPool", "AveragePool"):
        if a.get("ceil_mode", 0):
            raise ValueError(
                f"{lbl}: ceil_mode=1 is not supported — re-export with "
                f"ceil_mode=0 (floor) or pad explicitly")
    if op == "MaxPool":
        if any(d != 1 for d in a.get("dilations", [1])):
            raise ValueError(
                f"{lbl}: dilated max-pooling is not supported")
        if a.get("storage_order", 0):
            raise ValueError(f"{lbl}: storage_order=1 is not supported")
        if len(node.outputs) > 1 and node.outputs[1]:
            raise ValueError(
                f"{lbl}: the Indices output is not supported")
    if op == "Constant" and not any(
            k in a for k in _CONSTANT_SPELLINGS):
        raise ValueError(
            f"{lbl}: only tensor/float/int (scalar or list) constant "
            f"values are supported, got attributes {sorted(a)}")
    if op == "Split" and opset >= 13 and "split" in a:
        raise ValueError(
            f"{lbl}: attribute-form split sizes inside an "
            f"opset-{opset} graph (moved to an input at opset 13) — "
            f"file is inconsistent")
    if op == "Concat" and "axis" not in a:
        raise ValueError(f"{lbl}: required attribute 'axis' missing")
    if op == "Cast":
        to = a.get("to")
        if to not in _TENSOR_DTYPES:
            raise ValueError(
                f"{lbl}: cast target data_type {to} is not supported "
                f"(supported: {sorted(_TENSOR_DTYPES)})")
    if op == "LSTM":
        ndir = 2 if a.get("direction", "forward") == "bidirectional" else 1
        acts = a.get("activations")
        if acts is not None and list(acts) != _LSTM_DEFAULT_ACTS[ndir]:
            raise ValueError(
                f"{lbl}: non-default activations {acts} are not "
                f"supported (only {_LSTM_DEFAULT_ACTS[ndir]})")
        if a.get("input_forget", 0):
            raise ValueError(f"{lbl}: input_forget=1 is not supported")
        _validate_recurrent_envelope(node, lbl)
    if op == "LSTM" and len(node.inputs) > 7 and node.inputs[7]:
        raise ValueError(
            f"{lbl}: peephole weights (input P) are not supported — "
            f"the gates would compute without the P*c terms")
    if op == "GRU":
        ndir = 2 if a.get("direction", "forward") == "bidirectional" else 1
        acts = a.get("activations")
        if acts is not None and list(acts) != \
                ["Sigmoid", "Tanh"] * ndir:
            raise ValueError(
                f"{lbl}: non-default activations {acts} are not "
                f"supported (only Sigmoid/Tanh)")
        _validate_recurrent_envelope(node, lbl)
    if op in ("Squeeze", "Unsqueeze") and opset >= 13 and "axes" in a:
        raise ValueError(
            f"{lbl}: attribute-form axes inside an opset-{opset} graph "
            f"(axes moved to an input at opset 13) — file is "
            f"inconsistent")
    if op == "Unsqueeze" and opset >= 13 and (
            len(node.inputs) < 2 or not node.inputs[1]):
        raise ValueError(
            f"{lbl}: required 'axes' input missing (opset >= 13)")
    axes_input_opset = {"ReduceSum": 13, "ReduceMean": 18,
                        "ReduceMax": 18, "ReduceMin": 18}
    if op in axes_input_opset and opset >= axes_input_opset[op] \
            and "axes" in a:
        raise ValueError(
            f"{lbl}: attribute-form axes inside an opset-{opset} graph "
            f"(axes moved to an input at opset "
            f"{axes_input_opset[op]}) — file is inconsistent")
    if op in ("ArgMax", "ArgMin") and a.get("select_last_index", 0):
        raise ValueError(
            f"{lbl}: select_last_index=1 is not supported")
    if op == "Reshape" and a.get("allowzero", 0):
        raise ValueError(
            f"{lbl}: allowzero=1 is not supported (0 always means "
            f"'copy input dim' here)")
    if op == "Slice" and opset >= 10 and "starts" in a:
        raise ValueError(
            f"{lbl}: attribute-form Slice inside an opset-{opset} "
            f"graph — file is inconsistent")


def load_onnx(path: str) -> OnnxGraph:
    """Parse an .onnx file into an OnnxGraph; raises with the offending
    op list when the graph uses operators outside the supported subset,
    with the offending attribute when a supported op carries
    unsupported semantics, and with the declared opset when it falls
    outside [_OPSET_MIN, _OPSET_MAX] (fail at load, not
    mid-inference)."""
    with open(path, "rb") as f:
        buf = f.read()
    graph_buf: Optional[bytes] = None
    opset: Optional[int] = None
    try:
        for field, _wt, val in _fields(buf):
            if field == 7:                  # ModelProto.graph
                graph_buf = val
            elif field == 8:                # ModelProto.opset_import
                domain, version = "", None
                for f2, _w2, v2 in _fields(val):
                    if f2 == 1:
                        domain = v2.decode("utf-8")
                    elif f2 == 2:
                        version = v2
                if domain in ("", "ai.onnx") and version is not None:
                    opset = version
    except (IndexError, ValueError, struct.error) as e:
        raise ValueError(
            f"{path!r} is not a parseable ONNX protobuf: {e}") from e
    if graph_buf is None:
        raise ValueError(f"{path!r} has no graph — not an ONNX model file")
    if opset is None:
        opset = 13                          # spec default when absent
    if not _OPSET_MIN <= opset <= _OPSET_MAX:
        raise ValueError(
            f"{path!r} declares default-domain opset {opset}; this "
            f"importer implements opsets {_OPSET_MIN}..{_OPSET_MAX} — "
            f"re-export the model targeting a supported opset")
    nodes: List[OnnxNode] = []
    inits: Dict[str, np.ndarray] = {}
    inputs: List[str] = []
    outputs: List[str] = []
    input_infos: Dict[str, Tuple[Optional[int],
                                 Optional[List[Optional[int]]]]] = {}
    try:
        for field, _wt, val in _fields(graph_buf):
            if field == 1:
                nodes.append(_parse_node(val))
            elif field == 5:
                name, arr = _parse_tensor(val)
                inits[name] = arr
            elif field == 11:
                name, elem, dims = _parse_value_info(val)
                inputs.append(name)
                input_infos[name] = (elem, dims)
            elif field == 12:
                outputs.append(_parse_value_info(val)[0])
    except (IndexError, struct.error) as e:
        raise ValueError(
            f"{path!r}: corrupt/truncated ONNX graph: {e}") from e
    unsupported = sorted({n.op_type for n in nodes} - SUPPORTED_OPS)
    if unsupported:
        raise ValueError(
            f"ONNX graph uses unsupported operators {unsupported}; "
            f"supported subset: {sorted(SUPPORTED_OPS)}")
    for node in nodes:
        _validate_node(node, opset, inits)
    return OnnxGraph(nodes, inits, inputs, outputs, input_infos, opset)


# ---------------------------------------------------------------------------
# torch executor
# ---------------------------------------------------------------------------


def _pairs(pads: List[int]) -> List[Tuple[int, int]]:
    """ONNX pads [b0, b1, ..., e0, e1, ...] -> [(b0, e0), (b1, e1), ...]."""
    k = len(pads) // 2
    return [(pads[i], pads[k + i]) for i in range(k)]


def _torch_pads(pads: List[int]) -> List[int]:
    """ONNX pads -> ``F.pad``'s (last dim first) before/after list."""
    out: List[int] = []
    for b, e in reversed(_pairs(pads)):
        out += [b, e]
    return out


# node input slots that carry SHAPE-LIKE values (reshape targets, axes,
# slice bounds): these resolve to python ints, from the host
_SHAPE_SLOTS = {
    "Reshape": (1,),
    "Squeeze": (1,),
    "Unsqueeze": (1,),
    "Slice": (1, 2, 3, 4),
    "ReduceMean": (1,),
    "ReduceSum": (1,),
    "ReduceMax": (1,),
    "ReduceMin": (1,),
    "Split": (1,),
    "Expand": (1,),
}

_INT32_MAX = (1 << 31) - 1

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.bool_): torch.bool,
}


def _host(v: Any) -> bool:
    """True for plain host numbers/arrays (np.take on a 0-d index returns
    an np.generic SCALAR, so np.ndarray alone is not enough)."""
    return isinstance(v, (np.ndarray, np.generic, int, float))


def _all_host(*vals) -> bool:
    return all(_host(v) for v in vals)


def _weight_tensor(arr: np.ndarray) -> torch.Tensor:
    """An initializer as a CPU tensor; float64 runs as float32, as in
    the JAX executor (64-bit types off)."""
    arr = np.asarray(arr)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr))


class OnnxApply:
    """Picklable torch executor for a supported-subset ONNX graph —
    TPUModel's ``modelFn`` contract: ``(weights, inputs_dict) -> out``.
    Inputs/outputs follow the graph's native layout (NCHW for CNNs, the
    exporter's layout otherwise)."""

    def __init__(self, graph: OnnxGraph, input_shape=None):
        """``input_shape``: per-row shape to unflatten table rows to —
        a tuple for single-input graphs, or a dict {input_name: shape}
        for multi-input ones (None entries leave rows as-is)."""
        self.nodes = graph.nodes
        self.input_names = graph.inputs
        self.output_names = graph.outputs
        self.opset = graph.opset
        if isinstance(input_shape, dict):
            self.input_shape = {k: (tuple(v) if v else None)
                                for k, v in input_shape.items()}
        else:
            self.input_shape = tuple(input_shape) if input_shape else None
        # int-element graph inputs (token ids) — TPUModel reads this to
        # feed integer ids instead of the float compute dtype
        infos = [graph.input_infos.get(n, (None, None))
                 for n in graph.inputs]
        self.int_input = bool(infos) and all(
            e in _INT_ELEM_TYPES for e, _ in infos if e is not None
        ) and any(e is not None for e, _ in infos)
        # shape-like inputs (reshape targets, axes, slice bounds) come
        # from initializers or Constant nodes in exported graphs; they,
        # and every SMALL integer initializer/constant, stay numpy on the
        # host, so shape chains (Shape->Gather->Concat->Reshape) never
        # round-trip through the device
        consts: Dict[str, np.ndarray] = {}
        for node in graph.nodes:
            if node.op_type == "Constant" and node.outputs:
                v_c = _constant_value(node.attrs)
                if v_c is not None:
                    consts[node.outputs[0]] = v_c
        needed = set()
        for node in graph.nodes:
            for slot in _SHAPE_SLOTS.get(node.op_type, ()):
                if slot < len(node.inputs) and node.inputs[slot]:
                    needed.add(node.inputs[slot])
        self._static: Dict[str, np.ndarray] = {}
        for name in needed:
            if name in graph.initializers:
                self._static[name] = np.asarray(graph.initializers[name])
            elif name in consts:
                self._static[name] = consts[name]
        for src in (graph.initializers, consts):
            for name, arr in src.items():
                arr = np.asarray(arr)
                if arr.size <= 64 and np.issubdtype(arr.dtype, np.integer):
                    self._static.setdefault(name, arr)

    # -- value helpers ------------------------------------------------------

    def _t(self, v: Any, dev: torch.device) -> torch.Tensor:
        """``v`` as a tensor on ``dev`` (host values: float64 as float32,
        as the JAX executor would take them)."""
        if isinstance(v, torch.Tensor):
            return v if v.device == dev else v.to(dev)
        arr = np.asarray(v)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        return torch.from_numpy(np.array(arr)).to(dev)

    def _static_ints(self, node: OnnxNode, slot: int,
                     x: List[Any]) -> Optional[List[int]]:
        """A shape-like input as a list of python ints: from the static
        table, else from its runtime value."""
        if slot >= len(node.inputs) or not node.inputs[slot]:
            return None
        name = node.inputs[slot]
        if name in self._static:
            return [int(v) for v in self._static[name].ravel()]
        v = x[slot]
        if v is None:
            return None
        if isinstance(v, torch.Tensor):
            return [int(q) for q in v.detach().cpu().reshape(-1).tolist()]
        return [int(q) for q in np.asarray(v).ravel()]

    # -- the interpreter ----------------------------------------------------

    def __call__(self, weights: Dict[str, Any], inputs: Dict[str, Any]):
        from mmlspark_tpu_torch.models.networks import strict_f32
        env: Dict[str, Any] = dict(weights)
        env.update(self._static)
        # bind by NAME when the feed keys are the graph input names
        # (multi-input models); positional only for the single-input
        # case (whose feed key is "input")
        if set(self.input_names) <= set(inputs.keys()):
            bound = [(n, inputs[n]) for n in self.input_names]
        elif len(self.input_names) == 1:
            bound = list(zip(self.input_names, inputs.values()))
        else:
            raise KeyError(
                f"multi-input graph needs feeds keyed by its input "
                f"names {self.input_names}, got {sorted(inputs)}")
        dev = None
        for name, v in bound:
            if not isinstance(v, torch.Tensor):
                v = torch.as_tensor(np.asarray(v))
            shp = (self.input_shape.get(name)
                   if isinstance(self.input_shape, dict)
                   else self.input_shape)
            if shp:
                v = v.reshape((v.shape[0],) + tuple(shp))
            env[name] = v
            dev = v.device if dev is None else dev
        dev = dev or torch.device("cpu")
        with strict_f32():
            for node in self.nodes:
                x = [env[i] if i else None for i in node.inputs]
                out = self._run(node, x, dev)
                outs_t = out if isinstance(out, tuple) else (out,)
                for oname, oval in zip(node.outputs, outs_t):
                    if oname:
                        env[oname] = oval
        outs = [self._t(env[o], dev) for o in self.output_names]
        return outs[0] if len(outs) == 1 else tuple(outs)

    def _run(self, node: OnnxNode, x: List[Any], dev: torch.device):
        a = node.attrs
        op = node.op_type
        T = lambda v: self._t(v, dev)  # noqa: E731
        if op == "Conv":
            w = T(x[1])
            sp = w.ndim - 2                    # spatial rank: 1-D or 2-D
            strides = a.get("strides", [1] * sp)
            pads = a.get("pads", [0] * (2 * sp))
            dil = a.get("dilations", [1] * sp)
            groups = int(a.get("group", 1))
            inp = T(x[0])
            if any(pads):
                inp = F.pad(inp, _torch_pads(pads))
            conv = F.conv1d if sp == 1 else F.conv2d
            out = conv(inp, w, None, stride=tuple(strides),
                       dilation=tuple(dil), groups=groups)
            if len(x) > 2 and x[2] is not None:
                out = out + T(x[2]).reshape((1, -1) + (1,) * sp)
            return out
        if op == "BatchNormalization":
            eps = a.get("epsilon", 1e-5)
            xin = T(x[0])
            scale, b, mean, var = (T(t) for t in x[1:5])
            inv = scale / torch.sqrt(var + eps)
            # per-channel broadcast by spatial rank (module docstring)
            shape = (1, -1) + (1,) * (xin.ndim - 2)
            return (xin - mean.reshape(shape)) * inv.reshape(shape) \
                + b.reshape(shape)
        if op == "Relu":
            return torch.relu(T(x[0]))
        if op in ("MaxPool", "AveragePool"):
            return self._pool(op, T(x[0]), a)
        if op == "GlobalAveragePool":
            v = T(x[0])
            return v.mean(dim=tuple(range(2, v.ndim)), keepdim=True)
        if op in ("Add", "Sub", "Mul", "Div", "Pow"):
            if _all_host(x[0], x[1]):
                f = {"Add": np.add, "Sub": np.subtract,
                     "Mul": np.multiply, "Div": np.true_divide,
                     "Pow": np.power}[op]
                return f(x[0], x[1])
            f = {"Add": torch.add, "Sub": torch.sub, "Mul": torch.mul,
                 "Div": torch.div, "Pow": torch.pow}[op]
            return f(T(x[0]), T(x[1]))
        if op == "Neg":
            return -x[0] if _host(x[0]) else -T(x[0])
        if op == "Exp":
            return torch.exp(T(x[0]))
        if op == "Erf":
            return torch.erf(T(x[0]))
        if op == "Where":
            return torch.where(T(x[0]).bool(), T(x[1]), T(x[2]))
        if op == "Sqrt":
            return torch.sqrt(T(x[0]))
        if op == "Sigmoid":
            return torch.sigmoid(T(x[0]))
        if op == "Tanh":
            return torch.tanh(T(x[0]))
        if op == "LeakyRelu":
            v = T(x[0])
            alpha = a.get("alpha", 0.01)
            return torch.where(v >= 0, v, alpha * v)
        if op in ("Softmax", "LogSoftmax"):
            fn = torch.softmax if op == "Softmax" else torch.log_softmax
            v = T(x[0])
            if self.opset >= 13:
                return fn(v, dim=int(a.get("axis", -1)))
            # legacy semantics: flatten to 2D at axis, softmax over the
            # trailing block, restore shape
            ax = int(a.get("axis", 1)) % v.ndim
            flat = v.reshape((int(np.prod(v.shape[:ax])) if ax else 1, -1))
            return fn(flat, dim=-1).reshape(v.shape)
        if op == "Gemm":
            alpha = a.get("alpha", 1.0)
            beta = a.get("beta", 1.0)
            A = T(x[0])
            A = A.T if a.get("transA", 0) else A
            B = T(x[1])
            if a.get("transB", 0):
                B = B.T
            out = alpha * (A @ B)
            if len(x) > 2 and x[2] is not None:
                out = out + beta * T(x[2])
            return out
        if op == "MatMul":
            return torch.matmul(T(x[0]), T(x[1]))
        if op == "Flatten":
            ax = int(a.get("axis", 1))
            v = x[0] if _host(x[0]) else T(x[0])
            shape = v.shape
            return v.reshape((int(np.prod(shape[:ax])) if ax else 1, -1))
        if op == "Reshape":
            target = self._static_ints(node, 1, x)
            v = x[0] if _host(x[0]) else T(x[0])
            shape = list(v.shape)
            target = [shape[i] if t == 0 else int(t)
                      for i, t in enumerate(target)]
            return v.reshape(target)
        if op == "Transpose":
            perm = a.get("perm")
            if _host(x[0]):
                return np.transpose(x[0], tuple(perm) if perm else None)
            v = T(x[0])
            return v.permute(tuple(perm) if perm
                             else tuple(reversed(range(v.ndim))))
        if op == "Concat":
            parts = [t for t in x if t is not None]
            ax = int(a["axis"])
            if _all_host(*parts):
                return np.concatenate([np.atleast_1d(t) for t in parts],
                                      axis=ax)
            return torch.cat([T(np.atleast_1d(t)) if _host(t) else T(t)
                              for t in parts], dim=ax)
        if op == "Squeeze":
            axes = (a.get("axes") if self.opset < 13
                    else self._static_ints(node, 1, x))
            if _host(x[0]):
                v = np.asarray(x[0])
                return (np.squeeze(v, axis=tuple(ax % v.ndim for ax in axes))
                        if axes else np.squeeze(v))
            v = T(x[0])
            if axes:
                return v.squeeze(tuple(ax % v.ndim for ax in axes))
            return v.squeeze()
        if op == "Unsqueeze":
            axes = (a.get("axes") if self.opset < 13
                    else self._static_ints(node, 1, x))
            if _host(x[0]):
                v = np.asarray(x[0])
                nd = v.ndim + len(axes)
                return np.expand_dims(v, axis=tuple(ax % nd for ax in axes))
            v = T(x[0])
            nd = v.ndim + len(axes)
            for ax in sorted(ax % nd for ax in axes):
                v = v.unsqueeze(ax)
            return v
        if op == "Slice":
            return self._slice(node, x, a, dev)
        if op == "Split":
            v = T(x[0])
            ax = int(a.get("axis", 0)) % v.ndim
            sizes = (list(a["split"]) if "split" in a
                     else self._static_ints(node, 1, x))
            n_out = len([o for o in node.outputs if o])
            if sizes is None:
                # even split; ONNX lets the LAST chunk be smaller when
                # the axis is not divisible (ceil-sized rest)
                n_out = int(a.get("num_outputs", n_out))
                dim = v.shape[ax]
                chunk = -(-dim // n_out)
                sizes = [chunk] * (dim // chunk)
                if dim % chunk:
                    sizes.append(dim % chunk)
                if len(sizes) != n_out:
                    raise ValueError(
                        f"{_node_label(node)}: cannot split axis "
                        f"of size {dim} into {n_out} outputs")
            return tuple(torch.split(v, sizes, dim=ax))
        if op == "Expand":
            target = self._static_ints(node, 1, x)
            # bidirectional broadcast; a target dim of 1 keeps the
            # input's dim
            v = T(x[0])
            shape = list(v.shape)
            nd = max(len(target), len(shape))
            shape = [1] * (nd - len(shape)) + shape
            target = [1] * (nd - len(target)) + list(target)
            final = [max(s_, int(t)) for s_, t in zip(shape, target)]
            return torch.broadcast_to(v.reshape(shape), final)
        if op == "Shape":
            # a host value: shapes are known, so Shape->Gather->Concat->
            # Reshape chains stay on the host. start/end (opset 15+)
            shape = np.shape(x[0]) if _host(x[0]) else tuple(x[0].shape)
            r = len(shape)
            st = int(a.get("start", 0))
            en = a.get("end")
            en = r if en is None else int(en)
            st = max(st + r, 0) if st < 0 else min(st, r)
            en = max(en + r, 0) if en < 0 else min(en, r)
            return np.asarray(shape[st:en], dtype=np.int64)
        if op == "Gather":
            ax = int(a.get("axis", 0))
            if _all_host(x[0], x[1]):
                return np.take(np.asarray(x[0]), np.asarray(x[1]), axis=ax)
            v = T(x[0])
            ax %= v.ndim
            idx = T(x[1]).long()
            idx = torch.where(idx < 0, idx + v.shape[ax], idx)
            out = torch.index_select(v, ax, idx.reshape(-1))
            return out.reshape(tuple(v.shape[:ax]) + tuple(idx.shape)
                               + tuple(v.shape[ax + 1:]))
        if op == "Cast":
            dt = np.dtype(_TENSOR_DTYPES[a["to"]])
            if _host(x[0]):
                return np.asarray(x[0]).astype(dt)
            return T(x[0]).to(_TORCH_DTYPES[dt])
        if op in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin"):
            # axes: attribute in old opsets, input once moved
            # (ReduceSum at 13, the others at 18)
            moved = 13 if op == "ReduceSum" else 18
            axes = (a.get("axes") if self.opset < moved
                    else self._static_ints(node, 1, x))
            keep = bool(a.get("keepdims", 1))
            v = T(x[0])
            if not axes and self.opset >= moved and \
                    a.get("noop_with_empty_axes", 0):
                return v
            dims = tuple(axes) if axes else tuple(range(v.ndim))
            if op == "ReduceMean":
                return v.mean(dim=dims, keepdim=keep)
            if op == "ReduceSum":
                return v.sum(dim=dims, keepdim=keep)
            if op == "ReduceMax":
                return v.amax(dim=dims, keepdim=keep)
            return v.amin(dim=dims, keepdim=keep)
        if op in ("Min", "Max"):
            fn = torch.minimum if op == "Min" else torch.maximum
            out = T(x[0])
            for t in x[1:]:
                out = fn(out, T(t))
            return out
        if op in ("ArgMax", "ArgMin"):
            fn = torch.argmax if op == "ArgMax" else torch.argmin
            ax = int(a.get("axis", 0))
            return fn(T(x[0]), dim=ax,
                      keepdim=bool(int(a.get("keepdims", 1)))
                      ).to(torch.int32)
        if op == "Identity":
            return x[0]
        if op == "Constant":
            out = _constant_value(a)
            if out is None:  # pragma: no cover — load validated
                raise ValueError(
                    f"{_node_label(node)}: no supported value "
                    f"attribute (have {sorted(a)})")
            return out
        if op == "Clip":
            lo = x[1] if len(x) > 1 and x[1] is not None \
                else a.get("min", -np.inf)
            hi = x[2] if len(x) > 2 and x[2] is not None \
                else a.get("max", np.inf)
            v = T(x[0])
            lo = T(lo) if isinstance(lo, torch.Tensor) else float(
                np.asarray(lo))
            hi = T(hi) if isinstance(hi, torch.Tensor) else float(
                np.asarray(hi))
            return torch.clamp(v, lo, hi)
        if op == "LSTM":
            return self._lstm(x, a, T)
        if op == "GRU":
            return self._gru(x, a, T)
        raise ValueError(f"unsupported op {op}")  # pragma: no cover

    @staticmethod
    def _pool(op: str, v: torch.Tensor, a: Dict[str, Any]) -> torch.Tensor:
        ks = list(a["kernel_shape"])
        strides = a.get("strides", [1] * len(ks))
        pads = a.get("pads", [0] * (2 * len(ks)))
        one_d = len(ks) == 1
        if op == "MaxPool":
            if any(pads):
                v = F.pad(v, _torch_pads(pads), value=float("-inf"))
            pool = F.max_pool1d if one_d else F.max_pool2d
            return pool(v, ks, strides)
        pool = F.avg_pool1d if one_d else F.avg_pool2d
        n = float(np.prod(ks))
        padded = F.pad(v, _torch_pads(pads)) if any(pads) else v
        s = pool(padded, ks, strides) * n          # window sums
        if a.get("count_include_pad", 0) or not any(pads):
            return s / n
        ones = torch.ones_like(v)
        cnt = pool(F.pad(ones, _torch_pads(pads)), ks, strides) * n
        return s / cnt

    def _slice(self, node: OnnxNode, x: List[Any], a: Dict[str, Any],
               dev: torch.device):
        if self.opset < 10:
            starts = list(a["starts"])
            ends = list(a["ends"])
            axes = list(a.get("axes", range(len(starts))))
            steps = [1] * len(starts)
        else:
            starts = self._static_ints(node, 1, x)
            ends = self._static_ints(node, 2, x)
            axes = self._static_ints(node, 3, x) or list(range(len(starts)))
            steps = self._static_ints(node, 4, x) or [1] * len(starts)
        v = x[0] if _host(x[0]) else self._t(x[0], dev)
        nd = np.ndim(v) if _host(v) else v.ndim
        idx: List[Any] = [slice(None)] * nd
        for st, en, ax, sp in zip(starts, ends, axes, steps):
            # spec: huge sentinels mean "to the end"
            en_s = None if en >= _INT32_MAX else en
            st_s = None if (sp < 0 and st >= _INT32_MAX) else st
            if sp < 0 and en <= -_INT32_MAX:
                en_s = None
            idx[ax % nd] = slice(st_s, en_s, sp)
        if _host(v):
            return np.asarray(v)[tuple(idx)]
        # torch slicing takes no negative step: gather those axes
        for ax, sl in enumerate(idx):
            if sl.step is not None and sl.step < 0:
                keep = torch.arange(*sl.indices(v.shape[ax]), device=dev)
                v = torch.index_select(v, ax, keep)
                idx[ax] = slice(None)
        return v[tuple(idx)]

    @staticmethod
    def _directions(a: Dict[str, Any]) -> List[bool]:
        return {"forward": [False], "reverse": [True],
                "bidirectional": [False, True]}[
                    a.get("direction", "forward")]

    def _lstm(self, x: List[Any], a: Dict[str, Any], T):
        """ONNX LSTM (gate order i, o, f, c; sigmoid / tanh / tanh —
        load_onnx rejected anything else), the whole sequence's input
        projection hoisted out of the recurrence. Returns ONNX's output
        triple (Y [T, dirs, B, H], Y_h, Y_c)."""
        X = T(x[0])                                # (T, B, I)
        W, R = T(x[1]), T(x[2])                    # (D, 4H, I), (D, 4H, H)
        hid = R.shape[-1]
        bsz = X.shape[1]
        bias = T(x[3]) if len(x) > 3 and x[3] is not None else None
        h0 = T(x[5]) if len(x) > 5 and x[5] is not None else None
        c0 = T(x[6]) if len(x) > 6 and x[6] is not None else None
        ys_l, h_l, c_l = [], [], []
        for d, reverse in enumerate(self._directions(a)):
            bsum = (bias[d, :4 * hid] + bias[d, 4 * hid:]
                    if bias is not None
                    else torch.zeros(4 * hid, dtype=X.dtype,
                                     device=X.device))
            h = h0[d] if h0 is not None else torch.zeros(
                (bsz, hid), dtype=X.dtype, device=X.device)
            c = c0[d] if c0 is not None else torch.zeros(
                (bsz, hid), dtype=X.dtype, device=X.device)
            xs = torch.flip(X, (0,)) if reverse else X
            xw = xs @ W[d].T + bsum                # (T, B, 4H)
            Rt = R[d].T
            ys = []
            for t in range(xw.shape[0]):
                g = xw[t] + h @ Rt
                i, o, f, cc = torch.split(g, hid, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(cc)
                h = torch.sigmoid(o) * torch.tanh(c)
                ys.append(h)
            ys_t = torch.stack(ys, 0)
            if reverse:
                ys_t = torch.flip(ys_t, (0,))
            ys_l.append(ys_t)
            h_l.append(h)
            c_l.append(c)
        return (torch.stack(ys_l, 1), torch.stack(h_l, 0),
                torch.stack(c_l, 0))

    def _gru(self, x: List[Any], a: Dict[str, Any], T):
        """ONNX GRU (gate order z, r, h; sigmoid / tanh), honoring
        ``linear_before_reset`` both ways (torch exports 1). Returns
        (Y [T, dirs, B, H], Y_h [dirs, B, H])."""
        X = T(x[0])                                # (T, B, I)
        W, R = T(x[1]), T(x[2])                    # (D, 3H, I), (D, 3H, H)
        hid = R.shape[-1]
        bsz = X.shape[1]
        bias = T(x[3]) if len(x) > 3 and x[3] is not None else None
        h0 = T(x[5]) if len(x) > 5 and x[5] is not None else None
        lbr = int(a.get("linear_before_reset", 0))
        ys_l, h_l = [], []
        for d, reverse in enumerate(self._directions(a)):
            if bias is not None:
                wb, rb = bias[d, :3 * hid], bias[d, 3 * hid:]
            else:
                wb = rb = torch.zeros(3 * hid, dtype=X.dtype,
                                      device=X.device)
            h = h0[d] if h0 is not None else torch.zeros(
                (bsz, hid), dtype=X.dtype, device=X.device)
            xs = torch.flip(X, (0,)) if reverse else X
            xw = xs @ W[d].T + wb                  # (T, B, 3H)
            Rz, Rr, Rh = torch.split(R[d], hid, dim=0)
            rbz, rbr, rbh = torch.split(rb, hid)
            ys = []
            for t in range(xw.shape[0]):
                xz, xr, xh = torch.split(xw[t], hid, dim=-1)
                z = torch.sigmoid(xz + h @ Rz.T + rbz)
                r = torch.sigmoid(xr + h @ Rr.T + rbr)
                if lbr:
                    hh = torch.tanh(xh + r * (h @ Rh.T + rbh))
                else:
                    hh = torch.tanh(xh + (r * h) @ Rh.T + rbh)
                h = (1 - z) * hh + z * h
                ys.append(h)
            ys_t = torch.stack(ys, 0)
            if reverse:
                ys_t = torch.flip(ys_t, (0,))
            ys_l.append(ys_t)
            h_l.append(h)
        return torch.stack(ys_l, 1), torch.stack(h_l, 0)


def import_onnx_model(path: str, batch_size: int = 64,
                      input_shape=None, feed_cols=None,
                      device: DeviceLike = None):
    """ONNX file -> ready-to-serve ``TPUModel`` (the ModelDownloader /
    ImageFeaturizer contract). Weights are the graph initializers (as
    tensors); the modelFn is the torch graph executor; ``device`` is the
    model's (None = the card).

    Single-input graphs feed from the ``images`` column; ``input_shape``
    (e.g. [3, 224, 224]) unflattens table rows, inferred from the
    graph's declared input shape when omitted (trailing dims after the
    batch axis — a symbolic batch dim_param is the dynamic-batch
    convention). Integer-typed graph inputs (token ids) make the model
    feed int32 rows instead of floats.

    MULTI-input graphs feed each graph input from the table column of
    the same name — ``feed_cols={input_name: column}`` overrides the
    mapping; ``input_shape`` may then be a {input_name: shape} dict. All
    inputs must share one element class (all integer or all float):
    TPUModel's feed casts per model, not per column."""
    from mmlspark_tpu_torch.models.tpu_model import TPUModel

    graph = load_onnx(path)
    if not graph.inputs:
        raise ValueError("graph declares no runtime inputs")
    elems = [graph.input_infos.get(n, (None, None))[0]
             for n in graph.inputs]
    int_flags = {e in _INT_ELEM_TYPES for e in elems if e is not None}
    if len(int_flags) > 1:
        raise ValueError(
            f"graph mixes integer and float inputs "
            f"({dict(zip(graph.inputs, elems))}); TPUModel feeds one "
            f"element class per model — split the graph or cast inside "
            f"it")
    if feed_cols:
        unknown = sorted(set(feed_cols) - set(graph.inputs))
        if unknown:
            raise ValueError(
                f"feed_cols keys {unknown} are not graph inputs "
                f"{graph.inputs}")
    if isinstance(input_shape, dict):
        unknown = sorted(set(input_shape) - set(graph.inputs))
        if unknown:
            raise ValueError(
                f"input_shape keys {unknown} are not graph inputs "
                f"{graph.inputs}")
    apply_fn = OnnxApply(graph, input_shape=input_shape)

    def _declared(name):
        _e, dims = graph.input_infos.get(name, (None, None))
        if dims and len(dims) > 1 and all(
                d is not None for d in dims[1:]):
            return tuple(dims[1:])
        return None

    def model(**kw):
        return TPUModel(
            modelFn=apply_fn,
            weights={k: _weight_tensor(v)
                     for k, v in graph.initializers.items()},
            outputCol="scores", batchSize=batch_size,
            computeDtype="float32", device=str(resolve_device(device)),
            **kw)

    if len(graph.inputs) == 1:
        if apply_fn.input_shape is None:
            apply_fn.input_shape = _declared(graph.inputs[0])
        return model(inputCol="images")
    if apply_fn.input_shape is not None and not isinstance(
            apply_fn.input_shape, dict):
        raise ValueError(
            "multi-input graphs need input_shape as a "
            "{input_name: shape} dict (or omitted)")
    # a PARTIAL dict still infers the unlisted inputs from the declared
    # value infos (an explicit None entry disables)
    given = dict(apply_fn.input_shape or {})
    apply_fn.input_shape = {
        n: given[n] if n in given else _declared(n)
        for n in graph.inputs}
    feed = {n: (feed_cols or {}).get(n, n) for n in graph.inputs}
    return model(feedDict=feed)


def onnx_summary(path: str) -> Dict[str, Any]:
    """Structural manifest of an ONNX file (op histogram, opset,
    initializer count/bytes, inputs/outputs) — the validation hook
    ModelDownloader schemas record."""
    graph = load_onnx(path)
    ops: Dict[str, int] = {}
    for node in graph.nodes:
        ops[node.op_type] = ops.get(node.op_type, 0) + 1
    return {
        "ops": dict(sorted(ops.items())),
        "opset": graph.opset,
        "num_initializers": len(graph.initializers),
        "initializer_bytes": int(sum(
            v.nbytes for v in graph.initializers.values())),
        "inputs": graph.inputs,
        "outputs": graph.outputs,
    }
