"""Flax's msgpack weight blobs, read and written without ``flax`` or
``msgpack`` (the card machine has neither).

``flax.serialization.to_bytes(variables)`` -- how the JAX package's model
zoo stores weights (``downloader.py``) -- writes the variables tree as
one msgpack map of str keys whose leaves are msgpack ext values: type 1
for an ndarray, type 3 for a numpy scalar, each carrying a msgpack array
``[shape, dtype name, raw C-order bytes]``. This module handles the
subset flax emits -- map, array, str, bin, ext, int, float, nil and bool
-- in msgpack's smallest encodings, as the ``msgpack`` package writes
them, so ``packb(unpackb(blob)) == blob`` for a blob flax wrote. Maps
decode to dicts in their stored order. A ``bfloat16`` leaf, which numpy
cannot hold, decodes to a torch bfloat16 tensor and encodes back as one.
Flax splits an array above 1 GiB into a chunked map; this module
refuses such a map rather than return it as a tree of chunks.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np
import torch

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def _leaf(payload: bytes) -> Any:
    shape, name, raw = unpackb(payload)
    if name == "bfloat16":
        return torch.frombuffer(bytearray(raw), dtype=torch.bfloat16
                                ).reshape(shape) if raw else \
            torch.zeros(shape, dtype=torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"),
                 0xC6: (">I", "bin"), 0xC7: (">B", "ext"),
                 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"),
                 0xDB: (">I", "str"), 0xDC: (">H", "array"),
                 0xDD: (">I", "array"), 0xDE: (">H", "map"),
                 0xDF: (">I", "map")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode("utf-8")
            return getattr(self, kind)(n)
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        if 0xD4 <= b <= 0xD8:                              # fixext 1..16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def array(self, n: int) -> List[Any]:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED in out:
            raise ValueError("the blob holds an array flax split into "
                             "chunks (above 1 GiB); not supported")
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = self.take(n)
        if code == _EXT_NDARRAY:
            return _leaf(payload)
        if code == _EXT_NPSCALAR:
            return _leaf(payload)[()]
        raise ValueError(f"msgpack ext type {code} is not a flax array")


def unpackb(data: bytes) -> Any:
    """Decode one msgpack value (a flax blob: its variables tree, with
    numpy array leaves)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack "
                         "value")
    return out


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


def _sized(out: List[bytes], n: int, small: Tuple[int, int],
           codes: Tuple[int, ...]) -> None:
    """The header of a str / bin / array / map / ext of ``n`` items or
    bytes: the fix form (``small`` = (limit, base)) when it fits, else
    the 8- (where the type has one), 16- or 32-bit length form."""
    limit, base = small
    if n < limit:
        out.append(bytes([base | n]))
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I")[-len(codes):],
                              (0xFF, 0xFFFF, 0xFFFFFFFF)[-len(codes):]):
        if n <= top:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack length {n} too large")


def _int(out: List[bytes], v: int) -> None:
    if 0 <= v <= 0x7F:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v > 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise ValueError(f"integer {v} too large for msgpack")
    else:
        for code, fmt, lo in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                              (0xD2, ">i", -0x80000000),
                              (0xD3, ">q", -0x8000000000000000)):
            if v >= lo:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise ValueError(f"integer {v} too small for msgpack")


def _ext(out: List[bytes], code: int, payload: bytes) -> None:
    n = len(payload)
    if n in (1, 2, 4, 8, 16):
        out.append(bytes([0xD4 + n.bit_length() - 1]))
    else:
        _sized(out, n, (0, 0), (0xC7, 0xC8, 0xC9))
    out.append(struct.pack(">b", code) + payload)


def _leaf_payload(x: Any) -> bytes:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return packb([list(t.shape), "bfloat16",
                          t.view(torch.int16).numpy().tobytes()])
        x = t.numpy()
    a = np.asarray(x)
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise TypeError(f"cannot store dtype {a.dtype} in a flax blob")
    return packb([list(a.shape), a.dtype.name, a.tobytes("C")])


def _pack(out: List[bytes], v: Any) -> None:
    if v is None:
        out.append(b"\xc0")
    elif isinstance(v, bool):
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, int):
        _int(out, v)
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        _sized(out, len(raw), (32, 0xA0), (0xD9, 0xDA, 0xDB))
        out.append(raw)
    elif isinstance(v, (bytes, bytearray)):
        _sized(out, len(v), (0, 0), (0xC4, 0xC5, 0xC6))
        out.append(bytes(v))
    elif isinstance(v, dict):
        _sized(out, len(v), (16, 0x80), (0xDE, 0xDF))
        for k, x in v.items():
            if not isinstance(k, str):
                raise TypeError(f"flax blob keys are str, got {k!r}")
            _pack(out, k)
            _pack(out, x)
    elif isinstance(v, (list, tuple)):
        _sized(out, len(v), (16, 0x90), (0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        _ext(out, _EXT_NDARRAY, _leaf_payload(v))
    elif isinstance(v, np.generic):
        _ext(out, _EXT_NPSCALAR, _leaf_payload(v))
    else:
        raise TypeError(f"cannot store {type(v).__name__} in a flax blob")


def packb(tree: Any) -> bytes:
    """Encode ``tree`` (nested dicts with str keys, lists, scalars, numpy
    arrays or torch tensors) as ``flax.serialization.to_bytes`` would."""
    out: List[bytes] = []
    _pack(out, tree)
    return b"".join(out)
