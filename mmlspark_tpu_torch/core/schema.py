"""Column schemas and metadata.

The PyTorch port keeps its own copy of ``mmlspark_tpu/core/schema.py``
(it imports nothing of the JAX package); the two must stay in step.

Analog of the reference's core/schema layer:
- ``Schema``/``Field`` — ordered, typed column descriptors with per-column
  metadata (ref: src/core/schema/src/main/scala/SparkSchema.scala:13).
- ``ImageSchema`` — image-column struct layout
  (ref: src/core/schema/src/main/scala/ImageSchema.scala:12-22).
- ``BinaryFileSchema`` — binary-file struct layout
  (ref: src/core/schema/src/main/scala/BinaryFileSchema.scala:9).
- Categorical metadata on columns
  (ref: src/core/schema/src/main/scala/Categoricals.scala:16).

Unlike Spark's Catalyst types we keep a small tag set that maps directly to
numpy/JAX dtypes; complex values (images, binary files, HTTP requests) are
struct columns whose fields are themselves schema'd.
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# dtype tags
# ---------------------------------------------------------------------------

# scalar tags map 1:1 onto numpy dtypes; complex tags are struct-like
F32, F64 = "f32", "f64"
I8, I16, I32, I64 = "i8", "i16", "i32", "i64"
U8 = "u8"
BOOL = "bool"
STRING = "str"
BYTES = "bytes"
VECTOR = "vector"     # fixed or ragged 1-D float vector per row
TENSOR = "tensor"     # n-d array per row
STRUCT = "struct"     # dict per row (fields described in Field.fields)
OBJECT = "obj"        # anything else (python objects)
LIST = "list"         # variable-length list per row

_NUMPY_TO_TAG = {
    np.dtype(np.float32): F32,
    np.dtype(np.float64): F64,
    np.dtype(np.int8): I8,
    np.dtype(np.int16): I16,
    np.dtype(np.int32): I32,
    np.dtype(np.int64): I64,
    np.dtype(np.uint8): U8,
    np.dtype(np.bool_): BOOL,
}

_TAG_TO_NUMPY = {v: k for k, v in _NUMPY_TO_TAG.items()}

NUMERIC_TAGS = {F32, F64, I8, I16, I32, I64, U8, BOOL}


def numpy_dtype_for(tag: str):
    """numpy dtype for a scalar tag, or None for complex tags."""
    return _TAG_TO_NUMPY.get(tag)


def tag_for_numpy(dtype) -> str:
    dtype = np.dtype(dtype)
    if dtype in _NUMPY_TO_TAG:
        return _NUMPY_TO_TAG[dtype]
    if dtype.kind in ("U", "S"):
        return STRING
    return OBJECT


# ---------------------------------------------------------------------------
# Field / Schema
# ---------------------------------------------------------------------------


class Field:
    """A named, typed column descriptor with attached metadata.

    ``meta`` carries the analog of Spark column metadata: categorical levels
    (ref: Categoricals.scala:16-80), label/score roles
    (ref: SparkSchema.scala:13-60), ml attributes, etc.
    """

    __slots__ = ("name", "tag", "meta", "fields")

    def __init__(self, name: str, tag: str, meta: Optional[Dict[str, Any]] = None,
                 fields: Optional[List["Field"]] = None):
        self.name = name
        self.tag = tag
        self.meta = dict(meta or {})
        self.fields = list(fields or [])  # for STRUCT columns

    def with_meta(self, **kv) -> "Field":
        f = Field(self.name, self.tag, {**self.meta, **kv}, self.fields)
        return f

    def to_json(self) -> Dict[str, Any]:
        out = {"name": self.name, "tag": self.tag}
        if self.meta:
            out["meta"] = self.meta
        if self.fields:
            out["fields"] = [f.to_json() for f in self.fields]
        return out

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Field":
        return Field(
            d["name"], d["tag"], d.get("meta"),
            [Field.from_json(f) for f in d.get("fields", [])],
        )

    def __repr__(self):
        extra = f", meta={self.meta}" if self.meta else ""
        return f"Field({self.name!r}, {self.tag!r}{extra})"

    def __eq__(self, other):
        return (isinstance(other, Field) and self.name == other.name
                and self.tag == other.tag and self.meta == other.meta
                and self.fields == other.fields)


class Schema:
    """Ordered collection of Fields. Immutable-by-convention."""

    def __init__(self, fields: Sequence[Field] = ()):
        self._fields: List[Field] = list(fields)
        self._index = {f.name: i for i, f in enumerate(self._fields)}
        if len(self._index) != len(self._fields):
            raise ValueError("duplicate column names in schema")

    @property
    def names(self) -> List[str]:
        return [f.name for f in self._fields]

    @property
    def fields(self) -> List[Field]:
        return list(self._fields)

    def __iter__(self) -> Iterator[Field]:
        return iter(self._fields)

    def __len__(self):
        return len(self._fields)

    def __contains__(self, name: str):
        return name in self._index

    def __getitem__(self, name: str) -> Field:
        if name not in self._index:
            raise KeyError(f"column {name!r} not in schema {self.names}")
        return self._fields[self._index[name]]

    def get(self, name: str) -> Optional[Field]:
        i = self._index.get(name)
        return None if i is None else self._fields[i]

    def add(self, field: Field) -> "Schema":
        if field.name in self._index:
            raise ValueError(f"column {field.name!r} already exists")
        return Schema(self._fields + [field])

    def replace(self, field: Field) -> "Schema":
        fields = list(self._fields)
        fields[self._index[field.name]] = field
        return Schema(fields)

    def add_or_replace(self, field: Field) -> "Schema":
        return self.replace(field) if field.name in self._index else self.add(field)

    def drop(self, *names: str) -> "Schema":
        drop = set(names)
        return Schema([f for f in self._fields if f.name not in drop])

    def select(self, *names: str) -> "Schema":
        return Schema([self[n] for n in names])

    def rename(self, mapping: Dict[str, str]) -> "Schema":
        out = []
        for f in self._fields:
            if f.name in mapping:
                out.append(Field(mapping[f.name], f.tag, f.meta, f.fields))
            else:
                out.append(f)
        return Schema(out)

    def require(self, name: str, tags: Optional[Sequence[str]] = None) -> Field:
        """transformSchema-style validation helper."""
        f = self[name]
        if tags is not None and f.tag not in tags:
            raise TypeError(
                f"column {name!r} has type {f.tag!r}; expected one of {list(tags)}")
        return f

    def find_unused_name(self, base: str) -> str:
        """ref: core/schema DatasetExtensions.findUnusedColumnName."""
        name = base
        i = 1
        while name in self._index:
            name = f"{base}_{i}"
            i += 1
        return name

    def to_json(self) -> List[Dict[str, Any]]:
        return [f.to_json() for f in self._fields]

    @staticmethod
    def from_json(lst: List[Dict[str, Any]]) -> "Schema":
        return Schema([Field.from_json(d) for d in lst])

    def copy(self) -> "Schema":
        return Schema([_copy.deepcopy(f) for f in self._fields])

    def __repr__(self):
        inner = ", ".join(f"{f.name}:{f.tag}" for f in self._fields)
        return f"Schema({inner})"

    def __eq__(self, other):
        return isinstance(other, Schema) and self._fields == other._fields


# ---------------------------------------------------------------------------
# Image / binary-file struct schemas
# ---------------------------------------------------------------------------


class ImageSchema:
    """Image struct layout: {path, height, width, channels, mode, data}.

    The reference stores (path, height, width, cvType, bytes) with OpenCV
    BGR byte order (ref: ImageSchema.scala:12-22). We keep HWC uint8 numpy
    arrays in ``data`` with an explicit ``mode`` ("BGR", "RGB", "GRAY") —
    TPU-side code converts to CHW float via UnrollImage.
    """

    PATH, HEIGHT, WIDTH, CHANNELS, MODE, DATA = (
        "path", "height", "width", "channels", "mode", "data")

    FIELDS = [
        Field(PATH, STRING),
        Field(HEIGHT, I32),
        Field(WIDTH, I32),
        Field(CHANNELS, I32),
        Field(MODE, STRING),
        Field(DATA, TENSOR),
    ]

    @staticmethod
    def field(name: str = "image", meta: Optional[Dict[str, Any]] = None) -> Field:
        m = {"struct_kind": "image"}
        m.update(meta or {})
        return Field(name, STRUCT, m, ImageSchema.FIELDS)

    @staticmethod
    def is_image(field: Field) -> bool:
        return field.tag == STRUCT and field.meta.get("struct_kind") == "image"

    @staticmethod
    def make_row(path: str, data: np.ndarray, mode: str = "BGR") -> Dict[str, Any]:
        data = np.asarray(data)
        if data.ndim == 2:
            data = data[:, :, None]
        h, w, c = data.shape
        return {
            ImageSchema.PATH: path,
            ImageSchema.HEIGHT: int(h),
            ImageSchema.WIDTH: int(w),
            ImageSchema.CHANNELS: int(c),
            ImageSchema.MODE: mode,
            ImageSchema.DATA: np.ascontiguousarray(data, dtype=np.uint8),
        }


class BinaryFileSchema:
    """Binary-file struct: {path, bytes} (ref: BinaryFileSchema.scala:9)."""

    PATH, BYTES = "path", "bytes"

    FIELDS = [Field(PATH, STRING), Field(BYTES, BYTES)]

    @staticmethod
    def field(name: str = "value", meta: Optional[Dict[str, Any]] = None) -> Field:
        m = {"struct_kind": "binary_file"}
        m.update(meta or {})
        return Field(name, STRUCT, m, BinaryFileSchema.FIELDS)

    @staticmethod
    def is_binary_file(field: Field) -> bool:
        return field.tag == STRUCT and field.meta.get("struct_kind") == "binary_file"

    @staticmethod
    def make_row(path: str, data: bytes) -> Dict[str, Any]:
        return {BinaryFileSchema.PATH: path, BinaryFileSchema.BYTES: bytes(data)}


# ---------------------------------------------------------------------------
# Categorical metadata (ref: Categoricals.scala)
# ---------------------------------------------------------------------------

CATEGORICAL_KEY = "categorical"


def set_categorical_levels(field: Field, levels: Sequence[Any],
                           ordinal: bool = False) -> Field:
    """Attach categorical level info to a column, like CategoricalUtilities
    (ref: Categoricals.scala:16-80)."""
    return field.with_meta(**{CATEGORICAL_KEY: {
        "levels": list(levels), "ordinal": bool(ordinal)}})


def get_categorical_levels(field: Field) -> Optional[List[Any]]:
    info = field.meta.get(CATEGORICAL_KEY)
    return None if info is None else list(info["levels"])


def is_categorical(field: Field) -> bool:
    return CATEGORICAL_KEY in field.meta


# label/score roles (ref: SparkSchema.scala)
ROLE_KEY = "role"
ROLE_LABEL = "label"
ROLE_SCORE = "score"
ROLE_SCORED_LABELS = "scored_labels"
ROLE_SCORED_PROBABILITIES = "scored_probabilities"


def set_role(field: Field, role: str, model_name: str = "") -> Field:
    return field.with_meta(**{ROLE_KEY: role, "model": model_name})


def get_role(field: Field) -> Optional[str]:
    return field.meta.get(ROLE_KEY)
