"""Stage persistence, including non-JSON ("complex") params: the port's
copy of ``mmlspark_tpu/core/serialize.py``, on the same on-disk format.

Layout::

    path/
      metadata.json        class, module, uid, json params, complex-param kinds
      complex/<name>/...   one subdir/file per complex param, by handler

Handlers are keyed by a "kind" string recorded at save time (``stage``,
``stage_list``, ``table``, ``ndarray``, ``pytree``, ``callable``,
``pickle``), so load never guesses from file extensions. A stage saved
by either package loads in the other where both have the class; what the
port does differently:

- **Class lookup.** ``metadata.json`` names the declaring module. The
  port looks the class up in its own ``STAGE_REGISTRY`` and imports, to
  register it, only modules under ``mmlspark_tpu_torch.``: a JAX-package
  module ``mmlspark_tpu.x`` maps to ``mmlspark_tpu_torch.x``. It never
  imports the JAX package.
- **Pytrees** (``leaves.npz`` + ``treedef.json``) are walked here over
  dicts, lists and tuples (the reference walks them with
  ``jax.tree_util``). A torch tensor leaf is stored as its numpy array
  and tagged ``"tensor": true`` in the skeleton, so it loads back as a
  tensor (on the CPU). bfloat16 has no numpy dtype: such a leaf is
  stored widened to float32 (exact) and tagged ``"dtype": "bfloat16"``,
  and loads back as a bfloat16 tensor. The reference ignores both tags,
  so it reads either kind of leaf as a numpy array (bf16 ones as f32).
  The reference writes an ml_dtypes bfloat16 leaf as raw 2-byte voids
  (``|V2``); the port reads those bits back as a bfloat16 tensor.
- **Pickles** (the ``pickle`` / ``callable`` kinds) load through a
  restricted unpickler that refuses classes of the JAX package and of
  jax / flax: such an object cannot run in the port, and the error says
  what to use instead. The one exception is the JAX package's
  ``CSRMatrix`` (a sparse table column), plain numpy arrays in both
  packages: it loads as the port's, and ``portable_dumps`` writes the
  port's under the JAX package's name, so sparse tables cross both ways.
"""

from __future__ import annotations

import importlib
import io
import json
import logging
import os
import pickle
import shutil
from typing import Any, Dict, List

import numpy as np
import torch

from mmlspark_tpu_torch.core.sparse import CSRMatrix
from mmlspark_tpu_torch.version import __version__

SERIALIZATION_FORMAT_VERSION = 1

_PORT = "mmlspark_tpu_torch"
_REFERENCE = "mmlspark_tpu"


# ---------------------------------------------------------------------------
# complex value handlers
# ---------------------------------------------------------------------------


def _is_stage(v) -> bool:
    from mmlspark_tpu_torch.core.stage import PipelineStage
    return isinstance(v, PipelineStage)


def _is_table(v) -> bool:
    from mmlspark_tpu_torch.core.table import DataTable
    return isinstance(v, DataTable)


def _kind_of(value: Any) -> str:
    """Pick the handler kind for a complex value."""
    if _is_stage(value):
        return "stage"
    if _is_table(value):
        return "table"
    if isinstance(value, np.ndarray):
        return "ndarray"
    if isinstance(value, (list, tuple)) and value and all(_is_stage(v) for v in value):
        return "stage_list"
    if isinstance(value, dict) and _looks_like_pytree(value):
        return "pytree"
    if callable(value):
        return "callable"
    return "pickle"


def _tree_leaves(node: Any) -> List[Any]:
    if isinstance(node, dict):
        return [x for v in node.values() for x in _tree_leaves(v)]
    if isinstance(node, (list, tuple)):
        return [x for v in node for x in _tree_leaves(v)]
    if node is None:
        return []
    return [node]


def _looks_like_pytree(d: dict) -> bool:
    """True if every leaf is an array/tensor/scalar — i.e. model weights."""
    leaves = _tree_leaves(d)
    if not leaves:
        return False
    return all(isinstance(l, (np.ndarray, np.generic, int, float, bool,
                              torch.Tensor))
               for l in leaves)


def save_complex(value: Any, path: str) -> str:
    """Save a complex value under ``path``; returns the handler kind."""
    kind = _kind_of(value)
    os.makedirs(path, exist_ok=True)
    if kind == "stage":
        save_stage(value, os.path.join(path, "stage"))
    elif kind == "stage_list":
        with open(os.path.join(path, "count.json"), "w") as f:
            json.dump({"n": len(value)}, f)
        for i, st in enumerate(value):
            save_stage(st, os.path.join(path, f"stage_{i}"))
    elif kind == "table":
        value.save(os.path.join(path, "table"))
    elif kind == "ndarray":
        np.save(os.path.join(path, "array.npy"), value, allow_pickle=False)
    elif kind == "pytree":
        _save_pytree(value, path)
    else:  # callable / pickle
        with open(os.path.join(path, "value.pkl"), "wb") as f:
            pickle.dump(value, f)
    return kind


def load_complex(kind: str, path: str) -> Any:
    if kind == "stage":
        return load_stage(os.path.join(path, "stage"))
    if kind == "stage_list":
        with open(os.path.join(path, "count.json")) as f:
            n = json.load(f)["n"]
        return [load_stage(os.path.join(path, f"stage_{i}")) for i in range(n)]
    if kind == "table":
        from mmlspark_tpu_torch.core.table import DataTable
        return DataTable.load(os.path.join(path, "table"))
    if kind == "ndarray":
        return np.load(os.path.join(path, "array.npy"), allow_pickle=False)
    if kind == "pytree":
        return _load_pytree(path)
    with open(os.path.join(path, "value.pkl"), "rb") as f:
        return restricted_loads(f.read())


# ---------------------------------------------------------------------------
# restricted unpickling
# ---------------------------------------------------------------------------


def _refusal(module: str, name: str) -> str:
    top = module.split(".")[0]
    what = f"{module}.{name}"
    if top == "flax":
        return (f"refusing to unpickle {what}: a flax module cannot run "
                "in mmlspark_tpu_torch; rebuild it as a torch module with "
                "mmlspark_tpu_torch.convert.module_from_flax(spec, "
                "variables)")
    if top in ("jax", "jaxlib"):
        return (f"refusing to unpickle {what}: jax objects cannot run in "
                "mmlspark_tpu_torch; save plain numpy arrays or a torch "
                "callable instead")
    return (f"refusing to unpickle {what}: it belongs to the JAX package "
            f"(mmlspark_tpu), which mmlspark_tpu_torch never imports; "
            f"use its counterpart in mmlspark_tpu_torch "
            f"({_PORT}{module[len(_REFERENCE):]}) and save that")


# classes of the JAX package whose pickles the port reads as its own
# class of the same arrays (and writes under the JAX package's name)
_SHARED = {("mmlspark_tpu.core.sparse", "CSRMatrix"): CSRMatrix}


class RestrictedUnpickler(pickle.Unpickler):
    """``pickle.Unpickler`` that refuses ``mmlspark_tpu.*``, ``jax*``
    and ``flax*`` classes (``pickle.UnpicklingError`` naming what to use
    instead), apart from those in ``_SHARED``; everything else resolves
    as usual."""

    def find_class(self, module: str, name: str):
        shared = _SHARED.get((module, name))
        if shared is not None:
            return shared
        top = module.split(".")[0]
        if top in (_REFERENCE, "flax") or top.startswith("jax"):
            raise pickle.UnpicklingError(_refusal(module, name))
        return super().find_class(module, name)


def restricted_loads(data: bytes) -> Any:
    return RestrictedUnpickler(io.BytesIO(data)).load()


class _ReferenceCSR:
    """Stands for the JAX package's ``CSRMatrix`` in a pickle stream:
    ``_PortablePickler`` writes its name, never imports it."""


class _PortablePickler(pickle._Pickler):
    """The pure-Python pickler, writing each port ``CSRMatrix`` as a
    call of the JAX package's class on its four arrays. The C pickler
    would import that class to check the name; this one writes the name
    alone, so the port never imports the JAX package, and the JAX
    package's plain ``pickle.load`` builds its own ``CSRMatrix``."""

    def reducer_override(self, obj):
        if isinstance(obj, CSRMatrix):
            return _ReferenceCSR, (obj.data, obj.indices, obj.indptr,
                                   obj.shape)
        return NotImplemented

    def save_global(self, obj, name=None):
        if obj is not _ReferenceCSR:
            return super().save_global(obj, name)
        self.save("mmlspark_tpu.core.sparse")
        self.save("CSRMatrix")
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def portable_dumps(obj: Dict[str, Any]) -> bytes:
    """``pickle.dumps`` of a dict of table columns that the JAX package
    also loads when a column is a port ``CSRMatrix``; the C pickler when
    none is (it is the faster)."""
    if not any(isinstance(v, CSRMatrix) for v in obj.values()):
        return pickle.dumps(obj)
    buf = io.BytesIO()
    _PortablePickler(buf, protocol=4).dump(obj)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# pytrees
# ---------------------------------------------------------------------------


def _save_pytree(tree: Any, path: str) -> None:
    """Weights pytree → npz of leaves + a JSON structure skeleton.

    The skeleton records container kinds (dict/list/tuple) and python
    scalar leaf types exactly, so the loaded tree has the same structure
    as the original (tuples stay tuples, scalars stay scalars); torch
    leaves carry ``"tensor": true`` and, for bfloat16, ``"dtype":
    "bfloat16"`` over a float32 array (see the module docstring)."""
    leaves: List[np.ndarray] = []

    def encode(node: Any) -> Any:
        if isinstance(node, dict):
            return {"t": "dict",
                    "items": {str(k): encode(v) for k, v in node.items()}}
        if isinstance(node, tuple):
            return {"t": "tuple", "items": [encode(v) for v in node]}
        if isinstance(node, list):
            return {"t": "list", "items": [encode(v) for v in node]}
        if node is None:
            return {"t": "none"}
        # leaf
        idx = len(leaves)
        out: Dict[str, Any] = {"t": "leaf", "i": idx, "py": None}
        if isinstance(node, torch.Tensor):
            t = node.detach().cpu()
            out["tensor"] = True
            if t.dtype == torch.bfloat16:
                out["dtype"] = "bfloat16"
                t = t.float()
            leaves.append(t.numpy())
            return out
        if isinstance(node, bool):
            out["py"] = "bool"
        elif isinstance(node, int):
            out["py"] = "int"
        elif isinstance(node, float):
            out["py"] = "float"
        leaves.append(np.asarray(node))
        return out

    skeleton = encode(tree)
    np.savez(os.path.join(path, "leaves.npz"),
             **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    with open(os.path.join(path, "treedef.json"), "w") as f:
        json.dump({"skeleton": skeleton, "n": len(leaves)}, f)


def _load_pytree(path: str) -> Any:
    with open(os.path.join(path, "treedef.json")) as f:
        meta = json.load(f)
    npz = np.load(os.path.join(path, "leaves.npz"))

    def decode(node: Any) -> Any:
        t = node["t"]
        if t == "dict":
            return {k: decode(v) for k, v in node["items"].items()}
        if t == "tuple":
            return tuple(decode(v) for v in node["items"])
        if t == "list":
            return [decode(v) for v in node["items"]]
        if t == "none":
            return None
        leaf = npz[f"leaf_{node['i']}"]
        if leaf.dtype == np.dtype("V2"):
            # the raw bits of an ml_dtypes bfloat16 array, as the
            # reference's np.savez writes one
            return torch.from_numpy(leaf.view(np.int16).copy()).view(
                torch.bfloat16)
        if node.get("tensor"):
            out = torch.from_numpy(np.array(leaf))
            if node.get("dtype") == "bfloat16":
                out = out.to(torch.bfloat16)
            return out
        py = node.get("py")
        if py == "bool":
            return bool(leaf.item())
        if py == "int":
            return int(leaf.item())
        if py == "float":
            return float(leaf.item())
        return leaf

    return decode(meta["skeleton"])


# ---------------------------------------------------------------------------
# json-param encoding
# ---------------------------------------------------------------------------


def _json_safe(v: Any) -> Any:
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    return v


# ---------------------------------------------------------------------------
# stage save/load
# ---------------------------------------------------------------------------


def save_stage(stage, path: str, overwrite: bool = True) -> None:
    from mmlspark_tpu_torch.core.stage import PipelineStage
    if not isinstance(stage, PipelineStage):
        raise TypeError(f"not a PipelineStage: {stage!r}")
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(path)
        shutil.rmtree(path)
    os.makedirs(path)

    json_params: Dict[str, Any] = {}
    complex_kinds: Dict[str, str] = {}
    complex_dir = os.path.join(path, "complex")
    for p in type(stage).params():
        if p.name not in stage._paramMap:
            continue
        value = stage._paramMap[p.name]
        if p.is_complex and value is not None:
            kind = save_complex(value, os.path.join(complex_dir, p.name))
            complex_kinds[p.name] = kind
        else:
            json_params[p.name] = _json_safe(value)

    extra = {}
    if hasattr(stage, "_save_extra"):
        extra_dir = os.path.join(path, "extra")
        os.makedirs(extra_dir, exist_ok=True)
        extra = stage._save_extra(extra_dir) or {}

    meta = {
        "class": type(stage).__name__,
        "module": type(stage).__module__,
        "uid": stage.uid,
        "library_version": __version__,
        "format_version": SERIALIZATION_FORMAT_VERSION,
        "params": json_params,
        "complex_params": complex_kinds,
        "extra": _json_safe(extra),
    }
    markers = _numerics_markers(stage)
    if markers:
        meta["numerics_markers"] = markers
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=1)


def _numerics_markers(stage) -> Dict[str, str]:
    """Version markers for numerics-affecting architecture changes, so a
    checkpoint trained under older numerics fails loudly on load instead
    of silently degrading. Any stage, param value, or wrapped module may
    expose ``numerics_markers() -> dict``; the serializer aggregates them
    without knowing any model class."""
    markers: Dict[str, str] = {}

    def collect(obj) -> None:
        hook = getattr(obj, "numerics_markers", None)
        if callable(hook):
            try:
                markers.update(hook())
            except Exception:
                pass

    collect(stage)
    for value in stage._paramMap.values():
        collect(value)
        collect(getattr(value, "module", None))
    return markers


def port_module(module: str) -> str:
    """The port module a saved ``module`` name resolves to:
    ``mmlspark_tpu.x`` -> ``mmlspark_tpu_torch.x``; anything outside both
    packages -> ``""`` (never imported)."""
    if module == _PORT or module.startswith(_PORT + "."):
        return module
    if module == _REFERENCE or module.startswith(_REFERENCE + "."):
        return _PORT + module[len(_REFERENCE):]
    return ""


def load_stage(path: str):
    from mmlspark_tpu_torch.core.stage import STAGE_REGISTRY, PipelineStage
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    cls_name = meta["class"]
    cls = STAGE_REGISTRY.get(cls_name)
    if cls is None:
        # import the port's declaring module, which registers the class
        module = port_module(meta.get("module", ""))
        if module:
            try:
                importlib.import_module(module)
            except ModuleNotFoundError as e:
                # only the module's own absence (the port has no such
                # module yet) is a registry miss; a fault inside it
                # propagates with its cause
                if e.name is None or not (module == e.name or
                                          module.startswith(e.name + ".")):
                    raise
        cls = STAGE_REGISTRY.get(cls_name)
    if cls is None:
        raise KeyError(f"stage class {cls_name!r} not registered; "
                       f"import its module first")
    stage: PipelineStage = cls.__new__(cls)
    PipelineStage.__init__(stage)  # fresh uid + empty param map + _post_init
    stage.uid = meta["uid"]
    for name, value in meta["params"].items():
        try:
            stage.set(name, value)
        except KeyError:
            pass  # forward-compat: ignore unknown params
    for name, kind in meta["complex_params"].items():
        value = load_complex(kind, os.path.join(path, "complex", name))
        stage._paramMap[name] = value
    if hasattr(stage, "_load_extra"):
        stage._load_extra(os.path.join(path, "extra"), meta.get("extra", {}))
    expected = _numerics_markers(stage)
    saved = meta.get("numerics_markers", {})
    for key, current in expected.items():
        if saved.get(key) != current:
            import warnings
            msg = (
                f"stage {cls_name} was saved before the {key!r} numerics "
                f"change (saved marker {saved.get(key)!r}, current "
                f"{current!r}): weights trained under the old numerics "
                f"will produce degraded outputs — retrain or re-import "
                f"the checkpoint")
            warnings.warn(msg, stacklevel=2)
            logging.getLogger("mmlspark_tpu_torch.serialize").error(msg)
    return stage
