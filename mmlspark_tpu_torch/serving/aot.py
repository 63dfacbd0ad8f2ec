"""AOT serving artifacts of the port: a fitted model or pipeline that a
fresh replica loads and serves without building or warming anything on
the request path. The port's copy of ``mmlspark_tpu/serving/aot.py``.

``export_model`` runs every pow-2 shape bucket once through the real
serving path (``TPUModel.transform`` or the fused scorer), captures the
exact tensors that path hands the forward, and exports one program per
(bucket, program) with ``torch.export.export`` at static shapes; the
programs are saved with ``torch.export.save``, the weights once beside
them. ``load_model`` rebuilds a model that dispatches each padded batch
to its program by input signature: the port runs eagerly, so there is
no trace or compile to retire, but a replica neither re-runs the
model's Python to build the graph nor unpickles the model for a shape
the artifact exported.

Artifact layout (``<dir>/``)::

    manifest.json        # kind, format, version, precision, buckets,
                         # backend, torch version, kernels, serve hints
    programs.pkl         # [{key, avals, blob}]: torch.export.save bytes
    weights.pkl          # the weights pytree (torch.save, CPU tensors)
    model_fn.pkl         # lazy fallback for shapes the artifact never
                         # saw (tpu_model kind only)
    pipeline.pkl         # the fitted stage list (pipeline kind only)
    example.pkl          # warmup example rows
    example_request.json # one ready-to-POST request body
    kernels/             # the built kernel libraries the programs launch

Two artifact kinds, as in the reference:

- ``tpu_model`` — a ``TPUModel`` (f32 or ``quantize()``d int8): one
  program per bucket, taking ``(weights, inputs)``. ``load_model``
  returns an ``AOTTPUModel`` whose ``_forward_fn`` hook dispatches by
  ``input_signature``; an unseen shape falls back to the model fn
  (unpickled lazily from ``model_fn.pkl``) and counts in
  ``jit_cache_misses``.
- ``pipeline`` — a fitted ``PipelineModel`` / ``FusedPipelineModel``
  served through the fused scorer: one program per (bucket, fused
  segment) of the SERVING plan, taking ``(consts, env)``.
  ``load_model`` rebuilds the fused pipeline and installs the programs
  with ``FusedSegment.install_aot``.

What the port does differently:

- **Programs.** ``format`` is ``torch_export``: an exported torch graph.
  The flash-attention forward is the custom op
  ``mmlspark_tpu_torch::flash_fwd`` (``ops/flash_attention.py``), one
  opaque node that launches the hand-written kernel when the loaded
  program runs. AOTInductor is not used: it would replace the eager
  kernels with generated ones, and a loaded program must answer
  bitwise as the in-process model does. An artifact of the JAX package
  (``jax_export`` StableHLO, or ``trace_cache``) cannot run here, and
  ``load_model`` refuses it; a torch artifact does not load in the JAX
  package either.
- **``kernels/`` takes the place of ``xla_cache/``.** The reference seeds
  an XLA compilation cache so a replica never compiles; the artifact
  here carries copies of the kernel libraries its programs launch, named
  by ``_build``'s hash of the sources. ``load_model`` loads a copy only
  when that name matches the tree's own sources, and otherwise the
  library builds from ``csrc/`` at the first launch as usual.
- **Precision.** ``torch.export`` does not record the TF32 flags, so a
  loaded program runs under ``networks.strict_f32()``, the context the
  eager f32 and int8 forwards compute under; the manifest's
  ``precision`` names it.
- **Devices.** Programs are exported on one device (``backend``:
  ``cuda`` or ``cpu``) and load on a device of that type only.

The cold-start runner (``python -m mmlspark_tpu_torch.serving.aot ART
--mode trace|aot``) takes its clock from the process's own start time,
so interpreter start and the torch import land inside the window in
both modes; torch is imported lazily throughout this module.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pickle
import shutil
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

ARTIFACT_VERSION = 1
FORMAT_TORCH_EXPORT = "torch_export"
# the JAX package's formats: StableHLO programs or none at all
FORMAT_JAX_EXPORT = "jax_export"
FORMAT_TRACE_CACHE = "trace_cache"

_MANIFEST = "manifest.json"
_PROGRAMS = "programs.pkl"
_WEIGHTS = "weights.pkl"
_MODEL_FN = "model_fn.pkl"
_PIPELINE = "pipeline.pkl"
_EXAMPLE = "example.pkl"
_EXAMPLE_REQUEST = "example_request.json"
_KERNELS = "kernels"

# the port's custom ops -> the kernel library each one launches
_OP_LIBRARIES = {"mmlspark_tpu_torch.flash_fwd": "flash_fwd"}
# precisions whose forwards compute under networks.strict_f32()
_STRICT_F32 = ("f32", "int8")


def input_signature(inputs: Dict[str, Any]) -> Tuple:
    """Shape/dtype signature of a named-tensor dict — the key the
    per-bucket programs dispatch on (sorted, so dict ordering can never
    alias two programs)."""
    return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                        for k, v in inputs.items()))


def _avals_of(tree):
    """Pytree of tensors -> picklable pytree of (shape, dtype-str)."""
    if isinstance(tree, dict):
        return {k: _avals_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_avals_of(v) for v in tree]
    if hasattr(tree, "shape"):
        return (tuple(tree.shape), str(tree.dtype))
    return tree


def _to_cpu(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _write_manifest(out_dir: str, manifest: Dict[str, Any]) -> None:
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)


def read_manifest(art_dir: str) -> Dict[str, Any]:
    with open(os.path.join(art_dir, _MANIFEST)) as f:
        return json.load(f)


def _read_pickle(art_dir: str, name: str) -> Any:
    from mmlspark_tpu_torch.core.serialize import restricted_loads
    with open(os.path.join(art_dir, name), "rb") as f:
        return restricted_loads(f.read())


def _write_pickle(out_dir: str, name: str, obj: Any) -> None:
    with open(os.path.join(out_dir, name), "wb") as f:
        pickle.dump(obj, f)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def export_model(model, example, out_dir: str, version: str = "v0",
                 ) -> Dict[str, Any]:
    """Export ``model`` + every (bucket, program) pair to ``out_dir``.

    ``model`` is a ``TPUModel`` (f32 or ``quantize()``d) or a fitted
    ``PipelineModel`` / ``FusedPipelineModel`` (a ``PipelineModel`` is
    fused on the card); ``example`` is the same representative-row
    table/dict ``warmup`` takes. The programs are exported on the
    model's device. Returns the written manifest."""
    from mmlspark_tpu_torch.core.fusion import FusedPipelineModel
    from mmlspark_tpu_torch.core.stage import PipelineModel
    from mmlspark_tpu_torch.models.tpu_model import TPUModel
    os.makedirs(out_dir, exist_ok=True)
    if isinstance(model, TPUModel):
        return _export_tpu_model(model, example, out_dir, version)
    if isinstance(model, (PipelineModel, FusedPipelineModel)):
        return _export_pipeline(model, example, out_dir, version)
    raise TypeError(
        f"cannot AOT-export {type(model).__name__}: expected TPUModel, "
        f"PipelineModel, or FusedPipelineModel")


def _export_program(module, args) -> Tuple[bytes, List[str]]:
    """``torch.export`` of ``module`` at the static shapes of ``args``:
    the saved program and the kernel libraries its custom ops launch."""
    import torch
    ep = torch.export.export(module, args, strict=False)
    libs = sorted({lib for node in ep.graph.nodes
                   for op, lib in _OP_LIBRARIES.items()
                   if str(node.target).startswith(op + ".")})
    # the example inputs hold the weights: they travel once, in
    # weights.pkl, not inside every program
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue(), libs


def _copy_kernels(out_dir: str, libs) -> Dict[str, str]:
    """Copy each built library ``libs`` names into ``kernels/``; a
    library that was never built here (the CPU runs the plain versions)
    is not carried. Returns {library: file name}."""
    from mmlspark_tpu_torch import _build
    carried: Dict[str, str] = {}
    for lib in sorted(set(libs)):
        src = _build.library_path(lib)
        if not src.exists():
            continue
        os.makedirs(os.path.join(out_dir, _KERNELS), exist_ok=True)
        shutil.copyfile(src, os.path.join(out_dir, _KERNELS, src.name))
        carried[lib] = src.name
    return carried


def _common_manifest(kind: str, version: str, device) -> Dict[str, Any]:
    import torch
    return {"artifact_version": ARTIFACT_VERSION, "kind": kind,
            "format": FORMAT_TORCH_EXPORT, "version": version,
            "backend": device.type, "torch_version": torch.__version__}


def _export_tpu_model(model, example, out_dir: str,
                      version: str) -> Dict[str, Any]:
    import torch
    from mmlspark_tpu_torch.core.serialize import restricted_loads
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.models.tpu_model import TPUModel
    table = example if isinstance(example, DataTable) \
        else DataTable(dict(example))
    if len(table) == 0:
        raise ValueError("export needs at least one example row")

    # the export clone shares the weights; its forward records every
    # (weights, inputs) call, so export sees EXACTLY the tensors the
    # real transform path builds (coercion, padding, dtype casts)
    clone = TPUModel(modelFn=model.get("modelFn"),
                     weights=model.get("weights"),
                     feedDict=model.get("feedDict"),
                     fetchDict=model.get("fetchDict"),
                     batchSize=model.get("batchSize"),
                     computeDtype=model.get("computeDtype"),
                     inputCol=model.get("inputCol"),
                     outputCol=model.get("outputCol"),
                     precision=model.get("precision"),
                     device=model.get("device"))
    model_fn = model.get("modelFn")
    calls: List[Tuple[Any, Dict[str, Any]]] = []

    def capture(weights, inputs):
        calls.append((weights, inputs))
        return model_fn(weights, inputs)

    clone._forward_fn = lambda: capture
    for b in clone.bucket_sizes():
        idx = np.resize(np.arange(len(table)), b)
        clone.transform(table._take_indices(idx))

    fn_blob = pickle.dumps(model_fn)

    class Forward(torch.nn.Module):
        # a fresh copy of the model fn, as model_fn.pkl carries it: the
        # export's traced values never reach the live model's caches
        def __init__(self):
            super().__init__()
            self.fn = restricted_loads(fn_blob)

        def forward(self, weights, inputs):
            out = self.fn(weights, inputs)
            return out if isinstance(out, dict) else {"output": out}

    records: List[Dict[str, Any]] = []
    libs: List[str] = []
    seen = set()
    for weights_dev, inputs in calls:
        sig = input_signature(inputs)
        if sig in seen:
            continue
        seen.add(sig)
        blob, used = _export_program(Forward(), (weights_dev, inputs))
        libs += used
        records.append({"key": sig, "weights_avals": _avals_of(weights_dev),
                        "inputs_avals": _avals_of(inputs), "blob": blob})

    _write_pickle(out_dir, _PROGRAMS, records)
    torch.save(_to_cpu(model.get("weights")),
               os.path.join(out_dir, _WEIGHTS))
    with open(os.path.join(out_dir, _MODEL_FN), "wb") as f:
        f.write(fn_blob)
    example_cols = {c: np.asarray(table[c][:1]).tolist()
                    if isinstance(table[c], np.ndarray)
                    else list(table[c][:1]) for c in table.column_names}
    _write_pickle(out_dir, _EXAMPLE, example_cols)
    field = list(clone._feeds().values())[0]
    req = {field: np.asarray(table[field][:1]).ravel().tolist()}
    with open(os.path.join(out_dir, _EXAMPLE_REQUEST), "w") as f:
        json.dump(req, f)
    manifest = _common_manifest("tpu_model", version, clone._device())
    manifest.update({
        "precision": model.get("precision"),
        "buckets": clone.bucket_sizes(),
        "programs": len(records),
        "batch_size": int(model.get("batchSize")),
        "compute_dtype": model.get("computeDtype"),
        "int_input": bool(getattr(model_fn, "int_input", False)),
        "vocab_size": getattr(model_fn, "vocab_size", None),
        "feeds": clone._feeds(),
        "fetches": clone._fetches(),
        "serve": {"field": field},
        "kernels": _copy_kernels(out_dir, libs),
    })
    _write_manifest(out_dir, manifest)
    return manifest


@contextlib.contextmanager
def _capture_segment_calls():
    """Export-time hook: wrap ``FusedSegment.run`` so every fused
    dispatch records (segment, consts, env) — the exact tensors the
    serving path builds (bucket padding included)."""
    from mmlspark_tpu_torch.core import fusion as FZ
    orig = FZ.FusedSegment.run
    calls: List[Tuple[Any, Any, Dict[str, Any]]] = []

    def wrapper(seg, consts, env):
        calls.append((seg, consts, env))
        return orig(seg, consts, env)

    FZ.FusedSegment.run = wrapper
    try:
        yield calls
    finally:
        FZ.FusedSegment.run = orig


def _export_pipeline(pipeline, example, out_dir: str,
                     version: str) -> Dict[str, Any]:
    import torch
    from mmlspark_tpu_torch.core.fusion import FusedPipelineModel
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.io.http import _jsonable
    from mmlspark_tpu_torch.serving.fleet import _FusedPipelineScorer
    fused = pipeline if isinstance(pipeline, FusedPipelineModel) \
        else pipeline.fused()
    table = example if isinstance(example, DataTable) \
        else DataTable(dict(example))
    if len(table) == 0:
        raise ValueError("export needs at least one example row")
    scorer = _FusedPipelineScorer(fused, batch_size=fused.batch_size)

    with _capture_segment_calls() as calls:
        scorer.warmup(table)
    if not calls:
        raise ValueError(
            "nothing to AOT-export: the serving plan has no fused "
            "segment (host-only pipelines have no device programs to "
            "serialize)")
    # resolve each captured segment to its step index in the serving
    # plan (the plan load_model will rebuild)
    plan = next((p for p in fused._plans.values()
                 if any(step is calls[0][0] for step in p.steps)), None)
    if plan is None:
        raise RuntimeError("serving plan not found after warmup")

    class Segment(torch.nn.Module):
        def __init__(self, seg):
            super().__init__()
            self.seg = seg

        def forward(self, consts, env):
            return self.seg.apply_ops(consts, env)

    records = []
    libs: List[str] = []
    seen = set()
    for seg, consts, env in calls:
        step = next(i for i, s in enumerate(plan.steps) if s is seg)
        sig = input_signature(env)
        if (step, sig) in seen:
            continue
        seen.add((step, sig))
        blob, used = _export_program(Segment(seg), (consts, env))
        libs += used
        records.append({"step": step, "key": sig,
                        "consts_avals": _avals_of(consts),
                        "env_avals": _avals_of(env), "blob": blob})

    _write_pickle(out_dir, _PROGRAMS, records)
    _write_pickle(out_dir, _PIPELINE, {
        "stages": fused.get_stages(), "in_schema": plan.in_schema,
        "final_needed": plan.final_needed, "reply_col": scorer.reply_col,
        "row_names": list(scorer._row_names)})
    _write_pickle(out_dir, _EXAMPLE,
                  {c: [table[c][0]] for c in table.column_names})
    with open(os.path.join(out_dir, _EXAMPLE_REQUEST), "w") as f:
        json.dump({c: _jsonable(table[c][0]) for c in table.column_names},
                  f)
    manifest = _common_manifest("pipeline", version, fused.device)
    manifest.update({
        "precision": fused.precision,
        "buckets": fused.bucket_sizes(),
        "programs": len(records),
        "batch_size": int(fused.batch_size),
        "serve": {"reply_col": scorer.reply_col},
        "kernels": _copy_kernels(out_dir, libs),
    })
    _write_manifest(out_dir, manifest)
    return manifest


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------


class _LazyModelFn:
    """Placeholder model fn on an AOT-loaded model: carries the model's
    ``int_input`` / ``vocab_size`` (the transform path needs them to
    coerce feeds) without unpickling — calling it means the lazy
    fallback failed to load."""

    def __init__(self, int_input: bool, vocab_size: Optional[int] = None):
        self.int_input = bool(int_input)
        self.vocab_size = vocab_size

    def __call__(self, *a, **kw):
        raise RuntimeError("AOT placeholder model fn invoked; the "
                           "fallback failed to load")


def _load_program(blob: bytes, precision: str) -> Callable:
    """One saved program -> a callable running it under the context the
    eager forward computes under."""
    import torch
    from mmlspark_tpu_torch.models.networks import strict_f32
    if precision not in _STRICT_F32:
        raise ValueError(f"unknown artifact precision {precision!r}")
    module = torch.export.load(io.BytesIO(blob)).module()

    def call(*args):
        with strict_f32():
            return module(*args)

    return call


def _adopt_kernels(art_dir: str, manifest: Dict[str, Any]) -> None:
    from mmlspark_tpu_torch import _build
    for lib, fname in manifest.get("kernels", {}).items():
        _build.adopt(lib, os.path.join(art_dir, _KERNELS, fname))


def _check_artifact(art_dir: str, manifest: Dict[str, Any], device):
    """The device to load on, after refusing what cannot load here."""
    from mmlspark_tpu_torch.device import resolve_device
    fmt = manifest.get("format")
    if fmt in (FORMAT_JAX_EXPORT, FORMAT_TRACE_CACHE):
        raise ValueError(
            f"AOT artifact {art_dir!r} was written by the JAX package "
            f"(format {fmt!r}): its programs are StableHLO executables, "
            f"not exported torch graphs, and cannot run in "
            f"mmlspark_tpu_torch — export the model again with "
            f"mmlspark_tpu_torch.serving.aot.export_model")
    if fmt != FORMAT_TORCH_EXPORT:
        raise ValueError(f"unknown AOT artifact format {fmt!r} in "
                         f"{art_dir!r}")
    dev = resolve_device(device)
    if dev.type != manifest["backend"]:
        raise ValueError(
            f"AOT artifact {art_dir!r} was exported on {manifest['backend']}"
            f" and cannot load on {dev}: export it on that device")
    return dev


def load_model(art_dir: str, device=None):
    """Rebuild a served model from an AOT artifact on ``device`` (None =
    the card): the exported programs loaded, the model answering every
    exported shape from them. Returns an ``AOTTPUModel`` (tpu_model
    kind) or a ``FusedPipelineModel`` with the programs installed
    (pipeline kind); both carry ``aot=True`` + the artifact's
    ``precision`` for the serving_model_info labels, and slot straight
    into ``json_scoring_pipeline`` / ``ServingEngine.swap``. Refuses the
    JAX package's artifacts."""
    manifest = read_manifest(art_dir)
    dev = _check_artifact(art_dir, manifest, device)
    # the custom ops must be registered before a program deserializes
    import mmlspark_tpu_torch.ops.flash_attention  # noqa: F401
    _adopt_kernels(art_dir, manifest)
    if manifest["kind"] == "tpu_model":
        return _load_tpu_model(art_dir, manifest, dev)
    if manifest["kind"] == "pipeline":
        return _load_pipeline(art_dir, manifest, dev)
    raise ValueError(f"unknown artifact kind {manifest['kind']!r}")


_AOT_MODEL_CLS = None


def _aot_model_class():
    """The AOTTPUModel class, built once on first load (the models pull
    in torch, which this module keeps out of import time)."""
    global _AOT_MODEL_CLS
    if _AOT_MODEL_CLS is not None:
        return _AOT_MODEL_CLS
    import threading
    from mmlspark_tpu_torch.models.tpu_model import TPUModel

    class AOTTPUModel(TPUModel):
        """TPUModel whose forward goes straight to the artifact's
        exported programs (by input signature). The model fn is NOT
        loaded — an unseen shape lazily unpickles it, runs it, and
        counts in ``jit_cache_misses``."""

        def _post_init(self):
            super()._post_init()
            self.aot = True
            self._aot_programs: Dict[Tuple, Callable] = {}
            self._artifact_dir: Optional[str] = None
            self._fallback_lock = threading.Lock()
            self._fallback_shapes: set = set()

        def _on_param_change(self, name: str) -> None:
            # the artifact's precision label stands while the model fn
            # is the placeholder (the programs carry the int8 products)
            if not (name == "precision"
                    and isinstance(self.get("modelFn"), _LazyModelFn)):
                super()._on_param_change(name)

        @property
        def jit_cache_misses(self) -> int:
            """Signatures the programs did not cover (the fallback)."""
            return len(self._fallback_shapes)

        def _fallback(self) -> Callable:
            # check-then-set under a lock: two workers meeting unseen
            # shapes at once unpickle once
            with self._fallback_lock:
                if isinstance(self.get("modelFn"), _LazyModelFn):
                    path = os.path.join(self._artifact_dir, _MODEL_FN)
                    if not os.path.exists(path):
                        raise RuntimeError(
                            "AOT artifact has no model_fn fallback and "
                            "this input shape was never exported")
                    self.set("modelFn",
                             _read_pickle(self._artifact_dir, _MODEL_FN))
            return self.get("modelFn")

        def _forward_fn(self) -> Callable:
            progs = self._aot_programs
            model = self

            def dispatch(weights, inputs):
                sig = input_signature(inputs)
                prog = progs.get(sig)
                if prog is not None:
                    return prog(weights, inputs)
                model._fallback_shapes.add(sig)
                return model._fallback()(weights, inputs)

            return dispatch

        def device_op(self, schema):
            self._fallback()
            return super().device_op(schema)

        def unload(self) -> None:
            """Release what the loaded model holds (the zoo's eviction
            hook): the device and host weights and the loaded programs
            with their constants. The model scores nothing afterwards;
            load the artifact again."""
            # cleared in place: a dispatch closure already handed out
            # holds this very dict
            self._aot_programs.clear()
            self._device_weights = None
            self._paramMap["weights"] = None

    _AOT_MODEL_CLS = AOTTPUModel
    return AOTTPUModel


def __getattr__(name: str):
    # ``from mmlspark_tpu_torch.serving.aot import AOTTPUModel`` builds
    # the class (it registers, so codegen's generated tests import it)
    if name == "AOTTPUModel":
        return _aot_model_class()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _model_kwargs(manifest: Dict[str, Any],
                  weights: Any) -> Dict[str, Any]:
    """The ONE manifest -> TPUModel constructor mapping, shared by
    ``load_model`` and the cold-start runner's trace-mode rebuild so
    the two replicas being compared are configured identically."""
    return dict(
        weights=weights, batchSize=manifest["batch_size"],
        computeDtype=manifest.get("compute_dtype", "float32"),
        feedDict=manifest.get("feeds"),
        fetchDict=manifest.get("fetches"),
        inputCol=manifest["serve"]["field"],
        outputCol=list(manifest["fetches"])[0],
        precision=manifest.get("precision", "f32"))


def _load_weights(art_dir: str):
    import torch
    return torch.load(os.path.join(art_dir, _WEIGHTS), weights_only=True)


def _load_tpu_model(art_dir: str, manifest: Dict[str, Any], dev):
    weights = _load_weights(art_dir)
    records = _read_pickle(art_dir, _PROGRAMS)
    model = _aot_model_class()(
        modelFn=_LazyModelFn(manifest.get("int_input", False),
                             manifest.get("vocab_size")),
        device=str(dev), **_model_kwargs(manifest, weights))
    model._artifact_dir = art_dir
    precision = manifest.get("precision", "f32")
    for rec in records:
        model._aot_programs[rec["key"]] = _load_program(rec["blob"],
                                                        precision)
    return model


def _load_pipeline(art_dir: str, manifest: Dict[str, Any], dev):
    from mmlspark_tpu_torch.core.fusion import FusedPipelineModel, FusedSegment
    meta = _read_pickle(art_dir, _PIPELINE)
    records = _read_pickle(art_dir, _PROGRAMS)
    fused = FusedPipelineModel(meta["stages"],
                               batch_size=manifest["batch_size"],
                               device=dev)
    plan = fused.plan_for(meta["in_schema"], meta["final_needed"])
    precision = manifest.get("precision", "f32")
    for rec in records:
        step = plan.steps[rec["step"]]
        if not isinstance(step, FusedSegment):
            raise RuntimeError(
                f"artifact step {rec['step']} is not a fused segment in "
                f"the rebuilt plan — stage list drifted")
        step.install_aot({rec["key"]: _load_program(rec["blob"],
                                                     precision)})
    fused.aot = True
    return fused


# ---------------------------------------------------------------------------
# cold-start runner (chip_smoke.py phase 16 and the tests drive this as a
# fresh process)
# ---------------------------------------------------------------------------


def _process_start(now: float) -> float:
    """The ``time.perf_counter()`` reading at this process's start: its
    age from the kernel's start time (``/proc/self/stat``, in clock
    ticks of boot time) taken off ``now``; ``now`` where that cannot be
    read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return now
    return now - max(0.0, age)


def _coldstart(art_dir: str, mode: str, port: int, t0: float,
               device: str, t_main: float) -> Dict[str, Any]:
    """Build a serving replica from the artifact and time process start
    -> first HTTP 200. ``mode='aot'`` loads the exported programs;
    ``mode='trace'`` rebuilds the model from weights + model fn (or the
    stage list) and warms every bucket eagerly — the replica the AOT
    path is measured against."""
    import urllib.request
    import torch
    from mmlspark_tpu_torch.device import resolve_device
    manifest = read_manifest(art_dir)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)          # the CUDA context
        torch.cuda.synchronize(dev)
    t_ctx = time.perf_counter()
    if mode == "aot":
        model = load_model(art_dir, device=device)
    elif manifest["kind"] == "pipeline":
        from mmlspark_tpu_torch.core.fusion import FusedPipelineModel
        meta = _read_pickle(art_dir, _PIPELINE)
        model = FusedPipelineModel(meta["stages"],
                                   batch_size=manifest["batch_size"],
                                   device=dev)
    else:
        from mmlspark_tpu_torch.models.tpu_model import TPUModel
        model = TPUModel(modelFn=_read_pickle(art_dir, _MODEL_FN),
                         device=str(dev),
                         **_model_kwargs(manifest, _load_weights(art_dir)))
    t_loaded = time.perf_counter()
    # the kernel libraries (aot mode adopted the artifact's copies; trace
    # mode loads the tree's build), then the weights to the device: the
    # warmup below is the first call of each bucket alone
    from mmlspark_tpu_torch import _build
    for lib in manifest.get("kernels", {}):
        _build.load(lib)
    t_kernels = time.perf_counter()
    if manifest["kind"] == "tpu_model":
        model._weights_on_device()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    t_weights = time.perf_counter()

    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.serving.fleet import json_scoring_pipeline
    from mmlspark_tpu_torch.serving.server import HTTPSource, ServingEngine
    kwargs = {} if manifest["kind"] == "pipeline" \
        else {"field": manifest["serve"]["field"]}
    stage = json_scoring_pipeline(model, **kwargs)
    # warm through the SERVING path (the swap protocol's warmup hook):
    # both modes run every bucket once; AOT mode through its programs
    example = _read_pickle(art_dir, _EXAMPLE)
    warmup = getattr(stage, "warmup", None)
    if callable(warmup):
        warmup(DataTable(dict(example))
               if manifest["kind"] == "pipeline" else example)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_ready = time.perf_counter()
    source = HTTPSource(port=port)
    engine = ServingEngine(source, stage, batch_size=64,
                           version=manifest.get("version", "v0"),
                           tracing=False).start()
    with open(os.path.join(art_dir, _EXAMPLE_REQUEST), "rb") as f:
        body = f.read()
    misses_before = int(model.jit_cache_misses)
    req = urllib.request.Request(source.address, data=body,
                                 headers={"Content-Type":
                                          "application/json"})
    t_serving = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            code = resp.status
            resp.read()
        t_200 = time.perf_counter()
    finally:
        engine.stop()
    request_traces = int(model.jit_cache_misses) - misses_before

    def ms(a, b):
        return round((b - a) * 1e3, 1)

    return {
        "mode": mode,
        "ok": code == 200,
        "cold_start_to_first_200_ms": ms(t0, t_200),
        "model_ready_ms": ms(t0, t_ready),
        "first_request_ms": ms(t_ready, t_200),
        "jit_traces_total": int(model.jit_cache_misses),
        "jit_traces_at_request_time": request_traces,
        "precision": manifest.get("precision", "f32"),
        "format": manifest.get("format"),
        "backend": dev.type,
        # where the window goes: interpreter start and imports, the CUDA
        # context, the artifact read (programs or model fn + weights),
        # the kernel libraries, the weights to the device, the first
        # call of each bucket, the engine's start, the request
        "phases_ms": {"imports": ms(t0, t_main),
                      "cuda_context": ms(t_main, t_ctx),
                      "load": ms(t_ctx, t_loaded),
                      "kernels": ms(t_loaded, t_kernels),
                      "weights_to_device": ms(t_kernels, t_weights),
                      "warmup": ms(t_weights, t_ready),
                      "engine_start": ms(t_ready, t_serving),
                      "request": ms(t_serving, t_200)},
    }


def main(argv: Optional[List[str]] = None) -> int:
    # the clock is the process's own start: interpreter start and every
    # import (torch, the package) land inside the window in BOTH modes
    t_main = time.perf_counter()
    t0 = _process_start(t_main)
    import argparse
    ap = argparse.ArgumentParser(
        description="AOT serving artifact cold-start runner")
    ap.add_argument("artifact", help="artifact directory (export_model)")
    ap.add_argument("--mode", choices=["aot", "trace"], default="aot")
    ap.add_argument("--port", type=int, default=18980)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)
    out = _coldstart(args.artifact, args.mode, args.port, t0, args.device,
                     t_main)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
