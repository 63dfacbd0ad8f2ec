"""Static checks of the port's fused device ops, serving ingress, shared-
memory transport, streamed paths, control loop and adaptive serving
plane: the torch counterpart of the JAX package's
``tools/check_fusion_kernels.py`` (``check_registered_kernels``,
``check_ingress_kernels``, ``check_shm_transport``, ``check_ooc_ingest``,
``check_control_loop`` and ``check_adaptive_serving``).

**No host round trip in a device op.** A fused segment promises that
everything between its upload and its single device-to-host copy stays
on the device. One ``.item()`` or ``.cpu()`` inside a registered op
``fn`` (``core.fusion.KERNEL_REGISTRY``, filled when ``device_op()``
builds a DeviceOp) turns the segment into a per-batch host sync while
every test still passes. The audit reads each registered function's
source and flags:

- ``np.*`` / ``numpy.*`` (host arrays inside device code);
- ``.cpu()``, ``.item()``, ``.numpy()``, ``.tolist()``, ``.to('cpu')``,
  ``.synchronize()``;
- ``float(x)`` / ``int(x)`` / ``bool(x)`` of a tensor, and an ``if`` /
  ``while`` / conditional expression / ``assert`` whose test reads a
  tensor's value. A name is a tensor when it is the op's ``consts`` or
  ``env`` argument or is assigned from an expression that reads one;
  shapes, ``ndim``, ``dtype``, ``device`` and ``len()`` are metadata,
  not values.

**Bounded memory on the streamed paths.** Nothing on a ``ChunkedTable``
hot path may buffer the whole stream — no ``.materialize()``, no
``to_numpy()`` / ``to_pylist()`` / ``toarray()`` / ``concat`` pulls, no
full-stream ``np.concatenate`` / ``vstack`` / ``hstack`` / ``stack``,
no ``list(...chunks...)`` — unless the line carries the acknowledgment
``# ooc:materialize-ok`` (chunk-local decode is the sanctioned case).

A line of a device op may be acknowledged with ``# fusion:host-ok``.

**No per-row Python in an ingress kernel** (``check_ingress_kernels``):
a function registered in ``io.columnar.INGRESS_REGISTRY`` may hold no
loop or comprehension and no ``.tolist()`` / ``.item()`` / ``map()``
unless the line carries ``# ingress:row-ok`` (per-column loops, the
string materialization passes).

**One staged copy on the shm path** (``check_shm_transport``): a
function registered in ``io.shm.SHM_REGISTRY`` (and the fleet's
``_post_columns_shm``) may call no ``.tobytes()`` / ``.tolist()`` /
``.copy()`` / ``bytes()`` without ``# shm:copy-ok``; every slot it
claims is released on its failure paths; the class that creates the
segment also unlinks and closes it.

**The control loop** (``check_control_loop``): every ``self.state``
write of ``serving/controlplane.py`` goes through ``_transition``, which
records its event; refit and shadow work is called only from the
trainer thread's functions; the engine's batcher, worker, execute and
supervisor loops never call into training.

**Adaptive serving** (``check_adaptive_serving``): no variant selection
in the HTTP handler, no ``variants.tick`` off the batcher thread, and no
rotation removal or process stop in the autoscaler outside its drain
funnel (the rules above ``check_adaptive_serving_source``).

Run from the repository root::

    python -m mmlspark_tpu_torch.testing.fusion_check

It builds one fitted pipeline of every fusable stage family on the CPU,
audits the registered ops, the ingress kernels, the shm hot paths, the
streamed paths, the control loop and the adaptive serving sources, and
exits 1 with the violations listed when one is found.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import os
import sys
import textwrap
from typing import Iterable, List, Set, Tuple

_HOST_MARK = "# fusion:host-ok"
_FORBIDDEN_ROOTS = {"np", "numpy"}
_FORBIDDEN_ATTRS = {"cpu", "item", "numpy", "tolist", "to_py",
                    "synchronize"}
# metadata of a tensor: reading these is not reading its values
_META_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda",
               "size", "numel", "dim", "element_size"}
_CASTS = {"float", "int", "bool"}


def _sources(codes: Iterable[Tuple[object, str]]
             ) -> List[Tuple[str, str, int, List[str]]]:
    """(name, dedented source, first line, raw lines) per code object,
    one entry per distinct function definition."""
    out = []
    seen = set()
    for code, name in codes:
        key = (code.co_filename, code.co_firstlineno)
        if key in seen:
            continue
        seen.add(key)
        try:
            lines, first = inspect.getsourcelines(code)
        except OSError:
            continue   # built at run time (tests); nothing to audit
        out.append((name, textwrap.dedent("".join(lines)), first, lines))
    return out


def _reads_value(node: ast.AST, tainted: Set[str]) -> bool:
    """Whether ``node`` reads the value of a tainted (tensor) name:
    metadata reads (``x.shape``, ``len(x)``, ``isinstance``) do not
    count."""
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Attribute) and node.attr in _META_ATTRS:
        return False
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in _META_ATTRS:
        return False
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("len", "isinstance", "range"):
        return False
    return any(_reads_value(c, tainted) for c in ast.iter_child_nodes(node))


def _targets(node: ast.AST) -> List[str]:
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [n for e in node.elts for n in _targets(e)]
    return []


def _tainted_names(fn: ast.AST) -> Set[str]:
    """The op's ``consts`` / ``env`` arguments (its first two) and every
    name assigned, in any statement of the function, from an expression
    that reads one of them; iterated to a fixed point."""
    args = fn.args.args if isinstance(fn, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)) else []
    tainted = {a.arg for a in args[:2]}
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            pairs = []
            if isinstance(node, ast.Assign):
                pairs = [(t, node.value) for t in node.targets]
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) \
                    and node.value is not None:
                pairs = [(node.target, node.value)]
            elif isinstance(node, (ast.For, ast.comprehension)):
                pairs = [(node.target, node.iter)]
            elif isinstance(node, ast.withitem) \
                    and node.optional_vars is not None:
                pairs = [(node.optional_vars, node.context_expr)]
            for target, value in pairs:
                if _reads_value(value, tainted):
                    for name in _targets(target):
                        if name not in tainted:
                            tainted.add(name)
                            changed = True
    return tainted


def check_op_source(name: str, src: str, first: int,
                    lines: List[str]) -> List[str]:
    """The no-host-round-trip audit of ONE device-op function source."""
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return [f"{name}: unparseable device-op source"]
    fns = [n for n in tree.body
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    tainted = _tainted_names(fns[0]) if fns else set()
    violations: List[str] = []

    def flag(node: ast.AST, what: str) -> None:
        idx = node.lineno - 1
        if 0 <= idx < len(lines) and _HOST_MARK in lines[idx]:
            return
        violations.append(
            f"{name} (line {first + node.lineno - 1}): {what} inside a "
            f"fused device op")

    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            root = node.value
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name) and root.id in _FORBIDDEN_ROOTS:
                flag(node, f"host array construct '{root.id}.{node.attr}'")
            elif node.attr in _FORBIDDEN_ATTRS:
                flag(node, f"device-to-host call '.{node.attr}'")
        elif isinstance(node, ast.Name) and node.id in _FORBIDDEN_ROOTS:
            flag(node, f"host array module '{node.id}'")
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr == "to":
                vals = list(node.args) + [k.value for k in node.keywords]
                if any(isinstance(v, ast.Constant) and v.value == "cpu"
                       for v in vals):
                    flag(node, "device-to-host copy '.to(\"cpu\")'")
            if isinstance(func, ast.Name) and func.id in _CASTS \
                    and any(_reads_value(a, tainted) for a in node.args):
                flag(node, f"host read of a tensor value '{func.id}()'")
        if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)) \
                and _reads_value(node.test, tainted):
            flag(node, "branch on a tensor's value")
    return violations


def check_registered_kernels() -> List[str]:
    """All violations across the registered device ops (empty = clean)."""
    from mmlspark_tpu_torch.core.fusion import KERNEL_REGISTRY
    violations: List[str] = []
    for name, src, first, lines in _sources(list(KERNEL_REGISTRY.items())):
        violations.extend(check_op_source(name, src, first, lines))
    return violations


def register_known_callees() -> int:
    """Register the functions the device ops CALL (the audit's
    transitive reach): the forest walk, every GBDT objective's
    ``transform`` and the int8 product. The op functions are closures
    built by ``device_op()``; a host sync could hide in these callees.
    A TPUModel's ``modelFn`` is the user's code and out of scope."""
    from mmlspark_tpu_torch.core import quantize as QZ
    from mmlspark_tpu_torch.core.fusion import register_kernel
    from mmlspark_tpu_torch.gbdt import objectives as OBJ
    from mmlspark_tpu_torch.gbdt import tree as TREE
    register_kernel(TREE.predict_trees, "gbdt.tree.predict_trees")
    count = 1

    def subclasses(cls):
        for sub in cls.__subclasses__():
            yield sub
            yield from subclasses(sub)

    for cls in {OBJ.Objective, *subclasses(OBJ.Objective)}:
        fn = cls.__dict__.get("transform")
        if fn is not None:
            register_kernel(fn, f"gbdt.objectives.{cls.__name__}.transform")
            count += 1
    for fn in (QZ.int8_matmul, QZ.quantize_act):
        register_kernel(fn, f"quantize.{fn.__name__}")
        count += 1
    return count


def register_representative_pipelines() -> int:
    """Build one fitted pipeline of every fusable stage family on the
    CPU and plan it (and one chunked pass), so KERNEL_REGISTRY holds
    every shipped device op. Returns the number of registered code
    objects."""
    import numpy as np
    from mmlspark_tpu_torch.automl.featurize import Featurize
    from mmlspark_tpu_torch.core.fusion import KERNEL_REGISTRY, fuse
    from mmlspark_tpu_torch.core.stage import Pipeline, PipelineModel
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.gbdt.estimators import (
        TPUBoostClassifier, TPUBoostRegressor,
    )
    from mmlspark_tpu_torch.io.ooc import ChunkedTable
    from mmlspark_tpu_torch.models.linear import (
        TPULinearRegression, TPULogisticRegression,
    )
    from mmlspark_tpu_torch.models.tpu_model import TPUModel
    from mmlspark_tpu_torch.stages.dataprep import (
        CleanMissingData, FastVectorAssembler, StandardScaler,
        ValueIndexer,
    )

    rng = np.random.default_rng(0)
    n = 64
    table = DataTable({
        "a": rng.normal(size=n).astype(np.float32),
        "b": np.where(rng.random(n) < 0.2, np.nan, rng.normal(size=n)),
        "cat": [f"l{int(i)}" for i in rng.integers(0, 4, n)],
        "toks": [[f"w{int(t)}" for t in rng.integers(0, 9, 3)]
                 for _ in range(n)],
        "label": rng.integers(0, 2, n).astype(np.float64),
    })
    pm = Pipeline(stages=[
        CleanMissingData(inputCols=["b"], outputCols=["b"]),
        ValueIndexer(inputCol="cat", outputCol="cat_ix"),
        Featurize(featureColumns=["a", "b", "toks"], numberOfFeatures=8),
        FastVectorAssembler(inputCols=["features", "cat_ix"],
                            outputCol="fv"),
        StandardScaler(inputCol="fv", outputCol="fv"),
        TPULogisticRegression(featuresCol="fv", labelCol="label",
                              maxIter=3, device="cpu"),
    ]).fit(table)
    fuse(pm, device="cpu").plan_for(table.schema)
    # the chunked path runs the SAME registered ops
    for _ in fuse(pm, device="cpu").transform_chunked(
            ChunkedTable.from_table(table.drop("label"), chunk_rows=32)):
        pass
    lin = Pipeline(stages=[
        FastVectorAssembler(inputCols=["a"], outputCol="fv2"),
        TPULinearRegression(featuresCol="fv2", labelCol="label",
                            maxIter=3, device="cpu")]).fit(table)
    fuse(lin, device="cpu").plan_for(table.schema)
    for est in (TPUBoostClassifier, TPUBoostRegressor):
        gb = Pipeline(stages=[
            FastVectorAssembler(inputCols=["a", "b"], outputCol="fv3"),
            est(featuresCol="fv3", labelCol="label", numIterations=2,
                numLeaves=4, minDataInLeaf=2, device="cpu"),
        ]).fit(table)
        fuse(gb, device="cpu").plan_for(table.schema)
    tm = TPUModel.from_fn(
        lambda w, ins: list(ins.values())[0] @ w["W"],
        {"W": np.eye(1, dtype=np.float32)}, inputCol="a",
        outputCol="scores")
    fuse(PipelineModel(stages=[tm]), device="cpu").plan_for(table.schema)
    return len(KERNEL_REGISTRY)


# ---------------------------------------------------------------------------
# out-of-core ingest hot paths
# ---------------------------------------------------------------------------

_OOC_MARK = "# ooc:materialize-ok"
_OOC_ATTR_CALLS = {"materialize", "to_numpy", "to_pylist", "toarray",
                   "concat"}
_OOC_NP_CALLS = {"concatenate", "vstack", "hstack", "stack"}

# (dotted module, qualname) of every audited hot-path function
OOC_HOT_PATHS = (
    ("mmlspark_tpu_torch.io.ooc", "ChunkedTable._instrumented"),
    ("mmlspark_tpu_torch.io.ooc", "ChunkedTable.chunks"),
    ("mmlspark_tpu_torch.io.ooc", "ChunkedTable.map"),
    ("mmlspark_tpu_torch.io.ooc", "ChunkedTable.as_xy"),
    ("mmlspark_tpu_torch.io.ooc", "ChunkedTable.materialize"),
    ("mmlspark_tpu_torch.io.ooc", "_record_batch_to_table"),
    ("mmlspark_tpu_torch.core.fusion", "FusionPlan.execute_chunked"),
    ("mmlspark_tpu_torch.core.fusion",
     "FusedPipelineModel.transform_chunked"),
    ("mmlspark_tpu_torch.gbdt.binning", "BinMapper.fit_streaming"),
    ("mmlspark_tpu_torch.gbdt.sketch", "QuantileSketch.update"),
    ("mmlspark_tpu_torch.gbdt.sketch", "QuantileSketch._flush"),
    ("mmlspark_tpu_torch.gbdt.sketch", "QuantileSketch.summary"),
    ("mmlspark_tpu_torch.automl.featurize", "Featurize._fit_streaming"),
    ("mmlspark_tpu_torch.stages.dataprep",
     "StandardScaler._fit_streaming"),
    ("mmlspark_tpu_torch.stages.dataprep",
     "SummarizeData._transform_chunked"),
    ("mmlspark_tpu_torch.models.learner", "TPULearner._host_feed"),
)


def _resolve_qualname(module: str, qualname: str):
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def check_ooc_source(name: str, src: str, first: int,
                     lines: List[str]) -> List[str]:
    """No-materialize audit of ONE chunked hot-path function."""
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return [f"{name}: unparseable ooc hot-path source"]
    violations: List[str] = []

    def line_ok(lineno: int) -> bool:
        idx = lineno - 1
        return 0 <= idx < len(lines) and _OOC_MARK in lines[idx]

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        bad = None
        func = node.func
        if isinstance(func, ast.Attribute):
            if func.attr in _OOC_ATTR_CALLS:
                bad = f"materializing call '.{func.attr}()'"
            elif func.attr in _OOC_NP_CALLS and \
                    isinstance(func.value, ast.Name) and \
                    func.value.id in ("np", "numpy"):
                bad = f"full-stream 'np.{func.attr}()'"
        elif isinstance(func, ast.Name) and func.id == "list" \
                and node.args:
            # list(...chunks...) would buffer the whole stream; other
            # list() uses (schema names, dict keys) are fine
            arg = node.args[0]
            chunky = (isinstance(arg, ast.Call)
                      and isinstance(arg.func, ast.Attribute)
                      and arg.func.attr == "chunks") or (
                isinstance(arg, ast.Name) and "chunk" in arg.id)
            if chunky:
                bad = "stream buffering 'list()'"
        if bad is not None and not line_ok(node.lineno):
            violations.append(
                f"{name} (line {first + node.lineno - 1}): {bad} on a "
                f"ChunkedTable hot path (chunk-local use is "
                f"acknowledged with '{_OOC_MARK}')")
    return violations


def check_ooc_ingest() -> List[str]:
    """The no-materialize audit across every registered chunked hot
    path (empty = clean)."""
    violations: List[str] = []
    for module, qualname in OOC_HOT_PATHS:
        try:
            fn = _resolve_qualname(module, qualname)
        except (ImportError, AttributeError) as e:
            violations.append(f"{module}.{qualname}: unresolvable ({e})")
            continue
        fn = inspect.unwrap(fn)
        try:
            lines, first = inspect.getsourcelines(fn)
        except OSError as e:
            violations.append(
                f"{module}.{qualname}: unreadable source ({e})")
            continue
        violations.extend(check_ooc_source(
            f"{module}.{qualname}",
            textwrap.dedent("".join(lines)), first, lines))
    return violations


# ingress decode kernels (io/columnar.py INGRESS_REGISTRY) promise NO
# per-row Python iteration and NO per-element boxing between the socket
# and the device upload: loops/comprehensions and per-element materializers
# are forbidden unless the line carries the explicit acknowledgment
# (per-COLUMN loops and the documented string passes)
_INGRESS_MARK = "# ingress:row-ok"
_INGRESS_ATTRS = {"tolist", "item", "to_py"}


# ---------------------------------------------------------------------------
# ingress decode kernels (columnar serving ingress — io/columnar.py)
# ---------------------------------------------------------------------------


def _ingress_sources() -> List[Tuple[str, str, int, List[str]]]:
    from mmlspark_tpu_torch.io.columnar import INGRESS_REGISTRY
    out = []
    seen = set()
    for code, name in INGRESS_REGISTRY.items():
        key = (code.co_filename, code.co_firstlineno)
        if key in seen:
            continue
        seen.add(key)
        try:
            lines, first = inspect.getsourcelines(code)
        except OSError:
            continue   # dynamically built (tests); nothing to audit
        out.append((name, textwrap.dedent("".join(lines)), first, lines))
    return out


_LOOP_NODES = (ast.For, ast.While, ast.ListComp, ast.SetComp,
               ast.DictComp, ast.GeneratorExp)


def check_ingress_source(name: str, src: str, first: int,
                          lines: List[str]) -> List[str]:
    """Per-row iteration / per-element boxing audit of ONE registered
    ingress decode kernel. Any loop or comprehension must carry the
    ``# ingress:row-ok`` acknowledgment on its first line (per-column
    loops and the documented string-materialization passes); so must
    ``.tolist()``/``.item()`` and ``map()`` calls."""
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return [f"{name}: unparseable ingress kernel source"]
    violations: List[str] = []

    def line_ok(lineno: int) -> bool:
        idx = lineno - 1
        if 0 <= idx < len(lines):
            return _INGRESS_MARK in lines[idx]
        return False

    for node in ast.walk(tree):
        bad = None
        if isinstance(node, _LOOP_NODES):
            bad = ("per-row Python iteration "
                   f"({type(node).__name__.lower()})")
        elif isinstance(node, ast.Attribute) and \
                node.attr in _INGRESS_ATTRS:
            bad = f"per-element boxing '.{node.attr}'"
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and node.func.id == "map":
            bad = "per-element boxing 'map()'"
        if bad is not None and not line_ok(node.lineno):
            violations.append(
                f"{name} (line {first + node.lineno - 1}): {bad} inside "
                f"a registered ingress decode kernel (acknowledge a "
                f"per-column loop with '{_INGRESS_MARK}')")
    return violations


def check_ingress_kernels() -> List[str]:
    """All per-row-iteration violations across registered ingress
    decode kernels (empty = clean)."""
    violations: List[str] = []
    for name, src, first, lines in _ingress_sources():
        violations.extend(check_ingress_source(name, src, first, lines))
    return violations


# ---------------------------------------------------------------------------
# shared-memory transport hot paths (io/shm.py + the fleet client rung)
# ---------------------------------------------------------------------------

# the shm promise: ONE staged copy per numeric column (np.copyto into
# the segment), zero body bytes. Any other materialization on a
# registered shm hot path — ``.tobytes()``, ``.tolist()``, ``.copy()``,
# a ``bytes(...)`` call — must carry the explicit acknowledgment (the
# string-column contract and the ~150-byte control message are the
# sanctioned cases).
_SHM_MARK = "# shm:copy-ok"
_SHM_COPY_ATTRS = {"tobytes", "tolist", "copy"}

# additional shm hot paths living outside io/shm.py (the fleet client's
# write->post->release rung), audited by (module, qualname)
_SHM_EXTRA_PATHS = (
    ("mmlspark_tpu_torch.serving.fleet", "ServingFleet._post_columns_shm"),
)

# segment owners: every ``SharedMemory(create=True)`` class must also
# hold the matching ``.unlink(`` and ``.close(`` teardown
_SHM_SEGMENT_OWNERS = (
    ("mmlspark_tpu_torch.io.shm", "ShmRing"),
)


def _shm_sources() -> List[Tuple[str, str, int, List[str]]]:
    from mmlspark_tpu_torch.io.shm import SHM_REGISTRY
    out = []
    seen = set()
    for code, name in SHM_REGISTRY.items():
        key = (code.co_filename, code.co_firstlineno)
        if key in seen:
            continue
        seen.add(key)
        try:
            lines, first = inspect.getsourcelines(code)
        except OSError:
            continue   # dynamically built (tests); nothing to audit
        out.append((name, textwrap.dedent("".join(lines)), first, lines))
    for module, qualname in _SHM_EXTRA_PATHS:
        fn = _resolve_qualname(module, qualname)
        if fn is None:
            out.append((f"{module}.{qualname}", "", 0, []))
            continue
        lines, first = inspect.getsourcelines(fn)
        out.append((f"{module}.{qualname}",
                    textwrap.dedent("".join(lines)), first, lines))
    return out


def _check_shm_copy_source(name: str, src: str, first: int,
                           lines: List[str]) -> List[str]:
    """Unacknowledged-copy audit of ONE registered shm hot path:
    ``.tobytes()``/``.tolist()``/``.copy()`` attribute access and
    ``bytes(...)`` calls need ``# shm:copy-ok`` on their line.
    (``np.copyto`` is the ONE intended staged copy — allowed.)"""
    if not src:
        return [f"{name}: shm hot path is missing / unresolvable"]
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return [f"{name}: unparseable shm hot-path source"]
    violations: List[str] = []

    def line_ok(lineno: int) -> bool:
        idx = lineno - 1
        if 0 <= idx < len(lines):
            return _SHM_MARK in lines[idx]
        return False

    for node in ast.walk(tree):
        bad = None
        if isinstance(node, ast.Attribute) and \
                node.attr in _SHM_COPY_ATTRS:
            bad = f"unacknowledged copy '.{node.attr}'"
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id == "bytes":
            bad = "unacknowledged copy 'bytes()'"
        if bad is not None and not line_ok(node.lineno):
            violations.append(
                f"{name} (line {first + node.lineno - 1}): {bad} on a "
                f"registered shm hot path (acknowledge a sanctioned "
                f"materialization with '{_SHM_MARK}')")
    return violations


def _is_slot_acquire(node: ast.Call) -> bool:
    """A slot acquire: ``*._claim_slot(...)`` or ``ring.write(...)``
    (the fleet rung's token-producing call)."""
    f = node.func
    if not isinstance(f, ast.Attribute):
        return False
    if f.attr == "_claim_slot":
        return True
    return (f.attr == "write" and isinstance(f.value, ast.Name)
            and f.value.id == "ring")


def _has_protected_release(fn) -> bool:
    """Does ``fn`` release a slot on its failure paths — a
    ``.release(...)`` call inside a ``finally`` block or an ``except``
    handler?"""
    for t in ast.walk(fn):
        if not isinstance(t, ast.Try):
            continue
        bodies = list(t.finalbody)
        for h in t.handlers:
            bodies.extend(h.body)
        for stmt in bodies:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Call) and \
                        isinstance(n.func, ast.Attribute) and \
                        n.func.attr == "release":
                    return True
    return False


def check_shm_source(name: str, src: str, first: int,
                     lines: List[str]) -> List[str]:
    """Both shm audits (unacknowledged copies, slot pairing) over ONE
    hot-path source."""
    return (_check_shm_copy_source(name, src, first, lines)
            + _check_shm_pairing(name, src, first, lines))


def _check_shm_pairing(name: str, src: str, first: int,
                       lines: List[str]) -> List[str]:
    """Acquire/release pairing audit: any function on a registered shm
    hot path that claims a ring slot must release it on every failure
    path (a ``.release(`` inside ``finally`` or an ``except`` handler;
    the success path may hand the token to the caller by contract)."""
    if not src:
        return []   # the missing-source violation already fired
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return []
    violations: List[str] = []
    fns = [n for n in ast.walk(tree)
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for fn in fns or [tree]:
        acquires = [n for n in ast.walk(fn)
                    if isinstance(n, ast.Call) and _is_slot_acquire(n)]
        if acquires and not _has_protected_release(fn):
            violations.append(
                f"{name} (line {first + acquires[0].lineno - 1}): slot "
                f"acquire without a '.release(' on the failure paths "
                f"(finally / except handler) — a raised exception "
                f"leaks the slot")
    return violations


def check_shm_transport() -> List[str]:
    """The shared-memory transport audit: no unacknowledged copies on
    registered shm hot paths, every slot acquire released on failure
    paths, and every created segment unlinked (empty = clean)."""
    violations: List[str] = []
    for name, src, first, lines in _shm_sources():
        violations.extend(check_shm_source(name, src, first, lines))
    for module, qualname in _SHM_SEGMENT_OWNERS:
        obj = _resolve_qualname(module, qualname)
        if obj is None:
            violations.append(
                f"{module}.{qualname}: segment owner is missing")
            continue
        src = textwrap.dedent("".join(inspect.getsourcelines(obj)[0]))
        if "create=True" in src:
            for needed in (".unlink(", ".close("):
                if needed not in src:
                    violations.append(
                        f"{module}.{qualname}: creates a SharedMemory "
                        f"segment but never calls '{needed}' — a "
                        f"leaked /dev/shm file outlives the process")
    return violations



# ---------------------------------------------------------------------------
# continuous-training control loop (serving/controlplane.py)
# ---------------------------------------------------------------------------

# The control-loop discipline, statically enforced:
#   1. every `self.state` write happens inside the `_transition` funnel
#      (or `__init__`, the pre-loop initial value) — so no state change
#      can skip the timeline;
#   2. `_transition` calls `_record`, and `_record` calls
#      `record_event` — so the funnel actually lands the event on the
#      registry timeline;
#   3. refit/validation work (`refit`/`partial_fit`/`boost_more`/
#      `_run_refit`/`_shadow_and_gate`) is invoked ONLY from the
#      registered trainer-thread callsites;
#   4. the serving hot-path loops (batcher/worker/execute/supervisor)
#      never call into refit/validation — training on the request path
#      is the failure mode the dedicated trainer thread exists to
#      prevent.
_CONTROL_STATE_FUNNEL = "_transition"
_CONTROL_RECORDER = "_record"
_CONTROL_STATE_WRITERS = frozenset({_CONTROL_STATE_FUNNEL, "__init__"})
_REFIT_CALL_NAMES = frozenset({
    "refit", "partial_fit", "boost_more", "_run_refit",
    "_shadow_and_gate",
})
# trainer-thread callsites allowed to invoke refit/validation work
_TRAINER_ALLOWLIST = frozenset({
    "_cycle", "_run_refit", "_shadow_and_gate",
})
# serving hot-path functions that must stay training-free (the
# forbidden set adds the cycle entrypoint + fit: a hot loop must not
# even *start* a training cycle synchronously)
_SERVING_HOT_LOOPS = (
    ("mmlspark_tpu_torch.serving.server", "ServingEngine._batcher_loop"),
    ("mmlspark_tpu_torch.serving.server", "ServingEngine._worker_loop"),
    ("mmlspark_tpu_torch.serving.server", "ServingEngine._execute_batch"),
    ("mmlspark_tpu_torch.serving.server", "ServingEngine._supervise"),
)
_SERVING_FORBIDDEN = _REFIT_CALL_NAMES | {"_cycle", "fit"}


def check_control_loop_source(src: str, first: int = 1,
                              name: str = "serving/controlplane.py",
                              ) -> List[str]:
    """The control-loop discipline audit over ONE module source (rules
    1-3 above). Exposed at source level so the tier-1 tests can feed it
    positive and negative examples."""
    try:
        tree = ast.parse(textwrap.dedent(src))
    except SyntaxError:
        return [f"{name}: unparseable control-loop source"]
    violations: List[str] = []
    record_calls_in: dict = {}    # func name -> set of callee names
    for owner, node in _walk_with_owner(tree):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute) and t.attr == "state" \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self" \
                        and owner not in _CONTROL_STATE_WRITERS:
                    violations.append(
                        f"{name} (line {first + node.lineno - 1}): "
                        f"'self.state' written in {owner!r} — every "
                        f"loop state change must go through "
                        f"{_CONTROL_STATE_FUNNEL!r} so its timeline "
                        f"event is recorded")
        if isinstance(node, ast.Call):
            callee = _call_name(node.func)
            record_calls_in.setdefault(owner, set()).add(callee)
            if callee in _REFIT_CALL_NAMES and \
                    owner not in _TRAINER_ALLOWLIST:
                violations.append(
                    f"{name} (line {first + node.lineno - 1}): "
                    f"refit/validation call {callee!r} from "
                    f"{owner!r} — training work runs only on the "
                    f"trainer thread (allowlist: "
                    f"{sorted(_TRAINER_ALLOWLIST)})")
    funnel_calls = record_calls_in.get(_CONTROL_STATE_FUNNEL, set())
    if _CONTROL_RECORDER not in funnel_calls and \
            "record_event" not in funnel_calls:
        violations.append(
            f"{name}: {_CONTROL_STATE_FUNNEL!r} no longer records its "
            f"event ({_CONTROL_RECORDER!r}/'record_event' not called) "
            f"— transitions would vanish from the registry timeline")
    recorder_calls = record_calls_in.get(_CONTROL_RECORDER, set())
    if recorder_calls and "record_event" not in recorder_calls:
        violations.append(
            f"{name}: {_CONTROL_RECORDER!r} does not call "
            f"'record_event' — events never reach the registry")
    return violations


def check_control_loop() -> List[str]:
    """Rules 1-3 over the real serving/controlplane.py, plus rule 4
    over the engine's serving hot loops (empty = clean)."""
    mod = importlib.import_module("mmlspark_tpu_torch.serving.controlplane")
    src = inspect.getsource(mod)
    violations = check_control_loop_source(src)
    for module, qualname in _SERVING_HOT_LOOPS:
        try:
            fn = _resolve_qualname(module, qualname)
        except (ImportError, AttributeError) as e:
            violations.append(f"{module}.{qualname}: unresolvable "
                              f"({e}) — update _SERVING_HOT_LOOPS")
            continue
        fn = inspect.unwrap(fn)
        try:
            lines, fl = inspect.getsourcelines(fn)
        except OSError as e:
            violations.append(
                f"{module}.{qualname}: unreadable source ({e})")
            continue
        try:
            tree = ast.parse(textwrap.dedent("".join(lines)))
        except SyntaxError:
            violations.append(
                f"{module}.{qualname}: unparseable hot-loop source")
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                callee = _call_name(node.func)
                if callee in _SERVING_FORBIDDEN:
                    violations.append(
                        f"{module}.{qualname} (line "
                        f"{fl + node.lineno - 1}): refit/validation "
                        f"call {callee!r} on a serving hot loop — "
                        f"training must never run on batcher/worker "
                        f"threads")
    return violations



# ---------------------------------------------------------------------------
# SLO-adaptive serving (serving/variants.py + serving/autoscale.py)
# ---------------------------------------------------------------------------

# The adaptive-serving discipline, the JAX package's
# ``tools/check_fusion_kernels.py::check_adaptive_serving`` over the
# port's sources:
#
# 1. Variant SELECTION never runs on the HTTP handler. The nested
#    ``Handler`` class in serving/server.py must not touch the
#    ``variants`` attribute at all — /healthz reads the selector
#    through the engine's metrics probe, and routing/deciding happen
#    on the batcher thread only: ``variants.tick`` solely in
#    ``_batcher_loop`` (the rate-gated decision point),
#    ``variants.route`` solely in ``_ingest`` (admission), and
#    ``variants.observe`` solely in ``_execute_batch`` (the latency
#    feed).
# 2. Autoscaler scale-down goes ONLY through the drain path:
#    ``fleet.remove_engine`` is called nowhere but
#    ``_drain_and_stop`` (rotation removal precedes process stop),
#    ``_stop_proc`` is reachable only from ``_drain_and_stop`` and
#    the ``_scale_up`` join-failure cleanup (a process that never
#    entered the rotation), and raw ``terminate``/``kill`` live only
#    inside ``_stop_proc``.

def _call_name(func) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _walk_with_owner(tree):
    """Yield (innermost_function_name, node) over the tree."""
    stack: List[str] = []

    def visit(node):
        is_fn = isinstance(node, (ast.FunctionDef,
                                  ast.AsyncFunctionDef))
        if is_fn:
            stack.append(node.name)
        owner = stack[-1] if stack else "<module>"
        yield owner, node
        for child in ast.iter_child_nodes(node):
            yield from visit(child)
        if is_fn:
            stack.pop()

    yield from visit(tree)



_ADAPTIVE_HANDLER_CLASS = "Handler"
_VARIANT_CALL_OWNERS = {
    "tick": {"_batcher_loop"},
    "route": {"_ingest"},
    "observe": {"_execute_batch"},
}
_AUTOSCALE_REMOVE_OWNERS = {"_drain_and_stop"}
_AUTOSCALE_STOP_OWNERS = {"_drain_and_stop", "_scale_up"}
_AUTOSCALE_KILL_OWNERS = {"_stop_proc"}


def _is_variants_method(func) -> bool:
    """``<anything>.variants.<method>(...)`` — the selector surface."""
    return (isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Attribute)
            and func.value.attr == "variants")


def check_adaptive_serving_source(server_src: str, autoscale_src: str,
                                  ) -> List[str]:
    """The adaptive-serving audit over both module sources (rules 1-2
    above). Source-level so the tier-1 tests can feed it positive and
    negative examples."""
    violations: List[str] = []
    try:
        server_tree = ast.parse(textwrap.dedent(server_src))
    except SyntaxError:
        return ["serving/server.py: unparseable source"]
    # rule 1a: the HTTP handler class never touches the variant plane
    for node in ast.walk(server_tree):
        if isinstance(node, ast.ClassDef) and \
                node.name == _ADAPTIVE_HANDLER_CLASS:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Attribute) and \
                        sub.attr == "variants":
                    violations.append(
                        f"serving/server.py (line {sub.lineno}): the "
                        f"HTTP handler touches '.variants' — variant "
                        f"selection/reads belong on the batcher "
                        f"thread; /healthz reads the selector via the "
                        f"engine metrics probe")
    # rule 1b: each selector call lands only on its designated owner
    seen_tick = False
    for owner, node in _walk_with_owner(server_tree):
        if isinstance(node, ast.Call) and \
                _is_variants_method(node.func):
            method = node.func.attr
            allowed = _VARIANT_CALL_OWNERS.get(method)
            if method == "tick":
                seen_tick = True
            if allowed is not None and owner not in allowed:
                violations.append(
                    f"serving/server.py (line {node.lineno}): "
                    f"variants.{method} called from {owner!r} — "
                    f"allowed only in {sorted(allowed)} (selection "
                    f"never runs per-request)")
    if not seen_tick:
        violations.append(
            "serving/server.py: no variants.tick call found in "
            "'_batcher_loop' — the selector's decision point moved; "
            "update check_adaptive_serving_source")
    try:
        auto_tree = ast.parse(textwrap.dedent(autoscale_src))
    except SyntaxError:
        return violations + ["serving/autoscale.py: unparseable source"]
    # rule 2: scale-down only through the drain funnel
    drain_seen = False
    for owner, node in _walk_with_owner(auto_tree):
        if not isinstance(node, ast.Call):
            continue
        callee = _call_name(node.func)
        if callee == "remove_engine":
            drain_seen = True
            if owner not in _AUTOSCALE_REMOVE_OWNERS:
                violations.append(
                    f"serving/autoscale.py (line {node.lineno}): "
                    f"remove_engine called from {owner!r} — engines "
                    f"leave the rotation only inside "
                    f"{sorted(_AUTOSCALE_REMOVE_OWNERS)} (drain "
                    f"before retire)")
        elif callee == "_stop_proc":
            if owner not in _AUTOSCALE_STOP_OWNERS:
                violations.append(
                    f"serving/autoscale.py (line {node.lineno}): "
                    f"_stop_proc called from {owner!r} — processes "
                    f"stop only from {sorted(_AUTOSCALE_STOP_OWNERS)}")
        elif callee in ("terminate", "kill"):
            if owner not in _AUTOSCALE_KILL_OWNERS:
                violations.append(
                    f"serving/autoscale.py (line {node.lineno}): "
                    f"raw {callee} call from {owner!r} — only "
                    f"{sorted(_AUTOSCALE_KILL_OWNERS)} touches the "
                    f"process handle")
    if not drain_seen:
        violations.append(
            "serving/autoscale.py: no remove_engine call found in "
            "'_drain_and_stop' — the drain funnel moved; update "
            "check_adaptive_serving_source")
    return violations


def check_adaptive_serving() -> List[str]:
    """Rules 1-2 over the port's serving/server.py and
    serving/autoscale.py."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    srcs = []
    for rel in ("serving/server.py", "serving/autoscale.py"):
        try:
            with open(os.path.join(root, rel)) as f:
                srcs.append(f.read())
        except OSError as e:
            return [f"{rel}: unreadable ({e})"]
    return check_adaptive_serving_source(*srcs)


def main() -> int:
    n = register_representative_pipelines() + register_known_callees()
    from mmlspark_tpu_torch.io.columnar import INGRESS_REGISTRY
    from mmlspark_tpu_torch.io.shm import SHM_REGISTRY
    violations = (check_registered_kernels() + check_ingress_kernels()
                  + check_shm_transport() + check_ooc_ingest()
                  + check_control_loop() + check_adaptive_serving())
    for v in violations:
        print(v)
    print(f"{n} device-op code objects registered; "
          f"{len(INGRESS_REGISTRY)} ingress kernels and "
          f"{len(SHM_REGISTRY)} shm hot paths audited; "
          f"{len(OOC_HOT_PATHS)} streamed hot paths audited; control "
          f"loop and {len(_SERVING_HOT_LOOPS)} serving hot loops "
          f"audited; adaptive serving audited; {len(violations)} "
          f"violations")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
