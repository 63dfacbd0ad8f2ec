"""Static checks of the port's fused device ops, streamed paths and
adaptive serving plane: the torch counterpart of the JAX package's
``tools/check_fusion_kernels.py`` (``check_registered_kernels``,
``check_ooc_ingest`` and ``check_adaptive_serving``).

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

**Adaptive serving** (``check_adaptive_serving``): no variant selection
in the HTTP handler, no ``variants.tick`` off the batcher thread, and no
rotation removal or process stop in the autoscaler outside its drain
funnel (the rules above ``check_adaptive_serving_source``).

Run from the repository root::

    python -m mmlspark_tpu_torch.testing.fusion_check

It builds one fitted pipeline of every fusable stage family on the CPU,
audits the registered ops, the streamed paths and the adaptive serving
sources, and exits 1 with the violations listed when one is found.
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
    violations = (check_registered_kernels() + check_ooc_ingest()
                  + check_adaptive_serving())
    for v in violations:
        print(v)
    print(f"{n} device-op code objects registered; "
          f"{len(OOC_HOT_PATHS)} streamed hot paths audited; adaptive "
          f"serving audited; {len(violations)} violations")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
