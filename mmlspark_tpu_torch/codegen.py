"""Introspection-driven API generation.

Analog of the reference's codegen component
(ref: src/codegen/src/main/scala/CodeGen.scala:44-92,
PySparkWrapper.scala:17-328, DocGen): the reference reflection-scans
built jars and emits PySpark/R wrapper classes, docs, and smoke tests
for every Wrappable stage. Here the host language IS Python, so the
capability this layer preserves is: every registered stage is
automatically exposed with generated reference docs, a generated smoke
test per stage, and a machine-readable param manifest — coverage is
structural (anything in STAGE_REGISTRY is picked up, nothing is
hand-listed).

The port's copy of ``mmlspark_tpu/codegen.py``: the manifest covers
``mmlspark_tpu_torch.core.stage.STAGE_REGISTRY`` (the stages of the
modules in ``STAGE_MODULES``), with the same keys, docs and generated
tests. A private base class (a registered name with a leading
underscore, such as ``_BoosterModel``) is not part of the surface:
``load_all_stages`` leaves it out, so the CLI neither lists nor builds
it.

Usage::

    python -m mmlspark_tpu_torch.codegen out_dir/
"""

from __future__ import annotations

import importlib
import inspect
import json
import os
from typing import Any, Dict, List, Type

from mmlspark_tpu_torch.core.stage import (
    Estimator, Model, PipelineStage, STAGE_REGISTRY, Transformer,
)

# modules that define stages; imported so the registry is complete
STAGE_MODULES = [
    "mmlspark_tpu_torch.stages",
    "mmlspark_tpu_torch.gbdt",
    "mmlspark_tpu_torch.automl",
    "mmlspark_tpu_torch.models.learner",
    "mmlspark_tpu_torch.models.linear",
    "mmlspark_tpu_torch.models.tpu_model",
    "mmlspark_tpu_torch.io.http",
    "mmlspark_tpu_torch.io.minibatch",
    "mmlspark_tpu_torch.serving.fleet",
]


def load_all_stages() -> Dict[str, Type[PipelineStage]]:
    """Every registered stage but a private base class (a name with a
    leading underscore), with ``STAGE_MODULES`` imported first."""
    for m in STAGE_MODULES:
        importlib.import_module(m)
    return {n: c for n, c in STAGE_REGISTRY.items()
            if not n.startswith("_")}


def stage_kind(cls: Type[PipelineStage]) -> str:
    if issubclass(cls, Model):
        return "Model"
    if issubclass(cls, Estimator):
        return "Estimator"
    if issubclass(cls, Transformer):
        return "Transformer"
    return "PipelineStage"


def param_manifest(cls: Type[PipelineStage]) -> List[Dict[str, Any]]:
    """Machine-readable param table (name, type, default, doc, domain)."""
    out = []
    for p in cls.params():
        default: Any = None
        has_default = p.has_default
        if has_default:
            try:
                json.dumps(p.default)
                default = p.default
            except (TypeError, ValueError):
                default = repr(p.default)
        entry = {
            "name": p.name,
            "type": type(p).__name__,
            "doc": p.doc,
            "has_default": has_default,
            "default": default,
            "is_complex": p.is_complex,
        }
        values = getattr(p, "values", None)
        if values:
            entry["choices"] = list(values)
        out.append(entry)
    return out


def stage_manifest() -> Dict[str, Any]:
    """Full machine-readable manifest of the stage API surface."""
    stages = {}
    for name, cls in sorted(load_all_stages().items()):
        if name in ("Transformer", "Estimator", "Model"):
            continue
        # only the framework's own stages — user/test-defined subclasses
        # register too (for load-time resolution) but aren't part of the
        # generated API surface (the reference scans only its own jars)
        if not cls.__module__.startswith("mmlspark_tpu_torch."):
            continue
        stages[name] = {
            "kind": stage_kind(cls),
            "module": cls.__module__,
            "doc": inspect.getdoc(cls) or "",
            "params": param_manifest(cls),
        }
    return {"version": _version(), "stages": stages}


def _version() -> str:
    from mmlspark_tpu_torch.version import __version__
    return __version__


def stage_markdown(name: str, cls: Type[PipelineStage]) -> str:
    """One stage's reference doc (DocGen/WrapperClassDoc analog)."""
    lines = [f"# {name}", ""]
    lines.append(f"*{stage_kind(cls)}* — `{cls.__module__}.{name}`")
    lines.append("")
    doc = inspect.getdoc(cls)
    if doc:
        lines.append(doc)
        lines.append("")
    params = param_manifest(cls)
    if params:
        lines.append("## Parameters")
        lines.append("")
        lines.append("| name | type | default | description |")
        lines.append("|---|---|---|---|")
        for p in params:
            default = (json.dumps(p["default"])
                       if p["has_default"] else "*required*")
            doc_text = (p["doc"] or "").replace("\n", " ").replace("|", "\\|")
            if "choices" in p:
                doc_text += f" (one of: {', '.join(p['choices'])})"
            lines.append(f"| `{p['name']}` | {p['type']} | {default} "
                         f"| {doc_text} |")
        lines.append("")
    return "\n".join(lines)


def generated_smoke_test(name: str, cls: Type[PipelineStage]) -> str:
    """Source of a generated per-stage smoke test
    (PySparkWrapperTest analog): construct, set simple params, copy,
    round-trip explain_params."""
    return f'''
def test_{name.lower()}_smoke():
    """GENERATED — do not edit (ref: codegen PySparkWrapperTest)."""
    from {cls.__module__} import {name}
    stage = {name}()
    assert stage.uid.startswith("{name}")
    stage.explain_params()
    clone = stage.copy()
    assert type(clone) is {name}
    assert clone.uid == stage.uid
    for p in {name}.params():
        if p.has_default and not p.is_complex:
            assert clone.get(p) == stage.get(p)
'''


def generate_artifacts(out_dir: str) -> Dict[str, int]:
    """Emit docs/, manifest.json, and generated smoke tests
    (ref: CodeGen.generateArtifacts :44-92)."""
    stages = load_all_stages()
    docs_dir = os.path.join(out_dir, "docs")
    os.makedirs(docs_dir, exist_ok=True)

    manifest = stage_manifest()
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)

    index = ["# mmlspark_tpu_torch API reference", "",
             "Generated by `python -m mmlspark_tpu_torch.codegen`.", ""]
    n_docs = 0
    for name in sorted(manifest["stages"]):
        cls = stages[name]
        with open(os.path.join(docs_dir, f"{name}.md"), "w") as f:
            f.write(stage_markdown(name, cls))
        kind = manifest["stages"][name]["kind"]
        index.append(f"- [{name}]({name}.md) — {kind}")
        n_docs += 1
    with open(os.path.join(docs_dir, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")

    tests = ['"""GENERATED smoke tests — python -m '
             'mmlspark_tpu_torch.codegen."""', ""]
    n_tests = 0
    for name in sorted(manifest["stages"]):
        cls = stages[name]
        try:
            cls()  # only stages constructible with defaults get one
        except Exception:  # noqa: BLE001
            continue
        tests.append(generated_smoke_test(name, cls))
        n_tests += 1
    with open(os.path.join(out_dir, "test_generated_smoke.py"), "w") as f:
        f.write("\n".join(tests))

    return {"stages": len(manifest["stages"]), "docs": n_docs,
            "tests": n_tests}


def main(argv=None) -> int:
    """Console entry point (``python -m mmlspark_tpu_torch.codegen
    out_dir``)."""
    import sys
    args = sys.argv[1:] if argv is None else argv
    out = args[0] if args else "generated"
    counts = generate_artifacts(out)
    print(json.dumps(counts))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
