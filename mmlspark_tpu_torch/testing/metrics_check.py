"""Audit of every Prometheus family the port renders: the port's
counterpart of the JAX package's ``tools/check_metrics.py``.

Two passes over the same contracts:

**The source** (``audit_source``), per renderer call site
(``r.counter`` / ``r.gauge`` / ``r.histogram`` / ``r.info`` /
``r.sample`` in ``core/prometheus.py``, ``serving/server.py`` and
``serving/fleet.py``):

1. **HELP present** — the help-text argument is a non-empty string
   literal.
2. **Naming conventions** — counters end ``_total``; histogram
   families end in a unit suffix (``_ms``/``_s``/``_rows``/
   ``_bytes``); gauges/infos must NOT end in ``_total`` or the
   reserved histogram suffixes (``_bucket``/``_sum``/``_count``).
3. **Dynamic names declared** — an f-string family name must appear in
   ``DYNAMIC_OK`` with its full expected expansion list, and every
   expansion passes rule 2.
4. **Cardinality caps declared** — a family labelled with an
   unbounded-identity key (``model``/``version``/``tenant``/``feature``)
   must be listed in ``CAPPED_FAMILIES``.
5. **Raw samples continue a family** — ``r.sample`` must reuse a family
   name already declared by a headered call in the same module.

**A rendered exposition** (``audit_text``): every family has a legal
name, one ``# HELP`` with non-empty text and one ``# TYPE`` of a known
kind before its samples; every sample belongs to a declared family and
parses; no series (name and label set) appears twice; a histogram's
buckets ascend to ``+Inf`` with cumulative counts, ``+Inf`` equal to
``_count``; and rule 2 and rule 4 hold for every family rendered.
``main`` renders the exposition of a live engine on the CPU (after one
request, with per-model SLO streams and alerts), and of a two-engine
fleet over one model zoo with admission, a variant ladder, a placement
controller and an autoscaler attached, and audits both.

Run from the repository root::

    python -m mmlspark_tpu_torch.testing.metrics_check

Exit 1 with the violations listed on any violation.
"""

from __future__ import annotations

import ast
import json
import math
import os
import re
import urllib.request
from typing import Dict, List, Optional, Set, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)

# the modules that render Prometheus families
AUDIT_FILES = (
    "mmlspark_tpu_torch/core/prometheus.py",
    "mmlspark_tpu_torch/serving/server.py",
    "mmlspark_tpu_torch/serving/fleet.py",
)

RENDER_METHODS = {"counter", "gauge", "histogram", "info", "sample"}
# receivers that LOOK like renderer calls but aren't (logger.info)
_EXCLUDED_RECEIVERS = {"log", "logger", "logging", "self", "cls"}

HISTOGRAM_SUFFIXES = ("_ms", "_s", "_rows", "_bytes")
RESERVED_SUFFIXES = ("_total", "_bucket", "_sum", "_count")

# label keys that identify an unbounded population: any family carrying
# one must declare its cardinality story in CAPPED_FAMILIES
UNBOUNDED_LABEL_KEYS = {"model", "version", "tenant", "feature"}

# families allowed to carry unbounded-identity labels, because their
# renderers are hard-capped at the source:
CAPPED_FAMILIES = {
    # the engine's one model row (one active version per engine); the
    # zoo's rows resident-first capped at label_cardinality_cap, its
    # latency overflow folded into model="_other"
    "serving_model_info",
    "serving_model_latency_ms",
    # placement plane: per-model replica gauges capped at
    # REPLICA_LABEL_CAP, overflow summed into model="_other"
    "serving_placement_replicas",
    # drift exposition: per-feature scores capped at DRIFT_FEATURE_CAP
    # (top-K by score), overflow folds into feature="_other"
    # (core/prometheus.py drift_families)
    "serving_drift_score",
    # variant plane: per-model rung/floor gauges + the info row capped
    # at VARIANT_LABEL_CAP declared ladders
    "serving_variant_rung",
    "serving_variant_floor",
    "serving_variant_info",
    # SLO engine: per-model streams capped at SLOMonitor.label_cap,
    # overflow folds into "_other"; active alerts inherit the same
    # capped identity space
    "serving_slo_model_burn_rate",
    "serving_slo_alert_active",
}

# dynamic (f-string) family names, with their FULL expected expansions —
# every expansion is suffix-checked like a literal. Key: the template
# with "{}" placeholders, as extracted from the JoinedStr.
DYNAMIC_OK: Dict[str, Tuple[str, ...]] = {
    # engine/fleet per-stage histograms + the warmup family
    "serving_{}": ("serving_queue_wait_ms", "serving_decode_ms",
                   "serving_pipeline_ms", "serving_respond_ms",
                   "serving_batch_rows", "serving_model_warmup_ms"),
    # pipeline_families: the model's own histogram hooks (TPUModel's
    # pad / device / readback split)
    "serving_model_{}": ("serving_model_pad_ms",
                         "serving_model_device_ms",
                         "serving_model_readback_ms"),
    # device memory gauges (utils/profiling.device_memory_stats keys)
    "device_memory_{}": ("device_memory_bytes_in_use",
                         "device_memory_bytes_limit",
                         "device_memory_peak_bytes_in_use"),
}


class Violation:
    def __init__(self, filename: str, line: int, message: str):
        self.filename = filename
        self.line = line
        self.message = message

    def __repr__(self) -> str:
        return f"{self.filename}:{self.line}: {self.message}"


def _template_of(node: ast.AST) -> Optional[str]:
    """A Constant string verbatim; a JoinedStr as a "{}" template;
    None for anything the audit cannot see through."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts: List[str] = []
        for value in node.values:
            if isinstance(value, ast.Constant):
                parts.append(str(value.value))
            else:
                parts.append("{}")
        return "".join(parts)
    return None


def _label_keys(node: Optional[ast.AST]) -> Set[str]:
    """String keys of a labels argument: dict literals (including
    ``{**base, "k": v}`` — the spread contributes nothing statically)
    and dict() calls with keyword args."""
    keys: Set[str] = set()
    if node is None:
        return keys
    if isinstance(node, ast.Dict):
        for k in node.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                keys.add(k.value)
    elif isinstance(node, ast.Call) and \
            isinstance(node.func, ast.Name) and node.func.id == "dict":
        for kw in node.keywords:
            if kw.arg is not None:
                keys.add(kw.arg)
    return keys


def _check_name(method: str, name: str, filename: str, line: int,
                out: List[Violation]) -> None:
    if method == "counter" and not name.endswith("_total"):
        out.append(Violation(
            filename, line,
            f"counter {name!r} must end in '_total'"))
    if method == "histogram" and \
            not name.endswith(HISTOGRAM_SUFFIXES):
        out.append(Violation(
            filename, line,
            f"histogram {name!r} must end in a unit suffix "
            f"{HISTOGRAM_SUFFIXES}"))
    if method in ("gauge", "info") and \
            name.endswith(RESERVED_SUFFIXES):
        out.append(Violation(
            filename, line,
            f"{method} {name!r} ends in a reserved suffix "
            f"{RESERVED_SUFFIXES} (counters own '_total'; histograms "
            f"own '_bucket'/'_sum'/'_count')"))


def audit_source(src: str, filename: str = "<string>"
                 ) -> List[Violation]:
    """Audit one module's source. Returns the violation list."""
    out: List[Violation] = []
    tree = ast.parse(src, filename=filename)
    declared: Set[str] = set()     # families with HELP in this module

    # source order, not ast.walk's BFS order: the sample-continues-a-
    # declared-family rule depends on seeing declarations first
    calls = sorted(
        (n for n in ast.walk(tree) if isinstance(n, ast.Call)),
        key=lambda n: (n.lineno, n.col_offset))
    for node in calls:
        func = node.func
        if not isinstance(func, ast.Attribute) or \
                func.attr not in RENDER_METHODS:
            continue
        if not isinstance(func.value, ast.Name) or \
                func.value.id in _EXCLUDED_RECEIVERS:
            continue
        method = func.attr
        line = node.lineno
        if not node.args:
            out.append(Violation(filename, line,
                                 f"{method} call with no name argument"))
            continue
        template = _template_of(node.args[0])
        if template is None:
            out.append(Violation(
                filename, line,
                f"{method} family name is not a (f-)string literal — "
                f"the audit cannot verify it; render through a literal "
                f"or an f-string declared in DYNAMIC_OK"))
            continue
        if "{}" in template:
            expansions = DYNAMIC_OK.get(template)
            if expansions is None:
                out.append(Violation(
                    filename, line,
                    f"dynamic family name {template!r} is not declared "
                    f"in DYNAMIC_OK (testing/metrics_check.py) — list "
                    f"its "
                    f"full expected expansions"))
                names: Tuple[str, ...] = ()
            else:
                names = expansions
        else:
            names = (template,)
        for name in names:
            _check_name(method, name, filename, line, out)
        # HELP text: 2nd positional (or help_text kw) must be a
        # non-empty string literal — except r.sample, which continues
        # an already-declared family (and must not mint one itself)
        if method == "sample":
            for name in names:
                if name not in declared:
                    out.append(Violation(
                        filename, line,
                        f"raw sample {name!r} does not continue a "
                        f"family declared (with HELP) in this module"))
            continue
        declared.update(names)
        help_node: Optional[ast.AST] = None
        if len(node.args) >= 2:
            help_node = node.args[1]
        else:
            for kw in node.keywords:
                if kw.arg == "help_text":
                    help_node = kw.value
        help_text = _template_of(help_node) if help_node is not None \
            else None
        if not help_text or not help_text.strip():
            out.append(Violation(
                filename, line,
                f"{method} family {names or template!r} has no literal "
                f"non-empty HELP text"))
        # cardinality: unbounded-identity labels require a declared cap
        labels_node: Optional[ast.AST] = None
        pos = {"counter": 3, "gauge": 3, "histogram": 3, "info": 2}
        if len(node.args) > pos[method]:
            labels_node = node.args[pos[method]]
        else:
            for kw in node.keywords:
                if kw.arg == "labels":
                    labels_node = kw.value
        hot = _label_keys(labels_node) & UNBOUNDED_LABEL_KEYS
        if hot:
            for name in names:
                if name not in CAPPED_FAMILIES:
                    out.append(Violation(
                        filename, line,
                        f"family {name!r} carries unbounded-identity "
                        f"label(s) {sorted(hot)} but is not declared in "
                        f"CAPPED_FAMILIES — document its hard "
                        f"cardinality cap first"))
    return out


def audit_file(path: str) -> List[Violation]:
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    return audit_source(src, filename=os.path.relpath(path, _REPO))



_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)(?: (-?\d+))?$")


def _parse_labels(s: str) -> Optional[Tuple[Tuple[str, str], ...]]:
    """``k="v",...`` with the text format's escapes; None if
    malformed."""
    labels: List[Tuple[str, str]] = []
    i = 0
    while i < len(s):
        m = re.match(r"[a-zA-Z_][a-zA-Z0-9_]*", s[i:])
        if not m:
            return None
        name = m.group(0)
        i += m.end()
        if s[i:i + 2] != '="':
            return None
        i += 2
        val: List[str] = []
        while i < len(s) and s[i] != '"':
            if s[i] == "\\":
                if i + 1 >= len(s) or s[i + 1] not in '\\"n':
                    return None
                val.append({"\\": "\\", '"': '"', "n": "\n"}[s[i + 1]])
                i += 2
                continue
            if s[i] == "\n":
                return None
            val.append(s[i])
            i += 1
        if i >= len(s):
            return None
        i += 1
        labels.append((name, "".join(val)))
        if i < len(s):
            if s[i] != ",":
                return None
            i += 1
    return tuple(labels)


def _family_of(name: str, types: Dict[str, str]) -> str:
    for suffix in ("_bucket", "_sum", "_count"):
        base = name[:-len(suffix)]
        if name.endswith(suffix) and types.get(base) == "histogram":
            return base
    return name


def audit_text(text: str, where: str = "<exposition>"
               ) -> List[Violation]:
    """Audit one rendered exposition (module docstring)."""
    out: List[Violation] = []
    helps: Dict[str, str] = {}
    types: Dict[str, str] = {}
    series: Set[Tuple[str, Tuple[Tuple[str, str], ...]]] = set()
    buckets: Dict[Tuple[str, Tuple], List[Tuple[float, float]]] = {}
    counts: Dict[Tuple[str, Tuple], float] = {}
    for n, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line[7:].split(" ", 1)
            name = parts[0]
            if not _NAME_RE.match(name):
                out.append(Violation(where, n, f"bad family name {name!r}"))
            if name in helps:
                out.append(Violation(where, n, f"second HELP for {name}"))
            if len(parts) < 2 or not parts[1].strip():
                out.append(Violation(where, n, f"{name} has empty HELP"))
            helps[name] = parts[1] if len(parts) > 1 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line[7:].split(" ")
            if len(parts) != 2 or parts[1] not in _TYPES:
                out.append(Violation(where, n, f"bad TYPE line {line!r}"))
                continue
            name, kind = parts
            if name in types:
                out.append(Violation(where, n, f"second TYPE for {name}"))
            if name not in helps:
                out.append(Violation(where, n,
                                     f"TYPE before HELP for {name}"))
            types[name] = kind
            method = "info" if kind == "gauge" else kind
            _check_name(method, name, where, n, out)
            continue
        if line.startswith("#"):
            out.append(Violation(where, n, f"unknown comment {line!r}"))
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            out.append(Violation(where, n, f"bad sample line {line!r}"))
            continue
        name, labelstr, value = m.group(1), m.group(2), m.group(3)
        labels = _parse_labels(labelstr) if labelstr else ()
        if labels is None:
            out.append(Violation(where, n, f"bad labels in {line!r}"))
            continue
        try:
            v = {"+Inf": math.inf, "-Inf": -math.inf}.get(value)
            v = float(value) if v is None else v
        except ValueError:
            out.append(Violation(where, n, f"bad value in {line!r}"))
            continue
        family = _family_of(name, types)
        if family not in types or family not in helps:
            out.append(Violation(where, n,
                                 f"sample {name} has no HELP/TYPE"))
            continue
        if (name, labels) in series:
            out.append(Violation(where, n,
                                 f"duplicate series {name}{dict(labels)}"))
        series.add((name, labels))
        keys = {k for k, _ in labels}
        if keys & UNBOUNDED_LABEL_KEYS and family not in CAPPED_FAMILIES:
            out.append(Violation(
                where, n, f"family {family!r} carries unbounded-identity "
                f"label(s) {sorted(keys & UNBOUNDED_LABEL_KEYS)} but is "
                f"not declared in CAPPED_FAMILIES"))
        if types[family] == "histogram":
            rest = tuple(kv for kv in labels if kv[0] != "le")
            if name.endswith("_bucket"):
                le = dict(labels).get("le")
                if le is None:
                    out.append(Violation(where, n, f"{name} without le"))
                    continue
                bound = math.inf if le == "+Inf" else float(le)
                buckets.setdefault((family, rest), []).append((bound, v))
            elif name.endswith("_count"):
                counts[(family, rest)] = v
    for (family, rest), bs in buckets.items():
        les = [b for b, _ in bs]
        vals = [c for _, c in bs]
        if les != sorted(les) or not math.isinf(les[-1]):
            out.append(Violation(where, 0, f"{family}{dict(rest)}: le not "
                                 f"ascending to +Inf"))
        if any(a > b for a, b in zip(vals, vals[1:])):
            out.append(Violation(where, 0, f"{family}{dict(rest)}: "
                                 f"cumulative counts not monotone"))
        if counts.get((family, rest)) != vals[-1]:
            out.append(Violation(where, 0, f"{family}{dict(rest)}: "
                                 f"_count != +Inf bucket"))
    for family, kind in types.items():
        if kind == "histogram" and not any(f == family for f, _ in buckets):
            out.append(Violation(where, 0, f"histogram {family} has no "
                                 f"buckets"))
    return out


def engine_exposition() -> str:
    """The ``/metrics`` text of a live engine on the CPU after one
    request, with the pipeline's histogram hook and drift monitor (more
    features than the drift cap), per-model SLO streams, active alerts
    and a control loop's families rendered (the process-wide families
    as they stand: this touches no process-wide state)."""
    import numpy as np
    from mmlspark_tpu_torch.core import metrics as MC
    from mmlspark_tpu_torch.core.slo import SLOMonitor
    from mmlspark_tpu_torch.core.trace import Tracer
    from mmlspark_tpu_torch.serving import ContinuousTrainer, serve_model
    from mmlspark_tpu_torch.stages.basic import Lambda

    def echo(table):
        return table.with_column("reply", [{"ok": 1} for _ in table["id"]])

    lam = Lambda.apply(echo)
    lam.histograms = lambda: {"pad_ms": MC.LatencyHistogram()}
    lam.jit_cache_miss_count = lambda: 0
    width = 24
    lam.drift_monitor = MC.DriftMonitor(np.zeros(width), np.ones(width))
    lam.drift_monitor.observe(np.arange(4 * width, dtype=np.float64)
                              .reshape(4, width))
    mon = SLOMonitor()
    for i in range(100):
        mon.record(i % 2 == 0, 1.0, model=f"m{i % 3}")
    mon.evaluate()
    engine = serve_model(lam, port=0, tracer=Tracer(enabled=True),
                         slo=mon, flight_recorder=False)
    # a control loop attached (not started): its families render
    engine.controlplane = ContinuousTrainer(engine, lambda w, a: None)
    try:
        req = urllib.request.Request(
            engine.source.address, data=json.dumps({"x": 1}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            r.read()
        with urllib.request.urlopen(engine.source.address + "/metrics",
                                    timeout=30) as r:
            return r.read().decode()
    finally:
        engine.stop()


def zoo_fleet_expositions() -> Tuple[str, str]:
    """(``/metrics`` of one zoo engine, ``fleet.metrics_text()``) for a
    two-engine fleet over one model zoo on the CPU, with admission, a
    two-rung variant ladder, a placement controller and an autoscaler
    attached, after one model-routed request per model."""
    from mmlspark_tpu_torch.serving import (
        AdmissionController, FleetAutoscaler, ModelZoo, ServingFleet,
        VariantSelector,
    )
    from mmlspark_tpu_torch.stages.basic import Lambda

    def echo(table):
        return table.with_column("reply", [{"ok": 1} for _ in table["id"]])

    zoo = ModelZoo(memory_probe=None, device="cpu")
    for name in ("a", "a_int8", "b"):
        zoo.register_factory(name, "v1", lambda: Lambda.apply(echo))
    fleet = ServingFleet(n_engines=2, base_port=0, zoo=zoo,
                         admission=AdmissionController(), tracing=False,
                         flight_recorder=False)
    try:
        sel = VariantSelector(zoo)
        sel.declare("a", ["a", "a_int8"], slo_ms=50.0)
        for e in fleet.engines:
            e.variants = sel
        fleet.attach_placement(rebuild_min_interval_s=0.0)
        FleetAutoscaler(fleet, lambda: ("", None))
        for model in ("a", "b"):
            fleet.post({"x": 1}, model=model)
        with urllib.request.urlopen(
                fleet.addresses[0] + "/metrics", timeout=30) as r:
            engine_text = r.read().decode()
        return engine_text, fleet.metrics_text()
    finally:
        fleet.stop_all()
        zoo.close()


def main() -> int:
    violations: List[Violation] = []
    for rel in AUDIT_FILES:
        violations += audit_file(os.path.join(_REPO, rel))
    text = engine_exposition()
    violations += audit_text(text, where="GET /metrics")
    zoo_text, fleet_text = zoo_fleet_expositions()
    violations += audit_text(zoo_text, where="GET /metrics (zoo engine)")
    violations += audit_text(fleet_text, where="fleet.metrics_text()")
    families = sum(1 for t in (text, zoo_text, fleet_text)
                   for line in t.splitlines() if line.startswith("# TYPE "))
    if violations:
        print(f"{len(violations)} metrics-exposition violation(s):")
        for v in violations:
            print("  -", v)
        return 1
    print(f"OK: {len(AUDIT_FILES)} modules and three expositions "
          f"({families} families) audited: 0 violations")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
