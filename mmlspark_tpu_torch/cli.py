"""Command line of the port: the stage registry, JSON-spec pipelines,
ONNX import, scoring and HTTP serving.

    python -m mmlspark_tpu_torch.cli stages [--json]
    python -m mmlspark_tpu_torch.cli describe STAGE
    python -m mmlspark_tpu_torch.cli codegen OUT_DIR
    python -m mmlspark_tpu_torch.cli run SPEC --data D [--save M] [--score-out P] [--device cuda|cpu]
    python -m mmlspark_tpu_torch.cli import-onnx model.onnx --out M [--batch-size N] [--input-shape JSON] [--device cuda|cpu]
    python -m mmlspark_tpu_torch.cli score --model M --data D --out P [--device cuda|cpu]
    python -m mmlspark_tpu_torch.cli serve --model M [--host H] [--port N] [--device cuda|cpu]

The port's copy of ``mmlspark_tpu/cli.py``, with the same data IO
(``load_table`` / ``save_table``) and the same error texts. It is driven
by the codegen manifest (``codegen.stage_manifest``): stages are looked
up by registry name, params validated by the Param DSL, pipelines
described as plain JSON, so every registered stage is scriptable from a
shell. ``--device`` (default ``cuda``) is set on every stage of the
built, loaded or imported model that has a ``device`` param: entry
points of the port run on the card unless asked for the CPU. ``--port
0`` binds a free port; the line printed at start names the bound
address.

Pipeline spec (JSON)::

    {
      "pipeline": [
        {"stage": "CleanMissingData",
         "params": {"inputCols": ["f0"], "cleaningMode": "Mean"}},
        {"stage": "TPUBoostClassifier",
         "params": {"featuresCol": "features", "labelCol": "label"}}
      ]
    }

Data files: a DataTable directory (schema.json + columns.npz), an
``.npz`` of named columns, or a ``.csv`` with a header row (numeric
columns parse as float32; everything else stays string).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import threading
from typing import Any, Dict, List

PROG = "python -m mmlspark_tpu_torch.cli"


# ---------------------------------------------------------------------------
# data IO
# ---------------------------------------------------------------------------


def load_table(path: str):
    """DataTable from a table directory, .npz, or headered .csv."""
    import numpy as np
    from mmlspark_tpu_torch.core.table import DataTable

    if os.path.isdir(path):
        return DataTable.load(path)
    if path.endswith(".npz"):
        npz = np.load(path, allow_pickle=False)
        return DataTable({k: npz[k] for k in npz.files})
    if path.endswith(".csv"):
        with open(path, newline="") as f:
            reader = csv.reader(f)
            header = next(reader)
            rows = list(reader)
        cols: Dict[str, Any] = {}
        for i, name in enumerate(header):
            vals = [r[i] for r in rows]
            try:
                cols[name] = np.asarray(
                    [float(v) for v in vals], dtype=np.float32)
            except ValueError:
                cols[name] = vals
        return DataTable(cols)
    raise SystemExit(
        f"unrecognized data path {path!r}: expected a DataTable "
        f"directory, .npz, or .csv")


def save_table(table, path: str) -> None:
    """Table directory (default) or .csv when the path says so."""
    import numpy as np

    if path.endswith(".csv"):
        names = table.column_names
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(names)
            for row in table.rows():
                w.writerow([
                    row[n].tolist() if isinstance(row[n], np.ndarray)
                    else row[n] for n in names])
    else:
        table.save(path)


# ---------------------------------------------------------------------------
# pipeline spec
# ---------------------------------------------------------------------------


def _set_device(stages, device: str) -> None:
    for stage in stages:
        if any(p.name == "device" for p in type(stage).params()):
            stage.set("device", device)


def build_pipeline(spec: Dict[str, Any], device: str = "cuda"):
    """JSON spec -> Pipeline, resolving stages from the codegen
    registry and validating params through the Param DSL; ``device`` on
    every stage that has the param."""
    from mmlspark_tpu_torch.codegen import load_all_stages
    from mmlspark_tpu_torch.core.stage import Pipeline

    registry = load_all_stages()
    stages = []
    entries: List[Dict[str, Any]] = spec.get("pipeline", [])
    if not entries:
        raise SystemExit("spec has no 'pipeline' list")
    for i, entry in enumerate(entries):
        name = entry.get("stage")
        cls = registry.get(name)
        if cls is None:
            close = [k for k in sorted(registry)
                     if name and name.lower() in k.lower()]
            hint = f" (did you mean: {', '.join(close[:5])}?)" \
                if close else ""
            raise SystemExit(
                f"pipeline[{i}]: unknown stage {name!r}{hint} — run "
                f"`{PROG} stages` for the full list")
        try:
            stages.append(cls(**entry.get("params", {})))
        except (KeyError, TypeError, ValueError) as e:
            raise SystemExit(f"pipeline[{i}] ({name}): {e}") from e
    _set_device(stages, device)
    return Pipeline(stages=stages)


def _read_spec(path: str) -> Dict[str, Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SystemExit(f"cannot read pipeline spec {path!r}: {e}")


# ---------------------------------------------------------------------------
# commands
# ---------------------------------------------------------------------------


def load_model(path: str, device: str):
    """``load_stage`` + ``device`` on every stage that has the param
    (a PipelineModel's stages included)."""
    from mmlspark_tpu_torch.core.serialize import load_stage
    from mmlspark_tpu_torch.core.stage import PipelineModel
    from mmlspark_tpu_torch.device import resolve_device

    resolve_device(device)          # no card: raise before any work
    model = load_stage(path)
    _set_device(model.get_stages() if isinstance(model, PipelineModel)
                else [model], device)
    return model


def cmd_stages(args) -> int:
    from mmlspark_tpu_torch.codegen import stage_manifest
    manifest = stage_manifest()
    if args.json:
        json.dump(manifest, sys.stdout, indent=1)
        print()
        return 0
    for name, info in sorted(manifest["stages"].items()):
        first = (info["doc"] or "").split("\n")[0]
        print(f"{name:32s} {info['kind']:12s} {first[:70]}")
    print(f"\n{len(manifest['stages'])} stages "
          f"(v{manifest['version']})")
    return 0


def cmd_describe(args) -> int:
    from mmlspark_tpu_torch.codegen import load_all_stages, stage_markdown
    registry = load_all_stages()
    cls = registry.get(args.stage)
    if cls is None:
        raise SystemExit(f"unknown stage {args.stage!r} — run "
                         f"`{PROG} stages`")
    print(stage_markdown(args.stage, cls))
    return 0


def cmd_codegen(args) -> int:
    from mmlspark_tpu_torch.codegen import generate_artifacts
    counts = generate_artifacts(args.out_dir)
    print(json.dumps(counts))
    return 0


def cmd_run(args) -> int:
    from mmlspark_tpu_torch.device import resolve_device
    resolve_device(args.device)     # no card: raise before any work
    spec = _read_spec(args.spec)
    pipeline = build_pipeline(spec, args.device)
    table = load_table(args.data)
    print(f"fitting {len(spec['pipeline'])} stage(s) on "
          f"{table.num_rows} rows", file=sys.stderr)
    model = pipeline.fit(table)
    if args.save:
        model.save(args.save)
        print(f"model saved to {args.save}", file=sys.stderr)
    if args.score_out:
        scored = model.transform(table)
        save_table(scored, args.score_out)
        print(f"scored table written to {args.score_out}",
              file=sys.stderr)
    return 0


def cmd_score(args) -> int:
    model = load_model(args.model, args.device)
    table = load_table(args.data)
    out = model.transform(table)
    save_table(out, args.out)
    print(f"scored {table.num_rows} rows -> {args.out}", file=sys.stderr)
    return 0


def cmd_import_onnx(args) -> int:
    from mmlspark_tpu_torch.importers.onnx_import import import_onnx_model
    model = import_onnx_model(
        args.onnx, batch_size=args.batch_size,
        input_shape=json.loads(args.input_shape)
        if args.input_shape else None, device=args.device)
    model.save(args.out)
    # summarize from the model just built — re-parsing the protobuf
    # would decode every initializer a second time
    apply_fn = model.get("modelFn")
    ops: Dict[str, int] = {}
    for node in apply_fn.nodes:
        ops[node.op_type] = ops.get(node.op_type, 0) + 1
    print(json.dumps({"saved": args.out, "ops": dict(sorted(ops.items())),
                      "opset": apply_fn.opset,
                      "inputs": apply_fn.input_names}))
    print(f"model saved to {args.out} — score it with "
          f"`{PROG} score --model {args.out} ...` or serve it with "
          f"`{PROG} serve --model {args.out}`", file=sys.stderr)
    return 0


def cmd_serve(args) -> int:
    from mmlspark_tpu_torch.serving.fleet import json_row_scoring_pipeline
    from mmlspark_tpu_torch.serving.server import serve_model

    model = load_model(args.model, args.device)
    # requests arrive as an HTTP-request struct column; wrap the saved
    # tabular pipeline so JSON-object bodies score as table rows
    scorer = json_row_scoring_pipeline(model, reply_col=args.reply_col)
    engine = serve_model(scorer, host=args.host, port=args.port,
                         batch_size=args.batch_size,
                         workers=args.workers)
    print(f"serving {os.path.basename(os.path.abspath(args.model))} "
          f"on {engine.source.address} "
          f"(POST JSON rows; Ctrl-C to stop)", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        print("stopping", file=sys.stderr)
    finally:
        engine.stop()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog=PROG,
        description="Manifest-driven CLI over the PyTorch port's stage "
                    "registry: list/describe stages, fit+score JSON-spec "
                    "pipelines, import ONNX graphs, serve saved models.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("stages", help="list registered stages")
    p.add_argument("--json", action="store_true",
                   help="full machine-readable manifest")
    p.set_defaults(fn=cmd_stages)

    p = sub.add_parser("describe", help="param table for one stage")
    p.add_argument("stage")
    p.set_defaults(fn=cmd_describe)

    p = sub.add_parser("codegen",
                       help="emit docs + manifest + smoke tests")
    p.add_argument("out_dir")
    p.set_defaults(fn=cmd_codegen)

    p = sub.add_parser("run", help="fit a JSON pipeline spec")
    p.add_argument("spec")
    p.add_argument("--data", required=True)
    p.add_argument("--save", help="directory to save the fitted model")
    p.add_argument("--score-out",
                   help="also transform the data and write it here")
    p.add_argument("--device", default="cuda",
                   help="torch device the stages fit and score on "
                        "(default: cuda)")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser(
        "import-onnx",
        help="ONNX file -> saved TPUModel stage (then score/serve it)")
    p.add_argument("onnx")
    p.add_argument("--out", required=True,
                   help="directory to save the imported model stage")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--input-shape",
                   help='JSON per-row shape, e.g. "[3,224,224]" or '
                        '{"user": [6]} for multi-input graphs '
                        '(default: inferred from the graph)')
    p.add_argument("--device", default="cuda",
                   help="torch device the model scores on (default: cuda)")
    p.set_defaults(fn=cmd_import_onnx)

    p = sub.add_parser("score", help="transform data with a saved model")
    p.add_argument("--model", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device to score on (default: cuda)")
    p.set_defaults(fn=cmd_score)

    p = sub.add_parser("serve", help="HTTP-serve a saved model")
    p.add_argument("--model", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8899)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--reply-col", default="prediction",
                   help="output column returned as the HTTP reply "
                        "body (default: prediction)")
    p.add_argument("--device", default="cuda",
                   help="torch device to score on (default: cuda)")
    p.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:          # output piped into head/less
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 0


if __name__ == "__main__":
    sys.exit(main())
