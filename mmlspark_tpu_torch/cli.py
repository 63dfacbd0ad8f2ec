"""Command line of the port: import an ONNX graph, score or HTTP-serve a
saved model.

    python -m mmlspark_tpu_torch.cli import-onnx model.onnx --out M [--batch-size N] [--input-shape JSON] [--device cuda|cpu]
    python -m mmlspark_tpu_torch.cli score --model M --data D --out P [--device cuda|cpu]
    python -m mmlspark_tpu_torch.cli serve --model M [--host H] [--port N] [--device cuda|cpu]

The port's copy of the ``import-onnx``, ``score`` and ``serve`` commands
of ``mmlspark_tpu/cli.py``, with the same data IO (``load_table`` /
``save_table``). ``--device`` (default ``cuda``) is set on every stage of
the loaded (or imported) model that has a ``device`` param: entry points
of the port run on the card unless asked for the CPU. ``--port 0`` binds
a free port; the line printed at start names the bound address. The JAX
CLI's ``run``, ``stages``, ``describe`` and ``codegen`` are not
registered here (ROADMAP.md).

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
from typing import Any, Dict


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


def load_model(path: str, device: str):
    """``load_stage`` + ``device`` on every stage that has the param
    (a PipelineModel's stages included)."""
    from mmlspark_tpu_torch.core.serialize import load_stage
    from mmlspark_tpu_torch.core.stage import PipelineModel
    from mmlspark_tpu_torch.device import resolve_device

    resolve_device(device)          # no card: raise before any work
    model = load_stage(path)
    stages = (model.get_stages() if isinstance(model, PipelineModel)
              else [model])
    for stage in stages:
        if any(p.name == "device" for p in type(stage).params()):
            stage.set("device", device)
    return model


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
          f"`python -m mmlspark_tpu_torch.cli score --model {args.out} "
          f"...` or serve it with `python -m mmlspark_tpu_torch.cli serve "
          f"--model {args.out}`", file=sys.stderr)
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
        prog="python -m mmlspark_tpu_torch.cli",
        description="Import an ONNX graph, score or HTTP-serve a saved "
                    "model of the PyTorch port.")
    sub = ap.add_subparsers(dest="cmd", required=True)

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
