"""One serving-host process of the port, importing nothing of JAX.

Each worker is its own OS process with its own ``ServingEngine``, port
and counters: the multi-process fleet shape that
``ServingFleet.connect`` and ``post_columns`` (with or without the
shared-memory transport) drive.

Three scorers:

- ``echo``: JSON bodies ``{"x": ...}`` echo back with the worker id;
  ``{"__shutdown__": true}`` stops the worker and prints its counters.
- ``linear``: a seeded linear ``TPUModel`` served through
  ``json_scoring_pipeline``, so the worker speaks the JSON oracle and
  the columnar codecs and every worker computes the same predictions.
- ``forest``: a GBDT classifier loaded from a Booster model string
  (``--model PATH``) and served through ``json_scoring_pipeline`` on
  ``--device`` (the card unless ``cpu`` is asked for).

Every scorer prints ``READY <worker_id> <address> <pid>`` once it
listens, and stops on SIGTERM (the linear and forest scorers run until
then). ``PORT`` 0 binds a free port.

Usage::

    python -m mmlspark_tpu_torch.testing.serving_worker PORT WID
        [--scorer echo|linear|forest] [--model PATH]
        [--device cuda|cpu] [--batch-size N] [--workers N]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

sys.modules["jax"] = None

LINEAR_DIM, LINEAR_CLASSES = 16, 4


def _linear_stage(batch_size: int, device: str):
    """The seeded linear scorer every worker agrees on: 16 features in,
    4 classes out."""
    import numpy as np
    from mmlspark_tpu_torch.models.tpu_model import TPUModel
    from mmlspark_tpu_torch.serving.fleet import json_scoring_pipeline

    rng = np.random.default_rng(7)
    weights = {"W": rng.normal(size=(LINEAR_DIM, LINEAR_CLASSES))
               .astype(np.float32),
               "b": rng.normal(size=(LINEAR_CLASSES,)).astype(np.float32)}

    def fwd(w, inputs):
        x = list(inputs.values())[0]
        return {"output": x @ w["W"] + w["b"]}

    model = TPUModel.from_fn(fwd, weights, inputCol="features",
                             outputCol="scores", batchSize=batch_size,
                             device=device)
    stage = json_scoring_pipeline(model, field="features")
    stage.warmup({"features": rng.normal(size=(2, LINEAR_DIM))
                  .astype(np.float32)})
    return stage


def _forest_stage(path: str, batch_size: int, device: str):
    """A GBDT classifier from its model string, warmed on its device."""
    import numpy as np
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.gbdt.booster import Booster
    from mmlspark_tpu_torch.gbdt.estimators import (
        TPUBoostClassificationModel,
    )
    from mmlspark_tpu_torch.serving.fleet import json_scoring_pipeline

    with open(path) as f:
        text = f.read()
    booster = Booster.from_string(text, device=device)
    model = TPUBoostClassificationModel(
        modelString=text, numClasses=max(2, booster.num_class),
        device=device)
    model._booster = booster
    # one warm walk at a batch's width: the card's first forest walk
    # must not land on a client's request
    width = (len(booster.feature_names) if booster.feature_names
             else int(np.max(booster.trees["feature"])) + 1)
    model.transform(DataTable(
        {"features": np.zeros((batch_size, width), np.float32)}))
    return json_scoring_pipeline(model, batch_size=batch_size)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("port", type=int)
    ap.add_argument("worker_id", type=int)
    ap.add_argument("--scorer", choices=["echo", "linear", "forest"],
                    default="echo")
    ap.add_argument("--model", default=None,
                    help="Booster model string file (--scorer forest)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--workers", type=int, default=1)
    args = ap.parse_args()
    port, wid = args.port, args.worker_id
    if args.scorer == "forest" and not args.model:
        ap.error("--scorer forest needs --model PATH")

    from mmlspark_tpu_torch.serving.server import HTTPSource, ServingEngine
    from mmlspark_tpu_torch.stages.basic import Lambda

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())

    if args.scorer in ("linear", "forest"):
        if args.scorer == "linear":
            stage = _linear_stage(args.batch_size, args.device)
        else:
            stage = _forest_stage(args.model, args.batch_size, args.device)
        source = HTTPSource(host="127.0.0.1", port=port)
        engine = ServingEngine(source, stage, batch_size=args.batch_size,
                               workers=args.workers, slo=False,
                               flight_recorder=False).start()
        print(f"READY {wid} {source.address} {os.getpid()}", flush=True)
        try:
            stop.wait()
        finally:
            engine.stop()
        return

    def handle(table):
        replies = []
        for r in table["request"]:
            body = json.loads(r["entity"].decode())
            if body.get("__shutdown__"):
                stop.set()
                replies.append({"bye": wid})
            else:
                # the worker identity: each answer must come back
                # through the process that accepted it
                replies.append({"echo": body["x"], "worker": wid})
        return table.with_column("reply", replies)

    source = HTTPSource(host="127.0.0.1", port=port)
    engine = ServingEngine(source, Lambda.apply(handle), batch_size=8,
                           slo=False, flight_recorder=False).start()
    print(f"READY {wid} {source.address} {os.getpid()}", flush=True)
    stop.wait(timeout=120)
    time.sleep(0.3)   # let the shutdown reply flush
    print(f"COUNTERS {wid} {source.requests_seen} "
          f"{source.requests_accepted} {source.requests_answered}",
          flush=True)
    engine.stop()


if __name__ == "__main__":
    main()
