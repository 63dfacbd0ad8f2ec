"""One serving-host process of the port for the cross-process serving
tests (the port's counterpart of ``tests/serving_worker.py``'s ``echo``
scorer, importing nothing of JAX).

It runs a port engine on the CPU with JAX blocked: JSON bodies
``{"x": ...}`` echo back with the worker id; ``{"__shutdown__": true}``
stops the worker and prints its counters. It also stops on SIGTERM (the
autoscaler's drain-then-retire path terminates it).

Usage: python torch_serving_worker.py <port> <worker_id>
"""

import json
import os
import signal
import sys
import threading
import time

sys.modules["jax"] = None
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> None:
    port, wid = int(sys.argv[1]), int(sys.argv[2])

    from mmlspark_tpu_torch.serving.server import HTTPSource, ServingEngine
    from mmlspark_tpu_torch.stages.basic import Lambda

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())

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
