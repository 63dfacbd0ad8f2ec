"""One TRACED serving-host process of the port, for the cross-process
trace test of ``tests/test_torch_fleet.py`` (the port's counterpart of
``tests/traced_worker.py``).

It runs a Tracer-enabled port engine on the CPU with JAX blocked, and on
shutdown writes its whole trace buffer as Chrome trace-event JSON (with
the per-process ``process_name`` metadata) to the path given on the
command line. The scorer stalls when the request names THIS worker id
(``{"stall_worker": <wid>, "stall_s": 0.8}``), so the parent can make
exactly one leg slow — the deterministic hedge trigger.

Usage: python torch_traced_worker.py <port> <worker_id> <dump_path>
"""

import json
import os
import sys
import threading
import time

sys.modules["jax"] = None
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> None:
    port, wid, dump_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    from mmlspark_tpu_torch.core.trace import Tracer
    from mmlspark_tpu_torch.serving.server import HTTPSource, ServingEngine
    from mmlspark_tpu_torch.stages.basic import Lambda

    stop = threading.Event()

    def handle(table):
        replies = []
        for r in table["request"]:
            body = json.loads(r["entity"].decode())
            if body.get("__shutdown__"):
                stop.set()
                replies.append({"bye": wid})
                continue
            if body.get("stall_worker") == wid:
                time.sleep(float(body.get("stall_s", 0.8)))
            replies.append({"echo": body["x"], "worker": wid,
                            "pid": os.getpid()})
        return table.with_column("reply", replies)

    tracer = Tracer(enabled=True)
    source = HTTPSource(host="127.0.0.1", port=port)
    engine = ServingEngine(source, Lambda.apply(handle), batch_size=8,
                           tracer=tracer, slo=False,
                           flight_recorder=False).start()
    print(f"READY {wid} {source.address} {os.getpid()}", flush=True)

    stop.wait(timeout=120)
    time.sleep(0.5)   # let the shutdown reply + stalled batches flush
    with open(dump_path, "w", encoding="utf-8") as f:
        json.dump(engine.export_traces(), f)
    print(f"DUMPED {wid} {dump_path}", flush=True)
    engine.stop()


if __name__ == "__main__":
    main()
