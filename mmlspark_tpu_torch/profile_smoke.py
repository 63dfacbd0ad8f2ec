"""Where ``chip_smoke.py``'s wall time goes, line by line (the PyTorch port).

    python3 -m mmlspark_tpu_torch.profile_smoke [--out PATH] [--interval S]

Run from the root of the repository, on a CUDA card. It runs
``chip_smoke.main()`` as the script would, while a sampler thread reads
the main thread's stack every ``--interval`` seconds (default 0.5) and
counts the innermost frame that lies in ``chip_smoke.py`` (function and
line): a subprocess wait, a profiler's post-processing or a fit all land
on the line of the script that started them. Every 20 s and at the end
it writes ``{"function:line": seconds}``, largest first, to ``--out``
(default ``build/smoke_samples.json``). The exit code is the script's.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import threading
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build",
                                                  "smoke_samples.json"))
    ap.add_argument("--interval", type=float, default=0.5)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    counts: collections.Counter = collections.Counter()
    main_id = threading.main_thread().ident
    stop = threading.Event()

    def dump() -> None:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({k: round(v * args.interval, 1)
                       for k, v in counts.most_common()}, f, indent=0)

    def sampler() -> None:
        last = time.monotonic()
        while not stop.wait(args.interval):
            frame = sys._current_frames().get(main_id)
            while frame is not None and not frame.f_code.co_filename \
                    .endswith("chip_smoke.py"):
                frame = frame.f_back
            if frame is not None:
                counts[f"{frame.f_code.co_name}:{frame.f_lineno}"] += 1
            if time.monotonic() - last > 20:
                dump()
                last = time.monotonic()

    threading.Thread(target=sampler, daemon=True).start()
    try:
        return chip_smoke.main()
    finally:
        stop.set()
        dump()


if __name__ == "__main__":
    sys.exit(main())
