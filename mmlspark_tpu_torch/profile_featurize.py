"""Where the time of the transfer-learning image path goes on a CUDA card
(the PyTorch port).

    python3 -m mmlspark_tpu_torch.profile_featurize [--images 1024]
        [--batch 64] [--pool-widths 8,4,4,8] [--trace PATH]

Builds the configuration ``chip_smoke.py`` phase 10 drives: ResNet-18
with the ImageNet stem (``TORCHVISION_RESNET18_SPEC``) whose weights come
from a torchvision-layout state dict drawn from a seed
(``seeded_resnet18_state_dict``) through ``import_torchvision_resnet``,
cut at the pooled 512-wide embedding (``cutOutputLayers=1``), over
``--images`` Flowers-sized uint8 images (``flowers_table``: heights
240-500, widths 320-500, two classes of pixel mean 60 and 180). Prints:
  - the host half alone (``featurizer.load_image``: float32, resize to
    224 x 224, scale) of 256 images, in ms an image, at resize-pool
    widths 1, 2, 4 and 8 and with torch's intra-op threads at 1 and at
    their default, so that the pool's width and the threads' fan-out can
    be chosen from a measurement;
  - ``ImageFeaturizer.transform`` at ``--batch``, its resize pool at
    each of ``--pool-widths`` in turn (the process-wide pool rebuilt at
    that width): imgs/s of the second of two runs, the ``image_resize``
    / ``image_forward`` histograms;
  - a third run under ``torch.profiler``: the device's busy and idle
    shares of the transform's host-timed window (the call to its last
    synchronize), and device time by kernel.
With ``--trace`` it also writes the profiler's chrome trace there.
Exits 1 without a card, or if the profiler records no device activity.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from mmlspark_tpu_torch.profile_fit import union_us

SIDE = 224
RESIZE_IMAGES = 256


def seeded_resnet18_state_dict(seed: int = 0) -> dict:
    """A torchvision resnet18 state dict (the keys and shapes of
    ``_torchvision_manifest``) drawn from ``seed``: conv and fc weights
    normal with He scaling over the fan-in, BatchNorm scales in
    [0.5, 1.5], biases and running means normal(0, 0.1), running
    variances in [0.5, 2]."""
    import torch

    from mmlspark_tpu_torch.importers.torch_import import (
        _torchvision_manifest)
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for key, shape in _torchvision_manifest([2, 2, 2, 2], 1000).items():
        if len(shape) > 1:
            fan_in = int(np.prod(shape[1:]))
            t = torch.randn(shape, generator=g) * (2.0 / fan_in) ** 0.5
        elif key.endswith("running_var"):
            t = 0.5 + 1.5 * torch.rand(shape, generator=g)
        elif key.endswith(".weight"):
            t = 0.5 + torch.rand(shape, generator=g)
        else:
            t = 0.1 * torch.randn(shape, generator=g)
        sd[key] = t
    return sd


def flowers_table(n: int, seed: int = 0):
    """``n`` uint8 images in ``ImageSchema`` rows at Flowers-like sizes
    (height 240-500, width 320-500, from ``seed``), labelled 0 / 1 in
    turn, of pixel mean 60 / 180 as examples/305_transfer_learning.py
    draws them (normal, sd 35, clipped)."""
    from mmlspark_tpu_torch.core.schema import ImageSchema
    from mmlspark_tpu_torch.core.table import DataTable
    rng = np.random.default_rng(seed)
    rows, labels = [], []
    for i in range(n):
        h, w = int(rng.integers(240, 501)), int(rng.integers(320, 501))
        img = rng.standard_normal((h, w, 3), dtype=np.float32) * 35.0
        img += 60.0 if i % 2 == 0 else 180.0
        rows.append(ImageSchema.make_row(
            f"flower_{i}.jpg", np.clip(img, 0, 255).astype(np.uint8), "RGB"))
        labels.append(float(i % 2))
    return DataTable({"image": rows, "label": np.asarray(labels)})


def resize_sweep(table, widths=(1, 2, 4, 8), n: int = RESIZE_IMAGES):
    """{(pool width, torch threads): ms an image} of the featurizer's
    host half over the first ``n`` images; torch's thread count is
    restored after."""
    import torch

    from mmlspark_tpu_torch.stages.featurizer import load_image
    rows = list(table["image"][:n])
    default = torch.get_num_threads()
    out = {}
    try:
        for threads in (1, default):
            torch.set_num_threads(threads)
            for width in widths:
                with ThreadPoolExecutor(max_workers=width) as pool:
                    list(pool.map(lambda r: load_image(r, SIDE, SIDE, 1.0),
                                  rows[:width]))        # warm the threads
                    t0 = time.perf_counter()
                    list(pool.map(lambda r: load_image(r, SIDE, SIDE, 1.0),
                                  rows))
                    out[(width, threads)] = \
                        1e3 * (time.perf_counter() - t0) / len(rows)
    finally:
        torch.set_num_threads(default)
    return out


def device_busy(prof, window_us: float) -> dict:
    """Busy and idle shares of ``window_us``, the host's time around the
    profiled call (so the idle share counts the host work before the
    first device event and after the last), and device time by kernel
    name (us)."""
    import torch
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return {}
    busy = union_us([(e.time_range.start, e.time_range.end)
                     for e in events])
    by_name = defaultdict(lambda: [0, 0.0])
    for e in events:
        rec = by_name[e.name[:90]]
        rec[0] += 1
        rec[1] += e.time_range.end - e.time_range.start
    return {"window_us": window_us, "busy_us": busy,
            "idle_share": 1.0 - busy / window_us, "by_name": dict(by_name)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--pool-widths", default="")
    ap.add_argument("--trace", default="")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_featurize: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from mmlspark_tpu_torch.core.metrics import automl_histograms
    from mmlspark_tpu_torch.importers.torch_import import (
        TORCHVISION_RESNET18_SPEC, import_torchvision_resnet)
    from mmlspark_tpu_torch.stages import featurizer as F

    print(f"card: {torch.cuda.get_device_name(0)}; host cores "
          f"{os.cpu_count()}, torch intra-op threads "
          f"{torch.get_num_threads()}, resize pool {F.RESIZE_WORKERS}")
    t0 = time.perf_counter()
    table = flowers_table(args.images)
    print(f"{args.images} images made in {time.perf_counter() - t0:.3f} s")
    for (width, threads), ms in resize_sweep(table).items():
        print(f"host half: pool {width}, torch threads {threads}: "
              f"{ms:.3f} ms an image ({1e3 / ms:.1f} imgs/s)")

    variables = import_torchvision_resnet(seeded_resnet18_state_dict())
    feat = F.ImageFeaturizer(networkSpec=TORCHVISION_RESNET18_SPEC,
                             weights=variables, inputHeight=SIDE,
                             inputWidth=SIDE, cutOutputLayers=1,
                             batchSize=args.batch, device="cuda")
    hists = automl_histograms()
    widths = [int(w) for w in args.pool_widths.split(",") if w] or \
        [F.RESIZE_WORKERS]
    default_width = F.RESIZE_WORKERS
    try:
        for width in widths:
            F.RESIZE_WORKERS, F._RESIZE_POOL = width, None
            for attempt in ("first", "second"):
                for h in hists.values():
                    h.reset()
                t0 = time.perf_counter()
                out = feat.transform(table)["features"]
                secs = time.perf_counter() - t0
                print(f"transform, pool {width} ({attempt}): {secs:.3f} s, "
                      f"{args.images / secs:.1f} imgs/s, features "
                      f"{out.shape}")
            for name in ("image_resize", "image_forward"):
                print(f"  {name}: {hists[name].summary()}")
    finally:
        F.RESIZE_WORKERS, F._RESIZE_POOL = default_width, None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        feat.transform(table)
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    busy = device_busy(prof, window_us)
    if not busy:
        print("profile_featurize: the profiler recorded no device "
              "activity", file=sys.stderr)
        return 1
    print(f"profiled transform window {busy['window_us'] / 1e3:.3f} ms: "
          f"busy {busy['busy_us'] / 1e3:.3f} ms, idle "
          f"{100 * busy['idle_share']:.1f} %")
    total = sum(v[1] for v in busy["by_name"].values())
    for name, (count, us) in sorted(busy["by_name"].items(),
                                    key=lambda kv: -kv[1][1])[:12]:
        print(f"  {us / 1e3:10.3f} ms  {100 * us / total:5.1f} %  "
              f"x{count:<6d} {name}")
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)
        print(f"trace written to {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
