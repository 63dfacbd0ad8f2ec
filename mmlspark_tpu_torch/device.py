"""Device resolution for the port's entry points.

Every entry point (``gbdt.booster.train``, ``Booster``, the estimators)
takes ``device=None``, which means the card: ``"cuda"``. Without a card
it raises instead of quietly running on the CPU; the CPU path is taken
only when the caller asks for it with ``device="cpu"`` (as the tests do).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a usable card raises
    ``RuntimeError`` naming the explicit CPU opt-in."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mmlspark_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
