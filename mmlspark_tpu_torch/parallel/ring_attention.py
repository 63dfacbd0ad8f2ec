"""Single-device attention of the PyTorch port (see
``mmlspark_tpu/parallel/ring_attention.py``).

``attention`` routes as the JAX package does on its accelerator, on every
device: integer offsets with both sequences at least ``FLASH_MIN_LEN``
long go to ``ops.flash_attention`` (the CUDA kernel on the card, its
plain version on the CPU); the rest go to ``dense_attention``, one
einsum over the full score matrix. The sequence-parallel schemes (ring,
Ulysses) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from mmlspark_tpu_torch.ops.flash_attention import NEG_INF, flash_attention

# sequences at least this long take the flash kernel; below it, one
# dense einsum is cheaper than the kernel's grid
FLASH_MIN_LEN = 512


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, q_offset: int = 0,
                    k_offset: int = 0) -> torch.Tensor:
    """The dense path: float32 scores over every (query, key) pair. Rows
    whose keys are all masked (shard offsets can produce them) give 0,
    as the flash kernel's l == 0 rows do."""
    scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if causal:
        p = torch.where(mask.any(-1)[:, None], p, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, q_offset: int = 0,
              k_offset: int = 0) -> torch.Tensor:
    """Plain (single-device) attention: q ``(B, Lq, H, D)``, k / v
    ``(B, Lk, H, D)``; offsets give global positions for causal masking
    of sequence shards."""
    if (isinstance(q_offset, int) and isinstance(k_offset, int)
            and q.shape[1] >= FLASH_MIN_LEN
            and k.shape[1] >= FLASH_MIN_LEN):
        return flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               k_offset=k_offset)
    return dense_attention(q, k, v, causal, q_offset, k_offset)


def ring_attention(*args, **kwargs):
    raise NotImplementedError(
        "ring attention over a sharded sequence is not ported yet: "
        "ROADMAP.md, 'Long context'")


def ulysses_attention(*args, **kwargs):
    raise NotImplementedError(
        "Ulysses attention over a sharded sequence is not ported yet: "
        "ROADMAP.md, 'Long context'")
