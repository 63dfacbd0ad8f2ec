"""JAX's threefry random bits, reproduced bit for bit in PyTorch.

The JAX package draws its bagging, feature-fraction and stochastic-
rounding uniforms with ``jax.random`` (``PRNGKey``, ``fold_in``,
``uniform``) under ``jax_threefry_partitionable``; a forest depends on
every one of those bits, so the port computes the same function here:

  - ``PRNGKey(seed)``: the key (0, seed mod 2**32) of a 32-bit seed;
  - ``fold_in(key, data)``: threefry2x32 of ``key`` over the counter pair
    (0, data);
  - ``uniform(key)``: one float32 in [0, 1) from a key of shape (): the
    32 bits ``x0 ^ x1`` of threefry2x32 over the counter pair (0, 0),
    whose top 23 become the mantissa of a float in [1, 2), minus 1.

A key is a pair of uint32 values held as Python ints, or as int64
tensors when many keys are derived at once (``_index_uniforms`` folds
one key with a tensor of ids). Torch's uint32 has few operations,
fewer still on the card, so the 32-bit arithmetic runs in int64 with
``& 0xFFFFFFFF`` after each add and shift: integer ops only, so the CPU
and the card give the same bits.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

Word = Union[int, torch.Tensor]
Key = Tuple[Word, Word]

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3F800000      # float32 1.0


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0: Word, k1: Word, x0: Word, x1: Word) -> Key:
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x0, x1)
    under the key (k0, k1); every argument a uint32 value as an int or
    an int64 tensor, broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: (0, seed mod
    2**32)."""
    return 0, int(seed) & _MASK


def fold_in(key: Key, data: Word) -> Key:
    """``jax.random.fold_in(key, data)``: data (an int or an integer
    tensor) taken mod 2**32."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _MASK
    else:
        data = int(data) & _MASK
    return threefry2x32(key[0], key[1], 0, data)


def uniform(key: Key) -> torch.Tensor:
    """``jax.random.uniform(key)`` (float32 in [0, 1)) for a key of shape
    (), or elementwise for a key of int64 tensors: the partitionable
    scheme's 32 bits ``x0 ^ x1`` over the counter pair (0, 0)."""
    x0, x1 = threefry2x32(key[0], key[1], 0, 0)
    bits = x0 ^ x1
    if not isinstance(bits, torch.Tensor):
        bits = torch.tensor(bits, dtype=torch.int64)
    mant = ((bits >> 9) | _ONE_BITS).to(torch.int32)
    return mant.view(torch.float32) - 1.0
