"""Counter-based threefry2x32 draws, bit-identical to ``jax.random``.

The dense round of the reference draws its move gates with
``jax.random.uniform`` (threefry2x32 with ``jax_threefry_partitionable``).
This module rebuilds that generator from its definition so the port's
dense round, and with it ``partition(refine_engine="dense")``, makes the
reference's moves bit for bit:

* ``PRNGKey(s)`` is the pair ``(0, s)``;
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
* the 32 bits of flat element ``i`` are ``b1 ^ b2`` with
  ``(b1, b2) = threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``;
* the float is ``bitcast_f32((bits >> 9) | 0x3F800000) - 1``.

uint32 arithmetic runs on int64 tensors masked to 32 bits (torch on the CPU
has no uint32 right shift).  Keys are pairs of python ints.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["fold_in", "prng_key", "random_bits", "threefry2x32", "uniform"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(key: Key, x0, x1):
    """The 20-round Threefry-2x32 block function on a counter pair; works on
    python ints and on int64 tensors holding uint32 values."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed."""
    return (0, int(seed) & _M32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key, 0, int(data) & _M32)


def random_bits(key: Key, numel: int, device) -> torch.Tensor:
    """32 random bits per flat element (int64 tensor of uint32 values)."""
    i = torch.arange(numel, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key, i >> 32, i & _M32)
    return b1 ^ b2


def uniform(key: Key, shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32, in [0, 1)."""
    numel = 1
    for s in shape:
        numel *= int(s)
    bits = (random_bits(key, numel, device) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(shape)
