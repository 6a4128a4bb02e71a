"""The bits of ``jax.random`` (threefry2x32), reproduced in torch.

The JAX package draws its RANSAC hypotheses from ``jax.random``
(``ops/features/ransac.py``: ``split(PRNGKey(_SEED), P)`` and ``uniform``
per pair), so the same samples need the same bits.  The port cannot import
jax; this module recomputes them bit for bit under jax's defaults
(``jax_default_prng_impl=threefry2x32``, ``jax_threefry_partitionable=True``,
64-bit types disabled):

  * ``prng_key(seed)``: the raw key (0, seed mod 2^32) of an int32 seed;
  * ``split(key, num)``: keys i = threefry2x32(key, (0, i));
  * ``uniform(keys, shape)``: per key, 32-bit words
    bits1 ^ bits2 of threefry2x32(key, (hi, lo) of the flat index), their
    top 23 bits as the mantissa of a float in [1, 2), minus 1.

Words are carried in int64 with ``& 0xFFFFFFFF`` after every add and shift
(torch's uint32 arithmetic is incomplete), so the draws are the same on
the CPU and on the card.  tests/test_torch_prng.py holds them equal to
``jax.random``.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key words (k1, k2): int64 tensors (or ints) holding uint32 values,
    broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 (2,) tensor: (0, seed mod
    2^32) for an int32 seed (jax's seed without 64-bit types)."""
    if not -(1 << 31) <= seed < (1 << 31):
        raise OverflowError(f"seed {seed} is outside int32")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> (num, 2) int64 keys."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([a, b], dim=-1)


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit words of ``jax.random.bits`` for each of the (..., 2) keys ->
    int64 (..., *shape)."""
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    k1 = keys[..., 0, None]
    k2 = keys[..., 1, None]
    a, b = threefry2x32(k1, k2, i >> 32, i & _M32)
    return (a ^ b).reshape(*keys.shape[:-1], *shape)


def uniform(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1)) for each of
    the (..., 2) keys -> (..., *shape)."""
    bits = random_bits(keys, shape)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp_min(mant.view(torch.float32) - 1.0, 0.0)
