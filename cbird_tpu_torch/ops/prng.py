"""JAX's threefry2x32 random draws in int64 torch ops.

The color descriptor's k-means++ seeding (``ops/color.py``) draws from
``jax.random`` in the JAX package: ``fold_in(PRNGKey(12345), seed)``, then
``split`` and ``gumbel`` (``cbird_tpu/ops/color.py:89-118,178``).  The port
imports no JAX, so this module computes the same words: threefry2x32 with
JAX's 20 rounds and key schedule (``jax/_src/prng.py`` ``threefry2x32``),
``fold_in`` through ``threefry_seed`` (:802-827, :1163-1169), ``split``
and 32-bit ``random_bits`` in their partitionable form
(``jax_threefry_partitionable=True``: ``iota_2x32_shape`` counters,
:1156-1160, :1184-1200), ``uniform`` (mantissa bits OR'd into 1.0,
``jax/_src/random.py:435-480``) and ``gumbel`` in mode ``"low"``
(:1723-1735).  Nothing else of ``jax.random`` is here.

Torch has no uint32 arithmetic worth trusting, so a word is an int64
holding 0..2^32-1, masked to 32 bits after every add.  A key is a pair
``(k1, k2)`` of int64 tensors of one shape (a batch of keys); the words
are bit-equal to ``jax.random.key_data``'s.

The two ``log`` of ``gumbel`` are not XLA's: each is taken in float64 and
rounded to float32, so the CPU and the card give the same floats.  XLA's
CPU ``log`` is within 1 ulp of that; the gumbel floats then differ from
JAX's by at most ``GUMBEL_ATOL`` (``tests/test_torch_color.py`` measures
it).
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
TINY = 1.1754943508222875e-38  # float32's smallest normal: gumbel's minval
# |gumbel - JAX's gumbel|: one float32 ulp of the largest gumbels (8 to
# 16.6), the worst over 5 x 2^19 draws on the CPU
# (tests/test_torch_color.py::test_gumbel_matches_jax)
GUMBEL_ATOL = 2.0 ** -20


def threefry2x32(k1, k2, x0, x1):
    """JAX's threefry2x32 hash of the counter pairs (x0, x1) under key
    (k1, k2); all int64 words in 0..2^32-1, broadcast together.
    @return (y0, y1)"""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    x0, x1 = torch.broadcast_tensors(x0, x1)
    x0, x1 = x0.contiguous(), x1.contiguous()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:  # in place: these are fresh tensors
            x0.add_(x1).bitwise_and_(MASK)
            hi = x1 >> (32 - r)  # rotate left by r
            x1.bitwise_left_shift_(r).bitwise_and_(MASK).bitwise_or_(hi)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK)
    return x0, x1


def _word(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int64, device=device) & MASK


def prng_key(seed: int, device=None):
    """``jax.random.PRNGKey(seed)`` for a seed in 0..2^32-1: the key
    (0, seed), as ``threefry_seed`` pads a 32-bit seed."""
    return _word(0, device), _word(seed, device)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)`` for uint32 ``data`` (a tensor of
    words, one per key): threefry2x32(key, threefry_seed(data)), the
    counter pair (0, data)."""
    k1, k2 = key
    data = _word(data, k1.device)
    return threefry2x32(k1, k2, torch.zeros_like(data), data)


def split(key):
    """``jax.random.split(key)`` (two keys), partitionable form: counters
    (0, 0) and (0, 1); key i is (bits1[i], bits2[i]).
    @return (key0, key1)"""
    k1, k2 = key
    zero = torch.zeros_like(k1)
    a0, a1 = threefry2x32(k1, k2, zero, zero)
    b0, b1 = threefry2x32(k1, k2, zero, zero + 1)
    return (a0, a1), (b0, b1)


def random_bits(key, n: int) -> torch.Tensor:
    """32-bit ``random_bits`` of shape (n,) for each key: bits1 ^ bits2
    over the counters (0, i), i < n < 2^32.  @return [*key shape, n]"""
    k1, k2 = key
    lo = torch.arange(n, dtype=torch.int64, device=k1.device)
    y0, y1 = threefry2x32(k1[..., None], k2[..., None],
                          torch.zeros_like(lo), lo)
    return y0 ^ y1


def uniform(key, n: int, minval: float = 0.0) -> torch.Tensor:
    """float32 ``uniform(key, (n,), minval=minval, maxval=1)``: the top 23
    bits OR'd into 1.0's pattern, minus 1, scaled, then max(minval, .)."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    scale = torch.tensor(1.0, dtype=torch.float32,
                         device=floats.device) - lo
    return torch.maximum(lo, floats * scale + lo)


def log32(x: torch.Tensor) -> torch.Tensor:
    """float32 log of float32 ``x``, taken in float64 and rounded: the
    same floats on the CPU and the card."""
    return torch.log(x.double()).float()


def gumbel(key, n: int) -> torch.Tensor:
    """float32 ``gumbel(key, (n,))``, mode "low": -log(-log(u)) of
    ``uniform(minval=tiny)``.  @return [*key shape, n]"""
    return -log32(-log32(uniform(key, n, TINY)))
