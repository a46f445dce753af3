"""Numpy tables and the scalar Hamming distance the port needs.

Copies of ``cbird_tpu/ops/ref_numpy.py`` ``zigzag_table``, ``dct2_matrix``
and ``hamming64`` (the rest of that module is the JAX package's golden
model, which the tests import from there).
"""

from __future__ import annotations

import numpy as np


def zigzag_table(n: int = 9) -> np.ndarray:
    """Zig-zag traversal order of an n×n block, starting downward.

    Generates the 81-entry table used by the reference dctHash64
    (src/cvutil.cpp:491-496): anti-diagonals s=0..2n-2;
    odd diagonals walk bottom-left → top-right, even diagonals walk
    top-right → bottom-left.
    """
    order = []
    for s in range(2 * n - 1):
        if s % 2 == 1:  # (s,0) ... (0,s) — up-right
            rng = range(min(s, n - 1), max(0, s - n + 1) - 1, -1)
        else:  # (0,s) ... (s,0) — down-left
            rng = range(max(0, s - n + 1), min(s, n - 1) + 1)
        for r in rng:
            c = s - r
            order.append(r * n + c)
    return np.array(order, dtype=np.int64)


def dct2_matrix(n: int = 32) -> np.ndarray:
    """Orthonormal DCT-II matrix (cv::dct convention)."""
    k = np.arange(n)[:, None].astype(np.float64)
    m = np.arange(n)[None, :].astype(np.float64)
    d = np.cos(np.pi * (2 * m + 1) * k / (2 * n))
    d[0] *= np.sqrt(1.0 / n)
    d[1:] *= np.sqrt(2.0 / n)
    return d


def hamming64(a: int, b: int) -> int:
    """XOR+popcount distance (reference src/hamm.h:24-26)."""
    return bin((a ^ b) & 0xFFFFFFFFFFFFFFFF).count("1")
