"""Numpy tables, the scalar Hamming distance and the numpy hashes the
port needs.

Copies of ``cbird_tpu/ops/ref_numpy.py`` ``zigzag_table``,
``dct2_matrix``, ``hamming64`` and the golden hashes ``dct_hash64`` (the
template matcher's verify step) and ``average_hash64`` (the model of
``ops/dct_hash.py`` ``average_hash_batch``) with the helpers they call
(``reflect101``, ``mean_blur``, ``area_resize``, ``blur_kernel_size``);
the rest of that module is the JAX package's golden model, which the
tests import from there.  All intermediate math is float64, and
INTER_AREA resize is the exact box-overlap integral at every scale.
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


def reflect101(i: np.ndarray, n: int) -> np.ndarray:
    """OpenCV BORDER_REFLECT_101 index mapping (gfedcb|abcdefgh|gfedcba)."""
    i = np.asarray(i)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * n - 2
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


def mean_blur(img: np.ndarray, k: int) -> np.ndarray:
    """k×k normalized box filter with BORDER_REFLECT_101 (cv::blur default)."""
    if k <= 1:
        return img.astype(np.float64)
    r = k // 2
    h, w = img.shape
    x = img.astype(np.float64)
    ys = reflect101(np.arange(-r, h + r), h)
    xs = reflect101(np.arange(-r, w + r), w)
    padded = x[np.ix_(ys, xs)]
    out = np.zeros((h, w), dtype=np.float64)
    for dy in range(k):
        for dx in range(k):
            out += padded[dy:dy + h, dx:dx + w]
    return out / (k * k)


def area_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Box-overlap (INTER_AREA) resize: dst pixel = mean over its source box."""
    h, w = img.shape
    x = img.astype(np.float64)

    def axis_matrix(n_in: int, n_out: int) -> np.ndarray:
        s = n_in / n_out
        m = np.zeros((n_out, n_in))
        for i in range(n_out):
            lo, hi = i * s, (i + 1) * s
            for j in range(int(np.floor(lo)), min(int(np.ceil(hi)), n_in)):
                m[i, j] = max(0.0, min(hi, j + 1) - max(lo, j)) / s
        return m

    rh = axis_matrix(h, out_h)
    rw = axis_matrix(w, out_w)
    return rh @ x @ rw.T


def dct2_matrix(n: int = 32) -> np.ndarray:
    """Orthonormal DCT-II matrix (cv::dct convention)."""
    k = np.arange(n)[:, None].astype(np.float64)
    m = np.arange(n)[None, :].astype(np.float64)
    d = np.cos(np.pi * (2 * m + 1) * k / (2 * n))
    d[0] *= np.sqrt(1.0 / n)
    d[1:] *= np.sqrt(2.0 / n)
    return d


_ZZ = zigzag_table(9)
_D32 = dct2_matrix(32)


def blur_kernel_size(area: int) -> int:
    """Size-adaptive mean blur (reference src/cvutil.cpp:446-455)."""
    if area <= 32 * 32:
        return 0
    if area <= 64 * 64:
        return 3
    if area <= 128 * 128:
        return 5
    return 7


def dct_hash64(gray: np.ndarray) -> int:
    """64-bit perceptual DCT hash (reference dctHash64, src/cvutil.cpp:435-545).

    grayscale → size-adaptive mean blur (7/5/3/0 by area) → 32×32 INTER_AREA
    resize → float DCT → keep 9×9 low frequencies → zig-zag reorder → drop the
    6 lowest + keep 64 → threshold at mean → sign bitmask (bit 0 reserved so
    0 can mean "null hash").
    """
    gray = np.asarray(gray)
    assert gray.ndim == 2
    h, w = gray.shape
    k = blur_kernel_size(h * w)
    x = mean_blur(gray, k)
    x = area_resize(x, 32, 32)
    freq = _D32 @ x @ _D32.T
    blk = freq[:9, :9].reshape(-1)
    zz = blk[_ZZ]
    v = zz[6:70]  # 64 coefficients
    thresh = v.sum() / 64.0
    hash_ = 0
    for i in range(1, 64):
        if v[i] > thresh:
            hash_ |= 1 << i
    if hash_ == 0:
        hash_ = 1
    return hash_


def average_hash64(img: np.ndarray) -> int:
    """8×8 mean-threshold aHash (reference src/cvutil.cpp:564-576; parity only,
    not used in the main path). Uses area resize instead of INTER_CUBIC."""
    g = area_resize(np.asarray(img, dtype=np.float64), 8, 8).reshape(-1)
    mean = g.mean()
    h = 0
    for i in range(64):
        if g[i] > mean:
            h |= 1 << i
    return h


def hamming64(a: int, b: int) -> int:
    """XOR+popcount distance (reference src/hamm.h:24-26)."""
    return bin((a ^ b) & 0xFFFFFFFFFFFFFFFF).count("1")
