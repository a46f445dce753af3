"""Port parity of the color algorithm (``-p.alg color``):
``cbird_tpu_torch.ops.prng`` / ``ops.color`` / ``ops.color_scores`` /
``index.color_desc_index`` against ``cbird_tpu.ops.color`` and its index
on the JAX CPU backend, and the port's CLI verbs that waited on color.

Tolerances, each with its cause:

- threefry words: bit-equal.  Gumbel floats: within ``prng.GUMBEL_ATOL``
  (2^-20, one float32 ulp of the largest gumbels), as each ``log`` is
  float64 rounded where XLA's float32 ``log`` is within 1 ulp of it.
- ``rgb_to_luv``: equal but where the cube root differs by an ulp (XLA's
  ``pow`` by float32(1/3) against float64 rounded).
- descriptors: equal, or a quantized coordinate or weight off by 1 whose
  float lies on a quantization edge (a center or a weight sum an ulp
  from XLA's: XLA's float32 cluster sums against the port's exact ones,
  and the cube root).
- scores: bit-equal.  XLA's CPU contracts d2 as ``fma(dv, dv, fma(dl,
  dl, du * du))`` and sums the minima in ascending color order; the port
  does the same with an fma rounded once (``ops/exact32.py``).
"""

import contextlib
import io
import json
import os
import sqlite3
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbird_tpu.index.color_desc_index import ColorDescIndex as JaxIndex
from cbird_tpu.ops import color as jc
from cbird_tpu.ops import hamming as jh
from cbird_tpu.params import SearchParams as JaxParams
from cbird_tpu.store.media import Media as JaxMedia
from cbird_tpu_torch.cli import main as port_cli
from cbird_tpu_torch.index.color_desc_index import ColorDescIndex
from cbird_tpu_torch.ops import color as pc
from cbird_tpu_torch.ops import color_scores as cs
from cbird_tpu_torch.ops import exact32
from cbird_tpu_torch.ops import prng
from cbird_tpu_torch.params import SearchParams
from cbird_tpu_torch.store.media import Media

from fixtures import make_corpus

torch.set_num_threads(1)

SEEDS = (0, 1, 12345, 2**31 + 5, 0xFFFFFFFF)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("CBIRD_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(jh, "_MESH", None)  # single-device reference


def color_image(rng, h, w, n_patches=8):
    """Solid color patches on a colored ground (``tests/test_color.py``'s
    ``_color_image``)."""
    img = np.zeros((h, w, 3), dtype=np.uint8)
    img[..., 0], img[..., 1], img[..., 2] = 40, 90, 150
    for _ in range(n_patches):
        y, x = rng.integers(0, h - h // 5), rng.integers(0, w - w // 5)
        hh, ww = rng.integers(h // 8, h // 3), rng.integers(w // 8, w // 3)
        img[y:y + hh, x:x + ww] = rng.integers(30, 255, size=3)
    return img


def images(canvas: int, n: int, seed: int):
    """Patch images and noise images of 1/2 to 1 canvas a side."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(canvas // 2, canvas + 1, 2))
        out.append(color_image(rng, h, w) if i % 2 == 0 else
                   rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    return out


# ---- threefry ---------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_words_match_jax(seed):
    """PRNGKey, fold_in, split and 32-bit random_bits: the words of
    ``jax.random`` bit for bit (partitionable threefry)."""
    assert jax.config.jax_threefry_partitionable
    words = lambda k: tuple(int(w) for w in np.asarray(jax.random.key_data(k)))
    port = lambda k: (int(k[0]), int(k[1]))
    assert port(prng.prng_key(seed)) == words(jax.random.PRNGKey(seed))
    jk = jax.random.fold_in(jax.random.PRNGKey(12345), np.uint32(seed))
    pk = prng.fold_in(prng.prng_key(12345), seed)
    assert port(pk) == words(jk)
    for _ in range(3):
        jk, jsub = jax.random.split(jk)
        pk, psub = prng.split(pk)
        assert port(pk) == words(jk) and port(psub) == words(jsub)
    bits = np.asarray(jax.random.bits(jsub, (4099,), dtype=jnp.uint32))
    assert np.array_equal(prng.random_bits(psub, 4099).numpy(),
                          bits.astype(np.int64))


def test_threefry_batches_keys():
    """A batch of keys gives each key's own words."""
    data = torch.tensor(SEEDS, dtype=torch.int64)
    k1, k2 = prng.fold_in(prng.prng_key(12345), data)
    for i, seed in enumerate(SEEDS):
        one = prng.fold_in(prng.prng_key(12345), seed)
        assert (int(k1[i]), int(k2[i])) == (int(one[0]), int(one[1]))
    bits = prng.random_bits((k1, k2), 100)
    assert torch.equal(bits[3], prng.random_bits(
        prng.fold_in(prng.prng_key(12345), SEEDS[3]), 100))


def test_gumbel_matches_jax():
    """Gumbel floats within GUMBEL_ATOL of ``jax.random.gumbel`` over
    2^19 draws of each seed's key (the measured worst is 2^-20)."""
    worst = 0.0
    for seed in SEEDS:
        jk = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(12345),
                                                 np.uint32(seed)))[1]
        pk = prng.split(prng.fold_in(prng.prng_key(12345), seed))[1]
        want = np.asarray(jax.random.gumbel(jk, (1 << 19,)))
        got = prng.gumbel(pk, 1 << 19).numpy()
        assert got.dtype == np.float32
        worst = max(worst, float(np.abs(got - want).max()))
    assert worst <= prng.GUMBEL_ATOL


# ---- descriptor half ----------------------------------------------------------

def test_rgb_to_luv_grid():
    """A 16^3 RGB grid and every grey: equal to the JAX package's but where
    the cube root differs by an ulp (L by <= 2 ulps, u and v by what 13*L
    carries)."""
    g = np.arange(16, dtype=np.float32) * 17
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    grey = np.repeat(np.arange(256, dtype=np.float32)[:, None], 3, 1)
    rgb = np.concatenate([grid, grey]) * np.float32(1 / 256)
    want = np.asarray(jax.jit(jc.rgb_to_luv)(rgb))
    got = pc.rgb_to_luv(torch.from_numpy(rgb)).numpy()
    diff = np.any(got != want, axis=1)
    assert diff.mean() < 0.002, diff.sum()
    assert np.abs(got[:, 0] - want[:, 0]).max() <= 1.6e-5
    assert np.allclose(got, want, rtol=0, atol=6e-5)


def _edge(scaled: float) -> float:
    """Distance of a float to the nearest uint16 truncation edge."""
    return abs(scaled - round(scaled))


_COORD_SCALE = (lambda c: c[0] * (pc._U16 / 100.0),
                lambda c: (c[1] + 134.0) * (pc._U16 / 354.0),
                lambda c: (c[2] + 140.0) * (pc._U16 / 262.0))


def _named_differences(want, got, raw):
    """Each differing entry of two descriptors, with its cause; raises on
    a difference that no quantization edge explains.  ``raw`` is the
    port's (centers, label_w, label_n) of the image."""
    if want is None or got is None:
        assert want is None and got is None
        return []
    assert want[pc.NUM_COLORS, 0] == got[pc.NUM_COLORS, 0]
    centers, label_w, label_n = raw
    q = pc.quantize_luv(centers)
    freq: dict = {}
    for k in range(pc.NUM_COLORS):
        if label_n[k] > 0:
            key = tuple(int(v) for v in q[k])
            freq.setdefault(key, [0.0, []])
            freq[key][0] += float(label_w[k])
            freq[key][1].append(k)
    max_freq = max(f for f, _ in freq.values())
    out = []
    for r, c in np.argwhere(want != got):
        assert r < pc.NUM_COLORS and abs(int(want[r, c]) - int(got[r, c])) == 1
        key = tuple(int(v) for v in got[r, :3])
        f, ks = freq[key]
        if c < 3:  # a center an ulp or two from XLA's
            edge = min(_edge(_COORD_SCALE[c](centers[k])) for k in ks)
            assert edge < 0.02, (r, c, edge)
        else:  # weight sums ~1e-6 relative from XLA's float32 ones
            w = f * pc._U16 / max_freq
            edge = _edge(w)
            assert edge < 1e-6 * w + 1e-3, (r, c, edge)
        out.append((int(r), "luv"[c] if c < 3 else "w", round(edge, 5)))
    return out


@pytest.mark.parametrize("canvas,n", [(64, 6), (256, 2)])
def test_descriptors_match_jax(canvas, n):
    """Descriptors of patch and noise images equal the JAX package's, or
    differ by 1 at a quantization edge (each such difference is named)."""
    imgs = images(canvas, n, seed=canvas)
    want = jc.create_descriptors(imgs, canvas=canvas)
    got = pc.create_descriptors(imgs, canvas=canvas)
    named = []
    for i, im in enumerate(imgs):
        cv = np.zeros((1, canvas, canvas, 3), np.uint8)
        cv[0, :im.shape[0], :im.shape[1]] = im
        seed = int(np.sum(im, dtype=np.uint64) & 0xFFFFFFFF)
        raw = pc._descriptor_batch(torch.from_numpy(cv),
                                   torch.tensor([im.shape[:2]]),
                                   pc.seeding_keys(torch.tensor([seed])))
        raw = [a[0].numpy() for a in raw[:3]]
        named += [(i, *d) for d in _named_differences(want[i], got[i], raw)]
    assert sum(d is not None for d in got) >= n // 2
    # a few edge cases at most (these images: one L coordinate at canvas
    # 64, one weight at canvas 256)
    assert len(named) <= 3, named


def test_batch_equals_solo():
    """A descriptor computed in a batch equals the image's alone (each image
    stops at its own iteration count), also across launches of
    ``_SAMPLES_PER_LAUNCH`` pixels."""
    imgs = images(64, 5, seed=3)
    imgs.insert(2, None)  # grey media: no descriptor
    imgs.append(np.zeros((40, 40, 3), np.uint8))  # all dark: none
    batch = pc.create_descriptors(imgs, canvas=64)
    assert batch[2] is None and batch[-1] is None
    for im, d in zip(imgs, batch):
        solo = pc.create_descriptors([im], canvas=64)[0]
        assert (d is None and solo is None) or np.array_equal(d, solo)
    old = pc._SAMPLES_PER_LAUNCH
    try:
        pc._SAMPLES_PER_LAUNCH = 2 * 64 * 64  # launches of two images
        split = pc.create_descriptors(imgs, canvas=64)
    finally:
        pc._SAMPLES_PER_LAUNCH = old
    for a, b in zip(batch, split):
        assert (a is None and b is None) or np.array_equal(a, b)


def test_lloyd_stops_per_image():
    """Images converge at different iteration counts: each keeps its own
    centers (the batched loop steps only the images still moving)."""
    imgs = images(64, 4, seed=9)
    b = len(imgs)
    cv = np.zeros((b, 64, 64, 3), np.uint8)
    for i, im in enumerate(imgs):
        cv[i, :im.shape[0], :im.shape[1]] = im
    luv = pc.rgb_to_luv(torch.from_numpy(cv).float() / 256).reshape(b, -1, 3)
    mask = luv[..., 0] > 4
    keys = pc.seeding_keys(torch.arange(b))
    centers, labels = pc._kmeans(luv, mask, keys)
    for i in range(b):
        one = pc._kmeans(luv[i:i + 1], mask[i:i + 1],
                         (keys[0][:, i:i + 1], keys[1][:, i:i + 1]))
        assert torch.equal(one[0][0], centers[i])
        assert torch.equal(one[1][0], labels[i])


# ---- search half --------------------------------------------------------------

def store_data(n: int, seed: int, dups: int = 0):
    """Random quantized descriptors: counts 0/1/2/3/28-32, 10% invalid,
    ``dups`` rows copied from (or jittered off) earlier rows."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 65536, (n, 32, 3)).astype(np.uint16)
    counts = rng.choice([0, 1, 2, 3, 28, 29, 30, 31, 31, 31, 32], n)
    for j in range(dups):
        src, dst = rng.integers(0, n // 2), rng.integers(n // 2, n)
        q[dst] = q[src] + rng.integers(0, 3, (32, 3)).astype(np.uint16)
        counts[dst] = counts[src] + rng.integers(-1, 2) if counts[src] else 0
    colors = jc.dequantize_luv(q).astype(np.float32)
    valid = rng.random(n) > 0.1
    return colors, np.clip(counts, 0, 32).astype(np.int32), valid


def _jax_scores(nc, nn, hc, hn, hv, side="both"):
    if side == "both":
        return np.asarray(jax.jit(jc._color_scores)(nc, nn, hc, hn, hv))
    fn = jax.jit(jc._color_scores_oneside, static_argnames="side")
    return np.asarray(fn(nc, nn, hc, hn, hv, side=side))


@pytest.mark.parametrize("side", ["both", "ab", "ba"])
def test_plain_scores_match_jax(side):
    """K6's plain twin against ``_color_scores`` / ``_color_scores_oneside``
    (the latter with color_self_block's mask: a row window, counts > 0):
    counts 0, 1, 28-32, |difference| 2 and 3, invalid rows; the same
    rejections, scores bit-equal."""
    nc, nn, _ = store_data(9, seed=1)
    nn[:4] = (0, 1, 30, 31)
    hc, hn, hv = store_data(200, seed=2)
    hn[:6] = (0, 1, 29, 33 - 1, 28, 31)  # |31 - 28| = 3, |30 - 28| = 2
    lo, hi, base = (0, 1 << 40, 0) if side == "both" else (37, 161, 5)
    rows = base + np.arange(200)
    hv_j = hv if side == "both" else \
        hv & (hn > 0) & (rows >= lo) & (rows < hi)
    want = _jax_scores(nc, nn, hc, hn, hv_j, side)
    got = cs.color_scores_plain(*map(torch.from_numpy, (nc, nn, hc, hn, hv)),
                                side=side, lo=lo, hi=hi, base=base).numpy()
    bad = want >= cs.BAD_SCORE
    assert np.array_equal(bad, got >= cs.BAD_SCORE)
    assert 0 < bad.sum() < bad.size
    assert np.array_equal(got, want)
    # the wrapper runs the plain twin on CPU tensors, into a wider buffer
    buf = torch.zeros((9, 210))
    cs.color_scores(*map(torch.from_numpy, (nc, nn, hc, hn, hv)), side=side,
                    lo=lo, hi=hi, base=base, out=buf)
    assert torch.equal(buf[:, :200], torch.from_numpy(got))


@pytest.mark.parametrize("n,k", [(300, 20), (50, 80)])
def test_color_topk_matches_jax(n, k):
    """``color_topk`` at chunk 64: several chunks and a ragged last one
    (300 rows), and k past the rows (50 rows, one top-k): row indices
    and scores equal, BAD slots included."""
    nc, nn, _ = store_data(7, seed=3)
    nn[:3] = (0, 31, 30)
    hc, hn, hv = store_data(n, seed=4, dups=n // 10)
    hn[3], hv[3] = hn[3] or 31, True  # rows 3 and n/2 copies of needle 1:
    hc[n // 2], hn[n // 2], hv[n // 2] = hc[3], hn[3], True  # tied at 1
    nc[1], nn[1] = hc[3], hn[3]
    js, ji = (np.asarray(a) for a in jc.color_topk(nc, nn, hc, hn, hv, k=k,
                                                   chunk=64))
    ps, pi = pc.color_topk(*map(torch.from_numpy, (nc, nn, hc, hn, hv)),
                           k=k, chunk=64)
    assert np.array_equal(pi.numpy(), ji)
    assert np.array_equal(ps.numpy(), js)


def _round32(x: Fraction) -> np.float32:
    """The float32 nearest an exact rational, ties to even."""
    f = np.float32(float(x))
    near = (f, np.nextafter(f, np.float32(np.inf)),
            np.nextafter(f, np.float32(-np.inf)))
    return min(near, key=lambda v: (abs(Fraction(float(v)) - x),
                                    int(np.array(v).view(np.int32)) & 1))


def test_exact32_rounds_once():
    """``fma32``, in its sparse and its dense form, equals ``a * b + c``
    taken exactly (``Fraction``) and rounded once to float32: on random
    triples of mixed magnitudes and signs (results in float32's normal
    range, its domain) and on triples whose float64 sum lies on a float32
    midpoint (c with an odd last bit, a * b half its ulp less 2^-46 of
    that), where the float64 sum rounded again to float32 is an ulp off.
    ``sqrt32`` is the float32 nearest the root."""
    rng = np.random.default_rng(11)
    n, m = 2000, 500
    a, b, c = ((rng.standard_normal(n) * rng.choice(sc, n)).astype(np.float32)
               for sc in ([1e-3, 1, 1e3], [1e-3, 1, 1e3], [1e-6, 1, 1e6]))
    sign = rng.choice([-1, 1], m).astype(np.float32)
    c_mid = np.abs(rng.standard_normal(m) * rng.choice([1e-3, 1, 1e3], m))
    c_mid = (c_mid.astype(np.float32).view(np.int32) | 1).view(np.float32)
    ulp = np.nextafter(c_mid, np.float32(np.inf)) - c_mid
    a_mid = (ulp / 2 * np.float32(1 + 2**-23) * sign).astype(np.float32)
    b_mid = np.full(m, 1 - 2**-23, np.float32)
    c_mid = c_mid * sign
    a, b, c = (np.concatenate(v) for v in ((a, a_mid), (b, b_mid),
                                           (c, c_mid)))
    want = np.array([_round32(Fraction(float(x)) * Fraction(float(y))
                              + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    ops = exact32._operands(*map(torch.from_numpy, (a, b, c)))
    for form in (exact32._fma32_sparse, exact32._fma32_dense):
        got = form(*ops).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(exact32.fma32(*map(torch.from_numpy,
                                             (a, b, c))).numpy(), want)
    twice = (a[n:].astype(np.float64) * b[n:] + c[n:]).astype(np.float32)
    assert not np.any(twice == want[n:])
    want = _round32(Fraction(float(np.float32(0.1))) * 3 / 2 + 1)
    for form in (exact32._fma32_sparse, exact32._fma32_dense):
        ops = exact32._operands(0.1, torch.full((3,), 1.5), 1.0)
        got = form(*ops)  # Python numbers as float32, the result float32
        assert got.dtype == torch.float32 and got.shape == (3,)
        assert (got == float(want)).all()
    x = (rng.random(n) * rng.choice([1e-4, 1, 1e4], n)).astype(np.float32)
    r = exact32.sqrt32(torch.from_numpy(x)).numpy()
    for v, rv in zip(x, r):  # the root lies within half an ulp of r
        half = Fraction(float(np.nextafter(rv, np.float32(np.inf)) - rv)) / 2
        assert (Fraction(float(rv)) - half) ** 2 <= Fraction(float(v)) \
            <= (Fraction(float(rv)) + half) ** 2


def _padded_sums(nc, nn, hc, hn):
    """Both directed sums as K6 takes them: a row's slots at or past its
    count hold its color 0; "ab" the minimum over all 32 slots after each
    needle color, added in order; "ba" 32 column minima over the needle's
    colors, added for j in ascending order, +0.0 for a padded slot.
    @return (s_ab, s_ba) [Q, C]"""
    hc = torch.where(torch.arange(32)[None, :, None] < hn[:, None, None],
                     hc, hc[:, :1])
    s_ab = torch.zeros((len(nc), len(hc)))
    cm = torch.full((len(nc), len(hc), 32), float(cs.BAD_SCORE))
    for i in range(32):
        dl, du, dv = (nc[:, i, k][:, None, None] - hc[None, :, :, k]
                      for k in range(3))
        d2 = exact32.fma32(dv, dv, exact32.fma32(dl, dl, du * du))
        on = (i < nn)[:, None]
        s_ab = torch.where(on, s_ab + cs._finish(d2.amin(2)), s_ab)
        cm = torch.where(on[..., None], torch.minimum(cm, d2), cm)
    f = torch.where(torch.arange(32) < hn[:, None], cs._finish(cm), 0.0)
    s_ba = torch.zeros_like(s_ab)
    for j in range(32):
        s_ba = s_ba + f[:, :, j]
    return s_ab, s_ba


def test_padded_counts_match_jax():
    """Counts 1, 2, 31 and 32 in every warp of rows, rows and needles whose
    32 slots are one color, and 25 rows tied at a needle's best score
    across a chunk edge and the k boundary: K6's plain twin equals the JAX
    package's scores bit for bit (two-sided, "ab", "ba"), so does the
    order of work of the kernel (its padded slots, its sums), and
    ``color_topk`` equals the JAX ``color_topk`` in ids and scores."""
    hc, hn, hv = store_data(96, seed=13)
    hv[:] = True
    hn[:64] = np.tile((1, 2, 31, 32), 16)
    hc[64:72] = hc[64, :1]  # one color in all 32 slots
    hn[64:72] = (1, 2, 5, 31, 32, 32, 30, 3)
    hc[72:], hn[72:] = hc[10], hn[10]  # ties with row 10 (count 31)
    nc, nn, _ = store_data(10, seed=14)
    nn[:] = (1, 2, 31, 32, 32, 5, 31, 2, 31, 32)
    nc[4:6] = nc[4, :1]
    nc[6:8] = hc[64]
    nc[8] = hc[10]
    args = [torch.from_numpy(v) for v in (nc, nn, hc, hn, hv)]
    s_ab, s_ba = _padded_sums(*args[:4])
    for side in ("both", "ab", "ba"):
        want = _jax_scores(nc, nn, hc, hn, hv, side)
        got = cs.color_scores_plain(*args, side=side).numpy()
        assert np.array_equal(got, want), side
        model = 1.0 + (s_ab if side == "ab" else s_ba)
        if side == "both":
            model = torch.where(args[1][:, None] >= args[3][None, :],
                                1.0 + s_ab, 1.0 + s_ba)
        live = got < cs.BAD_SCORE
        assert live.sum() > 200, side
        assert np.array_equal(model.numpy()[live], got[live]), side
    js, ji = (np.asarray(v) for v in jc.color_topk(nc, nn, hc, hn, hv,
                                                   k=16, chunk=32))
    ps, pi = pc.color_topk(*args, k=16, chunk=32)
    assert (js[8] == js[8, 0]).all()  # the tie fills k
    assert np.array_equal(pi.numpy(), ji) and np.array_equal(ps.numpy(), js)


@pytest.mark.parametrize("side", ["ab", "ba"])
def test_color_self_block_matches_jax(side):
    """``color_self_block`` against the jitted JAX one (its chunks' top-k
    in a ``scan``): a 256-row window of a count-sorted store in chunks of
    64, rows outside [lo, hi) masked: the same scores and sorted-order
    indices, bit for bit."""
    hc, hn, hv = store_data(600, seed=15, dups=60)
    order = np.argsort(hn, kind="stable")
    hc, hn, hv = hc[order], hn[order], hv[order]
    nc, nn = hc[500:516].copy(), hn[500:516].copy()
    start, lo, hi = 256, 300, 470
    js, ji = (np.asarray(v) for v in jc.color_self_block(
        nc, nn, hc, hn, hv, np.int32(start), np.int32(lo), np.int32(hi),
        k=12, side=side, super_chunk=256, chunk=64))
    ps, pi = pc.color_self_block(
        *map(torch.from_numpy, (nc, nn, hc, hn, hv)), start, lo, hi, k=12,
        side=side, super_chunk=256, chunk=64)
    assert (js < cs.BAD_SCORE).sum() > 50
    assert np.array_equal(ps.numpy(), js) and np.array_equal(pi.numpy(), ji)


def _descs(colors, counts, valid):
    q = pc.quantize_luv(colors)
    d = np.zeros((len(q), 33, 4), np.uint16)
    d[:, :32, :3] = q
    d[:, :32, 3] = 1000
    d[:, 32, 0] = counts
    return d


def _jax_self(descs, ids, k):
    """Every live store row as a needle through the JAX ``color_topk`` over
    the whole store (not the JAX bucketed path)."""
    n = len(ids)
    colors = jc.dequantize_luv(descs[:, :32, :3]).astype(np.float32)
    counts = descs[:, 32, 0].astype(np.int32)
    valid = ids != 0
    ncnt = np.where(valid, counts, 0).astype(np.int32)
    s, i = (np.asarray(a) for a in jc.color_topk(colors, ncnt, colors,
                                                 counts, valid, k=k))
    out = {}
    for r in range(n):
        hit = s[r] < cs.BAD_SCORE
        if hit.any():
            out[r] = (ids[i[r][hit]], s[r][hit])
    return out


@pytest.fixture(scope="module")
def self_store():
    colors, counts, _ = store_data(300, seed=5, dups=40)
    descs = _descs(colors, counts, None)
    ids = np.arange(1, 301, dtype=np.uint32)
    store = pc.PackedColorStore("cpu")
    store.add(descs, ids)
    store.remove([7, 150, 299])  # tombstones
    return store


@pytest.mark.parametrize("buckets", ["on", "off"])
def test_search_self_matches_jax_topk(self_store, buckets, monkeypatch):
    """The bucketed and the scan ``search_self`` over 300 rows with planted
    near copies and tombstones: the same ids as the JAX ``color_topk`` of
    every row (no cluster holds more than k equal scores, where the
    bucketed path's documented tie order would differ), and the same
    scores."""
    monkeypatch.setenv("CBIRD_COLOR_BUCKETS", buckets)
    k = 12
    got = self_store.search_self(k=k, sparse=True)
    want = _jax_self(self_store.descriptors, self_store.ids, k)
    assert sorted(got) == sorted(want)
    for r, (ids, scores) in want.items():
        assert np.array_equal(got[r][0], ids), r
        assert np.array_equal(got[r][1], scores), r
    dense = self_store.search_self(k=k)
    assert len(dense) == 300 and np.array_equal(dense[5][0], got[5][0])


def test_bucketed_equals_scan(self_store, monkeypatch):
    """Both self-search paths give the same bits."""
    res = {}
    for buckets in ("on", "off"):
        monkeypatch.setenv("CBIRD_COLOR_BUCKETS", buckets)
        res[buckets] = self_store.search_self(k=12, sparse=True)
    assert sorted(res["on"]) == sorted(res["off"])
    for r, (ids, scores) in res["on"].items():
        assert np.array_equal(ids, res["off"][r][0])
        assert np.array_equal(scores, res["off"][r][1])


def _same_matches(port_idx, jax_idx, needles, sp, jsp):
    """find_batch of both indexes: equal ids, the stores' equal float
    scores and equal integer scores (the float truncated)."""
    got = port_idx.find_batch([Media(id=i) for i in needles], sp)
    want = jax_idx.find_batch([JaxMedia(id=i) for i in needles], jsp)
    k = max(sp.maxMatches * 4, 64)
    descs = [port_idx._store.descriptors[i - 1] for i in needles]
    fp = port_idx._store.search(descs, k=k)
    fj = jax_idx._store.search(descs, k=k)
    for g, w, (pi, ps), (ji, js) in zip(got, want, fp, fj):
        assert np.array_equal(pi, ji)
        assert np.array_equal(ps, js)
        assert [m.mediaId for m in g] == [m.mediaId for m in w]
        assert [m.score for m in g] == [m.score for m in w]


def test_index_reads_jax_table(tmp_path):
    """A ``color`` table the JAX ColorDescIndex wrote loads in the port's
    unchanged; find_batch equals the JAX index's, find_all holds each
    row's first maxMatches + 8 of them; remove drops a row from both."""
    colors, counts, _ = store_data(120, seed=6, dups=20)
    descs = _descs(colors, counts, None)
    media = []
    for i, d in enumerate(descs):
        m = JaxMedia(f"/x/{i}.jpg", JaxMedia.TypeImage, id=i + 1)
        m.colorDescriptor = d
        media.append(m)
    db = sqlite3.connect(str(tmp_path / "media.db"))
    jidx = JaxIndex()
    jidx.create_tables(db)
    jidx.add_records(db, media)
    jidx.load(db, "", "")
    idx = ColorDescIndex("cpu")
    idx.load(db, "", "")
    assert idx.count() == 120
    assert np.array_equal(idx._store.descriptors, descs)
    sp, jsp = SearchParams(), JaxParams()
    _same_matches(idx, jidx, (1, 5, 60, 119), sp, jsp)
    ids, raw = idx.find_all(sp)
    assert np.array_equal(ids, np.arange(1, 121))
    full = jidx.find_batch([JaxMedia(id=i) for i in range(1, 121)], jsp)
    assert len(raw) > 60
    for row, (hid, _) in raw.items():
        assert list(hid) == [m.mediaId for m in full[row]][:len(hid)]
        assert len(hid) == min(sp.maxMatches + 8, len(full[row]))
    idx.remove([5])
    jidx.remove([5])
    _same_matches(idx, jidx, (1, 60), sp, jsp)


# ---- the CLI --------------------------------------------------------------------

@pytest.fixture(scope="module")
def color_corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("color") / "src")
    make_corpus(root, n_base=2, scales=(1.0, 0.5))
    return root


def _cli(*args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = port_cli.main(list(args))
    return rc, buf.getvalue()


def test_cli_color_verbs(color_corpus, monkeypatch):
    """-update with color writes the JAX package's blob (which its index
    loads); -p.alg color -similar and -similar-to, -merge,
    -test-image-search (its fdct and orb needles at two pyramid levels)
    and -test-image-loader exit 0, and the port's CLI refuses no verb
    (its NOT_PORTED gate is gone)."""
    from cbird_tpu_torch.ops import orb
    monkeypatch.setattr(orb, "N_LEVELS", 2)
    d = color_corpus
    assert not hasattr(port_cli, "NOT_PORTED")
    for verb in ("-merge", "-test-image-search", "-test-image-loader"):
        assert verb in port_cli._KNOWN_VERBS
    rc, _ = _cli("-use", d, "-i.algos", "dct+color", "-create", "-update")
    assert rc == 0
    db = sqlite3.connect(os.path.join(d, "_index", "media3.db"))
    blobs = db.execute("select media_id, color_desc from color").fetchall()
    assert len(blobs) == 4 and all(len(b) == 33 * 4 * 2 for _, b in blobs)
    jidx = JaxIndex()
    jidx.load(db, "", "")
    assert jidx.count() == 4
    rc, out = _cli("-use", d, "-p.alg", "color", "-similar", "-json")
    assert rc == 0 and json.loads(out)
    needle = os.path.join(d, "img000_s100.png")
    rc, out = _cli("-use", d, "-p.alg", "color", "-similar-to", needle,
                   "-json")
    assert rc == 0
    hits = {os.path.basename(m["path"]) for m in json.loads(out)[0]["matches"]}
    assert "img000_s050.png" in hits
    # img001 is far from img000 by dct: -merge escalates to color
    rc, out = _cli("-use", d, "-merge", "img000_s100.png", "img001_s050.png",
                   "-dump")
    assert rc == 0 and "img001_s050.png" in out and "img000_s100.png" in out
    rc, out = _cli("-use", d, "-select-files", needle,
                   os.path.join(d, "img001_s050.png"), "-test-image-search")
    assert rc == 0 and "|  dct |   2 |   0 |" in out
    rc, out = _cli("-use", d, "-test-image-loader", needle)
    assert rc == 0 and "400x320" in out


def test_needles_and_mirror_of_color(color_corpus):
    """A video needle's frames become color needles of the frames stacked
    to RGB; a mirror pass adds nothing for color."""
    from cbird_tpu_torch.host.engine import Engine
    eng = Engine(color_corpus, device="cpu")
    sp = SearchParams()
    sp.algo = SearchParams.ALGO_COLOR
    rng = np.random.default_rng(2)
    grey = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    (m,) = eng._needles_from_images([grey], Media("/v.mp4"), 64, 48, sp)
    want = pc.create_descriptors([np.stack([grey] * 3, -1)])[0]
    assert np.array_equal(m.colorDescriptor, want)
    sp.mirrorMask = SearchParams.MIRROR_HORIZONTAL
    assert eng._mirror_query(Media(os.path.join(color_corpus,
                                                "img000_s100.png")), sp) == []


# ---- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_exact32_forms_on_card():
    """``fma32``'s sparse and dense forms on the card equal the CPU's, with
    tensors and Python numbers in every operand position (a number times
    a tensor is taken as the tensor times the number)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(12)
    t = [torch.from_numpy((rng.standard_normal(4096) * 30).astype(
        np.float32)) for _ in range(3)]
    for a, b, c in ((t[0], t[1], t[2]), (0.412453, t[1], t[2]),
                    (t[0], 3.0, t[2]), (0.5, 0.25, t[2]), (t[0], t[0], 1.0),
                    (116.0, t[1], -16.0)):
        want = exact32.fma32(a, b, c)
        on = [v.cuda() if isinstance(v, torch.Tensor) else v
              for v in (a, b, c)]
        for form in (exact32._fma32_sparse, exact32._fma32_dense):
            got = form(*exact32._operands(*on))
            assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["both", "ab", "ba"])
def test_kernel_matches_plain_on_card(side):
    """K6 against its plain twin on the card, bit for bit, at needle and
    row counts around its tiles (32 needles, 128 rows), with a row window;
    in warps whose rows' counts straddle the needles' (rows of 28-32
    colors, needles of 29-31: the two-sided form's warps of mixed sides);
    and the top-k with ties at the k boundary equal to the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for q, c in ((1, 1), (31, 127), (33, 129), (64, 1000), (40, 4097)):
        nc, nn, _ = store_data(q, seed=q)
        hc, hn, hv = store_data(c, seed=c, dups=c // 10)
        if c == 4097:  # straddling counts in every warp
            rng = np.random.default_rng(c)
            hn = rng.integers(28, 33, c).astype(np.int32)
            nn = rng.integers(29, 32, q).astype(np.int32)
        args = [torch.from_numpy(a) for a in (nc, nn, hc, hn, hv)]
        kw = dict(side=side, lo=3, hi=c - 2, base=1) if side != "both" \
            else {}
        want = cs.color_scores_plain(*(a.cuda() for a in args), **kw)
        got = cs.color_scores(*(a.cuda() for a in args), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (q, c)
    hc, hn, hv = store_data(5000, seed=7)
    hc[100:140] = hc[10]  # 41 equal scores across the k boundary
    hn[100:140], hv[100:140] = hn[10] or 31, True
    args = [torch.from_numpy(a) for a in (hc[:9], hn[:9], hc, hn, hv)]
    args[0][2], args[1][2] = args[2][10], args[3][100]
    for k in (16, 64):
        want = pc.color_topk(*args, k=k, chunk=512)
        got = pc.color_topk(*(a.cuda() for a in args), k=k, chunk=512)
        assert torch.equal(got[1].cpu(), want[1])
        assert torch.equal(got[0].cpu(), want[0])
