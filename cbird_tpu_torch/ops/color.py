"""Color histogram descriptors (Luv k-means) and the batched color search.

Port of ``cbird_tpu/ops/color.py`` (the reference's ColorDescriptor):

- ``create_descriptors``: a batch of <= 256 px RGB images -> per image a
  32-color Luv histogram: the elliptical center mask, RGB -> Luv (OpenCV's
  float formulas, no gamma), the brightness filter L > 4, k-means (k = 32,
  k-means++ seeding, Lloyd iterations to a center shift below 10), all
  batched over the images in plain PyTorch; the sort / merge / quantize
  tail runs on the host.  The seeding draws JAX's threefry words
  (``ops/prng.py``), keyed from the pixel sum as in the JAX package.
- ``color_topk``, ``color_self_block`` and ``PackedColorStore``: the
  chamfer min-distance-sum search, scored by kernel K6
  (``ops/color_scores.py``), each chunk's k best taken by a stable sort
  (ties go to the lower row) and merged.  On a mesh (``ops/hamming.py``
  ``_search_mesh``) the store's rows are split over its index axis and
  ``search`` runs ``parallel/sharded.py`` ``sharded_color_topk``;
  ``search_self`` takes the unbucketed scan there, as the JAX package
  does.

Numerics.  The batch keeps ``vmap(while_loop)``'s semantics: each image
stops at its own iteration count, and an image's descriptor does not
depend on the batch it is in.  Ties follow JAX: ``argmin`` / ``argmax``
take the first index, an empty cluster keeps its center, all-zero
minimum distances fall back to uniform seeding.  XLA's contractions of a
multiply into the add that takes it and its square roots are rounded
once, as XLA rounds them (``ops/exact32.py``).  Two things differ from
XLA's CPU and are chosen to give the same bits on the CPU and the card:

- the cube root of ``rgb_to_luv`` and the ``log`` of the seeding are
  taken in float64 and rounded to float32 (``_cbrt``, ``prng.log32``);
  XLA's float32 ``cbrt`` (a ``pow`` by float32(1/3)) and ``log`` are
  within 1 ulp of them;
- the cluster sums (XLA: a float32 ``einsum``) are exact integer sums of
  the samples in fixed point (``_cluster_sums``), so their order (batch,
  device, atomics) cannot change them; XLA's float32 sums are within
  ~1 ulp of them.

So a center can differ from the JAX package's by an ulp, and a quantized
coordinate or weight by 1 where its float lies on a quantization edge
(``tests/test_torch_color.py`` lists what the test images show).

Descriptor storage is the JAX package's: [33, 4] uint16 rows (l, u, v, w)
and the color count, whose reference quirk (count - 1) the score keeps.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve
from . import prng
from .color_scores import BAD_SCORE, NUM_COLORS, color_scores
from .exact32 import fma32, sqrt32
from .hamming import _bucket, _search_mesh

_U16 = 65535.0

# Luv white point constants (OpenCV float path)
_UN = 0.19793943
_VN = 0.46831096
_THIRD = float(np.float32(1.0 / 3.0))  # XLA's cbrt: pow by float32(1/3)

# fixed-point scales of the exact cluster sums: |Luv| < 2^8 and weights
# <= 1 over <= 2^16 samples stay below 2^62
_LUV_SCALE = 2.0 ** 38
_W_SCALE = 2.0 ** 45
# k-means temporaries hold [images, canvas^2, 32] float32: images a launch
_SAMPLES_PER_LAUNCH = 1 << 20


# ---------------------------------------------------------------------------
# color space
# ---------------------------------------------------------------------------

def _cbrt(y: torch.Tensor) -> torch.Tensor:
    return torch.pow(y.double(), _THIRD).float()


def rgb_to_luv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB [..., 3] float32 in [0, 1] -> Luv (OpenCV cvtColor float
    semantics: linear RGB -> XYZ matrix, no gamma; L in [0, 100], u in
    [-134, 220], v in [-140, 122]).  The sums of products are contracted
    as XLA contracts them (``fma32``)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    x = fma32(0.180423, b, fma32(0.412453, r, 0.357580 * g))
    y = fma32(0.072169, b, fma32(0.212671, r, 0.715160 * g))
    z = fma32(0.950227, b, fma32(0.019334, r, 0.119193 * g))
    l = torch.where(y > 0.008856, fma32(116.0, _cbrt(y), -16.0), 903.3 * y)
    denom = fma32(3.0, z, fma32(15.0, y, x))
    pos = denom > 0
    safe = torch.where(pos, denom, 1.0)
    up = torch.where(pos, 4.0 * x / safe, 0.0)
    vp = torch.where(pos, 9.0 * y / safe, 0.0)
    u = 13.0 * l * (up - _UN)
    v = 13.0 * l * (vp - _VN)
    return torch.stack([l, u, v], dim=-1)


# ---------------------------------------------------------------------------
# quantization (reference DescriptorColor set/get)
# ---------------------------------------------------------------------------

def quantize_luv(luv: np.ndarray) -> np.ndarray:
    """float Luv [..., 3] -> uint16 (reference DescriptorColor::set)."""
    l = np.clip((_U16 / 100.0) * luv[..., 0], 0, _U16)
    u = np.clip((_U16 / 354.0) * (luv[..., 1] + 134.0), 0, _U16)
    v = np.clip((_U16 / 262.0) * (luv[..., 2] + 140.0), 0, _U16)
    return np.stack([l, u, v], axis=-1).astype(np.uint16)


def dequantize_luv(q: np.ndarray) -> np.ndarray:
    """uint16 [..., 3] -> float Luv (reference DescriptorColor::get)."""
    q = q.astype(np.float32)
    l = q[..., 0] * 100.0 / _U16
    u = q[..., 1] * 354.0 / _U16 - 134.0
    v = q[..., 2] * 262.0 / _U16 - 140.0
    return np.stack([l, u, v], axis=-1)


# ---------------------------------------------------------------------------
# batched k-means over the masked sample sets
# ---------------------------------------------------------------------------

def _sq3(dl, du, dv) -> torch.Tensor:
    """dl^2 + du^2 + dv^2 as XLA's reduce over the three adds them: the
    running sum with each square contracted into its add."""
    return fma32(dv, dv, fma32(du, du, dl * dl))


def _d2(luv: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """[B, S, 3] samples x [B, K, 3] centers -> [B, S, K] squared
    distances."""
    return _sq3(*(luv[:, :, None, k] - centers[:, None, :, k]
                  for k in range(3)))


def _cluster_sums(labels, keep, values, scale):
    """Per image and cluster: the count of kept samples and the sums of
    ``values`` [B, S, D] over them, exact in fixed point (integer sums do
    not depend on their order).
    @return (counts [B, 32] int64, sums [B, 32, D] float32)"""
    b, s, d = values.shape
    bins = NUM_COLORS + 1  # the last bin takes the dropped samples
    seg = torch.where(keep, labels, NUM_COLORS) \
        + bins * torch.arange(b, device=labels.device)[:, None]
    seg = seg.reshape(-1)
    counts = torch.bincount(seg, minlength=b * bins).view(b, bins)
    sums = torch.zeros((b * bins, d), dtype=torch.int64,
                       device=values.device)
    # dropped samples add 0 (off the image a damping weight is negative
    # and unbounded, and its fixed point would not fit)
    kept = torch.where(keep[..., None], values.double(), 0.0)
    fixed = torch.round(kept * scale).to(torch.int64)
    sums.index_add_(0, seg, fixed.reshape(-1, d))
    sums = (sums.view(b, bins, d).double() / scale).float()
    return counts[:, :NUM_COLORS], sums[:, :NUM_COLORS]


def seeding_keys(seeds: torch.Tensor):
    """The keys of the seeding's 32 gumbel draws for each image: the key
    ``fold_in(PRNGKey(12345), seed)``, then the second key of each
    ``split`` of its chain, in order.  The chain of [B] words runs on the
    CPU, once for all the images of a call.
    @param seeds [B] uint32 words (int64)
    @return ([32, B], [32, B]) words on the CPU"""
    k = prng.fold_in(prng.prng_key(12345), seeds.cpu())
    subs = []
    for _ in range(NUM_COLORS):
        k, sub = prng.split(k)
        subs.append(sub)
    return (torch.stack([a for a, _ in subs]),
            torch.stack([b for _, b in subs]))


def _kmeans_pp_init(luv, mask, keys, group: int = 8):
    """k-means++ seeding over the masked samples. luv [B, S, 3], mask
    [B, S], keys the draws' keys (``seeding_keys``).  The gumbel noise of
    ``group`` draws is made in one pass.  @return centers [B, 32, 3]"""
    b, s, _ = luv.shape
    dev = luv.device
    neg_inf = torch.tensor(-1e30, dtype=torch.float32, device=dev)
    rows = torch.arange(b, device=dev)
    k1, k2 = keys
    noise = None

    def pick(logits, i):
        nonlocal noise
        if i % group == 0:
            noise = prng.gumbel((k1[i:i + group].to(dev),
                                 k2[i:i + group].to(dev)), s)
        return torch.argmax(logits + noise[i % group], dim=1)

    uniform = torch.where(mask, 0.0, neg_inf)
    centers = torch.zeros((b, NUM_COLORS, 3), dtype=torch.float32,
                          device=dev)
    centers[:, 0] = luv[rows, pick(uniform, 0)]
    mind2 = None
    for i in range(1, NUM_COLORS):
        # the minimum over centers < i, one new center at a time (a min
        # is exact, so this equals JAX's masked min over all 32)
        d2 = _d2(luv, centers[:, i - 1:i])[:, :, 0]
        mind2 = d2 if mind2 is None else torch.minimum(mind2, d2)
        logits = torch.where(mask & (mind2 > 0),
                             prng.log32(torch.clamp_min(mind2, 1e-12)),
                             neg_inf)
        # all-zero mind2 (duplicate-heavy images): fall back to uniform
        flat = (logits == neg_inf).all(dim=1, keepdim=True)
        logits = torch.where(flat, uniform, logits)
        centers[:, i] = luv[rows, pick(logits, i)]
    return centers


def _assign(luv, centers):
    return torch.argmin(_d2(luv, centers), dim=2)


def _lloyd_step(luv, mask, centers):
    """One Lloyd iteration.  @return (new centers, max center shift)"""
    counts, sums = _cluster_sums(_assign(luv, centers), mask, luv,
                                 _LUV_SCALE)
    cf = counts.to(torch.float32)[:, :, None]
    new = torch.where(cf > 0, sums / torch.clamp_min(cf, 1.0),
                      centers)  # an empty cluster keeps its center
    moved = _sq3(*(new - centers).unbind(-1))
    return new, sqrt32(moved.amax(dim=1))


def _kmeans(luv, mask, keys, max_iter: int = 100, eps: float = 10.0):
    """Lloyd iterations (squared L2, like cv::kmeans) until the max center
    shift falls below eps (TermCriteria 100/10), each image on its own
    count: the batch steps only the images whose condition holds, as
    ``vmap(while_loop)`` does.  @return (centers [B, 32, 3], labels
    [B, S])"""
    centers, shift = _lloyd_step(luv, mask, _kmeans_pp_init(luv, mask, keys))
    it = torch.ones(luv.shape[0], dtype=torch.int64, device=luv.device)
    while True:
        active = torch.nonzero((it < max_iter) & (shift >= eps))[:, 0]
        if active.numel() == 0:
            break
        new, moved = _lloyd_step(luv[active], mask[active], centers[active])
        centers[active] = new
        shift[active] = moved
        it[active] += 1
    return centers, _assign(luv, centers)


def _descriptor_batch(canvas: torch.Tensor, sizes: torch.Tensor, keys):
    """Device pipeline of a batch. canvas [B, H, W, 3] uint8, sizes [B, 2]
    (h, w), keys the seeding's (``seeding_keys``).

    @return (centers [B, 32, 3] f32 Luv, label_w [B, 32] f32 weight sums,
             label_n [B, 32] i32 counts, n_samples [B] i32)
    """
    b, hmax, wmax, _ = canvas.shape
    dev = canvas.device
    h = sizes[:, 0].to(torch.float32)[:, None, None]
    w = sizes[:, 1].to(torch.float32)[:, None, None]
    yy = torch.arange(hmax, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(wmax, dtype=torch.float32, device=dev)[None, None, :]
    inb = (yy < h) & (xx < w)

    # elliptical center mask (axes 0.9w x 0.9h); outside pixels go to
    # black and are then dropped by the L > 4 filter
    ex = (xx - w * 0.5) / torch.clamp_min(w * 0.45, 1.0)
    ey = (yy - h * 0.5) / torch.clamp_min(h * 0.45, 1.0)
    inside = fma32(ex, ex, ey * ey) <= 1.0

    rgb = canvas.to(torch.float32) * (1.0 / 256.0)  # mask scale + [0, 1]
    luv = rgb_to_luv(rgb)  # [B, H, W, 3]
    keep = inb & inside & (luv[..., 0] > 4.0)  # brightness filter L > 4
    flat_luv = luv.reshape(b, -1, 3)
    flat_keep = keep.reshape(b, -1)
    n_samples = flat_keep.sum(dim=1)

    centers, labels = _kmeans(flat_luv, flat_keep, keys)

    # positional damping: weight = (maxDist - dist_from_center) / maxDist
    dx = xx - torch.floor(w / 2.0)
    dy = yy - torch.floor(h / 2.0)
    dist = sqrt32(fma32(dx, dx, dy * dy))
    hw, hh = w / 2.0, h / 2.0
    max_dist = sqrt32(fma32(hw, hw, hh * hh))
    wpos = ((max_dist - dist) / torch.clamp_min(max_dist, 1e-6))
    wpos = wpos.expand(b, hmax, wmax).reshape(b, -1, 1)
    label_n, label_w = _cluster_sums(labels, flat_keep, wpos, _W_SCALE)
    return (centers, label_w[..., 0], label_n.to(torch.int32),
            n_samples.to(torch.int32))


def create_descriptors(images: Sequence[Optional[np.ndarray]],
                       canvas: int = 256,
                       device=None) -> list[Optional[np.ndarray]]:
    """Batch descriptor creation, in launches of at most
    ``_SAMPLES_PER_LAUNCH`` canvas pixels.

    @param images RGB uint8 arrays (<= canvas px), or None for grayscale
           media
    @return per image: [33, 4] uint16 -- rows 0..31 are (l, u, v, w), row
            32 holds (numColors, 0, 0, 0); None when no descriptor applies
            (grayscale input or < 32 usable colors, reference behavior)
    """
    dev = resolve(device)
    idx = [i for i, im in enumerate(images) if im is not None and im.ndim == 3]
    out: list[Optional[np.ndarray]] = [None] * len(images)
    if not idx:
        return out
    seeds = torch.tensor([int(np.sum(images[i], dtype=np.uint64) & 0xFFFFFFFF)
                          for i in idx], dtype=torch.int64)
    k1, k2 = seeding_keys(seeds)
    per = max(1, _SAMPLES_PER_LAUNCH // (canvas * canvas))
    for s in range(0, len(idx), per):
        part = idx[s:s + per]
        b = len(part)
        cv = np.zeros((b, canvas, canvas, 3), dtype=np.uint8)
        sizes = np.zeros((b, 2), dtype=np.int32)
        for n, i in enumerate(part):
            im = images[i]
            h, w = im.shape[:2]
            cv[n, :h, :w] = im[..., :3]
            sizes[n] = (h, w)
        res = _descriptor_batch(torch.from_numpy(cv).to(dev),
                                torch.from_numpy(sizes).to(dev),
                                (k1[:, s:s + b], k2[:, s:s + b]))
        centers, label_w, label_n, n_samples = (a.cpu().numpy() for a in res)
        for n, i in enumerate(part):
            out[i] = _format_descriptor(centers[n], label_w[n], label_n[n],
                                        int(n_samples[n]))
    return out


def _format_descriptor(centers: np.ndarray, label_w: np.ndarray,
                       label_n: np.ndarray, n_samples: int) -> Optional[np.ndarray]:
    """Quantize centers, merge colliding keys, sort by weight, normalize
    (reference src/cvutil.cpp:1005-1081)."""
    if n_samples < NUM_COLORS:
        return None  # "not enough colors" (src/cvutil.cpp:889-892)
    q = quantize_luv(centers)  # [32,3] u16
    freq: dict[tuple, float] = {}
    for k in range(NUM_COLORS):
        if label_n[k] <= 0:
            continue
        key = tuple(int(x) for x in q[k])
        freq[key] = freq.get(key, 0.0) + float(label_w[k])
    if not freq:
        return None
    max_freq = max(freq.values())
    keys = sorted(freq, key=lambda k: -freq[k])[:NUM_COLORS]
    desc = np.zeros((NUM_COLORS + 1, 4), dtype=np.uint16)
    for n, key in enumerate(keys):
        w16 = int(freq[key] * _U16 / max_freq) & 0xFFFF if max_freq > 0 else 0
        desc[n] = (key[0], key[1], key[2], w16)
    # reference quirk: numColors ends at count-1 (src/cvutil.cpp:1052)
    desc[NUM_COLORS, 0] = max(len(keys) - 1, 0)
    return desc


def descriptor_num_colors(desc: np.ndarray) -> int:
    return int(desc[NUM_COLORS, 0])


# ---------------------------------------------------------------------------
# batched distance search
# ---------------------------------------------------------------------------

# scores a K6 launch writes at most (a [Q, window] float32 buffer)
_SCORES_PER_LAUNCH = 1 << 26


def _chunk_topk(scores: torch.Tensor, k: int, chunk: int):
    """[Q, m * chunk] scores -> each chunk's k best by (score, position),
    a stable sort: (scores [Q, m, k], positions in the buffer [Q, m, k])."""
    q, width = scores.shape
    m = width // chunk
    val, pos = torch.sort(scores.view(q, m, chunk), dim=2, stable=True)
    pos = pos[:, :, :k] + (torch.arange(m, device=scores.device)
                           * chunk)[None, :, None]
    return val[:, :, :k], pos


def _merge(vals: torch.Tensor, rows: torch.Tensor, k: int):
    """[Q, n] candidates in ascending row order -> the k best by (score,
    position): one stable sort, as ``lax.top_k`` over the chunks' lists."""
    val, sel = torch.sort(vals, dim=1, stable=True)
    return val[:, :k], torch.gather(rows, 1, sel[:, :k])


def color_topk(n_colors: torch.Tensor, n_counts: torch.Tensor,
               h_colors: torch.Tensor, h_counts: torch.Tensor,
               h_valid: torch.Tensor, k: int = 64, chunk: int = 4096):
    """Asymmetric min-distance-sum color matching, batched (JAX
    ``color_topk`` and ``color_topk_local``).

    n_colors [Q, 32, 3] f32 needle Luv, n_counts [Q] int32 numColors;
    h_colors [N, 32, 3], h_counts [N], h_valid [N]
    @return (scores [Q, k] f32 ascending, indices [Q, k] int64); BAD_SCORE
            = miss.  The rows padded to whole chunks (counts 0), each
            chunk's k best by a stable sort, one exact merge.  K6 scores windows of whole
            chunks, at most ``_SCORES_PER_LAUNCH`` scores a launch."""
    q = n_colors.shape[0]
    n = h_colors.shape[0]
    dev = n_colors.device
    k = min(k, n)
    chunk = min(chunk, n)  # up to a chunk of rows: one chunk, no padding
    n_chunks = -(-n // chunk)
    per = max(1, _SCORES_PER_LAUNCH // max(q * chunk, 1))
    vals, rows = [], []
    for c0 in range(0, n_chunks, per):
        m = min(per, n_chunks - c0)
        lo, hi = c0 * chunk, min(n, (c0 + m) * chunk)
        buf = torch.full((q, m * chunk), float(BAD_SCORE),
                         dtype=torch.float32, device=dev)
        color_scores(n_colors, n_counts, h_colors[lo:hi], h_counts[lo:hi],
                     h_valid[lo:hi], out=buf)
        val, pos = _chunk_topk(buf, k, chunk)
        vals.append(val.reshape(q, -1))
        rows.append(pos.reshape(q, -1) + lo)
    return _merge(torch.cat(vals, 1), torch.cat(rows, 1), k)


def color_self_block(n_colors, n_counts, hs_colors, hs_counts, hs_valid,
                     start: int, lo: int, hi: int, k: int = 16,
                     side: str = "ab", super_chunk: int = 1 << 16,
                     chunk: int = 4096):
    """One needle block vs one ``super_chunk`` window of the count-sorted
    store (JAX ``color_self_block``): rows outside ``[lo, hi)`` are
    masked, each ``chunk`` of the window gives its k best by (score,
    sorted position), then one merge.  @return ([Q, k] scores ascending,
    [Q, k] indices into the SORTED order)"""
    end = min(start + super_chunk, hs_colors.shape[0])
    q = n_colors.shape[0]
    k = min(k, super_chunk)
    buf = torch.full((q, super_chunk), float(BAD_SCORE), dtype=torch.float32,
                     device=n_colors.device)
    color_scores(n_colors, n_counts, hs_colors[start:end],
                 hs_counts[start:end], hs_valid[start:end], side=side,
                 lo=lo, hi=hi, base=start, out=buf)
    val, pos = _chunk_topk(buf, k, min(chunk, super_chunk))
    val, idx = _merge(val.reshape(q, -1), pos.reshape(q, -1), k)
    return val, idx + start


class PackedColorStore:
    """Host + device packed color descriptor store (parallel arrays keyed
    by media id, tombstone removal: the PackedHashStore contract)."""

    def __init__(self, device=None):
        self.device = resolve(device)
        self._descs = np.zeros((0, NUM_COLORS + 1, 4), dtype=np.uint16)
        self._ids = np.zeros(0, dtype=np.uint32)
        self._dev = None
        self._dev_mesh = None  # the mesh _dev is sharded over

    def __len__(self):
        return len(self._ids)

    @property
    def ids(self):
        return self._ids

    @property
    def descriptors(self):
        return self._descs

    def memory_usage(self) -> int:
        return self._descs.nbytes + self._ids.nbytes

    def add(self, descs: np.ndarray, ids: np.ndarray) -> None:
        if len(ids) == 0:
            return
        self._descs = np.concatenate([self._descs, np.asarray(descs, np.uint16)])
        self._ids = np.concatenate([self._ids, np.asarray(ids, np.uint32)])
        self._dev = None

    def remove(self, ids) -> None:
        if not len(self._ids):
            return
        kill = np.isin(self._ids, np.asarray(list(ids), dtype=np.uint32))
        if kill.any():
            self._ids[kill] = 0
            self._descs[kill] = 0
            self._dev = None

    def slice(self, media_ids) -> "PackedColorStore":
        keep = np.isin(self._ids, np.asarray(list(media_ids), dtype=np.uint32))
        keep &= self._ids != 0
        out = PackedColorStore(self.device)
        out.add(self._descs[keep], self._ids[keep])
        return out

    def device_arrays(self):
        """(colors [b, 32, 3] f32, counts [b] i32, valid [b] bool) on the
        device, padded to a bucket (rows past the store: count 0), or
        ``Sharded`` over the mesh (the bucket a multiple of its shards)."""
        mesh = _search_mesh(self.device)
        if self._dev is None or self._dev_mesh is not mesh:
            from ..parallel.sharded import index_shards, shard_rows
            n = len(self._ids)
            b = _bucket(max(n, 1), minimum=64, multiple=index_shards(mesh)
                        if mesh is not None else 1)
            colors = np.zeros((b, NUM_COLORS, 3), dtype=np.float32)
            counts = np.zeros(b, dtype=np.int32)
            valid = np.zeros(b, dtype=bool)
            if n:
                colors[:n] = dequantize_luv(self._descs[:, :NUM_COLORS, :3])
                counts[:n] = self._descs[:, NUM_COLORS, 0]
                valid[:n] = self._ids != 0
            arrays = (colors, counts, valid)
            self._dev = shard_rows(mesh, *arrays) if mesh is not None else \
                tuple(torch.from_numpy(a).to(self.device) for a in arrays)
            self._dev_mesh = mesh
        return self._dev

    def _needle_block(self, descs, size: int):
        ncol = np.zeros((size, NUM_COLORS, 3), dtype=np.float32)
        ncnt = np.zeros(size, dtype=np.int32)
        for n, dsc in enumerate(descs):
            if dsc is not None:
                ncol[n] = dequantize_luv(dsc[:NUM_COLORS, :3])
                ncnt[n] = dsc[NUM_COLORS, 0]
        return ncol, ncnt

    def _topk(self, ncol: np.ndarray, ncnt: np.ndarray, k: int):
        """One needle block's top-k, read to the host."""
        colors_d, counts_d, valid_d = self.device_arrays()
        ncol = torch.from_numpy(ncol).to(self.device)
        ncnt = torch.from_numpy(ncnt).to(self.device)
        if self._dev_mesh is not None:
            from ..parallel.sharded import sharded_color_topk
            scores, idx = sharded_color_topk(self._dev_mesh, ncol, ncnt,
                                             colors_d, counts_d, valid_d,
                                             k=k)
        else:
            scores, idx = color_topk(ncol, ncnt, colors_d, counts_d,
                                     valid_d, k=k)
        return scores.cpu().numpy(), idx.cpu().numpy()

    def search(self, needle_descs: Sequence[Optional[np.ndarray]], k: int = 64,
               needle_batch: int = 64):
        """@return per needle (ids, scores float32) sorted ascending;
        needle blocks of ``needle_batch``, each read back once."""
        q_total = len(needle_descs)
        empty = (np.zeros(0, np.uint32), np.zeros(0, np.float32))
        if q_total == 0 or len(self._ids) == 0:
            return [empty] * q_total
        results: list = []
        for s in range(0, q_total, needle_batch):
            chunk = needle_descs[s:s + needle_batch]
            scores, idx = self._topk(*self._needle_block(chunk, needle_batch),
                                     k)
            for row in range(len(chunk)):
                hit = scores[row] < BAD_SCORE
                results.append((self._ids[idx[row][hit]], scores[row][hit]))
        return results

    def search_self(self, k: int = 16, needle_batch: int = 1024,
                    sparse: bool = False):
        """N^2 color search: every store row scored against the whole
        store.  Default: the count-bucketed one-sided scan
        (``_search_self_bucketed``); on a mesh (its rows sharded) or with
        ``CBIRD_COLOR_BUCKETS=off``, the unbucketed scan
        (``_search_self_scan``).

        @return {row: (ids, scores)} when sparse else a dense list."""
        n = len(self._ids)
        if n == 0:
            return {} if sparse else []
        if (_search_mesh(self.device) is None
                and os.environ.get("CBIRD_COLOR_BUCKETS", "on") != "off"):
            return self._search_self_bucketed(k, needle_batch, sparse)
        return self._search_self_scan(k, needle_batch, sparse)

    @staticmethod
    def _dense(out: dict, n: int, sparse: bool):
        if sparse:
            return out
        dense = [(np.zeros(0, np.uint32), np.zeros(0, np.float32))] * n
        for r, v in out.items():
            dense[r] = v
        return dense

    def _search_self_scan(self, k: int, needle_batch: int, sparse: bool):
        """Unbucketed N^2: the store rows streamed through ``search``'s
        chunked top-k in blocks of ``needle_batch``."""
        n = len(self._ids)
        out: dict = {}
        for s in range(0, n, needle_batch):
            qb = min(needle_batch, n - s)
            block = self._descs[s:s + qb]
            ncol = np.zeros((needle_batch, NUM_COLORS, 3), dtype=np.float32)
            ncnt = np.zeros(needle_batch, dtype=np.int32)
            ncol[:qb] = dequantize_luv(block[:, :NUM_COLORS, :3])
            ncnt[:qb] = block[:, NUM_COLORS, 0]
            ncnt[:qb][self._ids[s:s + qb] == 0] = 0  # tombstones never match
            scores, idx = self._topk(ncol, ncnt, k)
            for row in range(qb):
                hit = scores[row] < BAD_SCORE
                if hit.any():
                    out[s + row] = (self._ids[idx[row][hit]],
                                    scores[row][hit])
        return self._dense(out, n, sparse)

    def _search_self_bucketed(self, k: int, needle_batch: int, sparse: bool):
        """Count-bucketed one-sided N^2 (JAX ``_search_self_bucketed``).

        The store is sorted once by numColors; each equal-count needle
        bucket then scans two contiguous ranges of the sorted order --
        counts in [c-2, c] with the needle-side sum ("ab") and [c+1, c+2]
        with the row-side one ("ba") -- in super_chunk windows
        (``color_self_block``).  Per-window top-ks merge on the host by
        (score, original row).

        Known tie divergence from the scan path, kept as the JAX package
        has it: the final sort only sees candidates that survived each
        chunk's top-k, and within a chunk equal scores keep the lower
        sorted-order position.  With more than k exactly-equal scores in
        one chunk (a duplicate cluster larger than k), the k ids kept here
        can differ from the scan path's original-row tie-break; both are
        equally valid matches (identical scores)."""
        n = len(self._ids)
        counts = self._descs[:, NUM_COLORS, 0].astype(np.int32)
        counts = np.where(self._ids != 0, counts, 0)
        order = np.argsort(counts, kind="stable").astype(np.int64)
        sc = counts[order]
        super_chunk = min(1 << 16, _bucket(int(n), minimum=256))
        chunk = min(4096, super_chunk)
        qb_max = min(needle_batch, _bucket(int(n), minimum=64))
        ns = -(-n // super_chunk) * super_chunk
        colors_s = np.zeros((ns, NUM_COLORS, 3), np.float32)
        colors_s[:n] = dequantize_luv(self._descs[order][:, :NUM_COLORS, :3])
        cnt_s = np.zeros(ns, np.int32)
        cnt_s[:n] = sc
        val_s = np.zeros(ns, bool)
        val_s[:n] = self._ids[order] != 0
        dev = self.device
        hs_colors = torch.from_numpy(colors_s).to(dev)
        hs_counts = torch.from_numpy(cnt_s).to(dev)
        hs_valid = torch.from_numpy(val_s).to(dev)

        out: dict = {}
        bounds = np.searchsorted(sc, np.arange(0, NUM_COLORS + 4))
        for c in np.unique(sc[sc > 0]):
            c = int(c)
            blo, bhi = int(bounds[c]), int(bounds[c + 1])
            ab_lo = int(bounds[max(c - 2, 1)])
            ab_hi = int(bounds[c + 1])
            ba_lo = int(bounds[c + 1])
            ba_hi = int(bounds[min(c + 3, NUM_COLORS + 3)])
            for s in range(blo, bhi, qb_max):
                qb = min(qb_max, bhi - s)
                ncol = hs_colors.new_zeros((qb_max, NUM_COLORS, 3))
                ncnt = hs_counts.new_zeros(qb_max)
                ncol[:qb] = hs_colors[s:s + qb]
                ncnt[:qb] = hs_counts[s:s + qb]
                ds, is_ = [], []
                for rlo, rhi, side in ((ab_lo, ab_hi, "ab"),
                                       (ba_lo, ba_hi, "ba")):
                    if rhi <= rlo:
                        continue
                    first = rlo // super_chunk * super_chunk
                    for start in range(first, rhi, super_chunk):
                        v, i = color_self_block(
                            ncol, ncnt, hs_colors, hs_counts, hs_valid,
                            start, rlo, rhi, k=k, side=side,
                            super_chunk=super_chunk, chunk=chunk)
                        ds.append(v)
                        is_.append(i)
                ds = torch.cat(ds, 1)[:qb].cpu().numpy()
                is_ = torch.cat(is_, 1)[:qb].cpu().numpy()
                orig = order[np.minimum(is_, n - 1)]
                # tie order: score, then original row index (matches the
                # top-k over the original-order store)
                sel = np.lexsort((orig, ds), axis=1)[:, :k]
                ds = np.take_along_axis(ds, sel, axis=1)
                orig = np.take_along_axis(orig, sel, axis=1)
                for row in range(qb):
                    hit = ds[row] < BAD_SCORE
                    if hit.any():
                        out[int(order[s + row])] = (
                            self._ids[orig[row][hit]].astype(np.uint32),
                            ds[row][hit].astype(np.float32))
        return self._dense(out, n, sparse)
