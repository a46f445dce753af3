"""ORB keypoints, 256-bit rBRIEF descriptors and keypoint DCT hashes in
PyTorch.

Port of ``cbird_tpu/ops/orb.py`` (the reference's OpenCV ORB usage:
400 features, 12 levels at scale 1.2, edge and patch 31, HARRIS_SCORE, on
images whose long side is normalised to 400 px; and its
makeKeyPointHashes).  Same math, batched over a [B, 400, 400] canvas:

- the pyramid: each level an area resize of the canvas as two matmuls;
- FAST-9 corners from 16 rolled comparisons and a contiguous-run test;
- the Harris response (Sobel gradients, a 7x7 window) ranks them;
- 3x3 non-max suppression among corners, the border margin, then the
  level's top-k by response;
- the intensity-centroid angle over the 31x31 patch;
- rotated BRIEF: 256 Gaussian point pairs (numpy seed 777, the JAX
  package's pattern bit for bit) sampled from a 5x5 box-blurred level,
  packed to [K, 4] int64 (its bytes are the [K, 32] uint8 rows that
  ``Media.keyPointDescriptors`` holds);
- keypoint hashes (fdct): the square ROI of side size anchored at the
  keypoint, hashed with the dct hash's blur + area-resize maps
  (``dct_hash._axis_map``), every ROI of a chunk of images in one set of
  batched matmuls.

It is plain PyTorch: matmuls, rolls, a sort and gathers, with no hand
kernel.  Where the JAX package relies on XLA's semantics the port says so
explicitly: the per-level top-k breaks ties by the lower flat index (a
stable sort; ``torch.topk`` promises no tie order on CUDA), and gather
indices are clamped to the padded level as XLA clamps them (a CUDA gather
out of range is a device assert).

The same image gives the same features on a card, on the CPU and in any
batch: no step sums in float32 in an order a library picks (cuBLAS picks
its algorithm by shape and batch) or calls a float32 libm.  Each step is
elementwise in a fixed sequence of float32 ops, or rounds a float64
result once to float32, where a float32 product is exact, so that it
rounds alike everywhere but on a rounding edge (odds near 2^-29 a
value):
- the multiply-adds (``_fma``) and the resize's two products, a
  multiply-add chain in ascending k over each output's band of weights
  (``_band_product``): the order XLA's CPU dot sums them in, so the
  levels stay within the JAX package's float noise where a float64 sum
  rounded once would not (flat regions, where the noise decides ties);
- the ROI hashes' matmuls and threshold sum, the intensity centroid's
  sums and ``atan2``, and the descriptor's ``cos`` and ``sin``: in
  float64, rounded once.
No matmul runs in TF32 (``device.set_hash_numerics``).
"""

from __future__ import annotations

import concurrent.futures as cf
import functools
import math
import os
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve, set_hash_numerics
from .dct_hash import _BITS, _D32, _ZZ64, _axis_map, _blur_radius

# 12 levels like the reference; CBIRD_ORB_LEVELS overrides the default,
# as in the JAX package (the level functions also take it as an argument)
N_LEVELS = int(os.environ.get("CBIRD_ORB_LEVELS", "12"))
SCALE = 1.2
PATCH = 31
EDGE = 31  # border margin (OpenCV edgeThreshold)
FAST_T = 20
CANVAS = 400  # longest side normalised to exactly 400 px before detection
MIN_ROI = 31  # smaller keypoint ROIs are not hashed

# FAST circle of 16 offsets (radius 3) in clockwise order
_FAST_CIRCLE = [(0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2),
                (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0),
                (-3, 1), (-2, 2), (-1, 3)]


def features_per_level(nfeatures: int, levels: int = N_LEVELS) -> list[int]:
    """Geometric distribution of the feature budget over levels (OpenCV)."""
    factor = 1.0 / SCALE
    ndesired = nfeatures * (1 - factor) / (1 - factor ** levels)
    out = []
    total = 0
    for lvl in range(levels - 1):
        n = int(round(ndesired * factor ** lvl))
        out.append(n)
        total += n
    out.append(max(nfeatures - total, 0))
    return out


def _brief_pattern(seed: int = 777) -> np.ndarray:
    """[256, 4] (y1, x1, y2, x2) float32: iid Gaussian N(0, (patch/5)^2)
    clipped to the patch."""
    rng = np.random.default_rng(seed)
    sigma = PATCH / 5.0
    pts = rng.normal(0.0, sigma, size=(256, 4))
    lim = PATCH // 2 - 1
    return np.clip(pts, -lim, lim).astype(np.float32)


_PATTERN = _brief_pattern()


def _level_dims(levels: int = N_LEVELS) -> list[tuple[int, int]]:
    """Each level's square canvas: 400 / 1.2^lvl, at least 16, rounded up
    to a multiple of 8."""
    dims = []
    for lvl in range(levels):
        s = CANVAS / (SCALE ** lvl)
        n = max(int(math.ceil(s)), 16)
        n = (n + 7) // 8 * 8
        dims.append((n, n))
    return dims


@functools.lru_cache(maxsize=None)
def _band_steps(out_n: int, n_in: int = CANVAS) -> int:
    """The most input rows (or columns) that one output cell of the level
    ``out_n`` area resize weighs, over every content size 1..n_in: the
    steps of ``_band_product`` (``_resize_area``'s float32 arithmetic)."""
    ratio = out_n / CANVAS
    size = torch.arange(1, n_in + 1, dtype=torch.float32)[:, None]
    lsize = torch.clamp((size * ratio).to(torch.int32), min=1).float()
    s = size / lsize
    i = torch.arange(out_n, dtype=torch.float32)[None, :]
    span = torch.minimum(torch.ceil((i + 1.0) * s), size) - torch.floor(i * s)
    return int((span * (i < lsize)).max())


def _band_product(w: torch.Tensor, first: torch.Tensor, x: torch.Tensor,
                  steps: int) -> torch.Tensor:
    """w [B, n, K] @ x [B, K, M] for a banded w (row i's nonzero weights
    among columns first[:, i] .. + steps - 1), as XLA's CPU dot sums it: a
    float32 multiply-add chain in ascending k, each step rounded once (the
    product is exact in float64).  A weight of 0 leaves the sum as it is,
    so the chain equals the whole dot's.  Elementwise, so it rounds alike
    on any device and in any batch.
    @return [B, n, M] float32"""
    b, _, k = w.shape
    idx = first[..., None] + torch.arange(steps, device=w.device)
    wt = torch.gather(w, 2, idx.clamp(max=k - 1)) * (idx < k)
    wt, idx = wt.double(), idx.clamp(max=k - 1)
    x = x.double()
    bi = torch.arange(b, device=w.device)[:, None]
    acc = torch.zeros(b, w.shape[1], x.shape[2], device=w.device)
    lo = torch.zeros_like(acc)  # the sum of the first half of k, if split
    for t in range(steps):
        if t:  # a band across k's halves: its second sum starts from 0
            cut = (idx[..., t] == k // 2)[..., None]
            lo = torch.where(cut, acc, lo)
            acc = torch.where(cut, 0.0, acc)
        acc = torch.addcmul(acc.double(), wt[..., t, None],
                            x[bi, idx[..., t]]).float()
    return lo + acc


def _dot_chain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., M, K] @ b [..., K, N] as a float32 multiply-add chain in
    ascending k, each step rounded once (``_band_product``'s sum without
    the band): elementwise, so it rounds alike on any device and in any
    batch.
    @return float32"""
    a, b = a.double(), b.double()
    acc = torch.zeros(torch.broadcast_shapes(a.shape[:-1] + (1,),
                                             b.shape[:-2] + (1, b.shape[-1])),
                      device=a.device)
    for k in range(a.shape[-1]):
        acc = torch.addcmul(acc.double(), a[..., :, k, None],
                            b[..., k, None, :]).float()
    return acc


def _resize_area(img: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                 out_n: int):
    """Area-resize the (h, w) region of each square canvas [B, N, N] by
    out_n / 400 into [B, out_n, out_n]: (wy @ img) @ wx.T, each product a
    ``_band_product``.
    @return (level images, level h [B], level w [B])"""
    n_in = img.shape[-1]
    dev = img.device
    ratio = out_n / CANVAS
    lh = torch.clamp((h.float() * ratio).to(torch.int32), min=1)
    lw = torch.clamp((w.float() * ratio).to(torch.int32), min=1)
    i = torch.arange(out_n, dtype=torch.float32, device=dev)[None, :, None]
    y = torch.arange(n_in, dtype=torch.float32, device=dev)[None, None, :]
    in_idx = torch.arange(n_in, device=dev)[None, None, :]
    out_idx = torch.arange(out_n, device=dev)[None, :, None]

    def weights(size, lsize):
        """[B, out_n, n_in] weights and each row's first weighed column"""
        s = (size.float() / lsize.float())[:, None, None]
        lo = torch.maximum(i * s, y)
        hi = torch.minimum((i + 1.0) * s, y + 1.0)
        wgt = torch.clamp(hi - lo, min=0.0) / s
        first = torch.floor(i * s)[..., 0].to(torch.int64)
        return (wgt * (in_idx < size[:, None, None])
                * (out_idx < lsize[:, None, None])), first

    steps = _band_steps(out_n, n_in)
    (wy, fy), (wx, fx) = weights(h, lh), weights(w, lw)
    rows = _band_product(wy, fy, img, steps)  # [B, out_n, N]
    out = _band_product(wx, fx, rows.transpose(1, 2), steps)
    return out.transpose(1, 2).contiguous(), lh, lw


def _box_blur(img: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(2r+1)^2 box blur of [B, n, n] by rolls, summed in the JAX
    package's order (a different order moves the Harris responses in the
    last ulp and reorders near-equal corners), then scaled by the float32
    reciprocal of the window: XLA compiles the JAX package's division by
    a constant to that product."""
    k = 2 * r + 1
    out = torch.zeros_like(img)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            out = out + torch.roll(img, (dy, dx), dims=(-2, -1))
    return out * np.float32(1.0 / (k * k)).item()


def _shift2(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    return torch.roll(img, (-dy, -dx), dims=(-2, -1))


def _fast_corners(img: torch.Tensor) -> torch.Tensor:
    """FAST-9 corner mask (bool) of [..., n, n]."""
    bright = []
    dark = []
    for (dy, dx) in _FAST_CIRCLE:
        s = _shift2(img, dy, dx)
        bright.append(s > img + FAST_T)
        dark.append(s < img - FAST_T)

    def has_run9(m):
        mm = torch.stack(m + m[:9])  # wraparound
        run = mm[0:16]
        for j in range(1, 9):
            run = run & mm[j:j + 16]
        return run.any(dim=0)

    return has_run9(bright) | has_run9(dark)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32 (the product is exact in float64),
    as XLA's CPU backend contracts the JAX package's multiply-adds."""
    return (a.double() * b.double() + c.double()).float()


def _harris(img: torch.Tensor) -> torch.Tensor:
    """Harris response with Sobel gradients and a 7x7 window, rounded as
    the JAX package's compiled program rounds it: XLA folds the window's
    mean times 49 back to the sum and contracts det and the response to
    multiply-adds."""
    ix = (_shift2(img, 0, 1) - _shift2(img, 0, -1)) * 2.0 \
        + (_shift2(img, -1, 1) - _shift2(img, -1, -1)) \
        + (_shift2(img, 1, 1) - _shift2(img, 1, -1))
    iy = (_shift2(img, 1, 0) - _shift2(img, -1, 0)) * 2.0 \
        + (_shift2(img, 1, -1) - _shift2(img, -1, -1)) \
        + (_shift2(img, 1, 1) - _shift2(img, -1, 1))

    def win(a, b):  # the 7x7 sum of a * b; the unshifted product is fused
        p = a * b
        out = torch.zeros_like(a)
        for dy in range(-3, 4):
            for dx in range(-3, 4):
                out = (_fma(a, b, out) if dy == dx == 0 else
                       out + torch.roll(p, (dy, dx), dims=(-2, -1)))
        return out

    sxx, syy, sxy = win(ix, ix), win(iy, iy), win(ix, iy)
    det = _fma(sxx, syy, -(sxy * sxy))
    tr = sxx + syy
    return _fma(-(0.04 * tr), tr, det)


def _nms3(resp: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression of ``resp`` (-inf for excluded pixels, so
    corner candidates compete only with each other)."""
    m = resp
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            m = torch.maximum(m, _shift2(resp, dy, dx))
    return resp >= m


def _detect_level(img: torch.Tensor, lh: torch.Tensor, lw: torch.Tensor,
                  k: int):
    """One pyramid level [B, n, n] -> its top-k corners.
    @return (ys, xs, resp, valid), each [B, k]: ys, xs int64"""
    b, n = img.shape[0], img.shape[-1]
    dev = img.device
    corners = _fast_corners(img)
    resp = _harris(img)
    corner_resp = torch.where(corners, resp, -math.inf)
    keep = corners & _nms3(corner_resp)
    yy = torch.arange(n, device=dev)[None, :, None]
    xx = torch.arange(n, device=dev)[None, None, :]
    lh, lw = lh[:, None, None], lw[:, None, None]
    inb = (yy >= EDGE) & (yy < lh - EDGE) & (xx >= EDGE) & (xx < lw - EDGE)
    score = torch.where(keep & inb, resp, -math.inf).reshape(b, n * n)
    # the top k by score, equal scores (the -inf slots too) by the lower
    # flat index, as lax.top_k orders them
    top, idx = torch.sort(score, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    return idx // n, idx % n, top, torch.isfinite(top)


def _orientation(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle of [..., 31, 31] patches -> [...] radians:
    the moments summed in float64 and rounded to float32 (as the JAX
    package keeps them), their ``atan2`` in float64, rounded once."""
    r = PATCH // 2
    dev = patches.device
    yy = torch.arange(-r, r + 1, dtype=torch.float64, device=dev)[:, None]
    xx = torch.arange(-r, r + 1, dtype=torch.float64, device=dev)[None, :]
    circ = (yy * yy + xx * xx) <= r * r
    w = patches.double() * circ
    m01 = (w * yy).sum(dim=(-2, -1)).float()
    m10 = (w * xx).sum(dim=(-2, -1)).float()
    return torch.atan2(m01.double(), m10.double()).float()


def _gather_patches(pad: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """[B, k] centres -> [B, k, 31, 31] patches of ``pad`` [B, n + 62, n +
    62] (the level padded by PATCH), the start clamped into it as
    dynamic_slice clamps."""
    r = PATCH // 2
    lim = pad.shape[-1] - PATCH
    off = torch.arange(PATCH, device=pad.device)
    y0 = torch.clamp(ys - r + PATCH, 0, lim)
    x0 = torch.clamp(xs - r + PATCH, 0, lim)
    rows = (y0[..., None] + off)[..., :, None]  # [B, k, 31, 1]
    cols = (x0[..., None] + off)[..., None, :]  # [B, k, 1, 31]
    bi = torch.arange(pad.shape[0], device=pad.device)[:, None, None, None]
    return pad[bi, rows, cols]


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 256] bool -> [..., 4] int64 (bit j of word w is bit 64w + j:
    the little-endian bytes of the JAX package's [..., 8] uint32)."""
    w = torch.as_tensor(_BITS, device=bits.device)
    return (bits.reshape(*bits.shape[:-1], 4, 64).long() * w).sum(dim=-1)


def _descriptors(blurred_pad: torch.Tensor, ys: torch.Tensor,
                 xs: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotated-BRIEF 256-bit descriptors of [B, k] keypoints on the padded
    blurred level [B, n + 62, n + 62] -> [B, k, 4] int64."""
    dev = blurred_pad.device
    pat = torch.as_tensor(_PATTERN, device=dev)  # [256, 4]
    a64 = angles.double()
    ca = torch.cos(a64).float()[..., None]
    sa = torch.sin(a64).float()[..., None]
    lim = blurred_pad.shape[-1] - 1
    bi = torch.arange(blurred_pad.shape[0], device=dev)[:, None, None]

    def sample(y, x):  # pattern offsets rotated by each keypoint's angle
        ry = x * sa + y * ca
        rx = x * ca - y * sa
        py = torch.round(ys[..., None] + ry).to(torch.int64) + PATCH
        px = torch.round(xs[..., None] + rx).to(torch.int64) + PATCH
        return blurred_pad[bi, py.clamp(0, lim), px.clamp(0, lim)]

    bits = sample(pat[:, 0], pat[:, 1]) < sample(pat[:, 2], pat[:, 3])
    return _pack_bits(bits)


def orb_level(canvas: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
              lvl: int, k: int) -> dict:
    """One pyramid level of a [B, 400, 400] float32 canvas of images of
    sizes (h, w) [B]: the JAX package's per-level program.
    @return dict of [B, k] tensors: xs, ys (level-0 pixel centres, f32),
            size (the keypoint diameter), resp, angle, valid; desc [B, k, 4]
            int64"""
    n = _level_dims(lvl + 1)[lvl][0]
    # level-0 px per level px: the area resize shrinks content by exactly
    # CANVAS / n, whatever the content size
    scale = CANVAS / n
    level, lh, lw = _resize_area(canvas, h, w, n)
    ys, xs, resp, valid = _detect_level(level, lh, lw, k)
    pad = F.pad(level, (PATCH,) * 4)
    angles = _orientation(_gather_patches(pad, ys, xs))
    blurred = F.pad(_box_blur(level, 2), (PATCH,) * 4)
    desc = _descriptors(blurred, ys, xs, angles)
    # pixel-centre map-back: level cell x covers level-0 [x s, (x + 1) s)
    # (one rounding, as XLA contracts it)
    s32 = torch.full((), np.float32(scale).item(), device=canvas.device)
    half = torch.full((), -0.5, device=canvas.device)
    return {"xs": _fma(xs.float() + 0.5, s32, half),
            "ys": _fma(ys.float() + 0.5, s32, half),
            "size": torch.full(xs.shape, PATCH * scale, dtype=torch.float32,
                               device=canvas.device),
            "resp": resp, "angle": angles, "desc": desc, "valid": valid}


KEYS = ("xs", "ys", "size", "resp", "angle", "desc", "valid")


def orb_pyramid(canvas: torch.Tensor, sizes: torch.Tensor, nfeatures: int,
                levels: int = N_LEVELS) -> dict:
    """Batched ORB over every level.  canvas [B, 400, 400] float32, sizes
    [B, 2] (h, w).
    @return dict of the levels' results concatenated along dim 1 (see
            ``orb_level``)"""
    budgets = features_per_level(nfeatures, levels)
    h, w = sizes[:, 0].to(torch.int32), sizes[:, 1].to(torch.int32)
    per_level = [orb_level(canvas, h, w, lvl, max(budgets[lvl], 1))
                 for lvl in range(levels)]
    return {key: torch.cat([lv[key] for lv in per_level], dim=1)
            for key in KEYS}


# ---------------------------------------------------------------------------
# keypoint ROI hashes (fdct)
# ---------------------------------------------------------------------------

def roi_boxes(xs: torch.Tensor, ys: torch.Tensor, size: torch.Tensor,
              valid: torch.Tensor, h: torch.Tensor, w: torch.Tensor):
    """The reference's keypoint ROI: a square of side ``size`` whose corner
    sits AT the keypoint, skipped when under 31 px or not inside the image
    with a 2-pixel margin (the JAX package's host test, in float64).
    @return (boxes [..., 4] int64 (top, bottom, left, right), ok [...])"""
    x0, y0, s = xs.double(), ys.double(), size.double()
    ok = (valid & (size >= MIN_ROI) & (x0 > 0) & (y0 > 0)
          & (x0 + s < (w[:, None] - 2)) & (y0 + s < (h[:, None] - 2)))
    xi = torch.floor(x0).long()
    yi = torch.floor(y0).long()
    si = torch.ceil(s).long()
    return torch.stack([yi, yi + si, xi, xi + si], dim=-1), ok


def roi_hashes(canvas: torch.Tensor, boxes: torch.Tensor,
               ok: torch.Tensor) -> torch.Tensor:
    """DCT hashes of the ``ok`` ROIs of each image, every ROI of the batch
    in one set of matmuls.  canvas [B, H, W] float32, boxes [B, K, 4],
    ok [B, K].
    @return [B, K] int64 hashes (0 where not ok)"""
    b, hc, wc = canvas.shape
    dev = canvas.device
    # the ok ROIs first in each row, in keypoint order; the rest of the
    # widest row's slots get a harmless dummy box
    order = torch.sort((~ok).to(torch.uint8), dim=1, stable=True).indices
    kmax = int(ok.sum(dim=1).max()) if ok.numel() else 0
    out = torch.zeros(ok.shape, dtype=torch.int64, device=dev)
    if kmax == 0:
        return out
    order = order[:, :kmax]
    live = torch.gather(ok, 1, order)
    bx = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    dummy = torch.tensor([0, 32, 0, 32], device=dev)
    bx = torch.where(live[..., None], bx, dummy).reshape(-1, 4)
    top, bottom, left, right = bx.unbind(dim=1)
    hh, ww = bottom - top, right - left
    rblur = _blur_radius(hh * ww)
    mh = _axis_map(top, hh, rblur, 32, hc)  # [B * kmax, 32, H]
    mw = _axis_map(left, ww, rblur, 32, wc)  # [B * kmax, 32, W]
    # the blur-and-resize products in float64, each rounded once; the DCT
    # as float32 multiply-add chains (``_dot_chain``): a flat ROI's
    # coefficients are then float32 noise, as in the JAX package, and not
    # the exact ones, which would hash every flat ROI of a size alike
    g = torch.bmm(mh.double().reshape(b, kmax * 32, hc), canvas.double())
    g = torch.bmm(g.float().double().reshape(b * kmax, 32, wc),
                  mw.double().transpose(1, 2)).float()
    d = torch.as_tensor(_D32, device=dev)
    freq = _dot_chain(_dot_chain(d, g), d.T)
    v = freq[:, :9, :9].reshape(-1, 81)[:, torch.as_tensor(_ZZ64, device=dev)]
    thresh = v.double().sum(dim=1, keepdim=True).float() / 64.0
    bits = v > thresh
    bits[:, 0] = False  # ones-place reserved for the null convention
    hv = (bits.long() * torch.as_tensor(_BITS, device=dev)).sum(dim=1)
    hv = torch.where(hv == 0, torch.ones_like(hv), hv).reshape(b, kmax)
    out.scatter_(1, order, torch.where(live, hv, 0))
    return out


def keypoint_hashes(gray: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                    sizes: np.ndarray, valid: np.ndarray,
                    device=None) -> np.ndarray:
    """ROI dct hashes of one image's keypoints (reference
    makeKeyPointHashes), in keypoint order.
    @return [K'] uint64"""
    dev = resolve(device)
    set_hash_numerics()
    h, w = gray.shape
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,
                                      device=dev)[None]
    boxes, ok = roi_boxes(t(xs, torch.float32), t(ys, torch.float32),
                          t(sizes, torch.float32), t(valid, torch.bool),
                          torch.tensor([h], device=dev),
                          torch.tensor([w], device=dev))
    canvas = torch.as_tensor(np.asarray(gray), device=dev).float()[None]
    hv = roi_hashes(canvas, boxes, ok)[0]
    return hv[ok[0]].cpu().numpy().view(np.uint64)


# ---------------------------------------------------------------------------
# public batch API (used by the scanner)
# ---------------------------------------------------------------------------

def _prescale(gray: np.ndarray) -> np.ndarray:
    """Normalise the longest side to exactly 400, up or down, before
    detection (reference sizeLongestSide, LANCZOS), so that every scale of
    an image is featurised on one canvas."""
    long_side = max(gray.shape)
    if long_side == CANVAS:
        return gray
    from PIL import Image
    s = CANVAS / long_side
    im = Image.fromarray(gray).resize(
        (max(1, round(gray.shape[1] * s)), max(1, round(gray.shape[0] * s))),
        Image.LANCZOS)
    return np.asarray(im)


def pack_chunk(imgs: Sequence[np.ndarray], device):
    """Prescaled grayscale images -> (canvas [B, 400, 400] float32, sizes
    [B, 2] int32) on ``device``."""
    canvas = np.zeros((len(imgs), CANVAS, CANVAS), dtype=np.uint8)
    sizes = np.zeros((len(imgs), 2), dtype=np.int32)
    for n, g in enumerate(imgs):
        canvas[n, :g.shape[0], :g.shape[1]] = g
        sizes[n] = g.shape
    return (torch.from_numpy(canvas).to(device).float(),
            torch.from_numpy(sizes).to(device))


def features_chunk(canvas: torch.Tensor, sizes: torch.Tensor,
                   nfeatures: int, want_hashes: bool = True,
                   levels: int = N_LEVELS) -> dict:
    """ORB over one packed chunk, and the keypoint hashes of its ROIs.
    @return ``orb_pyramid``'s dict plus, with ``want_hashes``, "hash"
            [B, K] int64 and "hash_ok" [B, K] bool"""
    set_hash_numerics()
    res = orb_pyramid(canvas, sizes, nfeatures, levels)
    if want_hashes:
        boxes, ok = roi_boxes(res["xs"], res["ys"], res["size"],
                              res["valid"], sizes[:, 0], sizes[:, 1])
        res["hash"] = roi_hashes(canvas, boxes, ok)
        res["hash_ok"] = ok
    return res


def extract_features_batch(grays: Sequence[np.ndarray], nfeatures: int = 400,
                           want_descriptors: bool = True,
                           want_hashes: bool = True, batch: int | None = None,
                           device=None, levels: int | None = None):
    """@param batch images a chunk (default: 64 on a card, where the
           pyramid's ~700 small launches a level are paid per chunk, 16 on
           the CPU, where a chunk's ROI hashes take ~1 GB)
    @param levels pyramid levels (default: N_LEVELS when called)
    @return per image (descriptors [K, 32] uint8 or None, keypoint
            hashes [K'] uint64 or None)"""
    dev = resolve(device)
    batch = batch or (64 if dev.type == "cuda" else 16)
    levels = levels or N_LEVELS
    out = []
    # PIL resizes with the interpreter lock released: one image a thread
    with cf.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        imgs = list(pool.map(_prescale, grays))
    for s in range(0, len(imgs), batch):
        canvas, sizes = pack_chunk(imgs[s:s + batch], dev)
        res = features_chunk(canvas, sizes, nfeatures, want_hashes, levels)
        valid = res["valid"].cpu().numpy()
        desc = res["desc"].cpu().numpy() if want_descriptors else None
        if want_hashes:
            hashes = res["hash"].cpu().numpy().view(np.uint64)
            hash_ok = res["hash_ok"].cpu().numpy()
        for n in range(len(valid)):
            d = None
            if want_descriptors:
                d = np.ascontiguousarray(desc[n][valid[n]]).view(
                    np.uint8).reshape(-1, 32)
            hv = hashes[n][hash_ok[n]] if want_hashes else None
            out.append((d, hv))
    return out
