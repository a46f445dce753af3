"""Batched DCT perceptual hashing + de-letterbox autocrop in PyTorch.

Port of ``cbird_tpu/ops/dct_hash.py`` (same math, same layout at the public
functions).  A batch of grayscale images lives in a uint8 canvas [B, H, W];
``autocrop_boxes`` finds per-image crop boxes with masked reductions, blur
+ area resize are per-image linear maps applied as batched matmuls, the
32x32 DCT is two matmuls with the constant DCT-II matrix, and 64 zig-zag
coefficients are thresholded against their mean.

This is matmul and reduction code that the JAX package computes outside
any Pallas kernel, so it stays plain PyTorch.  All matmuls run in full
float32 (``device.set_hash_numerics``): a coefficient sitting at the mean
can flip a bit when a sum is taken in another order, so the port is held
to <= 1 bit per hash against ``cbird_tpu`` and the numpy golden model.

A hash is one int64 bit pattern (bit k of the uint64 hash is bit k of the
pattern); ``split_u64`` / ``combine_u32`` convert to and from the JAX
package's [N, 2] uint32 (lo, hi) layout.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from cbird_tpu.ops.ref_numpy import dct2_matrix, zigzag_table

from ..device import resolve, set_hash_numerics

_ZZ64 = np.asarray(zigzag_table(9)[6:70])  # 64 positions in the 9x9 block
_D32 = np.asarray(dct2_matrix(32), dtype=np.float32)
# bit weights of the packed hash; bit 63 is the int64 sign bit
_BITS = np.array([1 << i for i in range(63)] + [-(1 << 63)], dtype=np.int64)


# ---------------------------------------------------------------------------
# autocrop (de-letterbox)
# ---------------------------------------------------------------------------

def _axis_runs(diff: torch.Tensor, extent: torch.Tensor, n: int, dim: int):
    """First/last True index along ``dim`` within [0, extent); all-False
    lines give (extent, 0), the reference scan loops' convention."""
    shape = [1, 1, 1]
    shape[dim] = n
    idx = torch.arange(n, dtype=torch.int32, device=diff.device).view(shape)
    first = torch.where(diff, idx, n).amin(dim=dim)
    last = torch.where(diff, idx, -1).amax(dim=dim)
    any_ = last >= 0
    return torch.where(any_, first, extent), torch.where(any_, last + 1, 0)


def autocrop_boxes(canvas: torch.Tensor, sizes: torch.Tensor,
                   crop_range: int = 20) -> torch.Tensor:
    """Per-image crop boxes [B, 4] int32 = (t, b, l, r); see
    ``cbird_tpu.ops.dct_hash.autocrop_boxes`` for the semantics."""
    B, H, W = canvas.shape
    dev = canvas.device
    h = sizes[:, 0].to(torch.int32)[:, None]  # [B,1]
    w = sizes[:, 1].to(torch.int32)[:, None]
    color = canvas[:, 0:1, 0:1]

    rows_i = torch.arange(H, dtype=torch.int32, device=dev)
    cols_i = torch.arange(W, dtype=torch.int32, device=dev)
    valid = ((rows_i[None, :, None] < h[..., None])
             & (cols_i[None, None, :] < w[..., None]))
    ad = torch.maximum(canvas, color) - torch.minimum(canvas, color)
    diff = (ad > crop_range) & valid  # [B,H,W]

    min_w_cov = torch.floor(w.float() * 0.66).to(torch.int32)
    min_h_cov = torch.floor(h.float() * 0.66).to(torch.int32)
    max_h_margin = torch.floor(w.float() * 0.05).to(torch.int32)
    max_v_margin = torch.floor(h.float() * 0.05).to(torch.int32)

    left_r, right_r = _axis_runs(diff, w, W, dim=2)  # [B,H]
    is_lb_row = (left_r > 0) & (right_r < w) & (left_r + w - right_r > min_w_cov)
    top_c, bot_c = _axis_runs(diff, h, H, dim=1)  # [B,W]
    is_lb_col = (top_c > 0) & (bot_c < h) & (top_c + h - bot_c > min_h_cov)

    r_idx = rows_i[None, :]
    c_idx = cols_i[None, :]
    h2 = h // 2
    w2 = w // 2

    def amax(x):
        return x.amax(dim=1, keepdim=True)

    def amin(x):
        return x.amin(dim=1, keepdim=True)

    top = amax(torch.where(is_lb_row & (r_idx <= h2), r_idx, -1)) + 1
    bottom = amin(torch.where(is_lb_row & (r_idx >= h2 + 1) & (r_idx < h),
                              r_idx, h))
    left = amax(torch.where(is_lb_col & (c_idx <= w2), c_idx, -1)) + 1
    right = amin(torch.where(is_lb_col & (c_idx >= w2 + 1) & (c_idx < w),
                             c_idx, w))

    bmargin = h - bottom
    unbalanced_v = (top - bmargin).abs() > max_v_margin
    top2 = torch.where(unbalanced_v & (top > bmargin), bmargin, top)
    bottom2 = torch.where(unbalanced_v & (top <= bmargin), h - top, bottom)
    rmargin = w - right
    unbalanced_h = (left - rmargin).abs() > max_h_margin
    left2 = torch.where(unbalanced_h & (left > rmargin), rmargin, left)
    right2 = torch.where(unbalanced_h & (left <= rmargin), w - left, right)
    top, bottom, left, right = top2, bottom2, left2, right2

    some_crop = ((left != 0) & (right != w)) | ((top != 0) & (bottom != h))
    ok = (some_crop & (left < right) & (top < bottom)
          & ((right - left).float() / w.float() > 0.65)
          & ((bottom - top).float() / h.float() > 0.65))
    zero = torch.zeros_like(h)
    return torch.cat([torch.where(ok, top, zero), torch.where(ok, bottom, h),
                      torch.where(ok, left, zero), torch.where(ok, right, w)],
                     dim=1)


def full_boxes(sizes: torch.Tensor) -> torch.Tensor:
    h = sizes[:, 0:1].to(torch.int32)
    w = sizes[:, 1:2].to(torch.int32)
    zero = torch.zeros_like(h)
    return torch.cat([zero, h, zero, w], dim=1)


# ---------------------------------------------------------------------------
# fused blur + area-resize as a per-image linear map
# ---------------------------------------------------------------------------

def _axis_map(start: torch.Tensor, size: torch.Tensor, rblur: torch.Tensor,
              n_out: int, n_canvas: int) -> torch.Tensor:
    """[B, n_out, n_canvas] = area-resize(n_out) o mean-blur(2r+1,
    reflect101) restricted to canvas range [start, start+size), in the
    closed form of ``cbird_tpu.ops.dct_hash._axis_map`` (four prefix sums
    of the trapezoid overlap)."""
    dev = size.device
    size_f = size.float()[:, None, None]          # [B,1,1]
    sy = size_f / n_out
    i = torch.arange(n_out, dtype=torch.float32, device=dev)[None, :, None]
    lo = i * sy
    hi = (i + 1.0) * sy
    k_inv = 1.0 / (2.0 * rblur.float()[:, None, None] + 1.0)
    r = rblur.to(torch.int32)[:, None]            # [B,1]
    size_i = size.to(torch.int32)[:, None]
    tl = (torch.arange(n_canvas, dtype=torch.int32, device=dev)[None, :]
          - start.to(torch.int32)[:, None])        # [B,n_canvas]

    def cum(y_excl: torch.Tensor) -> torch.Tensor:
        yf = torch.minimum(y_excl.float()[:, None, :].clamp(min=0.0), size_f)
        return (torch.minimum(torch.maximum(yf, lo), hi) - lo) / sy

    interior = cum(tl + r + 1) - cum(tl - r)
    left = (tl >= 1).float()[:, None, :] * cum(r - tl + 1)
    right = (tl <= size_i - 2).float()[:, None, :] * (
        cum(size_i.expand_as(tl)) - cum(2 * size_i - 2 - tl - r))
    valid_t = ((tl >= 0) & (tl < size_i)).float()[:, None, :]
    return k_inv * (interior + left + right) * valid_t


def _blur_radius(area: torch.Tensor) -> torch.Tensor:
    """Size-adaptive blur radius (kernel 0/3/5/7 -> r 0/1/2/3)."""
    return torch.where(area <= 32 * 32, 0,
                       torch.where(area <= 64 * 64, 1,
                                   torch.where(area <= 128 * 128, 2, 3))
                       ).to(torch.int32)


def dct_hash_from_boxes(canvas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Hash each image's crop box: canvas [B,H,W] uint8, boxes [B,4] ->
    [B] int64 hashes (0 never occurs: 0 means null)."""
    B, H, W = canvas.shape
    dev = canvas.device
    top, bottom = boxes[:, 0], boxes[:, 1]
    left, right = boxes[:, 2], boxes[:, 3]
    hh = bottom - top
    ww = right - left
    rblur = _blur_radius(hh * ww)
    mh = _axis_map(top, hh, rblur, 32, H)    # [B,32,H]
    mw = _axis_map(left, ww, rblur, 32, W)   # [B,32,W]

    x = canvas.float()
    g = torch.bmm(torch.bmm(mh, x), mw.transpose(1, 2))  # [B,32,32]
    d = torch.as_tensor(_D32, device=dev)
    freq = d @ g @ d.T

    v = freq[:, :9, :9].reshape(B, 81)[:, torch.as_tensor(_ZZ64, device=dev)]
    thresh = v.sum(dim=1, keepdim=True) / 64.0
    bits = v > thresh
    bits[:, 0] = False  # ones-place reserved for the null convention
    h = (bits.long() * torch.as_tensor(_BITS, device=dev)).sum(dim=1)
    return torch.where(h == 0, torch.ones_like(h), h)


def hash_batch(canvas: torch.Tensor, sizes: torch.Tensor, do_crop: bool = False,
               crop_range: int = 20):
    """Autocrop (optional) + DCT hash.
    @return (hashes [B] int64, boxes [B,4] int32)"""
    set_hash_numerics()
    boxes = (autocrop_boxes(canvas, sizes, crop_range) if do_crop
             else full_boxes(sizes))
    return dct_hash_from_boxes(canvas, boxes), boxes


# ---------------------------------------------------------------------------
# host-facing convenience API
# ---------------------------------------------------------------------------

def pack_canvas(images: Sequence[np.ndarray], height: int, width: int):
    """Pack variable-sized grayscale uint8 images into a canvas batch."""
    canvas = np.zeros((len(images), height, width), dtype=np.uint8)
    sizes = np.zeros((len(images), 2), dtype=np.int32)
    for n, img in enumerate(images):
        h, w = img.shape
        if h > height or w > width:
            raise ValueError(f"image {n} ({h}x{w}) exceeds canvas {height}x{width}")
        canvas[n, :h, :w] = img
        sizes[n] = (h, w)
    return canvas, sizes


def combine_u32(pairs: np.ndarray) -> np.ndarray:
    """[N,2] uint32 (lo,hi) -> [N] uint64."""
    pairs = np.asarray(pairs, dtype=np.uint32)
    return pairs[:, 0].astype(np.uint64) | (pairs[:, 1].astype(np.uint64) << np.uint64(32))


def split_u64(hashes: np.ndarray) -> np.ndarray:
    """[N] uint64 -> [N,2] uint32 (lo,hi)."""
    h = np.asarray(hashes, dtype=np.uint64)
    lo = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (h >> np.uint64(32)).astype(np.uint32)
    return np.stack([lo, hi], axis=1)


class DctHasher:
    """Hashing front-end: packs host images into canvas batches on
    ``device`` and returns uint64 hashes."""

    def __init__(self, canvas_hw: tuple[int, int] = (640, 640), batch: int = 64,
                 crop_range: int = 20, device=None):
        self.canvas_hw = canvas_hw
        self.batch = batch
        self.crop_range = crop_range
        self.device = resolve(device)

    def hash_images(self, images: Sequence[np.ndarray], do_crop: bool = False) -> np.ndarray:
        """@return [N] uint64 dct hashes (0 is never produced; 0 == null)."""
        if not images:
            return np.zeros(0, dtype=np.uint64)
        out = []
        for i in range(0, len(images), self.batch):
            canvas, sizes = pack_canvas(images[i:i + self.batch],
                                        *self.canvas_hw)
            hashes, _ = hash_batch(
                torch.from_numpy(canvas).to(self.device),
                torch.from_numpy(sizes).to(self.device),
                do_crop=do_crop, crop_range=self.crop_range)
            out.append(hashes.cpu().numpy().view(np.uint64))
        return np.concatenate(out)
