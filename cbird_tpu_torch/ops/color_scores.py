"""The chamfer color score between 32-color descriptors: CUDA kernel K6 and
its plain twin.

``color_scores`` computes ``cbird_tpu/ops/color.py`` ``_color_scores``
(:266) and ``_color_scores_oneside`` (:315), the [Q, C] scores of a needle
block against a haystack window that ``color_topk_local`` (:397),
``color_topk`` (:435) and ``color_self_block`` (:352) rank (XLA in the
JAX package; ``ops/color.py`` holds their port).  Plain PyTorch would
materialise ``[Q, 32, C, 32]``; the kernel is ``csrc/color_scores.cu``,
whose header says what bounds it on an H100.

Contract, for needle q and haystack row c (store row ``base + c``):

- BAD_SCORE when a count is 0, the row is not valid, the row lies outside
  ``[lo, hi)``, or (``side="both"`` only) the counts differ by more
  than 2;
- else ``1 + sum over the colors of side A of min over the colors of side
  B of max(sqrt(d2), floor 0.06 to 0)``, with A the side with more colors
  (ties: the needle) for ``side="both"``, the needle for ``"ab"`` and the
  row for ``"ba"``.  ``d2 = fma(dv, dv, fma(dl, dl, du * du))`` (needle
  minus row, each fma rounded once), the minimum taken on ``d2``, the
  square root rounded once and the sum in ascending color order.

That is XLA's order on the CPU: the kernel, the plain twin and the JAX
package's ``_color_scores``, ``_color_scores_oneside``,
``color_self_block`` and ``color_topk`` give the same bits (the tests
hold the twin to them).  The twin takes the fmas and the root through
``ops/exact32.py``.  On a CPU tensor ``color_scores`` runs
``color_scores_plain``; on any other device it launches the kernel or
raises.  ``color_scores.launches`` counts the calls that launched it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..device import launch_on, one_device
from .exact32 import fma32, sqrt32

NUM_COLORS = 32
BAD_SCORE = np.float32(3.0e38)
SIDES = {"both": 0, "ab": 1, "ba": 2}
_NO_LIMIT = 1 << 62
_FLOOR = 0.06  # a distance below it counts 0 (compared in float32)


def _finish(m2: torch.Tensor) -> torch.Tensor:
    d = sqrt32(torch.clamp_min(m2, 0.0))
    floor = torch.tensor(_FLOOR, dtype=torch.float32, device=d.device)
    return torch.where(d < floor, torch.zeros_like(d), d)


def _plain_tile(nc, nn, hc, hn):
    """Both directed sums of one [Q, Cc] tile, one needle color at a time
    (temporaries [Q, Cc, 32]): (s_ab, s_ba).  Colors past the largest
    count add 0 or take no part in a minimum, so their loops stop there."""
    big = torch.tensor(float(BAD_SCORE), device=nc.device)
    jmask = torch.arange(NUM_COLORS, device=nc.device)[None, :] < hn[:, None]
    s_ab = torch.zeros((nc.shape[0], hc.shape[0]), dtype=torch.float32,
                       device=nc.device)
    mins = torch.full((nc.shape[0], hc.shape[0], NUM_COLORS), big,
                      device=nc.device)  # min over the needle's colors
    for i in range(int(nn.max())):
        on = (i < nn)[:, None]  # [Q, 1]
        dl, du, dv = (nc[:, i, k][:, None, None] - hc[None, :, :, k]
                      for k in range(3))
        d2 = fma32(dv, dv, fma32(dl, dl, du * du))
        m = torch.where(jmask[None], d2, big).amin(dim=2)
        s_ab = s_ab + torch.where(on, _finish(m), 0.0)
        mins = torch.minimum(mins, torch.where(on[:, :, None], d2, big))
    s_ba = torch.zeros_like(s_ab)
    for j in range(int(hn.max())):
        s_ba = s_ba + torch.where(jmask[None, :, j], _finish(mins[:, :, j]),
                                  0.0)
    return s_ab, s_ba


def color_scores_plain(n_colors, n_counts, h_colors, h_counts, h_valid,
                       side: str = "both", lo: int = 0,
                       hi: int = _NO_LIMIT, base: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract): only the needles
    and rows that can score, in tiles of at most ~2^24 (CPU 2^18) color
    pairs' rows.  @return [Q, C] float32"""
    q, c = n_colors.shape[0], h_colors.shape[0]
    dev = n_colors.device
    out = torch.full((q, c), float(BAD_SCORE), dtype=torch.float32,
                     device=dev)
    rows = base + torch.arange(c, device=dev)
    live = h_valid & (h_counts > 0) & (rows >= lo) & (rows < hi)
    qi = torch.nonzero(n_counts > 0)[:, 0]
    ci = torch.nonzero(live)[:, 0]
    if qi.numel() == 0 or ci.numel() == 0:
        return out
    nc, nn = n_colors[qi], n_counts[qi].to(torch.int64)
    budget = 1 << (24 if dev.type == "cuda" else 18)
    step = max(1, budget // (qi.numel() * NUM_COLORS))
    for c0 in range(0, ci.numel(), step):
        cols = ci[c0:c0 + step]
        hn = h_counts[cols].to(torch.int64)
        s_ab, s_ba = _plain_tile(nc, nn, h_colors[cols], hn)
        if side == "both":
            s = torch.where(nn[:, None] >= hn[None, :], s_ab, s_ba)
            s = torch.where((nn[:, None] - hn[None, :]).abs() > 2,
                            float(BAD_SCORE), 1.0 + s)
        else:
            s = 1.0 + (s_ab if side == "ab" else s_ba)
        out[qi[:, None], cols[None, :]] = s
    return out


def check_operands(n_colors, n_counts, h_colors, h_counts, h_valid) -> None:
    """Shapes, types, devices and contiguity the kernel accepts."""
    if n_colors.dtype != torch.float32 or h_colors.dtype != torch.float32:
        raise TypeError("colors must be float32 Luv")
    if n_counts.dtype != torch.int32 or h_counts.dtype != torch.int32:
        raise TypeError("counts must be int32")
    if h_valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    q, c = n_colors.shape[0], h_colors.shape[0]
    if n_colors.shape[1:] != (NUM_COLORS, 3) \
            or h_colors.shape[1:] != (NUM_COLORS, 3) \
            or n_counts.shape != (q,) or h_counts.shape != (c,) \
            or h_valid.shape != (c,):
        raise ValueError(f"bad shapes {tuple(n_colors.shape)} "
                         f"{tuple(h_colors.shape)}")
    ts = (n_colors, n_counts, h_colors, h_counts, h_valid)
    if len({t.device for t in ts}) != 1:
        raise ValueError("operands on different devices")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("operands must be contiguous")
    if h_colors.data_ptr() % 16:
        raise ValueError("haystack colors must be 16-byte aligned")
    if max(q, c) >= 1 << 31:
        raise ValueError("too many rows for int32 indexing")


_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_VP, _VP, _INT, _VP, _VP, _VP, _INT, _INT, _LL, _LL, _LL, _VP, _LL,
         _VP]


def color_scores(n_colors: torch.Tensor, n_counts: torch.Tensor,
                 h_colors: torch.Tensor, h_counts: torch.Tensor,
                 h_valid: torch.Tensor, side: str = "both", lo: int = 0,
                 hi: int = _NO_LIMIT, base: int = 0,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """[Q, C] chamfer scores (BAD_SCORE = rejected).

    @param n_colors [Q, 32, 3] float32 Luv, n_counts [Q] int32
    @param h_colors [C, 32, 3] float32, h_counts [C] int32, h_valid [C]
    @param side "both" (the side by the counts), "ab" or "ba"
    @param lo, hi, base rows outside [lo, hi) of the store, whose row c
           here is base + c, are rejected
    @param out a [Q, >= C] float32 buffer with unit column stride, written
           in its first C columns (default: a new [Q, C] tensor)
    """
    if side not in SIDES:
        raise ValueError(f"side must be one of {sorted(SIDES)}")
    dev = one_device("color_scores", n_colors, n_counts, h_colors, h_counts,
                     h_valid, out)
    if dev.type == "cpu":
        res = color_scores_plain(n_colors, n_counts, h_colors, h_counts,
                                 h_valid, side, lo, hi, base)
        if out is None:
            return res
        out[:, :res.shape[1]] = res
        return out
    check_operands(n_colors, n_counts, h_colors, h_counts, h_valid)
    lib = _build.load_kernel("color_scores", "cbird_color_scores", _ARGS)
    q, c = n_colors.shape[0], h_colors.shape[0]
    if out is None:
        out = torch.empty((q, c), dtype=torch.float32, device=h_colors.device)
    if out.dtype != torch.float32 or out.device != h_colors.device \
            or out.shape[0] != q or out.shape[1] < c or out.stride(1) != 1:
        raise ValueError("bad output buffer")
    if q == 0 or c == 0:
        return out
    with launch_on(dev):
        _build.check(lib, lib.cbird_color_scores(
            n_colors.data_ptr(), n_counts.data_ptr(), q, h_colors.data_ptr(),
            h_counts.data_ptr(), h_valid.data_ptr(), c, SIDES[side], base,
            lo, min(hi, _NO_LIMIT), out.data_ptr(), out.stride(0),
            torch.cuda.current_stream(dev).cuda_stream), "color_scores")
    color_scores.launches += 1
    return out


color_scores.launches = 0
