"""Plain reference of the color index's search (``-p.alg color``), and its
control.

A descriptor is [33, 4] uint16: rows 0-31 hold a color's quantized l, u, v
(and a weight, which the score does not read), row 32 column 0 the color
count n.  Dequantized in float32 (l = q * 100 / 65535, u = q * 354 /
65535 - 134, v = q * 262 / 65535 - 140: the stored format's definition).

The score of a needle (colors a, count x) against a live row (colors b,
count y): none when x or y is 0 or |x - y| > 2; else 1 + the sum over the
colors of the side with more colors (ties: the needle) of the distance to
the nearest color of the other side, a distance below 0.06 counting 0.
A needle's answer is its k best rows by (score, row).  The reference
computes in float64 (above the configuration's float32), the sums in
ascending color order.  Nothing of the port is imported or read, apart
from the answers it judges.

The control is the same function in bfloat16, the precision below the
configuration's float32: colors, differences, squares, roots and sums
each rounded to bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

NUM_COLORS = 32
FLOOR = 0.06
MAX_COUNT_GAP = 2
_U16 = 65535.0
_FAR = 1.0e6


def dequantize(codes: torch.Tensor) -> torch.Tensor:
    """[..., 3] l, u, v codes (any integer type holding the uint16
    values) -> float32 Luv."""
    q = codes.float()
    return torch.stack([q[..., 0] * 100.0 / _U16,
                        q[..., 1] * 354.0 / _U16 - 134.0,
                        q[..., 2] * 262.0 / _U16 - 140.0], dim=-1)


def _side_sum(d: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Sum over the first ``count`` colors of the distances, a distance
    below FLOOR counting 0.
    @param d [..., 32] distances to the nearest color; count a scalar or
           of d[..., 0]'s shape"""
    d = torch.where(d < FLOOR, torch.zeros_like(d), d)
    s = torch.zeros_like(d[..., 0])
    for i in range(NUM_COLORS):  # ascending color order
        s = s + torch.where(count > i, d[..., i], torch.zeros_like(s))
    return s


def _nearest(a: torch.Tensor, b: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """[cb, 32, 32] distances of one needle's colors ``a`` [32, 3] to
    each row's colors ``b`` [cb, 32, 3].  float64: |a|^2 + |b|^2 - 2 a.b
    as one matrix product (the cancellation is ~1e-11 on squares below
    1e5, far under float32's rounding); otherwise each difference, square
    and sum as its own operation in ``dtype``."""
    if dtype == torch.float64:
        cb = b.shape[0]
        flat = b.reshape(cb * NUM_COLORS, 3)
        d2 = (a @ flat.T).view(NUM_COLORS, cb, NUM_COLORS).permute(1, 0, 2)
        d2 = (d2 * -2.0 + (a * a).sum(1)[None, :, None]
              + (b * b).sum(2)[:, None, :])
        return torch.sqrt(torch.clamp_min(d2, 0.0))
    diff = [a[None, :, None, k] - b[:, None, :, k] for k in range(3)]
    return torch.sqrt((diff[0] * diff[0] + diff[1] * diff[1])
                      + diff[2] * diff[2])


def scores(n_colors: torch.Tensor, n_counts: torch.Tensor,
           h_colors: torch.Tensor, h_counts: torch.Tensor,
           h_valid: torch.Tensor, dtype: torch.dtype = torch.float64,
           rows_per_block: int = 1 << 18) -> torch.Tensor:
    """[Q, C] scores of needles against rows (inf: no score).

    @param n_colors [Q, 32, 3] float32, n_counts [Q]; h_colors [C, 32, 3],
           h_counts [C], h_valid [C] bool
    @param dtype the arithmetic's precision"""
    q, c = n_colors.shape[0], h_colors.shape[0]
    dev = n_colors.device
    out = torch.full((q, c), float("inf"), dtype=torch.float64, device=dev)
    ar = torch.arange(NUM_COLORS, device=dev)
    # colors past a count sit far from every color: never the nearest
    far = torch.tensor(_FAR, dtype=torch.float32, device=dev)
    nc = torch.where(ar[None, :, None] < n_counts[:, None, None], n_colors,
                     far).to(dtype)
    hc = torch.where(ar[None, :, None] < h_counts[:, None, None], h_colors,
                     far).to(dtype)
    for i in range(q):
        x = n_counts[i]
        for c0 in range(0, c, rows_per_block):
            y = h_counts[c0:c0 + rows_per_block]
            d = _nearest(nc[i], hc[c0:c0 + rows_per_block], dtype)
            s = torch.where(x >= y, _side_sum(d.amin(dim=2), x),
                            _side_sum(d.amin(dim=1), y))
            ok = (h_valid[c0:c0 + rows_per_block] & (y > 0) & (x > 0)
                  & ((x - y).abs() <= MAX_COUNT_GAP))
            out[i, c0:c0 + rows_per_block] = torch.where(
                ok, (1.0 + s).double(), float("inf"))
    return out


def best(sc: torch.Tensor, k: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """Each needle's k best rows by (score, row) and their scores."""
    val, rows = torch.sort(sc, dim=1, stable=True)
    val, rows = val[:, :k].cpu().numpy(), rows[:, :k].cpu().numpy()
    return [(r[np.isfinite(v)], v[np.isfinite(v)]) for v, r in zip(val, rows)]


def gaps(sc: torch.Tensor, answers: list, k: int) -> dict[str, float]:
    """How far the answers lie from the function's.

    @param sc [Q, C] reference scores (``scores``)
    @param answers per needle (rows, integer scores): the k best rows in
           order and each score cut to an integer, as the index returns
    @return rank_gap: the widest amount by which the j-th answered row's
            score exceeds the j-th best score (inf when an answer has
            another length than the function's); score_err: the widest
            distance of a row's score outside [s, s + 1) for its
            integer s"""
    top = torch.sort(sc, dim=1).values[:, :k].double().cpu().numpy()
    rank_gap = score_err = 0.0
    for i, (rows, ints) in enumerate(answers):
        want = top[i][np.isfinite(top[i])]
        rows = np.asarray(rows, np.int64)
        if len(rows) != len(want):
            return {"rank_gap": float("inf"), "score_err": float("inf")}
        if not len(rows):
            continue
        got = sc[i, torch.as_tensor(rows, device=sc.device)].double()
        got = got.cpu().numpy()
        if not np.isfinite(got).all():
            return {"rank_gap": float("inf"), "score_err": float("inf")}
        rank_gap = max(rank_gap, float((got - want).max()))
        ints = np.asarray(ints, np.float64)
        score_err = max(score_err, float(np.maximum(
            ints - got, got - (ints + 1)).max()))
    return {"rank_gap": rank_gap, "score_err": max(score_err, 0.0)}
