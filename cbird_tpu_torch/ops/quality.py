"""No-reference image quality score (blur/noise estimate from edge stats).

Vectorized numpy rebuild of the reference qualityScore
(src/cimgops.cpp:313-600, makeDiff/makeEdge/longEdgeCount
:37-152): crop 10% borders, channel-sum "gray", neighbor-difference maps in
both directions, edges = strict local maxima of above-mean differences,
long edges = runs >1 px perpendicular to the scan direction; final
score = 100·edgeRatio + 100·edgeLengthRatio (sharper images score higher;
blur stretches edges, noise shatters them).

The reference's CImg implementation is ~400 LoC of scalar loops +
QtConcurrent; here each step is an array expression.
"""

from __future__ import annotations

import numpy as np


def _make_diff(g: np.ndarray):
    """diff[x] = |g[x-1] - g[x+1]| along axis 1, zero at borders."""
    d = np.zeros_like(g)
    d[:, 1:-1] = np.abs(g[:, :-2] - g[:, 2:])
    h, w = g.shape
    mean = d.sum() / ((w - 1) * (h - 1))
    return d, mean


def _make_edge(diff: np.ndarray, mean: float) -> np.ndarray:
    """Edges: above-mean diffs that are strict local maxima horizontally."""
    c = np.where(diff > mean, diff, 0.0)
    edge = np.zeros(diff.shape, dtype=bool)
    edge[:, 1:-1] = (c[:, 1:-1] > c[:, :-2]) & (c[:, 1:-1] > c[:, 2:])
    return edge


def _long_edge_count(edge_t: np.ndarray) -> int:
    """Count runs of length > 1 along rows of the transposed edge map
    (columns 1..w-2 only, like the reference longEdgeCount)."""
    e = edge_t[:, 1:-1].astype(np.int8)
    if e.size == 0:
        return 0
    # run starts / ends via boundary padding
    padded = np.pad(e, ((0, 0), (1, 1)))
    starts = (padded[:, 1:-1] == 1) & (padded[:, :-2] == 0)
    ends = (padded[:, 1:-1] == 1) & (padded[:, 2:] == 0)
    # run length = end_pos - start_pos + 1 > 1  <=>  not(start & end at same x)
    singles = (starts & ends).sum()
    runs = starts.sum()
    return int(runs - singles)


def quality_score(img: np.ndarray) -> int:
    """@param img HxW grayscale or HxWx3 RGB uint8
    @return score (higher = sharper/cleaner; same scale as the reference)"""
    img = np.asarray(img)
    h, w = img.shape[:2]
    hc, vc = int(w * 0.10), int(h * 0.10)
    img = img[vc:h - vc if h - vc > vc else h, hc:w - hc if w - hc > hc else w]
    if img.shape[0] < 64 or img.shape[1] < 64:
        return 0
    if img.ndim == 3:
        g = img.astype(np.float64).sum(axis=2)  # CImg get_norm(1) = L1 norm
    else:
        g = img.astype(np.float64)

    h_diff, h_mean = _make_diff(g)
    v_diff_t, v_mean = _make_diff(g.T)
    h_edge = _make_edge(h_diff, h_mean)
    v_edge_t = _make_edge(v_diff_t, v_mean)
    v_edge = v_edge_t.T

    # long-edge counts: perpendicular runs (transpose of each edge map)
    h_edge_count = _long_edge_count(h_edge.T)
    v_edge_count = _long_edge_count(v_edge_t)

    edge = h_edge | v_edge
    num_edges = int(edge[1:-1, 1:-1].sum())
    if num_edges == 0:
        return 0
    hh, ww = g.shape
    edge_ratio = num_edges / ((ww - 2) * (hh - 2))
    edge_length_ratio = (v_edge_count + h_edge_count) / num_edges
    return int(100 * edge_ratio + 100 * edge_length_ratio)
