"""Grid/mosaic splitting (-select-grid) + histogram contrast stretch.

Rebuild of the reference demosaic path (src/cvutil.cpp:
brightnessAndContrastAuto/grayLevel/stretchContrast :578-665, findSolidLines
:1403-1443, demosaicHough :1445+): collage sheets are split into their cell
images by finding solid separator rows/columns (low intensity variance
spanning the image), then emitting the sub-rectangles between them.

Two detectors, tried in order:
- solid separators (low intensity variance spanning the image) — the
  common contact-sheet case, vectorized row/col variance scans;
- edge-projection lines for NON-solid gutters (the reference's
  Canny+Hough path): collage cell boundaries show as rows/cols where the
  luminance step is high across most of the span — the axis-aligned
  specialization of a Hough vote, with every theta=0/90 vote accumulated
  into one projection (grids are axis-aligned, so the general transform's
  angle sweep buys nothing).
"""

from __future__ import annotations

import numpy as np


def gray_level(gray: np.ndarray, clip_percent: float = 1.0) -> tuple[int, int]:
    """Histogram-clipped intensity range (reference grayLevel)."""
    if clip_percent <= 0:
        return int(gray.min()), int(gray.max())
    hist = np.bincount(gray.reshape(-1), minlength=256).astype(np.float64)
    cum = np.cumsum(hist)
    total = cum[-1]
    clip = total * clip_percent / 100.0 / 2.0
    lo = int(np.searchsorted(cum, clip))
    hi = int(np.searchsorted(cum, total - clip))
    return lo, max(hi, lo + 1)


def stretch_contrast(img: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Linear LUT stretch of [lo, hi] to [0, 255] (reference stretchContrast)."""
    scale = 255.0 / max(hi - lo, 1)
    out = (img.astype(np.float64) - lo) * scale
    return np.clip(out, 0, 255).astype(np.uint8)


def brightness_contrast_auto(img: np.ndarray, clip_percent: float = 1.0) -> np.ndarray:
    gray = img if img.ndim == 2 else \
        (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]).astype(np.uint8)
    lo, hi = gray_level(gray, clip_percent)
    return stretch_contrast(img, lo, hi)


def find_solid_lines(gray: np.ndarray, thresh: float = 10.0,
                     min_gap: int = 32) -> tuple[list[int], list[int]]:
    """Rows/cols whose intensity stddev is below thresh (solid separators),
    with at least min_gap spacing (reference findSolidLines)."""
    row_std = gray.std(axis=1)
    col_std = gray.std(axis=0)

    def pick(stds: np.ndarray) -> list[int]:
        out = []
        i = 0
        n = len(stds)
        while i < n:
            if stds[i] < thresh:
                out.append(i)
                i += min_gap
            else:
                i += 1
        return out

    return pick(row_std), pick(col_std)


def find_edge_lines(gray: np.ndarray, min_coverage: float = 0.75,
                    min_gap: int = 32) -> tuple[list[int], list[int]]:
    """Axis-aligned separator lines for textured (non-solid) gutters
    (reference demosaicHough, src/cvutil.cpp:1445+): rows/cols where the
    perpendicular luminance step exceeds an adaptive threshold across
    ≥ min_coverage of the span.  Adjacent collage cells have uncorrelated
    content, so their shared boundary is an edge along nearly its whole
    length, while rows inside a photo rarely exceed ~2x the global edge
    density."""
    g = gray.astype(np.int16)
    dy = np.abs(np.diff(g, axis=0))
    dx = np.abs(np.diff(g, axis=1))
    ty = max(10.0, float(np.percentile(dy, 90)))
    tx = max(10.0, float(np.percentile(dx, 90)))
    row_cov = (dy > ty).mean(axis=1)
    col_cov = (dx > tx).mean(axis=0)

    def pick(cov: np.ndarray) -> list[int]:
        out = []
        i = 0
        while i < len(cov):
            if cov[i] >= min_coverage:
                # take the strongest line of the local cluster
                j = int(np.argmax(cov[i:i + min_gap])) + i
                out.append(j + 1)  # diff index i = boundary between i, i+1
                i += min_gap
            else:
                i += 1
        return out

    return pick(row_cov), pick(col_cov)


def _grid_lines(lines: list[int], size: int, min_cell: int = 48,
                margin: int = 8) -> list[int]:
    """Longest chain of boundaries forming a near-regular grid.

    The reference only splits when the detected lines look like a grid:
    consecutive gaps must be s, 2s or s/2 of some base step s, and the
    chain needs >= 3 boundaries (selectLines + the count<3 full-image
    fallback, src/cvutil.cpp:1553-1640).  Without this, any single strong
    natural edge spanning the image (a horizon, a roofline) would split
    an ordinary photo in two.  Image boundaries 0/size participate as
    candidate grid lines, as in the reference.
    @return chained boundary positions incl. extremes, or [] (not a grid)
    """
    pts = sorted({0, size, *lines})
    best: list[int] = []
    for k in range(len(pts) - 1):
        for i in range(k + 1, len(pts)):
            s = pts[i] - pts[k]
            if s < min_cell:
                continue
            accepted = [s, 2 * s]
            if s // 2 >= min_cell:
                accepted.append(s // 2)
            chain = [pts[k], pts[i]]
            prev = i
            advanced = True
            while advanced:
                advanced = False
                for j in range(prev + 1, len(pts)):
                    d = pts[j] - pts[prev]
                    if any(abs(d - a) <= margin for a in accepted):
                        chain.append(pts[j])
                        prev = j
                        advanced = True
                        break
            key = (len(chain), chain[-1] - chain[0])
            if not best or key > (len(best), best[-1] - best[0]):
                best = chain
    return best if len(best) >= 3 else []


def demosaic_rects_hough(gray: np.ndarray, min_cell: int = 48,
                         min_gap: int = 32, min_coverage: float = 0.75
                         ) -> list[tuple[int, int, int, int]]:
    """Cell rectangles from edge-projection separator lines (collages
    whose cells touch directly, no solid gutter)."""
    h, w = gray.shape
    rows, cols = find_edge_lines(gray, min_coverage, min_gap)
    hb = _grid_lines(rows, h, min_cell)
    vb = _grid_lines(cols, w, min_cell)
    if not hb and not vb:
        return []  # neither axis forms a regular grid
    hb = hb or [0, h]
    vb = vb or [0, w]
    vs = [(a, b) for a, b in zip(hb[:-1], hb[1:]) if b - a >= min_cell]
    hs = [(a, b) for a, b in zip(vb[:-1], vb[1:]) if b - a >= min_cell]
    if len(vs) * len(hs) <= 1:
        return []
    return [(t, b, l, r) for t, b in vs for l, r in hs]


def demosaic_rects(gray: np.ndarray, thresh: float = 10.0, min_gap: int = 32,
                   min_cell: int = 48) -> list[tuple[int, int, int, int]]:
    """Split a collage into cell rectangles (t, b, l, r), excluding
    separator lines; cells smaller than min_cell px are dropped.  Falls
    back to edge-projection detection when no solid gutter exists."""
    h, w = gray.shape
    rows, cols = find_solid_lines(gray, thresh, min_gap)
    row_std = gray.std(axis=1)
    col_std = gray.std(axis=0)

    def spans(lines: list[int], stds: np.ndarray, size: int):
        # merge adjacent separator lines into bands, cells live between bands
        bands: list[list[int]] = []
        for x in lines:
            if bands and x - bands[-1][1] <= 2:
                bands[-1][1] = x
            else:
                bands.append([x, x])
        edges = [0] + [e for b in bands for e in (b[0], b[1] + 1)] + [size]
        out = []
        for i in range(0, len(edges) - 1, 2):
            a, b = edges[i], edges[i + 1]
            # the min_gap skip only marks the first line of a wide gap —
            # trim remaining solid rows/cols off both ends of the span
            while a < b and stds[a] < thresh:
                a += 1
            while b > a and stds[b - 1] < thresh:
                b -= 1
            if b - a >= min_cell:
                out.append((a, b))
        return out

    vspans = spans(rows, row_std, h)
    hspans = spans(cols, col_std, w)
    if len(vspans) * len(hspans) <= 1:
        # no solid gutters — try the edge-projection (Hough) detector
        return demosaic_rects_hough(gray, min_cell=min_cell,
                                    min_gap=min_gap)
    return [(t, b, l, r) for (t, b) in vspans for (l, r) in hspans]
