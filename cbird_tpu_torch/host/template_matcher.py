"""Template matcher: the expensive verification filter (`-p.tm`).

A copy of ``cbird_tpu/host/template_matcher.py`` with its device work on
the port: for each candidate of a match group, detect ORB features on the
needle (needleFeatures) and the candidate (haystackFeatures),
mutual-nearest radius match, estimate a similarity transform by RANSAC,
warp the candidate into the template frame, and accept when the
mask-aware DCT hashes agree within tmThresh (reference
src/templatematcher.cpp:45-436).  Results are cached per md5 pair under a
lock (src/templatematcher.cpp:64-103) and the match gains an ROI and an
affine transform for the GUI and dump layers.

The device work runs on the matcher's device:

- ORB of the template and of every candidate of a group goes through
  ``ops/orb.py`` ``orb_pyramid``, up to 64 images a chunk on a card (16
  on the CPU); descriptors stay on the device as [K, 4] int64 (the bytes
  of the JAX package's [K, 32] uint8).  ``match_groups`` (-similar's
  path) runs the ORB of a window of groups in two such passes before
  their matches: a pass is launch-bound, whatever its few images.
- The mutual match is two k = 1 searches of ``ops/hamming_lanes.py``
  ``hamming_lanes_topk`` (kernel K5 on a card, its plain twin on the
  CPU), bounded at the radius: every candidate's descriptors against the
  template's in one launch, and the template's against each candidate's
  rows, one launch a candidate (see ``mutual_matches``).

The RANSAC similarity fit, the PIL warp and the verify hash are numpy,
copied as they are.  Differences from the reference: features are
detected at the indexing prescale (<= 400 px) instead of full resolution
(both sides at the same scale, so the transform estimate is unaffected);
OpenCV's estimateRigidTransform RANSAC is replaced by a 2-point
similarity-model RANSAC and a least-squares refit.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch
from PIL import Image

from ..device import resolve, set_hash_numerics
from ..ops import orb
from ..ops.hamming_lanes import hamming_lanes_topk
from ..ops.ref_numpy import dct_hash64, hamming64
from ..params import SearchParams
from ..store.media import Media, MediaGroup
from ..utils.log import warn

INT_MAX = 2**31 - 1
_RANSAC_ITERS = 200
_INLIER_PX = 3.0


def _mutual_radius_match(da: np.ndarray, db: np.ndarray, radius: int):
    """Cross-checked Hamming radius match (cv::BFMatcher(NORM_HAMMING, true)
    + radiusMatch), the plain numpy version of ``mutual_matches``.
    @return list of (ia, ib) index pairs"""
    if len(da) == 0 or len(db) == 0:
        return []
    pa = np.unpackbits(da, axis=1).astype(np.uint8)
    pb = np.unpackbits(db, axis=1).astype(np.uint8)
    d = (pa[:, None, :] != pb[None, :, :]).sum(-1)  # [A,B]
    best_b = d.argmin(axis=1)
    best_a = d.argmin(axis=0)
    out = []
    for ia, ib in enumerate(best_b):
        if best_a[ib] == ia and d[ia, ib] < radius:
            out.append((ia, int(ib)))
    return out


def mutual_matches(tdesc: torch.Tensor, cdescs: list[torch.Tensor],
                   radius: int) -> list[list[tuple[int, int]]]:
    """``_mutual_radius_match(tdesc, c, radius)`` for each candidate c, on
    the descriptors' device through ``hamming_lanes_topk`` at k = 1,
    bounded at ``radius``.

    Exact: numpy's ``argmin`` and K5 both give ties to the lower row, and
    a pair at d < radius has its reverse nearest at d <= d < radius, so
    the bound drops no pair the numpy match keeps.  Reverse direction:
    every candidate's descriptors as needles against the template's, one
    launch.  Forward: the template's against each candidate's rows, a
    slice of the concatenated rows, one launch a candidate; a ``valid``
    mask a candidate would instead scan the whole group's rows a launch.

    @param tdesc [A, 4] int64, cdescs [B_i, 4] int64 on the same device
    @return per candidate, the (ia, ib) pairs in template order"""
    out: list[list[tuple[int, int]]] = [[] for _ in cdescs]
    live = [i for i, c in enumerate(cdescs) if len(c)]
    if len(tdesc) == 0 or not live:
        return out
    dev = tdesc.device
    cat = torch.cat([cdescs[i] for i in live])
    _, rev = hamming_lanes_topk(
        cat, tdesc, torch.ones(len(tdesc), dtype=torch.bool, device=dev),
        1, radius)
    fwd, off = [], 0
    for i in live:
        n = len(cdescs[i])
        _, rows = hamming_lanes_topk(
            tdesc, cat[off:off + n],
            torch.ones(n, dtype=torch.bool, device=dev), 1, radius)
        fwd.append(rows[:, 0])
        off += n
    fwd = torch.stack(fwd).cpu().numpy()  # [live, A]
    rev = rev[:, 0].cpu().numpy()  # [sum B_i]
    ia = np.arange(len(tdesc))
    off = 0
    for n, i in enumerate(live):
        ib = fwd[n]
        back = rev[off + np.maximum(ib, 0)]
        keep = np.nonzero((ib >= 0) & (back == ia))[0]
        out[i] = [(int(a), int(ib[a])) for a in keep]
        off += len(cdescs[i])
    return out


def _similarity_from_2pts(p: np.ndarray, q: np.ndarray) -> Optional[np.ndarray]:
    """Exact 4-DOF similarity (scale+rot+trans) mapping p[0:2] -> q[0:2];
    returns 2x3 matrix [[a,-b,tx],[b,a,ty]]."""
    dp = p[1] - p[0]
    dq = q[1] - q[0]
    n2 = dp @ dp
    if n2 < 1e-6:
        return None
    a = (dp[0] * dq[0] + dp[1] * dq[1]) / n2
    b = (dp[0] * dq[1] - dp[1] * dq[0]) / n2
    t = q[0] - np.array([a * p[0][0] - b * p[0][1], b * p[0][0] + a * p[0][1]])
    return np.array([[a, -b, t[0]], [b, a, t[1]]])


def _apply(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ m[:, :2].T + m[:, 2]


def _ls_similarity(p: np.ndarray, q: np.ndarray) -> Optional[np.ndarray]:
    """Least-squares 4-DOF similarity fit over all pairs."""
    n = len(p)
    if n < 2:
        return None
    # unknowns (a, b, tx, ty); rows: a*x - b*y + tx = qx ; b*x + a*y + ty = qy
    A = np.zeros((2 * n, 4))
    rhs = np.zeros(2 * n)
    A[0::2, 0] = p[:, 0]
    A[0::2, 1] = -p[:, 1]
    A[0::2, 2] = 1
    A[1::2, 0] = p[:, 1]
    A[1::2, 1] = p[:, 0]
    A[1::2, 3] = 1
    rhs[0::2] = q[:, 0]
    rhs[1::2] = q[:, 1]
    sol, *_ = np.linalg.lstsq(A, rhs, rcond=None)
    a, b, tx, ty = sol
    return np.array([[a, -b, tx], [b, a, ty]])


def estimate_similarity_ransac(p: np.ndarray, q: np.ndarray,
                               seed: int = 7) -> Optional[np.ndarray]:
    """RANSAC similarity estimate (stand-in for cv::estimateRigidTransform
    partial-affine mode). @return 2x3 matrix or None."""
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    n = len(p)
    if n < 3:
        return None
    rng = np.random.default_rng(seed)
    best_inliers: np.ndarray | None = None
    for _ in range(_RANSAC_ITERS):
        i, j = rng.integers(0, n, 2)
        if i == j:
            continue
        m = _similarity_from_2pts(p[[i, j]], q[[i, j]])
        if m is None:
            continue
        err = np.linalg.norm(_apply(m, p) - q, axis=1)
        inliers = err < _INLIER_PX
        if best_inliers is None or inliers.sum() > best_inliers.sum():
            best_inliers = inliers
    if best_inliers is None or best_inliers.sum() < 3:
        return None
    return _ls_similarity(p[best_inliers], q[best_inliers])


_DECODE_CACHE_MAX = 64   # grayscale decode LRU entries
# match_groups: images a window of groups touches (its ORB passes are one
# chunk of templates and one of candidates; its decodes fit the LRU)
_WINDOW_IMAGES = _DECODE_CACHE_MAX


class TemplateMatcher:
    def __init__(self, decode=None, device=None):
        """@param decode path -> DecodedImage with .gray at the indexing
               prescale (default: a Scanner's ``decode_image``)
        @param device the device of the ORB pass and the match (default:
               ``device.resolve``)"""
        self.device = resolve(device)
        if decode is None:
            from .scanner import Scanner
            decode = Scanner(device=self.device).decode_image
        self._decode = decode
        self._cache: dict[tuple[str, str], int] = {}
        self._lock = threading.Lock()
        self._grays: "OrderedDict[str, np.ndarray | None]" = OrderedDict()
        # (path, nfeatures, shape) -> features, filled by match_groups for
        # a window of groups
        self._feats: dict[tuple, tuple] = {}

    def _decode_gray(self, path: str) -> np.ndarray | None:
        """LRU-cached grayscale decode: a candidate appearing in many
        groups (common for popular dups) decodes once, not per pair."""
        with self._lock:
            if path in self._grays:
                self._grays.move_to_end(path)
                return self._grays[path]
        d = self._decode(path)
        gray = d.gray if d.gray is not None else None
        with self._lock:
            self._grays[path] = gray
            while len(self._grays) > _DECODE_CACHE_MAX:
                self._grays.popitem(last=False)
        return gray

    def _features_of(self, items: list[tuple[str, np.ndarray]],
                     nfeatures: int) -> list:
        """Features of (path, gray) items: the prefetched ones
        (``match_groups``), the rest in one ``_features_batch``."""
        keys = [(p, nfeatures, g.shape) for p, g in items]
        miss = [i for i, k in enumerate(keys) if k not in self._feats]
        got = dict(zip(miss, self._features_batch(
            [items[i][1] for i in miss], nfeatures))) if miss else {}
        return [got[i] if i in got else self._feats[k]
                for i, k in enumerate(keys)]

    def _known(self, key: tuple[str, str], planned: set) -> bool:
        """A verdict of the md5 pair in either order is cached or planned."""
        rev = (key[1], key[0])
        with self._lock:
            cached = key in self._cache or rev in self._cache
        return cached or key in planned or rev in planned

    def _prefetch(self, pairs: list, params: SearchParams) -> None:
        """ORB of the templates and candidates that ``match`` will verify
        for ``pairs`` in order (a pair cached, or planned by an earlier
        group in either order, is skipped as ``match`` skips it): the
        templates in one ``_features_batch``, the candidates (after
        -p.tscale) in another."""
        planned: set = set()
        tmpls: dict = {}
        cands: dict = {}
        for tmpl, group in pairs:
            use_cache = bool(tmpl.md5) and all(m.md5 for m in group)
            todo = [m for m in group if not (
                use_cache and self._known((m.md5, tmpl.md5), planned))]
            tg = self._decode_gray(tmpl.path) if todo else None
            if tg is None:
                continue
            tmpls[(tmpl.path, params.needleFeatures, tg.shape)] = tg
            for m in todo:
                g = self._decode_gray(m.path)
                if g is None:
                    continue
                g = self._tscale(tg, g, params)
                cands[(m.path, params.haystackFeatures, g.shape)] = g
                if use_cache:
                    planned.add((m.md5, tmpl.md5))
        for want, nf in ((tmpls, params.needleFeatures),
                         (cands, params.haystackFeatures)):
            keys = [k for k in want if k not in self._feats]
            if keys:
                self._feats.update(zip(keys, self._features_batch(
                    [want[k] for k in keys], nf)))

    def match_groups(self, pairs: list, params: SearchParams) -> None:
        """``match`` of each (template, group) of ``pairs``, in order, with
        the same verdicts; the ORB passes of a window of groups that touch
        at most _WINDOW_IMAGES images run together before its matches (a
        group's own passes would be two launch-bound pyramids for a few
        images)."""
        start = 0
        while start < len(pairs):
            paths: set = set()
            end = start
            while end < len(pairs) and (end == start
                                        or len(paths) < _WINDOW_IMAGES):
                tmpl, group = pairs[end]
                paths.add(tmpl.path)
                paths.update(m.path for m in group)
                end += 1
            try:
                self._prefetch(pairs[start:end], params)
                for tmpl, group in pairs[start:end]:
                    self.match(tmpl, group, params)
            finally:
                self._feats.clear()
            start = end

    def _features_batch(self, grays: list[np.ndarray], nfeatures: int):
        """ORB features of many images, a chunk of images a pass of
        ``orb_pyramid`` on the matcher's device (the per-candidate
        dispatch would dominate -p.tm groups).
        @return per image (xs, ys) float64 numpy at the image's scale and
                descriptors [K, 4] int64 on the device"""
        dev = self.device
        batch = 64 if dev.type == "cuda" else 16
        set_hash_numerics()
        out = []
        for s0 in range(0, len(grays), batch):
            chunk = grays[s0:s0 + batch]
            b = len(chunk)
            canvas = np.zeros((b, orb.CANVAS, orb.CANVAS), dtype=np.float32)
            sizes = np.ones((b, 2), dtype=np.int32)
            scales = np.ones(b)
            for i, g in enumerate(chunk):
                h, w = g.shape
                s = 1.0
                if max(h, w) > orb.CANVAS:
                    s = orb.CANVAS / max(h, w)
                    im = Image.fromarray(g).resize(
                        (max(1, round(w * s)), max(1, round(h * s))),
                        Image.BOX)
                    g = np.asarray(im)
                canvas[i, :g.shape[0], :g.shape[1]] = g
                sizes[i] = g.shape
                scales[i] = s
            res = orb.orb_pyramid(torch.from_numpy(canvas).to(dev),
                                  torch.from_numpy(sizes).to(dev),
                                  nfeatures, orb.N_LEVELS)
            valid = res["valid"].cpu().numpy()
            xs_all, ys_all = res["xs"].cpu().numpy(), res["ys"].cpu().numpy()
            for i in range(b):
                xs = xs_all[i][valid[i]] / scales[i]
                ys = ys_all[i][valid[i]] / scales[i]
                keep = torch.from_numpy(np.nonzero(valid[i])[0]).to(dev)
                out.append((xs, ys, res["desc"][i].index_select(0, keep)))
        return out

    def match(self, tmpl: Media, group: MediaGroup, params: SearchParams) -> None:
        """Filter ``group`` in place to candidates that verify against the
        template; sets score/roi/transform on survivors."""
        if not group:
            return
        use_cache = bool(tmpl.md5) and all(m.md5 for m in group)

        good: MediaGroup = []
        todo: MediaGroup = []
        if use_cache:
            with self._lock:
                for m in group:
                    key = (m.md5, tmpl.md5)
                    dist = self._cache.get(key, self._cache.get((tmpl.md5, m.md5)))
                    if dist is not None:
                        m.score = dist
                        if dist < params.tmThresh:
                            good.append(m)
                    else:
                        todo.append(m)
        else:
            todo = list(group)

        group.clear()
        if not todo:
            group.extend(sorted(good, key=lambda m: m.score))
            return

        tmpl_gray = self._decode_gray(tmpl.path)
        if tmpl_gray is None:
            # keep the cache-verified survivors: only the todo set is lost
            warn(f"template matcher: cannot load {tmpl.path}")
            group.extend(sorted(good, key=lambda m: m.score))
            return
        txs, tys, tdesc = self._features_of([(tmpl.path, tmpl_gray)],
                                            params.needleFeatures)[0]
        if len(tdesc) == 0:
            warn(f"template matcher: no keypoints in {tmpl.path}")
            group.extend(sorted(good, key=lambda m: m.score))
            return

        # decode every candidate (LRU-cached), apply the -p.tscale shrink,
        # then ONE batched device feature pass and match for the group
        cands: list[tuple[Media, np.ndarray]] = []
        for m in todo:
            g = self._decode_gray(m.path)
            if g is None:
                m.score = INT_MAX
                if use_cache:
                    with self._lock:
                        self._cache[(m.md5, tmpl.md5)] = INT_MAX
                continue
            cands.append((m, self._tscale(tmpl_gray, g, params)))
        feats = self._features_of([(m.path, g) for m, g in cands],
                                  params.haystackFeatures)
        pairs = mutual_matches(tdesc, [f[2] for f in feats], params.cvThresh)

        for (m, cgray), (cxs, cys, _), mp in zip(cands, feats, pairs):
            dist = self._verify_pair(tmpl_gray, txs, tys, m, cgray, cxs, cys,
                                     mp)
            if use_cache:
                with self._lock:
                    self._cache[(m.md5, tmpl.md5)] = dist
            m.score = dist
            if dist < params.tmThresh:
                good.append(m)

        group.extend(sorted(good, key=lambda m: m.score))

    @staticmethod
    def _tscale(tmpl_gray: np.ndarray, cand_gray: np.ndarray,
                params: SearchParams) -> np.ndarray:
        """-p.tscale: a candidate much larger than the template generates
        features at scales the template never sees; shrink it so its max
        side <= template max side x tmScalePct/100
        (reference src/templatematcher.cpp:171-192)."""
        th, tw = tmpl_gray.shape
        ch, cw = cand_gray.shape
        if th * tw >= ch * cw:
            return cand_gray
        c_size = max(ch, cw)
        max_size = max(th, tw) * params.tmScalePct / 100.0
        if c_size <= max_size:
            return cand_gray
        s = max_size / c_size
        im = Image.fromarray(cand_gray).resize(
            (max(1, round(cw * s)), max(1, round(ch * s))), Image.BILINEAR)
        return np.asarray(im)

    @staticmethod
    def _verify_pair(tmpl_gray: np.ndarray, txs, tys, m: Media,
                     cand_gray: np.ndarray, cxs, cys, pairs) -> int:
        if len(pairs) < 3:
            return INT_MAX

        tp = np.array([[txs[a], tys[a]] for a, _ in pairs])
        cp = np.array([[cxs[b], cys[b]] for _, b in pairs])
        tx = estimate_similarity_ransac(tp, cp)
        if tx is None:
            return INT_MAX

        th, tw = tmpl_gray.shape
        corners = np.array([[0, 0], [tw, 0], [tw, th], [0, th]], dtype=np.float64)
        roi = _apply(tx, corners)
        # map roi/transform back to the candidate's original resolution
        cscale = max(m.width, m.height) / max(cand_gray.shape) \
            if m.width > 0 and max(cand_gray.shape) > 0 else 1.0
        m.roi = [(float(x * cscale), float(y * cscale)) for x, y in roi]
        m.transform = (tx * cscale).tolist()

        # warp the candidate into the template frame; undefined pixels are
        # 0 = mask indicator (src/templatematcher.cpp:322-369).  PIL's
        # AFFINE data maps output(x,y) -> input coordinates, which is
        # exactly the forward template->candidate transform.
        if tx[0, 0] ** 2 + tx[1, 0] ** 2 < 1e-9:
            return INT_MAX
        cand = Image.fromarray(cand_gray)
        warped = cand.transform((tw, th), Image.AFFINE,
                                (tx[0, 0], tx[0, 1], tx[0, 2],
                                 tx[1, 0], tx[1, 1], tx[1, 2]),
                                resample=Image.BILINEAR, fillcolor=0)
        warped = np.asarray(warped)

        mask = warped != 0
        tmpl_masked = np.where(mask, tmpl_gray, 0).astype(np.uint8)
        return hamming64(dct_hash64(warped), dct_hash64(tmpl_masked))
