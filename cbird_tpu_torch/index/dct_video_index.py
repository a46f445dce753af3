"""Video search index — algo 4 (`-p.alg video`) on the port's store.

Port of ``cbird_tpu/index/dct_video_index.py`` (host numpy code; only its
store, ``ops/video_search.py``, runs on the device).  A rebuild of the
reference DctVideoIndex (src/dctvideoindex.{h,cpp}): DCT hash per
retained video frame; media ids come from the media table, hashes from
per-video ``.vdx`` files.  Two query modes:

- ``find_frame`` (image needle → videos): nearest frame per video under the
  threshold (reference findFrame, src/dctvideoindex.cpp:291-387);
- ``find_video`` (video needle → videos): every needle frame's per-video
  closest match, re-assembled into temporal ranges by adjacency scoring
  (frame margin 15, minFramesMatched/minFramesNear gates; reference
  findVideo src/dctvideoindex.cpp:399-657).

The reference prunes with a radix tree (`-p.vradix`); here the packed frame
array is scanned brute-force with a per-video segment-min reduction on
device (ops/video_search) — no recall loss, so vradix is accepted but inert.
"""

from __future__ import annotations

import os

import numpy as np

from ..device import resolve
from ..ops.video_search import PackedVideoStore
from ..params import FLAG_VIDEO, SearchParams, TYPE_IMAGE, TYPE_VIDEO
from ..store.media import MatchRange, Media, VideoIndexData
from .base import Index, Match

FRAME_MARGIN = 15  # adjacency margin (reference src/dctvideoindex.cpp:593)


class DctVideoIndex(Index):
    id = SearchParams.ALGO_VIDEO

    def __init__(self, device=None) -> None:
        self.device = resolve(device)
        self._store = PackedVideoStore(device=self.device)
        self._loaded = False
        self._data_path = ""

    def is_loaded(self) -> bool:
        return self._loaded

    def memory_usage(self) -> int:
        return self._store.memory_usage()

    def count(self) -> int:
        return len(self._store)

    def database_id(self) -> int:
        return 0  # ids come from the media table; payload lives in .vdx files

    def sql_media_ids(self, conn, cache_path: str, data_path: str) -> set[int]:
        out = set()
        for (mid,) in conn.execute("select id from media where type=?",
                                   (TYPE_VIDEO,)):
            if os.path.exists(os.path.join(data_path, f"{mid}.vdx")):
                out.add(mid)
        return out

    # ---- memory lifecycle -------------------------------------------------
    def load(self, conn, cache_path: str, data_path: str) -> None:
        from ..store.vdx import load_vdx
        self._data_path = data_path
        self._store = PackedVideoStore(device=self.device)
        for (mid,) in conn.execute(
                "select id from media where type=? order by id", (TYPE_VIDEO,)):
            path = os.path.join(data_path, f"{mid}.vdx")
            try:
                idx = load_vdx(path)
            except (OSError, ValueError):
                continue
            self._store.add_video(mid, idx.frames, idx.hashes)
        self._loaded = True

    def add(self, media: list[Media]) -> None:
        for m in media:
            if m.type == TYPE_VIDEO and m.videoIndex is not None \
                    and not m.videoIndex.is_empty():
                self._store.add_video(m.id, m.videoIndex.frames,
                                      m.videoIndex.hashes)

    def remove(self, media_ids: list[int]) -> None:
        self._store.remove(media_ids)

    # ---- search -----------------------------------------------------------
    def find(self, needle: Media, params: SearchParams) -> list[Match]:
        if needle.type == TYPE_VIDEO:
            return self._find_video(needle, params)
        return self._find_frame(needle, params)

    def find_batch(self, needles: list[Media], params: SearchParams) -> list[list[Match]]:
        # batch all image needles in one device pass; videos go one by one
        # (each video needle is itself a large frame batch)
        out: list[list[Match]] = [[] for _ in needles]
        img_idx = [i for i, n in enumerate(needles)
                   if n.type == TYPE_IMAGE and n.dctHash]
        if img_idx:
            hashes = np.array([np.uint64(needles[i].dctHash) for i in img_idx],
                              dtype=np.uint64)
            minima = self._per_video_minima(hashes, params.dctThresh)
            for row, i in enumerate(img_idx):
                slots, dists, frames = minima[row]
                if len(slots):
                    out[i] = self._frame_matches(needles[i], slots, dists,
                                                 frames, params)
        vid_idx = [i for i, n in enumerate(needles) if n.type == TYPE_VIDEO]
        frame_counts = None
        live: list[int] = []
        trims: dict = {}
        gated = len(vid_idx) > 8 and any(self._store.media_ids)
        if gated:
            # video↔video N²: needles that are stored, non-diverged copies
            # of the store resolve through ONE symmetric triangular frame
            # self-search over the packed array (~2x less count work than
            # needle-frames × store); the rest go through the per-frame
            # flat count gate + per-needle detailed search.  A stored
            # needle's frame always hits itself exactly once (same-video
            # retained frames are ≥ vht > dctThresh apart), so stored
            # needles require ≥ 2 counts per frame, unstored ≥ 1.
            trims = {i: self._trimmed_needle(needles[i], params)
                     for i in vid_idx}
            live = [i for i in vid_idx
                    if trims[i] is not None and len(trims[i][1])]
            if live:
                handled = self._find_video_all_pairs(needles, live, trims,
                                                     params, out)
                live = [i for i in live if i not in handled]
            if live:
                all_hashes = np.concatenate([trims[i][1] for i in live])
                frame_counts = self._store.flat_hit_counts(
                    all_hashes, params.dctThresh)
        if frame_counts is not None:
            gate = max(1, params.minFramesMatched)
            pos = 0
            for i in live:
                nf = len(trims[i][1])
                c = frame_counts[pos:pos + nf]
                pos += nf
                # per-frame self hits by actual membership in the stored
                # hash set (not assumed 1 for every frame of a stored
                # needle — a caller-supplied videoIndex can diverge from
                # the stored .vdx, which would undercount cross hits)
                stored = self._store.video_hashes(needles[i].id)
                if stored is not None and not params.filterSelf:
                    # without filterSelf a stored needle always matches
                    # itself, so it must reach the detailed phase
                    out[i] = self._find_video(needles[i], params,
                                              trimmed=trims[i], counts=c)
                    continue
                if stored is not None:
                    self_hits = np.isin(trims[i][1], stored)
                else:
                    self_hits = np.zeros(nf, dtype=bool)
                if int((c > self_hits).sum()) >= gate:
                    out[i] = self._find_video(needles[i], params,
                                              trimmed=trims[i], counts=c)
        elif not gated:
            for i in vid_idx:
                out[i] = self._find_video(needles[i], params)
        return out

    def _find_video_all_pairs(self, needles: list[Media], live: list[int],
                              trims: dict, params: SearchParams,
                              out: list) -> set[int]:
        """All-pairs video↔video search: one triangular self-search over
        the packed frame rows (ops/hamming.search_self — symmetric count
        phase, exact completeness invariants) + vectorized host reduction
        per (needle video, target video), instead of per-needle
        needle-frames × store scans (reference findVideo is per-needle,
        src/dctvideoindex.cpp:399-657).  Only needles whose trimmed hashes
        are bit-identical to the stored rows are eligible (their frame
        rows ARE store rows, so the symmetric relation is exact); writes
        their matches into ``out`` and returns the handled needle indexes.
        Returns an empty set (fall back to the gate path) when coverage is
        too low for the triangle to win or a hit list saturates."""
        if not params.filterSelf:
            return set()
        store = self._store
        store._consolidate()
        f_total = len(store._hashes)
        media_ids = store.media_ids
        if f_total == 0:
            return set()
        slot_map = {mid: s for s, mid in enumerate(media_ids) if mid}
        # per-slot row ranges (rows are insertion-ordered: frames ascending)
        order = np.argsort(store._vidx, kind="stable")
        bounds = np.searchsorted(store._vidx[order],
                                 np.arange(len(media_ids) + 1))
        skip = params.skipFrames
        slot_to_idx: dict[int, list[int]] = {}
        trimmed_frames = 0
        for i in live:
            slot = slot_map.get(needles[i].id)
            if slot is None:
                continue  # unstored needle — per-needle path
            rows = order[bounds[slot]:bounds[slot + 1]]
            fr = store._frames[rows]
            keep = (fr >= skip) & (fr <= int(fr[-1]) - skip) if len(fr) \
                else np.zeros(0, bool)
            qf, qh = trims[i]
            if not (len(fr[keep]) == len(qf)
                    and np.array_equal(store._hashes[rows][keep], qh)
                    and np.array_equal(fr[keep], qf)):
                continue  # diverged from the stored .vdx — per-needle path
            slot_to_idx.setdefault(slot, []).append(i)
            trimmed_frames += len(qf)
        if not slot_to_idx or 2 * trimmed_frames <= f_total:
            return set()  # triangle scan (F²/2) wouldn't beat Q_trim × F
        k = min(4096, f_total)
        res = store.as_hash_store().search_self(params.dctThresh, k=k,
                                                sparse=True)
        srcs, dsts, dists = [], [], []
        for r, (ids, ds) in res.items():
            m = len(ids)
            if m >= k:
                return set()  # possible truncation — exactness first
            srcs.append(np.full(m, r, np.int64))
            dsts.append(ids.astype(np.int64) - 1)
            dists.append(np.asarray(ds, np.int32))
        handled = {i for idxs in slot_to_idx.values() for i in idxs}
        if not srcs:
            return handled  # no sub-threshold pairs anywhere
        src = np.concatenate(srcs)
        dst = np.concatenate(dsts)
        dd = np.concatenate(dists)
        # symmetrize: search_self guarantees each unordered pair {i, j} in
        # at least one direction (a hot row's own 0.999-recall scan can
        # miss an EARLIER hit — the exactness invariant covers later rows,
        # and mirroring only fills never-scanned rows), so union the
        # relation with its transpose; the per-key min dedupes repeats
        src, dst, dd = (np.concatenate([src, dst]),
                        np.concatenate([dst, src]),
                        np.concatenate([dd, dd]))
        vsrc = store._vidx[src]
        vdst = store._vidx[dst]
        qf = store._frames[src]
        mf = store._frames[dst]
        # needle-side filter: requested slot, frame inside its trim window
        v = len(media_ids)
        requested = np.zeros(v, bool)
        requested[list(slot_to_idx)] = True
        hi = np.full(v, -1, np.int64)
        for slot in slot_to_idx:
            hi[slot] = int(store._frames[order[bounds[slot + 1] - 1]]) - skip
        sel = (requested[vsrc] & (vsrc != vdst) & (src != dst)
               & (qf >= skip) & (qf <= hi[vsrc]))
        src, dd, vsrc, vdst, qf, mf = (a[sel] for a in
                                       (src, dd, vsrc, vdst, qf, mf))
        if len(src) == 0:
            return handled
        # per-(needle frame row, target video) min by (dist, frame) — the
        # dense kernel's packed (d<<24 | frame) scatter-min tie-break
        key = src * v + vdst
        o2 = np.lexsort((mf, dd, key))
        first = np.unique(key[o2], return_index=True)[1]
        keep = o2[first]
        vsrc, vdst, qf, mf = vsrc[keep], vdst[keep], qf[keep], mf[keep]
        # group by (needle video, target video), pairs in (qf, mf) order
        o3 = np.lexsort((mf, qf, vdst, vsrc))
        vsrc, vdst, qf, mf = vsrc[o3], vdst[o3], qf[o3], mf[o3]
        gkey = vsrc.astype(np.int64) * v + vdst
        starts = np.concatenate([[0], np.nonzero(np.diff(gkey))[0] + 1,
                                 [len(gkey)]])
        gate = max(1, params.minFramesMatched)
        for g in range(len(starts) - 1):
            s0, s1 = starts[g], starts[g + 1]
            num = s1 - s0
            if num < gate:
                continue
            a_slot, b_slot = int(vsrc[s0]), int(vdst[s0])
            mid = media_ids[b_slot]
            if mid == 0:
                continue
            # adjacency scoring over the matched frame numbers, identical
            # to _find_video
            num_adjacent = 0
            last_frame = 0
            for m in mf[s0:s1].tolist():
                if abs(m - last_frame) < FRAME_MARGIN:
                    num_adjacent += 1
                last_frame = m
            percent_near = num_adjacent * 100 // int(num)
            if percent_near < params.minFramesNear:
                continue
            for i in slot_to_idx[a_slot]:
                out[i].append(Match(
                    mid, 100 - percent_near,
                    MatchRange(int(qf[s0]), int(mf[s0]),
                               max(int(qf[s1 - 1]) - int(qf[s0]),
                                   int(mf[s1 - 1]) - int(mf[s0])))))
        return handled

    def _per_video_minima(self, hashes: np.ndarray, threshold: int,
                          counts=None):
        """Per needle, the nearest stored frame of every video with a
        sub-threshold hit: sparse hit extraction (counts + exact top-k,
        PackedVideoStore.search_hits), with the dense [Q, V] segment-min
        search as per-needle fallback when a needle overflows k_cap.

        @return list per needle of (slots [m] i32, dist [m] i32,
                frame [m] i32), slots ascending"""
        hashes = np.asarray(hashes, np.uint64)
        hits = self._store.search_hits(hashes, threshold, counts=counts)
        out: list = [None] * len(hits)
        dense = [i for i, h in enumerate(hits) if h is None]
        if dense:
            d, f = self._store.search(hashes[dense])
            for r, i in enumerate(dense):
                slots = np.nonzero(d[r] < threshold)[0].astype(np.int32)
                out[i] = (slots, d[r, slots], f[r, slots])
        if len(dense) < len(hits):
            vmap, fmap = self._store.row_maps()
            nothing = np.zeros(0, np.int32)
            for i, h in enumerate(hits):
                if h is None:
                    continue
                rows, dd = h
                if len(rows) == 0:
                    out[i] = (nothing, nothing, nothing)
                    continue
                slots, ff = vmap[rows], fmap[rows]
                # per-slot min by (dist, frame) — same tie-break as the
                # dense kernel's packed (d<<24 | frame) scatter-min
                order = np.lexsort((ff, dd, slots))
                s, dd, ff = slots[order], dd[order], ff[order]
                _, first = np.unique(s, return_index=True)
                out[i] = (s[first], dd[first], ff[first])
        return out

    def _frame_matches(self, needle: Media, slots: np.ndarray,
                       dists: np.ndarray, frames: np.ndarray,
                       params: SearchParams) -> list[Match]:
        """Per-video nearest-frame minima (already sub-threshold) → matches."""
        out = []
        src_in = needle.matchRange.dstIn
        if src_in < 0:
            src_in = 0
        media_ids = self._store.media_ids
        for slot, d, f in zip(slots, dists, frames):
            mid = media_ids[int(slot)]
            if mid:
                out.append(Match(mid, int(d), MatchRange(src_in, int(f), 1)))
        return out

    def _find_frame(self, needle: Media, params: SearchParams) -> list[Match]:
        if not needle.dctHash:
            return []
        h = np.array([np.uint64(needle.dctHash)], dtype=np.uint64)
        slots, dists, frames = self._per_video_minima(h, params.dctThresh)[0]
        if not len(slots):
            return []
        return self._frame_matches(needle, slots, dists, frames, params)

    def _needle_video_index(self, needle: Media) -> VideoIndexData | None:
        if needle.id == 0 or (needle.videoIndex is not None
                              and not needle.videoIndex.is_empty()):
            return needle.videoIndex
        from ..store.vdx import load_vdx
        try:
            return load_vdx(os.path.join(self._data_path, f"{needle.id}.vdx"))
        except (OSError, ValueError):
            return None

    def _trimmed_needle(self, needle: Media, params: SearchParams):
        """Needle video frames with skipFrames trimmed at both ends
        (reference src/dctvideoindex.cpp:429-431), or None."""
        src = self._needle_video_index(needle)
        if src is None or src.is_empty():
            return None
        last = int(src.frames[-1])
        keep = (src.frames >= params.skipFrames) & \
               (src.frames <= last - params.skipFrames)
        return src.frames[keep], src.hashes[keep]

    def _find_video(self, needle: Media, params: SearchParams,
                    trimmed=None, counts=None) -> list[Match]:
        if trimmed is None:  # gated callers pass the trim they computed
            trimmed = self._trimmed_needle(needle, params)
        if trimmed is None:
            return []
        q_frames, q_hashes = trimmed
        if len(q_frames) == 0:
            return []

        # sparse per-(needle-frame, video) minima instead of the dense
        # [Q, V] kernel — the dense formulation measured ~50x slower than
        # the flat count/top-k scans at every shape tried (docs/TODO.md)
        minima = self._per_video_minima(q_hashes, params.dctThresh,
                                        counts=counts)
        by_slot: dict[int, list] = {}
        for r, (slots, _dists, mframes) in enumerate(minima):
            qf = int(q_frames[r])
            for s, m in zip(slots.tolist(), mframes.tolist()):
                by_slot.setdefault(s, []).append((qf, m))

        results: list[Match] = []
        media_ids = self._store.media_ids
        gate = max(1, params.minFramesMatched)
        for slot in sorted(by_slot):
            pairs = by_slot[slot]
            num = len(pairs)  # distinct needle frames hitting this video
            if num < gate:
                continue
            mid = media_ids[slot]
            if mid == 0:
                continue
            if params.filterSelf and mid == needle.id:
                continue
            pairs.sort()
            # adjacency scoring over the *matched* frame numbers
            num_adjacent = 0
            last_frame = 0
            for _, dst in pairs:
                if abs(dst - last_frame) < FRAME_MARGIN:
                    num_adjacent += 1
                last_frame = dst
            percent_near = num_adjacent * 100 // num
            if percent_near < params.minFramesNear:
                continue
            rng = MatchRange(pairs[0][0], pairs[0][1],
                             max(pairs[-1][0] - pairs[0][0],
                                 pairs[-1][1] - pairs[0][1]))
            results.append(Match(mid, 100 - percent_near, rng))
        return results

    def find_index_data(self, media: Media) -> bool:
        if media.id and media.type == TYPE_VIDEO and media.videoIndex is None:
            idx = self._needle_video_index(media)
            if idx is not None:
                media.videoIndex = idx
                return True
        return False

    def slice(self, media_ids: set[int]) -> "DctVideoIndex":
        chunk = DctVideoIndex(self.device)
        chunk._data_path = self._data_path
        chunk._loaded = True
        keep = {int(i) for i in media_ids}
        store = self._store
        store._consolidate()  # pending per-video appends → flat arrays
        for slot, mid in enumerate(store.media_ids):
            if mid in keep:
                sel = store._vidx == slot
                chunk._store.add_video(mid, store._frames[sel], store._hashes[sel])
        return chunk

    def result_types(self) -> int:
        return FLAG_VIDEO
