"""DCT features index: algo 1 (``-p.alg fdct``) on the port's store.

Port of ``cbird_tpu/index/dct_features_index.py``: up to ~400 DCT hashes
per image, one per ORB keypoint ROI (``ops/orb.py``), every one of them a
row of one ``PackedHashStore`` on the device, so a needle's hashes search
it in one batched pass (kernels K1-mma, K4), and ``-similar`` is the
store's self-search (K1-mma and K2-mma, or the pigeonhole count K3, then
K4).

Candidate voting is the reference's find(): per needle hash the 10 best
matches under dctThresh; per candidate image the matches and the sum of
their distances; score = maxMatches - matches (10 x the mean distance
when every candidate has one match); the needle itself scores -1.

Storage is the JAX package's: ``kphash(media_id integer primary key,
hashes blob)`` in media1.db (a uint64le array) and the ``dctfeatures``
sidecar cache, so either package reads the other's ``_index/``.
"""

from __future__ import annotations

import numpy as np

from ..device import resolve
from ..ops.hamming import PackedHashStore
from ..params import FLAG_IMAGE, SearchParams, TYPE_IMAGE
from ..store.media import Media
from .base import Index, Match
from .cache import load_cache, save_cache

VOTE_K = 10  # best matches considered per needle hash


class DctFeaturesIndex(Index):
    id = SearchParams.ALGO_DCT_FEATURES

    def __init__(self, device=None) -> None:
        self.device = resolve(device)
        # one row per keypoint hash
        self._store = PackedHashStore(device=self.device)
        self._loaded = False

    def is_loaded(self) -> bool:
        return self._loaded

    def memory_usage(self) -> int:
        return self._store.memory_usage()

    def count(self) -> int:
        return len(np.unique(self._store.ids[self._store.ids != 0]))

    def database_id(self) -> int:
        return 1

    # ---- sql ---------------------------------------------------------------
    def create_tables(self, conn) -> None:
        conn.execute("create table if not exists kphash ("
                     " media_id integer primary key not null,"
                     " hashes blob not null)")

    def add_records(self, conn, media: list[Media]) -> None:
        # an empty blob is stored when the image was processed but produced
        # no keypoint hashes (smooth images) — otherwise the algo-sync on
        # every -update would re-index such files forever
        rows = [(m.id, np.asarray(m.keyPointHashes, dtype=np.uint64).tobytes())
                for m in media
                if m.type == TYPE_IMAGE and m.keyPointHashes is not None]
        if rows:
            conn.executemany(
                "insert or replace into kphash (media_id, hashes) values (?,?)",
                rows)

    def remove_records(self, conn, media_ids: list[int]) -> None:
        conn.executemany("delete from kphash where media_id=?",
                         [(i,) for i in media_ids])

    def sql_media_ids(self, conn, cache_path: str, data_path: str) -> set[int]:
        return {r[0] for r in conn.execute("select media_id from kphash")}

    # ---- memory -------------------------------------------------------------
    def load(self, conn, cache_path: str, data_path: str) -> None:
        cached = load_cache(cache_path, "dctfeatures", conn)
        if cached is not None:
            self._store = PackedHashStore(cached["hashes"], cached["ids"],
                                          device=self.device)
            self._loaded = True
            return
        all_hashes, all_ids = [], []
        for mid, blob in conn.execute("select media_id, hashes from kphash"):
            h = np.frombuffer(blob, dtype=np.uint64)
            if len(h):
                all_hashes.append(h)
                all_ids.append(np.full(len(h), mid, dtype=np.uint32))
        self._store = PackedHashStore(device=self.device)
        if all_hashes:
            self._store.add(np.concatenate(all_hashes), np.concatenate(all_ids))
        self._loaded = True
        save_cache(cache_path, "dctfeatures",
                   hashes=self._store.hashes, ids=self._store.ids)

    def save(self, conn, cache_path: str) -> None:
        if self._loaded:
            save_cache(cache_path, "dctfeatures",
                       hashes=self._store.hashes, ids=self._store.ids)

    def add(self, media: list[Media]) -> None:
        for m in media:
            if m.type == TYPE_IMAGE and m.keyPointHashes is not None \
                    and len(m.keyPointHashes):
                h = np.asarray(m.keyPointHashes, dtype=np.uint64)
                self._store.add(h, np.full(len(h), m.id, dtype=np.uint32))

    def remove(self, media_ids: list[int]) -> None:
        self._store.remove(media_ids)

    # ---- search -------------------------------------------------------------
    def _needle_hashes(self, needle: Media) -> np.ndarray:
        if needle.keyPointHashes is not None and len(needle.keyPointHashes):
            return np.asarray(needle.keyPointHashes, dtype=np.uint64)
        if needle.id > 0:
            return self._store.hashes[self._store.rows_of(needle.id)]
        return np.zeros(0, dtype=np.uint64)

    def find(self, needle: Media, params: SearchParams) -> list[Match]:
        return self.find_batch([needle], params)[0]

    # bound on flattened needle hashes per device sweep: at ~400 kp-hashes
    # per image a 500k-needle N² run would otherwise flatten a multi-GB host
    # array (and hold all raw hits) — stream in ~2M-hash slices instead
    BATCH_HASHES = 1 << 21

    def find_batch(self, needles: list[Media], params: SearchParams) -> list[list[Match]]:
        out: list[list[Match]] = []
        slice_needles: list[tuple[Media, np.ndarray]] = []
        pending = 0

        def flush() -> None:
            nonlocal pending
            if not slice_needles:
                return
            flat = np.concatenate([h for _, h in slice_needles])
            # fetch 3x margin, then cut to VOTE_K deterministically by
            # (distance, media id) in _vote — the device top-k breaks
            # distance ties by row position, which changes when rows are
            # removed and re-appended (testAddRemove bit-identity)
            raw = self._store.search(flat, params.dctThresh, k=3 * VOTE_K) \
                if len(flat) else []
            pos = 0
            for needle, hashes in slice_needles:
                k = len(hashes)
                out.append(self._vote(needle.id, raw[pos:pos + k]))
                pos += k
            slice_needles.clear()
            pending = 0

        for n in needles:
            h = self._needle_hashes(n)
            slice_needles.append((n, h))
            pending += len(h)
            if pending >= self.BATCH_HASHES:
                flush()
        flush()
        return out

    def _vote(self, needle_id: int, hits) -> list[Match]:
        matches: dict[int, int] = {}
        scores: dict[int, int] = {}
        max_matches = 0
        for ids, dists in hits:
            if len(ids) > VOTE_K:  # deterministic top-10: (distance, id)
                order = np.lexsort((ids, dists))[:VOTE_K]
                ids, dists = ids[order], dists[order]
            for mid, d in zip(ids.tolist(), dists.tolist()):
                if mid <= 0:
                    continue
                matches[mid] = matches.get(mid, 0) + 1
                scores[mid] = scores.get(mid, 0) + d
                if mid != needle_id:
                    max_matches = max(max_matches, matches[mid])
        results = []
        for mid, count in matches.items():
            if count <= 0:
                continue
            avg = scores[mid] / count
            if mid == needle_id:
                score = -1
            elif max_matches == 1:
                score = int(10 * avg)
            else:
                score = max_matches - count
            results.append(Match(mid, score))
        return results

    def find_all(self, params: SearchParams):
        """-similar N^2 for fdct straight off the packed kp-hash store
        (no Media needle per DB row, no per-needle device sweeps): the
        store's self-search count-gates it so only keypoint hashes with a
        sub-threshold partner reach the top-k, then candidate voting runs
        per hot image on the host.

        Vote parity with the find_batch path: search_self returns the
        same per-hash candidate lists as store.search over the needle's
        own hashes (self-hit at distance 0 included), except rows whose
        ONLY hit is themselves come back empty — those rows feed only
        the needle's own score=-1 entry, which is count-independent, so
        the per-image vote is unchanged.  Reference semantics:
        dctfeaturesindex.cpp's find() queried per needle by the
        reference's Database::similar."""
        if not params.filterSelf:
            return None
        ids = self._store.ids
        if not len(ids):
            return np.zeros(0, np.uint32), []
        raw = self._store.search_self(params.dctThresh, k=3 * VOTE_K,
                                      sparse=True)
        by_img: dict[int, list] = {}
        for r in sorted(raw):  # row-ascending: per-image hit order as before
            by_img.setdefault(int(ids[r]), []).append(raw[r])
        votes = {mid: self._vote(mid, h) for mid, h in by_img.items()}
        if params.maxThresh > 0:
            # batched escalation, one store sweep per threshold step over
            # the still-short images (mirrors DctHashIndex.find_all; the
            # reference escalates per needle, src/database.cpp:1691-1757)
            tmp = params.copy()
            uniq = np.unique(ids[ids != 0])

            def short(mid: int) -> bool:
                # mirror _escalate_all's `len(matches) <= minMatches`: the
                # find_batch vote always contains the needle's own score=-1
                # entry for images with hashes, so images absent from
                # ``votes`` (or gated to empty by min_hits) count as 1
                return max(1, len(votes.get(mid, ()))) <= params.minMatches

            pend = [int(m) for m in uniq if short(int(m))]
            while pend:
                tmp.dctThresh += 1
                if tmp.dctThresh > params.maxThresh:
                    break
                rows = np.nonzero(np.isin(ids, np.asarray(
                    pend, ids.dtype)))[0]
                sub = self._store.search(self._store.hashes[rows],
                                         tmp.dctThresh, k=3 * VOTE_K,
                                         min_hits=2)
                regroup: dict[int, list] = {}
                for r, hits in zip(rows, sub):
                    if len(hits[0]):
                        regroup.setdefault(int(ids[r]), []).append(hits)
                for mid in pend:
                    votes[mid] = self._vote(mid, regroup.get(mid, []))
                pend = [m for m in pend if short(m)]
        out_ids = np.fromiter(votes.keys(), np.uint32, len(votes))
        out = []
        for mid in out_ids.tolist():
            ms = sorted(votes[mid], key=lambda m: (m.score, m.mediaId))
            out.append((np.array([m.mediaId for m in ms], np.int64),
                        np.array([m.score for m in ms], np.int64)))
        return out_ids, out

    def find_index_data(self, media: Media) -> bool:
        if media.id and (media.keyPointHashes is None
                         or not len(media.keyPointHashes)):
            rows = self._store.rows_of(media.id)
            if len(rows):
                media.keyPointHashes = self._store.hashes[rows]
                return True
        return False

    def slice(self, media_ids: set[int]) -> "DctFeaturesIndex":
        chunk = DctFeaturesIndex(self.device)
        chunk._store = self._store.slice(media_ids)
        chunk._loaded = True
        return chunk

    def result_types(self) -> int:
        return FLAG_IMAGE
