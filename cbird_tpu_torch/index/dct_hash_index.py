"""DCT hash index — algo 0 (``-p.alg dct``) on the port's store.

Port of ``cbird_tpu/index/dct_hash_index.py``: one 64-bit perceptual hash
per image, threshold search by Hamming distance over the device-resident
``PackedHashStore``.  The hash lives in the ``media`` table's
``phash_dct`` column, and stores of 4096+ rows keep the same ``dcthash``
sidecar cache (``index/cache.py``, a copy of the JAX package's), so
``_index/`` is shared with the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..device import resolve
from ..ops.hamming import PackedHashStore
from ..params import FLAG_IMAGE, SearchParams, TYPE_IMAGE
from ..store.media import Media
from ..utils.log import profile_stage
from .base import Index, Match
from .cache import load_cache, save_cache

# below this, rebuilding from SQL is as fast as reading the sidecar cache
CACHE_MIN_ROWS = 4096


class DctHashIndex(Index):
    id = SearchParams.ALGO_DCT

    def __init__(self, device=None) -> None:
        self.device = resolve(device)
        self._store = PackedHashStore(device=self.device)
        self._loaded = False

    # ---- status ----------------------------------------------------------
    def is_loaded(self) -> bool:
        return self._loaded

    def memory_usage(self) -> int:
        return self._store.memory_usage()

    def count(self) -> int:
        return int(np.count_nonzero(self._store.ids))

    def database_id(self) -> int:
        return 0

    # ---- sql persistence (hash is a column of the media table) -----------
    def sql_media_ids(self, conn, cache_path: str, data_path: str) -> set[int]:
        rows = conn.execute(
            "select id from media where type=? and phash_dct != 0",
            (TYPE_IMAGE,)).fetchall()
        return {r[0] for r in rows}

    # ---- memory lifecycle ------------------------------------------------
    def load(self, conn, cache_path: str, data_path: str) -> None:
        with profile_stage("dcthash sidecar-cache read"):
            cached = load_cache(cache_path, "dcthash", conn)
        if cached is not None and {"ids", "hashes"} <= set(cached):
            self._store = PackedHashStore(cached["hashes"], cached["ids"],
                                          device=self.device)
            self._loaded = True
            return
        with profile_stage("dcthash sql stream"):
            self._load_sql(conn, cache_path)

    def _load_sql(self, conn, cache_path: str) -> None:
        total = conn.execute(
            "select count(*) from media where type=? and phash_dct != 0",
            (TYPE_IMAGE,)).fetchone()[0]
        # stream the cursor into preallocated arrays (fetchall() at 10M
        # rows is ~1.5 GB of Python tuples held at once)
        ids = np.empty(total, dtype=np.uint32)
        hashes = np.empty(total, dtype=np.uint64)
        cur = conn.execute(
            "select id, phash_dct from media where type=? and phash_dct != 0",
            (TYPE_IMAGE,))
        i = 0
        while True:
            rows = cur.fetchmany(262144)
            if not rows:
                break
            stop = min(i + len(rows), total)
            arr = np.asarray(rows[:stop - i], dtype=np.int64)
            if len(arr):
                ids[i:stop] = arr[:, 0].astype(np.uint32)
                hashes[i:stop] = arr[:, 1].view(np.uint64)
            i = stop
        ids, hashes = ids[:i], hashes[:i]
        self._store = PackedHashStore(hashes, ids, device=self.device)
        self._loaded = True
        if len(ids) >= CACHE_MIN_ROWS:  # small ones reload from SQL fast
            save_cache(cache_path, "dcthash", ids=ids, hashes=hashes)

    def add(self, media: list[Media]) -> None:
        items = [(m.id, np.uint64(m.dctHash)) for m in media
                 if m.type == TYPE_IMAGE and m.dctHash]
        if items:
            self._store.add(np.array([h for _, h in items], dtype=np.uint64),
                            np.array([i for i, _ in items], dtype=np.uint32))

    def remove(self, media_ids: list[int]) -> None:
        self._store.remove(media_ids)

    # ---- search ----------------------------------------------------------
    def find(self, needle: Media, params: SearchParams) -> list[Match]:
        return self.find_batch([needle], params)[0]

    def find_batch(self, needles: list[Media], params: SearchParams) -> list[list[Match]]:
        hashes = np.array([np.uint64(n.dctHash) for n in needles], dtype=np.uint64)
        # cap on raw hits per needle; post-filtering (self, weeds, paths) can
        # consume a few, so fetch a margin above maxMatches
        k = max(params.maxMatches * 4, 64)
        # indexed needles always match themselves; when self matches will be
        # filtered anyway, let the count gate skip single-hit needles
        min_hits = 2 if (params.filterSelf
                         and all(n.id > 0 for n in needles)) else 1
        if (min_hits == 2 and len(needles) == len(self._store)
                and np.array_equal(hashes, self._store.hashes)
                and np.array_equal(
                    np.fromiter((n.id for n in needles), np.uint32,
                                len(needles)), self._store.ids)):
            # the needle set IS the index, row for row: triangular count
            raw = self._store.search_self(params.dctThresh, k=k)
        else:
            raw = self._store.search(hashes, params.dctThresh, k=k,
                                     min_hits=min_hits)
        out: list[list[Match]] = []
        for n, (ids, dists) in zip(needles, raw):
            if not n.dctHash:
                out.append([])
                continue
            out.append([Match(int(i), int(d)) for i, d in zip(ids, dists)])
        return out

    def find_all(self, params: SearchParams):
        """-similar N^2 straight off the packed store: triangular
        self-search + batched maxThresh escalation.  Only valid when self
        matches are filtered (search_self gates lone-self needles)."""
        if not params.filterSelf:
            return None
        hashes = self._store.hashes
        n = len(hashes)
        ids = self._store.ids
        if n == 0:
            return ids, []
        k = max(params.maxMatches * 4, 64)
        raw = self._store.search_self(params.dctThresh, k=k, sparse=True)
        if params.maxThresh > 0:
            with profile_stage("find_all escalation"):
                # one store scan per threshold step over the still-short
                # needles
                tmp = params.copy()
                hits_len = np.zeros(n, np.int64)
                for r, v in raw.items():
                    hits_len[r] = len(v[0])
                pend = np.nonzero((ids != 0)
                                  & (hits_len <= params.minMatches))[0].tolist()
                while pend:
                    tmp.dctThresh += 1
                    if tmp.dctThresh > params.maxThresh:
                        break
                    sub = self._store.search(hashes[pend], tmp.dctThresh,
                                             k=k, min_hits=2)
                    for i, r in zip(pend, sub):
                        raw[i] = r
                    pend = [i for i in pend
                            if len(raw[i][0]) <= params.minMatches]
        return ids, raw

    def find_index_data(self, media: Media) -> bool:
        if media.id and not media.dctHash:
            hits = np.nonzero(self._store.ids == media.id)[0]
            if len(hits):
                media.dctHash = int(self._store.hashes[hits[0]])
                return True
        return False

    def slice(self, media_ids: set[int]) -> "DctHashIndex":
        chunk = DctHashIndex(self.device)
        chunk._store = self._store.slice(media_ids)
        chunk._loaded = True
        return chunk

    def result_types(self) -> int:
        return FLAG_IMAGE
