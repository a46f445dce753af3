"""ORB descriptor index: algo 2 (``-p.alg orb``) on the port's device.

Port of ``cbird_tpu/index/cv_features_index.py``: 256-bit binary
descriptors (up to 400 an image) searched k-nearest with median-score
voting.  Every descriptor lives in one [T, 4] int64 array on the device
(``_PackedDescStore``), scanned by the exact k-nearest kernel K5
(``ops/hamming_lanes.py``), bounded at the vote threshold.

Voting is the reference's find(): per needle descriptor the 10 nearest;
hits at distance >= cvThresh dropped; per candidate image the distances;
score = median(distances) * 1000 / count; then the relative score gate
(``-p.ovg``).

Storage is the JAX package's: ``matrix(media_id integer primary key, rows
integer, data blob)`` in media2.db, a zlib-compressed [K, 32] uint8
descriptor matrix, and the ``cvfeatures`` sidecar cache ([T, 8] uint32
descriptors and ids), so either package reads the other's ``_index/``.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from ..device import resolve
from ..ops.hamming import IdRows
from ..ops.hamming_lanes import BAD_DIST, BINS, hamming_lanes_topk
from ..params import FLAG_IMAGE, SearchParams, TYPE_IMAGE
from ..store.media import Media
from .base import Index, Match
from .cache import load_cache, save_cache

KNN = 10


class _PackedDescStore:
    """[T, 8] uint32 descriptor rows and a media id a row, tombstoned (id
    0); on the device [T, 4] int64 words and a validity mask."""

    def __init__(self, device=None):
        self.device = resolve(device)
        self._desc = np.zeros((0, 8), dtype=np.uint32)
        self._ids = np.zeros(0, dtype=np.uint32)
        self._dev = None
        self._id_rows: IdRows | None = None

    def __len__(self):
        return len(self._ids)

    @property
    def ids(self):
        return self._ids

    @property
    def descriptors(self):
        return self._desc

    def memory_usage(self) -> int:
        return self._desc.nbytes + self._ids.nbytes

    def add(self, desc: np.ndarray, ids: np.ndarray) -> None:
        if len(ids) == 0:
            return
        self._desc = np.concatenate([self._desc, np.asarray(desc, np.uint32)])
        self._ids = np.concatenate([self._ids, np.asarray(ids, np.uint32)])
        self._dev = None
        self._id_rows = None

    def remove(self, ids) -> None:
        if not len(self._ids):
            return
        kill = np.isin(self._ids, np.asarray(list(ids), dtype=np.uint32))
        if kill.any():
            self._ids[kill] = 0
            self._desc[kill] = 0
            self._dev = None
            self._id_rows = None

    def rows_of(self, media_id: int) -> np.ndarray:
        """The rows of ``media_id``, ascending."""
        if self._id_rows is None:
            self._id_rows = IdRows(self._ids)
        return self._id_rows(media_id)

    def slice(self, media_ids) -> "_PackedDescStore":
        keep = np.isin(self._ids, np.asarray(list(media_ids), dtype=np.uint32))
        keep &= self._ids != 0
        out = _PackedDescStore(self.device)
        out.add(self._desc[keep], self._ids[keep])
        return out

    def device_arrays(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(descriptors [T, 4] int64, valid [T] bool) on the device (the
        kernel takes any row count: no padding)."""
        if self._dev is None:
            desc = np.ascontiguousarray(self._desc).view(np.int64)
            self._dev = (torch.from_numpy(desc).to(self.device),
                         torch.from_numpy(self._ids != 0).to(self.device))
        return self._dev

    def knn(self, needles: np.ndarray, k: int = KNN, bound: int = BINS,
            needle_batch: int = 8192):
        """@param needles [Q, 8] uint32
        @param bound keep only rows at distance < bound (the default: all)
        @return (dists [Q, k] int32, ids [Q, k] uint32; empty slots hold
                BAD_DIST and id 0)"""
        q_total = len(needles)
        out_d = np.full((q_total, k), BAD_DIST, np.int32)
        out_i = np.zeros((q_total, k), np.uint32)
        if q_total == 0 or len(self._ids) == 0:
            return out_d, out_i
        desc_d, valid_d = self.device_arrays()
        kk = min(k, len(self._ids))
        nd = torch.from_numpy(np.ascontiguousarray(
            needles, dtype=np.uint32).view(np.int64)).to(self.device)
        ids = np.r_[self._ids, np.uint32(0)]  # row -1: no id
        for s in range(0, q_total, needle_batch):
            d, i = hamming_lanes_topk(nd[s:s + needle_batch], desc_d,
                                      valid_d, kk, bound)
            d, i = d.cpu().numpy(), i.cpu().numpy()
            out_d[s:s + len(d), :kk] = d
            out_i[s:s + len(d), :kk] = ids[i]
        return out_d, out_i


def descriptors_to_u32(desc_u8: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(desc_u8, dtype=np.uint8).reshape(-1, 32) \
        .view(np.uint32).reshape(-1, 8)


class CvFeaturesIndex(Index):
    id = SearchParams.ALGO_CV_FEATURES

    def __init__(self, device=None) -> None:
        self.device = resolve(device)
        self._store = _PackedDescStore(self.device)
        self._loaded = False

    def is_loaded(self) -> bool:
        return self._loaded

    def memory_usage(self) -> int:
        return self._store.memory_usage()

    def count(self) -> int:
        return len(np.unique(self._store.ids[self._store.ids != 0]))

    def database_id(self) -> int:
        return 2

    # ---- sql ---------------------------------------------------------------
    def create_tables(self, conn) -> None:
        conn.execute("create table if not exists matrix ("
                     " media_id integer primary key not null,"
                     " rows integer not null,"
                     " data blob not null)")

    def add_records(self, conn, media: list[Media]) -> None:
        rows = []
        for m in media:
            # empty descriptor sets are stored too (processed marker; see
            # DctFeaturesIndex.add_records)
            if m.type == TYPE_IMAGE and m.keyPointDescriptors is not None:
                d = np.asarray(m.keyPointDescriptors, dtype=np.uint8)
                rows.append((m.id, len(d), zlib.compress(d.tobytes(), 6)))
        if rows:
            conn.executemany(
                "insert or replace into matrix (media_id, rows, data) values (?,?,?)",
                rows)

    def remove_records(self, conn, media_ids: list[int]) -> None:
        conn.executemany("delete from matrix where media_id=?",
                         [(i,) for i in media_ids])

    def sql_media_ids(self, conn, cache_path: str, data_path: str) -> set[int]:
        return {r[0] for r in conn.execute("select media_id from matrix")}

    # ---- memory -------------------------------------------------------------
    def load(self, conn, cache_path: str, data_path: str) -> None:
        self._store = _PackedDescStore(self.device)
        cached = load_cache(cache_path, "cvfeatures", conn)
        if cached is not None:
            self._store.add(cached["descriptors"], cached["ids"])
            self._loaded = True
            return
        descs, ids = [], []
        for mid, nrows, blob in conn.execute(
                "select media_id, rows, data from matrix"):
            d = np.frombuffer(zlib.decompress(blob), dtype=np.uint8)
            if len(d) != nrows * 32:
                continue  # corrupt row; rebuilt on next -update
            descs.append(descriptors_to_u32(d.reshape(nrows, 32)))
            ids.append(np.full(nrows, mid, dtype=np.uint32))
        if descs:
            self._store.add(np.concatenate(descs), np.concatenate(ids))
        self._loaded = True
        save_cache(cache_path, "cvfeatures",
                   descriptors=self._store.descriptors, ids=self._store.ids)

    def save(self, conn, cache_path: str) -> None:
        if self._loaded:
            save_cache(cache_path, "cvfeatures",
                       descriptors=self._store.descriptors, ids=self._store.ids)

    def add(self, media: list[Media]) -> None:
        for m in media:
            if m.type == TYPE_IMAGE and m.keyPointDescriptors is not None \
                    and len(m.keyPointDescriptors):
                d = descriptors_to_u32(np.asarray(m.keyPointDescriptors))
                self._store.add(d, np.full(len(d), m.id, dtype=np.uint32))

    def remove(self, media_ids: list[int]) -> None:
        self._store.remove(media_ids)

    # ---- search -------------------------------------------------------------
    def _needle_descriptors(self, needle: Media) -> np.ndarray:
        if needle.keyPointDescriptors is not None and len(needle.keyPointDescriptors):
            return descriptors_to_u32(np.asarray(needle.keyPointDescriptors))
        if needle.id > 0:
            return self._store.descriptors[self._store.rows_of(needle.id)]
        return np.zeros((0, 8), dtype=np.uint32)

    def find(self, needle: Media, params: SearchParams) -> list[Match]:
        return self.find_batch([needle], params)[0]

    def find_batch(self, needles: list[Media], params: SearchParams) -> list[list[Match]]:
        per_needle = [self._needle_descriptors(n) for n in needles]
        flat = np.concatenate(per_needle) if per_needle else \
            np.zeros((0, 8), np.uint32)
        if len(flat) == 0:
            return [[] for _ in needles]
        # bounded at the vote threshold: _vote drops every hit at or above
        # it, and the k nearest rows below it are the k nearest rows
        # filtered to it, so the votes are those of the unbounded search
        dists, ids = self._store.knn(flat, k=KNN, bound=params.cvThresh)
        out: list[list[Match]] = []
        pos = 0
        for needle, nd in zip(needles, per_needle):
            k = len(nd)
            votes = self._vote(dists[pos:pos + k], ids[pos:pos + k], params)
            out.append(self._gate(votes, needle.id, params))
            pos += k
        return out

    # vote-gate constants of the JAX package, measured there on its
    # accuracy corpus: the best non-self match scored 32-300, cross-base
    # junk never below 2166, trailing same-base matches up to 21.6x the
    # best; the gate is 25x with a 500 floor so that a very strong best
    # match cannot starve its own weaker true siblings.
    GATE_FLOOR = 500

    @staticmethod
    def _gate(votes: list[Match], needle_id: int, params: SearchParams) -> list[Match]:
        """Relative score gate: keep matches scoring <= max(FLOOR, cvGate x
        the best non-self score).

        The reference keeps every voted candidate and relies on score
        ordering to push cross-base junk last; with maxMatches result
        slots exceeding the true group size, that junk fills the tail.
        Junk and true scores separate by ~10-60x relative to the needle's
        best match (data above), so an adaptive cut beats any absolute
        threshold; -p.ovg 0 disables."""
        r = getattr(params, "cvGate", 0)
        if r <= 0 or len(votes) < 2:
            return votes
        others = [m.score for m in votes if m.mediaId != needle_id]
        if not others:
            return votes
        cut = max(CvFeaturesIndex.GATE_FLOOR, r * min(others))
        return [m for m in votes
                if m.mediaId == needle_id or m.score <= cut]

    @staticmethod
    def _vote(dists: np.ndarray, ids: np.ndarray, params: SearchParams) -> list[Match]:
        """Median-of-distances voting (the reference's find())."""
        scores: dict[int, list[int]] = {}
        for row_d, row_i in zip(dists, ids):
            for d, mid in zip(row_d.tolist(), row_i.tolist()):
                if mid == 0 or d >= params.cvThresh:
                    continue
                scores.setdefault(mid, []).append(d)
        results = []
        for mid, ds in scores.items():
            ds.sort()
            n = len(ds)
            mid_i = n // 2
            if n < 2:
                median = ds[0]
            elif n % 2 == 0:
                median = (ds[mid_i - 1] + ds[mid_i]) // 2
            else:
                median = ds[mid_i]
            results.append(Match(mid, median * 1000 // n))
        return results

    def find_index_data(self, media: Media) -> bool:
        if media.id and (media.keyPointDescriptors is None
                         or not len(media.keyPointDescriptors)):
            rows = self._store.rows_of(media.id)
            if len(rows):
                media.keyPointDescriptors = self._store.descriptors[rows] \
                    .view(np.uint8).reshape(-1, 32)
                return True
        return False

    def slice(self, media_ids: set[int]) -> "CvFeaturesIndex":
        chunk = CvFeaturesIndex(self.device)
        chunk._store = self._store.slice(media_ids)
        chunk._loaded = True
        return chunk

    def result_types(self) -> int:
        return FLAG_IMAGE
