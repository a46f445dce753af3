"""Color descriptor index — algo 3 (``-p.alg color``) on the port's store.

Port of ``cbird_tpu/index/color_desc_index.py``: 32 Luv colors and weights
an image, scored by the chamfer min-distance sum over the device-resident
``PackedColorStore`` (kernel K6).  The only algorithm that finds mirrored
images, since the histogram is orientation-invariant.

Storage: ``color(media_id integer primary key, color_desc blob)`` in
media3.db; the blob is the [33, 4] uint16 quantized descriptor (rows 0..31
l, u, v, w and the numColors row), the JAX package's, so an ``_index/``
either package wrote loads in the other unchanged.
"""

from __future__ import annotations

import numpy as np

from ..device import resolve
from ..ops.color import NUM_COLORS, PackedColorStore
from ..params import FLAG_IMAGE, SearchParams, TYPE_IMAGE
from ..store.media import Media
from .base import Index, Match

_BLOB_SHAPE = (NUM_COLORS + 1, 4)
_BLOB_BYTES = (NUM_COLORS + 1) * 4 * 2


class ColorDescIndex(Index):
    id = SearchParams.ALGO_COLOR

    def __init__(self, device=None) -> None:
        self.device = resolve(device)
        self._store = PackedColorStore(self.device)
        self._loaded = False

    def is_loaded(self) -> bool:
        return self._loaded

    def memory_usage(self) -> int:
        return self._store.memory_usage()

    def count(self) -> int:
        return int(np.count_nonzero(self._store.ids))

    # ---- sql ---------------------------------------------------------------
    def create_tables(self, conn) -> None:
        conn.execute("create table if not exists color ("
                     " media_id integer primary key not null,"
                     " color_desc blob not null)")

    def add_records(self, conn, media: list[Media]) -> None:
        rows = [(m.id, m.colorDescriptor.tobytes()) for m in media
                if m.type == TYPE_IMAGE and m.colorDescriptor is not None]
        if rows:
            conn.executemany(
                "insert or replace into color (media_id, color_desc) values (?,?)",
                rows)

    def remove_records(self, conn, media_ids: list[int]) -> None:
        conn.executemany("delete from color where media_id=?",
                         [(i,) for i in media_ids])

    def sql_media_ids(self, conn, cache_path: str, data_path: str) -> set[int]:
        return {r[0] for r in conn.execute("select media_id from color")}

    # ---- memory -------------------------------------------------------------
    def load(self, conn, cache_path: str, data_path: str) -> None:
        ids, descs = [], []
        for mid, blob in conn.execute("select media_id, color_desc from color"):
            if len(blob) != _BLOB_BYTES:
                continue  # corrupt row; skip (rebuilt on next -update)
            ids.append(mid)
            descs.append(np.frombuffer(blob, dtype=np.uint16).reshape(_BLOB_SHAPE))
        self._store = PackedColorStore(self.device)
        if ids:
            self._store.add(np.stack(descs), np.array(ids, dtype=np.uint32))
        self._loaded = True

    def add(self, media: list[Media]) -> None:
        items = [(m.id, m.colorDescriptor) for m in media
                 if m.type == TYPE_IMAGE and m.colorDescriptor is not None]
        if items:
            self._store.add(np.stack([d for _, d in items]),
                            np.array([i for i, _ in items], dtype=np.uint32))

    def remove(self, media_ids: list[int]) -> None:
        self._store.remove(media_ids)

    # ---- search -------------------------------------------------------------
    def find(self, needle: Media, params: SearchParams) -> list[Match]:
        return self.find_batch([needle], params)[0]

    def find_batch(self, needles: list[Media], params: SearchParams) -> list[list[Match]]:
        descs = []
        for n in needles:
            d = n.colorDescriptor
            if d is None and n.id:
                tmp = Media(id=n.id)
                if self.find_index_data(tmp):
                    d = tmp.colorDescriptor
            descs.append(d)
        k = max(params.maxMatches * 4, 64)
        raw = self._store.search(descs, k=k)
        out: list[list[Match]] = []
        for ids, scores in raw:
            out.append([Match(int(i), int(s)) for i, s in zip(ids, scores)])
        return out

    def find_all(self, params: SearchParams):
        """-similar N^2 straight off the packed store: needle blocks are the
        store's own rows (no Media object per row), through the
        count-bucketed self-search.  Color has no distance threshold, so
        k stays near maxMatches (the CLI group caps at maxMatches)."""
        if not params.filterSelf:
            return None
        ids = self._store.ids
        if not len(ids):
            return ids, []
        k = params.maxMatches + 8  # self-hit + group cap + tie margin
        raw = self._store.search_self(k=k, sparse=True)
        return ids, raw

    def find_index_data(self, media: Media) -> bool:
        if media.id and media.colorDescriptor is None:
            hits = np.nonzero(self._store.ids == media.id)[0]
            if len(hits):
                media.colorDescriptor = self._store.descriptors[hits[0]].copy()
                return True
        return False

    def slice(self, media_ids: set[int]) -> "ColorDescIndex":
        chunk = ColorDescIndex(self.device)
        chunk._store = self._store.slice(media_ids)
        chunk._loaded = True
        return chunk

    def result_types(self) -> int:
        return FLAG_IMAGE
