"""Index plugin contract — the five search algorithms implement this.

Python rebuild of the reference Index interface
(src/index.h:150-281): SQL schema hooks, load/save,
in-memory add/remove (tombstones), find, slice (subset search), and
findIndexData (recover index-only payloads like descriptors).

TPU twist: ``find_batch`` is first-class — the N×N ``-similar`` search
feeds *all* needles to the device in one batched scan instead of the
reference's thread-pool-of-single-queries (src/database.cpp:1400-1434).
"""

from __future__ import annotations

import dataclasses

from ..params import SearchParams
from ..store.media import MatchRange, Media


@dataclasses.dataclass
class Match:
    """One index hit (reference Index::Match, src/index.h:157-166)."""
    mediaId: int
    score: int
    range: MatchRange = dataclasses.field(default_factory=MatchRange)


class Index:
    """Base for searchable indexes; subclasses set ``id`` to their algo enum."""

    id: int = -1

    # ---- status ----------------------------------------------------------
    def is_loaded(self) -> bool:
        raise NotImplementedError

    def memory_usage(self) -> int:
        raise NotImplementedError

    def count(self) -> int:
        raise NotImplementedError

    def database_id(self) -> int:
        return self.id

    # ---- sql persistence -------------------------------------------------
    def create_tables(self, conn) -> None:
        pass

    def add_records(self, conn, media: list[Media]) -> None:
        pass

    def remove_records(self, conn, media_ids: list[int]) -> None:
        pass

    def sql_media_ids(self, conn, cache_path: str, data_path: str) -> set[int]:
        """All media ids present for this algo (used for -update algo sync)."""
        return set()

    # ---- memory lifecycle ------------------------------------------------
    def load(self, conn, cache_path: str, data_path: str) -> None:
        raise NotImplementedError

    def save(self, conn, cache_path: str) -> None:
        pass

    def add(self, media: list[Media]) -> None:
        raise NotImplementedError

    def remove(self, media_ids: list[int]) -> None:
        raise NotImplementedError

    # ---- search ----------------------------------------------------------
    def find(self, needle: Media, params: SearchParams) -> list[Match]:
        raise NotImplementedError

    def find_batch(self, needles: list[Media], params: SearchParams) -> list[list[Match]]:
        return [self.find(n, params) for n in needles]

    def find_all(self, params: SearchParams):
        """Optional whole-store N² self-search (Database -similar fast
        path at 10M+ items): return (store media ids [N], per-row
        (ids, dists) results aligned to those rows) computed straight off
        the packed store arrays — no Media needles — or None to use the
        generic per-needle find_batch path."""
        return None

    def find_index_data(self, media: Media) -> bool:
        return False

    def slice(self, media_ids: set[int]) -> "Index | None":
        return None

    def result_types(self) -> int:
        from ..params import FLAG_IMAGE
        return FLAG_IMAGE
