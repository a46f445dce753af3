"""SQLite metadata store + index-directory layout + search orchestration.

Python rebuild of the reference Database (src/database.{h,cpp}):

- owns ``<root>/_index/`` with ``media<N>.db`` SQLite files (N = algo database
  id; media0.db holds the ``media`` table with the same schema/columns as the
  reference, src/database.cpp:235-253), ``cache/`` for flat-file caches,
  ``video/`` for per-video hash files, ``last-added.txt``, ``write.lock``;
- per-thread, per-database connections (SQLite connections are not shared
  across threads; reference pools per (index id, thread),
  src/database.cpp:53-154);
- transactional batched add with id allocation at max(id)+1
  (src/database.cpp:358-459), cross-process write exclusion via flock on
  write.lock (src/database.cpp:371-377);
- search: ``similar`` (all-pairs, device-batched instead of the reference's
  QtConcurrent map), ``similar_to``, ``search_index`` with maxThresh
  escalation (src/database.cpp:1691-1757);
- result filtering: negative-match blacklist, weeds, path subset, parent
  filter, group dedup/merge/expand (src/database.cpp:1209-1278);
- weeds + negative matches as md5-pair map files (src/database.cpp:1759-1850).
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from contextlib import contextmanager

import numpy as np

from ..index.base import Index, Match
from ..params import SearchParams, TYPE_VIDEO
from .media import (MatchRange, Media, MediaGroup, MediaGroupList,
                    expand_group_list, merge_group_list, sort_group_list)

INDEX_DIR_NAME = "_index"


class Database:
    def __init__(self, root: str):
        root = os.path.abspath(root)
        if not os.path.isdir(root):
            raise FileNotFoundError(f"directory does not exist: {root}")
        self._root = root
        self._index_dir = os.path.join(root, INDEX_DIR_NAME)
        os.makedirs(self._index_dir, exist_ok=True)
        os.makedirs(self.cache_path(), exist_ok=True)
        os.makedirs(self.video_path(), exist_ok=True)
        self._tls = threading.local()
        self._lock = threading.RLock()
        self._algos: list[Index] = []
        self._weeds: set[tuple[str, str]] | None = None
        self._weed_md5s: set[str] | None = None
        self._neg: set[tuple[str, str]] | None = None
        self._media_cache: dict[int, Media] | None = None
        # () -> TemplateMatcher for -p.tm (the Engine sets one on its
        # device and decode; None: a matcher on the default device)
        self.make_matcher = None
        self._create_tables()

    # ---- paths -----------------------------------------------------------
    def path(self) -> str:
        return self._root

    def index_path(self) -> str:
        return self._index_dir

    def thumb_path(self) -> str:
        """Collection icon/thumbnail (reference Database::thumbPath,
        src/database.h:58 — written by the crop tool, store/thumbnail.py)."""
        return os.path.join(self._root, "thumb.png")

    def cache_path(self) -> str:
        return os.path.join(self._index_dir, "cache")

    def video_path(self) -> str:
        return os.path.join(self._index_dir, "video")

    def _db_file(self, db_id: int = 0) -> str:
        return os.path.join(self._index_dir, f"media{db_id}.db")

    # ---- connections -----------------------------------------------------
    def connect(self, db_id: int = 0) -> sqlite3.Connection:
        if not hasattr(self._tls, "conns"):
            self._tls.conns = {}
        conn = self._tls.conns.get(db_id)
        if conn is None:
            conn = sqlite3.connect(self._db_file(db_id), timeout=60.0)
            conn.execute("pragma journal_mode=wal")
            conn.execute("pragma synchronous=normal")
            self._tls.conns[db_id] = conn
        return conn

    def close(self) -> None:
        if hasattr(self._tls, "conns"):
            for c in self._tls.conns.values():
                c.close()
            self._tls.conns = {}

    @contextmanager
    def write_lock(self):
        """Cross-process write exclusion (reference QLockFile write.lock)."""
        import fcntl
        lock_file = os.path.join(self._index_dir, "write.lock")
        with open(lock_file, "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                f.write(str(os.getpid()))
                f.flush()
                yield
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    # ---- schema ----------------------------------------------------------
    def _create_tables(self) -> None:
        conn = self.connect()
        conn.executescript(
            "create table if not exists media ("
            " id      integer primary key not null,"
            " type    integer not null,"
            " path    text not null,"
            " width   integer not null,"
            " height  integer not null,"
            " md5     text not null,"
            " phash_dct integer not null);"
            "create unique index if not exists media_id_index on media(id);"
            "create unique index if not exists media_path_index on media(path);"
            "create index if not exists media_md5_index on media(md5);")
        conn.commit()
        for index in self._algos:
            c = self.connect(index.database_id())
            index.create_tables(c)
            c.commit()

    # ---- index registry --------------------------------------------------
    def add_index(self, index: Index) -> None:
        self._algos.append(index)
        c = self.connect(index.database_id())
        index.create_tables(c)
        c.commit()

    def indexes(self) -> list[Index]:
        return list(self._algos)

    def choose_index(self, params: SearchParams) -> Index:
        for i in self._algos:
            if i.id == params.algo:
                return i
        raise KeyError(f"no index with id {params.algo}")

    def load_index(self, params: SearchParams) -> Index:
        i = self.choose_index(params)
        if not i.is_loaded():
            with self._lock:
                if not i.is_loaded():
                    from ..utils.log import profile_stage
                    data_path = self.video_path() if i.id == SearchParams.ALGO_VIDEO else ""
                    with profile_stage(f"index load algo={i.id}"):
                        i.load(self.connect(i.database_id()),
                               self.cache_path(), data_path)
        return i

    def save_indices(self) -> None:
        for i in self._algos:
            i.save(self.connect(i.database_id()), self.cache_path())

    # ---- row mapping -----------------------------------------------------
    @staticmethod
    def _row_to_media(row) -> Media:
        m = Media(path=row[2], type=row[1], width=row[3], height=row[4],
                  md5=row[5], dctHash=np.uint64(row[6] & 0xFFFFFFFFFFFFFFFF),
                  id=row[0])
        return m

    def _abs(self, rel_path: str) -> str:
        if rel_path.startswith("/"):
            return rel_path
        return os.path.join(self._root, rel_path)

    def _rel(self, abs_path: str) -> str:
        ap = os.path.abspath(abs_path) if not abs_path.startswith(self._root) else abs_path
        if ap.startswith(self._root + os.sep):
            return ap[len(self._root) + 1:]
        return ap

    # ---- CRUD ------------------------------------------------------------
    def count(self) -> int:
        return self.connect().execute("select count(*) from media").fetchone()[0]

    def add(self, media: list[Media]) -> None:
        """Transactional batched add; allocates ids, writes per-index records,
        updates in-memory indexes (reference src/database.cpp:358-459)."""
        if not media:
            return
        with self.write_lock(), self._lock:
            conn = self.connect()
            cur = conn.execute("select max(id) from media")
            next_id = (cur.fetchone()[0] or 0) + 1
            for m in media:
                if m.id == 0:
                    m.id = next_id
                    next_id += 1
            conn.executemany(
                "insert or replace into media (id,type,path,width,height,md5,phash_dct)"
                " values (?,?,?,?,?,?,?)",
                [(m.id, m.type, self._rel(m.path), m.width, m.height, m.md5,
                  int(np.int64(np.uint64(m.dctHash)))) for m in media])
            conn.commit()
            for index in self._algos:
                c = self.connect(index.database_id())
                index.add_records(c, media)
                c.commit()
                if index.is_loaded():
                    index.add(media)
            # video hashes persist as .vdx files next to the SQL data
            from .vdx import save_vdx
            for m in media:
                if m.type == TYPE_VIDEO and m.videoIndex is not None:
                    save_vdx(os.path.join(self.video_path(), f"{m.id}.vdx"),
                             m.videoIndex)
            self._write_last_added()
            self._media_cache = None

    def remove(self, media_ids: list[int]) -> None:
        if not media_ids:
            return
        with self.write_lock(), self._lock:
            conn = self.connect()
            conn.executemany("delete from media where id=?",
                             [(i,) for i in media_ids])
            conn.commit()
            for index in self._algos:
                c = self.connect(index.database_id())
                index.remove_records(c, media_ids)
                c.commit()
                if index.is_loaded():
                    index.remove(media_ids)
            for mid in media_ids:
                vdx = os.path.join(self.video_path(), f"{mid}.vdx")
                if os.path.exists(vdx):
                    os.unlink(vdx)
            self._media_cache = None

    def set_md5(self, media: Media, md5: str) -> bool:
        """Replace the stored md5 of one row (reference Database::setMd5,
        used by -updatemd5 to upgrade legacy sparse video md5s to full
        md5s, src/main.cpp:1735-1752)."""
        if not media.id or not md5:
            return False
        with self.write_lock(), self._lock:
            conn = self.connect()
            conn.execute("update media set md5=? where id=?",
                         (md5, media.id))
            conn.commit()
        media.md5 = md5
        self._media_cache = None
        return True

    def move(self, media: Media, new_dir: str) -> bool:
        """Move file on disk preserving index (reference Database::move)."""
        new_path = os.path.join(new_dir, media.name())
        return self.rename(media, new_path)

    def rename(self, media: Media, new_path: str) -> bool:
        if media.is_archived():
            return False
        src = self._abs(media.path)
        dst = os.path.join(self._root, new_path) if not os.path.isabs(new_path) else new_path
        if not os.path.exists(src) or os.path.exists(dst):
            return False
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        os.rename(src, dst)
        conn = self.connect()
        conn.execute("update media set path=? where id=?", (self._rel(dst), media.id))
        conn.commit()
        media.path = dst
        self._media_cache = None
        return True

    def vacuum(self) -> None:
        for index in self._algos:
            self.connect(index.database_id()).execute("vacuum")
        self.connect().execute("vacuum")

    # ---- queries ---------------------------------------------------------
    def media_with_id(self, media_id: int) -> Media:
        row = self.connect().execute(
            "select * from media where id=?", (media_id,)).fetchone()
        if row is None:
            return Media()
        m = self._row_to_media(row)
        m.path = self._abs(m.path)
        return m

    def media_with_path(self, path: str) -> Media:
        rel = self._rel(path)
        row = self.connect().execute(
            "select * from media where path=?", (rel,)).fetchone()
        if row is None:
            return Media()
        m = self._row_to_media(row)
        m.path = self._abs(m.path)
        return m

    def media_with_md5(self, md5: str) -> MediaGroup:
        rows = self.connect().execute(
            "select * from media where md5=?", (md5,)).fetchall()
        out = []
        for r in rows:
            m = self._row_to_media(r)
            m.path = self._abs(m.path)
            out.append(m)
        return out

    def media_with_type(self, types: int) -> list[Media]:
        type_list = [t for t in (1, 2, 3) if types & (1 << (t - 1))]
        q = ",".join(str(t) for t in type_list)
        rows = self.connect().execute(
            f"select * from media where type in ({q})").fetchall()
        out = []
        for r in rows:
            m = self._row_to_media(r)
            m.path = self._abs(m.path)
            out.append(m)
        return out

    def all_media(self) -> list[Media]:
        return self.media_with_type(7)

    def indexed_files(self) -> set[str]:
        rows = self.connect().execute("select path from media").fetchall()
        return {self._abs(r[0]) for r in rows}

    def indexed_items(self) -> dict[str, tuple[int, int, int]]:
        """path -> (media id, type, algo flags present)
        (reference Database::indexedItems)."""
        present: dict[int, set[int]] = {}
        for i in self._algos:
            data_path = self.video_path() if i.id == SearchParams.ALGO_VIDEO else ""
            present[i.id] = i.sql_media_ids(self.connect(i.database_id()),
                                            self.cache_path(), data_path)
        out: dict[str, tuple[int, int, int]] = {}
        for row in self.connect().execute("select id,type,path from media"):
            mid, mtype, rel = row
            algos = 0
            for i in self._algos:
                if mid in present.get(i.id, ()):  # noqa: SIM118
                    algos |= 1 << i.id
            out[self._abs(rel)] = (mid, mtype, algos)
        return out

    def dups_by_md5(self, params: SearchParams) -> MediaGroupList:
        """Exact duplicates by content digest (reference Database::dupsByMd5)."""
        dups: MediaGroupList = []
        conn = self.connect()
        for (md5,) in conn.execute(
                "select md5 from media group by md5 having count(md5) > 1"):
            g = self.media_with_md5(md5)
            for m in g:
                if self.is_weed(m):
                    m.isWeed = True
            if g:
                dups.append(g)
        sort_group_list(dups, ["path"])
        return dups

    # ---- last-added timestamp -------------------------------------------
    def _last_added_file(self) -> str:
        return os.path.join(self._index_dir, "last-added.txt")

    def _write_last_added(self) -> None:
        self.write_last_added(time.time())

    def write_last_added(self, t: float) -> None:
        with open(self._last_added_file(), "w") as f:
            f.write(str(t))

    def last_added(self) -> float:
        try:
            with open(self._last_added_file()) as f:
                return float(f.read().strip())
        except (OSError, ValueError):
            return 0.0

    # ---- weeds / negative matches ---------------------------------------
    @staticmethod
    def _pair(a: str, b: str) -> tuple[str, str]:
        return (a, b) if a <= b else (b, a)

    def _map_file(self, name: str) -> str:
        return os.path.join(self._index_dir, name)

    def _load_pairs(self, name: str) -> set[tuple[str, str]]:
        try:
            with open(self._map_file(name)) as f:
                return {tuple(p) for p in json.load(f)}
        except (OSError, ValueError):
            return set()

    def _save_pairs(self, name: str, pairs: set[tuple[str, str]]) -> None:
        from .ioutil import write_file_atomically
        write_file_atomically(self._map_file(name),
                              json.dumps(sorted(pairs)).encode())

    def add_weed(self, weed: Media, original: Media) -> bool:
        """Record weed.md5 as a deleted dup of original.md5
        (reference Database::addWeed)."""
        if weed.md5 == original.md5 or not weed.md5 or not original.md5:
            return False
        if self._weeds is None:
            self._weeds = self._load_pairs("weeds.json")
        self._weeds.add((weed.md5, original.md5))
        if self._weed_md5s is not None:
            self._weed_md5s.add(weed.md5)
        self._save_pairs("weeds.json", self._weeds)
        return True

    def is_weed(self, m: Media) -> bool:
        if self._weeds is None:
            self._weeds = self._load_pairs("weeds.json")
        if self._weed_md5s is None:  # O(1) per item — every -similar group
            # filter pass calls this; a linear any() over the pair set goes
            # quadratic as the weed list grows
            self._weed_md5s = {w for w, _ in self._weeds}
        return m.md5 in self._weed_md5s

    def unweed(self, m: Media) -> bool:
        if self._weeds is None:
            self._weeds = self._load_pairs("weeds.json")
        n = len(self._weeds)
        self._weeds = {p for p in self._weeds if p[0] != m.md5}
        if len(self._weeds) != n:
            self._weed_md5s = None
            self._save_pairs("weeds.json", self._weeds)
            return True
        return False

    def add_negative_match(self, a: Media, b: Media) -> bool:
        if a.md5 == b.md5 or not a.md5 or not b.md5:
            return False
        if self._neg is None:
            self._neg = self._load_pairs("negative.json")
        self._neg.add(self._pair(a.md5, b.md5))
        self._save_pairs("negative.json", self._neg)
        return True

    def is_negative_match(self, a: Media, b: Media) -> bool:
        if self._neg is None:
            self._neg = self._load_pairs("negative.json")
        return self._pair(a.md5, b.md5) in self._neg

    def filter_negative_matches(self, group: MediaGroup) -> MediaGroup:
        if len(group) < 2:
            return group
        needle = group[0]
        return [needle] + [m for m in group[1:]
                           if not self.is_negative_match(needle, m)]

    # ---- search ----------------------------------------------------------
    def search_index(self, index: Index, needle: Media, params: SearchParams,
                     id_map: dict[int, Media] | None = None) -> MediaGroup:
        """Single-needle search with maxThresh escalation + score sort + cap
        (reference Database::searchIndex, src/database.cpp:1691-1757)."""
        matches = index.find(needle, params)
        matches = self._escalate(index, needle, params, matches)
        return self._matches_to_group(index, needle, params, matches, id_map)

    def _escalate(self, index: Index, needle: Media, params: SearchParams,
                  matches: list[Match]) -> list[Match]:
        if params.maxThresh <= 0:
            return matches
        tmp = params.copy()
        while len(matches) <= params.minMatches:
            if params.algo in (SearchParams.ALGO_DCT, SearchParams.ALGO_DCT_FEATURES,
                               SearchParams.ALGO_VIDEO):
                tmp.dctThresh += 1
                if tmp.dctThresh > params.maxThresh:
                    break
            elif params.algo == SearchParams.ALGO_CV_FEATURES:
                tmp.cvThresh += 5
                if tmp.cvThresh > params.maxThresh:
                    break
            else:
                break
            matches = index.find(needle, tmp)
        return matches

    def _matches_to_group(self, index: Index, needle: Media, params: SearchParams,
                          matches: list[Match],
                          id_map: dict[int, Media] | None) -> MediaGroup:
        matches = sorted(matches, key=lambda m: m.score)
        group: MediaGroup = []
        for match in matches:
            if params.filterSelf and match.mediaId == needle.id:
                continue
            if len(group) >= params.maxMatches:
                break
            media = None
            if id_map is not None:
                media = id_map.get(match.mediaId)
            if media is None:
                media = self.media_with_id(match.mediaId)
                if id_map is not None:
                    id_map[match.mediaId] = media
            if media.is_valid():
                import copy
                media = copy.copy(media)
                index.find_index_data(media)
                media.score = match.score
                media.matchRange = match.range
                group.append(media)
        return group

    def similar(self, params: SearchParams) -> MediaGroupList:
        """All-pairs search (reference Database::similar); needles go to the
        device in batches via Index.find_batch — or, when the index
        supports it, entirely off the packed store arrays (find_all), so
        only needles that actually hit ever materialize a Media."""
        from ..utils.log import profile_stage
        index: Index = self.load_index(params)

        if not params.inSet and params.queryTypes & index.result_types():
            with profile_stage(f"find_all algo={params.algo}"):
                fast = index.find_all(params)
            if fast is not None:
                return self._similar_streamed(index, params, *fast)

        if params.inSet:
            haystack = list(params.set)
        else:
            haystack = self.media_with_type(params.queryTypes | params.resultTypes())

        sliced = None
        if params.inSet:
            ids = {m.id for m in params.set if m.type_flag() & params.resultTypes()}
            if ids:
                sliced = index.slice(ids)
                if sliced is not None:
                    index = sliced

        id_map = {m.id: m for m in haystack}
        needles = [m for m in haystack if m.type_flag() & params.queryTypes]

        results: list = []  # (needle, group)
        with profile_stage(f"find_batch algo={params.algo} "
                           f"needles={len(needles)}"):
            all_matches = index.find_batch(needles, params)
        all_matches = self._escalate_all(index, needles, params, all_matches)
        for needle, matches in zip(needles, all_matches):
            self._append_group(results, index, params, needle, matches,
                               id_map)
        return self._finish_groups(params, results)

    def _similar_streamed(self, index: Index, params: SearchParams,
                          store_ids, raw) -> MediaGroupList:
        """Assemble -similar groups from a store-level N² result: Media
        rows are fetched from SQL only for needles with hits and their
        matches (bounded RSS at 10M+ items; the matched set is the small
        one in a dup-sparse corpus).  ``raw`` is either a sparse
        {store row: (ids, dists)} dict (dct/fdct find_all — only hot rows
        are ever visited; a dense N-list made the 2M CLI -similar spend
        175 of 177 s in this loop, VERDICT r03) or a dense list parallel
        to store_ids."""
        from ..utils.log import profile_stage
        id_map: dict[int, Media] = {}
        results: list = []  # (needle, group)
        items = sorted(raw.items()) if isinstance(raw, dict) \
            else enumerate(raw)
        n_hot = len(raw) if isinstance(raw, dict) else len(store_ids)
        with profile_stage(f"group assembly ({n_hot} hot rows)"):
            for row, (ids, dists) in items:
                nid = int(store_ids[row])
                if nid == 0 or len(ids) == 0:
                    continue
                matches = [Match(int(i), int(d)) for i, d in zip(ids, dists)]
                if params.filterSelf and all(m.mediaId == nid for m in matches):
                    continue  # lone self-hit: skip without touching SQL
                needle = id_map.get(nid)
                if needle is None:
                    needle = self.media_with_id(nid)
                    id_map[nid] = needle
                if not needle.is_valid():
                    continue
                self._append_group(results, index, params, needle, matches,
                                   id_map)
        return self._finish_groups(params, results)

    def _make_tm(self, params: SearchParams):
        if not params.templateMatch:
            return None
        if self.make_matcher is not None:
            return self.make_matcher()
        from ..host.template_matcher import TemplateMatcher
        return TemplateMatcher()

    def _escalate_all(self, index: Index, needles: list[Media],
                      params: SearchParams, all_matches: list) -> list:
        """Batched maxThresh escalation: ONE find_batch per threshold step
        over the still-short needles (the reference escalates per needle,
        src/database.cpp:1691-1757 — dispatch-bound at N² scale)."""
        if params.maxThresh <= 0:
            return all_matches
        tmp = params.copy()
        pend = [i for i, m in enumerate(all_matches)
                if len(m) <= params.minMatches]
        while pend:
            if params.algo in (SearchParams.ALGO_DCT,
                               SearchParams.ALGO_DCT_FEATURES,
                               SearchParams.ALGO_VIDEO):
                tmp.dctThresh += 1
                if tmp.dctThresh > params.maxThresh:
                    break
            elif params.algo == SearchParams.ALGO_CV_FEATURES:
                tmp.cvThresh += 5
                if tmp.cvThresh > params.maxThresh:
                    break
            else:
                break
            sub = index.find_batch([needles[i] for i in pend], tmp)
            for i, m in zip(pend, sub):
                all_matches[i] = m
            pend = [i for i in pend if len(all_matches[i]) <= params.minMatches]
        return all_matches

    def _append_group(self, results: list, index: Index,
                      params: SearchParams, needle: Media, matches: list,
                      id_map: dict) -> None:
        """Appends (needle, its group) when the group is not empty."""
        group = self._matches_to_group(index, needle, params, matches, id_map)
        if group:
            results.append((needle, group))

    def _finish_groups(self, params: SearchParams,
                       pending: list) -> MediaGroupList:
        """(needle, group) pairs -> the result: -p.tm's verification of
        every group (``TemplateMatcher.match_groups``, the same verdicts
        as one ``match`` a group in this order), the filters, the sort."""
        from ..utils.log import profile_stage
        tm = self._make_tm(params)
        if tm is not None:
            with profile_stage(f"template match ({len(pending)} groups)"):
                tm.match_groups(pending, params)
        results: MediaGroupList = []
        for needle, group in pending:
            if not group:
                continue
            needle2 = needle
            # propagate the first matched frame into the needle's range so
            # the GUI/dump can show the aligned frame (reference
            # src/database.cpp:1410-1416)
            for m in group:
                if m.matchRange.dstIn >= 0:
                    import copy
                    needle2 = copy.copy(needle)
                    needle2.matchRange = MatchRange(-1, m.matchRange.srcIn, 1)
                    break
            results.append([needle2] + group)
        with profile_stage(f"filter+sort ({len(results)} groups)"):
            out: MediaGroupList = []
            for group in results:
                if not self.filter_match(params, group):
                    out.append(group)
            out = self.filter_matches(params, out)
            sort_group_list(out, ["path"])
            return out

    def similar_to(self, needle: Media, params: SearchParams) -> MediaGroup:
        """Single/multi needle query (reference Database::similarTo)."""
        index = self.load_index(params)
        sliced = None
        if params.inSet:
            ids = {m.id for m in params.set}
            if ids:
                sliced = index.slice(ids)
                if sliced is not None:
                    index = sliced
        result = self.search_index(index, needle, params)
        group = [needle] + result
        if self.filter_match(params, group):
            return []
        return group[1:]

    # ---- result filtering -------------------------------------------------
    def filter_match(self, params: SearchParams, match: MediaGroup) -> bool:
        """@return True if the group should be dropped
        (reference Database::filterMatch, src/database.cpp:1209-1247)."""
        if params.negativeMatch:
            match[:] = self.filter_negative_matches(match)
        for m in match:
            if self.is_weed(m):
                m.isWeed = True
        if params.path and len(match) > 1:
            prefix = params.path
            if not prefix.startswith(self.path()):
                prefix = os.path.join(self.path(), params.path)
            kept = [match[0]]
            for m in match[1:]:
                if (not params.inPath) ^ m.path.startswith(prefix):
                    kept.append(m)
            match[:] = kept
        if params.filterParent and len(match) > 1:
            parent = match[0].dir_path()
            match[:] = [match[0]] + [m for m in match[1:] if m.dir_path() != parent]
        return len(match) <= params.minMatches

    def filter_matches(self, params: SearchParams,
                       matches: MediaGroupList) -> MediaGroupList:
        """Group dedup ({a,b}=={b,a}) + merge/expand
        (reference Database::filterMatches, src/database.cpp:1249-1278)."""
        if params.filterGroups:
            sort_group_list(matches, ["path"])
            seen: set[tuple] = set()
            filtered: MediaGroupList = []
            for group in matches:
                sig = tuple(sorted(m.path for m in group))
                if sig not in seen:
                    seen.add(sig)
                    filtered.append(group)
            matches = filtered
        if params.mergeGroups:
            matches = merge_group_list(matches)
        elif params.expandGroups:
            matches = expand_group_list(matches)
        return matches

    def memory_usage(self) -> int:
        return sum(i.memory_usage() for i in self._algos)
