"""Flat-file index caches — fast loads for the feature indexes.

The reference caches its in-memory indexes as flat files under
``_index/cache/`` because reconstructing them from SQL is slow
(dctfeatures.cache, cvfeatures.mat; src/dctfeaturesindex.cpp:34,
src/cvfeaturesindex.cpp:41,406-419), validated by mtime against the
database (DBHelper::isCacheFileStale, src/qtutil.h:125-132) and written
atomically.  Same design here: one .npz per index holding the packed
arrays; a cache older than its SQLite file is stale and rebuilt, corrupt
caches are deleted and rebuilt from SQL (src/dctfeaturesindex.cpp:109-126).
"""

from __future__ import annotations

import io
import os
from typing import Optional

import numpy as np

from ..store.ioutil import write_file_atomically
from ..utils.log import debug, warn


def _cache_file(cache_path: str, name: str) -> str:
    return os.path.join(cache_path, f"{name}.npz")


def _db_file_of(conn) -> Optional[str]:
    try:
        for _, name, path in conn.execute("pragma database_list"):
            if name == "main":
                return path
    except Exception:  # noqa: BLE001
        pass
    return None


def load_cache(cache_path: str, name: str, conn) -> Optional[dict]:
    """@return dict of arrays, or None when missing/stale/corrupt."""
    f = _cache_file(cache_path, name)
    if not os.path.exists(f):
        return None
    db_file = _db_file_of(conn)
    if db_file and os.path.exists(db_file):
        # committed writes can sit in the -wal without bumping the main
        # file's mtime (e.g. after a killed process) — a cache older than
        # either file may be missing recently indexed media
        db_mtime = os.path.getmtime(db_file)
        wal = db_file + "-wal"
        if os.path.exists(wal):
            db_mtime = max(db_mtime, os.path.getmtime(wal))
        if os.path.getmtime(f) < db_mtime:
            debug(f"cache stale: {f}")
            return None
    try:
        with np.load(f) as z:
            return {k: z[k] for k in z.files}
    except Exception:  # zipfile/format errors → rebuild from SQL
        warn(f"corrupt cache removed: {f}")
        try:
            os.unlink(f)
        except OSError:
            pass
        return None


# above this many raw bytes the cache is written UNCOMPRESSED: hash and
# descriptor arrays are high-entropy, so zlib buys ~20% size for 50x the
# write time (measured 7.1 s compressed vs 0.14 s raw at 10M rows) — and
# one-shot CLI runs pay the save on their first load
COMPRESS_MAX_BYTES = 16 << 20


def save_cache(cache_path: str, name: str, **arrays: np.ndarray) -> None:
    os.makedirs(cache_path, exist_ok=True)
    buf = io.BytesIO()
    total = sum(a.nbytes for a in arrays.values())
    if total <= COMPRESS_MAX_BYTES:
        np.savez_compressed(buf, **arrays)
    else:
        np.savez(buf, **arrays)
    write_file_atomically(_cache_file(cache_path, name), buf.getvalue())
