"""A collection as the CLI leaves it after ``-update``: the program's
``Database`` in a fresh temporary folder (under ``TMPDIR``), its
``media`` table filled with one row a stored item when a verb reads it,
the index's own records written by the index's adapter, and the index
loaded through ``Database.load_index``, the load path of every verb."""

from __future__ import annotations

import contextlib
import shutil
import tempfile

import numpy as np

from cbird_tpu_torch.store.database import Database
from cbird_tpu_torch.store.media import TYPE_IMAGE

WIDTH, HEIGHT = 640, 480  # the media rows' stated size; nothing reads it


class Collection:
    def __init__(self, index):
        """@param index the program's index object, not yet loaded"""
        self.root = tempfile.mkdtemp(prefix="cbird-bench-")
        self.db = Database(self.root)
        self.db.add_index(index)
        self.index = index

    def add_media(self, n: int, dct_hashes: np.ndarray | None = None) -> None:
        """Media rows 1..n (id = store row + 1), images under ``m/``."""
        zero = np.zeros(n, np.int64)
        phash = zero if dct_hashes is None else dct_hashes.view(np.int64)
        with self.bulk(self.db.connect()) as conn:
            conn.executemany(
                "insert into media (id,type,path,width,height,md5,phash_dct)"
                " values (?,?,?,?,?,?,?)",
                ((i + 1, TYPE_IMAGE, f"m/{i + 1}.jpg", WIDTH, HEIGHT, "",
                  int(h)) for i, h in enumerate(phash.tolist())))

    def connect_index(self):
        """The connection the index's records go to (use it in
        ``bulk``)."""
        return self.db.connect(self.index.database_id())

    @staticmethod
    @contextlib.contextmanager
    def bulk(conn):
        """A bulk write of the collection's rows, the benchmark's stand-in
        for an earlier ``-update``: no journal and no sync while it runs
        (half the bytes written, none waited for), committed, then the
        connection back in the journal mode the program set."""
        mode = conn.execute("pragma journal_mode").fetchone()[0]
        sync = conn.execute("pragma synchronous").fetchone()[0]
        conn.execute("pragma journal_mode=off")
        conn.execute("pragma synchronous=off")
        try:
            yield conn
            conn.commit()
        finally:
            conn.execute(f"pragma synchronous={int(sync)}")
            conn.execute(f"pragma journal_mode={mode}")

    def load(self, params):
        """The index through ``Database.load_index``."""
        return self.db.load_index(params)

    def close(self) -> None:
        self.db.close()
        shutil.rmtree(self.root, ignore_errors=True)
