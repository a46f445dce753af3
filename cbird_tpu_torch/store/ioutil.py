"""IO utilities: atomic writes, md5 digests, jpeg payload isolation.

Rebuild of the reference's ioutil + scanner byte helpers
(src/ioutil.h:33-232, src/scanner.cpp:904-978):

- ``write_file_atomically``: temp file + rename, required for cache safety.
- ``full_md5`` / ``sparse_md5``: content digests.
- ``jpeg_payload``: md5 is computed over the jpeg scan payload (EXIF/APPn
  segments stripped) so a metadata edit doesn't re-index the file.
- ``find_jpeg_marker``: jpeg detection + truncation check (missing EOI).
"""

from __future__ import annotations

import hashlib
import os
import tempfile


def write_file_atomically(path: str, data: bytes) -> None:
    """Write via temp file in the same directory + os.replace (atomic on POSIX)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-", suffix=os.path.basename(path))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def full_md5(data: bytes) -> str:
    return hashlib.md5(data).hexdigest()


def full_md5_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def sparse_md5_file(path: str, block: int = 1 << 20) -> str:
    """Digest of first/middle/last blocks + size; fast identity for huge files."""
    size = os.path.getsize(path)
    h = hashlib.md5()
    h.update(str(size).encode())
    with open(path, "rb") as f:
        h.update(f.read(block))
        if size > 3 * block:
            f.seek(size // 2)
            h.update(f.read(block))
        if size > block:
            f.seek(max(0, size - block))
            h.update(f.read(block))
    return h.hexdigest()


def find_jpeg_marker(data: bytes) -> tuple[bool, bool]:
    """@return (is_jpeg, is_truncated). Truncated = missing EOI trailer
    (reference src/scanner.cpp:966-978)."""
    if len(data) <= 3:
        return False, False
    is_jpeg = data[0] == 0xFF and data[1] == 0xD8
    truncated = False
    if is_jpeg and (data[-2] != 0xFF or data[-1] != 0xD9):
        truncated = True
    return is_jpeg, truncated


def jpeg_payload(data: bytes) -> bytes:
    """Return bytes from the first SOS marker to EOF so APPn/EXIF edits don't
    change the digest (reference src/scanner.cpp:927-964).

    Walks markers; application segments (0xE1-0xEF) are skipped over by their
    declared length since they may embed a thumbnail jpeg whose SOS would
    give the wrong offset.
    """
    # marker-hop scan via bytes.find — jump from 0xFF to 0xFF instead of
    # walking every byte; the same scan as the JAX package's native one
    # (cbird_tpu/native/cbird_host.cpp::cbird_jpeg_payload_offset), so the
    # digests are identical
    size = len(data)
    pos = 0
    while True:
        p = data.find(0xFF, pos)
        if p < 0 or p + 1 >= size:
            return data
        code = data[p + 1]
        if code == 0xFF:  # fill byte: next FF may start the marker
            pos = p + 1
        elif 0xE1 <= code <= 0xEF:  # APPn: hop the declared body
            if p + 3 < size:
                pos = p + 2 + ((data[p + 2] << 8) | data[p + 3])
            else:
                pos = p + 2
        elif code == 0xDA:  # first start-of-scan wins
            return data[p:] if p else data
        else:
            pos = p + 2


def image_content_md5(data: bytes) -> tuple[str, bool, bool]:
    """md5 of image content (jpeg payload for jpegs).

    @return (digest, is_jpeg, is_truncated)
    """
    is_jpeg, truncated = find_jpeg_marker(data)
    if is_jpeg:
        data = jpeg_payload(data)
    return full_md5(data), is_jpeg, truncated


class FileId:
    """Inode/device identity for duplicate-inode detection
    (reference src/fsutil.h)."""

    __slots__ = ("dev", "ino")

    def __init__(self, path: str):
        try:
            st = os.stat(path)
            self.dev, self.ino = st.st_dev, st.st_ino
        except OSError:
            self.dev = self.ino = -1

    def is_valid(self) -> bool:
        return self.ino >= 0

    def __eq__(self, other) -> bool:
        return (self.dev, self.ino) == (other.dev, other.ino)

    def __hash__(self) -> int:
        return hash((self.dev, self.ino))
