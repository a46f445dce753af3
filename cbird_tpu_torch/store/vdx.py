"""Per-video hash file (.vdx) — byte-compatible with the reference container.

Rebuild of VideoIndex (src/videoindex.{h,cpp}).  The logical
content is two parallel arrays: retained frame numbers + their 64-bit DCT
hashes.  Two on-disk versions exist and this module reads BOTH and writes v2
with the exact reference byte layout, so an `_index/video/` directory built
by the reference binary loads unchanged (and vice versa):

- **v1** (legacy, 16-bit): ``u16 count | u16 frames[count] | u64 hashes[count]``
  (src/videoindex.cpp:448-541).  Loading applies the reference's two repair
  quirks: the 65k frame-number wrap bug (truncate at the wrap; mark with
  frame 65535 so -migrate schedules a re-index) and the non-zero-first-frame
  bug (prepend frame 0 / hash 0).
- **v2**: text header ``cbird video index:<ver>:2:<byteorder>:1:8:<count>:\\n``
  then ``u32 packedLen``, 7-bit varint frame *offsets* (LSB group first,
  0x80 marks continuation; the stream starts with a literal 0x00 encoding
  frame 0), zero padding to 8-byte alignment, raw little-endian u64 hashes,
  and a 4-byte ``cbir`` trailer for fast truncation checks
  (src/videoindex.cpp:223-429).

Version sniffing matches getVersion (src/videoindex.cpp:41-68): the first
five bytes spell ``cbird`` for v2, anything else is treated as v1.

``migrate`` replicates VideoIndex::migrate (src/videoindex.cpp:104-221):
invalid v1 files are removed, v1 files ending on frame 65535 (the wrap
marker) are copied to ``resume-<md5>.vdx`` so the scanner resumes hashing
mid-file, and the rest are converted to v2 via a verified temp-file swap.
"""

from __future__ import annotations

import os
import shutil
import struct
import tempfile

import numpy as np

from .ioutil import write_file_atomically
from .media import VideoIndexData

MAGIC_V2 = b"cbird"
VERSION_STR = "0.8.1-tpu"  # header[1]; informational only (reference: CBIRD_VERSION)
BYTE_ORDER = 1  # QSysInfo::LittleEndian
TRAILER = b"cbir"
MAX_FRAMES_PER_VIDEO = 1 << 24  # reference src/dctvideoindex.h:50


def _pack_offsets(frames: np.ndarray) -> bytes:
    """7-bit varint encoding of frame deltas (save_v2, videoindex.cpp:285-319).

    The stream begins with the byte for frame 0 (always 0x00); each
    subsequent offset is emitted LSB-group first with 0x80 set on every
    group except the last."""
    if frames[0] != 0:
        raise ValueError("first frame must be 0")
    out = bytearray(b"\x00")
    prev = 0
    for f in frames[1:].tolist():
        off = f - prev
        if off < 1:
            raise ValueError(f"non-sequential frame number {f} after {prev}")
        prev = f
        while True:
            group = off & 0x7F
            off >>= 7
            out.append(group | (0x80 if off else 0x00))
            if not off:
                break
    return bytes(out)


def _unpack_offsets(packed: bytes, limit: int) -> np.ndarray:
    """Vectorized inverse of _pack_offsets (load_v2, videoindex.cpp:390-409).

    @param limit stop after this many frames (MAX_FRAMES_PER_VIDEO cap)
    @raises ValueError on a trailing unresolved continuation byte"""
    b = np.frombuffer(packed, dtype=np.uint8)
    if len(b) == 0:
        return np.zeros(0, np.int32)
    term = (b & 0x80) == 0
    if not term[-1]:
        raise ValueError("unresolved offset, possibly corrupt file")
    term_idx = np.nonzero(term)[0]
    starts = np.concatenate([[0], term_idx[:-1] + 1])  # first byte of each value
    vid = np.cumsum(np.concatenate([[False], term[:-1]]))  # value id per byte
    shift = np.arange(len(b)) - starts[vid]
    contrib = (b & 0x7F).astype(np.int64) << (7 * shift)
    values = np.add.reduceat(contrib, starts)
    frames = np.cumsum(values)[:limit]
    return frames.astype(np.int32)


def save_vdx(path: str, index: VideoIndexData, **_compat) -> None:
    """Write reference-format v2 (save_v2, videoindex.cpp:271-349)."""
    frames = np.asarray(index.frames, dtype=np.int64)
    hashes = np.asarray(index.hashes, dtype="<u8")
    assert len(frames) == len(hashes), "corrupt video index"
    header = (f"cbird video index:{VERSION_STR}:2:{BYTE_ORDER}:1:8:"
              f"{len(frames)}:\n").encode("latin-1")
    if len(frames) == 0:
        write_file_atomically(path, header)
        return
    packed = _pack_offsets(frames)
    here = len(header) + 4 + len(packed)
    pad = (-here) % 8  # align hashes for potential mmap (videoindex.cpp:332-339)
    blob = (header + struct.pack("<I", len(packed)) + packed + b"\x00" * pad
            + hashes.tobytes() + TRAILER)
    write_file_atomically(path, blob)


def _parse_header_v2(blob: bytes) -> tuple[list[bytes], int]:
    """@return (colon-split header fields, offset past the header line)"""
    nl = blob.find(b"\n")
    if nl < 0 or nl > 255:
        raise ValueError("missing header")
    fields = blob[:nl].split(b":")  # trailing ':' → 8 fields, last empty
    if len(fields) != 8 or fields[0] != b"cbird video index":
        raise ValueError("not a cbird video index")
    if (int(fields[2]) != 2 or int(fields[4]) != 1 or int(fields[5]) != 8):
        raise ValueError(
            f"unsupported format, written by cbird version: {fields[1]!r}")
    if int(fields[3]) != BYTE_ORDER:
        raise ValueError("written with different endianness")
    return fields, nl + 1


def _load_v2(blob: bytes, path: str) -> VideoIndexData:
    fields, off = _parse_header_v2(blob)
    num_frames = int(fields[6] or 0)
    if num_frames == 0:
        return VideoIndexData()
    reduced = num_frames > MAX_FRAMES_PER_VIDEO
    if reduced:
        num_frames = MAX_FRAMES_PER_VIDEO
    (packed_len,) = struct.unpack_from("<I", blob, off)
    if packed_len < num_frames:
        raise ValueError(f"invalid file, unexpected packed size: {packed_len}")
    off += 4
    frames = _unpack_offsets(blob[off:off + packed_len], num_frames)
    if len(frames) != num_frames:
        raise ValueError(
            f"failed to read expected number of frames: {num_frames} {len(frames)}")
    off += packed_len
    off += (-(off)) % 8  # skip alignment padding
    hashes = np.frombuffer(blob, dtype="<u8", count=num_frames, offset=off)
    return VideoIndexData(frames=frames, hashes=hashes.astype(np.uint64))


def _load_v1(blob: bytes, path: str) -> VideoIndexData:
    """v1 reader incl. wrap + first-frame repair (videoindex.cpp:478-541)."""
    if len(blob) < 2:
        raise ValueError(f"truncated v1 header: {path}")
    (num_frames,) = struct.unpack_from("<H", blob, 0)
    if num_frames == 0:
        return VideoIndexData()
    need = 2 + 2 * num_frames + 8 * num_frames
    if len(blob) < need:
        raise ValueError(f"truncated v1 payload: {path}")
    raw = np.frombuffer(blob, dtype="<u2", count=num_frames, offset=2)
    frames = raw.astype(np.int32)
    count = num_frames
    drops = np.nonzero(np.diff(frames) < 0)[0]
    if len(drops):
        i = int(drops[0]) + 1  # first non-monotonic position
        last = int(frames[i - 1])
        if last > 65000:
            # 65k wrap bug: truncate and mark with the 65535 sentinel so
            # -migrate schedules a full re-index (videoindex.cpp:505-517)
            if last != 0xFFFF:
                frames = frames.copy()
                frames[i] = 0xFFFF
                i += 1
            count = i
            frames = frames[:count]
        else:
            raise ValueError(f"non-sequential frame number (corrupt file?): {path}")
    hashes = np.frombuffer(blob, dtype="<u8", count=count,
                           offset=2 + 2 * num_frames).astype(np.uint64)
    if count and frames[0] != 0:  # old writer bug (videoindex.cpp:531-535)
        frames = np.concatenate([[0], frames]).astype(np.int32)
        hashes = np.concatenate([np.zeros(1, np.uint64), hashes])
    return VideoIndexData(frames=np.ascontiguousarray(frames), hashes=hashes)


def vdx_version(blob: bytes) -> int:
    return 2 if blob[:5] == MAGIC_V2 else 1


def load_vdx(path: str) -> VideoIndexData:
    with open(path, "rb") as f:
        blob = f.read()
    if vdx_version(blob) == 2:
        return _load_v2(blob, path)
    return _load_v1(blob, path)


def is_valid_vdx(path: str) -> bool:
    """verify_v1/verify_v2 (videoindex.cpp:248-269,431-446): header sanity,
    exact size (v1) or trailer presence (v2)."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return False
    try:
        if vdx_version(blob) == 2:
            fields, _ = _parse_header_v2(blob)
            if int(fields[6] or 0) == 0:
                return True  # "no frames stored" is valid (cpp:255-258)
            return blob[-4:] == TRAILER
        (num_frames,) = struct.unpack_from("<H", blob, 0)
        return len(blob) == 2 + 2 * num_frames + 8 * num_frames
    except (ValueError, struct.error):
        return False


def migrate(media_ids: list[tuple[int, str]], video_root: str,
            dry_run: bool = False) -> tuple[int, int]:
    """Upgrade v1 .vdx files in ``video_root`` to v2
    (VideoIndex::migrate, videoindex.cpp:104-221).

    @param media_ids (id, md5) of every indexed video
    @return (updated, removed)"""
    from ..utils.log import info, warn
    updated = removed = 0
    if dry_run:
        info("dry run, checking conversion with temp file")
    for mid, md5 in media_ids:
        path = os.path.join(video_root, f"{mid}.vdx")
        if not os.path.exists(path):
            continue  # vindex was disabled for this file; fine
        with open(path, "rb") as f:
            blob = f.read()
        if vdx_version(blob) != 1:
            continue
        if not is_valid_vdx(path):
            warn(f"removing invalid file: {path}")
            if not dry_run:
                os.remove(path)
                removed += 1
            continue
        try:
            v1 = _load_v1(blob, path)
        except ValueError:
            warn(f"removing file with errors: {path}")
            if not dry_run:
                os.remove(path)
                removed += 1
            continue
        if len(v1.frames) and int(v1.frames[-1]) == 0xFFFF:
            # hit the 65k wrap: stash for the scanner to resume mid-file
            info(f"re-indexing for >65k frames: {path}")
            resume = os.path.join(video_root, f"resume-{md5}.vdx")
            if dry_run:
                continue
            if os.path.exists(resume):
                os.remove(resume)
            shutil.copyfile(path, resume)
            os.remove(path)
            removed += 1
            continue
        if dry_run:
            tmp = os.path.join(tempfile.gettempdir(), "cbird-dryrun.vdx")
        else:
            tmp = os.path.join(video_root, f"migrate-{mid}.vdx")
        try:
            save_vdx(tmp, v1)
        except ValueError:
            # e.g. duplicate frame numbers that slip past the v1 repairs —
            # treat like any other unreadable file: drop and move on
            warn(f"removing file with errors: {path}")
            if not dry_run:
                os.remove(path)
                removed += 1
            continue
        if not is_valid_vdx(tmp):
            raise RuntimeError("aborting: invalid file after conversion")
        v2 = load_vdx(tmp)
        if (len(v1.frames) != len(v2.frames)
                or not np.array_equal(v1.frames, v2.frames)
                or not np.array_equal(v1.hashes, v2.hashes)):
            raise RuntimeError("aborting: data mismatch after conversion")
        if not dry_run:
            backup = path + ".bak"
            os.rename(path, backup)
            os.rename(tmp, path)
            os.remove(backup)
            updated += 1
        else:
            os.remove(tmp)
    if updated or removed:
        info("index was updated")
    if removed:
        info("run -update to refresh index")
    return updated, removed
