"""Ingest pipeline: filesystem walk -> host decode workers -> device batches.

Port of ``cbird_tpu/host/scanner.py`` with the port's ``DctHasher``: the
host walks the tree (include/exclude globs, zip members), decodes and
digests images on worker threads, and the device hashes fixed-size
batches of grayscale canvases (autocrop + DCT, ``ops/dct_hash.py``).  The
walk, decode, archive handling and the longest-job-first video queue are
those of the reference module (videos decode in ``host/video.py``); the
color and feature descriptors are not ported yet.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import io
import os
import zipfile
from typing import Callable, Iterable, Optional

import numpy as np
from PIL import Image, ImageOps

from ..ops.dct_hash import DctHasher
from ..params import IndexParams, SearchParams, TYPE_IMAGE, TYPE_VIDEO
from ..store.ioutil import FileId, image_content_md5
from ..store.media import Media, archive_paths
from ..utils.log import profile_stage

Image.MAX_IMAGE_PIXELS = None  # the scanner guards sizes itself

IMAGE_EXTS = {"jpg", "jpeg", "png", "gif", "bmp", "webp", "tif", "tiff",
              "ppm", "pgm", "pbm", "ico", "jfif"}
VIDEO_EXTS = {"mp4", "mkv", "avi", "mov", "webm", "m4v", "mpg", "mpeg",
              "wmv", "flv", "ts", "3gp", "ogv", "fseq"}
ARCHIVE_EXTS = {"zip", "cbz"}

# typed errors (reference src/scanner.h:125-135)
ERROR_OPEN = "open error"
ERROR_LOAD = "decode error"
ERROR_TOO_SMALL = "file too small"
ERROR_JPEG_TRUNCATED = "truncated jpeg"
ERROR_DUP_INODE = "duplicate inode"
ERROR_ZIP = "zip error"

# image algorithms other than dct: their descriptors are not ported yet
UNPORTED_IMAGE_ALGOS = ((1 << SearchParams.ALGO_COLOR)
                        | (1 << SearchParams.ALGO_DCT_FEATURES)
                        | (1 << SearchParams.ALGO_CV_FEATURES))


class NotPortedError(RuntimeError):
    """A feature of the JAX package that this package does not have yet."""


@dataclasses.dataclass
class DecodedImage:
    path: str
    gray: Optional[np.ndarray]  # prescaled grayscale for hashing
    width: int                  # original dimensions
    height: int
    md5: str
    error: Optional[str] = None


@dataclasses.dataclass
class ScanResult:
    new_images: list[str] = dataclasses.field(default_factory=list)
    new_videos: list[str] = dataclasses.field(default_factory=list)
    modified: list[str] = dataclasses.field(default_factory=list)
    removed_ids: list[int] = dataclasses.field(default_factory=list)
    ignored: int = 0


def _fsize(path: str) -> int:
    try:
        return os.stat(path).st_size
    except OSError:
        return 0


def media_type_for(path: str) -> int:
    ext = path.rsplit(".", 1)[-1].lower() if "." in path else ""
    if ext in IMAGE_EXTS:
        return TYPE_IMAGE
    if ext in VIDEO_EXTS:
        return TYPE_VIDEO
    return 0


def read_bytes(path: str) -> bytes:
    """Read a file or an ``archive.zip:member`` virtual path."""
    arch, member = archive_paths(path)
    if arch:
        with zipfile.ZipFile(arch) as z:
            return z.read(member)
    with open(path, "rb") as f:
        return f.read()


class Scanner:
    def __init__(self, params: IndexParams | None = None,
                 canvas: int | None = None, device=None):
        self.params = params or IndexParams()
        self._errors: dict[str, str] = {}
        rsize = self.params.resizeLongestSide
        if canvas is None:
            canvas = ((int(rsize * 1.6) + 63) // 64) * 64
        self._hasher = DctHasher(canvas_hw=(canvas, canvas), batch=64,
                                 device=device)

    # ---- error registry --------------------------------------------------
    def errors(self) -> dict[str, str]:
        return dict(self._errors)

    def set_error(self, path: str, err: str) -> None:
        self._errors[path] = err

    # ---- directory walk --------------------------------------------------
    def scan_directory(self, root: str,
                       expected: dict[str, tuple[int, int, int]] | None = None,
                       mod_time: float = 0.0) -> ScanResult:
        """Diff the tree against the already-indexed set
        (reference Scanner::scanDirectory + readDirectory)."""
        expected = dict(expected or {})
        result = ScanResult()
        p = self.params
        seen_inodes: set[FileId] = set()
        queued: set[str] = set()  # resolveLinks can map 2 paths to 1 target
        want_images = bool(p.types & 1)
        want_videos = bool(p.types & 2)
        abs_root = os.path.abspath(root)

        for dirpath, dirnames, filenames in os.walk(root, followlinks=p.followSymlinks):
            if not p.recursive and os.path.abspath(dirpath) != os.path.abspath(root):
                dirnames.clear()
                continue
            # never descend into our own index dir
            dirnames[:] = [d for d in sorted(dirnames)
                           if d != "_index" and not d.startswith(".")]
            for name in sorted(filenames):
                if name.startswith("."):
                    continue
                path = os.path.join(dirpath, name)
                if not p.path_included(path):
                    result.ignored += 1
                    continue
                if p.resolveLinks and os.path.islink(path):
                    canonical = os.path.realpath(path)
                    if canonical.startswith(abs_root + os.sep):
                        path = canonical
                ext = name.rsplit(".", 1)[-1].lower() if "." in name else ""
                if ext in ARCHIVE_EXTS:
                    if p.modTime and mod_time and \
                            self._zip_unchanged(path, mod_time, expected):
                        continue  # metadata time predates last add: skip
                    self._scan_archive(path, expected, result)
                    continue
                mtype = media_type_for(name)
                if mtype == 0:
                    result.ignored += 1
                    continue
                try:
                    st = os.stat(path)
                except OSError:
                    self.set_error(path, ERROR_OPEN)
                    continue
                if st.st_size < p.minFileSize:
                    result.ignored += 1
                    if p.showIgnored:
                        self.set_error(path, ERROR_TOO_SMALL)
                    continue
                if not p.dupInodes:
                    fid = FileId(path)
                    if fid.is_valid() and fid in seen_inodes:
                        self.set_error(path, ERROR_DUP_INODE)
                        continue
                    seen_inodes.add(fid)
                known = expected.pop(path, None)
                if known is not None:
                    if mod_time and st.st_mtime > mod_time:
                        result.modified.append(path)
                    continue
                if path in queued:
                    continue  # e.g. a link and its resolved target
                queued.add(path)
                if mtype == TYPE_IMAGE and want_images:
                    result.new_images.append(path)
                elif mtype == TYPE_VIDEO and want_videos:
                    result.new_videos.append(path)

        # anything still in expected is gone from disk
        result.removed_ids = [mid for mid, _, _ in expected.values()]
        self._order_video_queue(result.new_videos)
        return result

    def _order_video_queue(self, queue: list[str]) -> None:
        """Longest-job-first video ordering (reference src/scanner.cpp:159-206):
        with -i.ljf (default) each video is probed and jobs are sorted by
        estimated decode cost (total pixels) descending; otherwise
        likely-multithreaded container extensions go first, then file size
        descending."""
        if len(queue) < 2:
            return
        if self.params.estimateCost:
            from .video import backend_for

            def cost(path: str) -> float:
                be = backend_for(path)
                if be is None:
                    return 0.0
                try:
                    meta = be.probe(path)
                except Exception:
                    return 0.0
                # probe reports fps 0.0 when the stream has no rate:
                # assume 25 so long rate-less videos still sort first
                return (meta.get("duration", 0.0)
                        * (meta.get("fps", 0.0) or 25.0)
                        * meta.get("width", 0) * meta.get("height", 0))

            costs = {p: cost(p) for p in queue}
            queue.sort(key=lambda p: (costs[p], _fsize(p)), reverse=True)
        else:
            mt_formats = {"mp4", "mkv", "mpg", "webm"}
            queue.sort(key=lambda p: (p.rsplit(".", 1)[-1].lower() in mt_formats,
                                      _fsize(p)), reverse=True)

    @staticmethod
    def _zip_unchanged(path: str, mod_time: float, expected: dict) -> bool:
        """-i.modtime fast path: an archive whose metadata-change time
        predates the last add keeps its indexed members."""
        try:
            if os.stat(path).st_ctime >= mod_time:
                return False
        except OSError:
            return False
        members = [k for k in expected if k.startswith(path + ":")]
        if not members:
            return False  # unknown zip must still be read
        for k in members:
            expected.pop(k)
        return True

    def _scan_archive(self, path: str, expected, result: ScanResult) -> None:
        """Enumerate zip members as virtual paths."""
        try:
            with zipfile.ZipFile(path) as z:
                for info in z.infolist():
                    if info.is_dir():
                        continue
                    member = info.filename
                    if os.path.basename(member).startswith("."):
                        continue
                    if media_type_for(member) != TYPE_IMAGE:
                        continue
                    if info.file_size < self.params.minFileSize:
                        result.ignored += 1
                        continue
                    vpath = f"{path}:{member}"
                    if expected.pop(vpath, None) is None:
                        result.new_images.append(vpath)
        except (zipfile.BadZipFile, OSError):
            self.set_error(path, ERROR_ZIP)

    # ---- image decode ----------------------------------------------------
    def decode_image(self, path: str) -> DecodedImage:
        """Decode + digest one image: md5 over the jpeg scan payload,
        scaled jpeg decode targeting [rsize, 1.5*rsize] on the longest
        side, EXIF auto-orientation."""
        rsize = self.params.resizeLongestSide
        try:
            data = read_bytes(path)
        except (OSError, KeyError, zipfile.BadZipFile):
            self.set_error(path, ERROR_OPEN)
            return DecodedImage(path, None, -1, -1, "", ERROR_OPEN)

        digest, is_jpeg, truncated = image_content_md5(data)
        if truncated:
            self.set_error(path, ERROR_JPEG_TRUNCATED)
            return DecodedImage(path, None, -1, -1, digest,
                                ERROR_JPEG_TRUNCATED)
        try:
            img = Image.open(io.BytesIO(data))
            width, height = img.size
            if is_jpeg:
                img.draft(None, (rsize, rsize))  # libjpeg scaled idct
            img = ImageOps.exif_transpose(img)
            gray = img.convert("L")
            long_side = max(gray.size)
            if long_side > rsize * 1.5:
                s = rsize / long_side
                gray = gray.resize((max(1, round(gray.size[0] * s)),
                                    max(1, round(gray.size[1] * s))), Image.BOX)
            arr = np.asarray(gray)
            if arr.ndim != 2 or arr.size == 0:
                raise ValueError("bad decode")
            return DecodedImage(path, arr, width, height, digest)
        except Exception:  # any decoder failure is a typed per-file error
            self.set_error(path, ERROR_LOAD)
            return DecodedImage(path, None, -1, -1, digest, ERROR_LOAD)

    # ---- batched processing ---------------------------------------------
    def process_images(self, paths: list[str],
                       progress: Callable[[int, int], None] | None = None,
                       ) -> Iterable[Media]:
        """Decode on host threads, hash in device batches; yields Media in
        completion order of each device batch."""
        p = self.params
        if p.algos & UNPORTED_IMAGE_ALGOS:
            raise NotPortedError(
                "color, fdct and orb descriptors are not ported yet")
        want_dct = bool(p.algos & (1 << SearchParams.ALGO_DCT))
        workers = p.indexThreads or min(8, (os.cpu_count() or 1) * 2)
        batch = self._hasher.batch
        done = 0
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            def submit_chunk(chunk):
                return [pool.submit(self.decode_image, pp) for pp in chunk]

            # double-buffer: batch n+1 decodes on host threads while the
            # device hashes batch n
            chunks = [paths[s:s + batch] for s in range(0, len(paths), batch)]
            futs = submit_chunk(chunks[0]) if chunks else []
            for ci, chunk in enumerate(chunks):
                next_futs = (submit_chunk(chunks[ci + 1])
                             if ci + 1 < len(chunks) else [])
                with profile_stage(f"decode x{len(chunk)}"):
                    decoded = [f.result() for f in futs]
                futs = next_futs
                good = [d for d in decoded if d.error is None and d.gray is not None]
                hashes = np.zeros(len(good), dtype=np.uint64)
                if good and want_dct:
                    with profile_stage(f"dct hash x{len(good)}"):
                        hashes = self._hasher.hash_images(
                            [d.gray for d in good], do_crop=p.autocrop)
                for i, d in enumerate(good):
                    yield Media(d.path, TYPE_IMAGE, d.width, d.height, d.md5,
                                int(hashes[i]) if want_dct else 0)
                done += len(chunk)
                if progress:
                    progress(done, len(paths))

    def process_image_file(self, path: str, algos: int | None = None,
                           crop: bool | None = None) -> Media | None:
        """One-off processing for query needles.
        @param crop override -i.crop for this needle (-p.crop pre-filter)"""
        saved = self.params.algos
        saved_crop = self.params.autocrop
        if algos is not None:
            self.params.algos = algos
        if crop is not None:
            self.params.autocrop = crop
        try:
            out = list(self.process_images([path]))
        finally:
            self.params.algos = saved
            self.params.autocrop = saved_crop
        return out[0] if out else None
