"""Engine — composition root wiring Scanner -> Database -> the indexes.

Port of ``cbird_tpu/host/engine.py`` for every algorithm: it registers
the port's ``DctHashIndex``, ``ColorDescIndex``, ``DctFeaturesIndex``,
``CvFeaturesIndex`` and ``DctVideoIndex``.  Videos decode on worker
threads and hash on the engine's device (``host/video.py``), and commit
one by one in completion order.  The template matcher (`-p.tm`) runs on
the engine's device with the scanner's decode: ``template_matcher`` makes
one for each ``Database.similar`` and one that ``query`` keeps.
"""

from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np

from ..device import resolve
from ..index.color_desc_index import ColorDescIndex
from ..index.cv_features_index import CvFeaturesIndex
from ..index.dct_features_index import DctFeaturesIndex
from ..index.dct_hash_index import DctHashIndex
from ..index.dct_video_index import DctVideoIndex
from ..ops.color import create_descriptors
from ..ops.orb import extract_features_batch
from ..params import IndexParams, SearchParams, TYPE_IMAGE, TYPE_VIDEO
from ..store.database import Database
from ..store.media import Media, MediaGroup
from ..store.vdx import is_valid_vdx
from ..utils.log import info, warn
from .scanner import Scanner, media_type_for
from .template_matcher import TemplateMatcher
from .video import (DECODE_MAX_SIDE, backend_for, grab_frame, process_video,
                    process_videos)

DCT_MASK = 1 << SearchParams.ALGO_DCT
VIDEO_MASK = 1 << SearchParams.ALGO_VIDEO
COLOR_MASK = 1 << SearchParams.ALGO_COLOR
FEATURE_ALGOS = (SearchParams.ALGO_DCT_FEATURES, SearchParams.ALGO_CV_FEATURES)
IMAGE_MASK = (DCT_MASK | COLOR_MASK | (1 << SearchParams.ALGO_DCT_FEATURES)
              | (1 << SearchParams.ALGO_CV_FEATURES))


class Engine:
    def __init__(self, root: str, index_params: IndexParams | None = None,
                 device=None):
        self.params = index_params or IndexParams()
        self.device = resolve(device)
        self.db = Database(root)
        self.scanner = Scanner(self.params, device=self.device)
        self.db.make_matcher = self.template_matcher
        self._tm: TemplateMatcher | None = None
        self._stop_requested = False
        self.db.add_index(DctHashIndex(self.device))
        self.db.add_index(ColorDescIndex(self.device))
        self.db.add_index(DctFeaturesIndex(self.device))
        self.db.add_index(CvFeaturesIndex(self.device))
        self.db.add_index(DctVideoIndex(self.device))

    def template_matcher(self) -> TemplateMatcher:
        """A template matcher on the engine's device and decode."""
        return TemplateMatcher(self.scanner.decode_image, self.device)

    def stop_update(self) -> None:
        """Request a graceful stop of a running update: the batch loop
        commits the media it already processed and returns."""
        self._stop_requested = True

    # ---- update ----------------------------------------------------------
    def update(self, subdir: str = "",
               progress: Callable[[int, int], None] | None = None) -> dict:
        """Incremental re-scan (reference Engine::update).
        @return stats dict {added, removed, modified, errors, stopped,
                modified_kept}: the modified files whose old rows a
                stopped update kept because it did not re-add them"""
        p = self.params
        root = os.path.join(self.db.path(), subdir) if subdir else self.db.path()

        self._verify_vdx_files()
        if not p.modTime and self._modtime_capable():
            p.modTime = True

        expected = self.db.indexed_items()
        scan = self.scanner.scan_directory(root, expected, self.db.last_added())

        # algo-change sync: re-index items missing newly-enabled algos
        if p.sync:
            for path, (mid, mtype, algos_present) in self.db.indexed_items().items():
                needed = p.algos & (VIDEO_MASK if mtype == TYPE_VIDEO
                                    else IMAGE_MASK)
                if needed & ~algos_present:
                    if mtype == TYPE_IMAGE:
                        scan.modified.append(path)
                    else:
                        scan.new_videos.append(path)
                        scan.removed_ids.append(mid)

        if scan.removed_ids and not p.dryRun:
            self.db.remove(scan.removed_ids)

        # modified files: each indexed row is removed just before its re-add
        # is written, so a stopped update keeps the rows it did not reach
        stale = {}
        for path in scan.modified:
            m = self.db.media_with_path(path)
            if m.id:
                stale[path] = m.id
        todo_images = scan.new_images + scan.modified

        if p.dryRun:
            for path in todo_images:
                info(f"would add: {path}")
            return {"added": 0, "removed": len(scan.removed_ids),
                    "modified": len(scan.modified),
                    "errors": self.scanner.errors(), "stopped": False}

        def write(batch: list[Media]) -> None:
            self.db.remove([stale.pop(m.path) for m in batch
                            if m.path in stale])
            self.db.add(batch)

        added = 0
        self._stop_requested = False
        batch: list[Media] = []
        for m in self.scanner.process_images(todo_images, progress):
            batch.append(m)
            if len(batch) >= p.writeBatchSize:
                write(batch)
                added += len(batch)
                batch = []
            if self._stop_requested:
                break
        if batch:
            write(batch)
            added += len(batch)
        if self._stop_requested:
            # the modified rows not reached stay as they were; the next
            # update must see their files as modified again
            self._rewind_last_added(list(stale))
        else:
            self.db.remove(list(stale.values()))  # failed to re-add

        # videos decode concurrently (LJF-ordered queue, -i.decoderThreads
        # workers) feeding the shared device hasher; each commits as it
        # completes, like the reference (src/engine.cpp:85-92)
        if p.algos & VIDEO_MASK and not self._stop_requested:
            for path, m in process_videos(scan.new_videos, self.params,
                                          video_dir=self.db.video_path(),
                                          device=self.device):
                if m is not None:
                    self.db.add([m])
                    added += 1
                else:
                    self.scanner.set_error(path, "video decode error")
                if self._stop_requested:
                    break

        self.db.save_indices()
        return {"added": added, "removed": len(scan.removed_ids),
                "modified": len(scan.modified), "errors": self.scanner.errors(),
                "stopped": self._stop_requested,
                "modified_kept": sorted(stale) if self._stop_requested else []}

    def _rewind_last_added(self, paths: list[str]) -> None:
        """Set the last-added time just below the oldest modification
        time among ``paths``, so that the next scan finds them modified."""
        times = []
        for path in paths:
            try:
                times.append(os.stat(path).st_mtime)
            except OSError:
                pass
        if times:
            self.db.write_last_added(min(min(times) - 1e-3,
                                         self.db.last_added()))

    def _modtime_capable(self) -> bool:
        """True when a rename bumps st_ctime on the index filesystem (the
        reference's modtime-check-before/after probe)."""
        d = self.db.index_path()
        before = os.path.join(d, "modtime-check-before.txt")
        after = os.path.join(d, "modtime-check-after.txt")
        try:
            with open(before, "w") as f:
                f.write("x")
            t0 = os.stat(before).st_ctime_ns
            time.sleep(0.02)
            os.rename(before, after)
            return os.stat(after).st_ctime_ns > t0
        except OSError:
            return False
        finally:
            for pth in (before, after):
                try:
                    os.unlink(pth)
                except OSError:
                    pass

    def _verify_vdx_files(self) -> None:
        """Remove media whose .vdx went missing/corrupt so they re-index."""
        bad = []
        for row in self.db.connect().execute(
                "select id from media where type=?", (TYPE_VIDEO,)):
            vdx = os.path.join(self.db.video_path(), f"{row[0]}.vdx")
            if not os.path.exists(vdx) or not is_valid_vdx(vdx):
                bad.append(row[0])
        if bad:
            warn(f"removing {len(bad)} videos with missing/corrupt .vdx")
            self.db.remove(bad)

    # ---- query -----------------------------------------------------------
    def query(self, needle: Media, params: SearchParams) -> MediaGroup:
        """Single-needle search incl. on-the-fly processing of an
        unindexed needle and mirror variants (reference Engine::query)."""
        if needle.path and params.algo != SearchParams.ALGO_VIDEO \
                and (needle.type == TYPE_VIDEO
                     or media_type_for(needle.path) == TYPE_VIDEO):
            # video needle + image algo: grab 9 evenly-spaced frames and
            # query them as image needles (reference -similar-to <video>,
            # src/main.cpp:1136-1196 via VideoContext::frameGrab)
            return self._video_grab_query(needle, params)
        if needle.id == 0 and needle.path and not needle.dctHash:
            indexed = self.db.media_with_path(needle.path)
            if indexed.is_valid():
                needle = indexed
            else:
                if media_type_for(needle.path) == TYPE_VIDEO:
                    # unindexed video needle: hash its frames on the fly
                    processed = process_video(needle.path, self.params,
                                              device=self.device)
                else:
                    algos = (DCT_MASK if params.algo == SearchParams.ALGO_VIDEO
                             else 1 << params.algo)
                    processed = self.scanner.process_image_file(
                        needle.path, algos,
                        crop=True if params.autoCrop else None)
                if processed is None:
                    warn(f"cannot process needle: {needle.path}")
                    return []
                needle = processed

        matches = self.db.similar_to(needle, params)

        if params.templateMatch and matches:
            if self._tm is None:
                self._tm = self.template_matcher()
            self._tm.match(needle, matches, params)

        if params.mirrorMask and params.algo != SearchParams.ALGO_COLOR:
            matches += self._mirror_query(needle, params)
            seen = set()
            uniq = []
            # (score, path) sort: equal-score direct/mirror duplicates
            # dedupe deterministically
            for m in sorted(matches, key=lambda m: (m.score, m.path)):
                if m.path not in seen:
                    seen.add(m.path)
                    uniq.append(m)
            matches = uniq[:params.maxMatches]
        matches.sort(key=lambda m: m.score)
        return matches

    GRAB_COUNT = 9  # frame grabs for a video needle (src/main.cpp:1150)

    def _video_grab_query(self, needle: Media, params: SearchParams) -> MediaGroup:
        """Video needle against the image index: decode GRAB_COUNT evenly-
        spaced frames, hash them as image needles, query each and merge
        best-score-per-path (reference src/main.cpp:1136-1196)."""
        be = backend_for(needle.path)
        if be is None:
            warn(f"no video decode backend for {needle.path}")
            return []
        try:
            meta = be.probe(needle.path)
        except Exception:  # noqa: BLE001
            warn(f"cannot probe video needle: {needle.path}")
            return []
        fps = meta.get("fps") or 25.0
        total = int(round(meta.get("duration", 0.0) * fps))
        n = self.GRAB_COUNT
        if total > n:
            targets = sorted({total * i // (n + 1) for i in range(1, n + 1)})
        else:
            targets = list(range(max(total, 1)))
        grays = []
        for t in targets:
            frame = grab_frame(needle.path, t, max_side=DECODE_MAX_SIDE)
            if frame is not None:
                grays.append(frame)
        if not grays:
            return []
        out: MediaGroup = []
        for m in self._needles_from_images(grays, needle, needle.width,
                                           needle.height, params):
            out += self.db.similar_to(m, params)
        best: dict = {}
        for m in out:
            if m.path not in best or m.score < best[m.path].score:
                best[m.path] = m
        matches = sorted(best.values(), key=lambda m: m.score)
        if params.filterSelf:
            matches = [m for m in matches if m.path != needle.path]
        return matches[:params.maxMatches]

    def _mirror_query(self, needle: Media, params: SearchParams) -> MediaGroup:
        """Re-process flipped variants of the needle (dct re-hashes, fdct
        and orb re-extract features) and search each; color needs no
        mirror pass (the histogram is orientation-invariant)."""
        if params.algo == SearchParams.ALGO_COLOR:
            return []
        d = self.scanner.decode_image(needle.path)
        if d.gray is None:
            return []
        flips = []
        if params.mirrorMask & SearchParams.MIRROR_HORIZONTAL:
            flips.append(np.ascontiguousarray(np.fliplr(d.gray)))
        if params.mirrorMask & SearchParams.MIRROR_VERTICAL:
            flips.append(np.ascontiguousarray(np.flipud(d.gray)))
        if params.mirrorMask & SearchParams.MIRROR_BOTH:
            flips.append(np.ascontiguousarray(np.flipud(np.fliplr(d.gray))))
        if not flips:
            return []
        out: MediaGroup = []
        for m in self._needles_from_images(flips, needle, d.width, d.height,
                                           params):
            out += self.db.similar_to(m, params)
        return out

    def _needles_from_images(self, grays: list[np.ndarray], needle: Media,
                             width: int, height: int,
                             params: SearchParams) -> list[Media]:
        """Image needles of ``params.algo`` from grayscale images (a video
        needle's frames, the flips of a mirror query): dct hashes, fdct
        keypoint hashes, orb descriptors, or color descriptors of the
        frames stacked to RGB."""
        if params.algo == SearchParams.ALGO_COLOR:
            needles = []
            rgb = [np.stack([g, g, g], axis=-1) for g in grays]
            for desc in create_descriptors(rgb, device=self.device):
                m = Media(needle.path, TYPE_IMAGE, width, height, needle.md5,
                          id=needle.id)
                m.colorDescriptor = desc
                needles.append(m)
            return needles
        if params.algo in FEATURE_ALGOS:
            want_desc = params.algo == SearchParams.ALGO_CV_FEATURES
            needles = []
            for desc, hashes in extract_features_batch(
                    grays, self.params.numFeatures,
                    want_descriptors=want_desc, want_hashes=not want_desc,
                    device=self.device):
                m = Media(needle.path, TYPE_IMAGE, width, height, needle.md5,
                          id=needle.id)
                m.keyPointDescriptors = desc
                m.keyPointHashes = hashes
                needles.append(m)
            return needles
        hashes = self.scanner._hasher.hash_images(
            grays, do_crop=self.params.autocrop or params.autoCrop)
        return [Media(needle.path, TYPE_IMAGE, width, height, needle.md5,
                      int(h), id=needle.id) for h in hashes]
