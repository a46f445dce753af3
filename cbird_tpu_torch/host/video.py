"""Video ingest: pluggable decode backends → device frame hashing → window
compression.

Port of ``cbird_tpu/host/video.py`` with the port's ``DctHasher``.  A
rebuild of the reference video path (VideoContext FFmpeg wrapper,
src/videocontext.{h,cpp}; Media::makeVideoIndex, src/media.cpp:925-1037):
decode stays on the host while hashing moves to the device in large frame
batches; the reference hashes frame-by-frame on the decoder thread.

Backends:
- ``FfmpegBackend``: ffmpeg subprocess, grayscale rawvideo pipe scaled to
  ≤128px (the reference decodes at maxW/H 128 gray with skip_loop_filter,
  src/scanner.cpp:1040-1064) — used when an ffmpeg binary exists.
- ``FseqBackend``: ``.fseq`` frame-sequence files (npz: frames [N,H,W] u8 +
  fps) — hardware-free fixture format for tests and frame dumps.

The hash-run window compression (drop a frame when every hash in the window
since the last retained frame is within threshold; always retain the last
frame) replicates src/media.cpp:998-1031.  It is the reference behaviour's
pure-Python loop (the JAX package also has a native helper for it).

Every function that hashes takes the device explicitly; decode workers
share one hasher per device under a lock that covers each whole batch.
"""

from __future__ import annotations

import io
import os
import shutil
import subprocess
import threading
from typing import Iterator, Optional

import numpy as np

from ..device import resolve
from ..ops.dct_hash import DctHasher
from ..ops.ref_numpy import hamming64
from ..params import IndexParams, TYPE_VIDEO
from ..store.ioutil import full_md5_file
from ..store.media import Media, VideoIndexData
from ..utils.log import debug, warn

MAX_FRAMES_PER_VIDEO = 1 << 24  # 24-bit frame ids (reference src/dctvideoindex.h:50)
DECODE_MAX_SIDE = 128


# ---------------------------------------------------------------------------
# decode backends
# ---------------------------------------------------------------------------

class FseqBackend:
    """npz frame-sequence 'video': {frames: [N,H,W] uint8, fps: float}."""

    EXT = "fseq"

    @staticmethod
    def save(path: str, frames: np.ndarray, fps: float = 25.0) -> None:
        buf = io.BytesIO()
        np.savez_compressed(buf, frames=np.asarray(frames, dtype=np.uint8),
                            fps=np.float64(fps))
        with open(path, "wb") as f:
            f.write(buf.getvalue())

    def probe(self, path: str) -> dict:
        with np.load(path) as z:
            n, h, w = z["frames"].shape
            fps = float(z["fps"])
        return {"width": w, "height": h, "fps": fps, "duration": n / fps}

    def frames(self, path: str, max_side: int = DECODE_MAX_SIDE,
               start: int = 0) -> Iterator[np.ndarray]:
        with np.load(path) as z:
            arr = z["frames"][start:] if start else z["frames"]
            for frame in arr:
                if max(frame.shape) > max_side:
                    s = max_side / max(frame.shape)
                    from PIL import Image
                    im = Image.fromarray(frame).resize(
                        (max(1, round(frame.shape[1] * s)),
                         max(1, round(frame.shape[0] * s))), Image.BOX)
                    frame = np.asarray(im)
                yield frame


# Below this many frames a seek decodes-and-drops from frame 0 (cheap, and
# exact for any timestamp weirdness); at/above it an -ss keyframe seek pays
# off.  ~12s of 25fps video, a few GOPs.
SEEK_MIN_FRAMES = 300
# Input seek lands on the nearest keyframe at/before the target; back off
# this many seconds so the GOP containing the target is always decoded.
SEEK_GUARD_SECONDS = 10.0


def decode_cmd(path: str, ow: int, oh: int, start: int = 0,
               fps: float = 0.0, start_time: float = 0.0) -> list[str]:
    """Build the ffmpeg decode command (pure, unit-testable: the test
    environment has no ffmpeg binary).

    Small/zero ``start``: decode from 0, a select filter drops frames
    before ``start`` after decode (always exact).  Large ``start`` with a
    known ``fps``: fast keyframe seek via ``-ss`` before ``-i`` to
    ``SEEK_GUARD_SECONDS`` ahead of the target, then ``-copyts`` keeps the
    original timestamps so a time-based select drops the sub-GOP remainder
    — the reference's fast-then-accurate seek ladder
    (src/videocontext.cpp:1642-1773) without decoding the whole prefix."""
    pre = ["ffmpeg", "-v", "error", "-skip_frame", "default", "-flags2", "fast"]
    post: list[str] = []
    vf_select = ""
    if start >= SEEK_MIN_FRAMES and fps > 0:
        # input -ss is relative to the file start (ffmpeg adds the
        # container's start_time itself) but under -copyts the select
        # filter sees original timestamps, so only the select threshold
        # carries start_time — adding it to -ss too would double-count
        # (badly wrong on MPEG-TS with a large PCR base)
        seek_t = max(0.0, start / fps - SEEK_GUARD_SECONDS)
        if seek_t > 0:
            target_t = start / fps + start_time
            pre += ["-ss", f"{seek_t:.6f}"]
            post = ["-copyts"]
            # t is the original timestamp under -copyts; half a frame of
            # slack so float rounding never drops the target frame itself
            vf_select = f"select=gte(t\\,{target_t - 0.5 / fps:.6f}),"
        else:
            vf_select = f"select=gte(n\\,{start}),"
    elif start:
        vf_select = f"select=gte(n\\,{start}),"
    return (pre + ["-i", path] + post +
            ["-vf", f"{vf_select}scale={ow}:{oh}", "-fps_mode", "passthrough",
             "-f", "rawvideo", "-pix_fmt", "gray", "-"])


class FfmpegBackend:
    """ffmpeg subprocess decode: grayscale, ≤128px, fast flags."""

    @staticmethod
    def available() -> bool:
        return shutil.which("ffmpeg") is not None and shutil.which("ffprobe") is not None

    @staticmethod
    def _parse_rate(rate) -> float:
        num, _, den = str(rate or "").partition("/")
        try:
            return float(num) / float(den or 1)
        except (ValueError, ZeroDivisionError):  # "", "abc", "0/0"
            return 0.0

    def probe(self, path: str) -> dict:
        out = subprocess.run(
            ["ffprobe", "-v", "error", "-select_streams", "v:0",
             "-show_entries",
             "stream=width,height,r_frame_rate,avg_frame_rate,duration,start_time",
             "-of", "json", path],
            capture_output=True, text=True, timeout=60).stdout
        import json
        try:
            st = json.loads(out)["streams"][0]
        except (ValueError, KeyError, IndexError):
            st = {}
        fps = self._parse_rate(st.get("r_frame_rate"))
        avg = self._parse_rate(st.get("avg_frame_rate"))

        def _f(key):
            try:
                return float(st.get(key))
            except (TypeError, ValueError):
                return 0.0
        # "fps" stays 0.0 when the stream doesn't report a rate — the -ss
        # seek ladder must never compute a frame→time mapping from a
        # made-up 25.0 (a real 60 fps file would land 2.4x off); display
        # consumers fall back to 25 themselves
        return {"width": int(st.get("width", 0) or 0),
                "height": int(st.get("height", 0) or 0),
                "fps": fps, "avg_fps": avg, "duration": _f("duration"),
                "start_time": _f("start_time")}

    def frames(self, path: str, max_side: int = DECODE_MAX_SIDE,
               start: int = 0) -> Iterator[np.ndarray]:
        """@param start first frame number to yield (frame-accurate; large
        offsets use an -ss keyframe seek, see decode_cmd)."""
        meta = self.probe(path)
        w, h = meta["width"], meta["height"]
        if w <= 0 or h <= 0:
            return
        scale = min(1.0, max_side / max(w, h))
        ow, oh = max(2, int(w * scale) // 2 * 2), max(2, int(h * scale) // 2 * 2)
        # the time-based -ss seek assumes constant frame rate; when the
        # container's nominal and measured rates disagree (VFR screen
        # recordings etc.) force fps=0 so decode_cmd uses the exact
        # frame-number select from 0 instead of landing on wrong frames
        fps, avg = meta["fps"], meta.get("avg_fps", 0.0)
        seek_fps = fps if (fps > 0 and avg > 0
                           and abs(fps - avg) <= 0.001 * fps) else 0.0
        proc = subprocess.Popen(
            decode_cmd(path, ow, oh, start=start, fps=seek_fps,
                       start_time=meta.get("start_time", 0.0)),
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
        frame_bytes = ow * oh
        try:
            while True:
                buf = proc.stdout.read(frame_bytes)
                if len(buf) < frame_bytes:
                    break
                yield np.frombuffer(buf, dtype=np.uint8).reshape(oh, ow)
        finally:
            proc.stdout.close()
            proc.wait()


def backend_for(path: str):
    if path.lower().endswith(".fseq"):
        return FseqBackend()
    if FfmpegBackend.available():
        return FfmpegBackend()
    return None


def grab_frame(path: str, frame_no: int,
               max_side: int = 100000) -> Optional[np.ndarray]:
    """Decode exactly one frame (reference VideoContext::frameGrab,
    src/videocontext.cpp:354+): seeks via the backend's start support and
    stops the decoder after the first yielded frame."""
    be = backend_for(path)
    if be is None:
        return None
    it = be.frames(path, max_side=max_side, start=frame_no)
    try:
        return next(iter(it), None)
    finally:
        if hasattr(it, "close"):
            it.close()


# ---------------------------------------------------------------------------
# hash-run window compression (reference src/media.cpp:998-1031)
# ---------------------------------------------------------------------------

def compress_hash_run(hashes: np.ndarray, threshold: int):
    """@param hashes [N] uint64 per-frame hashes (frame i = hash i)
    @return (frames [M] int32, kept [M] uint64)

    Frame 0 is always retained.  A later frame is dropped when *every* hash
    in the window since the last retained frame is within ``threshold``;
    the final frame is always appended as a reference point."""
    n = len(hashes)
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.uint64)
    frames = [0]
    kept = [hashes[0]]
    window: list[int] = []
    for i in range(1, n):
        h = int(hashes[i])
        if threshold > 0:
            close = sum(1 for prev in window if hamming64(prev, h) < threshold)
            if close != len(window):
                window.clear()
                frames.append(i)
                kept.append(hashes[i])
            window.append(h)
        else:
            frames.append(i)
            kept.append(hashes[i])
    last = n - 1
    if frames[-1] != last:
        frames.append(last)
        kept.append(np.uint64(window[-1]) if window else hashes[last])
    return np.array(frames, dtype=np.int32), np.array(kept, dtype=np.uint64)


# ---------------------------------------------------------------------------
# per-file processing
# ---------------------------------------------------------------------------

_video_hashers: dict = {}  # device -> its shared frame hasher
_hasher_lock = threading.Lock()  # decode workers share one device hasher


def _hasher(device) -> DctHasher:
    dev = resolve(device)
    with _hasher_lock:
        if dev not in _video_hashers:
            _video_hashers[dev] = DctHasher(
                canvas_hw=(DECODE_MAX_SIDE, DECODE_MAX_SIDE), batch=256,
                device=dev)
        return _video_hashers[dev]


def make_video_index(frame_iter: Iterator[np.ndarray], threshold: int,
                     batch: int = 256, start_frame: int = 0,
                     device=None) -> VideoIndexData:
    """Hash every frame in device batches (autocrop 20 first, like the
    reference: grayscale → autocrop → dctHash per frame,
    src/media.cpp:991-996), then window-compress the run.

    @param start_frame number the first yielded frame carries (mid-video
    resume, reference src/media.cpp:930-937: the first resumed frame is
    retained unconditionally, which compress_hash_run guarantees for the
    head of a run).
    @param device the hasher's device (None: ``CBIRD_TORCH_DEVICE``)"""
    hasher = _hasher(device)
    all_hashes: list[np.ndarray] = []
    chunk: list[np.ndarray] = []
    total = start_frame
    for frame in frame_iter:
        chunk.append(frame)
        total += 1
        if len(chunk) >= batch:
            with _hasher_lock:  # decode runs parallel; the device is shared
                all_hashes.append(hasher.hash_images(chunk, do_crop=True))
            chunk = []
        if total >= MAX_FRAMES_PER_VIDEO:
            warn("too many frames, skipping the rest")
            break
    if chunk:
        with _hasher_lock:
            all_hashes.append(hasher.hash_images(chunk, do_crop=True))
    if not all_hashes:
        return VideoIndexData()
    hashes = np.concatenate(all_hashes)
    frames, kept = compress_hash_run(hashes, threshold)
    return VideoIndexData(frames=frames + np.int32(start_frame), hashes=kept)


def process_video(path: str, params: IndexParams,
                  video_dir: Optional[str] = None,
                  device=None) -> Optional[Media]:
    """Decode + hash one video into a Media with videoIndex
    (reference Scanner::processVideo, src/scanner.cpp:1066-1130).

    When ``video_dir`` holds a ``resume-<md5>.vdx`` (left by -migrate for
    videos that hit the v1 65k-frame wrap, src/scanner.cpp:1105-1116), the
    stored run is kept and hashing resumes from its last frame + 1."""
    backend = backend_for(path)
    if backend is None:
        warn(f"no video decode backend for {path} (ffmpeg not found)")
        return None
    try:
        meta = backend.probe(path)
    except Exception:
        return None
    md5 = full_md5_file(path)

    resume_path = None
    prior = None
    if video_dir:
        p = os.path.join(video_dir, f"resume-{md5}.vdx")
        if os.path.exists(p):
            from ..store.vdx import load_vdx
            try:
                prior = load_vdx(p)
            except (OSError, ValueError):
                prior = None
            if prior is not None and prior.is_empty():
                prior = None
            resume_path = p

    if prior is not None:
        start = int(prior.frames[-1]) + 1
        debug(f"resuming index from frame: {start}")
        tail = make_video_index(backend.frames(path, start=start),
                                params.videoThreshold, start_frame=start,
                                device=device)
        if tail.is_empty():
            # resume point past the end (like a failed seek,
            # src/media.cpp:934-937): fall back to a full re-hash
            index = make_video_index(backend.frames(path),
                                     params.videoThreshold, device=device)
        else:
            index = VideoIndexData(
                frames=np.concatenate([prior.frames, tail.frames]),
                hashes=np.concatenate([prior.hashes, tail.hashes]))
    else:
        index = make_video_index(backend.frames(path), params.videoThreshold,
                                 device=device)
    if index.is_empty():
        return None
    if resume_path and os.path.exists(resume_path):
        os.remove(resume_path)
    m = Media(path, TYPE_VIDEO, meta.get("width", -1), meta.get("height", -1),
              md5, 0)
    m.videoIndex = index
    debug(f"video {os.path.basename(path)}: {len(index.frames)} retained frames")
    return m


def _safe_process_video(path: str, params: IndexParams,
                        video_dir: Optional[str], device) -> Optional[Media]:
    """process_video with per-file error isolation: one broken container
    must not kill the whole ingest run (reference scanner error handling,
    src/scanner.cpp:1066-1130)."""
    try:
        return process_video(path, params, video_dir=video_dir,
                             device=device)
    except Exception as e:  # noqa: BLE001 — isolate any decode failure
        warn(f"video ingest failed: {path}: {e}")
        return None


def process_videos(paths: list[str], params: IndexParams,
                   video_dir: Optional[str] = None, workers: int = 0,
                   device=None):
    """Concurrent video ingest (reference video job scheduler,
    src/scanner.cpp:159-206,599-758): M decode workers run in parallel —
    ffmpeg decodes are separate subprocesses, .fseq decode is numpy — and
    feed the shared device hasher through a lock, so the card stays fed
    while the next videos decode.  Callers pass the scanner's LJF-ordered
    queue so the longest videos start first.

    @param workers 0 → -i.decoderThreads, else min(4, cpu count)
    @return iterator of (path, Media | None) in COMPLETION order — commit
    per video as results arrive (src/engine.cpp:85-92)."""
    if not paths:
        return
    if workers <= 0:
        workers = params.decoderThreads or min(4, max(1, os.cpu_count() or 1))
    workers = min(workers, len(paths))
    if workers <= 1:
        for path in paths:
            yield path, _safe_process_video(path, params, video_dir, device)
        return
    from concurrent.futures import ThreadPoolExecutor, as_completed
    with ThreadPoolExecutor(max_workers=workers) as ex:
        futs = {ex.submit(_safe_process_video, p, params, video_dir,
                          device): p
                for p in paths}
        for f in as_completed(futs):
            yield futs[f], f.result()
