"""Packed per-video frame-hash store on one PyTorch device.

Port of ``cbird_tpu/ops/video_search.py`` ``PackedVideoStore`` on one
device (the mesh branches are not ported).  All videos' retained frame
hashes live in one packed array with a parallel video-slot column; the
video index (``index/dct_video_index.py``) searches it three ways:

- ``flat_hit_counts``: per needle frame, the stored frames under the
  threshold, ignoring video identity: the count gate, through the
  tensor-core count kernel (``ops/count_below_mma.py``, K1-mma) in
  batches of 16,384 needles (the popcount K1 at threshold 64);
- ``search_hits``: every sub-threshold (needle, frame row) pair: the
  counts, then the exact top-k (K4) for needles with hits; the count is
  kept as a check, and a needle past ``k_cap`` hits returns None;
- ``search``: the dense [Q, V] per-video minimum of (distance, frame),
  the fallback for those needles, in plain PyTorch (popcount, then
  ``(d << 24) | frame`` and a scatter-min per chunk), as the JAX package
  computes it in XLA outside any Pallas kernel.

Device layout: [F_pad] int64 hash bit patterns, int32 video slots and
frame numbers, bool validity (frames of removed videos are invalid),
padded to ``ops.hamming._bucket`` rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from .count_below import chunk_cols, popcount64
from .count_below_mma import count_gate
from .hamming import PackedHashStore, _bucket
from .hamming_topk import hamming_topk

_FRAME_BITS = 24
_FRAME_MASK = (1 << _FRAME_BITS) - 1
_BIG = (65 << _FRAME_BITS) | _FRAME_MASK
_DENSE_PAIRS = 1 << 24  # bound of the dense search's [Q, chunk] temporaries


def frame_search(needles: torch.Tensor, hashes: torch.Tensor,
                 vidx: torch.Tensor, frame_no: torch.Tensor,
                 valid: torch.Tensor, num_videos: int):
    """Per needle and video, the nearest frame: the minimum of the packed
    (distance << 24 | frame), so ties go to the lower frame number.

    @param needles [Q] int64; hashes [F] int64; vidx [F] int32 video
    slot per frame; frame_no [F] int32; valid [F] bool
    @return (min_dist [Q, V] int32, 65 = no match; min_frame [Q, V])"""
    q = needles.numel()
    dev = needles.device
    acc = torch.full((q, num_videos), _BIG, dtype=torch.int32, device=dev)
    chunk = chunk_cols(q, dev) if dev.type == "cpu" else \
        max(1, _DENSE_PAIRS // q)
    for c0 in range(0, hashes.numel(), chunk):
        h = hashes[c0:c0 + chunk]
        d = popcount64(needles[:, None] ^ h[None, :])
        packed = (d << _FRAME_BITS) | (frame_no[c0:c0 + chunk]
                                       & _FRAME_MASK)[None, :]
        packed = torch.where(valid[None, c0:c0 + chunk], packed, _BIG)
        slot = vidx[c0:c0 + chunk].long()[None, :].expand(q, -1)
        acc.scatter_reduce_(1, slot, packed.to(torch.int32), "amin")
    return acc >> _FRAME_BITS, acc & _FRAME_MASK


class PackedVideoStore:
    """Packed frame-hash store: all videos' retained frames in parallel
    arrays, searched with per-video segment-min reductions."""

    def __init__(self, device=None):
        self.device = resolve(device)
        self._media_ids: list[int] = []     # video slot -> media id (0 = removed)
        self._hashes = np.zeros(0, np.uint64)
        self._vidx = np.zeros(0, np.int32)  # frame -> video slot
        self._frames = np.zeros(0, np.int32)
        # per-video appends buffer here and consolidate lazily: a
        # concatenate per add_video would make a V-video ingest O(V^2)
        self._pending: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._dev = None
        self._by_slot = None      # slot -> stored hashes (built lazily)
        self._hash_store = None   # frame rows as a PackedHashStore (lazily)

    def _consolidate(self) -> None:
        if self._pending:
            self._hashes = np.concatenate(
                [self._hashes] + [p[0] for p in self._pending])
            self._vidx = np.concatenate(
                [self._vidx] + [p[1] for p in self._pending])
            self._frames = np.concatenate(
                [self._frames] + [p[2] for p in self._pending])
            self._pending.clear()

    def __len__(self):
        return sum(1 for i in self._media_ids if i)

    def frame_count(self) -> int:
        return len(self._hashes) + sum(len(p[0]) for p in self._pending)

    @property
    def media_ids(self):
        return self._media_ids

    def memory_usage(self) -> int:
        return self.frame_count() * (8 + 4 + 4)

    def add_video(self, media_id: int, frames: np.ndarray,
                  hashes: np.ndarray) -> None:
        slot = len(self._media_ids)
        self._media_ids.append(int(media_id))
        self._pending.append((np.asarray(hashes, np.uint64),
                              np.full(len(hashes), slot, np.int32),
                              np.asarray(frames, np.int32)))
        self._dev = None
        self._by_slot = None
        self._hash_store = None

    def video_hashes(self, media_id: int) -> np.ndarray | None:
        """Stored frame hashes (u64) of one media id, or None if absent:
        the N^2 gate compares a needle's in-memory hashes against these
        (a caller-supplied videoIndex can diverge from the stored .vdx)."""
        mid = int(media_id)
        if mid == 0:
            return None
        try:
            slot = self._media_ids.index(mid)
        except ValueError:
            return None
        self._consolidate()
        if self._by_slot is None:
            order = np.argsort(self._vidx, kind="stable")
            bounds = np.searchsorted(self._vidx[order],
                                     np.arange(len(self._media_ids) + 1))
            self._by_slot = (self._hashes[order], bounds)
        hashes, bounds = self._by_slot
        return hashes[bounds[slot]:bounds[slot + 1]]

    def remove(self, media_ids) -> None:
        kill = set(int(i) for i in media_ids)
        changed = False
        for slot, mid in enumerate(self._media_ids):
            if mid in kill:
                self._media_ids[slot] = 0
                changed = True
        if changed:
            self._dev = None
            self._hash_store = None

    def _device(self):
        """@return (hashes int64, vidx int32, frames int32, valid bool),
        each [F_pad] on the device"""
        if self._dev is None:
            self._consolidate()
            n = len(self._hashes)
            fb = _bucket(max(n, 1))
            hashes = np.zeros(fb, np.int64)
            vidx = np.zeros(fb, np.int32)
            frames = np.zeros(fb, np.int32)
            valid = np.zeros(fb, bool)
            if n:
                hashes[:n] = self._hashes.view(np.int64)
                vidx[:n] = self._vidx
                frames[:n] = self._frames
                alive = np.array([bool(m) for m in self._media_ids], bool)
                valid[:n] = alive[self._vidx]
            self._dev = tuple(torch.from_numpy(a).to(self.device)
                              for a in (hashes, vidx, frames, valid))
        return self._dev

    def _needles(self, needle_hashes: np.ndarray) -> torch.Tensor:
        h = np.ascontiguousarray(needle_hashes, dtype=np.uint64).view(np.int64)
        return torch.from_numpy(h).to(self.device)

    def flat_hit_counts(self, needle_hashes: np.ndarray, threshold: int,
                        needle_batch: int = 16384) -> np.ndarray:
        """Per needle FRAME count of sub-threshold stored frames, ignoring
        video identity.  The video-video N^2 gate aggregates these per
        needle video: a stored needle's frame hits itself exactly once
        (same-video retained frames are >= vht > dctThresh apart), so
        frames with >= 2 counts have a cross-video hit.

        @return counts [len(needle_hashes)] int32"""
        n = len(needle_hashes)
        if n == 0 or self.frame_count() == 0:
            return np.zeros(n, np.int32)
        hashes, _, _, valid = self._device()
        needles = self._needles(needle_hashes)
        parts = [count_gate(needles[s0:s0 + needle_batch], hashes, valid,
                            threshold)
                 for s0 in range(0, n, needle_batch)]
        return torch.cat(parts).cpu().numpy().astype(np.int32)

    def row_maps(self):
        """(vidx [F] int32, frames [F] int32) host arrays aligned with the
        row indices search_hits returns."""
        self._consolidate()
        return self._vidx, self._frames

    def as_hash_store(self) -> PackedHashStore:
        """The frame rows as a PackedHashStore with ids = row + 1 (0 for
        rows of removed videos): the triangular N^2 self-search runs over
        frames, and ids map back to rows as id - 1.  Cached until the
        store changes."""
        if self._hash_store is None:
            self._consolidate()
            n = len(self._hashes)
            ids = np.arange(1, n + 1, dtype=np.uint32)
            if n:
                alive = np.array([bool(m) for m in self._media_ids], bool)
                ids[~alive[self._vidx]] = 0
            self._hash_store = PackedHashStore(self._hashes, ids,
                                               device=self.device)
        return self._hash_store

    def search_hits(self, needle_hashes: np.ndarray, threshold: int,
                    k_cap: int = 4096, needle_batch: int = 1024,
                    counts: np.ndarray | None = None):
        """Every sub-threshold (needle, frame row) pair: exact per-needle
        counts, then the exact top-k (K4) at distance < threshold for the
        needles that hit.  K4 is exact, so a needle returns None only when
        its count exceeds ``k_cap``; the count is kept as a check, and a
        top-k that disagrees with it raises.

        @param counts optional precomputed flat_hit_counts(needle_hashes,
               threshold), so a caller that gated on it scans once
        @return list per needle of (row_idx [m] int32, dist [m] int32),
                m = exact sub-threshold count, or None (dense fallback)"""
        n = len(needle_hashes)
        empty = (np.zeros(0, np.int32), np.zeros(0, np.int32))
        if n == 0 or self.frame_count() == 0:
            return [empty] * n
        if counts is None:
            counts = self.flat_hit_counts(needle_hashes, threshold,
                                          needle_batch=max(needle_batch,
                                                           16384))
        results: list = [empty] * n
        for needle in np.nonzero(counts > k_cap)[0]:
            results[needle] = None  # overflow past k_cap: dense fallback
        hot = np.nonzero((counts > 0) & (counts <= k_cap))[0]
        if len(hot) == 0:
            return results
        hashes, _, _, valid = self._device()
        needles = self._needles(needle_hashes)
        hot_dev = torch.from_numpy(hot.astype(np.int64)).to(self.device)
        for s in range(0, len(hot), needle_batch):
            sel = hot[s:s + needle_batch]
            # k per batch (a power of two <= k_cap), so one hot needle
            # elsewhere does not inflate every readback
            k = int(min(k_cap, max(64, 1 << int(counts[sel].max() - 1)
                                   .bit_length())))
            k = min(k, hashes.numel())
            d, i = hamming_topk(needles[hot_dev[s:s + needle_batch]], hashes,
                                valid, k, threshold)
            d, i = d.cpu().numpy(), i.cpu().numpy()
            hit = d < threshold
            got = hit.sum(axis=1)
            for r, needle in enumerate(sel):
                # k >= the count, so the exact top-k holds every hit
                if got[r] != counts[needle]:
                    raise RuntimeError(
                        f"needle {needle}: the top-k found {got[r]} frames "
                        f"under threshold {threshold}, the count gate "
                        f"{counts[needle]}")
                cols = np.nonzero(hit[r])[0]
                results[needle] = (i[r, cols].astype(np.int32),
                                   d[r, cols].astype(np.int32))
        return results

    def search(self, needle_hashes: np.ndarray, needle_batch: int = 256):
        """@param needle_hashes [Q] uint64
        @return (min_dist [Q, V] int32 with 65 = miss, min_frame [Q, V]
        int32), V = number of video slots (.media_ids maps them to ids)"""
        v = len(self._media_ids)
        q_total = len(needle_hashes)
        if q_total == 0 or v == 0 or self.frame_count() == 0:
            return (np.full((q_total, max(v, 1)), 65, np.int32),
                    np.zeros((q_total, max(v, 1)), np.int32))
        hashes, vidx, frames, valid = self._device()
        needles = self._needles(needle_hashes)
        out_d = np.zeros((q_total, v), np.int32)
        out_f = np.zeros((q_total, v), np.int32)
        for s in range(0, q_total, needle_batch):
            d, fr = frame_search(needles[s:s + needle_batch], hashes, vidx,
                                 frames, valid, v)
            out_d[s:s + needle_batch] = d.cpu().numpy()
            out_f[s:s + needle_batch] = fr.cpu().numpy()
        return out_d, out_f
