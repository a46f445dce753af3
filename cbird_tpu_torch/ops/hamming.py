"""Packed Hamming hash store on one PyTorch device.

Port of ``cbird_tpu/ops/hamming.py`` ``PackedHashStore`` in the
configuration ``CBIRD_PIGEONHOLE=off`` selects on one device: the count
phase is exact, so its result sets equal those with pigeonhole on.  The
mesh branches, the pigeonhole count phase and its extraction are not
ported here.

Layout: the host keeps [N] uint64 hashes and [N] uint32 media ids (id 0 is
a tombstone, as in the reference); the device keeps [n_pad] int64 bit
patterns and an [n_pad] bool validity mask, padded to ``_bucket`` rows.
Two kernels carry the search (ops/count_below.py, ops/hamming_topk.py):

- ``search``: for Q > 64 needles on a store of > 4096 rows, a count gate
  (K1) keeps only needles with ``min_hits`` hits; then the exact top-k
  (K4) for those;
- ``search_self``: the N^2 self-search counts the upper triangle of tiles
  (K1, and K2 on the diagonal tiles), then runs the top-k only for rows
  with a later-row hit and mirrors their hits to the rows they matched.

The top-k is exact with ties ordered by store row, so the verify step of
the reference (count phase vs list lengths) is kept as a check that
should never rescan; ``rescanned`` reports how many rows it rescanned.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..device import resolve
from .count_below import count_below, self_tile
from .dct_hash import combine_u32, split_u64
from .hamming_topk import hamming_topk

# shared read-only "no hits" result tuple
_EMPTY = (np.zeros(0, np.uint32), np.zeros(0, np.int32))


def from_packed(pairs: np.ndarray, valid: np.ndarray,
                device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX store device layout ([N, 2] uint32 (lo, hi) + [N] validity) ->
    the port's (int64 [N], bool [N]) tensors."""
    h = combine_u32(pairs).view(np.int64)
    dev = resolve(device)
    return (torch.from_numpy(h.copy()).to(dev),
            torch.from_numpy(np.asarray(valid, dtype=bool).copy()).to(dev))


def to_packed(hashes: torch.Tensor,
              valid: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of ``from_packed``: -> ([N, 2] uint32, [N] bool) numpy."""
    h = hashes.cpu().numpy().view(np.uint64)
    return split_u64(h), valid.cpu().numpy().astype(bool)


def _bucket(n: int, minimum: int = 1024, chunk: int = 1 << 21) -> int:
    """Device-array bucket size: powers of two for small stores, chunk
    multiples beyond one chunk (power-of-two padding would scan up to 2x
    dead rows at 10M+ items).  Every self-search tile shape divides it."""
    if n > chunk:
        return -(-n // chunk) * chunk
    b = minimum
    while b < n:
        b *= 2
    return b


class PackedHashStore:
    """Device-resident packed hash index with tombstone removal: add()
    appends, remove() tombstones in place, slice() builds a subset copy
    (the Index contract)."""

    def __init__(self, hashes: np.ndarray | None = None,
                 ids: np.ndarray | None = None, device=None):
        self.device = resolve(device)
        self._hashes = np.zeros(0, dtype=np.uint64)
        self._ids = np.zeros(0, dtype=np.uint32)
        self._dev = None  # (hashes [n_pad] int64, valid [n_pad] bool)
        self._id_rows = None  # (sorted_ids, rows_sorted) id->row cache
        self._fp: str | None = None
        self.rescanned = 0  # rows the last search_self's verify rescanned
        if hashes is not None and len(hashes):
            self._hashes = np.asarray(hashes, dtype=np.uint64).copy()
            self._ids = np.asarray(ids, dtype=np.uint32).copy()

    def __len__(self) -> int:
        return len(self._hashes)

    @property
    def ids(self) -> np.ndarray:
        return self._ids

    @property
    def hashes(self) -> np.ndarray:
        return self._hashes

    def memory_usage(self) -> int:
        return self._hashes.nbytes + self._ids.nbytes

    def _invalidate(self) -> None:
        self._dev = None
        self._id_rows = None
        self._fp = None

    def add(self, hashes: np.ndarray, ids: np.ndarray) -> None:
        if len(hashes) == 0:
            return
        self._hashes = np.concatenate(
            [self._hashes, np.asarray(hashes, dtype=np.uint64)])
        self._ids = np.concatenate([self._ids, np.asarray(ids, dtype=np.uint32)])
        self._invalidate()

    def remove(self, ids) -> None:
        """Tombstone by media id (reference zeroes id+hash, keeps the slot)."""
        if len(self._ids) == 0:
            return
        kill = np.isin(self._ids, np.asarray(list(ids), dtype=np.uint32))
        if kill.any():
            self._ids[kill] = 0
            self._hashes[kill] = 0
            self._invalidate()

    def slice(self, media_ids) -> "PackedHashStore":
        keep = np.isin(self._ids, np.asarray(list(media_ids), dtype=np.uint32))
        keep &= self._ids != 0
        return PackedHashStore(self._hashes[keep], self._ids[keep],
                               device=self.device)

    def fingerprint(self) -> str:
        """Content fingerprint of the store (hashes + ids), cached until
        the next add/remove."""
        if self._fp is None:
            h = hashlib.blake2b(digest_size=16)
            h.update(np.int64(len(self._hashes)).tobytes())
            h.update(self._hashes.tobytes())
            h.update(self._ids.tobytes())
            self._fp = h.hexdigest()
        return self._fp

    def _device_arrays(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._dev is None:
            n = len(self._hashes)
            b = _bucket(max(n, 1))
            hashes = np.zeros(b, dtype=np.int64)
            valid = np.zeros(b, dtype=bool)
            hashes[:n] = self._hashes.view(np.int64)
            valid[:n] = self._ids != 0
            self._dev = (torch.from_numpy(hashes).to(self.device),
                         torch.from_numpy(valid).to(self.device))
        return self._dev

    def _needles(self, needle_hashes: np.ndarray) -> torch.Tensor:
        h = np.ascontiguousarray(needle_hashes, dtype=np.uint64).view(np.int64)
        return torch.from_numpy(h).to(self.device)

    @staticmethod
    def _topk_call(needles: torch.Tensor, hashes_dev, valid_dev, k: int,
                   threshold: int, rescan: bool = False):
        """Exact top-k below ``threshold``; ``rescan`` marks the verify
        step's rescans (the kernel is exact either way)."""
        return hamming_topk(needles, hashes_dev, valid_dev, k, threshold)

    def search(self, needle_hashes: np.ndarray, threshold: int, k: int = 64,
               needle_batch: int = 1024, min_hits: int = 1):
        """Batched threshold search.

        @param needle_hashes [Q] uint64
        @param min_hits skip needles with fewer than this many raw hits —
               pass 2 for self-search (indexed needles hit themselves)
        @return list (len Q) of (ids [m] uint32, dists [m] int32) with
                dist < threshold, ascending by (distance, store row),
                capped at k
        """
        q_total = len(needle_hashes)
        if q_total == 0 or len(self._hashes) == 0:
            return [_EMPTY] * q_total
        hashes_dev, valid_dev = self._device_arrays()
        k = min(k, len(self._hashes))
        needles = self._needles(needle_hashes)
        results: list = [_EMPTY] * q_total

        hot = np.arange(q_total)
        if len(self._hashes) > 4096 and q_total > 64:
            # count gate: only needles with min_hits hits reach the top-k
            counts = count_below(needles, hashes_dev, valid_dev,
                                 threshold).cpu().numpy()
            hot = np.nonzero(counts >= min_hits)[0]
            if len(hot) == 0:
                return results
        return self._topk_phase(needles, hot, results, hashes_dev, valid_dev,
                                threshold, k, needle_batch)

    def search_self(self, threshold: int, k: int = 64,
                    needle_batch: int = 1024, rows: int = 0,
                    cols: int = 0, min_n: int = 1 << 16,
                    sparse: bool = False):
        """N^2 self-search, equivalent to ``search(self.hashes, threshold,
        k, min_hits=2)`` but counting only the upper triangle of the
        symmetric distance matrix.  Needles whose duplicates are all
        earlier rows are never row-hot; their results are mirrored out of
        the hot needles' lists (every (i, j) hit has a hot i).

        @param sparse return {row: (ids, dists)} holding only rows with
               hits instead of a dense N-list"""
        n = len(self._hashes)
        self.rescanned = 0
        if n == 0:
            return {} if sparse else []
        if n <= min_n:
            # small stores are count-phase-cheap: plain two-phase path
            dense = self.search(self._hashes, threshold, k, min_hits=2)
            if sparse:
                return {r: v for r, v in enumerate(dense) if len(v[0])}
            return dense
        hashes_dev, valid_dev = self._device_arrays()
        n_pad = hashes_dev.numel()
        if not rows:
            rows = 16384 if n_pad <= 1 << 20 else 32768
        if not cols:
            cols = 1 << 16 if n_pad <= 1 << 20 else 1 << 17
        rows = min(rows, n_pad)
        cols = min(cols, n_pad)
        if n_pad % rows or n_pad % cols:
            raise ValueError(f"tiles {rows}x{cols} must divide {n_pad}")
        k = min(k, n)
        # hot = store rows with >= 1 neighbour at a LATER row; hot_counts =
        # their exact later-row hit counts (the verify invariant below)
        counts = self._classic_self_counts(hashes_dev, valid_dev, threshold,
                                           n_pad, rows, cols)
        hot = np.nonzero(counts >= 1)[0]
        hot_counts = counts[hot]
        results: dict = {}
        if len(hot) == 0:
            return self._self_result(results, n, sparse)
        needles = hashes_dev  # the store rows are the needles
        self._topk_phase(needles, hot, results, hashes_dev, valid_dev,
                         threshold, k, needle_batch)
        # Saturation escalation: a hot needle whose list filled to k may
        # have truncated hits, and a dropped (i, j) pair would make the
        # mirror below lose j's only match.  Rescan saturated needles with
        # growing k until every hot list is complete.
        kk = k
        sat = [i for i in hot if len(results.get(i, _EMPTY)[0]) >= kk]
        pathological = False
        while sat and kk < n:
            kk = min(kk * 4, n, 1 << 16)
            self._topk_phase(needles, np.asarray(sat), results, hashes_dev,
                             valid_dev, threshold, kk, needle_batch)
            sat = [i for i in sat if len(results.get(i, _EMPTY)[0]) >= kk]
            if sat and kk >= 1 << 16:
                pathological = True  # >65536-member duplicate cluster
                break
        if not pathological:
            # Invariant: the count phase is exact, so hot_counts[i] is the
            # true number of later-row hits of hot needle i.  The top-k is
            # exact too, so this should never rescan; it guards the mirror
            # (a missing (i, j) pair would lose j's only match).
            bad_ix = np.nonzero(
                self._later_row_hits(hot, results) < hot_counts)[0]
            kk2 = kk
            while len(bad_ix):
                bad = hot[bad_ix]
                self.rescanned += len(bad)
                self._topk_phase(needles, bad, results, hashes_dev,
                                 valid_dev, threshold, kk2, needle_batch,
                                 rescan=True)
                bad_ix = bad_ix[self._later_row_hits(bad, results)
                                < hot_counts[bad_ix]]
                if not len(bad_ix) or kk2 >= min(n, 1 << 16):
                    break  # still short: list capped at kk2
                kk2 = min(kk2 * 4, n, 1 << 16)
        mirrored_rows = []
        if pathological:
            # complete source lists are off the table — run the plain
            # two-phase search for every row the triangle never scanned
            cold = np.setdiff1d(np.arange(n, dtype=np.int64), hot)
            for r, res in zip(cold, self.search(
                    self._hashes[cold], threshold, k=k, min_hits=2)):
                ids, ds = res
                if (len(ids) == 1 and ids[0] == self._ids[r]
                        and ds[0] == 0):  # lone self-hit is not a duplicate
                    continue
                if len(ids):
                    results[r] = res
        else:
            mirrored_rows = self._mirror_self_matches(results, hot, k)
        for i in hot:  # restore the caller's k cap after escalation
            ids, ds = results.get(i, _EMPTY)
            if len(ids) > k:
                results[i] = (ids[:k], ds[:k])
        overflow = [r for r in mirrored_rows
                    if len(results.get(r, _EMPTY)[0]) >= k]
        if overflow:
            # mirrored >= k hits: the mirror may have truncated differently
            # than the needle's own top-k would — rescan those rows
            self._topk_phase(needles, np.asarray(overflow), results,
                             hashes_dev, valid_dev, threshold, k,
                             needle_batch)
        return self._self_result(results, n, sparse)

    @staticmethod
    def _self_result(results: dict, n: int, sparse: bool):
        """Sparse dict -> caller format: drop empty rows (sparse) or expand
        to the dense N-list."""
        if sparse:
            return {r: v for r, v in results.items() if len(v[0])}
        dense = [_EMPTY] * n
        for r, v in results.items():
            dense[r] = v
        return dense

    def _classic_self_counts(self, hashes_dev, valid_dev, threshold, n_pad,
                             rows, cols) -> np.ndarray:
        """Triangular tiled count phase: every tile on or above the block
        diagonal, the diagonal-straddling ones masked to column > row."""
        n = len(self._hashes)
        parts = []
        for rb in range(0, n_pad, rows):
            acc = torch.zeros(rows, dtype=torch.int32, device=self.device)
            for cb in range(0, n_pad, cols):
                if cb + cols <= rb:
                    continue  # tile entirely below the diagonal
                acc = self_tile(acc, hashes_dev, valid_dev, threshold, rb, cb,
                                rows, cols, masked=cb < rb + rows)
            parts.append(acc)
        return torch.cat(parts).cpu().numpy()[:n]

    def _later_row_hits(self, needle_rows, results):
        """Per needle row i: #{entries of results[i] whose store row is > i}."""
        out = np.zeros(len(needle_rows), np.int64)
        sorted_ids, rows_sorted = self._sorted_id_rows()
        if not len(sorted_ids):
            return out.astype(np.int32)
        src_parts, id_parts = [], []
        for j, i in enumerate(needle_rows):
            ids = results.get(i, _EMPTY)[0]
            if len(ids):
                src_parts.append(np.full(len(ids), j, np.int64))
                id_parts.append(ids)
        if not src_parts:
            return out.astype(np.int32)
        src = np.concatenate(src_parts)
        ids = np.concatenate(id_parts)
        pos = np.clip(np.searchsorted(sorted_ids, ids),
                      0, len(sorted_ids) - 1)
        tgt = rows_sorted[pos]
        good = (sorted_ids[pos] == ids) & \
            (tgt > np.asarray(needle_rows, np.int64)[src])
        np.add.at(out, src[good], 1)
        return out.astype(np.int32)

    def _sorted_id_rows(self):
        """(sorted_ids, rows_sorted) for vectorized id->store-row lookups,
        cached until the next add/remove."""
        if self._id_rows is None:
            valid_rows = np.nonzero(self._ids)[0]
            order = np.argsort(self._ids[valid_rows])
            self._id_rows = (self._ids[valid_rows][order],
                             valid_rows[order])
        return self._id_rows

    def _mirror_self_matches(self, results, hot, k):
        """Self-search completion: for every hit (i, j) of a row-hot needle
        i, add the symmetric (j, i) hit to j's results if j was not scanned
        itself (store ids are unique).  Mirrored lists gain the target's own
        self-match (distance 0) and are ordered like a scan: ascending
        distance, ties by store row.
        @return list of target rows that received mirrored results"""
        src_parts, id_parts, d_parts = [], [], []
        for i in hot:
            ids, dists = results.get(i, _EMPTY)
            if len(ids):
                src_parts.append(np.full(len(ids), i, np.int64))
                id_parts.append(ids)
                d_parts.append(dists)
        if not src_parts:
            return []
        src = np.concatenate(src_parts)
        hit_ids = np.concatenate(id_parts)
        d = np.concatenate(d_parts)
        sorted_ids, rows_sorted = self._sorted_id_rows()
        pos = np.clip(np.searchsorted(sorted_ids, hit_ids),
                      0, max(len(sorted_ids) - 1, 0))
        tgt = rows_sorted[pos]
        hot_mask = np.zeros(len(self._ids), bool)
        hot_mask[hot] = True
        keep = ((sorted_ids[pos] == hit_ids) & (tgt != src) & ~hot_mask[tgt])
        sel = np.nonzero(keep)[0]
        if not len(sel):
            return []
        tgt, d, src = tgt[sel], d[sel], src[sel]
        by_tgt = np.lexsort((src, d, tgt))
        tgt, d, src = tgt[by_tgt], d[by_tgt], src[by_tgt]
        starts = np.nonzero(np.r_[True, tgt[1:] != tgt[:-1]])[0]
        bounds = np.r_[starts[1:], len(tgt)]
        filled = []
        for s0, s1 in zip(starts, bounds):
            r = int(tgt[s0])
            ds = np.r_[np.int32(0), d[s0:s1]]       # own self-match first
            rows = np.r_[np.int64(r), src[s0:s1]]
            o = np.lexsort((rows, ds))[:k]
            results[r] = (self._ids[rows[o]].astype(np.uint32),
                          ds[o].astype(np.int32))
            filled.append(r)
        return filled

    def _topk_phase(self, needles: torch.Tensor, hot, results, hashes_dev,
                    valid_dev, threshold, k, needle_batch, rescan=False):
        """Top-k for the needles (rows of ``needles``) that passed the
        count gate; fills and returns ``results`` with ids/dists below the
        threshold, ascending by (distance, store row) — the kernel's order."""
        hot_dev = torch.as_tensor(np.asarray(hot, np.int64), device=self.device)
        for s in range(0, len(hot), needle_batch):
            sel = hot[s:s + needle_batch]
            d, i = self._topk_call(needles[hot_dev[s:s + needle_batch]],
                                   hashes_dev, valid_dev, k, threshold,
                                   rescan)
            d, i = d.cpu().numpy(), i.cpu().numpy()
            hit = d < threshold
            r_idx, c_idx = np.nonzero(hit)
            if len(r_idx) == 0:
                continue
            ids_flat = self._ids[i[r_idx, c_idx]]
            d_flat = d[r_idx, c_idx]
            uniq, starts = np.unique(r_idx, return_index=True)
            bounds = np.append(starts[1:], len(r_idx))
            for u, s0, s1 in zip(uniq, starts, bounds):
                results[sel[u]] = (ids_flat[s0:s1], d_flat[s0:s1])
        return results
