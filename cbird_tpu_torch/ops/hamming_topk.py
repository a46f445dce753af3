"""Exact per-needle Hamming top-k: CUDA kernel K4 and its plain twin.

``hamming_topk`` replaces ``cbird_tpu/ops/pallas_hamming.py``
``hamming_topk_pallas`` and, on the main path, the role of
``cbird_tpu/ops/hamming.py`` ``hamming_topk`` (XLA ``approx_min_k``):
torch has neither that operator nor a popcount.  The kernel is
``csrc/hamming_topk.cu`` (``topk_scan``); its header says what bounds it
on an H100 and how the design answers that.

Contract: for each needle, the ``k`` valid haystack rows with the smallest
(distance, row) among rows at distance < ``bound``, ascending; empty slots
hold distance ``BAD_DIST`` and row -1.  Keys are unique, so the result is
exact and ties go to the lower store row.  ``k`` is not bounded.

On a CUDA tensor the work is ``topk_passes`` around the kernel: one scan
appends every hit's key to its needle's ``capacity(k, n)`` slots and
counts the hits; a sort of each needle's slots; one read of the cursors
and histograms to the host; a second scan, cut at each needle's k-th
distance, for the needles whose hits overflowed their slots.
``topk_scan_plain`` is that scan in plain PyTorch, so the steps around
the kernel run on the CPU too (the tests).

On a CPU tensor ``hamming_topk`` runs ``hamming_topk_plain``; on any other
device it launches the kernel or raises.  ``hamming_topk.launches``
counts wrapper calls that launched the kernel, ``hamming_topk.overflowed``
the needles that took the second pass.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .count_below import check_operands, chunk_cols, popcount64

BAD_DIST = 0x7FFF
BINS = 65  # distances 0..64
WARP = 32
# upper bound on key slots per scan launch (8 B each, plus the sort's
# scratch); a single needle may exceed it, bounded by the store size
MAX_KEYS = 1 << 26
# an empty slot: sorts after every (distance << 32 | row) key (distance
# <= 64, row < 2^31) and unpacks to (BAD_DIST, row -1)
_NONE = (BAD_DIST << 32) | 0xFFFFFFFF


def _finish(keys: torch.Tensor, k: int):
    """[Q, k] sorted keys (``_NONE`` = empty) -> (dists, rows) int32 (the
    cast keeps a key's low word)."""
    return (keys >> 32).to(torch.int32), keys.to(torch.int32)


def hamming_topk_plain(needles: torch.Tensor, hay: torch.Tensor,
                       valid: torch.Tensor, k: int, bound: int = BINS):
    """Plain PyTorch version (same contract): the haystack in
    ``chunk_cols`` steps, a running top-k of unique (distance << 32 | row)
    keys.
    @return (dists [Q, k] int32, rows [Q, k] int32)"""
    q, n = needles.numel(), hay.numel()
    dev = needles.device
    best = torch.full((q, k), _NONE, dtype=torch.int64, device=dev)
    if q == 0 or n == 0 or k == 0:
        return _finish(best, k)
    chunk = chunk_cols(q, dev)
    for c0 in range(0, n, chunk):
        h = hay[c0:c0 + chunk]
        d = popcount64(needles[:, None] ^ h[None, :])
        ok = valid[None, c0:c0 + chunk] & (d < bound)
        rows = torch.arange(c0, c0 + h.numel(), device=dev)
        key = torch.where(ok, (d << 32) | rows[None, :], _NONE)
        best = torch.topk(torch.cat([best, key], dim=1), k, dim=1,
                          largest=False, sorted=True).values
    return _finish(best, k)


def capacity(k: int, n: int) -> int:
    """Key slots per needle in the first scan: k, at most the haystack's
    n (no needle has more hits), rounded up to a warp multiple."""
    return -(-min(k, n) // WARP) * WARP


def topk_scan_plain(needles: torch.Tensor, hay: torch.Tensor,
                    valid: torch.Tensor, bound: int, rows, hist, cut,
                    c_all: int, cursor: torch.Tensor, keys: torch.Tensor):
    """Plain PyTorch version of one ``topk_scan`` pass, with the kernel's
    outputs: needle i is needles[rows[i]] (``rows`` None: needles[i]);
    every slot of ``keys`` is first emptied (``_NONE``), then needle i's
    hits (distance below min(bound, cut[i] + 1), or bound when ``cut`` is
    None) go to its slots keys[i * c_all, + c_all) while they last;
    ``cursor`` [Q] int32 counts every hit; ``hist`` [Q, 65] int32 (None:
    not kept) counts them by distance.  Keys land in another order than
    the kernel's (haystack chunks last to first): the order of a needle's
    slots is free."""
    if rows is not None:
        needles = needles[rows]
    q, n = needles.numel(), hay.numel()
    dev = needles.device
    keys.fill_(_NONE)
    cursor.zero_()
    if hist is not None:
        hist.zero_()
    lim = torch.full((q,), bound, dtype=torch.int64, device=dev)
    if cut is not None:
        lim = (cut.long() + 1).clamp(max=bound)
    chunk = chunk_cols(q, dev)
    for c0 in reversed(range(0, n, chunk)):
        h = hay[c0:c0 + chunk]
        d = popcount64(needles[:, None] ^ h[None, :])
        hit = valid[None, c0:c0 + chunk] & (d < lim[:, None])
        i, j = torch.nonzero(hit, as_tuple=True)  # by needle, then row
        dd = d[i, j]
        if hist is not None:
            hist.index_put_((i, dd), torch.ones_like(i, dtype=torch.int32),
                            accumulate=True)
        cnt = torch.bincount(i, minlength=q)
        slot = cursor[i].long() + torch.arange(i.numel(), device=dev) \
            - (torch.cumsum(cnt, 0) - cnt)[i]
        ok = slot < c_all
        keys[i[ok] * c_all + slot[ok]] = (dd[ok] << 32) | (c0 + j[ok])
        cursor += cnt.to(torch.int32)


def cut_sizes(hist: np.ndarray, k: int):
    """Per needle, from its exact distance histogram [Q, 65]: the cut, the
    smallest d with >= k hits at <= d (64: take all), and the hits at <=
    the cut (what the cut pass collects; the sort keeps the first k).
    @return (cut [Q] int32, size [Q] int64)"""
    cum = np.cumsum(hist, axis=1, dtype=np.int64)
    cut = (cum[:, :BINS - 1] < k).sum(axis=1)
    return cut.astype(np.int32), cum[np.arange(len(cum)), cut]


def topk_passes(scan, needles: torch.Tensor, n: int, k: int,
                max_keys: int = MAX_KEYS):
    """The top-k around a scan (the kernel, or ``topk_scan_plain`` bound to
    the haystack): ``scan(needles, rows, hist, cut, c_all, cursor, keys)``
    as ``topk_scan_plain`` takes them after ``bound``, which also sets each
    output's first value.  The first pass gives every needle ``capacity(k,
    n)`` slots and keeps the histogram, and each needle's sorted slots are
    its answer; one read of the cursors and histograms finds the needles
    whose hits overflowed and their cuts; those take the cut pass, with as
    many slots as the most hits at or below any of their cuts, and its
    sorted slots replace their answers.  Launches hold at most
    ``max_keys`` slots, or one needle's.
    @return (keys [Q, k] int64 ascending, ``_NONE`` = empty; the number of
            needles that took the second pass)"""
    q, dev = needles.numel(), needles.device
    if q == 0 or n == 0 or k == 0:
        return torch.full((q, k), _NONE, dtype=torch.int64, device=dev), 0
    c = capacity(k, n)
    counts = torch.empty(q * (BINS + 1), dtype=torch.int32, device=dev)
    hist, cursor = counts[:q * BINS].view(q, BINS), counts[q * BINS:]
    step = max(1, max_keys // c)
    parts = []
    for s0 in range(0, q, step):
        s1 = min(q, s0 + step)
        keys = torch.empty((s1 - s0) * c, dtype=torch.int64, device=dev)
        scan(needles[s0:s1], None, hist[s0:s1], None, c, cursor[s0:s1],
             keys)
        parts.append(keys.view(s1 - s0, c).sort(dim=1).values)
    out = parts[0] if len(parts) == 1 else torch.cat(parts)
    if c < k:  # k > n: the slots past the haystack stay empty
        out = torch.nn.functional.pad(out, (0, k - c), value=_NONE)
    out = out[:, :k]
    # the one read between the passes; an overflowed needle's slots hold an
    # arbitrary subset of its hits, its row of out is written again below
    counts = counts.cpu().numpy()
    over = np.nonzero(counts[q * BINS:] > c)[0]
    if len(over):
        cut, size = cut_sizes(counts[:q * BINS].reshape(q, BINS)[over], k)
        width = capacity(int(size.max()), n)
        step = max(1, max_keys // width)
        ov = torch.from_numpy(over).to(dev)
        cut = torch.from_numpy(cut).to(dev)
        for a0 in range(0, len(over), step):
            rows = ov[a0:a0 + step]
            keys = torch.empty(rows.numel() * width, dtype=torch.int64,
                               device=dev)
            cur = torch.empty(rows.numel(), dtype=torch.int32, device=dev)
            scan(needles, rows, None, cut[a0:a0 + step], width, cur, keys)
            out[rows] = keys.view(-1, width).sort(dim=1).values[:, :k]
    return out, len(over)


_VP, _INT = ctypes.c_void_p, ctypes.c_int
_SCAN_ARGS = [_VP, _VP, _INT, _VP, _VP, _INT, _INT, _VP, _VP,
              ctypes.c_longlong, _VP, _VP, _VP]


def _load():
    return _build.load_kernel("hamming_topk", "cbird_topk_scan", _SCAN_ARGS)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def hamming_topk(needles: torch.Tensor, hay: torch.Tensor,
                 valid: torch.Tensor, k: int, bound: int = BINS):
    """Exact k nearest valid rows at distance < ``bound`` per needle.

    @param needles [Q] int64, hay [N] int64, valid [N] bool
    @return (dists [Q, k] int32 ascending, rows [Q, k] int32)
    """
    k, bound = int(k), max(0, min(int(bound), BINS))
    if needles.device.type == "cpu":
        return hamming_topk_plain(needles, hay, valid, k, bound)
    lib = _load()
    check_operands(needles, hay, valid)
    if needles.device.type != "cuda":
        raise ValueError(f"hamming_topk needs CUDA tensors, got "
                         f"{needles.device}")
    n = hay.numel()
    stream = torch.cuda.current_stream(needles.device).cuda_stream

    def scan(nd, rows, hist, cut, c_all, cursor, keys):
        _build.check(lib, lib.cbird_topk_scan(
            nd.data_ptr(), _ptr(rows), cursor.numel(), hay.data_ptr(),
            valid.data_ptr(), n, bound, _ptr(hist), _ptr(cut), c_all,
            cursor.data_ptr(), keys.data_ptr(), stream), "topk_scan")
    out, second = topk_passes(scan, needles, n, k)
    if needles.numel() and n and k:
        hamming_topk.launches += 1
    hamming_topk.overflowed += second
    return _finish(out, k)


hamming_topk.launches = 0
hamming_topk.overflowed = 0
