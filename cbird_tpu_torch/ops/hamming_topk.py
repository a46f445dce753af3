"""Exact per-needle Hamming top-k: CUDA kernel K4 and its plain twin.

``hamming_topk`` replaces ``cbird_tpu/ops/pallas_hamming.py``
``hamming_topk_pallas`` and, on the main path, the role of
``cbird_tpu/ops/hamming.py`` ``hamming_topk`` (XLA ``approx_min_k``):
torch has neither that operator nor a popcount.  The kernels are
``csrc/hamming_topk.cu``; its header says what bounds them on an H100 and
how the design answers that.

Contract: for each needle, the ``k`` valid haystack rows with the smallest
(distance, row) among rows at distance < ``bound``, ascending; empty slots
hold distance ``BAD_DIST`` and row -1.  Keys are unique, so the result is
exact and ties go to the lower store row.  ``k`` is not bounded.

On a CPU tensor the wrapper runs ``hamming_topk_plain``; on any other
device it launches the kernels or raises.  ``hamming_topk.launches``
counts wrapper calls that launched the kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .count_below import check_operands, chunk_cols, popcount64

BAD_DIST = 0x7FFF
BINS = 65  # distances 0..64
# upper bound on collected keys per collect launch (8 B each, plus the
# sort's scratch); a single needle may exceed it, bounded by the store size
MAX_KEYS = 1 << 26
# needles per collect launch: the sort key is needle << 40 | distance << 32
# | row (a row < 2^31, a distance < 2^7), so the needle index needs < 2^23
MAX_NEEDLES = 1 << 22
_NONE = 1 << 62  # sorts after every (distance << 32 | row) key


def _finish(keys: torch.Tensor, k: int):
    """[Q, k] sorted keys (``_NONE`` = empty) -> (dists, rows) int32."""
    hit = keys < _NONE
    d = torch.where(hit, keys >> 32, BAD_DIST).to(torch.int32)
    i = torch.where(hit, keys & 0xFFFFFFFF, -1).to(torch.int32)
    return d, i


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


_VP, _INT = ctypes.c_void_p, ctypes.c_int
_HIST_ARGS = [_VP, _INT, _VP, _VP, _INT, _INT, _VP, _VP]
_COLLECT_ARGS = [_VP, _INT, _VP, _VP, _INT, _INT, _VP, _VP, _VP, _VP, _VP]


def _load():
    lib = _build.load_kernel("hamming_topk", "cbird_topk_hist", _HIST_ARGS)
    lib.cbird_topk_collect.argtypes = _COLLECT_ARGS
    lib.cbird_topk_collect.restype = _INT
    return lib


def _groups(sizes: np.ndarray, budget: int, max_needles: int = MAX_NEEDLES):
    """Consecutive ranges of at most ``max_needles`` needles whose key
    counts sum to <= budget (a lone needle may exceed it)."""
    s0, acc = 0, 0
    for i, s in enumerate(sizes.tolist()):
        if i > s0 and (acc + s > budget or i - s0 >= max_needles):
            yield s0, i
            s0, acc = i, 0
        acc += s
    if s0 < len(sizes):
        yield s0, len(sizes)


def hamming_topk(needles: torch.Tensor, hay: torch.Tensor,
                 valid: torch.Tensor, k: int, bound: int = BINS):
    """Exact k nearest valid rows at distance < ``bound`` per needle.

    @param needles [Q] int64, hay [N] int64, valid [N] bool
    @return (dists [Q, k] int32 ascending, rows [Q, k] int32)
    """
    k, bound = int(k), min(int(bound), BINS)
    if needles.device.type == "cpu":
        return hamming_topk_plain(needles, hay, valid, k, bound)
    lib = _load()
    check_operands(needles, hay, valid)
    if needles.device.type != "cuda":
        raise ValueError(f"hamming_topk needs CUDA tensors, got "
                         f"{needles.device}")
    dev = needles.device
    q, n = needles.numel(), hay.numel()
    out = torch.full((q, k), _NONE, dtype=torch.int64, device=dev)
    if q == 0 or n == 0 or k == 0:
        return _finish(out, k)
    stream = torch.cuda.current_stream(dev).cuda_stream
    hist = torch.empty((q, BINS), dtype=torch.int32, device=dev)
    _build.check(lib, lib.cbird_topk_hist(
        needles.data_ptr(), q, hay.data_ptr(), valid.data_ptr(), n, bound,
        hist.data_ptr(), stream), "topk_hist")
    hamming_topk.launches += 1
    # cut distance: the smallest d with >= k rows at <= d (64: take all);
    # every row at <= cut is collected, the sort keeps the first k
    cum = hist.cumsum(dim=1)
    cut = (cum < k).sum(dim=1).clamp(max=BINS - 1)
    size = cum.gather(1, cut[:, None])[:, 0]
    cut = cut.to(torch.int32)
    for s0, s1 in _groups(size.cpu().numpy(), MAX_KEYS):
        sz = size[s0:s1]
        total = int(sz.sum())
        if total == 0:
            continue
        off = torch.cumsum(sz, 0) - sz
        keys = torch.empty(total, dtype=torch.int64, device=dev)
        cursor = torch.empty(s1 - s0, dtype=torch.int32, device=dev)
        _build.check(lib, lib.cbird_topk_collect(
            needles[s0:s1].data_ptr(), s1 - s0, hay.data_ptr(),
            valid.data_ptr(), n, bound, cut[s0:s1].data_ptr(),
            off.data_ptr(), cursor.data_ptr(), keys.data_ptr(), stream),
            "topk_collect")
        seg = torch.repeat_interleave(
            torch.arange(s1 - s0, device=dev), sz, output_size=total)
        skeys = torch.sort((seg << 40) | keys).values
        seg = skeys >> 40
        pos = torch.arange(total, device=dev) - off[seg]
        take = pos < k
        out[s0 + seg[take], pos[take]] = skeys[take] & ((1 << 40) - 1)
    return _finish(out, k)


hamming_topk.launches = 0
