"""Exact per-needle k nearest 256-bit rows: CUDA kernel K5 and its plain
twin.

``hamming_lanes_topk`` replaces ``cbird_tpu/ops/hamming.py``
``hamming_lanes_topk`` (XLA: ``_chunk_dists_lanes`` and ``approx_min_k``
over 16k-row chunks), the k-nearest search of the orb index over 256-bit
ORB descriptors.  Torch has neither a popcount nor ``approx_min_k``.  The
kernel is ``csrc/hamming_lanes_topk.cu``: its distances come from a +-1
product over K = 256 on the tensor cores (``wgmma``), and a per-needle
admission limit in the epilogue keeps the top-k work off the common path;
its header says what bounds it on an H100 and how the design answers that.
``hamming_lanes_topk_popc`` launches the same source's popcount form, the
yardstick, which nothing but ``chip_smoke.py``'s checks call.

Contract: for each needle, the ``k`` valid rows with the smallest
(distance, row) key among rows at distance < ``bound``, ascending.  A row
is four int64 words (256 bits; distances 0..256).  Empty slots hold
distance ``BAD_DIST`` and row -1.  Keys are unique, so the result is exact
and ties go to the lower row.  With the default bound (257) this is the
JAX function's contract, exact where the TPU's ``approx_min_k`` has a
recall of 0.99 above 16384 rows; the orb index passes its vote threshold
(``cvThresh``) as the bound, which keeps every vote: the k nearest among
rows at d < c are the k nearest rows filtered to d < c.

On a CPU tensor both wrappers run ``hamming_lanes_topk_plain``; on any
other device each launches its kernel or raises: neither falls back to the
other or to the plain twin.  ``hamming_lanes_topk.launches`` and
``hamming_lanes_topk_popc.launches`` count the calls that launched each.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..device import launch_on, one_device
from .count_below import chunk_cols, popcount64

BAD_DIST = 0x7FFF
WORDS = 4  # int64 words a row
BINS = 257  # distances 0..256: the bound that keeps every row
MAX_K = 10  # the kernel's largest list: the orb index's k
# an empty slot: sorts after every (distance << 32 | row) key and unpacks
# to (BAD_DIST, row -1)
_NONE = (BAD_DIST << 32) | 0xFFFFFFFF


def _finish(keys: torch.Tensor):
    """[Q, k] sorted keys (``_NONE`` = empty) -> (dists, rows) int32."""
    return (keys >> 32).to(torch.int32), keys.to(torch.int32)


def lane_dists(needles: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """[Q, 4] x [C, 4] int64 -> [Q, C] int64 Hamming distances."""
    d = popcount64(needles[:, None, 0] ^ rows[None, :, 0])
    for w in range(1, WORDS):
        d = d + popcount64(needles[:, None, w] ^ rows[None, :, w])
    return d


def hamming_lanes_topk_plain(needles: torch.Tensor, hay: torch.Tensor,
                             valid: torch.Tensor, k: int,
                             bound: int = BINS):
    """Plain PyTorch version (same contract): the haystack in chunks, a
    running top-k of unique (distance << 32 | row) keys.
    @return (dists [Q, k] int32, rows [Q, k] int32)"""
    q, n = needles.shape[0], hay.shape[0]
    dev = needles.device
    best = torch.full((q, k), _NONE, dtype=torch.int64, device=dev)
    if q == 0 or n == 0 or k == 0:
        return _finish(best)
    chunk = max(1024, chunk_cols(q, dev) // WORDS)
    for c0 in range(0, n, chunk):
        h = hay[c0:c0 + chunk]
        d = lane_dists(needles, h)
        ok = valid[None, c0:c0 + chunk] & (d < bound)
        rows = torch.arange(c0, c0 + h.shape[0], device=dev)
        key = torch.where(ok, (d << 32) | rows[None, :], _NONE)
        best = torch.topk(torch.cat([best, key], dim=1), k, dim=1,
                          largest=False, sorted=True).values
    return _finish(best)


def check_operands(needles: torch.Tensor, hay: torch.Tensor,
                   valid: torch.Tensor) -> None:
    """Shapes, types, devices and contiguity the kernel accepts."""
    if needles.dtype != torch.int64 or hay.dtype != torch.int64:
        raise TypeError("rows must be int64 words")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    if needles.dim() != 2 or needles.shape[1] != WORDS or hay.dim() != 2 \
            or hay.shape[1] != WORDS or valid.shape != hay.shape[:1]:
        raise ValueError(f"bad shapes {tuple(needles.shape)} "
                         f"{tuple(hay.shape)} {tuple(valid.shape)}")
    if not (needles.device == hay.device == valid.device):
        raise ValueError("operands on different devices")
    if not (needles.is_contiguous() and hay.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("operands must be contiguous")
    if hay.shape[0] >= 1 << 31:
        raise ValueError("at most 2^31 - 1 rows")


_VP, _INT = ctypes.c_void_p, ctypes.c_int
# cbird_lanes_topk (tensor cores): ..., bound, xc, chunk, scratch, ...;
# cbird_lanes_topk_popc: ..., bound, splits, scratch, ...
_ARGS = [_VP, _INT, _VP, _VP, _INT, _INT, _INT, _INT, _INT, _VP, _VP, _VP,
         _VP]
_POPC_ARGS = [_VP, _INT, _VP, _VP, _INT, _INT, _INT, _INT, _VP, _VP, _VP,
              _VP]
# the tensor-core form's tiles (csrc/hamming_lanes_topk.cu): units of BQ
# needles x a chunk of whole steps of SUB columns; a chunk holds at most
# MAX_CHUNK columns (a list key keeps 23 bits of column offset)
BQ, SUB, MAX_CHUNK = 192, 256, 1 << 23
UNIT_COST = 2  # a unit's fixed cost in steps (its A tiles, lists, merge)


def list_size(k: int) -> int:
    """Keys the kernels keep a needle and split: the smaller of their
    list sizes (1, MAX_K) that holds k."""
    return 1 if k <= 1 else MAX_K


def _load():
    lib = _build.load_kernel("hamming_lanes_topk", "cbird_lanes_topk",
                             _ARGS)
    lib.cbird_lanes_topk_popc.argtypes = _POPC_ARGS
    lib.cbird_lanes_topk_popc.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1024)
def tc_plan(q: int, n: int, sms: int) -> tuple[int, int]:
    """The tensor-core form's column chunks: (xc, chunk columns).  Units of
    BQ needles x a chunk; one block a multiprocessor walks every sms-th
    unit.  The chunk minimises the slowest multiprocessor's steps, each unit
    costing UNIT_COST steps more, over at most 16 units a multiprocessor;
    so a call with few needles splits its columns.  (0, 0) for no rows."""
    steps = -(-n // SUB)
    if steps == 0:
        return 0, 0
    ytiles = -(-q // BQ)
    best_ch, best_cost = None, None
    for xc in range(-(-steps // (MAX_CHUNK // SUB)), steps + 1):
        ch = -(-steps // xc)
        if -(-steps // ch) != xc:
            continue  # the same chunk as a smaller xc
        units = ytiles * xc
        if best_ch is not None and units > 16 * sms:
            break
        cost = -(-units // sms) * (ch + UNIT_COST)
        if best_cost is None or cost < best_cost:
            best_ch, best_cost = ch, cost
    return -(-steps // best_ch), best_ch * SUB


def splits_for(q: int, n: int, sms: int) -> int:
    """Haystack splits of one popcount-form launch: enough blocks of 128
    needles for about eight a multiprocessor, each split at least 1024
    rows."""
    blocks = -(-q // 128)
    return max(1, min(-(-8 * sms // blocks), -(-n // 1024), 65535))


def _prepare(needles, hay, valid, k, what):
    """The launch's checked operands and outputs.
    @return (lib, q, n, dists, rows, sms)"""
    lib = _load()
    check_operands(needles, hay, valid)
    if needles.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {needles.device}")
    if k > MAX_K:
        raise ValueError(f"k = {k} is above the kernel's {MAX_K}")
    q, n = needles.shape[0], hay.shape[0]
    dev = needles.device
    dists = torch.empty((q, k), dtype=torch.int32, device=dev)
    rows = torch.empty((q, k), dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return lib, q, n, dists, rows, sms


def hamming_lanes_topk(needles: torch.Tensor, hay: torch.Tensor,
                       valid: torch.Tensor, k: int, bound: int = BINS):
    """Exact k nearest valid rows at distance < ``bound`` per needle, on
    the tensor cores.

    @param needles [Q, 4] int64, hay [T, 4] int64, valid [T] bool
    @return (dists [Q, k] int32 ascending, rows [Q, k] int32)
    """
    k, bound = int(k), max(0, min(int(bound), BINS))
    dev = one_device("hamming_lanes_topk", needles, hay, valid)
    if dev.type == "cpu":
        return hamming_lanes_topk_plain(needles, hay, valid, k, bound)
    lib, q, n, dists, rows, sms = _prepare(needles, hay, valid, k,
                                           "hamming_lanes_topk")
    if q == 0 or k == 0:
        return dists, rows
    xc, chunk = tc_plan(q, n, sms)
    scratch = torch.empty(max(xc, 1) * list_size(k) * q, dtype=torch.int64,
                          device=dev)
    with launch_on(dev):
        _build.check(lib, lib.cbird_lanes_topk(
            needles.data_ptr(), q, hay.data_ptr(), valid.data_ptr(), n, k,
            bound, xc, chunk, scratch.data_ptr(), dists.data_ptr(),
            rows.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
            "lanes_topk")
    hamming_lanes_topk.launches += 1
    return dists, rows


hamming_lanes_topk.launches = 0


def hamming_lanes_topk_popc(needles: torch.Tensor, hay: torch.Tensor,
                            valid: torch.Tensor, k: int, bound: int = BINS):
    """The same by the kernel's popcount form (the yardstick)."""
    k, bound = int(k), max(0, min(int(bound), BINS))
    dev = one_device("hamming_lanes_topk_popc", needles, hay, valid)
    if dev.type == "cpu":
        return hamming_lanes_topk_plain(needles, hay, valid, k, bound)
    lib, q, n, dists, rows, sms = _prepare(needles, hay, valid, k,
                                           "hamming_lanes_topk_popc")
    if q == 0 or k == 0:
        return dists, rows
    splits = splits_for(q, n, sms)
    scratch = torch.empty(splits * list_size(k) * q, dtype=torch.int64,
                          device=dev)
    with launch_on(dev):
        _build.check(lib, lib.cbird_lanes_topk_popc(
            needles.data_ptr(), q, hay.data_ptr(), valid.data_ptr(), n, k,
            bound, splits, scratch.data_ptr(), dists.data_ptr(),
            rows.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
            "lanes_topk_popc")
    hamming_lanes_topk_popc.launches += 1
    return dists, rows


hamming_lanes_topk_popc.launches = 0
