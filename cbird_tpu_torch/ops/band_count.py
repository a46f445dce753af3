"""Pigeonhole band credits: CUDA kernel K3, its plain twin, the checks.

``band_counts`` replaces ``cbird_tpu/ops/pallas_band.py`` ``band_counts``
and ``cbird_tpu/ops/pigeonhole.py`` ``_band_chunk``; ``run_tiles``
replaces ``_run_tile`` / ``_run_contribs`` (one launch for a block's whole
tile list instead of one dispatch per tile pair; the list lies on the
card, ``ops/pigeonhole.py`` ``run_tile_pairs``).  The kernel is
``csrc/band_count.cu``; its header states the contract, what bounds it on
an H100, how the band walks only each row's own equal-key run (it finds
the run edges itself, so the operands are the sorted block's three
arrays) and how the run tiles sum a hit-dense tile's credits.

Operands: one block's sorted order, ``sh`` [n_pad + s] int64 hashes,
``srow`` [n_pad + s] int32 original store rows, ``svalid`` [n_pad + s]
bool; ``masks``: the current block's mask, then the earlier blocks' (at
most 8 int64 bit patterns); ``t`` the threshold; ``s`` the tile size,
which divides n_pad.  The result is the csort vector [n_pad + s] int32.

On a CPU tensor a wrapper runs the plain version; on any other device it
launches the kernel or raises.  ``band_counts.launches`` and
``run_tiles.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from .. import _build
from ..device import launch_on, one_device
from .count_below import popcount64

MAX_MASKS = 8


def check_operands(sh: torch.Tensor, srow: torch.Tensor,
                   svalid: torch.Tensor, masks: Sequence[int], s: int) -> None:
    """Shapes, types, devices and contiguity the kernels accept."""
    if sh.dtype != torch.int64 or srow.dtype != torch.int32:
        raise TypeError("sh must be int64 bit patterns, srow int32")
    if svalid.dtype != torch.bool:
        raise TypeError("svalid must be bool")
    if sh.dim() != 1 or srow.shape != sh.shape or svalid.shape != sh.shape:
        raise ValueError(f"bad shapes {tuple(sh.shape)} {tuple(srow.shape)} "
                         f"{tuple(svalid.shape)}")
    if not (sh.device == srow.device == svalid.device):
        raise ValueError("operands on different devices")
    if not (sh.is_contiguous() and srow.is_contiguous()
            and svalid.is_contiguous()):
        raise ValueError("operands must be contiguous")
    n_pad = sh.numel() - s
    if s < 1 or n_pad < s or n_pad % s:
        raise ValueError(f"tile size {s} must divide n_pad {n_pad}")
    if sh.numel() + s >= 1 << 30:  # positions + one stage stay int32
        raise ValueError("operand too long for int32 indexing")
    if not 1 <= len(masks) <= MAX_MASKS:
        raise ValueError(f"{len(masks)} masks; 1 to {MAX_MASKS} allowed")


def check_tiles(tiles: np.ndarray, n_tot: int, s: int) -> None:
    """Run tiles given on the host: [P, 2] (ta, tb) with tb >= ta + 2,
    inside the order.  (A list on the card is not read back: the kernel
    skips a pair outside the order.)"""
    if tiles.ndim != 2 or tiles.shape[1] != 2:
        raise ValueError(f"tiles must be [P, 2], got {tiles.shape}")
    tiles = tiles.astype(np.int64)
    if len(tiles) and (tiles[:, 0].min() < 0
                       or (tiles[:, 1] < tiles[:, 0] + 2).any()
                       or (int(tiles[:, 1].max()) + 1) * s > n_tot - s):
        raise ValueError("run tiles must satisfy 0 <= ta, ta + 2 <= tb, "
                         "(tb + 1) * s <= n_pad")


def _pair_budget(device: torch.device) -> int:
    """Pairs per step of a plain version: cache-sized on the CPU, bounded
    memory on a card."""
    return 1 << (17 if device.type == "cpu" else 26)


def _credit(out: torch.Tensor, sh: torch.Tensor, srow: torch.Tensor,
            svalid: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
            masks: Sequence[int], t: int, later: bool) -> None:
    """Credit the counted pairs among rows ``p`` [R] x columns ``q`` [R, C]
    (sorted positions) to the smaller original store row's position."""
    x = sh[p][:, None] ^ sh[q]
    hit = (x & masks[0]) == 0
    if later:
        hit &= q > p[:, None]
    for m in masks[1:]:
        hit &= (x & m) != 0
    hit &= svalid[p][:, None] & svalid[q]
    i, j = torch.nonzero(hit, as_tuple=True)  # equal current-block keys
    near = popcount64(x[i, j]) < t
    pp, qq = p[i[near]], q[i[near], j[near]]
    who = torch.where(srow[pp] < srow[qq], pp, qq)
    out.index_add_(0, who, torch.ones_like(who, dtype=torch.int32))


def band_counts_plain(sh: torch.Tensor, srow: torch.Tensor,
                      svalid: torch.Tensor, masks: Sequence[int], t: int,
                      s: int) -> torch.Tensor:
    """Plain PyTorch version of the band (same contract): each row against
    the 2s positions from its tile's start, a slab of rows per step.
    @return csort [n_pad + s] int32"""
    n_tot = sh.numel()
    n_pad = n_tot - s
    dev = sh.device
    out = torch.zeros(n_tot, dtype=torch.int32, device=dev)
    step = max(1, _pair_budget(dev) // (2 * s))
    win = torch.arange(2 * s, device=dev)
    for p0 in range(0, n_pad, step):
        p = torch.arange(p0, min(p0 + step, n_pad), device=dev)
        q = (p // s * s)[:, None] + win[None, :]
        _credit(out, sh, srow, svalid, p, q, masks, t, later=True)
    return out


def run_tiles_plain(csort: torch.Tensor, sh: torch.Tensor,
                    srow: torch.Tensor, svalid: torch.Tensor,
                    tiles, masks: Sequence[int], t: int,
                    s: int) -> torch.Tensor:
    """Plain PyTorch version of the run tiles: adds into ``csort``.
    @param tiles [P, 2] (ta, tb): a host array or a tensor
    @return csort"""
    dev = sh.device
    span = torch.arange(s, device=dev)
    if isinstance(tiles, torch.Tensor):
        tiles = tiles.cpu().numpy()
    for ta, tb in np.asarray(tiles).reshape(-1, 2):
        q = (int(tb) * s + span)[None, :].expand(s, s)
        _credit(csort, sh, srow, svalid, int(ta) * s + span, q, masks, t,
                later=False)
    return csort


_BAND_FN = "cbird_band_counts"
_RUN_FN = "cbird_run_tiles"
_COMMON = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
           ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
# cbird_run_tiles: _COMMON, tiles, n_pairs, out, stream
_RUN_ARGS = _COMMON + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]


def _load(fn: str, argtypes: list):
    return _build.load_kernel("band_count", fn, argtypes)


def _mask_array(masks: Sequence[int]):
    arr = (ctypes.c_ulonglong * MAX_MASKS)()
    for i, m in enumerate(masks):
        arr[i] = int(m) & 0xFFFFFFFFFFFFFFFF
    return arr


def _require_cuda(sh: torch.Tensor, what: str) -> None:
    if sh.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {sh.device}")


def band_counts(sh: torch.Tensor, srow: torch.Tensor, svalid: torch.Tensor,
                masks: Sequence[int], t: int, s: int) -> torch.Tensor:
    """Band credits of one block's sorted order: every counted pair within
    one tile of ``s`` sorted positions or between adjacent tiles.
    @return csort [n_pad + s] int32"""
    dev = one_device("band_counts", sh, srow, svalid)
    if dev.type == "cpu":
        return band_counts_plain(sh, srow, svalid, masks, t, s)
    lib = _load(_BAND_FN, _COMMON + [ctypes.c_void_p, ctypes.c_void_p])
    check_operands(sh, srow, svalid, masks, s)
    _require_cuda(sh, "band_counts")
    out = torch.empty(sh.numel(), dtype=torch.int32, device=dev)
    marr = _mask_array(masks)
    with launch_on(dev):
        err = getattr(lib, _BAND_FN)(
            sh.data_ptr(), srow.data_ptr(), svalid.data_ptr(), sh.numel(),
            int(s), ctypes.addressof(marr), len(masks), int(t),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "band_counts")
    band_counts.launches += 1
    return out


band_counts.launches = 0


def device_tiles(tiles, dev: torch.device, n_tot: int,
                 s: int) -> torch.Tensor:
    """The tile list as K3-run reads it: a contiguous [P, 2] int32 tensor
    on ``dev``.  A host list is checked (``check_tiles``) and copied; a
    tensor on ``dev`` is used as it is."""
    if isinstance(tiles, torch.Tensor):
        if tiles.device != dev:
            raise ValueError("operands on different devices: the tile list "
                             f"on {tiles.device}, the order on {dev}")
        if tiles.dtype != torch.int32 or tiles.dim() != 2 \
                or tiles.shape[1] != 2:
            raise ValueError(f"tiles must be [P, 2] int32, got "
                             f"{tuple(tiles.shape)} {tiles.dtype}")
        return tiles.contiguous()
    tiles = np.asarray(tiles, dtype=np.int32).reshape(-1, 2)
    check_tiles(tiles, n_tot, s)
    return torch.from_numpy(tiles).to(dev)


def run_tiles(csort: torch.Tensor, sh: torch.Tensor, srow: torch.Tensor,
              svalid: torch.Tensor, tiles, masks: Sequence[int], t: int,
              s: int) -> torch.Tensor:
    """Add the dense [s, s] tiles (ta, tb) of over-long equal-key runs into
    ``csort``, all in one launch.
    @param tiles [P, 2] (ta, tb), tb >= ta + 2: an int32 tensor on the
           operands' device (``ops/pigeonhole.py`` ``run_tile_pairs``: no
           copy), or a host array (checked, then copied)
    @return csort"""
    dev = one_device("run_tiles", csort, sh, srow, svalid)
    if dev.type == "cpu":
        return run_tiles_plain(csort, sh, srow, svalid, tiles, masks, t, s)
    lib = _load(_RUN_FN, _RUN_ARGS)
    check_operands(sh, srow, svalid, masks, s)
    _require_cuda(sh, "run_tiles")
    if (csort.dtype != torch.int32 or csort.shape != sh.shape
            or csort.device != sh.device or not csort.is_contiguous()):
        raise ValueError("csort must be a contiguous int32 vector like sh")
    tiles = device_tiles(tiles, dev, sh.numel(), s)
    if not len(tiles):
        return csort
    marr = _mask_array(masks)
    with launch_on(dev):
        err = getattr(lib, _RUN_FN)(
            sh.data_ptr(), srow.data_ptr(), svalid.data_ptr(), sh.numel(),
            int(s), ctypes.addressof(marr), len(masks), int(t),
            tiles.data_ptr(), len(tiles), csort.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "run_tiles")
    run_tiles.launches += 1
    return csort


run_tiles.launches = 0
