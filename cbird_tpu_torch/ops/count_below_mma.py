"""Hamming count-below-threshold on the tensor cores: CUDA kernels K1-mma
and K2-mma, their plain twin, the count gate and the triangle's tiles.

``count_below_mma`` computes K1's function (per needle, the valid
haystack rows at Hamming distance < t) as a +-1 matrix product, dot = 64
- 2 * ham, with the compare and the row sum on chip.  With
``masked=True`` it counts only global column id > global row id, as K2
does on the diagonal tiles of the self-search triangle.  On the main path
it replaces ``cbird_tpu/ops/mxu_count.py`` ``mxu_count_below`` and
``mxu_count_triangle``; it also ports the TPU's +-1 product experiments
(``experiments/mxu_epilogue_ab.py`` ``count``, ``count_jouter``,
``count_packed``, ``experiments/mxu_i16_ab.py`` ``count_i16`` and, with
``bf16=True``, ``experiments/mxu_count_sweep2.py`` ``mxu_count_bf16``).
The kernel is ``csrc/count_below_mma.cu``; its header says what bounds
it on an H100 and how the design answers that.  The popcount form,
``ops/count_below.py``, stays as the yardstick and for the plain twins
of the other kernels.

On a CPU tensor the wrapper runs ``count_below_mma_plain`` (the same +-1
product in float32); on any other device it launches the kernel or
raises.  The main form is a wgmma kernel on e4m3 +-1 operands with f16
sums (the int8 rate; exact, |sum| < 2048; a row's hits added as
integers).  ``count_below_mma.launches`` counts launches of its unmasked
form, ``count_below_mma.masked_launches`` those of its masked form,
``count_below_mma.bf16_launches`` those of the bf16 form.

``count_gate`` takes the roles of ``count_below_padded`` and
``mxu_enabled`` of ``cbird_tpu/ops/mxu_count.py`` (no padding: the kernel
masks its ragged edges), and ``self_tile`` is the port of
``mxu_self_tile`` (tile slicing and row-validity zeroing).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .count_below import check_operands, chunk_cols

_FN = "cbird_count_below_mma"
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p]


def _check_threshold(threshold: int) -> int:
    """@return the threshold the kernel takes: every t >= 65 counts every
    valid row, as t = 65 does (dot > -66 holds for every dot)."""
    t = int(threshold)
    if t < 0:
        raise ValueError(f"count_below_mma takes thresholds >= 0, got {t}")
    return min(t, 65)


def unpack_pm1(hashes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[N] int64 bit patterns -> [N, 64] +-1 (bit k of row i: -1 if set)."""
    k = torch.arange(64, device=hashes.device)
    return (1 - 2 * ((hashes[:, None] >> k) & 1)).to(dtype)


def count_below_mma_plain(needles: torch.Tensor, hay: torch.Tensor,
                          valid: torch.Tensor, threshold: int, *,
                          masked: bool = False, row_base: int = 0,
                          col_base: int = 0) -> torch.Tensor:
    """Plain PyTorch version of every form (same contract): the +-1
    product in float32, exact since |dot| <= 64, over the haystack in
    ``chunk_cols`` steps; ``masked`` keeps only global column id > global
    row id."""
    t = _check_threshold(threshold)
    q, n = needles.numel(), hay.numel()
    out = torch.zeros(q, dtype=torch.int32, device=needles.device)
    if q == 0 or n == 0:
        return out
    a = unpack_pm1(needles)
    rows = row_base + torch.arange(q, device=needles.device)
    chunk = chunk_cols(q, needles.device)
    for c0 in range(0, n, chunk):
        h = hay[c0:c0 + chunk]
        hit = (a @ unpack_pm1(h).T) > 64 - 2 * t
        hit &= valid[None, c0:c0 + chunk]
        if masked:
            cols = col_base + c0 + torch.arange(h.numel(),
                                                device=needles.device)
            hit &= cols[None, :] > rows[:, None]
        out += hit.sum(dim=1, dtype=torch.int32)
    return out


def _load():
    return _build.load_kernel("count_below_mma", _FN, _ARGTYPES)


def count_below_mma(needles: torch.Tensor, hay: torch.Tensor,
                    valid: torch.Tensor, threshold: int, *,
                    masked: bool = False, row_base: int = 0,
                    col_base: int = 0, bf16: bool = False) -> torch.Tensor:
    """Per needle, the number of valid haystack rows at Hamming distance
    < ``threshold`` (>= 0), on the tensor cores at the 8-bit rate
    (``bf16``: the bf16 one).  ``masked`` counts only global column id
    (``col_base + j``) > global row id (``row_base + i``): the diagonal
    tile of the self-search triangle.  Needle-row validity is not masked.

    @param needles [Q] int64, hay [N] int64, valid [N] bool
    @return [Q] int32 counts
    """
    t = _check_threshold(threshold)
    if needles.device.type == "cpu":
        return count_below_mma_plain(needles, hay, valid, t, masked=masked,
                                     row_base=row_base, col_base=col_base)
    lib = _load()
    check_operands(needles, hay, valid)
    if needles.device.type != "cuda":
        raise ValueError(f"count_below_mma needs CUDA tensors, got "
                         f"{needles.device}")
    out = torch.empty(needles.numel(), dtype=torch.int32,
                      device=needles.device)
    err = getattr(lib, _FN)(
        needles.data_ptr(), needles.numel(), hay.data_ptr(), valid.data_ptr(),
        hay.numel(), t, int(bf16), int(masked), int(row_base), int(col_base),
        out.data_ptr(), torch.cuda.current_stream(needles.device).cuda_stream)
    _build.check(lib, err, "count_below_mma")
    if bf16:
        count_below_mma.bf16_launches += 1
    elif masked:
        count_below_mma.masked_launches += 1
    else:
        count_below_mma.launches += 1
    return out


count_below_mma.launches = 0
count_below_mma.masked_launches = 0
count_below_mma.bf16_launches = 0


def count_gate(needles: torch.Tensor, hay: torch.Tensor, valid: torch.Tensor,
               threshold: int) -> torch.Tensor:
    """K1's counts for the count gates of the image and video searches:
    the tensor-core form at every threshold."""
    return count_below_mma(needles, hay, valid, threshold)


def self_tile(acc: torch.Tensor, hashes: torch.Tensor, valid: torch.Tensor,
              threshold: int, row_base: int, col_base: int, rows: int,
              cols: int, masked: bool) -> torch.Tensor:
    """One [rows x cols] tile of the triangular self-search count phase
    (port of ``mxu_self_tile``): store rows [row_base, +rows) against
    store columns [col_base, +cols); invalid needle rows count 0.
    @return acc + the tile's per-row counts"""
    counts = count_below_mma(hashes[row_base:row_base + rows],
                             hashes[col_base:col_base + cols],
                             valid[col_base:col_base + cols], threshold,
                             masked=masked, row_base=row_base,
                             col_base=col_base)
    return acc + counts * valid[row_base:row_base + rows]
