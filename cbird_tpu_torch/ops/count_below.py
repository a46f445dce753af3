"""Hamming count-below-threshold, popcount form: CUDA kernel K1/K2, its
plain twin, shared helpers.

``count_below`` computes the function of ``cbird_tpu/ops/mxu_count.py``
``mxu_count_below`` (K1) and, with ``masked=True``, ``mxu_count_triangle``
(K2) with one popcount a pair.  The main path takes the tensor-core form
of the same function (``ops/count_below_mma.py``, K1-mma and K2-mma) at
every threshold; this one stays as the yardstick that chip_smoke.py times
and checks beside it.  The kernel is ``csrc/count_below.cu``; its header
says what bounds it on an H100.

Hashes are int64 bit patterns, one per row.  On a CPU tensor the wrapper
runs ``count_below_plain``; on any other device it launches the kernel or
raises.  ``count_below.launches`` counts launches of the unmasked kernel
(K1), ``count_below.masked_launches`` those of the masked one (K2).

``popcount64``, ``chunk_cols`` and ``check_operands`` serve the plain
twins and wrappers of the other kernels too.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F


def popcount64(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 bit patterns (SWAR).  Torch has no popcount, and
    ``>>`` on int64 is arithmetic: the mask after the first shift clears
    the copied sign bits, and every later value is non-negative."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def chunk_cols(q: int, device: torch.device) -> int:
    """Haystack columns per step of a plain version: ~2^16 pairs on the
    CPU (cache-sized temporaries run ~6x faster than 2^20-pair ones),
    ~2^26 on a card (few launches, bounded memory)."""
    return max(1, (1 << (16 if device.type == "cpu" else 26)) // max(q, 1))


def check_operands(needles: torch.Tensor, hay: torch.Tensor,
                   valid: torch.Tensor) -> None:
    """Shapes, types, devices and contiguity the kernels accept."""
    if needles.dtype != torch.int64 or hay.dtype != torch.int64:
        raise TypeError("hashes must be int64 bit patterns")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    if needles.dim() != 1 or hay.dim() != 1 or valid.shape != hay.shape:
        raise ValueError(f"bad shapes {tuple(needles.shape)} "
                         f"{tuple(hay.shape)} {tuple(valid.shape)}")
    if not (needles.device == hay.device == valid.device):
        raise ValueError("operands on different devices")
    if not (needles.is_contiguous() and hay.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("operands must be contiguous")
    if max(needles.numel(), hay.numel()) >= 1 << 31:
        raise ValueError("operand too long for int32 indexing")


def count_below_plain(needles: torch.Tensor, hay: torch.Tensor,
                      valid: torch.Tensor, threshold: int, *,
                      masked: bool = False, row_base: int = 0,
                      col_base: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract), over the
    haystack in ``chunk_cols`` steps."""
    q, n = needles.numel(), hay.numel()
    out = torch.zeros(q, dtype=torch.int32, device=needles.device)
    if q == 0 or n == 0:
        return out
    chunk = chunk_cols(q, needles.device)
    rows = row_base + torch.arange(q, device=needles.device)
    for c0 in range(0, n, chunk):
        h = hay[c0:c0 + chunk]
        hit = popcount64(needles[:, None] ^ h[None, :]) < threshold
        hit &= valid[None, c0:c0 + chunk]
        if masked:
            cols = col_base + c0 + torch.arange(h.numel(),
                                                device=needles.device)
            hit &= cols[None, :] > rows[:, None]
        out += hit.sum(dim=1, dtype=torch.int32)
    return out


_FN = "cbird_count_below"
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]


def _load():
    return _build.load_kernel("count_below", _FN, _ARGTYPES)


def count_below(needles: torch.Tensor, hay: torch.Tensor, valid: torch.Tensor,
                threshold: int, *, masked: bool = False, row_base: int = 0,
                col_base: int = 0) -> torch.Tensor:
    """Per needle, the number of valid haystack rows at Hamming distance
    < ``threshold``.  ``masked`` counts only global column id
    (``col_base + j``) > global row id (``row_base + i``): the diagonal
    tile of the self-search triangle.  Needle-row validity is not masked.

    @param needles [Q] int64, hay [N] int64, valid [N] bool
    @return [Q] int32 counts
    """
    if needles.device.type == "cpu":
        return count_below_plain(needles, hay, valid, threshold,
                                 masked=masked, row_base=row_base,
                                 col_base=col_base)
    lib = _load()
    check_operands(needles, hay, valid)
    if needles.device.type != "cuda":
        raise ValueError(f"count_below needs CUDA tensors, got "
                         f"{needles.device}")
    out = torch.empty(needles.numel(), dtype=torch.int32,
                      device=needles.device)
    err = getattr(lib, _FN)(
        needles.data_ptr(), needles.numel(), hay.data_ptr(), valid.data_ptr(),
        hay.numel(), int(threshold), int(masked), int(row_base),
        int(col_base), out.data_ptr(),
        torch.cuda.current_stream(needles.device).cuda_stream)
    _build.check(lib, err, "count_below")
    if masked:
        count_below.masked_launches += 1
    else:
        count_below.launches += 1
    return out


count_below.launches = 0
count_below.masked_launches = 0

