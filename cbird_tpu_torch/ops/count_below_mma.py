"""Hamming count-below-threshold on the tensor cores: CUDA kernel K1-mma.

``count_below_mma`` computes K1's function (``ops/count_below.py``
``count_below``: per needle, the valid haystack rows at Hamming distance
< t) as a +-1 matrix product, dot = 64 - 2 * ham, with the compare and
the row sum on chip.  It replaces the TPU's +-1 product kernels of
``experiments/mxu_epilogue_ab.py`` (``count``, ``count_jouter``,
``count_packed``), ``experiments/mxu_i16_ab.py`` (``count_i16``) and, with
``bf16=True``, ``experiments/mxu_count_sweep2.py`` (``mxu_count_bf16``).
The kernel is ``csrc/count_below_mma.cu``; its header says what bounds it
on an H100 and how the design answers that.

On a CPU tensor the wrapper runs ``count_below_mma_plain`` (the same +-1
product in float32); on any other device it launches the kernel or
raises.  ``count_below_mma.launches`` counts launches of the int8 form,
``count_below_mma.bf16_launches`` those of the bf16 form.

``count_gate`` takes the roles of ``count_below_padded`` and
``mxu_enabled`` of ``cbird_tpu/ops/mxu_count.py``: the tensor-core form
below threshold 64 (no padding: the kernel masks its ragged edges), the
popcount K1 at 64.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .count_below import check_operands, chunk_cols, count_below

_FN = "cbird_count_below_mma"
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p]


def _check_threshold(threshold: int) -> int:
    t = int(threshold)
    if not 0 <= t <= 63:
        raise ValueError(f"count_below_mma takes thresholds 0..63, got {t}")
    return t


def unpack_pm1(hashes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[N] int64 bit patterns -> [N, 64] +-1 (bit k of row i: -1 if set)."""
    k = torch.arange(64, device=hashes.device)
    return (1 - 2 * ((hashes[:, None] >> k) & 1)).to(dtype)


def count_below_mma_plain(needles: torch.Tensor, hay: torch.Tensor,
                          valid: torch.Tensor, threshold: int) -> torch.Tensor:
    """Plain PyTorch version of both forms (same contract): the +-1 product
    in float32, exact since |dot| <= 64, over the haystack in
    ``chunk_cols`` steps."""
    t = _check_threshold(threshold)
    q, n = needles.numel(), hay.numel()
    out = torch.zeros(q, dtype=torch.int32, device=needles.device)
    if q == 0 or n == 0:
        return out
    a = unpack_pm1(needles)
    chunk = chunk_cols(q, needles.device)
    for c0 in range(0, n, chunk):
        hit = (a @ unpack_pm1(hay[c0:c0 + chunk]).T) > 64 - 2 * t
        hit &= valid[None, c0:c0 + chunk]
        out += hit.sum(dim=1, dtype=torch.int32)
    return out


def _load():
    return _build.load_kernel("count_below_mma", _FN, _ARGTYPES)


def count_below_mma(needles: torch.Tensor, hay: torch.Tensor,
                    valid: torch.Tensor, threshold: int, *,
                    bf16: bool = False) -> torch.Tensor:
    """Per needle, the number of valid haystack rows at Hamming distance
    < ``threshold`` (0..63), on the int8 tensor cores (``bf16``: the bf16
    ones).

    @param needles [Q] int64, hay [N] int64, valid [N] bool
    @return [Q] int32 counts
    """
    t = _check_threshold(threshold)
    if needles.device.type == "cpu":
        return count_below_mma_plain(needles, hay, valid, t)
    lib = _load()
    check_operands(needles, hay, valid)
    if needles.device.type != "cuda":
        raise ValueError(f"count_below_mma needs CUDA tensors, got "
                         f"{needles.device}")
    out = torch.empty(needles.numel(), dtype=torch.int32,
                      device=needles.device)
    err = getattr(lib, _FN)(
        needles.data_ptr(), needles.numel(), hay.data_ptr(), valid.data_ptr(),
        hay.numel(), t, int(bf16), out.data_ptr(),
        torch.cuda.current_stream(needles.device).cuda_stream)
    _build.check(lib, err, "count_below_mma")
    if bf16:
        count_below_mma.bf16_launches += 1
    else:
        count_below_mma.launches += 1
    return out


count_below_mma.launches = 0
count_below_mma.bf16_launches = 0


def count_gate(needles: torch.Tensor, hay: torch.Tensor, valid: torch.Tensor,
               threshold: int) -> torch.Tensor:
    """K1's counts through the tensor-core form below threshold 64, the
    popcount form at 64 (the +-1 compare has no room for it)."""
    if threshold < 64:
        return count_below_mma(needles, hay, valid, threshold)
    return count_below(needles, hay, valid, threshold)
