"""float32 operations rounded once, in plain PyTorch: ``fma32`` and
``sqrt32``, as XLA's CPU backend and CUDA (``__fmaf_rn``, ``__fsqrt_rn``)
compute them.

PyTorch has no float32 fma, and its CPU float32 ``sqrt`` of a large
tensor (through MKL) is not correctly rounded: 1 ulp off on ~0.7% of
random inputs.  ``sqrt32`` takes the root in float64 and rounds it, which
gives the correctly rounded float32 (53 >= 2 * 24 + 2 bits).  ``fma32``
takes ``a * b + c`` in float64, where the product of two float32 is
exact, so only the add rounds there.  Rounding that sum again to float32
goes the exact sum's way unless the float64 sum lies on a float32
midpoint; there the add is taken rounded to odd (the float64 sum, its
TwoSum error, and where the error is nonzero and the sum's last mantissa
bit is 0, the sum stepped one ulp toward the error), which in 53 bits
rounds to the same float32 as the exact sum.  The sparse form rounds to
odd only the midpoints, found with a host sync; the dense form steps
each midpoint a little toward the TwoSum error, in more passes and no
sync (launch-bound tensors on the card).
"""

from __future__ import annotations

import numpy as np
import torch

_LOW29, _HALF29 = (1 << 29) - 1, 1 << 28  # float64 bits below float32's
# entries: on the card fma32 takes the dense form below, the sparse one
# from here up (the crossover of the two on an H100, chip_tune.py fma)
_DENSE_MAX = 1 << 23


def _round_odd(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float64 ``p + c`` rounded to odd (p and c float64)."""
    s = p + c
    bb = s - p  # TwoSum: s + err == p + c exactly
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    step = ((bits & 1) == 0) & (err != 0)
    away = (err > 0) == (s > 0)  # toward err is away from 0
    return torch.where(step, torch.where(away, bits + 1, bits - 1),
                       bits).view(torch.float64)


def _operands(a, b, c):
    """(a, b) float32 tensors, a with a dimension where either has one (the
    product commutes), c a tensor, and the result's shape.  Python numbers
    become 0-dim tensors on the CPU (a, b float32, c float64), which a
    CUDA op takes as scalars (no copy to the card)."""
    ts = [v for v in (a, b, c) if isinstance(v, torch.Tensor)]
    shape = torch.broadcast_shapes(*(t.shape for t in ts))
    a, b = (v if isinstance(v, torch.Tensor) else
            torch.tensor(np.float32(v)) for v in (a, b))
    if not a.dim() and b.dim():
        a, b = b, a
    if not isinstance(c, torch.Tensor):
        c = torch.tensor(float(np.float32(c)), dtype=torch.float64)
    return a, b, c, shape


def _fma32_sparse(a, b, c, shape) -> torch.Tensor:
    """The float64 sum, and the sum rounded to odd where it lies on a
    float32 midpoint: a few passes, and a host sync to find those."""
    dev = next(t.device for t in (a, b, c) if t.dim())
    # a float64 operand of the result's shape: the product exact, the add
    # rounded once
    c = c.to(dev, torch.float64).expand(shape)
    s = torch.addcmul(c, a, b) if a.dim() else c + a.double() * b.double()
    r = s.to(torch.float32)
    hard = (s.view(torch.int64) & _LOW29) == _HALF29
    if bool(hard.any()):
        at = hard.nonzero(as_tuple=True)
        p = (a.to(dev).expand(shape)[at].double()
             * b.to(dev).expand(shape)[at].double())
        r[at] = _round_odd(p, c[at]).to(torch.float32)
    return r


def _fma32_dense(a, b, c, shape) -> torch.Tensor:
    """Every entry's sum, stepped toward its TwoSum error where it lies on
    a float32 midpoint: more passes, no host sync."""
    a64 = a.to(torch.float64)
    p = a64 * (a64 if b is a else b.to(torch.float64))  # exact
    if not p.dim():  # a 0-dim float64 leaves a float32 tensor's sum float32
        c = c.to(torch.float64)
    s = p + c
    bb = s - p  # TwoSum: s + err == p + c exactly
    err = (p - (s - bb)) + (c - bb)
    mid = (s.view(torch.int64) & _LOW29) == _HALF29
    # at a midpoint, a step of 2^-40 |s| toward err: past s's float64
    # neighbours, short of its float32 ones, so the float32 rounding goes
    # the exact sum's way (rounding to odd would give the same float32)
    toward = torch.where(mid, (err * s).sign_(), 0.0)
    return torch.addcmul(s, toward, s, value=2.0 ** -40).to(torch.float32)


def fma32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, wherever the exact result is 0
    or in float32's normal range (|a * b + c| >= 2^-126; below it, where
    no caller here goes, it may round twice).  Each operand is a float32
    tensor or a Python number taken as float32; at least one is a tensor
    with a dimension.  On the card a result under _DENSE_MAX entries takes
    the dense form (there its passes cost less than the sparse form's
    host sync), a larger one the sparse form; on the CPU every size takes
    the sparse form.
    @return float32, the operands' broadcast shape"""
    a, b, c, shape = _operands(a, b, c)
    dev = next(t.device for t in (a, b, c) if t.dim())
    if dev.type != "cpu" and shape.numel() < _DENSE_MAX:
        return _fma32_dense(a, b, c, shape)
    return _fma32_sparse(a, b, c, shape)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``sqrt(x)`` rounded once."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)
