"""Plain reference of the dct index's search (``-p.alg dct``), and its
control.

The function, for a needle hash q over the store's rows: every live row
r with Hamming distance d(q, r) < t, ascending by (d, r), at most k of
them; a needle whose hash is 0 (a media without a hash) has none.
``-similar`` gives each live row the list of its own hash (itself at
distance 0 first among equals), and keeps the rows whose list holds
another row.

Distances come from a +-1 product: with bit b of a hash mapped to +1 when
set and -1 when clear, dot(q, r) = 64 - 2 d(q, r).  Every partial sum is
an integer of magnitude at most 64, exact in bfloat16 and float32 under
any order of accumulation, so the product is exact.  Plain PyTorch on the
benchmark's own arrays; nothing of the port is imported or read, apart
from the answers it judges.

The control breaks one guarantee, exactness, the way an approximate index
would: it keeps only the matches that share one of the four 16-bit
quarters of the needle exactly, so a pair at distance 4 with one differing
bit in each quarter is lost.
"""

from __future__ import annotations

import numpy as np
import torch

BITS = 64


def _pm1(h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[N] int64 -> [N, 64] +-1 in ``dtype`` (bit b: +1 when set)."""
    shifts = torch.arange(BITS, device=h.device)
    return (((h[:, None] >> shifts) & 1) * 2 - 1).to(dtype)


def _dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def pm1_store(hashes: torch.Tensor, block: int = 1 << 20) -> torch.Tensor:
    """The store as [N, 64] +-1, unpacked in blocks of rows."""
    dt = _dtype(hashes.device)
    return torch.cat([_pm1(hashes[i:i + block], dt)
                      for i in range(0, hashes.numel(), block)])


def near_rows(store_pm1: torch.Tensor, valid: torch.Tensor,
              needles: torch.Tensor, t: int, k: int,
              block: int = 256) -> list[tuple[np.ndarray, np.ndarray]]:
    """The function for each needle.

    @param store_pm1 ``pm1_store(hashes)``; valid [N] bool: live rows
    @param needles [Q] int64
    @return per needle (rows int64, distances int64), ascending by
            (distance, row), at most k"""
    n = store_pm1.shape[0]
    out: list = []
    for b0 in range(0, needles.numel(), block):
        nd = needles[b0:b0 + block]
        dot = _pm1(nd, store_pm1.dtype) @ store_pm1.T  # [b, N], exact
        hit = (dot > BITS - 2 * t) & valid[None, :]
        qi, rows = torch.nonzero(hit, as_tuple=True)
        d = ((BITS - dot[qi, rows].float()) / 2).long()
        order = torch.argsort((qi * (BITS + 1) + d) * n + rows)
        qi, rows, d = (x[order].cpu().numpy() for x in (qi, rows, d))
        bounds = np.searchsorted(qi, np.arange(nd.numel() + 1))
        zero = (nd == 0).cpu().numpy()
        for j in range(nd.numel()):
            s0, s1 = bounds[j], min(bounds[j + 1], bounds[j] + k)
            if zero[j]:
                s1 = s0
            out.append((rows[s0:s1], d[s0:s1]))
        del dot, hit
    return out


def similar_rows(store_pm1: torch.Tensor, hashes: torch.Tensor,
                 valid: torch.Tensor, rows: np.ndarray, t: int,
                 k: int) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    """``-similar``'s entries of the given store rows: {row: (rows,
    distances)} for the live ones whose list holds another row."""
    rows = np.asarray(rows, np.int64)
    rows_dev = torch.as_tensor(rows, device=hashes.device)
    lists = near_rows(store_pm1, valid, hashes[rows_dev], t, k)
    live = valid[rows_dev].cpu().numpy()
    return {int(r): lst for r, lst, on in zip(rows, lists, live)
            if on and len(lst[0]) >= 2}


def control(needles: torch.Tensor, hashes: torch.Tensor,
            lists: list) -> list:
    """The control's answers: ``lists`` (the function's, for
    ``needles``) keeping only the rows that equal their needle on one of
    the four 16-bit quarters."""
    out = []
    h = hashes.cpu().numpy().view(np.uint64)
    q = needles.cpu().numpy().view(np.uint64)
    for qv, (rows, d) in zip(q, lists):
        x = h[rows] ^ qv
        keep = np.zeros(len(rows), bool)
        for s in range(0, BITS, 16):
            keep |= ((x >> np.uint64(s)) & np.uint64(0xFFFF)) == 0
        out.append((rows[keep], d[keep]))
    return out


def wrong_lists(got: list, want: list) -> int:
    """How many answers differ from the function's: (rows, distances)
    pairs compared whole, in order."""
    return sum(not (np.array_equal(np.asarray(g[0], np.int64), w[0])
                    and np.array_equal(np.asarray(g[1], np.int64), w[1]))
               for g, w in zip(got, want, strict=True))
