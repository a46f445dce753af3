"""K3, the pigeonhole count phase's band (``band_kernel``) of
``-similar`` at threshold t: the pairs that share one of t disjoint bit
blocks exactly.

A pair at distance < t agrees exactly on at least one of t disjoint
blocks, so the count phase has to test, in each block, every pair of live
rows with equal block keys: that is the work these inputs need
(``equal_key_pairs``).  A pair equal in two blocks is counted in both,
which random hashes make rare.  Operations: one Hamming pair
(``hamming.py``) per such pair.  Bytes, each block's sorted operands read
once and its counts written once: 8 (hash) + 4 (row) + 1 (validity) + 4
(count) bytes a row.

The blocks are the port's partition at the time this count was written,
frozen here: 64 bit positions dealt round-robin, in the order ``SHUFFLE``,
to t blocks.
"""

import torch

from benchlib.manifest import part

hamming = part("rooflines", "hamming")

KERNEL = "band_kernel"
BYTES_PER_ROW = 17
SHUFFLE = (59, 58, 35, 13, 46, 18, 55, 25, 56, 34, 48, 22, 33, 27, 63, 49,
           61, 3, 45, 47, 12, 14, 26, 30, 15, 50, 41, 62, 7, 4, 44, 37, 24,
           23, 2, 16, 54, 9, 28, 5, 19, 31, 21, 29, 42, 53, 8, 60, 17, 39,
           51, 32, 10, 52, 38, 6, 36, 57, 43, 1, 11, 20, 0, 40)


def block_masks(t: int) -> list[int]:
    """t disjoint masks covering the 64 bits, as int64 bit patterns."""
    masks = [0] * t
    for i, bit in enumerate(SHUFFLE):
        masks[i % t] |= 1 << bit
    return [m - (1 << 64) if m >= 1 << 63 else m for m in masks]


def equal_key_pairs(hashes: torch.Tensor, valid: torch.Tensor,
                    t: int) -> int:
    """Pairs of live rows with equal keys, summed over the t blocks.
    @param hashes [N] int64, valid [N] bool"""
    live = hashes[valid]
    total = 0
    for m in block_masks(t):
        keys, _ = torch.sort(live & m)
        runs = torch.unique_consecutive(keys, return_counts=True)[1].long()
        total += int((runs * (runs - 1) // 2).sum())
    return total


def least_s(rec: dict):
    """@param rec one call's work: ``k3_pairs``, ``k3_blocks``,
    ``n_rows``; @return seconds, or None without a count phase"""
    pairs = rec.get("k3_pairs")
    if pairs is None:
        return None
    return hamming.least_s(pairs, BYTES_PER_ROW * rec["n_rows"]
                           * rec["k3_blocks"])
