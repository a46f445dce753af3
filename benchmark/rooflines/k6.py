"""K6, the chamfer color score (``score_kernel``) of a needle block
against every row of the color store (``side="both"``).

Operations, from the needles' and the live rows' color counts: a pair of
needle and row with counts x, y (|x - y| <= 2; other pairs score nothing)
takes 7 FP32 instructions a color pair (3 subtracts, a multiply, 2 FMAs
for d2 and a min) and 3 a color of the side that drives the sum (a square
root, a compare, an add), at the published FP32 rate in instructions
(``peaks.FP32_INSTRUCTIONS_PER_S``).  Bytes: each needle's colors and
count (384 + 4), each row's (384 + 4 + 1 for validity) and each [Q, C]
score (4) once.
"""

import numpy as np

from benchlib.manifest import part

peaks = part("rooflines", "peaks")

KERNEL = "score_kernel"
STEP_INSTRUCTIONS = 7
OUTER_INSTRUCTIONS = 3
MAX_COUNT_GAP = 2


def work(needle_counts, row_counts) -> tuple[float, float]:
    """@param needle_counts the needles' color counts; row_counts the live
    rows' color counts (arrays of ints 0..32)
    @return (FP32 instructions, bytes) of one launch"""
    a = np.bincount(np.asarray(needle_counts), minlength=33).astype(
        np.float64)
    b = np.bincount(np.asarray(row_counts), minlength=33).astype(np.float64)
    ops = 0.0
    for x in range(1, 33):
        for y in range(max(1, x - MAX_COUNT_GAP),
                       min(32, x + MAX_COUNT_GAP) + 1):
            ops += a[x] * b[y] * (STEP_INSTRUCTIONS * x * y
                                  + OUTER_INSTRUCTIONS * max(x, y))
    q, c = len(needle_counts), len(row_counts)
    return ops, 388 * q + 389 * c + 4 * q * c


def least_s(rec: dict):
    """@param rec one call's work: ``k6_instructions``, ``k6_bytes``"""
    if "k6_instructions" not in rec:
        return None
    return peaks.least_s(rec["k6_instructions"],
                         peaks.FP32_INSTRUCTIONS_PER_S, rec["k6_bytes"])
