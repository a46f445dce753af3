"""The work of a 64-bit Hamming pair, whatever unit a kernel runs it on.

A pair's distance is one 64-term +-1 product (dot = 64 - 2 * distance):
64 multiply-adds, 128 operations, at the int8 tensor-core rate, the
fastest published rate that computes it exactly.  A kernel on the
popcount pipes is held to the same bound, so a tensor-core form of it can
never read above 100%.
"""

from benchlib.manifest import part

peaks = part("rooflines", "peaks")

OPS_PER_PAIR = 128
OPS_PER_S = peaks.INT8_TENSOR_OPS_PER_S


def least_s(pairs: float, nbytes: float) -> float:
    return peaks.least_s(OPS_PER_PAIR * pairs, OPS_PER_S, nbytes)
