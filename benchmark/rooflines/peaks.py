"""Published peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet:
dense rates, no sparsity, at the full 700 W power limit), and the least
time of a kernel's work at them.

A card set below 700 W runs slower under load: the run prints its power
limit beside the shares.  These are the published numbers, not a clock
probed on the card, so a share is against what the part is sold as.
"""

HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12
# the FP32 pipes issue one instruction a lane a clock; 67 TFLOPS counts an
# FMA as two operations, so instructions (of any kind) issue at half that
FP32_INSTRUCTIONS_PER_S = FP32_FLOPS / 2


def least_s(ops: float, ops_per_s: float, nbytes: float) -> float:
    """The least time of ``ops`` operations at ``ops_per_s`` and
    ``nbytes`` bytes of HBM traffic: the larger of the two."""
    return max(ops / ops_per_s, nbytes / HBM_BYTES_PER_S)
