"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit) and the roofline bound of a count.

A kernel's bound is the larger of its operations over the float32 peak
outside the tensor cores and its bytes over the memory bandwidth; its share
of the roofline is that bound over its measured time.
"""

PEAK_FP32_FLOPS = 67e12      # FLOP/s, float32 without the tensor cores
PEAK_BYTES_S = 3.35e12       # B/s, HBM3

# FLOP a (pixel, list entry) pair, exp as one: the α of every entry of an
# applied chunk; the blend where α > 0; the gradient of a pair where α > 0
ALPHA_FLOPS, BLEND_FLOPS, GRAD_FLOPS = 15, 11, 52


def bound_s(flops: float, nbytes: float) -> float:
    """Least time the card could take for this work, in seconds."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_S)
