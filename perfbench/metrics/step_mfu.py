"""The step's share of the card's float32 peak: the counted operations of
every kernel of ``perfbench/roofline/`` that ran in the traced steps, over
as many steps' seconds of the measured window."""

from perfbench.harness.readers import step_mfu
from perfbench.roofline import kernels

KERNELS = kernels()
CAPTURES = tuple(sorted({k.CAPTURE for k in KERNELS}))


def read(ctx):
    return step_mfu(ctx, KERNELS)
