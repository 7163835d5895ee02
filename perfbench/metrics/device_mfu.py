"""The step's share of the card's float32 peak on the device's time: the
counted operations of every kernel of ``perfbench/roofline/`` that ran in
the traced steps, over the seconds the device was busy in them."""

from perfbench.harness.readers import device_mfu
from perfbench.roofline import kernels

KERNELS = kernels()
CAPTURES = tuple(sorted({k.CAPTURE for k in KERNELS}))


def read(ctx):
    return device_mfu(ctx, KERNELS)
