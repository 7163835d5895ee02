"""K1b's share of its roofline (``perfbench/roofline/k1b.py``)."""

from perfbench.harness.readers import roofline_share
from perfbench.roofline import k1b

CAPTURES = (k1b.CAPTURE,)


def read(ctx):
    return roofline_share(ctx, k1b)
