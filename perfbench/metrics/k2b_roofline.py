"""K2b's share of its roofline (``perfbench/roofline/k2b.py``)."""

from perfbench.harness.readers import roofline_share
from perfbench.roofline import k2b

CAPTURES = (k2b.CAPTURE,)


def read(ctx):
    return roofline_share(ctx, k2b)
