"""K2f's share of its roofline (``perfbench/roofline/k2f.py``)."""

from perfbench.harness.readers import roofline_share
from perfbench.roofline import k2f

CAPTURES = (k2f.CAPTURE,)


def read(ctx):
    return roofline_share(ctx, k2f)
