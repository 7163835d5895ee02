"""K1f's share of its roofline (``perfbench/roofline/k1f.py``)."""

from perfbench.harness.readers import roofline_share
from perfbench.roofline import k1f

CAPTURES = (k1f.CAPTURE,)


def read(ctx):
    return roofline_share(ctx, k1f)
