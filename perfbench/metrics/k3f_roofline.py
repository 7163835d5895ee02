"""K3f's share of its roofline (``perfbench/roofline/k3f.py``)."""

from perfbench.harness.readers import roofline_share
from perfbench.roofline import k3f

CAPTURES = (k3f.CAPTURE,)


def read(ctx):
    return roofline_share(ctx, k3f)
