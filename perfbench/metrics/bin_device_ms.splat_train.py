"""Device ms a traced step of the trainer's binning (``render.bin``,
``_bin_gaussians``: the keys, the depth and key sorts and the
``searchsorted`` of the tiles' bounds)."""

from perfbench.harness import program  # noqa: F401  (the program's spans on)
from perfbench.harness.readers import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ["render.bin"])
