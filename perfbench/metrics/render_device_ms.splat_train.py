"""Device ms a traced step of the trainer's forward render
(``train.render``: projection, SH, binning, the tile lists' gather and
K1f), its binning (``render.bin``) included."""

from perfbench.harness import program  # noqa: F401  (the program's spans on)
from perfbench.harness.readers import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ["train.render", "render.bin"])
