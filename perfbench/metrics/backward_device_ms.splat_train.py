"""Device ms a traced step of the trainer's backward (``train.backward``:
SSIM's and the L1's gradient, K1b, the gather's scatter into the
gaussians, the projection's and the SH's backward)."""

from perfbench.harness import program  # noqa: F401  (the program's spans on)
from perfbench.harness.readers import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ["train.backward"])
