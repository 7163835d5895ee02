"""Device ms a step of the kernels the render layer launches: the static
prepare (SH, tile cache, K1) and the selected-tile render (posing's
projection, binning, selection, gathers, K2)."""

from perfbench.harness.readers import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ["render.prepare", "render.select"])
