"""Host ms a step in the render layer: the static prepare (SH, tile cache,
K1) and the selected-tile render (posing's projection, binning, selection,
gathers, K2)."""

from perfbench.harness.readers import span_ms


def read(ctx):
    return span_ms(ctx, ["render.prepare", "render.select"])
