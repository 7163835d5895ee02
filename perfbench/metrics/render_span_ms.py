"""Host ms a window step in the program's ``render.prepare`` and
``render.select`` spans (the static prepare, and the selected-tile render
of ``rasterize_cache_sel_batch``)."""

from perfbench.harness.program import span_ms


def read(ctx):
    return span_ms(ctx, ["render.prepare", "render.select"])
