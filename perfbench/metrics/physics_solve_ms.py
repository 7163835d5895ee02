"""Host ms a window step in the program's ``physics.solve`` spans
(``planar.solve_contacts``, the PGS solve of each of the ten substeps)."""

from perfbench.harness.program import span_ms


def read(ctx):
    return span_ms(ctx, ["physics.solve"])
