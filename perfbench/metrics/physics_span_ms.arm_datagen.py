"""Host ms a window step in the program's ``physics`` span (the arm env's
step: the PD loop, the end effector's FK, the block's contact substeps and
the step's info), from the program's tracer, under the ``step.arm``
roots."""

from perfbench.harness.program import span_ms
from perfbench.systems.pusharm import ROOT_SPAN


def read(ctx):
    return span_ms(ctx, ["physics"], root=ROOT_SPAN)
