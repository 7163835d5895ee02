"""Host ms a window step in the program's ``render.cameras`` span (the
render of both cameras of the arm's collect step: the viewport through K2,
the end-effector camera through K3), under the ``step.arm`` roots."""

from perfbench.harness.program import span_ms
from perfbench.systems.pusharm import ROOT_SPAN


def read(ctx):
    return span_ms(ctx, ["render.cameras"], root=ROOT_SPAN)
