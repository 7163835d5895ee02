"""Host ms a window step in the program's ``render.moving_build`` spans
(the end-effector camera's candidate-cache builds: an episode's first and
each rebuild past the margin budget), spread over the window's
``step.arm`` roots; 0 where the window built none."""

from perfbench.harness.program import window_roots
from perfbench.systems.pusharm import ROOT_SPAN


def read(ctx):
    roots = window_roots(ctx, ROOT_SPAN)
    if not roots:
        return None
    return sum(r.by_name.get("render.moving_build", 0.0)
               for r in roots) / len(roots) * 1e3
