"""Host ms a window step in the program's ``train.refine`` spans (the cull
rounds, one every ``refine_every`` steps), spread over the window's
``step.splat`` roots."""

from perfbench.harness.program import span_ms
from perfbench.systems.splatfacto import ROOT_SPAN


def read(ctx):
    return span_ms(ctx, ["train.refine"], root=ROOT_SPAN)
