"""Host ms a window step in the program's ``step.train`` span that none of
its child spans covers."""

from perfbench.harness.program import self_ms


def read(ctx):
    return self_ms(ctx)
