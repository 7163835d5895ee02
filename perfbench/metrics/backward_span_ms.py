"""Host ms a window step in the program's ``step.backward`` span (the
``torch.autograd.grad`` call of the train step: autograd's backward with
K2b and K1b)."""

from perfbench.harness.program import span_ms


def read(ctx):
    return span_ms(ctx, ["step.backward"])
