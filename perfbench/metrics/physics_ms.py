"""Host ms a step in the physics layer (``pusht.control_step``)."""

from perfbench.harness.readers import span_ms


def read(ctx):
    return span_ms(ctx, ["physics"])
