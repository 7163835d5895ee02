"""Host ms a window step in the program's ``physics`` span
(``pusht.control_step``), from the program's tracer."""

from perfbench.harness.program import span_ms


def read(ctx):
    return span_ms(ctx, ["physics"])
