"""Env frames completed in the measured window over the window's seconds
(host clock, the device synchronised at both ends and after every step)."""

from perfbench.harness.stats import rate


def read(ctx):
    return rate(ctx.frames, ctx.window_s)
