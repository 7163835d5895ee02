"""Percent of a step in which the device ran nothing: the traced steps'
device-busy seconds against the measured window's seconds a step."""

from perfbench.harness.readers import idle_share


def read(ctx):
    return idle_share(ctx)
