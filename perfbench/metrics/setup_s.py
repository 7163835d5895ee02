"""Seconds from the process's start to the measured window: imports, the
scene from the seed, the kernels' load (their build in a checkout's first
run) and one warm step of the cell's shapes."""


def read(ctx):
    return ctx.setup_s
