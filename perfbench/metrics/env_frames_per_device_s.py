"""Env frames completed in the measured window over the seconds in which
the device ran their work (the union of its kernels', copies' and fills'
times, each step profiled, ``trace.DeviceBusy``): the frames a second the
card gives where it is kept busy, which the host's speed does not touch."""


def read(ctx):
    d = ctx.window_device
    if d is None or d.busy_s <= 0:
        return None
    return d.frames / d.busy_s
