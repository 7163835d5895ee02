"""Device ms a step of the kernels the arm's render layer launches under
the harness's ``render.cameras`` span (both cameras of the collect step:
posing, projection, SH, binning, the moving camera's reprojection and the
composites; the end-effector caches' builds run outside it)."""

from perfbench.harness.readers import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ["render.cameras"])
