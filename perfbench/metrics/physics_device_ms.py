"""Device ms a step of the kernels the physics layer
(``pusht.control_step``) launches."""

from perfbench.harness.readers import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ["physics"])
