"""Device ms a traced step of the trainer's optimizer
(``train.optimizer``: ‖∇means‖ and Adam's update of the six fields)."""

from perfbench.harness import program  # noqa: F401  (the program's spans on)
from perfbench.harness.readers import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ["train.optimizer"])
