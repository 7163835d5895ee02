"""The arithmetic of the end-to-end metrics: a synchronising clock, a rate
over a whole window and a percentile by nearest rank."""

from __future__ import annotations

import math
import time


class Clock:
    """Host clock that waits for the device before it reads: ``now()``
    synchronises ``sync`` (a callable, e.g. ``torch.cuda.synchronize``)
    first, so a time spans the device's work and not only its enqueue."""

    def __init__(self, sync=None):
        self.sync = sync

    def now(self) -> float:
        if self.sync is not None:
            self.sync()
        return time.perf_counter()


def rate(count: float, seconds: float) -> float:
    """Work completed per second over a whole window."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return count / seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile by nearest rank: the smallest value with at
    least q % of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]

