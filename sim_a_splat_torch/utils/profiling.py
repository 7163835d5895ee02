"""Profiling and timing harness.

Port of ``sim_a_splat_tpu/utils/profiling.py``: a device-trace context
(``torch.profiler`` in place of ``jax.profiler``; the trace is written as
a Chrome trace, which Perfetto reads), a steady-state timer that separates
the first call from the timed ones, and a named-section accumulator.

Work on a CUDA device is asynchronous: a host clock read without a
synchronise measures the enqueue.  So every timer here synchronises the
device before it reads the clock, where the work ran on one.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import torch

from sim_a_splat_torch.parallel.mesh import tree_map


def _synchronize(tree=None) -> None:
    """Wait for the CUDA work behind ``tree`` (every CUDA device's work
    when ``tree`` is None)."""
    if not torch.cuda.is_available():
        return
    if tree is None:
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        return
    devices = set()
    tree_map(lambda a: devices.add(a.device)
             if torch.is_tensor(a) and a.is_cuda else None, tree)
    for d in devices:
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def device_trace(logdir: str | Path):
    """``torch.profiler`` trace of the host and CUDA activity inside the
    context, written to ``<logdir>/trace.json`` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _synchronize()
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


def time_jitted(fn, *args, iters: int = 10, warmup: int = 1,
                name: str | None = None, log=print):
    """Time a callable: the first call alone (where the reference compiles;
    here the port builds and loads its kernels on first use), then
    ``warmup - 1`` untimed calls, then ``iters`` timed calls.  The name is
    the reference's, kept so callers find it; nothing is jitted.

    Returns (mean_seconds, result_of_last_call).  The device is
    synchronised on the result before each clock read, so the numbers are
    wall-clock per call including dispatch."""
    t0 = time.perf_counter()
    out = fn(*args)
    _synchronize(out)
    first_s = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        out = fn(*args)
    _synchronize(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _synchronize(out)
    mean_s = (time.perf_counter() - t0) / iters
    if name and log:
        log(f"{name}: {mean_s * 1e3:.2f} ms/call (first call {first_s:.1f}s)")
    return mean_s, out


class Timer:
    """Named-section wall-clock accumulator (host-side).  A section given
    ``block_on`` (a tensor or a tree of them) waits for the device work
    behind it before the clock is read."""

    def __init__(self):
        self.totals: dict = {}
        self.counts: dict = {}

    @contextlib.contextmanager
    def section(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {
            k: {"total_s": v, "calls": self.counts[k],
                "mean_ms": 1e3 * v / self.counts[k]}
            for k, v in sorted(self.totals.items(),
                               key=lambda kv: -kv[1])
        }

    def report(self, log=print):
        for k, v in self.summary().items():
            log(f"{k:32s} {v['mean_ms']:9.2f} ms × {v['calls']}")

    def dump(self, path: str | Path):
        Path(path).write_text(json.dumps(self.summary(), indent=2))
