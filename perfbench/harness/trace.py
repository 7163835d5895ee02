"""Spans around the program's layer calls, the captured kernel inputs, and
the reading of a device trace.

A span wraps a module attribute of the program for the length of a run: it
adds the host time of every call to its total and marks the call with
``torch.profiler.record_function``, so that a device trace names what the
host was doing in each idle gap.  Nothing in the program changes.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from collections import defaultdict


class Spans:
    """Host seconds and calls per span name."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)

    def wrap(self, name: str, fn):
        import torch

        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*args, **kw)
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1
            return out
        return wrapped

    def reset(self):
        self.seconds.clear()
        self.calls.clear()

    def copy(self) -> "Spans":
        out = Spans()
        out.seconds.update(self.seconds)
        out.calls.update(self.calls)
        return out


def resolve(target: str):
    """``"package.module:attr"`` → (module, attr)."""
    mod, attr = target.split(":")
    return importlib.import_module(mod), attr


@contextlib.contextmanager
def patched(pairs):
    """Set each (module, attr) of ``pairs`` (a dict → new value) for the
    block, and put the old values back after it."""
    old = {k: getattr(*k) for k in pairs}
    for (m, a), fn in pairs.items():
        setattr(m, a, fn)
    try:
        yield old
    finally:
        for (m, a), fn in old.items():
            setattr(m, a, fn)


class Captures:
    """The arguments of every call to the program functions named by
    ``targets`` while ``on`` is set."""

    def __init__(self, targets):
        self.targets = sorted(set(targets))
        self.args = defaultdict(list)
        self.on = False

    def wrappers(self, current):
        """{(module, attr): wrapper} around the ``current`` functions."""
        out = {}
        for t in self.targets:
            key = resolve(t)
            fn = current.get(key, getattr(*key))

            def wrapped(*args, _fn=fn, _t=t, **kw):
                if self.on:
                    self.args[_t].append(args)
                return _fn(*args, **kw)
            out[key] = wrapped
        return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class DeviceTrace:
    """What one profiled window holds: device busy seconds, the window's
    length, device seconds per kernel name, device seconds per span (of
    the kernels launched while the host was inside it, innermost span
    first), the longest idle gaps named by the innermost span the host was
    in, and the top device operations."""

    def __init__(self, busy_s, window_s, kernel_s, gaps, span_s=None):
        self.busy_s = busy_s
        self.window_s = window_s
        self.kernel_s = kernel_s
        self.gaps = gaps
        self.span_s = span_s or {}

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose name holds one of
        ``names``."""
        return sum(s for k, s in self.kernel_s.items()
                   if any(n in k for n in names))

    def breakdown(self, top: int = 10) -> dict:
        """The top device operations by device seconds, and the idle
        seconds summed by what the host was doing."""
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        by, n = defaultdict(float), defaultdict(int)
        for name, s in self.gaps:
            by[name] += s
            n[name] += 1
        gaps = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:120], s] for k, s in ops],
                "idle_gaps": [[f"{k} ({n[k]} gaps)", s] for k, s in gaps]}


WINDOW = "perfbench.window"


def read_profile(prof, span_names) -> DeviceTrace:
    """A :class:`DeviceTrace` of a ``torch.profiler.profile`` whose steps
    ran inside a ``record_function(WINDOW)``."""
    from torch.autograd import DeviceType
    win = None
    device, spans, launches = [], [], []
    marks = set(span_names) | {WINDOW}
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            # the spans' own marks on the device's timeline are no work
            if e.name not in marks and not getattr(e, "is_user_annotation",
                                                   False):
                device.append((tr.start, tr.end, e.name))
        else:
            if e.name == WINDOW:
                win = (tr.start, tr.end)
            elif e.name in span_names:
                spans.append((tr.start, tr.end, e.name))
            # the host op (or, for an extension's launch, the span) that
            # the kernels are linked to; not the runtime's own calls
            if e.kernels and not e.name.startswith("cu"):
                launches.append((tr.start,
                                 sum(k.duration for k in e.kernels)))
    if win is None:
        raise RuntimeError("the profile holds no window span")
    w0, w1 = win
    kernel_s = defaultdict(float)
    inside = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            kernel_s[name] += (e - s) * 1e-6
            inside.append((s, e))
    busy = _union(inside)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = []
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        host = [(ss, ee, n) for ss, ee, n in spans if ss <= mid <= ee]
        # the innermost span: the latest to start
        name = max(host)[2] if host else "outside the spans"
        gaps.append((name, (e - s) * 1e-6))
    return DeviceTrace(sum(e - s for s, e in busy) * 1e-6, (w1 - w0) * 1e-6,
                       dict(kernel_s), gaps, span_seconds(launches, spans))


def span_seconds(launches, spans) -> dict:
    """Device seconds per span name: each (host start, device µs) launch
    goes to the innermost span whose host interval holds its start."""
    out = defaultdict(float)
    for t, us in launches:
        host = [(ss, ee, n) for ss, ee, n in spans if ss <= t <= ee]
        if host:
            out[max(host)[2]] += us * 1e-6
    return dict(out)


class DeviceBusy:
    """The device's busy seconds and the frames done over a run of steps,
    each step profiled by itself with the device's activity alone (a
    session keeps at most ~128 MB of device records, some eight steps of
    this path, so one session a step).  Now and then the profiler drops
    some of a step's device records, and a step's busy time is then not
    known: a step whose kernels recorded fall short of its kernel launches
    by more than the least shortfall of any step is left out of both sums.
    (Some launches put no kernel on the device at all, so a shortfall that
    every step has is the program's, not the profiler's.)  Call
    ``start()`` before a step and ``stop(frames)`` once the device has
    finished it."""

    def __init__(self):
        self.steps = []     # (busy s, kernels recorded, launches, frames)
        self._prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()

    def stop(self, frames: int):
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self.steps.append((*device_busy(prof.profiler.kineto_results
                                        .events()), frames))

    def whole(self) -> list:
        """The steps whose device records are whole."""
        if not self.steps:
            return []
        least = min(n - k for _, k, n, _ in self.steps)
        return [s for s in self.steps if s[2] - s[1] <= least]

    @property
    def busy_s(self) -> float:
        return sum(s[0] for s in self.whole())

    @property
    def frames(self) -> int:
        return sum(s[3] for s in self.whole())


def device_busy(events) -> tuple:
    """(busy seconds, kernels recorded, kernel launches) of a profile's raw
    events: the union of every kernel's, copy's and fill's time on the
    device, the count of its kernels, and the count of the host's calls
    that launched kernels."""
    from torch.autograd import DeviceType
    iv, kernels, launched = [], 0, 0
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                iv.append((e.start_ns(), e.start_ns() + e.duration_ns()))
                kernels += not e.name().startswith(("Memcpy", "Memset"))
        elif "LaunchKernel" in e.name():
            launched += 1
    return sum(e - s for s, e in _union(iv)) * 1e-9, kernels, launched


def profile_steps(step, n: int, span_names, sync):
    """Run ``step()`` ``n`` times under the profiler (host and device
    activity) and read the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            for _ in range(n):
                step()
            sync()
    return read_profile(prof, span_names)
