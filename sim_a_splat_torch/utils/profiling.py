"""Profiling: the program's tracer, a device-trace context and a steady-state
timer.

Port of ``sim_a_splat_tpu/utils/profiling.py`` (``torch.profiler`` in place
of ``jax.profiler``; the trace is a Chrome trace, which Perfetto reads),
grown into the port's one tracer.

The tracer
----------
``span(name)`` marks a layer of the program, as a context manager or as a
decorator; ``count(name, n)`` adds to a named counter.  Tracing is off by
default, and then a span costs one check of a module-level flag: no clock
read, no allocation, no ``record_function``.  It is turned on by
:func:`enable`, or from import by the environment variable
``SIM_A_SPLAT_TRACE=<path>``, the operator's switch: the spans are then
written to ``<path>`` at exit (:func:`export`).

On, each span records its name, its start and end from ``time.time_ns()``
(the clock of ``torch.profiler``'s raw events, so the spans line up with
the kernels of a device trace), its parent, and its step: each root span
opens a new step, and every span under it carries that step's id, on any
thread.  Stacks of open spans are kept per thread.  A span opened on a
thread with no open span takes as its parent the innermost span open on
the thread whose root span is open: on the card autograd runs ``backward``
on its own device thread, and its spans so nest under the span around the
``torch.autograd.grad`` call.  While a profiler is active a span also
enters ``torch.profiler.record_function(name)``, so it sits on the
profiler's timeline beside the kernels; with none it skips that (~12 µs a
span on a CPU host).  ``launches`` counts the kernels' launches by
operator name (the kernels' launch helper adds to it, on or off); a root
span records, as counter events named after the operators at its end, the
change of each over its step.  Nothing here synchronises the device or
reads a device tensor.

Memory: the finished spans are kept in a buffer of the last ``CAPACITY``
(65,536: ~1,600 steps of the batched train step's ~40 spans, ~15 MB), and
the counter events in another of the same bound; older records are
dropped, and counted (:func:`dropped`).  :func:`roots` reads the spans
grouped by root; :func:`export` writes them as Chrome trace JSON.

``device_trace`` with tracing on also writes ``idle_by_span.json``: the
window's device-idle seconds by the innermost span the host was in at each
idle gap's midpoint (:func:`idle_by_span`).

Work on a CUDA device is asynchronous: a host clock read without a
synchronise measures the enqueue.  So ``device_trace`` and ``time_jitted``
synchronise the device before they read the clock; a span does not, and
its seconds are the host's.
"""

from __future__ import annotations

import atexit
import bisect
import collections
import contextlib
import functools
import itertools
import json
import os
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

CAPACITY = 1 << 16      # spans kept, and counter events kept
OUTSIDE = "outside every span"
# the kernels' launches since the process started, by operator name (e.g.
# "composite_static", "pusht_step"); read differences of it
launches: collections.Counter = collections.Counter()


class Record(NamedTuple):
    """A finished span: times in ``time.time_ns()`` nanoseconds; ``parent``
    the id of its parent span (None for a root); ``thread`` the native id
    of the thread it ran on."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    step: int
    thread: int


class Count(NamedTuple):
    """A counter event: the counter's value at ``ts_ns`` (for an
    operator's name, its launches in the root step that ended then)."""
    name: str
    ts_ns: int
    value: int
    step: int | None


class Root(NamedTuple):
    """A root span with its descendants: ``seconds`` the root's; ``self_s``
    the part of it that no child span covers; ``by_name`` the descendants'
    seconds and ``calls`` their number, by name."""
    name: str
    step: int
    seconds: float
    self_s: float
    by_name: dict
    calls: dict


_on = False
_lock = threading.Lock()
_local = threading.local()
_owner = None              # the span stack of the thread whose root is open
_ids = itertools.count()
_steps = itertools.count()
_spans = collections.deque(maxlen=CAPACITY)
_counts = collections.deque(maxlen=CAPACITY)
_totals: dict = {}
_finished = [0, 0]         # spans and counter events ever recorded
_off: dict = {}            # name → the span object handed out while off


def enable(on: bool = True) -> None:
    """Turn tracing on (or off).  Records already taken are kept."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def clear() -> None:
    """Forget every record and counter total (the buffers take the
    current ``CAPACITY``)."""
    global _spans, _counts
    with _lock:
        _spans = collections.deque(maxlen=CAPACITY)
        _counts = collections.deque(maxlen=CAPACITY)
        _totals.clear()
        _finished[:] = [0, 0]


def _stack() -> list:
    """This thread's stack of open spans."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        _local.tid = threading.get_native_id()
        return _local.stack


def _innermost(stack):
    """The open span a new span on this thread nests under, or None."""
    if stack:
        return stack[-1]
    owner = _owner
    if owner is not None and owner is not stack:
        try:
            return owner[-1]
        except IndexError:       # the root closed meanwhile
            return None
    return None


def _traced(name: str, fn):
    @functools.wraps(fn)
    def traced(*args, **kwargs):
        if not _on:
            return fn(*args, **kwargs)
        with _Span(name):
            return fn(*args, **kwargs)
    return traced


class _Off:
    """What ``span`` hands out while tracing is off: a context manager that
    does nothing, and a decorator like ``_Span``'s."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _traced(self.name, fn)


class _Span:
    """One open span (tracing on)."""
    __slots__ = ("name", "step", "id", "_parent", "_stack", "_rf", "_t0",
                 "_c0")

    def __init__(self, name: str):
        self.name = name

    def __call__(self, fn):
        return _traced(self.name, fn)

    def __enter__(self):
        global _owner
        stack = _stack()
        top = _innermost(stack)
        if top is None:
            self.step = next(_steps)
            self._parent = None
            self._c0 = launches.copy()
            _owner = stack
        else:
            self.step = top.step
            self._parent = top.id
        self.id = next(_ids)
        self._stack = stack
        stack.append(self)
        self._t0 = time.time_ns()
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        global _owner
        if self._rf is not None:
            self._rf.__exit__(*exc)
        t1 = time.time_ns()
        self._stack.pop()
        # a plain tuple here (a Record costs more); ``records`` names it
        rec = (self.name, self._t0, t1, self.id, self._parent, self.step,
               _local.tid)
        with _lock:
            _spans.append(rec)
            _finished[0] += 1
        if self._parent is None:
            if _owner is self._stack:
                _owner = None
            now = launches.copy()
            with _lock:
                for name, v in now.items():
                    _counts.append(Count(name, t1, v - self._c0[name],
                                         self.step))
                    _finished[1] += 1
        return False


def span(name: str):
    """A span named ``name``: ``with span(name): ...``, or ``@span(name)``
    on a function (every call is a span).  Off, the context manager is one
    object per name, made at its first use, that does nothing."""
    if _on:
        return _Span(name)
    off = _off.get(name)
    if off is None:
        off = _off[name] = _Off(name)
    return off


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` and record its new value as a
    counter event (tracing on; off it does nothing)."""
    if not _on:
        return
    top = _innermost(_stack())
    with _lock:
        v = _totals[name] = _totals.get(name, 0) + n
        _counts.append(Count(name, time.time_ns(), v,
                             None if top is None else top.step))
        _finished[1] += 1


def records() -> list:
    """The finished spans kept, in the order they ended."""
    with _lock:
        return [Record(*r) for r in _spans]


def counter_events() -> list:
    """The counter events kept, in the order they were recorded."""
    with _lock:
        return list(_counts)


def dropped() -> tuple:
    """(spans, counter events) dropped from the full buffers."""
    with _lock:
        return _finished[0] - len(_spans), _finished[1] - len(_counts)


def _covered(intervals, lo, hi) -> int:
    """Nanoseconds of [lo, hi] that the union of ``intervals`` covers."""
    total, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def roots(name: str | None = None, last: int | None = None) -> list:
    """The finished root spans (named ``name``, or all), the last ``last``
    of them, oldest first, each a :class:`Root` with its descendants'
    seconds by name."""
    recs = records()
    members = collections.defaultdict(list)
    for r in recs:
        members[r.step].append(r)
    picked = [r for r in recs
              if r.parent is None and (name is None or r.name == name)]
    if last is not None:
        picked = picked[max(len(picked) - last, 0):] if last > 0 else []
    out = []
    for r in picked:
        by_name = collections.defaultdict(float)
        calls = collections.defaultdict(int)
        children = []
        for m in members[r.step]:
            if m.id == r.id:
                continue
            by_name[m.name] += (m.end_ns - m.start_ns) * 1e-9
            calls[m.name] += 1
            if m.parent == r.id:
                children.append((m.start_ns, m.end_ns))
        seconds = (r.end_ns - r.start_ns) * 1e-9
        self_s = seconds - _covered(children, r.start_ns, r.end_ns) * 1e-9
        out.append(Root(r.name, r.step, seconds, self_s, dict(by_name),
                        dict(calls)))
    return out


def export(path) -> None:
    """Write the kept spans and counter events to ``path`` as Chrome trace
    JSON: spans as "X" events (args: step, id, parent), counters as "C"
    events.  ``ts`` is in microseconds after ``baseTimeNanoseconds`` on
    the ``time.time_ns()`` clock, the convention of ``torch.profiler``'s
    own export (``trace.json``), so both lie on one timeline."""
    spans, counts = records(), counter_events()
    starts = [r.start_ns for r in spans] + [c.ts_ns for c in counts]
    base = min(starts) // 10**9 * 10**9 if starts else 0
    pid = os.getpid()
    events = [{"name": r.name, "cat": "span", "ph": "X",
               "ts": (r.start_ns - base) / 1e3,
               "dur": (r.end_ns - r.start_ns) / 1e3, "pid": pid,
               "tid": r.thread,
               "args": {"step": r.step, "id": r.id, "parent": r.parent}}
              for r in spans]
    events += [{"name": c.name, "cat": "counter", "ph": "C",
                "ts": (c.ts_ns - base) / 1e3, "pid": pid,
                "args": {"value": c.value}} for c in counts]
    n_spans, n_counts = dropped()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({
        "traceEvents": events, "displayTimeUnit": "ms",
        "baseTimeNanoseconds": base,
        "otherData": {"clock": "time.time_ns", "capacity": CAPACITY,
                      "dropped_spans": n_spans,
                      "dropped_counter_events": n_counts}}))


def _union(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def idle_by_span(events, t0_ns: int, t1_ns: int) -> dict:
    """The device's idle seconds in [t0_ns, t1_ns], and their gaps, by the
    innermost span the host was in at each gap's midpoint (the latest to
    start of the spans that hold it, on any thread), or ``OUTSIDE``.
    ``events`` are a profile's raw events
    (``prof.profiler.kineto_results.events()``): their device records give
    the busy intervals, on the tracer's clock.  ``record_function_lag_us``
    is the median of each span's ``record_function`` event's start less
    the span's recorded start (a few µs where the clocks agree)."""
    from torch.autograd import DeviceType
    busy, marks = [], collections.defaultdict(list)
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                busy.append((max(e.start_ns(), t0_ns),
                             min(e.start_ns() + e.duration_ns(), t1_ns)))
        elif e.is_user_annotation():
            marks[e.name()].append(e.start_ns())
    busy = _union([(s, e) for s, e in busy if e > s])
    spans = sorted((r for r in records()
                    if r.end_ns >= t0_ns and r.start_ns <= t1_ns),
                   key=lambda r: r.start_ns)
    starts = [r.start_ns for r in spans]
    idle = collections.defaultdict(lambda: [0.0, 0])
    edges = [t0_ns] + [x for iv in busy for x in iv] + [t1_ns]
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) // 2
        name = OUTSIDE
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0:
            if spans[i].end_ns >= mid:
                name = spans[i].name
                break
            i -= 1
        idle[name][0] += (e - s) * 1e-9
        idle[name][1] += 1
    lags = []
    by_name = collections.defaultdict(list)
    for r in spans:
        by_name[r.name].append(r.start_ns)
    for name, ours in by_name.items():
        theirs = sorted(marks.get(name, []))
        if len(theirs) == len(ours):
            lags += [(b - a) * 1e-3 for a, b in zip(sorted(ours), theirs)]
    lags.sort()
    busy_s = sum(e - s for s, e in busy) * 1e-9
    window_s = (t1_ns - t0_ns) * 1e-9
    return {
        "window_s": window_s, "busy_s": busy_s, "idle_s": window_s - busy_s,
        "gaps": sum(n for _, n in idle.values()),
        "record_function_lag_us": lags[len(lags) // 2] if lags else None,
        "by_span": {k: {"idle_s": v[0], "gaps": v[1]} for k, v in
                    sorted(idle.items(), key=lambda kv: -kv[1][0])},
    }


def _synchronize(tree=None) -> None:
    """Wait for the CUDA work behind ``tree`` (every CUDA device's work
    when ``tree`` is None)."""
    if not torch.cuda.is_available():
        return
    if tree is None:
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        return
    # imported here: the parallel layer imports the ops, which import this
    from sim_a_splat_torch.parallel.mesh import tree_map
    devices = set()
    tree_map(lambda a: devices.add(a.device)
             if torch.is_tensor(a) and a.is_cuda else None, tree)
    for d in devices:
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def device_trace(logdir: str | Path):
    """``torch.profiler`` trace of the host and CUDA activity inside the
    context, written to ``<logdir>/trace.json`` (Chrome trace format); with
    tracing on, also ``<logdir>/idle_by_span.json``
    (:func:`idle_by_span` of the context's window)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        t0 = time.time_ns()
        try:
            yield prof
        finally:
            _synchronize()
            t1 = time.time_ns()
    prof.export_chrome_trace(str(logdir / "trace.json"))
    if _on:
        idle = idle_by_span(prof.profiler.kineto_results.events(), t0, t1)
        (logdir / "idle_by_span.json").write_text(json.dumps(idle, indent=1))


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


_PATH = os.environ.get("SIM_A_SPLAT_TRACE")
if _PATH:
    _on = True
    atexit.register(export, Path(_PATH).resolve())
