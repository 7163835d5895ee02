"""One run of one cell: set-up, the measured window, the traced window,
the correctness check, and the result line.

Everything a cell needs is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``perfbench/configs/<config>
.json``: the sizes and the correctness limits) and its traffic mix
(``perfbench/traffic/<mix>.json``), which names the system that drives the
program (``perfbench/systems/<system>.py``, with its plain reference in
``perfbench/reference/``); every metric, end-to-end or per-layer, is read
by ``perfbench/metrics/<metric>.py`` or by the reader of its kind, and each
kernel's roofline count is ``perfbench/roofline/<kernel>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import time
from pathlib import Path

import torch

from perfbench.harness import guard, stats
from perfbench.harness import traffic as traffic_gen
from perfbench.harness import trace as tr

ROOT = Path(__file__).resolve().parent.parent
CONFIG_DIR = ROOT / "configs"
METRIC_DIR = ROOT / "metrics"


def load_config(name: str, root: Path = CONFIG_DIR) -> dict:
    path = root / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no configuration {name!r} ({path})")
    return json.loads(path.read_text())


def find_cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def cell_metrics(bench: dict, workload: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries the cell reports."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def load_metric(name: str, root: Path = METRIC_DIR):
    """The reader of metric ``name``: ``perfbench/metrics/<name>.py``, or
    where there is none, the reader of its kind, named by the part before
    the first dot (``physics_ms.py`` for ``physics_ms.train``).  A module
    with ``read(ctx)``, which returns None where it finds nothing to read,
    and optionally ``CAPTURES``, the program calls whose arguments it
    reads."""
    path = root / f"{name}.py"
    if not path.is_file():
        path = root / f"{name.split('.')[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Context:
    """What a metric reads: the set-up's seconds; the measured window's
    steps, frames, seconds, span totals and, where a metric of the run is
    taken from the device, its profiled steps (a ``trace.DeviceBusy``);
    the traced steps' device trace and captured kernel inputs."""

    def __init__(self, setup_s, steps, frames, window_s, spans, trace=None,
                 captures=None, trace_steps=0, window_device=None):
        self.setup_s = setup_s
        self.steps = steps
        self.frames = frames
        self.window_s = window_s
        self.spans = spans
        self.trace = trace
        self.captures = captures or {}
        self.trace_steps = trace_steps
        self.window_device = window_device


def device_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def _no_forbidden_modules():
    loaded = guard.forbidden_loaded()
    if loaded:
        raise RuntimeError(f"modules loaded that a run may not hold: {loaded}")


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", t_start=None, log=print,
             metric_dir: Path = METRIC_DIR, config_dir: Path = CONFIG_DIR,
             traffic_dir: Path = traffic_gen.TRAFFIC_DIR) -> dict:
    """Run ``workload`` once and return its result line (a dict)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bad = guard.reference_violations()
    if bad:
        raise RuntimeError(f"the reference imports {bad}")
    cell = find_cell(bench, workload)
    cfg = load_config(cell["config"], config_dir)
    mix = traffic_gen.load(cell["traffic"], traffic_dir)
    system_mod = importlib.import_module(f"perfbench.systems.{mix['system']}")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    clock = stats.Clock(sync)

    wanted = cell_metrics(bench, workload,
                          "per_layer" if trace else "end_to_end")
    # an end-to-end metric of the device's time: the window's every step
    # runs under the profiler (its host overhead does not touch the
    # device's busy time)
    busy = (tr.DeviceBusy() if not trace and device.type == "cuda" and any(
        m["source"] == "device_trace" for m in wanted) else None)
    readers = {m["name"]: load_metric(m["name"], metric_dir) for m in wanted}
    spans = tr.Spans()
    captures = tr.Captures([t for r in readers.values()
                            for t in getattr(r, "CAPTURES", ())])
    wrap = {}
    for name, target in system_mod.SPANS.items():
        key = tr.resolve(target)
        wrap[key] = spans.wrap(name, getattr(*key))
    wrap.update(captures.wrappers(wrap))
    with tr.patched(wrap):
        system = system_mod.System(cfg, mix, seed, device, spans=spans)
        system.step()                        # every shape of the cell, built
        sync()
        if busy is not None:                 # the profiler's own start-up
            t_prof = time.perf_counter()
            busy.start()
            torch.zeros(1, device=device).add_(1)
            sync()
            busy.stop(0)
            busy = tr.DeviceBusy()
            log(f"profiler start-up: {time.perf_counter() - t_prof:.3f} s")
        system.restart()
        spans.reset()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = clock.now()
        cpu0 = time.process_time()
        setup_s = t0 - t_start
        frames = steps = 0
        ends = [t0]
        while True:
            if busy is not None:
                busy.start()
            done = system.step()
            frames += done
            steps += 1
            ends.append(clock.now())
            if busy is not None:
                busy.stop(done)
                ends[-1] = time.perf_counter()
            if ends[-1] - t0 >= seconds:
                break
        window_s = ends[-1] - t0
        step_ms = sorted((b - a) * 1e3 for a, b in zip(ends, ends[1:]))
        log(f"window: {steps} steps, step ms min {step_ms[0]:.1f} median "
            f"{stats.percentile(step_ms, 50):.1f} max {step_ms[-1]:.1f}; "
            f"host CPU {time.process_time() - cpu0:.2f} s of "
            f"{window_s:.2f} s")
        if busy is not None:
            log(f"device: busy {busy.busy_s:.6f} s for {busy.frames} "
                f"frames; a step, ms, kernels recorded/launched: "
                + ", ".join(f"{b * 1e3:.3f} {n}/{k}"
                            for b, n, k, _ in busy.steps))
        failed_steps, severe = system.counters()
        window_spans = spans.copy()      # the traced steps add to ``spans``
        dtrace = None
        if trace:
            captures.on = True
            dtrace = tr.profile_steps(system.step, int(mix["trace_steps"]),
                                      system_mod.SPAN_NAMES, sync)
            captures.on = False
    dev_info = device_info(device)
    _no_forbidden_modules()
    ctx = Context(setup_s, steps, frames, window_s, window_spans, dtrace,
                  captures.args, int(mix["trace_steps"]), busy)
    metrics = {}
    for m in wanted:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if trace:
        dev_info.update(busy_s=dtrace.busy_s, window_s=dtrace.window_s)
    # the check: once the window has closed and the peak has been read
    system.release()
    captures.args.clear()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = dict(system.check(), severe=severe)
    checks = {k: {"value": readings.get(k, float("inf")),
                  "limit": cfg["limits"][k]} for k in system.readings}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    log(f"check: {time.perf_counter() - t_check:.1f} s, steps {steps}, "
        f"window {window_s:.3f} s, set-up {setup_s:.3f} s")
    for k, c in checks.items():
        log(f"{k} {c['value']!r} limit {c['limit']!r}")
    _no_forbidden_modules()
    line = {"correct": bool(correct), "attempted": frames,
            "failed": failed_steps * system.B, "metrics": metrics,
            "device": dev_info}
    if trace:
        line["breakdown"] = dtrace.breakdown()
    line["checks"] = checks
    return line
