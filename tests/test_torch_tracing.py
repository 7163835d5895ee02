"""The port's tracer (``sim_a_splat_torch/utils/profiling.py``): spans and
counters at the layer boundaries of the batched pushT step and its train
step, on a tiny scene on the CPU.

Off, a span records nothing and marks nothing on a profiler's timeline;
on, every span of the step appears under its parent with its step's id,
on the clock of the profiler's raw events, and the step's outputs are the
same bit for bit.  The card's own case (autograd's device thread) is the
one test marked ``cuda``.
"""

import json
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from sim_a_splat_torch import entry
from sim_a_splat_torch.ops import _kernels
from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
from sim_a_splat_torch.physics import pusht
from sim_a_splat_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
RES = 64
B = 3

# span → the names its parent may have in the batched step (None: a root)
PARENTS = {
    "step.train": {None},
    "step.backward": {"step.train"},
    "step.batch": {"step.train", None},
    "render.prepare": {"step.train", None},
    "render.tile_cache": {"render.prepare"},
    "render.k1f": {"render.prepare"},
    "physics": {"step.batch"},
    "physics.contacts": {"physics"},
    "physics.solve": {"physics"},
    "render.pose": {"step.batch"},
    "render.sh": {"step.batch", "render.prepare"},
    "render.select": {"step.batch"},
    "render.project": {"render.select", "render.tile_cache"},
    "render.bin": {"render.select", "render.tile_cache"},
    "render.tiles": {"render.select"},
    "render.gather": {"render.select"},
    "render.k2f": {"render.select"},
    "render.k2b": {"step.backward"},
    "render.k1b": {"step.backward"},
}


@pytest.fixture(autouse=True)
def tracer():
    """Each test starts with tracing off and no records, and leaves the
    tracer as it found it."""
    was = profiling.enabled()
    profiling.enable(False)
    profiling.clear()
    yield profiling
    profiling.enable(was)
    profiling.clear()


@pytest.fixture(scope="module")
def step_inputs():
    graph = entry.build_scene(n_bg=256, n_block=64, n_agent=32, seed=0,
                              sh_degree=3, device="cpu")
    raster = RasterConfig(tile_size=16, tile_capacity=128,
                          max_tiles_per_gaussian=16, sigma_cutoff=3.0,
                          term_eps=1e-4)
    prepare, step_batch, params = entry.make_step_cached_batch(
        graph, RES, RES, raster, dyn_capacity=128, sel_tiles=8,
        dyn_max_tiles=9, device="cpu")
    states = pusht.reset(params, torch.Generator().manual_seed(0), B)
    actions = states.agent_pos + torch.tensor([6.0, -4.0])
    return prepare, step_batch, graph.scene, states, actions


def _run(step_inputs):
    """One train step and one forward step: (train outputs, forward
    outputs)."""
    prepare, step_batch, scene, states, actions = step_inputs
    train = entry.loss_and_grads(prepare, step_batch, scene, states, actions)
    fwd = step_batch(prepare(scene), scene, states, actions)
    return train, fwd


def _by_id():
    return {r.id: r for r in profiling.records()}


def test_off_records_nothing_and_marks_no_profile(step_inputs):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(step_inputs)
    assert profiling.records() == [] and profiling.counter_events() == []
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not names & set(PARENTS)


def test_off_is_one_flag_check(monkeypatch):
    """Off, a span reads no clock, enters no ``record_function`` and makes
    no object after its name's first use; a decorated call goes straight
    through."""
    def boom(*a, **k):
        raise AssertionError("called with tracing off")

    class NoClock:
        time_ns = staticmethod(boom)
    monkeypatch.setattr(profiling, "time", NoClock)
    monkeypatch.setattr(torch.profiler, "record_function", boom)

    @profiling.span("decorated")
    def f(x):
        return x + 1

    assert profiling.span("a") is profiling.span("a")
    with profiling.span("a"):
        assert f(1) == 2
    profiling.count("n", 3)
    assert profiling.records() == [] and profiling.counter_events() == []


def test_every_span_under_its_parent(step_inputs):
    profiling.enable(True)
    _run(step_inputs)
    recs = profiling.records()
    by_id = _by_id()
    seen = set()
    for r in recs:
        parent = None if r.parent is None else by_id[r.parent]
        if r.name in PARENTS:
            assert (parent and parent.name) in PARENTS[r.name], r
            seen.add(r.name)
        if parent is not None:
            assert parent.step == r.step
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
    assert seen == set(PARENTS)
    # one train root and the forward step's two roots, each its own step
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["step.train", "render.prepare",
                                       "step.batch"]
    assert len({r.step for r in roots}) == 3
    train = profiling.roots("step.train")[0]
    assert train.calls["physics.contacts"] == 10
    assert train.calls["physics.solve"] == 10
    assert train.calls["render.k2b"] == train.calls["render.k1b"] == 1


def test_roots_give_descendants_and_self_time(step_inputs):
    profiling.enable(True)
    for _ in range(2):
        _run(step_inputs)
    last = profiling.roots("step.train", last=1)
    both = profiling.roots("step.train")
    assert len(both) == 2 and last == both[-1:]
    assert len(profiling.roots(last=10)) == 6
    r = last[0]
    rec = {x.step: x for x in profiling.records() if x.parent is None}[r.step]
    children = [x for x in profiling.records() if x.parent == rec.id]
    assert {c.name for c in children} == {"render.prepare", "step.batch",
                                          "step.backward"}
    child_s = sum(c.end_ns - c.start_ns for c in children) * 1e-9
    assert r.self_s + child_s == pytest.approx(r.seconds, abs=1e-9)
    assert 0 <= r.self_s < r.seconds
    assert r.by_name["physics"] >= r.by_name["physics.solve"] > 0


def test_span_on_another_thread_nests_under_the_open_root():
    """A span opened on a thread with no open span (autograd's device
    thread on the card) takes the innermost span open on the thread whose
    root is open as its parent, and that root's step."""
    profiling.enable(True)
    done = []

    def worker():
        with profiling.span("render.k2b"):
            with profiling.span("inner"):
                done.append(threading.get_native_id())

    with profiling.span("step.train"):
        with profiling.span("step.backward"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive() and done
    t = threading.Thread(target=worker)        # no root open: its own root
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    recs = profiling.records()
    assert [r.name for r in recs] == ["inner", "render.k2b", "step.backward",
                                      "step.train", "inner", "render.k2b"]
    inner, k2b, backward, train, inner2, k2b_alone = recs
    assert k2b.parent == backward.id
    assert inner.parent == k2b.id and backward.parent == train.id
    assert k2b.step == inner.step == train.step
    assert k2b.thread == done[0] != train.thread
    assert k2b_alone.parent is None and k2b_alone.step != train.step
    assert inner2.parent == k2b_alone.id


def test_outputs_bit_equal_with_tracing_on_and_off(step_inputs):
    off_train, off_fwd = _run(step_inputs)
    profiling.enable(True)
    on_train, on_fwd = _run(step_inputs)
    assert profiling.records()

    def flat(x):
        if torch.is_tensor(x):
            return [x]
        if x is None:
            return []
        return [t for y in x for t in flat(y)]
    a = flat(off_train) + flat(off_fwd)
    b = flat(on_train) + flat(on_fwd)
    assert len(a) == len(b) > 10
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_spans_on_the_profilers_clock():
    """Under a CPU profiler each span enters a ``record_function`` whose raw
    event lies within 50 µs of the span's recorded start and end."""
    from torch.profiler import ProfilerActivity, profile
    profiling.enable(True)
    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("warm"):
            pass
        with profiling.span("outer"):
            for _ in range(4):
                with profiling.span("mid"):
                    with profiling.span("leaf"):
                        x = x @ x / 64
    marks = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in ("outer", "mid", "leaf"):
            marks.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    recs = [r for r in profiling.records() if r.name != "warm"]
    assert len(recs) == 9
    for name in ("outer", "mid", "leaf"):
        ours = sorted((r.start_ns, r.end_ns) for r in recs if r.name == name)
        theirs = sorted(marks[name])
        assert len(ours) == len(theirs)
        for (s0, e0), (s1, e1) in zip(ours, theirs):
            assert abs(s1 - s0) <= 50_000 and abs(e1 - e0) <= 50_000
            assert s0 <= s1 and e1 <= e0      # the span holds its mark


def test_export_is_a_chrome_trace_with_launch_counters(step_inputs, tmp_path,
                                                       monkeypatch):
    # an operator launched before: each root records its change, 0 here
    monkeypatch.setitem(profiling.launches, "composite_static", 5)
    profiling.enable(True)
    _run(step_inputs)
    profiling.count("kernels.built", 2)
    profiling.export(tmp_path / "spans.json")
    data = json.loads((tmp_path / "spans.json").read_text())
    base = data["baseTimeNanoseconds"]
    xs = [e for e in data["traceEvents"] if e["ph"] == "X"]
    cs = [e for e in data["traceEvents"] if e["ph"] == "C"]
    recs = profiling.records()
    assert len(xs) == len(recs)
    first = min(recs, key=lambda r: r.start_ns)
    x0 = min(xs, key=lambda e: e["ts"])
    assert x0["name"] == first.name
    assert abs(base + x0["ts"] * 1e3 - first.start_ns) < 1e3
    assert {"step", "id", "parent"} <= set(x0["args"])
    n_roots = sum(r.parent is None for r in recs)
    launched = [e["args"]["value"] for e in cs
                if e["name"] == "composite_static"]
    assert launched == [0] * n_roots
    built = [e for e in cs if e["name"] == "kernels.built"]
    assert [e["args"]["value"] for e in built] == [2]


def test_buffer_keeps_the_last_capacity_spans(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 8)
    monkeypatch.setitem(profiling.launches, "composite_static", 0)
    profiling.clear()
    profiling.enable(True)
    for i in range(20):
        with profiling.span(f"s{i}"):
            pass
    recs = profiling.records()
    assert [r.name for r in recs] == [f"s{i}" for i in range(12, 20)]
    assert profiling.dropped()[0] == 12
    assert len(profiling.counter_events()) == 8    # launch counters too
    assert profiling.dropped()[1] == 12


def test_kernel_load_span_and_build_counter(monkeypatch, tmp_path):
    """``kernels.load`` spans a library's first load, and ``kernels.built``
    counts the libraries nvcc built (both faked here: no nvcc)."""
    profiling.enable(True)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "_library_path",
                        lambda name: tmp_path / f"lib{name}.so")

    def fake_compile(jobs):
        for _, _, out in jobs:
            out.write_bytes(b"")
        return {out: "" for _, _, out in jobs}
    monkeypatch.setattr(_kernels, "compile_all", fake_compile)
    monkeypatch.setattr(_kernels.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_kernels, "_loaded", {})
    _kernels.load("composite")                   # builds every library
    _kernels.load("composite")                   # loaded: no span
    _kernels.load("composite_bwd")               # built: a load, no build
    assert [r.name for r in profiling.records()] == ["kernels.load"] * 2
    assert [c.value for c in profiling.counter_events()
            if c.name == "kernels.built"] == [len(_kernels.KERNEL_SOURCES)]


def test_idle_by_span_names_each_gap(monkeypatch):
    """Device-idle gaps go to the innermost span that holds their midpoint,
    on any thread, or outside every span."""
    from torch.autograd import DeviceType

    class Ev:
        def __init__(self, s, e, device=True):
            self.s, self.e, self.dev = s, e, device

        def device_type(self):
            return DeviceType.CUDA if self.dev else DeviceType.CPU

        def is_user_annotation(self):
            return False

        def start_ns(self):
            return self.s

        def duration_ns(self):
            return self.e - self.s

        def name(self):
            return "kernel"

    # on the tracer's clock: a root [100, 900] with a child [200, 400], and
    # another thread's span [500, 700] under it
    recs = [profiling.Record("child", 200, 400, 1, 0, 0, 1),
            profiling.Record("worker", 500, 700, 2, 0, 0, 2),
            profiling.Record("root", 100, 900, 0, None, 0, 1)]
    monkeypatch.setattr(profiling, "records", lambda: recs)
    busy = [Ev(150, 250), Ev(350, 550), Ev(560, 580), Ev(950, 980),
            Ev(300, 320, device=False)]
    out = profiling.idle_by_span(busy, 0, 1000)
    by = out["by_span"]
    # gaps [0, 150] and [980, 1000] outside; [250, 350] child (mid 300);
    # [550, 560] worker (mid 555); [580, 950] root (mid 765)
    assert by["child"] == {"idle_s": pytest.approx(100e-9), "gaps": 1}
    assert by["worker"] == {"idle_s": pytest.approx(10e-9), "gaps": 1}
    assert by["root"] == {"idle_s": pytest.approx(370e-9), "gaps": 1}
    assert by[profiling.OUTSIDE] == {"idle_s": pytest.approx(170e-9),
                                     "gaps": 2}
    assert out["gaps"] == 5
    assert out["busy_s"] == pytest.approx((100 + 200 + 20 + 30) * 1e-9)
    assert out["idle_s"] == pytest.approx(out["window_s"] - out["busy_s"])


def test_device_trace_writes_idle_by_span(tmp_path):
    profiling.enable(True)
    with profiling.device_trace(tmp_path / "tr"):
        with profiling.span("work"):
            torch.ones(256, 256) @ torch.ones(256, 256)
    assert json.loads((tmp_path / "tr" / "trace.json").read_text())[
        "traceEvents"]
    idle = json.loads((tmp_path / "tr" / "idle_by_span.json").read_text())
    assert idle["idle_s"] == pytest.approx(idle["window_s"])  # no device
    assert sum(v["gaps"] for v in idle["by_span"].values()) == idle["gaps"]
    assert idle["record_function_lag_us"] is not None
    profiling.enable(False)
    with profiling.device_trace(tmp_path / "off"):
        pass
    assert not (tmp_path / "off" / "idle_by_span.json").exists()


def test_environment_switch_exports_at_exit(tmp_path):
    out = tmp_path / "run" / "spans.json"
    code = ("from sim_a_splat_torch.utils import profiling as p\n"
            "assert p.enabled()\n"
            "with p.span('outer'):\n"
            "    with p.span('inner'):\n"
            "        pass\n")
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
           "SIM_A_SPLAT_TRACE": str(out), "HOME": str(tmp_path)}
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=300)
    names = [e["name"] for e in json.loads(out.read_text())["traceEvents"]
             if e["ph"] == "X"]
    assert names == ["inner", "outer"]


@pytest.mark.cuda
def test_backward_spans_nest_on_the_card():
    """On the card autograd runs the backward kernels on its own thread:
    K2b's and K1b's spans still sit under ``step.backward``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    graph = entry.build_scene(n_bg=2000, n_block=400, n_agent=150, seed=0,
                              sh_degree=3, device="cuda")
    raster = RasterConfig(tile_size=16, tile_capacity=256,
                          max_tiles_per_gaussian=16, sigma_cutoff=3.0,
                          term_eps=1e-4)
    prepare, step_batch, params = entry.make_step_cached_batch(
        graph, 128, 128, raster, dyn_capacity=128, sel_tiles=16,
        dyn_max_tiles=9, device="cuda")
    states = pusht.reset(params,
                         torch.Generator(device="cuda").manual_seed(0), 8)
    profiling.enable(True)
    entry.loss_and_grads(prepare, step_batch, graph.scene, states,
                         states.agent_pos + 5.0)
    torch.cuda.synchronize()
    by_id = _by_id()
    recs = profiling.records()
    train = [r for r in recs if r.name == "step.train"]
    assert len(train) == 1
    for name in ("render.k2b", "render.k1b"):
        r = [x for x in recs if x.name == name]
        assert len(r) == 1 and by_id[r[0].parent].name == "step.backward"
        assert r[0].step == train[0].step
        assert r[0].thread != train[0].thread     # autograd's device thread
    launches = {c.name: c.value for c in profiling.counter_events()
                if c.step == train[0].step}
    assert launches["composite_static"] == 1
    assert launches["composite_pair_sel_bwd"] == 1
