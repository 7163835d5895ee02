"""The per-layer metrics read from the program's own spans
(``perfbench/harness/program.py``): a small train cell on the CPU reports
them beside the harness's wrappers' numbers; a ``--trace 0`` run keeps the
tracer off; on a program without the tracer the readers return None."""

import sys
from types import SimpleNamespace

import pytest

from perfbench.harness import bench as harness
from perfbench.tests import tiny

DATAGEN, TRAIN = tiny.CELLS
METRICS = ("physics_span_ms.train", "physics_solve_ms.train",
           "render_span_ms.train", "backward_span_ms.train",
           "step_self_ms.train")


@pytest.fixture
def profiling():
    from sim_a_splat_torch.utils import profiling
    was = profiling.enabled()
    profiling.enable(False)
    profiling.clear()
    yield profiling
    profiling.enable(was)
    profiling.clear()


def _window(profiling, trace_steps):
    """A reader's context for the roots the run left: the warm step, the
    window's steps, the traced steps."""
    n = len(profiling.roots("step.train"))
    return SimpleNamespace(steps=n - 1 - trace_steps, trace_steps=trace_steps)


def test_a_traced_train_run_reports_the_program_spans(tmp_path, profiling):
    from perfbench.harness import program
    line = tiny.run_small(tmp_path, TRAIN, trace=True)
    got = line["metrics"]
    for name in METRICS:
        assert got[name]["unit"] == "ms" and got[name]["value"] > 0, name
    # the program's span and the harness's wrapper time the same calls
    assert got["physics_span_ms.train"]["value"] == pytest.approx(
        got["physics_ms.train"]["value"], rel=0.05)
    assert got["render_span_ms.train"]["value"] == pytest.approx(
        got["render_ms.train"]["value"], rel=0.05)
    assert got["physics_solve_ms.train"]["value"] \
        < got["physics_span_ms.train"]["value"]
    ctx = _window(profiling, tiny.SMALL_TRAFFIC["trace_steps"])
    assert ctx.steps >= 1
    assert program.self_ms(ctx) == got["step_self_ms.train"]["value"]
    children = program.span_ms(ctx, ["render.prepare", "step.batch",
                                     "step.backward"])
    root = sum(r.seconds for r in program.window_roots(ctx)) \
        / ctx.steps * 1e3
    assert program.self_ms(ctx) + children == pytest.approx(root, rel=1e-9)


def test_an_untraced_run_records_no_span(tmp_path, profiling):
    sys.modules.pop("perfbench.harness.program", None)
    line = tiny.run_small(tmp_path, TRAIN, trace=False)
    assert line["correct"] and "train_frames_per_s" in line["metrics"]
    assert "perfbench.harness.program" not in sys.modules
    assert not profiling.enabled()
    assert profiling.records() == []


def test_without_the_programs_tracer_the_readers_read_nothing(
        tmp_path, profiling, monkeypatch):
    monkeypatch.delattr(profiling, "roots")
    from perfbench.harness import program
    assert program.tracer() is None
    ctx = SimpleNamespace(steps=5, trace_steps=1)
    for name in METRICS:
        assert harness.load_metric(name).read(ctx) is None
    line = tiny.run_small(tmp_path, TRAIN, trace=True)
    assert not set(METRICS) & set(line["metrics"])
    assert "physics_ms.train" in line["metrics"]
