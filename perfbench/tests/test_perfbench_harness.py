"""The harness: BENCHMARK.json against its contract, everything found by
name, the result line, the end-to-end arithmetic, and what a run may
load."""

import json
import re
import statistics
import subprocess
import sys

import pytest

from perfbench.harness import bench as harness
from perfbench.harness import guard, stats
from perfbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_holds_to_its_contract():
    b = tiny.bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and 1 <= b["run_seconds"] <= 51
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert (tiny.ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (tiny.ROOT / "perfbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
        reported = {m["name"] for m in harness.cell_metrics(
            b, w["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        layer = harness.cell_metrics(b, w["name"], "per_layer")
        assert layer
        for m in layer:          # every metric moves one its cells report
            assert m["moves"] in reported


def test_every_metric_has_its_reader():
    b = tiny.bench()
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read)


def test_a_metric_falls_back_to_the_reader_of_its_kind(tmp_path):
    (tmp_path / "lat_ms.py").write_text("def read(ctx):\n    return 1.0\n")
    (tmp_path / "lat_ms.teleop.py").write_text(
        "def read(ctx):\n    return 2.0\n")
    assert harness.load_metric("lat_ms.train", tmp_path).read(None) == 1.0
    assert harness.load_metric("lat_ms.teleop", tmp_path).read(None) == 2.0
    with pytest.raises(FileNotFoundError):
        harness.load_metric("other.train", tmp_path)
    mfu = harness.load_metric("step_mfu.train")
    assert {k.__name__.rsplit(".", 1)[1] for k in mfu.KERNELS} >= {
        "k1f", "k1b", "k2f", "k2b"}


def test_the_device_shares_divide_by_the_measured_steps():
    """A traced step that the profiler stretches moves neither the idle
    share nor the step's share of the peak; a kernel with no launch in the
    trace adds no operations."""
    from types import SimpleNamespace as NS

    from perfbench.harness import readers
    from perfbench.roofline.peaks import PEAK_FP32_FLOPS
    ran = NS(CAPTURE="f", KERNELS=("ran",), work=lambda a: (a[0], 0))
    absent = NS(CAPTURE="f", KERNELS=("absent",), work=lambda a: (a[0], 0))

    def ctx(traced_s):
        trace = NS(busy_s=0.1, window_s=traced_s,
                   kernel_seconds=lambda names: 0.05 * ("ran" in names))
        return harness.Context(10.0, 40, 40 * 128, 20.0, None, trace,
                               {"f": [(PEAK_FP32_FLOPS * 0.05,)]}, 1)
    for traced_s in (0.5, 2.0):          # a measured step is 0.5 s
        assert readers.idle_share(ctx(traced_s)) == pytest.approx(80.0)
        assert readers.step_mfu(ctx(traced_s), [ran, absent]) == (
            pytest.approx(10.0))


def test_the_device_rate_reads_the_busy_time_alone():
    """Frames over the device's busy seconds: overlapping operations count
    once, the spans' marks and the host's events not at all, and a window
    twice as long on the host's clock reads the same."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from perfbench.harness import readers, trace
    from perfbench.roofline.peaks import PEAK_FP32_FLOPS

    def ev(start, dur, dev=DeviceType.CUDA, mark=False, name="k"):
        return NS(start_ns=lambda: start, duration_ns=lambda: dur,
                  device_type=lambda: dev, is_user_annotation=lambda: mark,
                  name=lambda: name)
    cpu = DeviceType.CPU
    events = [ev(0, 100), ev(50, 100), ev(400, 100, name="Memset (Device)"),
              ev(0, 10**6, mark=True),
              ev(0, 10**6, dev=cpu, name="aten::add"),
              ev(0, 1, dev=cpu, name="cudaLaunchKernel"),
              ev(0, 1, dev=cpu, name="cudaMemsetAsync"),
              ev(0, 1, dev=cpu, name="cudaMemsetAsync")]
    assert trace.device_busy(events) == (pytest.approx(250e-9), 2, 1)
    # a step whose kernels fall short of its launches by more than every
    # step does (launches that put no kernel on the device) is left out
    busy = trace.DeviceBusy()
    busy.steps += [(0.074, 56188, 56193, 128), (0.069, 48787, 56193, 128),
                   (0.075, 56188, 56193, 128)]
    assert (busy.busy_s, busy.frames) == (pytest.approx(0.149), 256)
    reader = harness.load_metric("env_frames_per_device_s")
    for window_s in (20.0, 40.0):
        c = harness.Context(10.0, 3, 384, window_s, None,
                            window_device=busy)
        assert reader.read(c) == pytest.approx(256 / 0.149)
    assert reader.read(harness.Context(10.0, 40, 5120, 20.0, None)) is None
    # each launch's device time goes to the innermost span around it
    spans = [(0, 100, "physics"), (200, 300, "render.prepare"),
             (210, 250, "render.inner")]
    got = trace.span_seconds([(10, 5.0), (220, 7.0), (260, 1.0),
                              (500, 9.0)], spans)
    assert got == {"physics": pytest.approx(5e-6),
                   "render.inner": pytest.approx(7e-6),
                   "render.prepare": pytest.approx(1e-6)}
    tr = NS(busy_s=0.1, span_s=got, kernel_seconds=lambda names: 0.05)
    c = harness.Context(10.0, 40, 5120, 20.0, None, tr,
                        {"f": [(PEAK_FP32_FLOPS * 0.02,)]}, 2)
    assert readers.span_device_ms(c, ["physics"]) == pytest.approx(2.5e-3)
    assert readers.span_device_ms(c, ["absent"]) is None
    k = NS(CAPTURE="f", KERNELS=("k",), work=lambda a: (a[0], 0))
    assert readers.device_mfu(c, [k]) == pytest.approx(20.0)


def test_the_rate_and_the_p90_both_move_with_a_stall():
    steps = [0.6] * 50
    stalled = steps[:25] + [5.0] + steps[25:]
    B = 128
    rate = stats.rate(B * len(steps), sum(steps))
    rate_stalled = stats.rate(B * len(stalled), sum(stalled))
    assert rate == pytest.approx(B / 0.6)
    assert rate_stalled < 0.9 * rate
    # ten slower steps: the tenth beyond p90 moves it, a median does not
    slow = steps[:40] + [0.9] * 10 + [5.0]
    assert stats.percentile(steps, 90) == 0.6
    assert stats.percentile(slow, 90) == 0.9
    assert stats.percentile([1, 2, 3, 4], 50) == 2


def test_the_spread_of_a_set_leaves_out_its_farthest_run():
    from perfbench import spread
    vals = [214.3, 203.2, 186.6, 245.5, 229.4, 183.0]
    med, q1, q3, s, s_trim = spread.spreads(vals)
    assert med == statistics.median(vals)
    assert s == pytest.approx((q3 - q1) / med)
    rest = [214.3, 203.2, 186.6, 229.4, 183.0]       # 245.5 left out
    r1, _, r3 = statistics.quantiles(rest, n=4)
    assert s_trim == pytest.approx((r3 - r1) / 203.2)


def test_forbidden_names_are_compared_whole():
    assert guard.forbidden_loaded({"jax.numpy": 0, "numpy": 0}) == ["jax"]
    assert guard.forbidden_loaded({"sim_a_splat_torch.entry": 0,
                                   "jaxtyping": 0, "flaxen": 0}) == []
    assert guard.forbidden_loaded({"sim_a_splat_tpu.ops": 0}) == [
        "sim_a_splat_tpu"]


def test_the_reference_loads_nothing_of_the_program():
    assert guard.reference_violations() == []
    code = ("import sys, pkgutil, importlib, perfbench.reference as r\n"
            "for m in pkgutil.iter_modules(r.__path__):\n"
            "    importlib.import_module('perfbench.reference.' + m.name)\n"
            "bad = {n.split('.')[0] for n in sys.modules} & {'jax', "
            "'jaxlib', 'flax', 'sim_a_splat_tpu', 'sim_a_splat_torch'}\n"
            "print(sorted(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_without_a_card_prints_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", tiny.CELLS[0],
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=tiny.ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_a_run_without_the_program_prints_no_result(tmp_path):
    import shutil
    shutil.copy(tiny.BENCH, tmp_path / "BENCHMARK.json")
    shutil.copytree(tiny.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", tiny.CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_a_new_config_and_cell_are_found_by_name(tmp_path):
    """A configuration file and a cell entry are all a new cell needs."""
    cdir, tdir = tiny.write_small(tmp_path)
    cfg = json.loads((cdir / "pusht_fixed_100k_sh3.json").read_text())
    cfg.update(n_gaussians=2000, n_block=200, n_agent=80)
    (cdir / "pusht_fixed_2k_sh3.json").write_text(json.dumps(cfg))
    b = tiny.bench()
    b["configs"].append(dict(b["configs"][0], name="pusht_fixed_2k_sh3",
                             file="perfbench/configs/pusht_fixed_2k_sh3.json"))
    b["workloads"].append({"name": "pusht_fixed_2k-train", "chips": 1,
                           "config": "pusht_fixed_2k_sh3",
                           "traffic": "train_b128", "why": "a test"})
    rate = next(m for m in b["end_to_end"]
                if m["name"] == "train_frames_per_s")
    rate["workloads"].append("pusht_fixed_2k-train")
    from perfbench.harness import bench as h
    line = h.run_cell(b, "pusht_fixed_2k-train", 7, 0.5, False,
                      device="cpu", config_dir=cdir, traffic_dir=tdir,
                      log=lambda m: None)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert set(line["metrics"]) == {"train_frames_per_s", "setup_s"}
    assert line["attempted"] >= 4 and line["failed"] == 0


def test_a_metric_of_the_device_finds_nothing_on_the_host(tmp_path):
    """On the CPU no step is profiled: the device's rate is left out of
    the line, never read as 0."""
    line = tiny.run_small(tmp_path, tiny.CELLS[0])
    assert line["correct"] is True
    assert set(line["metrics"]) == {"setup_s"}


def test_a_traced_line_holds_the_per_layer_metrics(tmp_path):
    line = tiny.run_small(tmp_path, tiny.CELLS[1], trace=True)
    assert line["correct"] is True
    assert {"physics_ms.train", "render_ms.train"} <= set(line["metrics"])
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(line)
