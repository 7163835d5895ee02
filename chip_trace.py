#!/usr/bin/env python3
"""The program's tracer on the card: which program span the device's idle
gaps fall in, what a span costs the host, and the spans a step records.
Not part of the port: nothing imports it.

Run from the root of a checkout on a machine with one NVIDIA GPU, with the
operator's switch set (the spans of the whole run are written there at
exit):

    SIM_A_SPLAT_TRACE=chiprun_out/trace/spans.json python3 chip_trace.py \\
        [outdir, default chiprun_out/trace] [--cpu]

(``--cpu``: a rehearsal on the CPU at a tiny size, B = 4, 3,000
gaussians, 64².  ``--arm``: the arm's collect step instead, below.)

It builds the batched pushT step at the benchmark's width (B = 128 envs,
100,000 SH-3 gaussians, 256², tile 16, ``sel_tiles`` 48), and then:

1. times a span on this host, nested under a root, 20,000 times: with
   tracing off, on with no profiler active, and on under a profiler; and
   a bare ``torch.profiler.record_function`` with no profiler active (what
   a span skips then);
2. warms the step up (the kernels' load), and counts the spans that a
   forward step (data collection: ``prepare`` + ``step_batch``) and a train
   step (``entry.loss_and_grads``) record;
3. runs one forward step and one train step, each inside its own
   ``device_trace`` with tracing on: ``<outdir>/datagen/`` and
   ``<outdir>/train/`` get ``trace.json`` and ``idle_by_span.json``;
4. times train steps with tracing on and off in turns, one step a turn
   (on, off, off, on, ...; host clock, synchronised after each step), and
   the difference within each pair of neighbouring steps.

With ``--arm`` it builds the arm deployment of the benchmark's cells
instead (``entry.build_product_wrapper``: 100,000 SH-3 gaussians, two
cameras at 240×320) and runs its collect step (``entry.make_product_collect``)
inside ``device_trace`` with tracing on: one teleop step at B = 1 after a
120-step settle (``<outdir>/arm_b1/``), and at B = 8 after a 40-step settle
an episode's first step, which builds the end-effector caches
(``<outdir>/arm_b8_first/``), and the step after it (``<outdir>/arm_b8/``).
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

B = 128
N = 100_000
RES = 256
COST_SPANS = 20_000
AB_STEPS = 40        # step 4: train steps with tracing on, and off


def log(msg):
    print(msg, flush=True)


def main() -> int:
    import torch
    cpu = "--cpu" in sys.argv[1:]
    args = [a for a in sys.argv[1:] if a not in ("--cpu", "--arm")]
    if not cpu and not torch.cuda.is_available():
        print("chip_trace: torch.cuda.is_available() is False — needs a "
              "CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from sim_a_splat_torch import entry
    from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
    from sim_a_splat_torch.physics import pusht
    from sim_a_splat_torch.utils import profiling

    out = Path(args[0] if args else "chiprun_out/trace")
    out.mkdir(parents=True, exist_ok=True)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi: {e}"
    log(f"card: {smi}; torch {torch.__version__}, cuda {torch.version.cuda}")
    log(f"tracing on from import: {profiling.enabled()}")
    dev = torch.device("cpu" if cpu else "cuda")
    if "--arm" in sys.argv[1:]:
        profiling.enable(True)
        return arm(out, dev, cpu)
    n, b, res, cap, sel = ((3000, 4, 64, 256, 16) if cpu
                           else (N, B, RES, 1024, 48))
    sync = torch.cuda.synchronize if not cpu else (lambda: None)

    # 1. a span's cost on this host ------------------------------------------
    def span_cost(on: bool) -> float:
        profiling.enable(on)
        with profiling.span("cost.root"):
            t0 = time.perf_counter()
            for _ in range(COST_SPANS):
                with profiling.span("cost"):
                    pass
            dt = time.perf_counter() - t0
        return dt / COST_SPANS * 1e6

    cost = {"off": span_cost(False), "on": span_cost(True)}
    with profile(activities=[ProfilerActivity.CPU]
                 + ([] if cpu else [ProfilerActivity.CUDA])):
        cost["on, profiler active"] = span_cost(True)
    t0 = time.perf_counter()
    for _ in range(COST_SPANS):
        with torch.profiler.record_function("cost"):
            pass
    cost["record_function, no profiler"] = \
        (time.perf_counter() - t0) / COST_SPANS * 1e6
    log("a span's cost on the host, us (empty body, nested): "
        + ", ".join(f"{k} {v:.3f}" for k, v in cost.items()))
    profiling.clear()
    profiling.enable(True)

    # 2. the step at the benchmark's width, warmed up -----------------------
    nb, na = n // 20, n // 50
    graph = entry.build_scene(n_bg=n - nb - na, n_block=nb, n_agent=na,
                              seed=0, sh_degree=3, device=dev)
    raster = RasterConfig(tile_size=16, tile_capacity=cap,
                          max_tiles_per_gaussian=16, sigma_cutoff=3.0,
                          term_eps=1e-4,
                          buckets=((4, 0.90), (6, 0.06), (9, 0.04)))
    prepare, step_batch, params = entry.make_step_cached_batch(
        graph, res, res, raster, dyn_capacity=128, sel_tiles=sel,
        dyn_max_tiles=9, device=dev)
    scene = graph.scene
    gen = torch.Generator(device=dev).manual_seed(0)
    states = pusht.reset(params, gen, b)
    state = {"s": states}

    def fwd():
        new, imgs, n_drop = step_batch(prepare(scene), scene, state["s"],
                                       state["s"].agent_pos + 8.0)
        state["s"] = new
        return imgs

    def train():
        new, loss, n_drop, grads = entry.loss_and_grads(
            prepare, step_batch, scene, state["s"],
            state["s"].agent_pos + 8.0)
        state["s"] = new
        return loss

    t0 = time.perf_counter()
    fwd()
    train()
    sync()
    built = [c.value for c in profiling.counter_events()
             if c.name == "kernels.built"]
    loads = sum(r.name == "kernels.load" for r in profiling.records())
    log(f"warm-up (kernels' load and build): {time.perf_counter() - t0:.2f}"
        f" s; kernels.load spans {loads}; kernels.built {built}")
    for fn in (fwd, train):
        n0 = len(profiling.records())
        fn()
        sync()
        log(f"spans a {fn.__name__} step: {len(profiling.records()) - n0}")

    # 3. one step of each under device_trace ---------------------------------
    for name, fn in (("datagen", fwd), ("train", train)):
        traced(out / name, fn)

    # 4. train steps with tracing on and off, in turns -----------------------
    ms = {True: [], False: []}
    for i in range(2 * AB_STEPS):
        on = i % 4 in (0, 3)             # on, off, off, on, on, off, ...
        profiling.enable(on)
        t0 = time.perf_counter()
        train()
        sync()
        ms[on].append((time.perf_counter() - t0) * 1e3)
    profiling.enable(True)
    for on in (True, False):
        v = ms[on]
        q = statistics.quantiles(v, n=4)
        log(f"train step ms, tracing {'on' if on else 'off'}: median "
            f"{statistics.median(v):.2f}, quartiles {q[0]:.2f} {q[2]:.2f}, "
            f"{len(v)} steps")
    diff = [a - b for a, b in zip(ms[True], ms[False])]
    q = statistics.quantiles(diff, n=4)
    log(f"on less off, neighbouring steps, ms: median "
        f"{statistics.median(diff):.2f}, quartiles {q[0]:.2f} {q[2]:.2f}; "
        f"on slower in {sum(d > 0 for d in diff)} of {len(diff)} pairs")
    log(f"spans dropped: {profiling.dropped()}")
    return 0


def traced(outdir: Path, fn):
    """``fn()`` inside ``device_trace(outdir)`` with tracing on; log where
    the device's idle time fell and the host ms of the last root's spans."""
    from sim_a_splat_torch.utils import profiling
    with profiling.device_trace(outdir):
        fn()
    idle = json.loads((outdir / "idle_by_span.json").read_text())
    outside = idle["by_span"].get(profiling.OUTSIDE, {"idle_s": 0.0})
    log(f"{outdir.name}: window {idle['window_s']:.4f} s, busy "
        f"{idle['busy_s']:.4f} s, idle {idle['idle_s']:.4f} s in "
        f"{idle['gaps']} gaps; outside every span "
        f"{100 * outside['idle_s'] / idle['idle_s']:.3f} % of the idle; "
        f"record_function lag {idle['record_function_lag_us']} us")
    for k, v in idle["by_span"].items():
        log(f"  {k}: {v['idle_s'] * 1e3:.3f} ms in {v['gaps']} gaps")
    root = profiling.roots()[-1]
    log(f"  host ms by span in {root.name} "
        f"({root.seconds * 1e3:.1f} ms, self {root.self_s * 1e3:.3f}): "
        + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in
                    sorted(root.by_name.items(), key=lambda kv: -kv[1])))
    for c in profiling.counter_events():
        if c.step == root.step and c.value:
            log(f"  {c.name}: {c.value}")


def arm(out: Path, dev, cpu: bool) -> int:
    """The arm's collect step under ``device_trace`` (the module's notes)."""
    import torch
    from sim_a_splat_torch import entry
    n, size = (3000, (48, 64)) if cpu else (100_000, (240, 320))
    w = entry.build_product_wrapper(n_total=n, render_size=size, device=dev)
    collect = entry.make_product_collect(w)
    caches = w.build_render_cache()
    for B, settle in ((1, 120), (8, 40)):
        states, actions = entry.product_inputs(w, B, 2,
                                               settle=3 if cpu else settle)
        run = {"s": states, "mc": None if B > 1 else w.build_moving_caches(
            w.env.draw_state(states), margin=16.0, kc=512, z_split=0.35,
            near_cap=16384)}

        def step(i):
            def fn():
                with torch.no_grad():
                    tr, run["mc"] = collect(run["s"], actions[i], caches,
                                            run["mc"])
                run["s"] = tr.state
            return fn

        if B == 1:
            step(0)()                               # warm-up
            traced(out / "arm_b1", step(1))
        else:
            traced(out / "arm_b8_first", step(0))
            traced(out / "arm_b8", step(1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
