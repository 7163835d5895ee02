#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``sim_a_splat_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--parent DIR]

With ``--parent DIR`` (the root of another checkout, e.g. the parent
commit's ``git archive``) it also builds that checkout's K2 and K4 kernels
and times them on the same inputs, in turns with this tree's (parent,
this, this, parent), beside this tree's times.

It builds the port's CUDA kernels from ``sim_a_splat_torch/csrc``, holds
each against its plain PyTorch version at the shapes of its path, and
drives three paths through the port's entry points, each forward and in
training, at N=100k gaussians, SH degree 3, 256×256:

- the fixed camera (K1f, K1b, K2f, K2b), B=128 envs: the batched pushT
  splat env step (``entry.make_step_cached_batch``) and its train step
  (``entry.loss_and_grads``: the mean-square image loss and its gradient
  to every gaussian parameter);
- the same envs through the reference's per-env fixed-camera step
  (``entry.make_step_cached``, K1f, K1b, K4f, K4b), B=128, forward and
  in training, its images against the selected-tile path's and its
  ``static_skip=False`` variant;
- K2 and K4 at ``dyn_capacity`` 4096 on 2 of those envs, past the
  dynamic windows of their backward kernels (and past the first design's
  card limits), against their plain versions in float64, and at
  ``dyn_capacity`` 1024 and tile size 32 (a window of 128 entries in the
  backward kernels), timed;
- the moving camera attached to each env's agent (K3f, K3b): the R=32
  frame candidate-cache rollout (``entry.make_step_moving_cached``) at
  B=32 forward and B=16 in training (``entry.rollout_loss_and_grads``),
  and one frame against the full per-frame rebin
  (``entry.make_step_moving``).

It checks that every kernel of each path was launched (and no backward
kernel by a forward run), that the fixed-camera render is exact (no
dropped tiles), that all gradients are finite, that the images and the
gradients agree with the port's plain path, and that K4 (which runs K2's
block body) gives K2's output and dynamic gradient bit for bit on the
same (env, tile) pairs.  Any disagreement raises.

Output: phase reports, then the card's name and power limit, one JSON line
``{"kernels": [...]}`` with per-kernel launches, max |Δ|, kernel / plain
times and the roofline bound, and last ``{"ok": true, "device": {...}}``.
Kernel times are CUDA-event times over back-to-back calls, for every
kernel.  K1f and K1b run about as short as their Python dispatch, so the
device time of their kernels under the profiler is printed beside theirs.
Exits non-zero without a result where there is no CUDA device.  The top
rows of a device profile of one forward step and one train step are
printed with the phase reports.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

B, N, RES, SH_DEGREE = 128, 100_000, 256, 3
SEL_TILES, DYN_CAP, DYN_M = 36, 128, 9
BIG_KD = 4096   # a dynamic capacity past the backward kernels' windows
LONG_ENVS = 2   # envs of the BIG_KD phase (its float64 plain versions)
TS32_KD = 1024  # the dynamic capacity of the tile-size-32 phase
ITERS = 5
# K2f and K2b of the first design (one thread per pixel, K2b's per-slot
# output summed by index_add_), K4 on that walk, and K1f and K1b of the
# first design (one block per tile walking its chunks in order): this
# script on an NVIDIA H100 80GB HBM3 at 700 W
FIRST_DESIGN_MS = {"composite_pair_sel": 1.2854,
                   "composite_pair_sel_bwd": 4.2181,
                   "composite_pair": 1.3624, "composite_pair_bwd": 4.2581,
                   "composite_static": 0.1340,
                   "composite_static_bwd": 0.5092}
# the moving camera (bench.py's moving_camera / moving_fwd variants)
B_MV_FWD, B_MV_TRAIN, R_MV, MV_ITERS = 32, 16, 32, 1
MV_KW = dict(margin=16.0, kc=512, dyn_capacity=DYN_CAP, dyn_max_tiles=DYN_M,
             cam_height=-420.0, z_split=0.0)
TOL_REBIN = (2e-5, 1e-4)  # atol, rtol: the reference's own bound for the
                          # cached render against the full rebin
# FLOP per (pixel, list entry) pair, exp as one: the alpha (dx, dy, the
# conic quadratic, exp, opacity, clamp) is evaluated for every entry of an
# applied chunk; the blend (w = αT, four FMAs, T·(1-α)) only where α > 0
ALPHA_FLOPS, BLEND_FLOPS = 15, 11
# the gradient of one (pixel, entry) pair with α > 0: b = ct·rgbd, w, the
# prefix and suffix, dalpha, the 10 payload-row terms and the T update
# (42), and the pair's share of the 10 sums over the tile's pixels (10)
GRAD_FLOPS = 52
# H100 SXM published peaks (NVIDIA data sheet; at the 700 W power limit)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
TOL = 1e-4   # kernel vs plain: float32 products accumulated in another
             # order (per-pixel sequential vs cumprod / log space) over up
             # to 1,152 entries; depth rows are held to TOL × max depth
TOL_GRAD_LONG = 2e-3  # gradients at dyn_capacity BIG_KD against the plain
             # versions in float64: the kernels take each suffix sum as
             # ct . (out - prefix), and each step of those float32
             # accumulators rounds at the accumulator's size, so over merged
             # lists of thousands of entries (the main scene's at BIG_KD)
             # the error of a near-opaque entry's gradient grows past
             # TOL_GRAD; the bound tests/test_torch_grad.py holds float32
             # suffix sums to against float64
TOL_GRAD = 2e-4  # gradients, kernel vs plain: each payload row (and each
             # scene field) within TOL_GRAD × its largest plain gradient.
             # The plain backward is autograd through the plain forward; in
             # float32 it is held to the same bound against a float64 run on
             # near-opaque tiles with random cotangents
             # (tests/test_torch_grad.py), while the kernels' suffix sums
             # are taken against the forward's own accumulators


def log(msg=""):
    print(msg, flush=True)


def run(cmd):
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return (out.stdout + out.stderr).strip()


@contextlib.contextmanager
def replaced(module, name, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield old
    finally:
        setattr(module, name, old)


def cuda_ms(fn, reps, warmup=1):
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps, tries=3):
    """Device time of one ``fn()``, its kernels' own time over ``reps``
    calls under the profiler (host gaps excluded: a call shorter than its
    Python dispatch is not timed by the dispatch).  A profile that recorded
    no device time is taken again, up to ``tries`` times."""
    fn()
    for _ in range(tries):
        ms = device_profile(lambda: [fn() for _ in range(reps)])[0] / reps
        if ms > 0:
            return ms
    raise RuntimeError(f"the profiler recorded no device time in {tries} "
                       "tries")


def device_profile(fn):
    """(device time in ms, key averages) of one ``fn()`` under the profiler:
    the self time of every CUDA event, host gaps excluded."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in avg if str(e.device_type).endswith("CUDA"))
    return dev_us / 1e3, avg


def bound(nbytes, flops):
    t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def check_rows(name, got, want, what, rel=TOL_GRAD):
    """Each payload row (axis -2) of ``got`` within ``rel`` × that row's
    largest |want|; returns the max |Δ| over all rows."""
    worst = 0.0
    for r in range(want.shape[-2]):
        g, w = got[..., r, :], want[..., r, :]
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        worst = max(worst, err / scale if scale > 0 else err)
        if not err <= rel * scale:
            raise AssertionError(f"{name} {what} row {r}: max|Δ| {err} > "
                                 f"{rel} × {scale}")
    err = float((got - want).abs().max())
    log(f"  {name} {what}: max|Δ| = {err:.3e}, largest per-row max|Δ| / "
        f"max|g| = {worst:.3e} (tolerance {rel:.1e})")
    return err


def check_fields(what, g_k, g_p, fields):
    """Each gradient field of the scene ``g_k`` finite and within TOL_GRAD ×
    that field's largest gradient in ``g_p`` (the plain path's); returns
    the largest max|Δ| / max|g| over the fields."""
    import torch
    worst = 0.0
    for n in fields:
        got, want = getattr(g_k, n), getattr(g_p, n)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        log(f"  grad {n}: max|Δ| = {err:.3e}, max|g| = {scale:.3e} "
            f"(tolerance {TOL_GRAD:.1e} × max|g|)")
        if not (bool(torch.isfinite(got).all()) and err <= TOL_GRAD * scale):
            raise AssertionError(f"{what} gradient of {n} disagrees with the "
                                 f"plain path: {err} > {TOL_GRAD} × {scale}")
        worst = max(worst, err / scale)
    return worst


def check(name, got, want, atol, what):
    err = float((got - want).abs().max())
    log(f"  {name} {what}: max|Δ| = {err:.3e} (tolerance {atol:.1e})")
    if not err <= atol:
        raise AssertionError(f"{name} {what} disagrees with its plain "
                             f"version: max|Δ| {err} > {atol}")
    return err


def k2_slots_of_k4(spay, dpay, counts_s, counts_d, skip):
    """K2's inputs (spay_pad, dpay, ids, counts_s_pad, counts_d) for the
    (env, tile) pairs that K4's inputs touch (skip > 0): the static lists
    with the zero trash row, each env's touched tiles as its slots in tile
    order (pads name the trash row), their dynamic lists and counts."""
    import torch
    B, T = skip.shape
    on = skip > 0
    TT = max(int(on.sum(1).max()), 1)
    order = torch.argsort((~on).to(torch.int8), dim=1, stable=True)[:, :TT]
    real = torch.gather(on, 1, order)
    ids = torch.where(real, order, T).to(torch.int32)
    bidx = torch.arange(B, device=skip.device)[:, None]
    safe = torch.where(real, order, 0)
    dsel = torch.where(real[..., None, None], dpay[bidx, safe], 0.0)
    cd = torch.where(real, counts_d[bidx, safe], 0).to(torch.int32)
    return (torch.cat([spay, spay.new_zeros((1, *spay.shape[1:]))]),
            dsel.contiguous(), ids,
            torch.cat([counts_s, counts_s.new_zeros(1)]), cd)


def parent_libraries(parent):
    """{source name: loaded library} of the K2 and K4 kernels of the checkout
    at ``parent``, built from its ``csrc`` (one nvcc each, in parallel) into
    ``sim_a_splat_torch/_build/parent/``."""
    import ctypes
    from pathlib import Path
    from sim_a_splat_torch.ops import _kernels
    csrc = Path(parent).resolve() / "sim_a_splat_torch" / "csrc"
    out = _kernels.BUILD_DIR / "parent"
    out.mkdir(parents=True, exist_ok=True)
    names = ("composite_sel", "composite_sel_bwd", "composite_pair",
             "composite_pair_bwd")
    jobs = {n: (csrc / f"{n}.cu", csrc, out / f"lib{n}.so") for n in names}
    _kernels.compile_all(list(jobs.values()))
    return {n: ctypes.CDLL(str(job[2])) for n, job in jobs.items()}


@contextlib.contextmanager
def kernels_of(libs):
    """The port's wrappers launch the kernels of ``libs`` ({source name:
    library}, e.g. parent_libraries') while inside; the tree's after."""
    from sim_a_splat_torch.ops import _kernels
    saved = {n: _kernels._loaded.get(n) for n in libs}
    _kernels._loaded.update(libs)
    try:
        yield
    finally:
        for n, lib in saved.items():
            if lib is None:
                _kernels._loaded.pop(n, None)
            else:
                _kernels._loaded[n] = lib


def versus_parent(label, fn, parent, reps):
    """With the parent's libraries ``parent``: ``fn()`` (one kernel call
    through its wrapper) timed by CUDA events with the parent's kernels and
    this tree's, in turns (parent, this, this, parent), logged with the
    ratio of the means; returns (this tree's ms, the parent's ms), or None
    without ``parent``."""
    if not parent:
        return None
    times = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        with kernels_of(parent) if who == "parent" else contextlib.nullcontext():
            times[who].append(cuda_ms(fn, reps))
    new, old = (sum(times[k]) / 2 for k in ("this", "parent"))
    log(f"  {label}: this tree {times['this'][0]:.4f} / {times['this'][1]:.4f}"
        f" ms, the parent's kernel {times['parent'][0]:.4f} / "
        f"{times['parent'][1]:.4f} ms (in turns, this call): "
        f"{new / old - 1:+.1%}")
    return new, old


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a "
              "CUDA device", file=sys.stderr)
        return 2
    from sim_a_splat_torch import entry
    from sim_a_splat_torch.ops import (
        _kernels, composite, composite_pair, composite_sel, composite_single,
        rasterize_moving,
    )
    from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
    from sim_a_splat_torch.physics import pusht

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. toolchain ------------------------------------------------------------
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()})")
    log("nvcc: " + run([_kernels.nvcc_path(), "--version"]).splitlines()[-1])
    try:
        import triton
        log(f"triton {triton.__version__} imports")
    except ImportError as e:
        log(f"triton does not import ({e})")

    # 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    report = _kernels.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"(parallel nvcc; rebuilt: {sorted(report) or 'none, cached'})")
    parent = None
    if "--parent" in sys.argv[1:]:
        t0 = time.perf_counter()
        parent = parent_libraries(sys.argv[sys.argv.index("--parent") + 1])
        log(f"the parent's K2 and K4 kernels built in "
            f"{time.perf_counter() - t0:.2f} s")
    for name, r in report.items():
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}.cu ptxas: {line.strip()}")

    # scene and step at full width ---------------------------------------------
    nb, na = max(N // 20, 100), max(N // 50, 50)
    graph = entry.build_scene(n_bg=N - nb - na, n_block=nb, n_agent=na,
                              seed=0, sh_degree=SH_DEGREE, device=dev)
    raster = RasterConfig(tile_size=16, tile_capacity=1024,
                          max_tiles_per_gaussian=16, sigma_cutoff=3.0, term_eps=1e-4,
                          buckets=((4, 0.90), (6, 0.06), (9, 0.04)))
    prepare, step, P = entry.make_step_cached_batch(
        graph, RES, RES, raster, dyn_capacity=DYN_CAP, sel_tiles=SEL_TILES,
        dyn_max_tiles=DYN_M, device=dev)
    scene = graph.scene
    gen = torch.Generator(device=dev).manual_seed(0)
    states0 = pusht.reset(P, gen, B)
    actions = torch.tensor([[150.0, 250.0]], device=dev).expand(B, 2)

    # one step with the kernels' inputs captured (also the warm-up)
    seen = {}

    def capture(key, fn):
        def wrapped(*args, **kw):
            seen[key] = args
            return fn(*args, **kw)
        return wrapped

    with replaced(composite, "composite_static",
                  capture("k1", composite.composite_static)), \
            replaced(composite_sel, "composite_pair_sel",
                     capture("k2", composite_sel.composite_pair_sel)):
        _, imgs0, drop0 = step(prepare(scene), scene, states0, actions)
    torch.cuda.synchronize()
    log(f"first step: n_drop {drop0.tolist()}")

    kernels = []

    # 3. K1 at full size --------------------------------------------------------
    log("K1 composite_static vs composite_static_plain "
        f"(payload {tuple(seen['k1'][0].shape)}):")
    a1 = seen["k1"]
    out_k, car_k, acc_k = composite.composite_static_fwd(*a1)
    out_p, car_p, applied, hits = composite.composite_static_plain(
        *a1, return_work=True)
    pay, counts, skip = a1[:3]
    rows = [0, 1, 2, 4]
    e1 = max(check("K1", out_k[..., rows], out_p[..., rows], TOL, "rgb+trans"),
             check("K1", car_k, car_p, TOL, "carries"))
    dscale = max(1.0, float(pay[:, 8].abs().max()))
    check("K1", out_k[..., 3] / dscale, out_p[..., 3] / dscale, TOL,
          "depth_acc / max depth")
    T, _, K = pay.shape
    P_ = a1[3] ** 2
    nc = K // composite.CHUNK
    cnt = torch.where(skip > 0, counts, 0).long()
    c0 = torch.arange(nc, device=dev) * composite.CHUNK
    per_chunk = torch.clamp(cnt[:, None] - c0, 0, composite.CHUNK)
    used = torch.arange(nc, device=dev)[None] < applied[:, None]
    entries = int((per_chunk * used).sum())
    blended = int(hits.sum())
    b_ms, b_by = bound(entries * 40 + T * 8 + T * P_ * (8 + nc) * 4,
                       ALPHA_FLOPS * P_ * entries + BLEND_FLOPS * blended)
    k1 = dict(name="composite_static", route="cuda",
              source="sim_a_splat_torch/csrc/composite.cu",
              replaces="sim_a_splat_tpu/ops/pallas_composite.py:238",
              max_abs_err=e1,
              ms=cuda_ms(lambda: composite.composite_static(*a1), 20),
              plain_ms=cuda_ms(lambda: composite.composite_static_plain(*a1),
                               3),
              bound_ms=b_ms, bound_by=b_by, library_ms=None)
    chunk_blocks = int(torch.clamp((cnt + composite.CHUNK - 1)
                                   // composite.CHUNK, max=nc).sum())
    log(f"  applied entries {entries} of {int(cnt.clamp(max=K).sum())} "
        f"active, chunks {int(applied.sum())} applied of {chunk_blocks} "
        f"composited by the chunk blocks; (pixel, entry) pairs: "
        f"{P_ * entries} alpha, {blended} blended (α > 0); kernel "
        f"{k1['ms']:.4f} ms (its two launches' device time under the "
        f"profiler {kernel_ms(lambda: composite.composite_static(*a1), 20):.4f}"
        f" ms; "
        f"first design {FIRST_DESIGN_MS['composite_static']} ms), plain "
        f"{k1['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    # the (applied entry, warp) pairs that the cull skips, by the kernels'
    # test's plain twin on K1's warp rectangles
    box1 = composite_sel.cull_boxes(pay, a1[5])             # (T, 4, K)
    cull1 = composite_sel.culled(box1, composite.warp_rects(
        torch.arange(T, device=dev, dtype=torch.int32), a1[3], a1[4]))
    col_used = (torch.arange(K, device=dev) < torch.minimum(
        cnt, applied * composite.CHUNK)[:, None])           # (T, K)
    skipped1 = int((cull1 & col_used[:, None]).sum())
    pairs1 = int(col_used.sum()) * cull1.shape[1]
    log(f"  cull skipped {skipped1} of {pairs1} (applied entry, warp) pairs "
        f"({skipped1 / pairs1:.4f}); {composite.kernel_threads(a1[3])} "
        f"threads a block")
    kernels.append(k1)

    # 3b. K1b at full size, for a numpy-seeded cotangent ----------------------
    log("K1b composite_static_bwd vs composite_static_bwd_plain:")
    ct1 = torch.as_tensor(np.random.default_rng(0).normal(
        size=tuple(out_k.shape)).astype(np.float32), device=dev)
    a1b = (pay, counts, skip, ct1, out_k, car_k, *a1[3:])
    g_k = composite.composite_static_bwd(*a1b, chunk_acc=acc_k)
    g_p = composite.composite_static_bwd_plain(pay, counts, skip, ct1,
                                               *a1[3:])
    e1b = check_rows("K1b", g_k, g_p, "payload grad")
    if not bool(torch.isfinite(g_k).all()):
        raise AssertionError("K1b: gradient not finite")
    # reads: applied payload columns, counts/skip, 5 channels each of ct and
    # out, carries; writes every gradient column once
    b_ms, b_by = bound(entries * 40 + T * 8 + T * P_ * (2 * 5 + nc) * 4
                       + T * 10 * K * 4,
                       ALPHA_FLOPS * P_ * entries + GRAD_FLOPS * blended)
    k1b = dict(name="composite_static_bwd", route="cuda",
               source="sim_a_splat_torch/csrc/composite_bwd.cu",
               replaces="sim_a_splat_tpu/ops/pallas_composite.py:277",
               max_abs_err=e1b,
               ms=cuda_ms(lambda: composite.composite_static_bwd(
                   *a1b, chunk_acc=acc_k), 20),
               plain_ms=cuda_ms(lambda: composite.composite_static_bwd_plain(
                   pay, counts, skip, ct1, *a1[3:]), 3),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"  gradient pairs (α > 0): {blended}; kernel {k1b['ms']:.4f} ms "
        f"(device time under the profiler "
        f"{kernel_ms(lambda: composite.composite_static_bwd(*a1b, chunk_acc=acc_k), 20):.4f}"
        f" ms; first design {FIRST_DESIGN_MS['composite_static_bwd']} ms), "
        f"plain {k1b['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    kernels.append(k1b)

    # 4. K2 at full size --------------------------------------------------------
    a2 = seen["k2"]
    spay, dpay, ids, cs_pad, cd = a2[:5]
    ts2, tx2, sigma2 = a2[5], a2[6], a2[7]
    log(f"K2 composite_pair_sel vs plain (spay {tuple(spay.shape)}, "
        f"dpay {tuple(dpay.shape)}):")
    out_k = composite_sel.composite_pair_sel(*a2)
    out_p, applied, hits = composite_sel.composite_pair_sel_plain(
        *a2, return_work=True)
    bidx = torch.arange(ids.shape[0], device=dev)[:, None]
    sel_k, sel_p = out_k[bidx, ids.long()], out_p[bidx, ids.long()]
    e2 = check("K2", sel_k[:, :, rows], sel_p[:, :, rows], TOL,
               "rgb+trans (selected rows)")
    dscale = max(1.0, float(spay[:, 8].abs().max()), float(dpay[:, :, 8].abs().max()))
    check("K2", sel_k[:, :, 3] / dscale, sel_p[:, :, 3] / dscale, TOL,
          "depth_acc / max depth")
    Ks, Kd = spay.shape[-1], dpay.shape[-1]
    cs_slot = torch.clamp(cs_pad[ids.long()].long(), max=Ks)       # (B, TT)
    c0 = torch.arange(Ks // composite.CHUNK, device=dev) * composite.CHUNK
    per_chunk = torch.clamp(cs_slot[..., None] - c0, 0, composite.CHUNK)
    used = torch.arange(len(c0), device=dev) < applied[..., None]
    s_entries = (per_chunk * used).sum(-1)                          # (B, TT)
    d_entries = torch.clamp(cd.long(), max=Kd)
    entries = int(s_entries.sum() + d_entries.sum())
    blended = int(hits.sum())
    T1 = spay.shape[0]
    tile_need = torch.zeros(T1, dtype=torch.long, device=dev).scatter_reduce(
        0, ids.long().reshape(-1), s_entries.reshape(-1), "amax")
    real = ids.long() < T1 - 1
    rows_written = int(real.sum()) + int((~real).any(dim=1).sum())
    nbytes = (int(tile_need.sum()) * 40 + int(d_entries.sum()) * 40
              + ids.numel() * 8 + T1 * 4 + rows_written * 8 * P_ * 4)
    b_ms, b_by = bound(nbytes,
                       ALPHA_FLOPS * P_ * entries + BLEND_FLOPS * blended)
    k2 = dict(name="composite_pair_sel", route="cuda",
              source="sim_a_splat_torch/csrc/composite_sel.cu",
              replaces="sim_a_splat_tpu/ops/pallas_composite_sel.py:583",
              max_abs_err=e2,
              ms=cuda_ms(lambda: composite_sel.composite_pair_sel(*a2), 10),
              plain_ms=cuda_ms(
                  lambda: composite_sel.composite_pair_sel_plain(*a2), 1),
              bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"  slots {ids.numel()} ({int(real.sum())} real), entries "
        f"{entries}; (pixel, entry) pairs: {P_ * entries} alpha, {blended} "
        f"blended (α > 0); kernel {k2['ms']:.4f} ms "
        f"({composite_sel.blocks_per_sm(False, Kd, ts2)} blocks/SM, "
        f"{composite_sel.smem_bytes(Kd, ts2, False)} B shared; first design "
        f"{FIRST_DESIGN_MS['composite_pair_sel']} ms), plain "
        f"{k2['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    versus_parent("K2f", lambda: composite_sel.composite_pair_sel(*a2),
                  parent, 10)
    # the (entry, warp) pairs of the applied entries that the cull skips,
    # by the kernels' test's plain twin
    sbox = composite_sel.cull_boxes(spay, sigma2)           # (T+1, 4, Ks)
    dbox = composite_sel.cull_boxes(dpay, sigma2).flatten(0, 1)
    lim_s = s_entries.reshape(-1, 1)
    lim_d = d_entries.reshape(-1, 1)
    flat_ids = ids.reshape(-1)
    skipped = pairs = 0
    for s0 in range(0, flat_ids.numel(), 512):
        sl = slice(s0, s0 + 512)
        rects = composite_sel.warp_rects(flat_ids[sl], ts2, tx2)
        cs_ = composite_sel.culled(sbox[flat_ids[sl].long()], rects)
        cd_ = composite_sel.culled(dbox[sl], rects)
        on_s = torch.arange(Ks, device=dev) < lim_s[sl]     # (S, Ks)
        on_d = torch.arange(Kd, device=dev) < lim_d[sl]
        skipped += int((cs_ & on_s[:, None]).sum() + (cd_ & on_d[:, None]).sum())
        pairs += (int(on_s.sum()) + int(on_d.sum())) * rects.shape[1]
    log(f"  cull skipped {skipped} of {pairs} (entry, warp) pairs "
        f"({skipped / pairs:.4f})")
    kernels.append(k2)

    # 4b. K2b at full size, for a numpy-seeded cotangent on the selected rows -
    B_, TT = ids.shape
    log(f"K2b composite_pair_sel_bwd vs composite_pair_sel_bwd_plain "
        f"(all {B_ * TT} slots; the plain version 8 envs at a time):")
    ct2 = torch.zeros_like(out_k)
    ct2[bidx, ids.long(), :5] = torch.as_tensor(np.random.default_rng(1).normal(
        size=(B_, TT, 5, P_)).astype(np.float32), device=dev)
    ct2[:, T1 - 1] = 0.0                       # the trash row: pads only
    a2b = (spay, dpay, ids, cs_pad, cd, ct2, out_k, *a2[5:])

    def k2b_plain():
        g_s, g_d = torch.zeros_like(spay), torch.empty_like(dpay)
        for b0 in range(0, B_, 8):
            sl = slice(b0, b0 + 8)
            s_, d_ = composite_sel.composite_pair_sel_bwd_plain(
                spay, dpay[sl], ids[sl], cs_pad, cd[sl], ct2[sl], *a2[5:])
            g_s += s_
            g_d[sl] = d_
        return g_s, g_d

    gs_p, gd_p = k2b_plain()
    gs_k, gd_k = composite_sel.composite_pair_sel_bwd(*a2b)
    e2b = max(check_rows("K2b", gs_k[:T1 - 1], gs_p[:T1 - 1],
                         "static grad, summed per tile"),
              check_rows("K2b", gd_k, gd_p, "dynamic grad"))
    if not (bool(torch.isfinite(gs_k).all()) and bool(torch.isfinite(gd_k).all())):
        raise AssertionError("K2b: gradient not finite")
    if bool(gs_k[T1 - 1].any()) or bool(gd_k[~real].any()):
        raise AssertionError("K2b: pad slots or the trash row got a nonzero "
                             "gradient")
    # reads as K2f plus 5 channels each of ct and out at every written row;
    # writes the per-tile static gradient (atomic adds into (T+1, 10, Ks))
    # and the per-slot dynamic gradient once
    b_ms, b_by = bound(int(tile_need.sum()) * 40 + int(d_entries.sum()) * 40
                       + ids.numel() * 8 + T1 * 4 + rows_written * 2 * 5 * P_ * 4
                       + T1 * 10 * Ks * 4 + ids.numel() * 10 * Kd * 4,
                       ALPHA_FLOPS * P_ * entries + GRAD_FLOPS * blended)
    k2b = dict(name="composite_pair_sel_bwd", route="cuda",
               source="sim_a_splat_torch/csrc/composite_sel_bwd.cu",
               replaces="sim_a_splat_tpu/ops/pallas_composite_sel.py:633",
               max_abs_err=e2b,
               # the whole gradient: the per-tile sum is in the kernel
               ms=cuda_ms(lambda: composite_sel.composite_pair_sel_bwd(*a2b),
                          10),
               plain_ms=cuda_ms(k2b_plain, 1, warmup=0),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"  gradient pairs (α > 0): {blended}; kernel {k2b['ms']:.4f} ms "
        f"with the per-tile sum and its zero fill "
        f"({composite_sel.blocks_per_sm(True, Kd, ts2)} blocks/SM, "
        f"{composite_sel.smem_bytes(Kd, ts2, True)} B shared; first design "
        f"{FIRST_DESIGN_MS['composite_pair_sel_bwd']} ms), plain "
        f"{k2b['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    versus_parent("K2b", lambda: composite_sel.composite_pair_sel_bwd(*a2b),
                  parent, 10)
    kernels.append(k2b)
    # free the checks' tensors before the forward step's peak-memory reading
    del ct1, a1b, acc_k, g_k, g_p, ct2, a2b, gs_k, gd_k, gs_p, gd_p

    # 5. the main path forward, timed ----------------------------------------
    def reset_counts():
        for m in (composite, composite_sel, composite_single, composite_pair):
            m.launches = 0
            m.launches_bwd = 0

    def counts_now():
        return {"composite_static": composite.launches,
                "composite_pair_sel": composite_sel.launches,
                "composite_static_bwd": composite.launches_bwd,
                "composite_pair_sel_bwd": composite_sel.launches_bwd,
                "composite_sel_single": composite_single.launches,
                "composite_sel_single_bwd": composite_single.launches_bwd,
                "composite_pair": composite_pair.launches,
                "composite_pair_bwd": composite_pair.launches_bwd}

    fixed_names = ("composite_static", "composite_pair_sel",
                   "composite_static_bwd", "composite_pair_sel_bwd")

    reset_counts()
    states = states0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_host = time.perf_counter()
    start.record()
    drops = []
    for _ in range(ITERS):
        cache = prepare(scene)
        states, imgs, n_drop = step(cache, scene, states, actions)
        drops.append(n_drop)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_host
    launches = counts_now()
    step_ms = start.elapsed_time(end) / ITERS
    drops = torch.stack(drops).cpu()
    exact = bool((drops[:, 0] == 0).all())
    log(f"main path, forward: {ITERS} × (prepare + step_batch), B={B}, N={N}, "
        f"sh{SH_DEGREE}, {RES}²: {step_ms:.2f} ms/step (events), "
        f"{wall / ITERS * 1e3:.2f} ms/step (host clock), "
        f"{B * 1e3 / step_ms:.1f} frames/s; exact={exact}, "
        f"bounded truncations={int(drops[-1, 1])}, launches {launches}, "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not exact:
        raise AssertionError(f"sel-dropped tiles: {drops[:, 0].tolist()}")
    for name in ("composite_static", "composite_pair_sel"):
        if launches[name] < ITERS:
            raise AssertionError(f"kernel {name} launched {launches[name]} "
                                 f"times in {ITERS} steps of the main path")
    for name in ("composite_static_bwd", "composite_pair_sel_bwd",
                 "composite_sel_single", "composite_sel_single_bwd",
                 "composite_pair", "composite_pair_bwd"):
        if launches[name]:
            raise AssertionError(f"the forward step launched {name}")
    if imgs.shape != (B, 3, RES, RES) or not bool(torch.isfinite(imgs).all()):
        raise AssertionError(f"bad images {tuple(imgs.shape)}")
    # each phase alone; the render is step_batch with the control step
    # replaced by its precomputed result
    prep_ms = cuda_ms(lambda: prepare(scene), 3)
    phys_ms = cuda_ms(lambda: pusht.control_step(P, states0, actions), 3)
    cache0, s_next = prepare(scene), pusht.control_step(P, states0, actions)
    with replaced(pusht, "control_step", lambda *_: s_next):
        rend_ms = cuda_ms(lambda: step(cache0, scene, states0, actions), 3)
        rend_dev_ms = device_profile(
            lambda: step(cache0, scene, states0, actions))[0]
    log(f"breakdown (events, each phase alone): prepare {prep_ms:.2f} ms, "
        f"control_step {phys_ms:.2f} ms, step_batch without control_step "
        f"{rend_ms:.2f} ms (first K2 design: 8.96 ms; its device time "
        f"{rend_dev_ms:.2f} ms); sum {prep_ms + phys_ms + rend_ms:.2f} ms vs "
        f"{step_ms:.2f} ms/step")

    # image against the port's plain path on the first 8 envs
    s8 = pusht.PushTState(*(f[:8] for f in states0))
    _, imgs_k, drop_k = step(prepare(scene), scene, s8, actions[:8])
    with replaced(composite, "composite_static",
                  composite.composite_static_plain), \
            replaced(composite_sel, "composite_pair_sel",
                     composite_sel.composite_pair_sel_plain):
        _, imgs_p, drop_p = step(prepare(scene), scene, s8, actions[:8])
    e_img = check("step", imgs_k, imgs_p, TOL,
                  "image vs the plain path (first 8 envs)")
    if drop_k.tolist() != drop_p.tolist():
        raise AssertionError(f"n_drop {drop_k.tolist()} (kernels) vs "
                             f"{drop_p.tolist()} (plain)")

    # device profile of one step (where the time goes) -------------------------
    def profiled(label, fn, ms_per_step):
        dev_ms, avg = device_profile(fn)
        table = avg.table(sort_by="self_cuda_time_total", row_limit=11)
        log(f"profile of one {label}: device time {dev_ms:.2f} ms of "
            f"{ms_per_step:.2f} ms/step, idle share "
            f"{1 - dev_ms / ms_per_step:.3f}")
        for line in table.splitlines()[:14]:
            log("  " + line)

    profiled("step", lambda: step(prepare(scene), scene, states0, actions),
             step_ms)

    # 6. the main path's train step, timed ------------------------------------
    fields = [n for n, f in zip(scene._fields, scene) if f is not None]
    reset_counts()
    states = states0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_host = time.perf_counter()
    start.record()
    out_train = []
    for _ in range(ITERS):
        states, loss, n_drop, grads = entry.loss_and_grads(
            prepare, step, scene, states, actions)
        out_train.append((loss, n_drop, grads))
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_host
    launches = counts_now()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    launches = {n: launches[n] for n in fixed_names}
    train_ms = start.elapsed_time(end) / ITERS
    drops = torch.stack([o[1] for o in out_train]).cpu()
    exact = bool((drops[:, 0] == 0).all())
    finite = all(bool(torch.isfinite(getattr(g, n)).all())
                 for _, _, g in out_train for n in fields)
    log(f"main path, train: {ITERS} × loss_and_grads (prepare + step_batch + "
        f"mean(imgs²) + its gradient to {', '.join(fields)}): "
        f"{train_ms:.2f} ms/step (events), {wall / ITERS * 1e3:.2f} ms/step "
        f"(host clock), {B * 1e3 / train_ms:.1f} frames/s; exact={exact}, "
        f"grads finite={finite}, loss {float(out_train[-1][0]):.6f}, "
        f"launches {launches}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not exact:
        raise AssertionError(f"sel-dropped tiles: {drops[:, 0].tolist()}")
    if not finite:
        raise AssertionError("a gradient of the train step is not finite")
    for name, n in launches.items():
        if n < ITERS:
            raise AssertionError(f"kernel {name} launched {n} times in "
                                 f"{ITERS} train steps of the main path")
    # its forward and backward alone (the backward on a kept graph)
    leaves = type(scene)(*(None if f is None else f.detach().requires_grad_()
                           for f in scene))
    leaf_list = [f for f in leaves if f is not None]

    def forward():
        _, imgs_, _ = step(prepare(leaves), leaves, states0, actions)
        return torch.mean(imgs_ ** 2)

    fwd_ms = cuda_ms(forward, 3)
    loss0 = forward()
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(loss0, leaf_list,
                                                 retain_graph=True), 3)
    bwd_dev_ms = device_profile(lambda: torch.autograd.grad(
        loss0, leaf_list, retain_graph=True))[0]
    del loss0
    log(f"breakdown (events, each phase alone): forward with the graph kept "
        f"{fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms (its device time "
        f"{bwd_dev_ms:.2f} ms); sum {fwd_ms + bwd_ms:.2f} ms vs "
        f"{train_ms:.2f} ms/step")
    profiled("train step", lambda: entry.loss_and_grads(
        prepare, step, scene, states0, actions), train_ms)

    # 7. the train step's gradients against the port's plain path, 8 envs ------
    _, loss_k, drop_k, g_k = entry.loss_and_grads(prepare, step, scene, s8,
                                                  actions[:8])
    with replaced(composite, "composite_static",
                  composite.composite_static_plain), \
            replaced(composite_sel, "composite_pair_sel",
                     composite_sel.composite_pair_sel_plain):
        _, loss_p, drop_p, g_p = entry.loss_and_grads(prepare, step, scene,
                                                      s8, actions[:8])
    if drop_k.tolist() != drop_p.tolist():
        raise AssertionError(f"n_drop {drop_k.tolist()} (kernels) vs "
                             f"{drop_p.tolist()} (plain)")
    log(f"train step vs the plain path (first 8 envs): loss {float(loss_k)} "
        f"vs {float(loss_p)}")
    e_grad = check_fields("train-step", g_k, g_p, fields)

    log(f"image max|Δ| vs plain: {e_img:.3e}; train-step gradients max|Δ| / "
        f"max|g|: {e_grad:.3e}; {time.perf_counter() - t_start:.1f} s so far")
    del out_train, g_k, g_p

    # 8-11. the per-env fixed-camera step (kernel K4) --------------------------
    kernels += per_env_camera(entry, composite, composite_sel, composite_pair,
                              pusht, graph, scene, P, states0, actions,
                              raster, imgs0, drop0, reset_counts, counts_now,
                              profiled, parent, dev)
    del imgs0
    log(f"{time.perf_counter() - t_start:.1f} s so far")

    # 11b. K2 and K4 at a dynamic capacity past their backward kernels'
    # windows, and at tile size 32 ---------------------------------------------
    large_capacity(entry, composite_sel, composite_pair, pusht, graph, scene,
                   states0, actions, raster, parent, dev)
    log(f"{time.perf_counter() - t_start:.1f} s so far")

    # 12-15. the moving camera -----------------------------------------------
    kernels += moving_camera(entry, composite, composite_single,
                             rasterize_moving, pusht, graph, scene, P, gen,
                             reset_counts, counts_now, profiled, dev)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def per_env_camera(entry, composite, composite_sel, composite_pair, pusht,
                   graph, scene, P, states0, actions, raster, imgs_sel,
                   drop_sel, reset_counts, counts_now, profiled, parent, dev):
    """The per-env fixed-camera path (``entry.make_step_cached``, the
    reference's vmapped ``_make_step_cached``): K4f/K4b against their plain
    versions at full size, against K2f/K2b on the same (env, tile) pairs
    (bit for bit) and, with ``parent``, timed beside the parent's kernels;
    ITERS forward steps and ITERS train steps (timed, launches checked), the
    images against the plain path (8 envs), against the selected-tile
    path's ``imgs_sel`` (same states, both exact) and with
    ``static_skip=False`` (16 envs), and the gradients against the plain
    path (8 envs).  Returns the K4f and K4b entries of the ``kernels``
    line."""
    import numpy as np
    import torch
    prepare, step, _ = entry.make_step_cached(
        graph, RES, RES, raster, dyn_capacity=DYN_CAP, dyn_max_tiles=DYN_M,
        device=dev)

    # 8. K4f and K4b at full size, on one step's captured inputs -------------
    seen = {}
    real_k4 = composite_pair.composite_pair

    def capture(*args):
        seen["k4"] = args
        return real_k4(*args)

    with replaced(composite_pair, "composite_pair", capture):
        _, imgs0, trunc0 = step(prepare(scene), scene, states0, actions)
    torch.cuda.synchronize()
    a4 = seen.pop("k4")
    spay, dpay, cs, cd, skip = a4[:5]
    Bk, T = skip.shape
    Ks, Kd = spay.shape[-1], dpay.shape[-1]
    P_ = a4[5] ** 2
    log(f"per-env step (make_step_cached, B={Bk}): first step's bounded "
        f"truncations {int(trunc0.sum())}")
    log(f"K4 composite_pair vs composite_pair_plain (spay "
        f"{tuple(spay.shape)}, dpay {tuple(dpay.shape)}):")
    out_k = composite_pair.composite_pair(*a4)
    out_p, applied, hits = composite_pair.composite_pair_plain(
        *a4, return_work=True)
    rows = [0, 1, 2, 4]
    e4 = check("K4", out_k[..., rows], out_p[..., rows], TOL, "rgb+trans")
    dscale = max(1.0, float(spay[:, 8].abs().max()),
                 float(dpay[:, :, 8].abs().max()))
    check("K4", out_k[..., 3] / dscale, out_p[..., 3] / dscale, TOL,
          "depth_acc / max depth")
    on = skip > 0
    c0 = torch.arange(Ks // composite.CHUNK, device=dev) * composite.CHUNK
    per_chunk = torch.clamp(torch.clamp(cs.long(), max=Ks)[:, None] - c0, 0,
                            composite.CHUNK)                   # (T, nc)
    used = torch.arange(len(c0), device=dev) < applied[..., None]
    s_entries = (per_chunk * used).sum(-1)                     # (B, T)
    d_entries = torch.clamp(cd.long(), max=Kd) * on
    entries = int(s_entries.sum() + d_entries.sum())
    blended = int(hits.sum())
    n_on = int(on.sum())
    # reads each tile's applied static columns once (shared by the envs),
    # the touched pairs' dynamic entries, counts and skip; writes every
    # (env, tile) row of out
    in_bytes = (int(s_entries.amax(0).sum()) * 40 + int(d_entries.sum()) * 40
                + T * 4 + Bk * T * 8)
    b_ms, b_by = bound(in_bytes + Bk * T * P_ * 8 * 4,
                       ALPHA_FLOPS * P_ * entries + BLEND_FLOPS * blended)
    k4 = dict(name="composite_pair", route="cuda",
              source="sim_a_splat_torch/csrc/composite_pair.cu",
              replaces="sim_a_splat_tpu/ops/pallas_composite_pair.py:352",
              max_abs_err=e4,
              ms=cuda_ms(lambda: composite_pair.composite_pair(*a4), 10),
              plain_ms=cuda_ms(
                  lambda: composite_pair.composite_pair_plain(*a4), 1),
              bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"  touched (env, tile) pairs {n_on} of {Bk * T}, entries {entries}; "
        f"(pixel, entry) pairs: {P_ * entries} alpha, {blended} blended "
        f"(α > 0); kernel {k4['ms']:.4f} ms (first design "
        f"{FIRST_DESIGN_MS['composite_pair']} ms), plain "
        f"{k4['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    versus_parent("K4f", lambda: composite_pair.composite_pair(*a4), parent,
                  10)
    # K4 runs K2's block body: K2f on the same (env, tile) pairs
    a2 = k2_slots_of_k4(*a4[:5])
    ids = a2[2]
    out2 = composite_sel.composite_pair_sel(*a2, *a4[5:])
    bidx = torch.arange(Bk, device=dev)[:, None]
    real = ids < T
    safe = torch.where(real, ids, 0).long()
    same = torch.equal(out_k[bidx, safe][real],
                       out2[bidx, safe][real].transpose(-1, -2))
    k2_ms = cuda_ms(lambda: composite_sel.composite_pair_sel(*a2, *a4[5:]),
                    10)
    log(f"  K4f on the {int(real.sum())} touched pairs equals K2f on the same "
        f"pairs (slots of {tuple(ids.shape)}) bit for bit: {same}; K2f there "
        f"{k2_ms:.4f} ms, K4f {k4['ms']:.4f} ms "
        f"({k4['ms'] / k2_ms:.2f}×, with the skipped pairs' output)")
    if not same:
        raise AssertionError("K4f differs from K2f on the same pairs")

    log("K4b composite_pair_bwd vs composite_pair_bwd_plain (the plain "
        "version 8 envs at a time):")
    ct4 = torch.zeros_like(out_k)
    ct4[on] = torch.nn.functional.pad(torch.as_tensor(
        np.random.default_rng(3).normal(size=(n_on, P_, 5)).astype(
            np.float32), device=dev), (0, 3))
    a4b = (spay, dpay, cs, cd, skip, ct4, out_k, *a4[5:])
    gs_k, gd_k = composite_pair.composite_pair_bwd(*a4b)

    def k4b_plain():
        g_s, g_d = torch.zeros_like(spay), torch.empty_like(dpay)
        for b0 in range(0, Bk, 8):
            sl = slice(b0, b0 + 8)
            s_, d_ = composite_pair.composite_pair_bwd_plain(
                spay, dpay[sl], cs, cd[sl], skip[sl], ct4[sl], *a4[5:])
            g_s += s_
            g_d[sl] = d_
        return g_s, g_d

    gs_p, gd_p = k4b_plain()
    e4b = max(check_rows("K4b", gs_k, gs_p, "static grad, summed over envs"),
              check_rows("K4b", gd_k, gd_p, "dynamic grad"))
    if not (bool(torch.isfinite(gs_k).all())
            and bool(torch.isfinite(gd_k).all())):
        raise AssertionError("K4b: gradient not finite")
    if bool(gd_k[~on].any()):
        raise AssertionError("K4b: a skipped pair got a dynamic gradient")
    # reads as K4f plus 5 channels each of ct and out at the touched pairs;
    # writes the static gradient and the whole dynamic gradient once
    b_ms, b_by = bound(in_bytes + n_on * 2 * 5 * P_ * 4
                       + (spay.numel() + dpay.numel()) * 4,
                       ALPHA_FLOPS * P_ * entries + GRAD_FLOPS * blended)
    k4b = dict(name="composite_pair_bwd", route="cuda",
               source="sim_a_splat_torch/csrc/composite_pair_bwd.cu",
               replaces="sim_a_splat_tpu/ops/pallas_composite_pair.py:386",
               max_abs_err=e4b,
               ms=cuda_ms(lambda: composite_pair.composite_pair_bwd(*a4b),
                          10),
               plain_ms=cuda_ms(k4b_plain, 1, warmup=0),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"  gradient pairs (α > 0): {blended}; kernel {k4b['ms']:.4f} ms "
        f"(with the zero fill of the static gradient; first design "
        f"{FIRST_DESIGN_MS['composite_pair_bwd']} ms), plain "
        f"{k4b['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    versus_parent("K4b", lambda: composite_pair.composite_pair_bwd(*a4b),
                  parent, 10)
    ct2 = torch.zeros_like(out2)
    ct2[bidx, ids.long()] = torch.where(             # pads: the trash row
        real[..., None, None], ct4[bidx, safe].transpose(-1, -2), 0.0)
    a2b = (*a2, ct2, out2, *a4[5:])
    _, gd2 = composite_sel.composite_pair_sel_bwd(*a2b)
    same = torch.equal(gd_k[bidx, safe][real], gd2[real])
    k2b_ms = cuda_ms(lambda: composite_sel.composite_pair_sel_bwd(*a2b), 10)
    log(f"  K4b's dynamic gradient on the touched pairs equals K2b's bit for "
        f"bit: {same}; K2b there {k2b_ms:.4f} ms, K4b {k4b['ms']:.4f} ms "
        f"({k4b['ms'] / k2b_ms:.2f}×, with the skipped pairs' zero rows)")
    if not same:
        raise AssertionError("K4b's dynamic gradient differs from K2b's")
    del a4, a4b, out_k, out_p, ct4, gs_k, gd_k, gs_p, gd_p, spay, dpay
    del a2, a2b, out2, ct2, gd2

    # 9. the per-env step forward, timed --------------------------------------
    def forward_counts(n):
        want = dict.fromkeys(counts_now(), 0)
        want.update(composite_static=n, composite_pair=n)
        return want

    reset_counts()
    states = states0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_host = time.perf_counter()
    start.record()
    for _ in range(ITERS):
        states, imgs, trunc = step(prepare(scene), scene, states, actions)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_host
    launches = counts_now()
    step_ms = start.elapsed_time(end) / ITERS
    log(f"per-env step, forward: {ITERS} × (prepare + step), B={B}, N={N}, "
        f"sh{SH_DEGREE}, {RES}²: {step_ms:.2f} ms/step (events), "
        f"{wall / ITERS * 1e3:.2f} ms/step (host clock), "
        f"{B * 1e3 / step_ms:.1f} frames/s; bounded truncations "
        f"{int(trunc.sum())}, launches {launches}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches != forward_counts(ITERS):
        raise AssertionError(f"{ITERS} forward steps of the per-env path "
                             f"launched {launches}")
    if imgs.shape != (B, RES, RES, 3) or not bool(torch.isfinite(imgs).all()):
        raise AssertionError(f"bad per-env images {tuple(imgs.shape)}")
    prep_ms = cuda_ms(lambda: prepare(scene), 3)
    cache0, s_next = prepare(scene), pusht.control_step(P, states0, actions)
    with replaced(pusht, "control_step", lambda *_: s_next):
        rend_ms = cuda_ms(lambda: step(cache0, scene, states0, actions), 3)
    log(f"breakdown (events, each phase alone): prepare {prep_ms:.2f} ms, "
        f"step without control_step {rend_ms:.2f} ms")
    del cache0
    profiled("per-env step", lambda: step(prepare(scene), scene, states0,
                                          actions), step_ms)

    # 10. its images against the plain path, the selected-tile path and the
    # step without the static skip -------------------------------------------
    s8 = pusht.PushTState(*(f[:8] for f in states0))
    _, imgs_k, tr_k = step(prepare(scene), scene, s8, actions[:8])
    with replaced(composite, "composite_static",
                  composite.composite_static_plain), \
            replaced(composite_pair, "composite_pair",
                     composite_pair.composite_pair_plain):
        _, imgs_p, tr_p = step(prepare(scene), scene, s8, actions[:8])
    e_img = check("per-env step", imgs_k, imgs_p, TOL,
                  "image vs the plain path (first 8 envs)")
    if tr_k.tolist() != tr_p.tolist():
        raise AssertionError(f"truncations {tr_k.tolist()} (kernels) vs "
                             f"{tr_p.tolist()} (plain)")
    if int(drop_sel[0]) != 0:
        raise AssertionError(f"the selected-tile step dropped tiles: "
                             f"{drop_sel.tolist()}")
    check("per-env step", imgs0, imgs_sel.permute(0, 2, 3, 1), TOL,
          f"image vs the selected-tile path (all {B} envs, both exact)")
    prep_ns, step_ns, _ = entry.make_step_cached(
        graph, RES, RES, raster, dyn_capacity=DYN_CAP, dyn_max_tiles=DYN_M,
        static_skip=False, device=dev)
    s16 = pusht.PushTState(*(f[:16] for f in states0))
    reset_counts()
    _, imgs_ns, _ = step_ns(prep_ns(scene), scene, s16, actions[:16])
    launches = counts_now()
    check("per-env step", imgs_ns, imgs0[:16], TOL,
          "static_skip=False vs True (first 16 envs)")
    if launches["composite_static"] or launches["composite_pair"] != 1:
        raise AssertionError(f"the step without the static skip launched "
                             f"{launches}")
    del imgs_ns, imgs_k, imgs_p, imgs0

    # 11. the per-env train step, timed, and its gradients against the plain
    # path on 8 envs -----------------------------------------------------------
    fields = [n for n, f in zip(scene._fields, scene) if f is not None]
    reset_counts()
    states = states0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_host = time.perf_counter()
    start.record()
    finite = True
    for _ in range(ITERS):
        states, loss, _, grads = entry.loss_and_grads(prepare, step, scene,
                                                      states, actions)
        finite &= all(bool(torch.isfinite(getattr(grads, n)).all())
                      for n in fields)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_host
    launches = counts_now()
    train_ms = start.elapsed_time(end) / ITERS
    log(f"per-env step, train: {ITERS} × loss_and_grads: {train_ms:.2f} "
        f"ms/step (events), {wall / ITERS * 1e3:.2f} ms/step (host clock), "
        f"{B * 1e3 / train_ms:.1f} frames/s; grads finite={finite}, loss "
        f"{float(loss):.6f}, launches {launches}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    want = forward_counts(ITERS)
    want.update(composite_static_bwd=ITERS, composite_pair_bwd=ITERS)
    if launches != want:
        raise AssertionError(f"{ITERS} train steps of the per-env path "
                             f"launched {launches}")
    if not finite:
        raise AssertionError("a gradient of the per-env train step is not "
                             "finite")
    k4["launches"] = launches["composite_pair"]
    k4b["launches"] = launches["composite_pair_bwd"]
    del grads

    _, loss_k, _, g_k = entry.loss_and_grads(prepare, step, scene, s8,
                                             actions[:8])
    with replaced(composite, "composite_static",
                  composite.composite_static_plain), \
            replaced(composite_pair, "composite_pair",
                     composite_pair.composite_pair_plain):
        _, loss_p, _, g_p = entry.loss_and_grads(prepare, step, scene, s8,
                                                 actions[:8])
    log(f"per-env train step vs the plain path (first 8 envs): loss "
        f"{float(loss_k)} vs {float(loss_p)}")
    e_grad = check_fields("per-env train-step", g_k, g_p, fields)
    log(f"per-env image max|Δ| vs plain: {e_img:.3e}; gradients max|Δ| / "
        f"max|g|: {e_grad:.3e}")
    return [k4, k4b]


def large_capacity(entry, composite_sel, composite_pair, pusht, graph, scene,
                   states0, actions, raster, parent, dev):
    """K2f, K2b, K4f and K4b at ``dyn_capacity`` BIG_KD, past the dynamic
    windows of the backward kernels (896 entries at ts 16) and past the
    first design's card limits, on LONG_ENVS envs of the main path's scene
    through the selected-tile and the per-env steps, against their plain
    versions run in float64 (their float32 log-space sums drift over
    dynamic lists of thousands of entries), the gradients at TOL_GRAD_LONG;
    then all four at tile size 32 and ``dyn_capacity`` TS32_KD on 8 envs
    (the backward's window: 128 entries), K4 against K2 on the same pairs
    bit for bit, timed (beside the parent's kernels with ``parent``)."""
    import numpy as np
    import torch

    def f64(args):
        return [a.double() if torch.is_tensor(a) and a.is_floating_point()
                else a for a in args]
    sN = pusht.PushTState(*(f[:LONG_ENVS] for f in states0))
    aN = actions[:LONG_ENVS]
    seen = {}

    def capture(key, fn):
        def wrapped(*args):
            seen[key] = args
            return fn(*args)
        return wrapped

    prepare, step, _ = entry.make_step_cached_batch(
        graph, RES, RES, raster, dyn_capacity=BIG_KD, sel_tiles=SEL_TILES,
        dyn_max_tiles=DYN_M, device=dev)
    with replaced(composite_sel, "composite_pair_sel",
                  capture("k2", composite_sel.composite_pair_sel)):
        step(prepare(scene), scene, sN, aN)
    a2 = seen.pop("k2")
    spay, dpay, ids, cs_pad, cd = a2[:5]
    ts = a2[5]
    T1 = spay.shape[0]
    log(f"K2 at dyn_capacity {BIG_KD} ({LONG_ENVS} envs; windows of "
        f"{composite_sel.window(BIG_KD, ts, False)} (K2f) and "
        f"{composite_sel.window(BIG_KD, ts, True)} (K2b) entries, largest "
        f"dynamic count {int(cd.max())}):")
    rows = [0, 1, 2, 4]
    out_k = composite_sel.composite_pair_sel(*a2)
    out_p = composite_sel.composite_pair_sel_plain(*f64(a2))
    bidx = torch.arange(ids.shape[0], device=dev)[:, None]
    sel_k, sel_p = out_k[bidx, ids.long()], out_p[bidx, ids.long()]
    check("K2", sel_k[:, :, rows], sel_p[:, :, rows], TOL,
          "rgb+trans (selected rows)")
    dscale = max(1.0, float(spay[:, 8].abs().max()),
                 float(dpay[:, :, 8].abs().max()))
    check("K2", sel_k[:, :, 3] / dscale, sel_p[:, :, 3] / dscale, TOL,
          "depth_acc / max depth")
    ct = torch.zeros_like(out_k)
    ct[bidx, ids.long(), :5] = torch.as_tensor(np.random.default_rng(4).normal(
        size=(*ids.shape, 5, out_k.shape[-1])).astype(np.float32), device=dev)
    ct[:, T1 - 1] = 0.0
    a2b = (*a2[:5], ct, out_k, *a2[5:])
    gs_k, gd_k = composite_sel.composite_pair_sel_bwd(*a2b)
    gs_p, gd_p = composite_sel.composite_pair_sel_bwd_plain(
        *f64(a2[:5]), ct.double(), *a2[5:])
    check_rows("K2b", gs_k[:T1 - 1], gs_p[:T1 - 1],
               "static grad, summed per tile", TOL_GRAD_LONG)
    check_rows("K2b", gd_k, gd_p, "dynamic grad", TOL_GRAD_LONG)
    log(f"  K2f {cuda_ms(lambda: composite_sel.composite_pair_sel(*a2), 5):.4f}"
        f" ms ({composite_sel.smem_bytes(BIG_KD, ts, False)} B shared), K2b "
        f"{cuda_ms(lambda: composite_sel.composite_pair_sel_bwd(*a2b), 5):.4f}"
        f" ms ({composite_sel.smem_bytes(BIG_KD, ts, True)} B shared)")
    del a2, a2b, spay, dpay, out_k, out_p, sel_k, sel_p, ct, gs_k, gd_k
    del gs_p, gd_p

    prepare, step, _ = entry.make_step_cached(
        graph, RES, RES, raster, dyn_capacity=BIG_KD, dyn_max_tiles=DYN_M,
        device=dev)
    with replaced(composite_pair, "composite_pair",
                  capture("k4", composite_pair.composite_pair)):
        step(prepare(scene), scene, sN, aN)
    a4 = seen.pop("k4")
    skip = a4[4]
    log(f"K4 at dyn_capacity {BIG_KD} ({LONG_ENVS} envs, "
        f"{int((skip > 0).sum())} touched pairs, largest dynamic count "
        f"{int(a4[3].max())}):")
    out_k = composite_pair.composite_pair(*a4)
    out_p = composite_pair.composite_pair_plain(*f64(a4))
    check("K4", out_k[..., rows], out_p[..., rows], TOL, "rgb+trans")
    dscale = max(1.0, float(a4[0][:, 8].abs().max()),
                 float(a4[1][:, :, 8].abs().max()))
    check("K4", out_k[..., 3] / dscale, out_p[..., 3] / dscale, TOL,
          "depth_acc / max depth")
    ct = torch.zeros_like(out_k)
    ct[skip > 0] = torch.nn.functional.pad(torch.as_tensor(
        np.random.default_rng(5).normal(
            size=(int((skip > 0).sum()), out_k.shape[2], 5)).astype(
                np.float32), device=dev), (0, 3))
    a4b = (*a4[:5], ct, out_k, *a4[5:])
    gs_k, gd_k = composite_pair.composite_pair_bwd(*a4b)
    gs_p, gd_p = composite_pair.composite_pair_bwd_plain(*f64(a4[:5]),
                                                         ct.double(), *a4[5:])
    check_rows("K4b", gs_k, gs_p, "static grad, summed over envs",
               TOL_GRAD_LONG)
    check_rows("K4b", gd_k, gd_p, "dynamic grad", TOL_GRAD_LONG)
    log(f"  K4f {cuda_ms(lambda: composite_pair.composite_pair(*a4), 5):.4f} "
        f"ms, K4b {cuda_ms(lambda: composite_pair.composite_pair_bwd(*a4b), 5):.4f} ms")
    del a4, a4b, out_k, out_p, ct, gs_k, gd_k, gs_p, gd_p

    # tile size 32: K2b's and K4b's window is one chunk -----------------------
    raster32 = raster._replace(tile_size=32, tile_capacity=4096)
    s8 = pusht.PushTState(*(f[:8] for f in states0))
    prepare, step, _ = entry.make_step_cached_batch(
        graph, RES, RES, raster32, dyn_capacity=TS32_KD, sel_tiles=SEL_TILES,
        dyn_max_tiles=DYN_M, device=dev)
    with replaced(composite_sel, "composite_pair_sel",
                  capture("k2", composite_sel.composite_pair_sel)):
        step(prepare(scene), scene, s8, actions[:8])
    prepare, step, _ = entry.make_step_cached(
        graph, RES, RES, raster32, dyn_capacity=TS32_KD, dyn_max_tiles=DYN_M,
        device=dev)
    with replaced(composite_pair, "composite_pair",
                  capture("k4", composite_pair.composite_pair)):
        step(prepare(scene), scene, s8, actions[:8])
    a2, a4 = seen.pop("k2"), seen.pop("k4")
    log(f"K2 and K4 at tile size 32, dyn_capacity {TS32_KD} (8 envs; "
        f"windows {composite_sel.window(TS32_KD, 32, False)} forward, "
        f"{composite_sel.window(TS32_KD, 32, True)} backward; largest dynamic "
        f"count {int(a2[4].max())}, {int((a4[4] > 0).sum())} touched pairs):")
    out2 = composite_sel.composite_pair_sel(*a2)
    out4 = composite_pair.composite_pair(*a4)
    k2 = k2_slots_of_k4(*a4[:5])
    real = k2[2] < a4[4].shape[1]
    safe = torch.where(real, k2[2], 0).long()
    b8 = torch.arange(8, device=dev)[:, None]
    same = torch.equal(out4[b8, safe][real], composite_sel.composite_pair_sel(
        *k2, *a4[5:])[b8, safe][real].transpose(-1, -2))
    log(f"  K4f equals K2f on the touched pairs bit for bit: {same}")
    if not same:
        raise AssertionError("K4f differs from K2f on the same pairs at "
                             "tile size 32")
    ids = a2[2]
    ct2 = torch.zeros_like(out2)
    ct2[b8, ids.long(), :5] = torch.as_tensor(np.random.default_rng(6).normal(
        size=(*ids.shape, 5, out2.shape[-1])).astype(np.float32), device=dev)
    ct2[:, -1] = 0.0
    ct4 = torch.zeros_like(out4)
    ct4[a4[4] > 0] = torch.nn.functional.pad(torch.as_tensor(
        np.random.default_rng(7).normal(
            size=(int((a4[4] > 0).sum()), out4.shape[2], 5)).astype(
                np.float32), device=dev), (0, 3))
    a2b = (*a2[:5], ct2, out2, *a2[5:])
    a4b = (*a4[:5], ct4, out4, *a4[5:])
    for g in (*composite_sel.composite_pair_sel_bwd(*a2b),
              *composite_pair.composite_pair_bwd(*a4b)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError("a gradient at tile size 32 is not finite")
    for label, fn in (
            ("K2f", lambda: composite_sel.composite_pair_sel(*a2)),
            ("K2b", lambda: composite_sel.composite_pair_sel_bwd(*a2b)),
            ("K4f", lambda: composite_pair.composite_pair(*a4)),
            ("K4b", lambda: composite_pair.composite_pair_bwd(*a4b))):
        if versus_parent(f"{label} at ts 32", fn, parent, 5) is None:
            log(f"  {label} at ts 32: {cuda_ms(fn, 5):.4f} ms")


def moving_camera(entry, composite, composite_single, rasterize_moving,
                  pusht, graph, scene, P, gen, reset_counts, counts_now,
                  profiled, dev):
    """The moving-camera path: K3f/K3b against their plain versions at full
    size, the B=32 forward rollout (timed, profiled, one frame against the
    full rebin), the B=16 train rollout (timed, broken down) and its
    gradients against the plain path.  Returns the K3f and K3b entries of
    the ``kernels`` line."""
    import numpy as np
    import torch
    from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
    raster = RasterConfig(tile_size=16, tile_capacity=1024,
                          max_tiles_per_gaussian=16, sigma_cutoff=3.0,
                          term_eps=1e-4,
                          buckets=((4, 0.80), (9, 0.12), (16, 0.08)))

    def rollout_of(R):
        return entry.make_step_moving_cached(graph, RES, RES, raster, R=R,
                                             device=dev, **MV_KW)[0]

    rollout, roll1, roll2, roll4 = (rollout_of(r) for r in (R_MV, 1, 2, 4))
    st_fwd = pusht.reset(P, gen, B_MV_FWD)
    st_train = pusht.PushTState(*(f[:B_MV_TRAIN] for f in st_fwd))
    act = torch.tensor([[150.0, 250.0]], device=dev).expand(B_MV_FWD, 2)
    act_train = act[:B_MV_TRAIN]
    log(f"moving camera: N={N}, sh{SH_DEGREE}, {RES}², kc {MV_KW['kc']}, "
        f"margin {MV_KW['margin']}, buckets {raster.buckets}, R={R_MV}")

    # 12. K3f and K3b at full size, on one frame of a B=16 rollout ------------
    seen = {}
    real_k3 = composite_single.composite_sel_single

    def capture(*args):
        seen["k3"] = args
        return real_k3(*args)

    with torch.no_grad(), replaced(composite_single, "composite_sel_single",
                                   capture):
        roll2(scene, st_train, act_train)                    # also warm-up
    torch.cuda.synchronize()
    a3 = seen.pop("k3")
    spay, ids, counts_pad = a3[:3]
    Bk, T1, _, Km = spay.shape
    T, P_ = T1 - 1, a3[3] ** 2
    log(f"K3 composite_sel_single vs plain (spay {tuple(spay.shape)}):")
    out_k = composite_single.composite_sel_single(*a3)
    out_p, applied, hits = composite_single.composite_sel_single_plain(
        *a3, return_work=True)
    rows = [0, 1, 2, 4]
    e3 = check("K3", out_k[:, :T, rows], out_p[:, :T, rows], TOL,
               "rgb+trans")
    dscale = max(1.0, float(spay[:, :, 8].abs().max()))
    check("K3", out_k[:, :T, 3] / dscale, out_p[:, :T, 3] / dscale, TOL,
          "depth_acc / max depth")
    cnt = counts_pad[:, :T].long()
    c0 = torch.arange(Km // composite.CHUNK, device=dev) * composite.CHUNK
    per_chunk = torch.clamp(cnt[..., None] - c0, 0, composite.CHUNK)
    used = torch.arange(len(c0), device=dev) < applied[..., None]
    entries = int((per_chunk * used).sum())
    blended = int(hits.sum())
    # reads the applied payload columns, ids and counts; writes 8 rows of
    # every named tile
    nbytes = entries * 40 + ids.numel() * 8 + Bk * T * 8 * P_ * 4
    b_ms, b_by = bound(nbytes,
                       ALPHA_FLOPS * P_ * entries + BLEND_FLOPS * blended)
    k3 = dict(name="composite_sel_single", route="cuda",
              source="sim_a_splat_torch/csrc/composite_single.cu",
              replaces="sim_a_splat_tpu/ops/pallas_composite_sel.py:465",
              max_abs_err=e3,
              ms=cuda_ms(lambda: composite_single.composite_sel_single(*a3),
                         20),
              plain_ms=cuda_ms(
                  lambda: composite_single.composite_sel_single_plain(*a3), 2),
              bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"  applied entries {entries} of {int(cnt.clamp(max=Km).sum())} "
        f"active; (pixel, entry) pairs: {P_ * entries} alpha, {blended} "
        f"blended (α > 0); kernel {k3['ms']:.4f} ms, plain "
        f"{k3['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")

    log("K3b composite_sel_single_bwd vs composite_sel_single_bwd_plain "
        "(the plain version 4 envs at a time):")
    with torch.enable_grad():        # the training forward: row 5 is filled
        out_s = composite_single.composite_sel_single(
            spay.detach().requires_grad_(), *a3[1:]).detach()
    ct3 = torch.zeros_like(out_s)
    ct3[:, :T, :5] = torch.as_tensor(np.random.default_rng(2).normal(
        size=(Bk, T, 5, P_)).astype(np.float32), device=dev)
    a3b = (spay, ids, counts_pad, ct3, out_s, *a3[3:])
    g_k = composite_single.composite_sel_single_bwd(*a3b)

    def k3b_plain():
        g = torch.empty_like(spay)
        for b0 in range(0, Bk, 4):
            sl = slice(b0, b0 + 4)
            g[sl] = composite_single.composite_sel_single_bwd_plain(
                spay[sl], ids[sl], counts_pad[sl], ct3[sl], *a3[3:])
        return g

    g_p = k3b_plain()
    e3b = check_rows("K3b", g_k[:, :T], g_p[:, :T], "payload grad")
    if not bool(torch.isfinite(g_k).all()) or bool(g_k[:, T].any()):
        raise AssertionError("K3b: gradient not finite, or the trash row "
                             "got one")
    # reads as K3f plus 5 channels each of ct and out at every named tile;
    # writes the whole (B, T+1, 10, Km) gradient once
    nbytes = (entries * 40 + ids.numel() * 8 + Bk * T * 2 * 5 * P_ * 4
              + spay.numel() * 4)
    b_ms, b_by = bound(nbytes,
                       ALPHA_FLOPS * P_ * entries + GRAD_FLOPS * blended)
    k3b = dict(name="composite_sel_single_bwd", route="cuda",
               source="sim_a_splat_torch/csrc/composite_single_bwd.cu",
               replaces="sim_a_splat_tpu/ops/pallas_composite_sel.py:500",
               max_abs_err=e3b,
               ms=cuda_ms(lambda: composite_single.composite_sel_single_bwd(
                   *a3b), 10),
               plain_ms=cuda_ms(k3b_plain, 1, warmup=0),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"  gradient pairs (α > 0): {blended}; kernel {k3b['ms']:.4f} ms "
        f"(with the gradient's zero fill), plain {k3b['plain_ms']:.3f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    del a3, spay, ids, counts_pad, out_k, out_p, out_s, ct3, a3b, g_k, g_p

    # 13. the forward rollout, B=32, timed ------------------------------------
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t_host = time.perf_counter()
    start.record()
    flags = []
    with torch.no_grad():
        for _ in range(MV_ITERS):
            _, loss, f = rollout(scene, st_fwd, act)
            flags.append(f)
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t_host) / MV_ITERS
    launches = counts_now()
    ev_ms = start.elapsed_time(end) / MV_ITERS
    flags = torch.stack(flags).cpu()
    log(f"moving camera, forward: {MV_ITERS} × rollout (B={B_MV_FWD}, "
        f"R={R_MV}): {ev_ms:.2f} ms/rollout (events), {wall * 1e3:.2f} "
        f"ms/rollout (host clock), {B_MV_FWD * R_MV / wall:.1f} frames/s; "
        f"loss {float(loss):.6f}, flags [severe, bounded] "
        f"{flags.tolist()}, launches {launches}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches["composite_sel_single"] != R_MV * MV_ITERS:
        raise AssertionError(f"K3f launched {launches['composite_sel_single']}"
                             f" times in {MV_ITERS} rollouts of {R_MV} frames")
    if any(launches[n] for n in launches if n != "composite_sel_single"):
        raise AssertionError(f"the forward rollout launched {launches}")
    if not bool(torch.isfinite(loss)):
        raise AssertionError("the forward rollout's loss is not finite")

    def short_rollout():
        with torch.no_grad():
            roll2(scene, st_fwd, act)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    short_rollout()
    ms2 = (time.perf_counter() - t0) * 1e3
    log(f"  R=2 rollout (host clock, for the profile's idle share): "
        f"{ms2:.2f} ms")
    profiled("R=2 forward rollout", short_rollout, ms2)

    # 14. one frame against the full per-frame rebin (kernel K1) ---------------
    real_render = rasterize_moving.render_moving_batch

    def keep(*args, **kw):
        seen["mv"] = real_render(*args, **kw)
        return seen["mv"]

    with torch.no_grad():
        with replaced(rasterize_moving, "render_moving_batch", keep):
            _, _, flags1 = roll1(scene, st_fwd, act)
        step_rb, _ = entry.make_step_moving(graph, RES, RES, raster,
                                            cam_height=MV_KW["cam_height"],
                                            device=dev)
        _, img_rb, n_trunc = step_rb(scene, st_fwd, act)
    img_c, aux = seen.pop("mv")
    diff = (img_c.permute(0, 2, 3, 1) - img_rb).abs()
    per_env = diff.flatten(1).amax(1)
    flags1, n_trunc = flags1.tolist(), int(n_trunc.sum())
    log(f"one frame vs the full rebin (make_step_moving, B={B_MV_FWD}): "
        f"max|Δ| {float(per_env.max()):.3e}, median over envs "
        f"{float(per_env.median()):.3e}; cached flags [severe, bounded] "
        f"{flags1} (frame: {int(aux.n_overflowed_tiles)} overflowed tiles, "
        f"{int(aux.n_slot_truncated)} slot-truncated), rebin truncations "
        f"{n_trunc}")
    if not bool(torch.isfinite(img_c).all()) or \
            img_c.shape != (B_MV_FWD, 3, RES, RES):
        raise AssertionError(f"bad moving images {tuple(img_c.shape)}")
    if flags1 == [0, 0] and n_trunc == 0:
        atol, rtol = TOL_REBIN
        if not bool((diff <= atol + rtol * img_rb.abs()).all()):
            raise AssertionError("the cached frame disagrees with the rebin "
                                 "with nothing truncated")
        log(f"  exact case: within atol {atol} / rtol {rtol}")
    else:
        log("  not gated: a flag or a truncation count is nonzero")
    del img_c, img_rb, diff, aux

    # 15. the train rollout, B=16, timed and broken down ----------------------
    entry.rollout_loss_and_grads(roll2, scene, st_train, act_train)  # warm-up
    phases = {"build": 0.0, "control_step": 0.0, "backward": 0.0}

    def timed(key, fn):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*args, **kw)
            torch.cuda.synchronize()
            phases[key] += time.perf_counter() - t
            return r
        return wrapped

    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start.record()
    t_host = time.perf_counter()
    with replaced(rasterize_moving, "build_moving_cache",
                  timed("build", rasterize_moving.build_moving_cache)), \
            replaced(pusht, "control_step",
                     timed("control_step", pusht.control_step)), \
            replaced(torch.autograd, "grad",
                     timed("backward", torch.autograd.grad)):
        _, loss, flags_t, grads = entry.rollout_loss_and_grads(
            rollout, scene, st_train, act_train)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_host
    launches = counts_now()
    k3["launches"] = launches["composite_sel_single"]
    k3b["launches"] = launches["composite_sel_single_bwd"]
    fields = [n for n, f in zip(grads._fields, grads) if f is not None]
    finite = all(bool(torch.isfinite(getattr(grads, n)).all())
                 for n in fields)
    frames_s = wall - phases["build"] - phases["backward"]
    log(f"moving camera, train: rollout_loss_and_grads (B={B_MV_TRAIN}, "
        f"R={R_MV}): {start.elapsed_time(end):.2f} ms (events), "
        f"{wall * 1e3:.2f} ms (host clock), "
        f"{B_MV_TRAIN * R_MV / wall:.1f} frames/s; loss {float(loss):.6f}, "
        f"flags {flags_t.tolist()}, grads finite={finite}, launches "
        f"{launches}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  breakdown (host clock, each phase synchronised): cache build "
        f"{phases['build'] * 1e3:.2f} ms, {R_MV} frames "
        f"{frames_s * 1e3:.2f} ms (control_step "
        f"{phases['control_step'] * 1e3:.2f} ms of it), backward "
        f"{phases['backward'] * 1e3:.2f} ms")
    if not finite:
        raise AssertionError("a gradient of the train rollout is not finite")
    for name in ("composite_sel_single", "composite_sel_single_bwd"):
        if launches[name] != R_MV:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"a train rollout of {R_MV} frames")
    del grads

    # gradients against the port's plain path, B=2, R=4 -----------------------
    st2 = pusht.PushTState(*(f[:2] for f in st_train))
    _, loss_k, flags_k, g_k = entry.rollout_loss_and_grads(
        roll4, scene, st2, act[:2])
    with replaced(composite_single, "composite_sel_single",
                  composite_single.composite_sel_single_plain):
        _, loss_p, flags_p, g_p = entry.rollout_loss_and_grads(
            roll4, scene, st2, act[:2])
    if flags_k.tolist() != flags_p.tolist():
        raise AssertionError(f"flags {flags_k.tolist()} (kernels) vs "
                             f"{flags_p.tolist()} (plain)")
    log(f"train rollout vs the plain path (B=2, R=4): loss {float(loss_k)} "
        f"vs {float(loss_p)}, flags {flags_k.tolist()}")
    check_fields("train-rollout", g_k, g_p, fields)
    return [k3, k3b]


if __name__ == "__main__":
    sys.exit(main())
