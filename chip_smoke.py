#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``sim_a_splat_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``sim_a_splat_torch/csrc``, holds
each against its plain PyTorch version at the shapes of the main path, then
drives the main path — the batched pushT splat env step, forward (B=128
envs, N=100k gaussians, SH degree 3, 256×256, fixed camera) — through
``entry.make_step_cached_batch`` and checks that every kernel of the path
was launched, that the render is exact (no dropped tiles) and that its
images agree with the port's plain path.  Any disagreement raises.

Output: phase reports, then the card's name and power limit, one JSON line
``{"kernels": [...]}`` with per-kernel launches, max |Δ|, kernel / plain
times and the roofline bound, and last ``{"ok": true, "device": {...}}``.
Exits non-zero without a result where there is no CUDA device.  The top
rows of a device profile of one step are printed with the phase reports.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

B, N, RES, SH_DEGREE = 128, 100_000, 256, 3
SEL_TILES, DYN_CAP, DYN_M = 36, 128, 9
ITERS = 5
# FLOP per (pixel, list entry) pair, exp as one: the alpha (dx, dy, the
# conic quadratic, exp, opacity, clamp) is evaluated for every entry of an
# applied chunk; the blend (w = αT, four FMAs, T·(1-α)) only where α > 0
ALPHA_FLOPS, BLEND_FLOPS = 15, 11
# H100 SXM published peaks (NVIDIA data sheet; at the 700 W power limit)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
TOL = 1e-4   # kernel vs plain: float32 products accumulated in another
             # order (per-pixel sequential vs cumprod / log space) over up
             # to 1,152 entries; depth rows are held to TOL × max depth


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


def bound(nbytes, flops):
    t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def check(name, got, want, atol, what):
    err = float((got - want).abs().max())
    log(f"  {name} {what}: max|Δ| = {err:.3e} (tolerance {atol:.1e})")
    if not err <= atol:
        raise AssertionError(f"{name} {what} disagrees with its plain "
                             f"version: max|Δ| {err} > {atol}")
    return err


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a "
              "CUDA device", file=sys.stderr)
        return 2
    from sim_a_splat_torch import entry
    from sim_a_splat_torch.ops import _kernels, composite, composite_sel
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
    out_k, car_k = composite.composite_static(*a1)
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
    log(f"  applied entries {entries} of {int(cnt.clamp(max=K).sum())} "
        f"active; (pixel, entry) pairs: {P_ * entries} alpha, {blended} "
        f"blended (α > 0); kernel {k1['ms']:.4f} ms, plain {k1['plain_ms']:.3f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    kernels.append(k1)

    # 4. K2 at full size --------------------------------------------------------
    a2 = seen["k2"]
    spay, dpay, ids, cs_pad, cd = a2[:5]
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
        f"blended (α > 0); "
        f"kernel {k2['ms']:.4f} ms, plain {k2['plain_ms']:.3f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    kernels.append(k2)

    # 5. the main path, timed ------------------------------------------------------
    composite.launches = 0
    composite_sel.launches = 0
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
    launches = {"composite_static": composite.launches,
                "composite_pair_sel": composite_sel.launches}
    for k in kernels:
        k["launches"] = launches[k["name"]]
    step_ms = start.elapsed_time(end) / ITERS
    drops = torch.stack(drops).cpu()
    exact = bool((drops[:, 0] == 0).all())
    log(f"main path: {ITERS} × (prepare + step_batch), B={B}, N={N}, "
        f"sh{SH_DEGREE}, {RES}²: {step_ms:.2f} ms/step (events), "
        f"{wall / ITERS * 1e3:.2f} ms/step (host clock), "
        f"{B * 1e3 / step_ms:.1f} frames/s; exact={exact}, "
        f"bounded truncations={int(drops[-1, 1])}, launches {launches}, "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not exact:
        raise AssertionError(f"sel-dropped tiles: {drops[:, 0].tolist()}")
    for name, n in launches.items():
        if n < ITERS:
            raise AssertionError(f"kernel {name} launched {n} times in "
                                 f"{ITERS} steps of the main path")
    if imgs.shape != (B, 3, RES, RES) or not bool(torch.isfinite(imgs).all()):
        raise AssertionError(f"bad images {tuple(imgs.shape)}")
    # each phase alone; the render is step_batch with the control step
    # replaced by its precomputed result
    prep_ms = cuda_ms(lambda: prepare(scene), 3)
    phys_ms = cuda_ms(lambda: pusht.control_step(P, states0, actions), 3)
    cache0, s_next = prepare(scene), pusht.control_step(P, states0, actions)
    with replaced(pusht, "control_step", lambda *_: s_next):
        rend_ms = cuda_ms(lambda: step(cache0, scene, states0, actions), 3)
    log(f"breakdown (events, each phase alone): prepare {prep_ms:.2f} ms, "
        f"control_step {phys_ms:.2f} ms, step_batch without control_step "
        f"{rend_ms:.2f} ms; sum {prep_ms + phys_ms + rend_ms:.2f} ms vs "
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
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cache = prepare(scene)
        _ = step(cache, scene, states0, actions)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    table = avg.table(sort_by="self_cuda_time_total", row_limit=11)
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in avg if str(e.device_type).endswith("CUDA"))
    log(f"profile of one step: device time {dev_us / 1e3:.2f} ms of "
        f"{step_ms:.2f} ms/step, idle share {1 - dev_us / 1e3 / step_ms:.3f}")
    for line in table.splitlines()[:14]:
        log("  " + line)

    log(f"image max|Δ| vs plain: {e_img:.3e}; total "
        f"{time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
