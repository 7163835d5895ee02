#!/usr/bin/env python3
"""One-off measurement: the K1, K2 and K4b kernels with one design lever
undone at a time, timed on the card.  Not part of the port: nothing imports it,
and ``chip_smoke.py`` is the check of the kernels as they are.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_levers.py

It builds the B=128 / N=100k / sh3 / 256² selected-tile step and per-env
step of ``chip_smoke.py``, captures one step's K1, K2 and K4 inputs, and
compiles variants of ``csrc/composite.cu``, ``csrc/composite_bwd.cu``,
``csrc/composite_sel.cu``, ``csrc/composite_sel_bwd.cu`` and
``csrc/composite_pair_bwd.cu`` from copies of the sources with one text
edit each (one ``nvcc`` per file, in parallel, into
``sim_a_splat_torch/_build/levers/``):

- ``design``: the sources as they are;
- ``no_cull``: the warp-level footprint cull off in K1 and K2 (every warp
  visits every entry);
- ``py1`` / ``py4``: K2 with 1 or 4 pixels per thread (warp rectangles
  8 × 4 and 8 × 16) instead of 2 (8 × 8);
- ``shfl_down``: K2b's warp sums by 5 shuffles a row (``warp_sum_rows``,
  50 an entry), not the transposed exchange;
- ``no_atomics``: K2b without the per-tile atomic adds (its static
  gradient then is wrong: a measure of what the in-kernel sum costs);
- ``fast_div``: K2b's division by 1 - alpha with ``__fdividef`` (2 ulp)
  instead of the IEEE division (changes the gradient's last bits);
- ``windows_always``: the code that moves the dynamic window compiled into
  the K2 and K4 kernels where the list is one window (the main path's
  Kd = 128), instead of compiled out (``sel::Layout::windows``);
- ``mask_test``: K2f's masked pixels (past a tile that is not a multiple
  of 8) kept out of the blend by a test of every alpha, instead of by
  starting them at T = 0 (no pixel is masked at the main path's ts 16:
  the test's cost alone).

K4b runs K2b's block body (``composite_sel_walk.cuh``), so every lever of
K2 and K2b acts on it too.

Each variant is timed in two rounds, with its largest deviation from the
design's own output: K2 and K4b by CUDA events around 10 launches, K1
(tens of microseconds a launch, about its Python dispatch) by the device
time of its kernels under the profiler (``chip_smoke.cuda_ms`` and
``kernel_ms``).  An edit that no longer matches its source
raises.  Exits non-zero where there is no CUDA device.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

from chip_smoke import cuda_ms, kernel_ms

B, N, RES = 128, 100_000, 256
WALK, COMMON, FWD, BWD = ("composite_sel_walk.cuh", "composite_common.cuh",
                          "composite_sel.cu", "composite_sel_bwd.cu")
K1F, K1B, K4B = "composite.cu", "composite_bwd.cu", "composite_pair_bwd.cu"
PY2 = "constexpr int PY = 2;"
VARIANTS = {
    "design": [],
    "no_cull": [(WALK, "  return box.y < rect.x || box.x > rect.y || "
                       "box.w < rect.z ||\n         box.z > rect.w;",
                 "  return false;")],
    "py1": [(WALK, PY2, "constexpr int PY = 1;")],
    "py4": [(WALK, PY2, "constexpr int PY = 4;")],
    "shfl_down": [(WALK, "warp_sum_store(sum, any, part + i, s.L);",
                   "warp_sum_rows(sum, any, part, s.L, i);")],
    "no_atomics": [(WALK, "if (v != 0.0f) atomicAdd(",
                    "if (v == 1e38f) atomicAdd(")],
    "fast_div": [(COMMON, "(suffix + st.trans_term) / one_m",
                  "__fdividef(suffix + st.trans_term, one_m)")],
    "windows_always": [(WALK, "    windows = W < Kd;",
                        "    windows = true;")],
    "mask_test": [(WALK, "    T[k] = pix.on[k] ? 1.0f : 0.0f;",
                   "    T[k] = 1.0f;"),
                  (WALK, "      any |= a[k] > 0.0f;",
                   "      if (!pix.on[k]) a[k] = 0.0f;\n"
                   "      any |= a[k] > 0.0f;")],
}


def main_path_inputs(dev):
    """One selected-tile step's K2 inputs, out and a numpy-seeded
    cotangent on the selected rows, its K1 inputs, and one per-env step's
    K4b inputs (with a numpy-seeded cotangent on the touched pairs)."""
    import numpy as np
    import torch
    from sim_a_splat_torch import entry
    from sim_a_splat_torch.ops import composite, composite_pair, composite_sel
    from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
    from sim_a_splat_torch.physics import pusht
    nb, na = N // 20, N // 50
    graph = entry.build_scene(n_bg=N - nb - na, n_block=nb, n_agent=na,
                              seed=0, sh_degree=3, device=dev)
    raster = RasterConfig(tile_size=16, tile_capacity=1024,
                          max_tiles_per_gaussian=16, sigma_cutoff=3.0,
                          term_eps=1e-4,
                          buckets=((4, 0.90), (6, 0.06), (9, 0.04)))
    prepare, step, P = entry.make_step_cached_batch(
        graph, RES, RES, raster, dyn_capacity=128, sel_tiles=36,
        dyn_max_tiles=9, device=dev)
    states = pusht.reset(P, torch.Generator(device=dev).manual_seed(0), B)
    actions = torch.tensor([[150.0, 250.0]], device=dev).expand(B, 2)
    seen, real = {}, composite_sel.composite_pair_sel
    real1 = composite.composite_static

    def capture(*args):
        seen["k2"] = args
        return real(*args)

    def capture1(*args):
        seen["k1"] = args
        return real1(*args)

    composite_sel.composite_pair_sel = capture
    composite.composite_static = capture1
    try:
        step(prepare(graph.scene), graph.scene, states, actions)
    finally:
        composite_sel.composite_pair_sel = real
        composite.composite_static = real1
    prep4, step4, _ = entry.make_step_cached(
        graph, RES, RES, raster, dyn_capacity=128, dyn_max_tiles=9,
        device=dev)
    real4 = composite_pair.composite_pair

    def capture4(*args):
        seen["k4"] = args
        return real4(*args)

    composite_pair.composite_pair = capture4
    try:
        step4(prep4(graph.scene), graph.scene, states, actions)
    finally:
        composite_pair.composite_pair = real4
    a4 = seen["k4"]
    out4 = real4(*a4)
    on = a4[4] > 0
    ct4 = torch.zeros_like(out4)
    ct4[on] = torch.nn.functional.pad(torch.as_tensor(
        np.random.default_rng(3).normal(size=(int(on.sum()), out4.shape[2],
                                              5)).astype(np.float32),
        device=dev), (0, 3))
    args = seen["k2"]
    out = real(*args)
    ids = args[2]
    ct = torch.zeros_like(out)
    ct[torch.arange(B, device=dev)[:, None], ids.long(), :5] = torch.as_tensor(
        np.random.default_rng(1).normal(size=(B, ids.shape[1], 5, out.shape[-1]))
        .astype(np.float32), device=dev)
    ct[:, out.shape[1] - 1] = 0.0
    return args, out, ct, seen["k1"], (*a4[:5], ct4, out4, *a4[5:])


def build_variants(workdir: Path):
    """{variant: {source: library}}, built in parallel."""
    from sim_a_splat_torch.ops import _kernels
    jobs = []
    for name, edits in VARIANTS.items():
        src = workdir / name
        shutil.copytree(_kernels.CSRC, src)
        for fname, old, new in edits:
            text = (src / fname).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} not once in "
                                   f"{fname}")
            (src / fname).write_text(text.replace(old, new))
        jobs += [(name, cu, (src / cu, src, src / (cu + ".so")))
                 for cu in (FWD, BWD, K1F, K1B, K4B)]
    _kernels.compile_all([job for _, _, job in jobs])
    libs = {}
    for name, cu, (_, _, lib) in jobs:
        libs.setdefault(name, {})[cu] = ctypes.CDLL(str(lib))
    return libs


def levers(dev) -> None:
    import numpy as np
    import torch
    from sim_a_splat_torch.ops import _kernels
    from sim_a_splat_torch.ops import composite_sel as cs
    from sim_a_splat_torch.ops import composite as k1
    from sim_a_splat_torch.ops import composite_pair as cp
    args, out, ct, a1, a4b = main_path_inputs(dev)
    spay, dpay, ids, counts_s, counts_d, ts, tx, sigma, term = args
    scalars = cs._scalars(spay, dpay, ids, ts, tx, sigma, term)
    stream = torch.cuda.current_stream().cuda_stream

    def fwd(lib):
        f = lib.composite_pair_sel_launch
        f.argtypes, f.restype = cs._FWD_ARGS, ctypes.c_int
        o = torch.empty_like(out)
        rc = f(spay.data_ptr(), dpay.data_ptr(), ids.data_ptr(),
               counts_s.data_ptr(), counts_d.data_ptr(), o.data_ptr(),
               *scalars, stream)
        if rc:
            raise RuntimeError(f"K2f variant: CUDA error {rc}")
        return o

    def bwd(lib):
        f = lib.composite_pair_sel_bwd_launch
        f.argtypes, f.restype = cs._BWD_ARGS, ctypes.c_int
        gs, gd = torch.zeros_like(spay), torch.empty_like(dpay)
        rc = f(spay.data_ptr(), dpay.data_ptr(), ids.data_ptr(),
               counts_s.data_ptr(), counts_d.data_ptr(), ct.data_ptr(),
               out.data_ptr(), gs.data_ptr(), gd.data_ptr(), *scalars, stream)
        if rc:
            raise RuntimeError(f"K2b variant: CUDA error {rc}")
        return gs, gd

    pay, counts1, skip1, ts1, tx1, sigma1, term1 = a1
    T1, _, K1 = pay.shape
    P1, nc1 = ts1 * ts1, K1 // k1.CHUNK
    pmin1 = k1.power_min_of(sigma1)
    tail1 = (T1, K1, ts1, tx1, 0.0 if pmin1 is None else pmin1,
             int(pmin1 is not None), 0.0 if term1 is None else term1,
             int(term1 is not None), stream)

    def fwd1(lib):
        f = lib.composite_static_launch
        f.argtypes, f.restype = k1._FWD_ARGS, ctypes.c_int
        o = pay.new_empty((T1, P1, 8))
        car = pay.new_empty((T1, P1, nc1))
        acc = pay.new_empty((T1, nc1, 4, P1))
        rc = f(pay.data_ptr(), counts1.data_ptr(), skip1.data_ptr(),
               o.data_ptr(), car.data_ptr(), acc.data_ptr(), *tail1)
        if rc:
            raise RuntimeError(f"K1f variant: CUDA error {rc}")
        return o, car, acc

    want1 = k1.composite_static_fwd(*a1)
    ct1 = torch.as_tensor(np.random.default_rng(0).normal(
        size=(T1, P1, 8)).astype(np.float32), device=dev)

    def bwd1(lib):
        f = lib.composite_static_bwd_launch
        f.argtypes, f.restype = k1._BWD_ARGS, ctypes.c_int
        g = torch.empty_like(pay)
        rc = f(pay.data_ptr(), counts1.data_ptr(), skip1.data_ptr(),
               ct1.data_ptr(), want1[0].data_ptr(), want1[1].data_ptr(),
               want1[2].data_ptr(), g.data_ptr(), *tail1)
        if rc:
            raise RuntimeError(f"K1b variant: CUDA error {rc}")
        return g

    scalars4 = cp._scalars(a4b[0], a4b[1], *a4b[7:])

    def bwd4(lib):
        f = lib.composite_pair_bwd_launch
        f.argtypes, f.restype = cp._BWD_ARGS, ctypes.c_int
        gs, gd = torch.zeros_like(a4b[0]), torch.empty_like(a4b[1])
        rc = f(*(a.data_ptr() for a in a4b[:7]), gs.data_ptr(),
               gd.data_ptr(), *scalars4, stream)
        if rc:
            raise RuntimeError(f"K4b variant: CUDA error {rc}")
        return gs, gd

    want4 = cp.composite_pair_bwd(*a4b)
    want1b = k1.composite_static_bwd(pay, counts1, skip1, ct1, want1[0],
                                     want1[1], *a1[3:], chunk_acc=want1[2])
    rows = (torch.arange(B, device=dev)[:, None], ids.long())
    want_f = out[rows]
    want_s, want_d = cs.composite_pair_sel_bwd(*args[:5], ct, out, *args[5:])
    workdir = _kernels.BUILD_DIR / "levers"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    libs = build_variants(workdir)
    print(f"built {len(libs)} variants of {FWD}, {BWD}, {K1F}, {K1B} and "
          f"{K4B}", flush=True)
    for rnd in range(2):
        for name, lib in libs.items():
            o1 = fwd1(lib[K1F])
            dev_1f = max(float((a - b).abs().max())
                         for a, b in zip(o1, want1))
            dev_1b = float((bwd1(lib[K1B]) - want1b).abs().max()
                           / want1b.abs().max())
            print(f"round {rnd} {name:10s}: K1f "
                  f"{kernel_ms(lambda: fwd1(lib[K1F]), 20):.4f} ms "
                  f"(max|Δ| {dev_1f:.1e}), K1b "
                  f"{kernel_ms(lambda: bwd1(lib[K1B]), 20):.4f} ms "
                  f"(max|Δ| / max|g| {dev_1b:.1e})", flush=True)
            dev_f = float((fwd(lib[FWD])[rows] - want_f).abs().max())
            gs, gd = bwd(lib[BWD])
            dev_b = max(float((gs - want_s).abs().max() / want_s.abs().max()),
                        float((gd - want_d).abs().max() / want_d.abs().max()))
            print(f"round {rnd} {name:10s}: K2f "
                  f"{cuda_ms(lambda: fwd(lib[FWD]), 10):.4f} ms "
                  f"(max|Δ| {dev_f:.1e}), K2b "
                  f"{cuda_ms(lambda: bwd(lib[BWD]), 10):.4f} ms "
                  f"(max|Δ| / max|g| {dev_b:.1e})", flush=True)
            gs, gd = bwd4(lib[K4B])
            dev_4 = max(float((gs - want4[0]).abs().max()
                              / want4[0].abs().max()),
                        float((gd - want4[1]).abs().max()
                              / want4[1].abs().max()))
            print(f"round {rnd} {name:10s}: K4b "
                  f"{cuda_ms(lambda: bwd4(lib[K4B]), 10):.4f} ms "
                  f"(max|Δ| / max|g| {dev_4:.1e})", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_levers: torch.cuda.is_available() is False — needs a "
              "CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    levers(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
