#!/usr/bin/env python3
"""One-off measurement: the K2 kernels with one design lever undone at a
time, timed on the card.  Not part of the port: nothing imports it, and
``chip_smoke.py`` is the check of the kernels as they are.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_levers.py

It builds the B=128 / N=100k / sh3 / 256² selected-tile step of
``chip_smoke.py``, captures one step's K2 inputs, and compiles variants of
``csrc/composite_sel.cu`` and ``csrc/composite_sel_bwd.cu`` from copies of
the sources with one text edit each (one ``nvcc`` per file, in parallel,
into ``sim_a_splat_torch/_build/levers/``):

- ``design``: the sources as they are;
- ``no_cull``: the warp-level footprint cull off (every warp visits every
  entry);
- ``py1`` / ``py4``: 1 or 4 pixels per thread (warp rectangles 8 × 4 and
  8 × 16) instead of 2 (8 × 8);
- ``shfl_down``: K2b's warp sums by 5 shuffles a row (``warp_sum_rows``,
  50 an entry), not the transposed exchange;
- ``no_atomics``: K2b without the per-tile atomic adds (its static
  gradient then is wrong: a measure of what the in-kernel sum costs);
- ``fast_div``: K2b's division by 1 - alpha with ``__fdividef`` (2 ulp)
  instead of the IEEE division (changes the gradient's last bits).

Each variant is timed in two rounds, with its largest deviation from the
design's own output.  An edit that no longer matches its source raises.
Exits non-zero where there is no CUDA device.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

B, N, RES = 128, 100_000, 256
WALK, COMMON, FWD, BWD = ("composite_sel_walk.cuh", "composite_common.cuh",
                          "composite_sel.cu", "composite_sel_bwd.cu")
PY2 = "constexpr int PY = 2;"
VARIANTS = {
    "design": [],
    "no_cull": [(WALK, "  return box.y < rect.x || box.x > rect.y || "
                       "box.w < rect.z ||\n         box.z > rect.w;",
                 "  return false;")],
    "py1": [(WALK, PY2, "constexpr int PY = 1;")],
    "py4": [(WALK, PY2, "constexpr int PY = 4;")],
    "shfl_down": [(BWD, "sel::warp_sum_store(sum, any, part + i, s.L);",
                   "warp_sum_rows(sum, any, part, s.L, i);")],
    "no_atomics": [(BWD, "if (v != 0.0f) atomicAdd(",
                    "if (v == 1e38f) atomicAdd(")],
    "fast_div": [(COMMON, "(suffix + st.trans_term) / one_m",
                  "__fdividef(suffix + st.trans_term, one_m)")],
}


def main_path_inputs(dev):
    """One selected-tile step's K2 inputs, out and a numpy-seeded
    cotangent on the selected rows."""
    import numpy as np
    import torch
    from sim_a_splat_torch import entry
    from sim_a_splat_torch.ops import composite_sel
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

    def capture(*args):
        seen["k2"] = args
        return real(*args)

    composite_sel.composite_pair_sel = capture
    try:
        step(prepare(graph.scene), graph.scene, states, actions)
    finally:
        composite_sel.composite_pair_sel = real
    args = seen["k2"]
    out = real(*args)
    ids = args[2]
    ct = torch.zeros_like(out)
    ct[torch.arange(B, device=dev)[:, None], ids.long(), :5] = torch.as_tensor(
        np.random.default_rng(1).normal(size=(B, ids.shape[1], 5, out.shape[-1]))
        .astype(np.float32), device=dev)
    ct[:, out.shape[1] - 1] = 0.0
    return args, out, ct


def cuda_ms(fn, reps=10):
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_variants(workdir: Path):
    """{variant: {source: library}}, built in parallel."""
    from sim_a_splat_torch.ops import _kernels
    nvcc, procs = _kernels.nvcc_path(), []
    for name, edits in VARIANTS.items():
        src = workdir / name
        shutil.copytree(_kernels.CSRC, src)
        for fname, old, new in edits:
            text = (src / fname).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} not once in "
                                   f"{fname}")
            (src / fname).write_text(text.replace(old, new))
        for cu in (FWD, BWD):
            lib = src / (cu + ".so")
            procs.append((name, cu, lib, subprocess.Popen(
                [nvcc, *_kernels.NVCC_FLAGS, "-I", str(src), "-o", str(lib),
                 str(src / cu)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, cu, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}/{cu}:\n{log}")
        libs.setdefault(name, {})[cu] = ctypes.CDLL(str(lib))
    return libs


def levers(dev) -> None:
    import torch
    from sim_a_splat_torch.ops import _kernels
    from sim_a_splat_torch.ops import composite_sel as cs
    args, out, ct = main_path_inputs(dev)
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

    rows = (torch.arange(B, device=dev)[:, None], ids.long())
    want_f = out[rows]
    want_s, want_d = cs.composite_pair_sel_bwd(*args[:5], ct, out, *args[5:])
    workdir = _kernels.BUILD_DIR / "levers"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    libs = build_variants(workdir)
    print(f"built {len(libs)} variants of {FWD} and {BWD}", flush=True)
    for rnd in range(2):
        for name, lib in libs.items():
            dev_f = float((fwd(lib[FWD])[rows] - want_f).abs().max())
            gs, gd = bwd(lib[BWD])
            dev_b = max(float((gs - want_s).abs().max() / want_s.abs().max()),
                        float((gd - want_d).abs().max() / want_d.abs().max()))
            print(f"round {rnd} {name:10s}: K2f "
                  f"{cuda_ms(lambda: fwd(lib[FWD])):.4f} ms "
                  f"(max|Δ| {dev_f:.1e}), K2b "
                  f"{cuda_ms(lambda: bwd(lib[BWD])):.4f} ms "
                  f"(max|Δ| / max|g| {dev_b:.1e})", flush=True)


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
