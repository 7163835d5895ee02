#!/usr/bin/env python3
"""One-off measurement: the K1, K2, K3 and K4b kernels with one design
lever undone at a time, timed on the card.  Not part of the port: nothing
imports it, and ``chip_smoke.py`` is the check of the kernels as they are.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_levers.py [k3]

(``k3``: the K3 levers only.)

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
- ``shfl_down``: K2b's warp sums by 5 shuffles a row (50 an entry, the
  first design's), not the transposed exchange;
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

K3 (``csrc/composite_single.cu``, ``csrc/composite_single_bwd.cu``) on one
frame of the moving camera's B=16 train rollout (``chip_smoke.py``'s cell):
``design`` and ``no_cull`` as above (K3 runs K1's chunk walk);
``k3_split``, K3f with K1f's split of its work (one block per (env, slot,
chunk) into a state buffer, then a one-block-per-slot combine) instead of
one block per slot walking its chunks in order; and ``k3_kept_state``,
K3f writing the chunk-start state of every applied chunk (~100 MiB a
frame) and K3b reading it instead of recomputing it in each block, timed
per frame and by the peak device memory (``torch.cuda.max_memory_allocated``)
of the whole B=16, R=32 train rollout with the design's kernels and with
this variant's (put in place of the wrappers' launches, the state held
from each training forward to its backward).  The variants that keep a
state take it as a launch argument after ``out``.  K3f is timed through
its launch function (ctypes, buffers allocated once), K3b through its
wrapper, or its launch function where it reads a state.

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

from chip_smoke import (
    B_MV_TRAIN, MV_KW, MV_RASTER, R_MV, cuda_ms, kernel_ms, kernels_of,
    replaced,
)

B, N, RES = 128, 100_000, 256
WALK, COMMON, FWD, BWD = ("composite_sel_walk.cuh", "composite_common.cuh",
                          "composite_sel.cu", "composite_sel_bwd.cu")
K1F, K1B, K4B = "composite.cu", "composite_bwd.cu", "composite_pair_bwd.cu"
K3F, K3B = "composite_single.cu", "composite_single_bwd.cu"
# the rows of a chunk-start state, each of P pixels: the accumulators r, g,
# b, depth_acc and the transmittance at the chunk's start
K3_STATE = [(src, "using namespace splat;\n",
             "using namespace splat;\n\nconstexpr int STATE = 5;\n")
            for src in (K3F, K3B)]
# the launch functions with a state buffer after out
K3F_STATE_ARG = (K3F, "const void* counts, void* out, int B,",
                 "const void* counts, void* out, void* state, int B,")
K3B_STATE_ARG = (K3B, "const void* ct, const void* out, void* grad,",
                 "const void* ct, const void* out, const void* state,\n"
                 "    void* grad,")
# K1f's split of K3f's work, the design K3f replaced: one block per (env,
# slot, chunk) composites its chunk into the state buffer, then one block
# per slot combines the chunks in order and overwrites each applied chunk's
# local sums with its chunk-start state
K3_SPLIT_KERNELS = r"""
// split = 1, first launch: one block per (env, slot, chunk) composites its
// chunk from T = 1 into state (local sums and transmittance).
__global__ void __launch_bounds__(stat::MAX_THREADS)
composite_single_chunks(const float* __restrict__ spay,
                        const int* __restrict__ ids,
                        const int* __restrict__ counts,
                        float* __restrict__ state, int TT, int T1, int K,
                        int ts, int tx, float power_min, int has_pmin,
                        int shared) {
  extern __shared__ float4 smem[];
  const Slot sl(spay, ids, counts, blockIdx.z, blockIdx.y, TT, T1, K,
                shared != 0);
  const int c = blockIdx.x, c0 = c * CHUNK;
  if (c0 >= sl.count) return;                  // uniform across the block
  const int nc = K / CHUNK, P = ts * ts, n = min(CHUNK, sl.count - c0);
  const bool pm = has_pmin != 0;
  const sel::Smem s = sel::carve(smem, 0, blockDim.x >> 5);
  const stat::Pixel pix(ts, tx, sl.tile);
  stat::stage_chunk(s, sl.list, K, c0, n, power_min, pm);
  __syncthreads();
  float local[4], tl;
  stat::composite_chunk(s, pix, n, power_min, pm, local, tl);
  if (!pix.on) return;
  float* st = state + ((sl.row * nc + c) * STATE) * P + pix.p;
#pragma unroll
  for (int j = 0; j < 4; ++j) st[j * P] = local[j];
  st[4 * P] = tl;
}

// split = 1, second launch: one block per (env, slot), one thread per pixel,
// applies the chunks in order with the stop and overwrites each applied
// chunk's local results with its chunk-start state.
__global__ void __launch_bounds__(1024)
composite_single_combine(const int* __restrict__ ids,
                         const int* __restrict__ counts,
                         float* __restrict__ out, float* __restrict__ state,
                         int TT, int T1, int nc, float term_eps, int has_term,
                         int save_state, int shared) {
  const int b = blockIdx.y, tile = ids[(size_t)b * TT + blockIdx.x];
  const size_t row = (size_t)b * T1 + tile;
  const int count = counts[shared ? (size_t)tile : row];
  const int p = threadIdx.x, P = blockDim.x;
  float* st = state + (row * nc * STATE) * P + p;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, tc = 1.0f;
  int applied = 0;
  for (int c = 0; c < nc && c * CHUNK < count; ++c, st += STATE * P) {
    float local[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      local[j] = st[j * P];
      st[j * P] = acc[j];
    }
    const float tl = st[4 * P];
    st[4 * P] = tc;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = fmaf(tc, local[j], acc[j]);
    tc = tc * tl;
    ++applied;
    if (has_term && !__syncthreads_or(tc >= term_eps)) break;
  }
  if (out != nullptr)
    write_out(out, row, P, p, acc, tc, save_state ? (float)applied : 0.0f);
}

"""
K3_SPLIT_LAUNCH = """  if (state == nullptr) return (int)cudaErrorInvalidValue;
  composite_single_chunks<<<dim3(K / CHUNK, TT, B), threads, smem,
                            (cudaStream_t)stream>>>(
      (const float*)spay, (const int*)ids, (const int*)counts,
      (float*)state, TT, T1, K, ts, tx, power_min, has_pmin, shared);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  composite_single_combine<<<dim3(TT, B), ts * ts, 0,
                             (cudaStream_t)stream>>>(
      (const int*)ids, (const int*)counts, (float*)out, (float*)state, TT,
      T1, K / CHUNK, term_eps, has_term, save_state, shared);
  return (int)cudaGetLastError();
"""
K3_DESIGN_LAUNCH = """  composite_single_fwd<<<dim3(TT, B), threads, smem,
                         (cudaStream_t)stream>>>(
      (const float*)spay, (const int*)ids, (const int*)counts, (float*)out,
      TT, T1, K, ts, tx, power_min, has_pmin, term_eps, has_term,
      save_state, shared);
  return (int)cudaGetLastError();
"""
# K3b's recompute of its chunk-start state, the design
K3B_RECOMPUTE = """  // the chunk-start state, recomputed: chunks 0 .. c-1 composited and
  // combined with K3f's very operations (bit for bit its state)
  stat::BwdPixel st;
#pragma unroll
  for (int j = 0; j < 4; ++j) st.acc0[j] = 0.0f;
  st.tc = 1.0f;
  for (int j = 0; j < c; ++j) {
    stat::stage_chunk(s, list, K, j * CHUNK, CHUNK, power_min, pm);
    __syncthreads();
    float local[4], tl;
    stat::composite_chunk(s, pix, CHUNK, power_min, pm, local, tl);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      st.acc0[k] = fmaf(st.tc, local[k], st.acc0[k]);
    st.tc = st.tc * tl;
    __syncthreads();                           // the chunk fully read
  }
"""
# K3f writing, and K3b reading, the chunk-start state of every applied
# chunk: state (B, T+1, nc, STATE, P)
K3_KEEP = [
    K3F_STATE_ARG, K3B_STATE_ARG,
    (K3F, "float* __restrict__ out,\n                     int TT,",
     "float* __restrict__ out,\n                     "
     "float* __restrict__ state, int TT,"),
    (K3F, "(float*)out,\n      TT,", "(float*)out,\n      (float*)state, TT,"),
    (K3F, "  const stat::Pixel pix(ts, tx, sl.tile);\n",
     "  const stat::Pixel pix(ts, tx, sl.tile);\n"
     "  float* st = state != nullptr\n"
     "                  ? state + (sl.row * nc * STATE) * P + pix.p\n"
     "                  : nullptr;\n"),
    (K3F, "    const int c0 = c * CHUNK, n = min(CHUNK, sl.count - c0);\n",
     "    const int c0 = c * CHUNK, n = min(CHUNK, sl.count - c0);\n"
     "    if (st != nullptr && pix.on) {\n"
     "      for (int j = 0; j < 4; ++j) st[(c * STATE + j) * P] = acc[j];\n"
     "      st[(c * STATE + 4) * P] = tc;\n"
     "    }\n"),
    (K3B, "const float* __restrict__ out,\n",
     "const float* __restrict__ out,\n"
     "                     const float* __restrict__ state,\n"),
    (K3B, "(const float*)out,\n        (float*)grad,",
     "(const float*)out,\n        (const float*)state, (float*)grad,"),
    (K3B, K3B_RECOMPUTE, """  stat::BwdPixel st;
  {
    const float* s0 = state + ((row * (K / CHUNK) + c) * STATE) * P + p;
    for (int j = 0; j < 4; ++j) st.acc0[j] = s0[j * P];
    st.tc = s0[4 * P];
  }
"""),
]
PY2 = "constexpr int PY = 2;"
# the first design's warp sums: 5 shuffles down a row, 50 an entry
SHFL_DOWN = """{
      const bool lane0 = (threadIdx.x & 31) == 0;
      if (!__any_sync(0xffffffffu, any)) {
        if (lane0)
          for (int r = 0; r < ROWS; ++r) part[r * s.L + i] = 0.0f;
      } else {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          float v = sum[r];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_down_sync(0xffffffffu, v, off);
          if (lane0) part[r * s.L + i] = v;
        }
      }
    }"""
VARIANTS = {
    "design": [],
    "no_cull": [(WALK, "  return box.y < rect.x || box.x > rect.y || "
                       "box.w < rect.z ||\n         box.z > rect.w;",
                 "  return false;")],
    "py1": [(WALK, PY2, "constexpr int PY = 1;")],
    "py4": [(WALK, PY2, "constexpr int PY = 4;")],
    "shfl_down": [(WALK, "warp_sum_store(sum, any, part + i, s.L);",
                   SHFL_DOWN)],
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

K3_VARIANTS = {
    "design": [],
    "no_cull": VARIANTS["no_cull"],
    "k3_split": K3_STATE[:1] + [
        K3F_STATE_ARG,
        (K3F, "}  // namespace\n", K3_SPLIT_KERNELS + "}  // namespace\n"),
        (K3F, K3_DESIGN_LAUNCH, K3_SPLIT_LAUNCH)],
    "k3_kept_state": K3_STATE + K3_KEEP,
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
    actions = torch.tensor([[150.0, 250.0]], device=dev).repeat(B, 1)
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


def build_variants(workdir: Path, variants=VARIANTS,
                   sources=(FWD, BWD, K1F, K1B, K4B)):
    """{variant: {source: library}} of ``variants`` ({name: edits}), each
    of ``sources``, built in parallel."""
    from sim_a_splat_torch.ops import _kernels
    jobs = []
    for name, edits in variants.items():
        src = workdir / name
        shutil.copytree(_kernels.CSRC, src)
        for fname, old, new in edits:
            text = (src / fname).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} not once in "
                                   f"{fname}")
            (src / fname).write_text(text.replace(old, new))
        jobs += [(name, cu, (src / cu, src, src / (cu + ".so")))
                 for cu in sources]
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
    tail1 = (T1, T1, K1, ts1, tx1, 0.0 if pmin1 is None else pmin1,
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


def k3_levers(dev) -> None:
    """K3's levers on one frame of the moving camera's B=16 train rollout,
    and the rollout's peak memory with and without a kept state."""
    import numpy as np
    import torch
    from sim_a_splat_torch import entry
    from sim_a_splat_torch.ops import _kernels
    from sim_a_splat_torch.ops import composite_single as k3
    from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
    from sim_a_splat_torch.physics import pusht
    nb, na = N // 20, N // 50
    graph = entry.build_scene(n_bg=N - nb - na, n_block=nb, n_agent=na,
                              seed=0, sh_degree=3, device=dev)
    raster = RasterConfig(**MV_RASTER)
    rollout, P = entry.make_step_moving_cached(graph, RES, RES, raster,
                                               R=R_MV, device=dev, **MV_KW)
    roll2, _ = entry.make_step_moving_cached(graph, RES, RES, raster, R=2,
                                             device=dev, **MV_KW)
    states = pusht.reset(P, torch.Generator(device=dev).manual_seed(0),
                         B_MV_TRAIN)
    actions = torch.tensor([[150.0, 250.0]], device=dev).repeat(
        B_MV_TRAIN, 1)
    seen, real = {}, k3.composite_sel_single

    def capture(*args):
        seen["k3"] = args
        return real(*args)

    with torch.no_grad(), replaced(k3, "composite_sel_single", capture):
        roll2(graph.scene, states, actions)
    a3 = seen["k3"]
    spay, ids = a3[:2]
    with torch.enable_grad():
        out = k3.composite_sel_single(spay.detach().requires_grad_(),
                                      *a3[1:]).detach()
    ct = torch.zeros_like(out)
    ct[:, :-1, :5] = torch.as_tensor(np.random.default_rng(2).normal(
        size=(out.shape[0], out.shape[1] - 1, 5, out.shape[-1])).astype(
            np.float32), device=dev)
    a3b = (*a3[:3], ct, out, *a3[3:])
    want_f = k3.composite_sel_single(*a3)
    want_b = k3.composite_sel_single_bwd(*a3b)
    workdir = _kernels.BUILD_DIR / "levers"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    libs = build_variants(workdir, K3_VARIANTS, (K3F, K3B))
    counts = a3[2]
    B, TT = ids.shape
    T1, _, Km = spay.shape[-3:]
    ts, tx, sigma, term = a3[3:]
    pmin = k3.power_min_of(sigma)
    stream = torch.cuda.current_stream().cuda_stream
    o = torch.empty_like(want_f)
    state_shape = (B, T1, Km // k3.CHUNK, 5, ts * ts)
    scratch = spay.new_empty(state_shape)
    print(f"K3 inputs: spay {tuple(spay.shape)}, ids {tuple(ids.shape)}; "
          f"state {scratch.numel() * 4 / 2**20:.1f} MiB", flush=True)

    def launch_fwd(lib, spay, ids, counts, out, st, B, TT, T1, Km,
                   save_state):
        f = lib.composite_sel_single_launch
        f.argtypes, f.restype = k3._FWD_ARGS, ctypes.c_int
        ptrs = [spay.data_ptr(), ids.data_ptr(), counts.data_ptr(),
                out.data_ptr()]
        if st is not False:              # a variant that takes a state
            f.argtypes = f.argtypes[:4] + [ctypes.c_void_p] + f.argtypes[4:]
            ptrs.append(None if st is None else st.data_ptr())
        rc = f(*ptrs, B, TT, T1, Km, ts, tx, 0.0 if pmin is None else pmin,
               int(pmin is not None), 0.0 if term is None else term,
               int(term is not None), int(save_state), 0, stream)
        if rc:
            raise RuntimeError(f"K3f variant: CUDA error {rc}")
        return out

    def fwd3(lib, st=False):
        return launch_fwd(lib, spay, ids, counts, o, st, B, TT, T1, Km, 0)

    def bwd_kept(lib, spay, ids, counts, ct, out, st):
        """K3b reading ``st``, per-env payloads, as the wrapper runs K3b."""
        B, TT = ids.shape
        T1, _, Km = spay.shape[-3:]
        grad = torch.empty_like(spay)
        named = torch.zeros((B, T1), dtype=torch.int32, device=dev)
        named[torch.arange(B, device=dev)[:, None], ids.long()] = 1
        f = lib.composite_sel_single_bwd_launch
        f.argtypes = (k3._BWD_ARGS[:6] + [ctypes.c_void_p]
                      + k3._BWD_ARGS[6:])
        f.restype = ctypes.c_int
        rc = f(spay.data_ptr(), ids.data_ptr(), counts.data_ptr(),
               named.data_ptr(), ct.data_ptr(), out.data_ptr(),
               st.data_ptr(), grad.data_ptr(), B, TT, T1, Km, ts, tx,
               0.0 if pmin is None else pmin, int(pmin is not None), 0,
               stream)
        if rc:
            raise RuntimeError(f"K3b variant: CUDA error {rc}")
        return grad

    def dev_f(out3):
        rows = (torch.arange(B, device=dev)[:, None], ids.long())
        return float((out3[rows][..., :5, :]
                      - want_f[rows][..., :5, :]).abs().max())

    def dev_b(g):
        return float((g - want_b).abs().max() / want_b.abs().max())

    keep = libs["k3_kept_state"]
    for rnd in range(2):
        for name, lib in libs.items():
            if name == "k3_kept_state":
                f_ms = cuda_ms(lambda: fwd3(lib[K3F], scratch), 20)
                err_f = dev_f(fwd3(lib[K3F], scratch))
                b_ms = cuda_ms(lambda: bwd_kept(lib[K3B], *a3b[:5], scratch),
                               10)
                err = dev_b(bwd_kept(lib[K3B], *a3b[:5], scratch))
                print(f"round {rnd} {name:10s}: K3f writing the state "
                      f"{f_ms:.4f} ms (max|Δ| {err_f:.1e}), K3b reading it "
                      f"{b_ms:.4f} ms (max|Δ| / max|g| {err:.1e})",
                      flush=True)
                continue
            st = scratch if name == "k3_split" else False
            line = (f"round {rnd} {name:10s}: K3f "
                    f"{cuda_ms(lambda: fwd3(lib[K3F], st), 20):.4f} ms "
                    f"(max|Δ| {dev_f(fwd3(lib[K3F], st)):.1e})")
            if name != "k3_split":
                with kernels_of({"composite_single_bwd": lib[K3B]}):
                    b_ms = cuda_ms(lambda: k3.composite_sel_single_bwd(*a3b),
                                   10)
                    err = dev_b(k3.composite_sel_single_bwd(*a3b))
                line += (f", K3b {b_ms:.4f} ms recomputing its state "
                         f"(max|Δ| / max|g| {err:.1e})")
            print(line, flush=True)
    # only the rollout's own tensors in the peak-memory runs
    del scratch, o, want_f, want_b, a3, a3b, out, ct, spay, ids
    del counts, seen
    kept = {}                 # a training forward's out pointer → its state

    def fwd_keeping(spay, ids, counts, ts_, tx_, sigma_, term_,
                    save_state=False):
        if (ts_, tx_, sigma_, term_) != (ts, tx, sigma, term):
            raise RuntimeError("a K3 call unlike the captured frame's")
        spay, ids, counts = (a.contiguous() for a in (spay, ids, counts))
        B, TT = ids.shape
        T1, _, Km = spay.shape[-3:]
        out = spay.new_empty((B, T1, 8, ts * ts))
        st = (spay.new_empty((B, T1, Km // k3.CHUNK, 5, ts * ts))
              if save_state else None)
        launch_fwd(keep[K3F], spay, ids, counts, out, st, B, TT, T1, Km,
                   save_state)
        if st is not None:
            kept[out.data_ptr()] = st
        return out

    def bwd_keeping(spay, ids, counts, ct, out, *rest):
        return bwd_kept(keep[K3B], spay.contiguous(), ids.contiguous(),
                        counts.contiguous(), ct.contiguous(), out,
                        kept.pop(out.data_ptr()))

    for keeping in (False, True, False, True):
        with replaced(k3, "composite_sel_single_fwd",
                      fwd_keeping if keeping
                      else k3.composite_sel_single_fwd), \
                replaced(k3, "composite_sel_single_bwd",
                         bwd_keeping if keeping
                         else k3.composite_sel_single_bwd):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _, loss, _, grads = entry.rollout_loss_and_grads(
                rollout, graph.scene, states, actions)
            torch.cuda.synchronize()
        if kept:
            raise RuntimeError(f"{len(kept)} kept states were never read")
        peak = torch.cuda.max_memory_allocated()
        print(f"train rollout B={B_MV_TRAIN}, R={R_MV}, K3b "
              f"{'from the kept state' if keeping else 'recomputing'}: peak "
              f"device memory {peak / 2**30:.3f} GiB ({peak} B), loss "
              f"{float(loss):.6f}", flush=True)
        del grads


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_levers: torch.cuda.is_available() is False — needs a "
              "CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if sys.argv[1:] != ["k3"]:
        levers(torch.device("cuda"))
    k3_levers(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
