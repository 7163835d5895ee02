// Kernel K4 forward: merge-free composite of the shared static tile lists
// interleaved by depth with each env's dynamic lists, over every tile.
//
// Replaces the TPU kernel _fwd_kernel / _call_fwd of
// sim_a_splat_tpu/ops/pallas_composite_pair.py (composite_pallas_pair, run
// under the per-env step's vmap: one launch covers every env).
//
// Layout: spay (T, 10, Ks) the shared static lists, dpay (B, T, 10, Kd) each
// env's dynamic list of every tile; counts_s (T,), counts_d (B, T) and
// skip (B, T) int32.  Output out (B, T, P, 8) pixel-major
// [r, g, b, depth_acc, trans, 0, 0, 0], every row written.  Pairs with
// skip <= 0 emit rgb 0 / trans 1 and do no other work (the caller takes the
// static composite there).
//
// Design: one block per (tile, env); the block reads its own skip flag and
// counts, so no tile-id table is built on the host.  The per-env step of
// the reference vmaps a kernel whose grid is the tile axis; here the env
// axis is the grid's second dimension.  A touched pair is the very problem
// K2f solves on a selected slot (one shared static list, one dynamic list,
// one depth merge with statics first on equal depth, the early stop once
// per applied 128-entry chunk), so it runs K2f's block body
// (composite_block in composite_sel_walk.cuh): K2's threads and 8 × 8 warp
// rectangles, the entry-major staging with the dynamic list in windows,
// the warp-level cull and the merged walk, with tile = spay + t·10·Ks (the
// static lists are not padded).  Its output on a touched pair is K2f's on
// the same (env, tile), bit for bit; the reference's log-space
// depth-indicator contractions give the same composite to float32 rounding.
//
// What bounds it on an H100: instruction issue in the touched pairs' walk
// (K2f's note), and the whole (B, T, P, 8) output (268 MB at the main
// path's shape), most of it the skipped pairs' rgb 0 / trans 1 written as
// two 16-byte stores a pixel.  The first design (one thread per pixel, no
// cull, the dynamic list staged field-major) took 2.4 times K2f's time on
// the same pairs.

#include <cuda_runtime.h>

#include "composite_sel_walk.cuh"

using namespace splat;

namespace {

// WINDOWS: the dynamic list takes more than one window (sel::Layout).
template <bool WINDOWS>
__global__ void __launch_bounds__(sel::MAX_THREADS)
composite_pair_fwd(const float* __restrict__ spay,
                   const float* __restrict__ dpay,
                   const int* __restrict__ counts_s,
                   const int* __restrict__ counts_d,
                   const int* __restrict__ skip, float* __restrict__ out,
                   int n_tiles, int Ks, int Kd, int W, int ts, int tx,
                   float power_min, int has_pmin, float term_eps,
                   int has_term) {
  extern __shared__ float4 smem[];
  const int t = blockIdx.x;
  const size_t pair = (size_t)blockIdx.y * n_tiles + t;
  const int P = ts * ts;
  const sel::Pixels pix(ts, tx, t);
  float* o = out + pair * P * 8;
  if (skip[pair] <= 0) {                       // uniform across the block
#pragma unroll
    for (int k = 0; k < sel::PY; ++k) {
      if (!pix.on[k]) continue;
      float4* q = reinterpret_cast<float4*>(o + (size_t)pix.p[k] * 8);
      q[0] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      q[1] = make_float4(1.0f, 0.0f, 0.0f, 0.0f);
    }
    return;
  }
  const sel::Smem s = sel::carve(smem, W, blockDim.x >> 5);
  sel::composite_block<true, WINDOWS>(
      s, pix, spay + (size_t)t * ROWS * Ks, Ks, min(counts_s[t], Ks),
      dpay + pair * ROWS * Kd, Kd, min(counts_d[pair], Kd), power_min,
      has_pmin != 0, term_eps, has_term != 0, o, P);
}

}  // namespace

// The caller checks the layout (1 <= ts <= 32, Kd % 128 == 0).
extern "C" int composite_pair_launch(
    const void* spay, const void* dpay, const void* counts_s,
    const void* counts_d, const void* skip, void* out, int B, int T, int Ks,
    int Kd, int ts, int tx, float power_min, int has_pmin, float term_eps,
    int has_term, void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaGetLastError();
  const sel::Layout l(Kd, ts, false);
  auto kernel =
      l.windows ? composite_pair_fwd<true> : composite_pair_fwd<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)l.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(T, B), l.threads, l.smem, (cudaStream_t)stream>>>(
      (const float*)spay, (const float*)dpay, (const int*)counts_s,
      (const int*)counts_d, (const int*)skip, (float*)out, T, Ks, Kd, l.W, ts,
      tx, power_min, has_pmin, term_eps, has_term);
  return (int)cudaGetLastError();
}
