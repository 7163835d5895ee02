// Kernel K4 backward: gradient of the merge-free composite of the shared
// static tile lists interleaved by depth with each env's dynamic lists.
//
// Replaces the TPU kernel _bwd_kernel / _call_bwd of
// sim_a_splat_tpu/ops/pallas_composite_pair.py (the backward of the custom
// VJP composite_pallas_pair, run under the per-env step's vmap).
//
// Layout: spay (T, 10, Ks), dpay (B, T, 10, Kd), counts_s (T,), counts_d
// (B, T) and skip (B, T) as in K4f (composite_pair.cu); ct (B, T, P, 8) the
// cotangent of out and out (B, T, P, 8) the forward's output.  Outputs:
// gs (T, 10, Ks), the gradient of the shared static lists summed over the
// envs, which the caller zeroes before the launch; gd (B, T, 10, Kd), each
// env's dynamic gradient, every column written (zero for skipped pairs and
// past the counts).
//
// Design: one block per (tile, env), as K4f.  The TPU kernel needs no saved
// state: pass A replays the forward's stop decisions, pass B takes the
// static gradients from union suffix sums, then the dynamic ones.  Here a
// touched pair runs K2b's block body (grad_block in
// composite_sel_walk.cuh): K4f's merged walk replayed with K2's layout,
// windows and cull, every stop decision bit-identical to K4f's, each
// entry's union suffix sum ct . (out - prefix) with the prefixes rounded as
// K4f rounded out, the per-warp sums in shared memory added in warp order.
// A skipped pair writes a zero gd row and does nothing else.
//
// The static gradient is shared by every env (the reference's vmap sums
// each env's (T, 10, Ks) gradient in its transpose).  A per-env buffer
// would be 1.34 GB at the main path's shape, and only the ~13 % of pairs a
// dynamic gaussian touches contribute.  So each block sums each static
// column over its pixels, as K2b does per slot, and adds the nonzero sums
// to its tile's row with atomicAdd: no buffer, no compaction of the touched
// pairs on the host, and a contention of at most B blocks per row.  The
// order of those float additions across envs changes from run to run.
// Each dynamic column is stored once, when its window retires.
//
// What bounds it on an H100: the per-pixel gradient of the touched pairs
// (K2b's note); the largest traffic is the dynamic gradient gd (168 MB at
// the main path's shape), written once, most of it zeros of skipped pairs.
// The first design (one thread per pixel, no cull, 50 shuffles an entry)
// took 2.2 times K2b's time on the same pairs.

#include <cuda_runtime.h>

#include "composite_sel_walk.cuh"

using namespace splat;

namespace {

// WINDOWS: the dynamic list takes more than one window (sel::Layout).
template <bool WINDOWS>
__global__ void __launch_bounds__(sel::MAX_THREADS)
composite_pair_bwd(const float* __restrict__ spay,
                   const float* __restrict__ dpay,
                   const int* __restrict__ counts_s,
                   const int* __restrict__ counts_d,
                   const int* __restrict__ skip,
                   const float* __restrict__ ct,
                   const float* __restrict__ out, float* __restrict__ gs,
                   float* __restrict__ gd, int n_tiles, int Ks, int Kd,
                   int W, int ts, int tx, float power_min, int has_pmin,
                   float term_eps, int has_term) {
  extern __shared__ float4 smem[];
  const int t = blockIdx.x;
  const size_t pair = (size_t)blockIdx.y * n_tiles + t;
  const int P = ts * ts;
  float* gd_pair = gd + pair * ROWS * Kd;
  if (skip[pair] <= 0) {                         // uniform across the block
    zero_cols(gd_pair, Kd, 0, Kd);
    return;
  }
  const sel::Smem s = sel::carve(smem, W, blockDim.x >> 5);
  const sel::Pixels pix(ts, tx, t);
  sel::grad_block<true, WINDOWS>(
      s, pix, spay + (size_t)t * ROWS * Ks, Ks, min(counts_s[t], Ks),
      dpay + pair * ROWS * Kd, Kd, min(counts_d[pair], Kd), power_min,
      has_pmin != 0, term_eps, has_term != 0, ct + pair * P * 8,
      out + pair * P * 8, P, gs + (size_t)t * ROWS * Ks, gd_pair);
}

}  // namespace

// The caller checks the layout, as for composite_pair_launch, and zeroes
// gs.
extern "C" int composite_pair_bwd_launch(
    const void* spay, const void* dpay, const void* counts_s,
    const void* counts_d, const void* skip, const void* ct, const void* out,
    void* gs, void* gd, int B, int T, int Ks, int Kd, int ts, int tx,
    float power_min, int has_pmin, float term_eps, int has_term,
    void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaGetLastError();
  const sel::Layout l(Kd, ts, true);
  auto kernel =
      l.windows ? composite_pair_bwd<true> : composite_pair_bwd<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)l.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(T, B), l.threads, l.smem, (cudaStream_t)stream>>>(
      (const float*)spay, (const float*)dpay, (const int*)counts_s,
      (const int*)counts_d, (const int*)skip, (const float*)ct,
      (const float*)out, (float*)gs, (float*)gd, T, Ks, Kd, l.W, ts, tx,
      power_min, has_pmin, term_eps, has_term);
  return (int)cudaGetLastError();
}
