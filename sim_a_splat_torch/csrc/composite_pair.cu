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
// skip == 0 emit rgb 0 / trans 1 and do no other work (the caller takes the
// static composite there).
//
// Design: one block per (tile, env), one thread per pixel; the block reads
// its own skip flag and counts, so no tile-id table is built on the host.
// The per-env step of the reference vmaps a kernel whose grid is the tile
// axis; here the env axis is the grid's second dimension.  The env's
// dynamic list of the tile stays in shared memory and the merged order is
// walked directly (pair_walk in composite_common.cuh): static
// first on equal depth, the early stop on the running T after each applied
// static chunk, the remaining dynamic entries always composited.  The
// reference's log-space depth-indicator contractions give the same
// composite to float32 rounding.
//
// What bounds it on an H100: the per-pixel sequential walk of the touched
// pairs (latency and instruction rate).  Most of the B * T blocks
// are skipped pairs that only write their 8 KB of output, so the whole
// (B, T, P, 8) output (268 MB at the main path's shape) is the largest
// traffic; each pixel writes its 8 channels as two 16-byte stores.

#include <cuda_runtime.h>

#include "composite_common.cuh"

using namespace splat;

namespace {

__global__ void __launch_bounds__(1024)
composite_pair_fwd(const float* __restrict__ spay,
                   const float* __restrict__ dpay,
                   const int* __restrict__ counts_s,
                   const int* __restrict__ counts_d,
                   const int* __restrict__ skip, float* __restrict__ out,
                   int n_tiles, int Ks, int Kd, int ts, int tx,
                   float power_min, int has_pmin, float term_eps,
                   int has_term) {
  extern __shared__ float smem[];
  float* sd = smem;                  // (10, Kd) dynamic list of this pair
  float* ss = smem + ROWS * Kd;      // (10, CHUNK) current static chunk
  const int t = blockIdx.x;
  const size_t pair = (size_t)blockIdx.y * n_tiles + t;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  float4* o = reinterpret_cast<float4*>(out + (pair * P + p) * 8);
  if (skip[pair] <= 0) {                       // uniform across the block
    o[0] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    o[1] = make_float4(1.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const int count_s = min(counts_s[t], Ks);
  const int count_d = min(counts_d[pair], Kd);
  const float px = (float)(p % ts) + 0.5f + (float)((t % tx) * ts);
  const float py = (float)(p / ts) + 0.5f + (float)((t / tx) * ts);

  const float* dsrc = dpay + pair * ROWS * Kd;
  for (int i = p; i < ROWS * Kd; i += P) sd[i] = dsrc[i];
  __syncthreads();

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float T = 1.0f;
  pair_walk(ss, sd, Kd, count_d, spay + (size_t)t * ROWS * Ks, Ks, count_s,
            px, py, power_min, has_pmin != 0, term_eps, has_term != 0, acc, T);
  o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  o[1] = make_float4(T, 0.0f, 0.0f, 0.0f);
}

}  // namespace

extern "C" int composite_pair_launch(
    const void* spay, const void* dpay, const void* counts_s,
    const void* counts_d, const void* skip, void* out, int B, int T, int Ks,
    int Kd, int ts, int tx, float power_min, int has_pmin, float term_eps,
    int has_term, void* stream) {
  if (B > 0 && T > 0) {
    const size_t smem = sizeof(float) * ROWS * (Kd + CHUNK);
    cudaError_t err = cudaFuncSetAttribute(
        composite_pair_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    composite_pair_fwd<<<dim3(T, B), ts * ts, smem, (cudaStream_t)stream>>>(
        (const float*)spay, (const float*)dpay, (const int*)counts_s,
        (const int*)counts_d, (const int*)skip, (float*)out, T, Ks, Kd, ts,
        tx, power_min, has_pmin, term_eps, has_term);
  }
  return (int)cudaGetLastError();
}
