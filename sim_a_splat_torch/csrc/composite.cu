// Kernel K1 forward: per-tile front-to-back alpha compositing of the static
// background's depth-sorted tile lists.
//
// Replaces the TPU kernel _fwd_kernel / _call_fwd of
// sim_a_splat_tpu/ops/pallas_composite.py (composite_pallas).
//
// Layout: payload (T, 10, K) float32 field-major rows [x, y, conic a b c,
// r, g, b, depth, opacity], K % 128 == 0, entries depth-sorted per tile with
// the active ones first; counts (T,) and skip (T,) int32.  Outputs:
// out (T, P, 8) [r, g, b, depth_acc, trans, 0, 0, 0] and carries (T, P, nc),
// the transmittance at the start of every 128-entry chunk (the restart
// points of the backward kernel), P = ts * ts.
//
// Design: one block per tile, one thread per pixel (P = 256).  Each applied
// chunk's 10 x 128 payload is staged in shared memory (5 KB) and every thread
// walks it in order with its transmittance in a register.  Chunks at or past
// the tile's count are skipped, tiles with skip == 0 emit rgb 0 / T 1, and
// after each applied chunk the block stops once no pixel has
// T >= term_eps (__syncthreads_or), the TPU kernel's chunk-granular stop.
//
// What bounds it on an H100: neither bytes nor FLOPs at this size.  The
// whole input is ~10 MB and the work ~24 FLOP per (pixel, entry) applied;
// with T = 256 tiles the grid is 256 blocks of 8 warps on 132 SMs, so the
// kernel is latency-bound (one sequential walk per pixel, little parallel
// slack).  The design keeps every operand in shared memory or registers and
// reads each payload column once per block.

#include <cuda_runtime.h>

#include "composite_common.cuh"

using namespace splat;

namespace {

__global__ void __launch_bounds__(1024)
composite_static_fwd(const float* __restrict__ payload,
                     const int* __restrict__ counts,
                     const int* __restrict__ skip, float* __restrict__ out,
                     float* __restrict__ carries, int K, int ts, int tx,
                     float power_min, int has_pmin, float term_eps,
                     int has_term) {
  __shared__ float s[ROWS * CHUNK];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int nc = K / CHUNK;
  const int count = skip[t] > 0 ? counts[t] : 0;
  const float px = (float)(p % ts) + 0.5f + (float)((t % tx) * ts);
  const float py = (float)(p / ts) + 0.5f + (float)((t / tx) * ts);
  const float* tile = payload + (size_t)t * ROWS * K;
  float* carry = carries + ((size_t)t * P + p) * nc;

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float T = 1.0f;
  bool alive = true;
  for (int c = 0; c < nc; ++c) {
    carry[c] = T;
    const int c0 = c * CHUNK;
    if (!alive || c0 >= count) continue;   // uniform across the block
    __syncthreads();                       // previous chunk fully read
    stage_chunk(s, tile, K, c0);
    __syncthreads();
    const int n = min(CHUNK, count - c0);
    for (int e = 0; e < n; ++e)
      composite_entry(s, CHUNK, e, px, py, power_min, has_pmin != 0, T, acc);
    if (has_term) alive = __syncthreads_or(T >= term_eps) != 0;
  }
  float* o = out + ((size_t)t * P + p) * 8;
  o[0] = acc[0];
  o[1] = acc[1];
  o[2] = acc[2];
  o[3] = acc[3];
  o[4] = T;
  o[5] = 0.0f;
  o[6] = 0.0f;
  o[7] = 0.0f;
}

}  // namespace

extern "C" int composite_static_launch(const void* payload, const void* counts,
                                       const void* skip, void* out,
                                       void* carries, int T, int K, int ts,
                                       int tx, float power_min, int has_pmin,
                                       float term_eps, int has_term,
                                       void* stream) {
  if (T > 0) {
    composite_static_fwd<<<T, ts * ts, 0, (cudaStream_t)stream>>>(
        (const float*)payload, (const int*)counts, (const int*)skip,
        (float*)out, (float*)carries, K, ts, tx, power_min, has_pmin,
        term_eps, has_term);
  }
  return (int)cudaGetLastError();
}
