// Kernel K1 backward: gsplat's gradient of the static background's per-tile
// front-to-back composite, for all 10 payload rows.
//
// Replaces the TPU kernel _bwd_kernel / _call_bwd of
// sim_a_splat_tpu/ops/pallas_composite.py (the backward of the custom VJP
// composite_pallas).
//
// Layout: payload (T, 10, K), counts (T,), skip (T,) as in K1f
// (composite.cu); ct (T, P, 8) the cotangent of out, out (T, P, 8) and
// carries (T, P, nc) the forward's outputs.  Output grad (T, 10, K): every
// column written once, zero for entries the forward never applied (past
// counts, skipped tiles, chunks after the early stop).
//
// Design: one block per tile, one thread per pixel, as K1f.  Each applied
// chunk is staged in shared memory and every thread walks it again,
// restarting from the chunk-start transmittance the forward saved
// (carries) and keeping running per-channel prefix sums, so the suffix sum
// of the later entries is ct . (out - prefix), rounded as the forward
// rounded out (entry_grad in composite_common.cuh: the reference's
// s_tot - prefix, without its float32 cancellation).  The early stop is
// found again from carries: the forward stopped after chunk c - 1 iff no
// pixel's carries[c] reaches term_eps.  The 10 per-entry gradients are
// sums over the tile's pixels: each warp reduces its 32 pixels with
// shuffles into its own row of shared memory, and after the chunk the
// warps' partials are added in warp order, so the result is deterministic
// and needs no atomics.
//
// What bounds it on an H100: the per-pixel sequential walk and the
// per-entry warp reductions (latency and instruction issue), not bytes or
// FLOPs: it reads the ~10 MB payload and ~6 MB of cotangent, forward
// outputs and carries and writes a ~10 MB gradient, and the grid is 256
// blocks of 8 warps on 132 SMs.  The design
// reads each payload column once per block, keeps the walk in registers
// and skips the shuffles of a warp where no pixel sees the entry.

#include <cuda_runtime.h>

#include "composite_common.cuh"

using namespace splat;

namespace {

__global__ void __launch_bounds__(1024)
composite_static_bwd(const float* __restrict__ payload,
                     const int* __restrict__ counts,
                     const int* __restrict__ skip,
                     const float* __restrict__ ct,
                     const float* __restrict__ out,
                     const float* __restrict__ carries,
                     float* __restrict__ grad, int K, int ts, int tx,
                     float power_min, int has_pmin, float term_eps,
                     int has_term) {
  extern __shared__ float smem[];
  float* s = smem;                     // (ROWS, CHUNK) current chunk
  float* part = smem + ROWS * CHUNK;   // (warps, ROWS, CHUNK) partial sums
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int warps = P >> 5;
  float* my_part = part + (p >> 5) * ROWS * CHUNK;
  const int nc = K / CHUNK;
  const int count = skip[t] > 0 ? counts[t] : 0;
  const bool pm = has_pmin != 0;
  const float* tile = payload + (size_t)t * ROWS * K;
  const float* carry = carries + ((size_t)t * P + p) * nc;
  float* gt = grad + (size_t)t * ROWS * K;

  BwdPixel st;
  init_bwd_pixel(st, (float)(p % ts) + 0.5f + (float)((t % tx) * ts),
                 (float)(p / ts) + 0.5f + (float)((t / tx) * ts),
                 ct + ((size_t)t * P + p) * 8, out + ((size_t)t * P + p) * 8,
                 1);

  for (int c = 0; c < nc; ++c) {
    const int c0 = c * CHUNK;
    bool applied = c0 < count;                     // uniform across the block
    if (applied && has_term && c > 0)
      applied = __syncthreads_or(carry[c] >= term_eps) != 0;
    if (!applied) {                  // so is every later chunk: zero them
      zero_cols(gt, K, c0, K);
      break;
    }
    __syncthreads();                 // previous chunk's partials fully read
    stage_chunk(s, tile, K, c0);
    __syncthreads();
    st.T = carry[c];
    const int n = min(CHUNK, count - c0);
    for (int e = 0; e < n; ++e) {
      float g[ROWS];
      const bool hit = entry_grad(s, CHUNK, e, power_min, pm, st, g);
      warp_sum_rows(g, hit, my_part, CHUNK, e);
    }
    __syncthreads();
    block_sum_rows(part, warps, CHUNK, n, CHUNK, gt + c0, K);
  }
}

}  // namespace

extern "C" int composite_static_bwd_launch(
    const void* payload, const void* counts, const void* skip, const void* ct,
    const void* out, const void* carries, void* grad, int T, int K, int ts,
    int tx, float power_min, int has_pmin, float term_eps, int has_term,
    void* stream) {
  if (T > 0) {
    const int threads = ts * ts;
    const size_t smem = sizeof(float) * ROWS * CHUNK * (1 + threads / 32);
    cudaError_t err = cudaFuncSetAttribute(
        composite_static_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    composite_static_bwd<<<T, threads, smem, (cudaStream_t)stream>>>(
        (const float*)payload, (const int*)counts, (const int*)skip,
        (const float*)ct, (const float*)out, (const float*)carries,
        (float*)grad, K, ts, tx, power_min, has_pmin, term_eps, has_term);
  }
  return (int)cudaGetLastError();
}
