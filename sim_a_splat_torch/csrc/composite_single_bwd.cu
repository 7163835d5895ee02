// Kernel K3 backward: gsplat's gradient of the single-list selected-tile
// composite, for all 10 rows of the per-env payload.
//
// Replaces the TPU kernel _bwd_kernel_single / _call_single_bwd of
// sim_a_splat_tpu/ops/pallas_composite_sel.py (the backward of the custom
// VJP composite_sel_single), in its per-env (4-D payload) mode.
//
// Layout: spay (B, T+1, 10, K), ids (B, TT), counts (B, T+1) as in K3f
// (composite_single.cu); ct (B, T+1, 8, P) the cotangent of out and out the
// training forward's output, whose row 5 holds each slot's applied-chunk
// count.  Output grad (B, T+1, 10, K), zeroed by the caller: the block of
// slot (b, i) writes the columns of the chunks it applied at row
// (b, ids[b, i]), so the gradient is scattered by tile id (each tile named
// at most once per env; pad slots have count 0 and write nothing).
//
// Design: one block per (env, slot), one thread per pixel, as K3f.  The
// block walks exactly the forward's applied chunks again from T = 1 with
// the very float operations K3f used (entry_grad advances T as
// composite_entry did), so every transmittance replays bit for bit and no
// state beyond out is kept.  Suffix sums are taken against running
// per-channel prefixes, ct . (out - prefix), which the walk rounds as the
// forward rounded out: the reference's s_tot - (prefix + incl) cancels in
// float32 on near-opaque tiles.  The 10 per-entry gradients are sums over
// the tile's pixels: each warp reduces its 32 pixels with shuffles into its
// own row of shared memory, and after the chunk the warps' partials are
// added in warp order, so the result is deterministic and needs no atomics.
//
// What bounds it on an H100: the per-pixel sequential walk and the
// per-entry warp reductions (latency and instruction issue), not bytes or
// FLOPs: at B = 16, T = 256, K = 640 it reads the 105 MB payload and
// ~34 MB each of cotangent and forward output and writes a 105 MB
// gradient.  The design reads each payload column once per block, keeps
// the walk in registers and skips the shuffles of a warp where no pixel
// sees the entry.

#include <cuda_runtime.h>

#include "composite_common.cuh"

using namespace splat;

namespace {

__global__ void __launch_bounds__(1024)
composite_single_bwd(const float* __restrict__ spay,
                     const int* __restrict__ ids,
                     const int* __restrict__ counts,
                     const float* __restrict__ ct,
                     const float* __restrict__ out,
                     float* __restrict__ grad, int TT, int T1, int K, int ts,
                     int tx, float power_min, int has_pmin) {
  extern __shared__ float smem[];
  float* s = smem;                     // (ROWS, CHUNK) current chunk
  float* part = smem + ROWS * CHUNK;   // (warps, ROWS, CHUNK) partial sums
  const int b = blockIdx.y;
  const int t = ids[(size_t)b * TT + blockIdx.x];
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int warps = P >> 5;
  float* my_part = part + (p >> 5) * ROWS * CHUNK;
  const size_t row = (size_t)b * T1 + t;
  const int count = counts[row];
  const bool pm = has_pmin != 0;
  const float* list = spay + row * ROWS * K;
  float* gt = grad + row * ROWS * K;
  // the forward's applied-chunk count, the same at every pixel
  const int applied = min((int)out[row * 8 * P + 5 * P],
                          (count + CHUNK - 1) / CHUNK);

  BwdPixel st;
  init_bwd_pixel(st, (float)(p % ts) + 0.5f + (float)((t % tx) * ts),
                 (float)(p / ts) + 0.5f + (float)((t / tx) * ts),
                 ct + row * 8 * P + p, out + row * 8 * P + p, P);

  for (int c = 0; c < applied; ++c) {
    const int c0 = c * CHUNK;
    __syncthreads();                 // previous chunk's partials fully read
    stage_chunk(s, list, K, c0);
    __syncthreads();
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

extern "C" int composite_sel_single_bwd_launch(
    const void* spay, const void* ids, const void* counts, const void* ct,
    const void* out, void* grad, int B, int TT, int T1, int K, int ts, int tx,
    float power_min, int has_pmin, void* stream) {
  if (B > 0 && TT > 0) {
    const int threads = ts * ts;
    const size_t smem = sizeof(float) * ROWS * CHUNK * (1 + threads / 32);
    cudaError_t err = cudaFuncSetAttribute(
        composite_single_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    composite_single_bwd<<<dim3(TT, B), threads, smem,
                           (cudaStream_t)stream>>>(
        (const float*)spay, (const int*)ids, (const int*)counts,
        (const float*)ct, (const float*)out, (float*)grad, TT, T1, K, ts, tx,
        power_min, has_pmin);
  }
  return (int)cudaGetLastError();
}
