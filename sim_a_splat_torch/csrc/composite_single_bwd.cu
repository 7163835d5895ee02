// Kernel K3 backward: gsplat's gradient of the single-list selected-tile
// composite, for all 10 payload rows.
//
// Replaces the TPU kernel _bwd_kernel_single / _call_single_bwd of
// sim_a_splat_tpu/ops/pallas_composite_sel.py (the backward of the custom
// VJP composite_sel_single), in both of its modes.
//
// Layout: spay, ids, counts as in K3f (composite_single.cu), per-env
// (B, T+1, 10, K) or shared (T+1, 10, K); ct (B, T+1, 8, P) the cotangent
// of out, out the training forward's output, whose row 5 holds each slot's
// applied-chunk count.  named (B, T+1): 1 where some slot of env b names
// the row.
// Output grad, shaped as spay:
// - per-env: every column written once, at the row the slot names (the
//   gradient scattered by tile id; each tile named at most once per env
//   apart from the pad id, whose row has count 0), zero for rows no slot
//   names and for entries the forward never applied;
// - shared: each slot's gradient added to its tile's row with atomicAdd
//   (the reference's _scatter_rows sum over envs and slots); the caller
//   zeroes grad.
//
// Design: K1b's restart (composite_static_walk.cuh).  One block per
// (env, row, chunk) in per-env mode, per (env, slot, chunk) in shared mode.
// A chunk the forward did not apply (at or past row 5's count) writes
// zeros (per-env) or nothing (shared).  An applied chunk restarts from the
// chunk-start tc and acc, which the block recomputes by compositing chunks
// 0 .. c-1 as K3f does (most lists are one chunk long, so most blocks
// recompute nothing).  So no state is kept: on the moving camera's frames
// a state kept by K3f (lever k3_kept_state of chip_levers.py) made K3b
// between 4 % slower and 19 % faster (about 11 % faster in the median of
// six runs) and cost ~100 MiB a frame, 2.94 GiB more peak memory in a
// B=16, R=32 train rollout (an H100 80GB HBM3 at 700 W).  It walks the
// chunk with K1f's cull, keeping the chunk's local sums with the forward's
// own operations, and takes each suffix as ct . (out - prefix) with
// prefix = fmaf(tc, L, acc0): no float32 cancellation.  Per entry each
// warp sums its pixels' 10 rows by K2b's 12-shuffle exchange into per-warp
// partials, and the block adds the visiting warps' partials in warp order:
// deterministic, and no atomics in per-env mode.
//
// What bounds it on an H100: the gradient of the kept pairs (~52 FLOP each)
// and its IEEE division by 1 - alpha, and writing the gradient: at B = 16,
// T = 256, K = 640 that is 105 MB, ~0.03 ms of the card's bandwidth, while
// the applied payload it reads is ~12 MB.

#include <cuda_runtime.h>

#include "composite_static_walk.cuh"

using namespace splat;

namespace {

__global__ void __launch_bounds__(stat::MAX_THREADS)
composite_single_bwd(const float* __restrict__ spay,
                     const int* __restrict__ ids,
                     const int* __restrict__ counts,
                     const int* __restrict__ named,
                     const float* __restrict__ ct,
                     const float* __restrict__ out,
                     float* __restrict__ grad, int TT, int T1, int K, int ts,
                     int tx, float power_min, int has_pmin, int shared) {
  extern __shared__ float4 smem[];
  const int warps = blockDim.x >> 5;
  const int b = blockIdx.z, c = blockIdx.x, c0 = c * CHUNK;
  const int P = ts * ts;
  // per-env: blockIdx.y is the row; shared: the slot, naming the row
  const int tile = shared ? ids[(size_t)b * TT + blockIdx.y] : blockIdx.y;
  const size_t row = (size_t)b * T1 + tile;
  const size_t lrow = shared ? (size_t)tile : row;
  const int count = counts[lrow];
  float* gt = grad + lrow * ROWS * K;
  // the forward's applied-chunk count, the same at every pixel
  const bool on_row = shared || named[row] != 0;
  const int napp = on_row ? (int)out[row * 8 * P + 5 * P] : 0;

  if (c >= napp || c0 >= count) {              // uniform across the block
    if (!shared) zero_cols(gt, K, c0, c0 + CHUNK);
    return;
  }
  const int n = min(CHUNK, count - c0);
  const bool pm = has_pmin != 0;
  const sel::Smem s = sel::carve(smem, 0, warps);
  const stat::Pixel pix(ts, tx, tile);
  const float* list = spay + lrow * ROWS * K;
  const int p = pix.on ? pix.p : 0;

  // the chunk-start state, recomputed: chunks 0 .. c-1 composited and
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
  stat::stage_chunk(s, list, K, c0, n, power_min, pm);
  {
    const float* ctp = ct + row * 8 * P + p;
    const float* op = out + row * 8 * P + p;
    st.px = pix.px;
    st.py = pix.py;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      st.ct[j] = ctp[j * P];
      st.out[j] = op[j * P];
      st.L[j] = 0.0f;
    }
    st.trans_term = ctp[4 * P] * op[4 * P];
    st.Tl = 1.0f;
  }
  __syncthreads();

  stat::grad_chunk(s, pix, n, power_min, pm, st);
  __syncthreads();
  if (shared) {
    stat::column_sums(s, warps, n, [&](int r, int e, float v) {
      if (v != 0.0f) atomicAdd(gt + r * K + c0 + e, v);
    });
  } else {
    stat::column_sums(s, warps, n, [&](int r, int e, float v) {
      gt[r * K + c0 + e] = v;
    });
  }
}

}  // namespace

// The caller checks the layout (ts <= 32, K % 128 == 0) and, in shared
// mode, zeroes grad.
extern "C" int composite_sel_single_bwd_launch(
    const void* spay, const void* ids, const void* counts, const void* named,
    const void* ct, const void* out, void* grad, int B, int TT, int T1, int K,
    int ts, int tx, float power_min, int has_pmin, int shared, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const int threads = stat::block_threads(ts);
  const size_t smem = stat::smem_bytes(threads / 32, true);
  cudaError_t err = cudaFuncSetAttribute(
      composite_single_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = shared ? TT : T1;
  if (rows > 0)
    composite_single_bwd<<<dim3(K / CHUNK, rows, B), threads, smem,
                           (cudaStream_t)stream>>>(
        (const float*)spay, (const int*)ids, (const int*)counts,
        (const int*)named, (const float*)ct, (const float*)out,
        (float*)grad, TT, T1, K, ts, tx, power_min, has_pmin, shared);
  return (int)cudaGetLastError();
}
