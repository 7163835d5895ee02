// Kernel K2 forward: selected-tile composite of the shared static tile
// lists interleaved by depth with each env's dynamic lists.
//
// Replaces the TPU kernel _fwd_kernel / _call_fwd of
// sim_a_splat_tpu/ops/pallas_composite_sel.py (composite_pair_sel, shared
// 3-D static payload; helpers _dyn_log_alphas / _static_chunk_ind of
// pallas_composite_pair.py).
//
// Layout: spay_pad (T+1, 10, Ks) with a zero trash row T; dpay (B, TT, 10, Kd);
// ids (B, TT) int32 tile ids, pad slots carry T; counts_s_pad (T+1,) and
// counts_d (B, TT) int32.  Output out (B, T+1, 8, P), channel-major
// [r, g, b, depth_acc, trans, 0, 0, 0], written only at the rows the slots
// name (pads write the trash row); other rows are left unwritten.
//
// Design: one block per (env, slot), ceil(ts / 8)² warps, each thread with
// 2 pixels of its warp's compact 8 × 8 rectangle, walking the merged order
// of the two lists (merged_walk in composite_sel_walk.cuh, shared with K4):
// both lists staged entry-major in shared memory, the dynamic list in
// windows that fit beside one static chunk (any capacity; the main path's
// Kd = 128 is one window), the merge positions found once per chunk, and a
// warp-level footprint cull.
//
// What bounds it on an H100: instruction issue, not bytes (a block reads at
// most ~45 KB of payload).  One thread per pixel walking every entry spent
// ~40 instructions per (pixel, entry) pair, though 87 % of the main path's
// pairs blend nothing.  The cull skips an entry for a whole warp with one
// ballot per 32 entries, and the 2 pixels of a thread share the entry's
// loads, its merge test and the loop, so what is left is mostly the alpha of
// pairs near a footprint.  The staging (10 coalesced loads and the cull box
// in double precision per entry and block) and the block-wide stop check
// are the fixed costs.

#include <cuda_runtime.h>

#include "composite_sel_walk.cuh"

using namespace splat;

namespace {

// WINDOWS: the dynamic list takes more than one window (sel::Layout).
template <bool WINDOWS>
__global__ void __launch_bounds__(sel::MAX_THREADS)
composite_pair_sel_fwd(const float* __restrict__ spay,
                       const float* __restrict__ dpay,
                       const int* __restrict__ ids,
                       const int* __restrict__ counts_s_pad,
                       const int* __restrict__ counts_d,
                       float* __restrict__ out, int TT, int T1, int Ks,
                       int Kd, int W, int ts, int tx, float power_min,
                       int has_pmin, float term_eps, int has_term) {
  extern __shared__ float4 smem[];
  const sel::Smem s = sel::carve(smem, W, blockDim.x >> 5);
  const int b = blockIdx.y;
  const int slot = b * TT + blockIdx.x;
  const int tid = ids[slot];
  const int P = ts * ts;
  const sel::Pixels pix(ts, tx, tid);
  sel::composite_block<false, WINDOWS>(
      s, pix, spay + (size_t)tid * ROWS * Ks, Ks, min(counts_s_pad[tid], Ks),
      dpay + (size_t)slot * ROWS * Kd, Kd, min(counts_d[slot], Kd),
      power_min, has_pmin != 0, term_eps, has_term != 0,
      out + (size_t)(b * T1 + tid) * 8 * P, P);
}

}  // namespace

// The caller checks the layout (1 <= ts <= 32, Kd % 128 == 0).
extern "C" int composite_pair_sel_launch(
    const void* spay, const void* dpay, const void* ids,
    const void* counts_s_pad, const void* counts_d, void* out, int B, int TT,
    int T1, int Ks, int Kd, int ts, int tx, float power_min, int has_pmin,
    float term_eps, int has_term, void* stream) {
  if (B <= 0 || TT <= 0) return (int)cudaGetLastError();
  const sel::Layout l(Kd, ts, false);
  auto kernel =
      l.windows ? composite_pair_sel_fwd<true> : composite_pair_sel_fwd<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)l.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(TT, B), l.threads, l.smem, (cudaStream_t)stream>>>(
      (const float*)spay, (const float*)dpay, (const int*)ids,
      (const int*)counts_s_pad, (const int*)counts_d, (float*)out, TT, T1,
      Ks, Kd, l.W, ts, tx, power_min, has_pmin, term_eps, has_term);
  return (int)cudaGetLastError();
}

// Blocks of composite_pair_sel_fwd that fit on one SM at (Kd, ts)
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into *blocks.
extern "C" int composite_pair_sel_blocks_per_sm(int Kd, int ts, int* blocks) {
  const sel::Layout l(Kd, ts, false);
  auto kernel =
      l.windows ? composite_pair_sel_fwd<true> : composite_pair_sel_fwd<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)l.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, l.threads, l.smem);
  return (int)err;
}
