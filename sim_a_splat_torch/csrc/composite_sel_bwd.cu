// Kernel K2 backward: gradient of the selected-tile composite of the static
// tile lists (shared, or one set per env) interleaved by depth with each
// env's dynamic lists.
//
// Replaces the TPU kernel _bwd_kernel / _call_bwd of
// sim_a_splat_tpu/ops/pallas_composite_sel.py (the backward of the custom
// VJP composite_pair_sel, shared 3-D or per-env 4-D static payload, with the
// per-tile sum _scatter_rows).
//
// Layout: spay_pad (T+1, 10, Ks) or (B, T+1, 10, Ks) per env, dpay
// (B, TT, 10, Kd), ids (B, TT), counts_s_pad (T+1,) or (B, T+1),
// counts_d (B, TT) as in K2f (composite_sel.cu); ct (B, T+1, 8, P) the
// cotangent of out and out (B, T+1, 8, P) the forward's output, both read
// only at the rows the slots name.  Outputs: gs, spay_pad's shape, zeroed by
// the caller, receives each slot's static gradient summed into the row of
// its static list with atomicAdd: its tile's row (shared), or its tile's row
// of its own env (per env: the reference's dense ids meet no contention, and
// other ids get the true gradient, scattered by id); nothing for the trash
// row T, nothing for entries the forward never applied; gd (B, TT, 10, Kd)
// the gradient of each slot's dynamic list, every column written once (zero
// past count_d).
//
// Design: K2f's block and pixel layout and its merged walk replayed
// (grad_block in composite_sel_walk.cuh, shared with K4b), T advanced by
// the very float operations K2f used (pixel_grad in composite_common.cuh),
// so every stop decision and every cull is K2f's, and nothing beyond out is
// saved (the TPU saves a (B, TT, P, Kd) log-transmittance block, 604 MB at
// the main path's shape).  Along the walk each pixel keeps per-channel
// prefix sums over the merged order, so an entry's suffix is
// ct . (out - prefix), rounded as K2f rounded out (no float32
// cancellation).  Per entry a thread first sums its 2 pixels in registers;
// the warp then sums its 10 rows by a transposed halving exchange (12
// shuffles, not 50) into per-warp partials in shared memory, and the block
// adds the warps' partials in warp order (deterministic) after each chunk,
// and for the dynamic list when its window retires.  The static sums go
// straight to their tile rows with atomicAdd, so there is no per-slot
// buffer and no separate per-tile sum (the cross-env order of those adds
// varies from run to run).  Each dynamic column belongs to exactly one
// window of the one block that owns its row, so its sums are stored, not
// added: the dynamic gradient needs no atomics at any capacity.  The window
// is smaller than K2f's (the partials take 40 B per staged column and
// warp): 896 entries at ts 16, 128 at ts 32.
//
// What bounds it on an H100: the latency and issue of the per-pixel
// gradient, not bytes.  The first design walked every entry for every
// pixel and reduced every entry that any pixel of a warp hit with 50
// shuffles, in 8 warps whose 90 KB of partials left 2 blocks per SM.  Here
// the cull removes the entries a warp cannot touch before any work, the
// reduction takes 12 shuffles for 2 pixels, and with half the warps a block
// the partials (warps × 10 × (W + 128) floats) leave more blocks per SM.
// Measured with each lever undone (chip_levers.py), what is left is mostly
// the per-pixel gradient of the kept pairs, its IEEE division by 1 - alpha
// the largest single part (kept: the gradient's bits stay those of the
// first design); the warp sums and the atomic per-tile adds cost little.

#include <cuda_runtime.h>

#include "composite_sel_walk.cuh"

using namespace splat;

namespace {

// WINDOWS: the dynamic list takes more than one window (sel::Layout).
template <bool WINDOWS>
__global__ void __launch_bounds__(sel::MAX_THREADS)
composite_pair_sel_bwd(const float* __restrict__ spay,
                       const float* __restrict__ dpay,
                       const int* __restrict__ ids,
                       const int* __restrict__ counts_s_pad,
                       const int* __restrict__ counts_d,
                       const float* __restrict__ ct,
                       const float* __restrict__ out,
                       float* __restrict__ gs, float* __restrict__ gd, int TT,
                       int T1, int Ks, int Kd, int W, int ts, int tx,
                       float power_min, int has_pmin, float term_eps,
                       int has_term, int per_env) {
  extern __shared__ float4 smem[];
  const sel::Smem s = sel::carve(smem, W, blockDim.x >> 5);
  const int b = blockIdx.y;
  const int slot = b * TT + blockIdx.x;
  const int tid = ids[slot];
  const int P = ts * ts;
  const sel::Pixels pix(ts, tx, tid);
  const size_t row = (size_t)(b * T1 + tid) * 8 * P;
  const size_t srow = (per_env ? (size_t)b * T1 : 0) + tid;  // static list
  // the trash row T (pads) gets nothing
  float* gtile = tid < T1 - 1 ? gs + srow * ROWS * Ks : nullptr;
  sel::grad_block<false, WINDOWS>(
      s, pix, spay + srow * ROWS * Ks, Ks, min(counts_s_pad[srow], Ks),
      dpay + (size_t)slot * ROWS * Kd, Kd, min(counts_d[slot], Kd),
      power_min, has_pmin != 0, term_eps, has_term != 0, ct + row, out + row,
      P, gtile, gd + (size_t)slot * ROWS * Kd);
}

}  // namespace

// The caller checks the layout, as for composite_pair_sel_launch, and
// zeroes gs.
extern "C" int composite_pair_sel_bwd_launch(
    const void* spay, const void* dpay, const void* ids,
    const void* counts_s_pad, const void* counts_d, const void* ct,
    const void* out, void* gs, void* gd, int B, int TT, int T1, int Ks,
    int Kd, int ts, int tx, float power_min, int has_pmin, float term_eps,
    int has_term, int per_env, void* stream) {
  if (B <= 0 || TT <= 0) return (int)cudaGetLastError();
  const sel::Layout l(Kd, ts, true);
  auto kernel =
      l.windows ? composite_pair_sel_bwd<true> : composite_pair_sel_bwd<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)l.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(TT, B), l.threads, l.smem, (cudaStream_t)stream>>>(
      (const float*)spay, (const float*)dpay, (const int*)ids,
      (const int*)counts_s_pad, (const int*)counts_d, (const float*)ct,
      (const float*)out, (float*)gs, (float*)gd, TT, T1, Ks, Kd, l.W, ts, tx,
      power_min, has_pmin, term_eps, has_term, per_env);
  return (int)cudaGetLastError();
}

// Blocks of composite_pair_sel_bwd that fit on one SM at (Kd, ts) into
// *blocks.
extern "C" int composite_pair_sel_bwd_blocks_per_sm(int Kd, int ts,
                                                    int* blocks) {
  const sel::Layout l(Kd, ts, true);
  auto kernel =
      l.windows ? composite_pair_sel_bwd<true> : composite_pair_sel_bwd<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)l.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, l.threads, l.smem);
  return (int)err;
}
