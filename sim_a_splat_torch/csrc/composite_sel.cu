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
// Design: one block per (env, slot), ts² / 2 threads, each with 2 pixels
// of its warp's compact 8 × 8 rectangle, walking the merged order of the
// two lists (merged_walk in composite_sel_walk.cuh): both lists staged
// entry-major in shared memory, the merge positions found once per chunk,
// and a warp-level footprint cull.
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

__global__ void __launch_bounds__(sel::MAX_THREADS)
composite_pair_sel_fwd(const float* __restrict__ spay,
                       const float* __restrict__ dpay,
                       const int* __restrict__ ids,
                       const int* __restrict__ counts_s_pad,
                       const int* __restrict__ counts_d,
                       float* __restrict__ out, int TT, int T1, int Ks,
                       int Kd, int ts, int tx, float power_min, int has_pmin,
                       float term_eps, int has_term) {
  extern __shared__ float4 smem[];
  const sel::Smem s = sel::carve(smem, Kd, blockDim.x >> 5);
  const int b = blockIdx.y;
  const int slot = b * TT + blockIdx.x;
  const int tid = ids[slot];
  const int count_s = min(counts_s_pad[tid], Ks);
  const int count_d = min(counts_d[slot], Kd);
  const bool pm = has_pmin != 0;
  const sel::Pixels pix(ts, tx, tid);

  sel::stage_dynamic(s, dpay + (size_t)slot * ROWS * Kd, Kd, count_d,
                     pix.rect, power_min, pm);
  float T[sel::PY], acc[sel::PY][4];
#pragma unroll
  for (int k = 0; k < sel::PY; ++k) {
    T[k] = 1.0f;
    acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.0f;
  }
  // composite_entry's steps for each of the thread's pixels
  auto visit = [&](int i) {
    const float4 g0 = s.g0[i];
    const float2 g1 = s.g1[i];
    float a[sel::PY];
    bool any = false;
#pragma unroll
    for (int k = 0; k < sel::PY; ++k) {
      a[k] = geom_at(g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, pix.px, pix.py[k],
                     power_min, pm).alpha;
      any |= a[k] > 0.0f;
    }
    if (!any) return;
    const float4 c = s.col[i];
#pragma unroll
    for (int k = 0; k < sel::PY; ++k) {
      if (a[k] > 0.0f) {
        const float w = a[k] * T[k];
        acc[k][0] = fmaf(w, c.x, acc[k][0]);
        acc[k][1] = fmaf(w, c.y, acc[k][1]);
        acc[k][2] = fmaf(w, c.z, acc[k][2]);
        acc[k][3] = fmaf(w, c.w, acc[k][3]);
        T[k] = T[k] * (1.0f - a[k]);
      }
    }
  };
  auto alive = [&]() {
    bool on = false;
#pragma unroll
    for (int k = 0; k < sel::PY; ++k) on |= T[k] >= term_eps;
    return on;
  };
  sel::merged_walk(s, spay + (size_t)tid * ROWS * Ks, Ks, count_s, Kd,
                   count_d, pix.rect, power_min, pm, has_term != 0, visit,
                   [](int, int) {}, alive);

  const int P = ts * ts;
  float* o = out + (size_t)(b * T1 + tid) * 8 * P;
#pragma unroll
  for (int k = 0; k < sel::PY; ++k) {
    float* q = o + pix.p[k];
    q[0 * P] = acc[k][0];
    q[1 * P] = acc[k][1];
    q[2 * P] = acc[k][2];
    q[3 * P] = acc[k][3];
    q[4 * P] = T[k];
    q[5 * P] = 0.0f;
    q[6 * P] = 0.0f;
    q[7 * P] = 0.0f;
  }
}

int launch(const void* spay, const void* dpay, const void* ids,
           const void* counts_s_pad, const void* counts_d, void* out, int B,
           int TT, int T1, int Ks, int Kd, int ts, int tx, float power_min,
           int has_pmin, float term_eps, int has_term, cudaStream_t stream) {
  const int threads = ts * ts / sel::PY;
  const size_t smem = sel::smem_bytes(Kd, threads / 32, false);
  cudaError_t err = cudaFuncSetAttribute(
      composite_pair_sel_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  composite_pair_sel_fwd<<<dim3(TT, B), threads, smem, stream>>>(
      (const float*)spay, (const float*)dpay, (const int*)ids,
      (const int*)counts_s_pad, (const int*)counts_d, (float*)out, TT, T1,
      Ks, Kd, ts, tx, power_min, has_pmin, term_eps, has_term);
  return (int)cudaGetLastError();
}

}  // namespace

// The caller checks the layout (ts in {8, 16, 24, 32}) and the shared
// memory (sel::smem_bytes).
extern "C" int composite_pair_sel_launch(
    const void* spay, const void* dpay, const void* ids,
    const void* counts_s_pad, const void* counts_d, void* out, int B, int TT,
    int T1, int Ks, int Kd, int ts, int tx, float power_min, int has_pmin,
    float term_eps, int has_term, void* stream) {
  if (B <= 0 || TT <= 0) return (int)cudaGetLastError();
  return launch(spay, dpay, ids, counts_s_pad, counts_d, out, B, TT, T1, Ks,
                Kd, ts, tx, power_min, has_pmin, term_eps, has_term,
                (cudaStream_t)stream);
}

// Blocks of composite_pair_sel_fwd that fit on one SM at (Kd, ts)
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into *blocks.
extern "C" int composite_pair_sel_blocks_per_sm(int Kd, int ts, int* blocks) {
  const int threads = ts * ts / sel::PY;
  const size_t smem = sel::smem_bytes(Kd, threads / 32, false);
  cudaError_t err = cudaFuncSetAttribute(
      composite_pair_sel_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, composite_pair_sel_fwd, threads, smem);
  return (int)err;
}
