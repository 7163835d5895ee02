// Kernel K2 backward: gradient of the selected-tile composite of the shared
// static tile lists interleaved by depth with each env's dynamic lists.
//
// Replaces the TPU kernel _bwd_kernel / _call_bwd of
// sim_a_splat_tpu/ops/pallas_composite_sel.py (the backward of the custom
// VJP composite_pair_sel, shared 3-D static payload, with the per-tile sum
// _scatter_rows).
//
// Layout: spay_pad (T+1, 10, Ks), dpay (B, TT, 10, Kd), ids (B, TT),
// counts_s_pad (T+1,), counts_d (B, TT) as in K2f (composite_sel.cu);
// ct (B, T+1, 8, P) the cotangent of out and out (B, T+1, 8, P) the
// forward's output, both read only at the rows the slots name.  Outputs:
// gs (T+1, 10, Ks), zeroed by the caller, receives each slot's static
// gradient summed into its tile row with atomicAdd (nothing for the trash
// row T, nothing for entries the forward never applied); gd (B, TT, 10, Kd)
// the gradient of each slot's dynamic list, every column written once (zero
// past count_d).
//
// Design: K2f's block and pixel layout and its merged walk
// (composite_sel_walk.cuh) replayed, T advanced by the very float
// operations K2f used (pixel_grad in composite_common.cuh), so every stop
// decision and every cull is K2f's, and nothing beyond out is saved (the
// TPU saves a (B, TT, P, Kd) log-transmittance block, 604 MB at the main
// path's shape).  Along the walk each pixel keeps per-channel prefix sums
// over the merged order, so an entry's suffix is ct . (out - prefix),
// rounded as K2f rounded out (no float32 cancellation).  Per entry a thread
// first sums its 2 pixels in registers; the warp then sums its 10 rows by
// a transposed halving exchange (12 shuffles, not 50) into per-warp
// partials in shared memory, and the block adds the warps' partials in warp
// order (deterministic) after each chunk, and for the dynamic list at the
// end.  The static sums go straight to their tile rows with atomicAdd, so
// there is no per-slot buffer and no separate per-tile sum (the cross-env
// order of those adds varies from run to run).
//
// Where the dynamic list's partials (warps × 10 × Kd floats) do not fit
// beside the staged lists (Kd > 2176 at ts 8, > 896 at ts 16, > 384 at
// ts 24, > 128 at ts 32), the block zeroes its slot's row of gd and each
// warp adds its dynamic sums to it with atomicAdd instead (their order then
// varies from run to run).  Only there: at the main path's Kd = 128, ts 16
// the atomic layout took 2.13 ms against 1.96 (+8.8 %, chip_levers.py lever
// atomic_sums, H100 80GB HBM3 at 700 W).
//
// What bounds it on an H100: the latency and issue of the per-pixel
// gradient, not bytes.  The first design walked every entry for every
// pixel and reduced every entry that any pixel of a warp hit with 50
// shuffles, in 8 warps whose 90 KB of partials left 2 blocks per SM.  Here
// the cull removes the entries a warp cannot touch before any work, the
// reduction takes 12 shuffles for 2 pixels, and with half the warps a block
// the partials (warps × 10 × (Kd + 128) floats) leave more blocks per SM.
// Measured with each lever undone (chip_levers.py), what is left is mostly
// the per-pixel gradient of the kept pairs, its IEEE division by 1 - alpha
// the largest single part (kept: the gradient's bits stay those of the
// first design); the warp sums and the atomic per-tile adds cost little.

#include <cuda_runtime.h>

#include "composite_sel_walk.cuh"

using namespace splat;

namespace {

// DYN_PARTIALS: the warps' partial sums of the dynamic list are kept in
// shared memory with the static chunk's (the layout wherever it fits);
// else each warp adds its dynamic sums atomically to the slot's row of gd,
// which the block zeroes first.
template <bool DYN_PARTIALS>
__global__ void __launch_bounds__(sel::MAX_THREADS)
composite_pair_sel_bwd(const float* __restrict__ spay,
                       const float* __restrict__ dpay,
                       const int* __restrict__ ids,
                       const int* __restrict__ counts_s_pad,
                       const int* __restrict__ counts_d,
                       const float* __restrict__ ct,
                       const float* __restrict__ out,
                       float* __restrict__ gs, float* __restrict__ gd, int TT,
                       int T1, int Ks, int Kd, int ts, int tx,
                       float power_min, int has_pmin, float term_eps,
                       int has_term) {
  extern __shared__ float4 smem[];
  const int warps = blockDim.x >> 5;
  const sel::Smem s = sel::carve(smem, Kd, warps);
  const int b = blockIdx.y;
  const int slot = b * TT + blockIdx.x;
  const int tid = ids[slot];
  const int count_s = min(counts_s_pad[tid], Ks);
  const int count_d = min(counts_d[slot], Kd);
  const bool pm = has_pmin != 0;
  const int P = ts * ts;
  const sel::Pixels pix(ts, tx, tid);

  sel::stage_dynamic(s, dpay + (size_t)slot * ROWS * Kd, Kd, count_d,
                     pix.rect, power_min, pm);
  BwdPixel st[sel::PY];
#pragma unroll
  for (int k = 0; k < sel::PY; ++k) {
    const size_t row = (size_t)(b * T1 + tid) * 8 * P + pix.p[k];
    init_bwd_pixel(st[k], pix.px, pix.py[k], ct + row, out + row, P);
  }
  // a warp's partial sums: row stride and the column of staged column i
  const int pstride = DYN_PARTIALS ? s.L : CHUNK;
  auto pcol = [&](int i) { return DYN_PARTIALS ? i : i - Kd; };
  float* part = s.part + (threadIdx.x >> 5) * ROWS * pstride;
  float* gslot = gd + (size_t)slot * ROWS * Kd;
  if (!DYN_PARTIALS) {
    for (int j = threadIdx.x; j < Kd; j += blockDim.x) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) gslot[r * Kd + j] = 0.0f;
    }
    __syncthreads();
  }
  auto visit = [&](int i) {
    const float4 g0 = s.g0[i];
    const float2 g1 = s.g1[i];
    const float4 c4 = s.col[i];
    const float col[4] = {c4.x, c4.y, c4.z, c4.w};
    float sum[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) sum[r] = 0.0f;
    bool any = false;
#pragma unroll
    for (int k = 0; k < sel::PY; ++k) {
      const Geom G = geom_at(g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, st[k].px,
                             st[k].py, power_min, pm);
      if (G.alpha > 0.0f) {
        float g[ROWS];
        pixel_grad(G, g0.z, g0.w, g1.x, col, st[k], g);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) sum[r] += g[r];
        any = true;
      }
    }
    if (DYN_PARTIALS || i >= Kd)
      sel::warp_sum_store(sum, any, part + pcol(i), pstride);
    else
      sel::warp_sum_store<true>(sum, any, gslot + i, Kd);
  };
  // the warps (a bit mask) that visited staged column i, from their hit
  // words (dynamic, or the current static chunk's)
  auto visitors = [&](const unsigned* hits, int words, int e) {
    unsigned m = 0;
    for (int w = 0; w < warps; ++w)
      m |= ((hits[w * words + (e >> 5)] >> (e & 31)) & 1u) << w;
    return m;
  };
  // row r of staged column i summed over the warps of mask m, in warp
  // order
  auto warp_total = [&](unsigned m, int r, int i) {
    float v = 0.0f;
    for (; m; m &= m - 1u)
      v += s.part[((__ffs(m) - 1) * ROWS + r) * pstride + pcol(i)];
    return v;
  };
  // after each applied chunk: each entry's sums go to the tile's row (the
  // trash row gets nothing), one entry per thread
  float* gtile = gs + (size_t)tid * ROWS * Ks;
  const bool real = tid < T1 - 1;
  auto chunk_end = [&](int c0, int n) {
    __syncthreads();
    for (int e = threadIdx.x; e < n && real; e += blockDim.x) {
      const unsigned m = visitors(s.shit, CHUNK / 32, e);
      if (!m) continue;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float v = warp_total(m, r, Kd + e);
        if (v != 0.0f) atomicAdd(gtile + r * Ks + c0 + e, v);
      }
    }
  };
  auto alive = [&]() {
    bool on = false;
#pragma unroll
    for (int k = 0; k < sel::PY; ++k) on |= st[k].T >= term_eps;
    return on;
  };
  sel::merged_walk(s, spay + (size_t)tid * ROWS * Ks, Ks, count_s, Kd,
                   count_d, pix.rect, power_min, pm, has_term != 0, visit,
                   chunk_end, alive);

  // the dynamic list's sums, every column written once
  if (!DYN_PARTIALS) return;
  __syncthreads();
  for (int j = threadIdx.x; j < Kd; j += blockDim.x) {
    const unsigned m = j < count_d ? visitors(s.dhit, s.dwords, j) : 0u;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) gslot[r * Kd + j] = warp_total(m, r, j);
  }
}

// The layout of a K2b block at (Kd, warps): the dynamic list's partial
// sums in shared memory where they fit, else added to gd atomically.
bool dyn_partials(int Kd, int warps) {
  return sel::smem_bytes(Kd, warps, true) <= SMEM_OPTIN;
}

template <bool DYN_PARTIALS>
int launch(const void* spay, const void* dpay, const void* ids,
           const void* counts_s_pad, const void* counts_d, const void* ct,
           const void* out, void* gs, void* gd, int B, int TT, int T1,
           int Ks, int Kd, int ts, int tx, float power_min, int has_pmin,
           float term_eps, int has_term, cudaStream_t stream) {
  const int threads = ts * ts / sel::PY;
  const size_t smem = sel::smem_bytes(Kd, threads / 32, true, DYN_PARTIALS);
  cudaError_t err = cudaFuncSetAttribute(
      composite_pair_sel_bwd<DYN_PARTIALS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  composite_pair_sel_bwd<DYN_PARTIALS>
      <<<dim3(TT, B), threads, smem, stream>>>(
          (const float*)spay, (const float*)dpay, (const int*)ids,
          (const int*)counts_s_pad, (const int*)counts_d, (const float*)ct,
          (const float*)out, (float*)gs, (float*)gd, TT, T1, Ks, Kd, ts, tx,
          power_min, has_pmin, term_eps, has_term);
  return (int)cudaGetLastError();
}

}  // namespace

// The caller checks the layout and the shared memory, as for
// composite_pair_sel_launch, and zeroes gs.
extern "C" int composite_pair_sel_bwd_launch(
    const void* spay, const void* dpay, const void* ids,
    const void* counts_s_pad, const void* counts_d, const void* ct,
    const void* out, void* gs, void* gd, int B, int TT, int T1, int Ks,
    int Kd, int ts, int tx, float power_min, int has_pmin, float term_eps,
    int has_term, void* stream) {
  if (B <= 0 || TT <= 0) return (int)cudaGetLastError();
  auto go = dyn_partials(Kd, ts * ts / sel::PY / 32) ? launch<true>
                                                     : launch<false>;
  return go(spay, dpay, ids, counts_s_pad, counts_d, ct, out, gs, gd, B, TT,
            T1, Ks, Kd, ts, tx, power_min, has_pmin, term_eps, has_term,
            (cudaStream_t)stream);
}

// Blocks of composite_pair_sel_bwd that fit on one SM at (Kd, ts) into
// *blocks.
extern "C" int composite_pair_sel_bwd_blocks_per_sm(int Kd, int ts,
                                                    int* blocks) {
  const int threads = ts * ts / sel::PY;
  const bool in_smem = dyn_partials(Kd, threads / 32);
  const size_t smem = sel::smem_bytes(Kd, threads / 32, true, in_smem);
  auto kernel = in_smem ? composite_pair_sel_bwd<true>
                        : composite_pair_sel_bwd<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                        threads, smem);
  return (int)err;
}
