// Kernel K2 backward: gradient of the selected-tile composite of the shared
// static tile lists interleaved by depth with each env's dynamic lists.
//
// Replaces the TPU kernel _bwd_kernel / _call_bwd of
// sim_a_splat_tpu/ops/pallas_composite_sel.py (the backward of the custom
// VJP composite_pair_sel, shared 3-D static payload).
//
// Layout: spay_pad (T+1, 10, Ks), dpay (B, TT, 10, Kd), ids (B, TT),
// counts_s_pad (T+1,), counts_d (B, TT) as in K2f (composite_sel.cu);
// ct (B, T+1, 8, P) the cotangent of out and out (B, T+1, 8, P) the
// forward's output, both read only at the rows the slots name.  Outputs,
// per slot as the TPU kernel emits them: gs (B, TT, 10, Ks) the gradient of
// the static list the slot composited and gd (B, TT, 10, Kd) of its
// dynamic list, every column written once, zero for entries the forward
// never applied (pads, past the counts, static chunks after the early
// stop).  The caller sums gs into its tiles (index_add_ over ids).
//
// Design: one block per (env, slot), one thread per pixel.  The TPU
// training forward saves a (B, TT, P, Kd) log-transmittance block (604 MB
// at the main path's shape) and the applied-chunk count, and its backward
// rebuilds the interleaving with depth-indicator contractions.  Here the
// forward's merged walk is replayed instead: the same sequence as K2f
// (static first on equal depth, the early stop on the running T after each
// applied static chunk, the remaining dynamic entries always composited),
// with T advanced by the same float operations, so every stop decision is
// bit-identical to K2f's and nothing beyond out is saved.  Along the walk
// each thread keeps per-channel prefix sums over the merged order, so the
// suffix of an entry, the union suffix sum of both lists, is
// ct . (out - prefix), rounded as K2f rounded out (entry_grad in
// composite_common.cuh: the reference's s_tot - prefix, without its
// float32 cancellation).  Per-entry sums over the pixels go through
// per-warp partials in shared memory, added in warp order: deterministic,
// no atomics.  The dynamic list, one static
// chunk and both partial buffers take 10 (Kd + 128)(1 + warps) floats
// (90 KB at Kd = 128, 8 warps): dynamic shared memory above 48 KB.
//
// What bounds it on an H100: the per-pixel sequential walk and the
// per-entry warp reductions, not bytes: a block reads at most ~45 KB of
// payload, and the 4,608 blocks of the main path keep all 132 SMs busy.
// The largest traffic is the per-slot static output (10 Ks floats per
// slot, 189 MB at the main path's shape), written once.

#include <cuda_runtime.h>

#include "composite_common.cuh"

using namespace splat;

namespace {

__global__ void __launch_bounds__(1024)
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
  extern __shared__ float smem[];
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int warps = P >> 5;
  float* sd = smem;                              // (ROWS, Kd) dynamic list
  float* ss = sd + ROWS * Kd;                    // (ROWS, CHUNK) static chunk
  float* part_s = ss + ROWS * CHUNK;             // (warps, ROWS, CHUNK)
  float* part_d = part_s + warps * ROWS * CHUNK;  // (warps, ROWS, Kd)
  float* my_part_s = part_s + (p >> 5) * ROWS * CHUNK;
  float* my_part_d = part_d + (p >> 5) * ROWS * Kd;
  const int b = blockIdx.y;
  const int slot = b * TT + blockIdx.x;
  const int tid = ids[slot];
  const int count_s = min(counts_s_pad[tid], Ks);
  const int count_d = min(counts_d[slot], Kd);
  const bool pm = has_pmin != 0;

  const float* dsrc = dpay + (size_t)slot * ROWS * Kd;
  for (int i = p; i < ROWS * Kd; i += P) sd[i] = dsrc[i];

  const size_t row = (size_t)(b * T1 + tid) * 8 * P + p;
  BwdPixel st;
  init_bwd_pixel(st, (float)(p % ts) + 0.5f + (float)((tid % tx) * ts),
                 (float)(p / ts) + 0.5f + (float)((tid / tx) * ts), ct + row,
                 out + row, P);
  float* gs_slot = gs + (size_t)slot * ROWS * Ks;
  float* gd_slot = gd + (size_t)slot * ROWS * Kd;
  const float* tile = spay + (size_t)tid * ROWS * Ks;

  float g[ROWS];
  int j = 0;                                     // next dynamic entry
  int c0 = 0;                                    // next static chunk
  while (c0 < count_s) {
    __syncthreads();          // sd loaded; previous chunk's partials read
    stage_chunk(ss, tile, Ks, c0);
    __syncthreads();
    const int n = min(CHUNK, count_s - c0);
    for (int e = 0; e < n; ++e) {
      const float ds = ss[ROW_DEPTH * CHUNK + e];
      while (j < count_d && sd[ROW_DEPTH * Kd + j] < ds) {
        const bool hit = entry_grad(sd, Kd, j, power_min, pm, st, g);
        warp_sum_rows(g, hit, my_part_d, Kd, j);
        ++j;
      }
      const bool hit = entry_grad(ss, CHUNK, e, power_min, pm, st, g);
      warp_sum_rows(g, hit, my_part_s, CHUNK, e);
    }
    __syncthreads();
    block_sum_rows(part_s, warps, CHUNK, n, CHUNK, gs_slot + c0, Ks);
    c0 += CHUNK;
    if (has_term && !__syncthreads_or(st.T >= term_eps)) break;
  }
  zero_cols(gs_slot, Ks, c0, Ks);
  __syncthreads();                               // sd loaded (no chunk ran)
  for (; j < count_d; ++j) {
    const bool hit = entry_grad(sd, Kd, j, power_min, pm, st, g);
    warp_sum_rows(g, hit, my_part_d, Kd, j);
  }
  __syncthreads();
  block_sum_rows(part_d, warps, Kd, count_d, Kd, gd_slot, Kd);
}

}  // namespace

extern "C" int composite_pair_sel_bwd_launch(
    const void* spay, const void* dpay, const void* ids,
    const void* counts_s_pad, const void* counts_d, const void* ct,
    const void* out, void* gs, void* gd, int B, int TT, int T1, int Ks,
    int Kd, int ts, int tx, float power_min, int has_pmin, float term_eps,
    int has_term, void* stream) {
  if (B > 0 && TT > 0) {
    const int threads = ts * ts;
    const size_t smem =
        sizeof(float) * ROWS * (Kd + CHUNK) * (1 + threads / 32);
    cudaError_t err = cudaFuncSetAttribute(
        composite_pair_sel_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    composite_pair_sel_bwd<<<dim3(TT, B), threads, smem,
                             (cudaStream_t)stream>>>(
        (const float*)spay, (const float*)dpay, (const int*)ids,
        (const int*)counts_s_pad, (const int*)counts_d, (const float*)ct,
        (const float*)out, (float*)gs, (float*)gd, TT, T1, Ks, Kd, ts, tx,
        power_min, has_pmin, term_eps, has_term);
  }
  return (int)cudaGetLastError();
}
