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
// Design: one block per (env, slot), one thread per pixel.  The env's
// dynamic list stays in shared memory and the merged order is walked
// directly (pair_walk in composite_common.cuh, shared with K4f): every
// thread walks the same sequence, static first on equal depth, with the
// early stop after each applied static chunk.
//
// What bounds it on an H100: the per-pixel sequential walk (latency and
// instruction rate), not bytes: one block reads at most ~45 KB of payload and the
// 4,608 blocks of the main path keep all 132 SMs busy.  The design keeps
// both lists in shared memory (broadcast reads) and T in a register, and the
// dynamic payload is read from device memory once per block.

#include <cuda_runtime.h>

#include "composite_common.cuh"

using namespace splat;

namespace {

__global__ void __launch_bounds__(1024)
composite_pair_sel_fwd(const float* __restrict__ spay,
                       const float* __restrict__ dpay,
                       const int* __restrict__ ids,
                       const int* __restrict__ counts_s_pad,
                       const int* __restrict__ counts_d,
                       float* __restrict__ out, int TT, int T1, int Ks,
                       int Kd, int ts, int tx, float power_min, int has_pmin,
                       float term_eps, int has_term) {
  extern __shared__ float smem[];
  float* sd = smem;                  // (10, Kd) dynamic list of this slot
  float* ss = smem + ROWS * Kd;      // (10, CHUNK) current static chunk
  const int b = blockIdx.y;
  const int slot = b * TT + blockIdx.x;
  const int tid = ids[slot];
  const int count_s = min(counts_s_pad[tid], Ks);
  const int count_d = min(counts_d[slot], Kd);
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const bool pm = has_pmin != 0;
  const float px = (float)(p % ts) + 0.5f + (float)((tid % tx) * ts);
  const float py = (float)(p / ts) + 0.5f + (float)((tid / tx) * ts);

  const float* dsrc = dpay + (size_t)slot * ROWS * Kd;
  for (int i = p; i < ROWS * Kd; i += P) sd[i] = dsrc[i];
  __syncthreads();

  const float* tile = spay + (size_t)tid * ROWS * Ks;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float T = 1.0f;
  pair_walk(ss, sd, Kd, count_d, tile, Ks, count_s, px, py, power_min, pm,
            term_eps, has_term != 0, acc, T);

  float* o = out + (size_t)(b * T1 + tid) * 8 * P + p;
  o[0 * P] = acc[0];
  o[1 * P] = acc[1];
  o[2 * P] = acc[2];
  o[3 * P] = acc[3];
  o[4 * P] = T;
  o[5 * P] = 0.0f;
  o[6 * P] = 0.0f;
  o[7 * P] = 0.0f;
}

}  // namespace

extern "C" int composite_pair_sel_launch(
    const void* spay, const void* dpay, const void* ids,
    const void* counts_s_pad, const void* counts_d, void* out, int B, int TT,
    int T1, int Ks, int Kd, int ts, int tx, float power_min, int has_pmin,
    float term_eps, int has_term, void* stream) {
  if (B > 0 && TT > 0) {
    const size_t smem = sizeof(float) * ROWS * (Kd + CHUNK);
    composite_pair_sel_fwd<<<dim3(TT, B), ts * ts, smem,
                             (cudaStream_t)stream>>>(
        (const float*)spay, (const float*)dpay, (const int*)ids,
        (const int*)counts_s_pad, (const int*)counts_d, (float*)out, TT, T1,
        Ks, Kd, ts, tx, power_min, has_pmin, term_eps, has_term);
  }
  return (int)cudaGetLastError();
}
