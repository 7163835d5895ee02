// Kernel K3 forward: single-list selected-tile composite of per-env
// depth-sorted tile lists, the moving camera's compositor.
//
// Replaces the TPU kernel _fwd_kernel_single / _call_single_fwd of
// sim_a_splat_tpu/ops/pallas_composite_sel.py (composite_sel_single), in
// its per-env (4-D payload) mode.
//
// Layout: spay (B, T+1, 10, K) float32 field-major rows [x, y, conic a b c,
// r, g, b, depth, opacity], K % 128 == 0, each list depth-sorted with its
// active entries first; ids (B, TT) int32 tile ids (the pad id T names a
// zero-count trash row); counts (B, T+1) int32.  Output out (B, T+1, 8, P),
// channel-major, written at the rows ids name: rgb, accumulated depth,
// final transmittance, then the number of applied chunks (save_state, the
// training forward; 0 otherwise) and two zero rows.  P = ts * ts.
//
// Design: one block per (env, slot), one thread per pixel.  The walk is
// K1f's (composite_walk in composite_common.cuh): each applied chunk's
// 10 x 128 payload is staged in shared memory (5 KB) and every thread
// composites it in order with its transmittance in a register; chunks at or
// past the count are skipped, and after each applied chunk the block stops
// once no pixel has T >= term_eps.  Writes are channel-major, so each of
// the 8 rows is one coalesced 1 KB store per block.
//
// What bounds it on an H100: neither bytes nor FLOPs.  At the moving
// camera's shapes (B = 16 or 32, T = 256, K = 640) the payload is 105-210
// MB and the work ~15 FLOP per (pixel, entry) of an applied chunk, while
// each pixel's walk is sequential over up to 640 entries: the kernel is
// bound by the latency of that walk.  The grid of B * 256 blocks of 8
// warps gives the 132 SMs enough blocks to hide part of it; the design
// reads each payload column once per block and keeps the walk in
// registers and shared memory.

#include <cuda_runtime.h>

#include "composite_common.cuh"

using namespace splat;

namespace {

__global__ void __launch_bounds__(1024)
composite_single_fwd(const float* __restrict__ spay,
                     const int* __restrict__ ids,
                     const int* __restrict__ counts, float* __restrict__ out,
                     int TT, int T1, int K, int ts, int tx, float power_min,
                     int has_pmin, float term_eps, int has_term,
                     int save_state) {
  __shared__ float s[ROWS * CHUNK];
  const int b = blockIdx.y;
  const int t = ids[(size_t)b * TT + blockIdx.x];
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const size_t row = (size_t)b * T1 + t;
  const int count = counts[row];
  const float px = (float)(p % ts) + 0.5f + (float)((t % tx) * ts);
  const float py = (float)(p / ts) + 0.5f + (float)((t / tx) * ts);

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float T = 1.0f;
  const int applied =
      composite_walk(s, spay + row * ROWS * K, K, count, px, py, power_min,
                     has_pmin != 0, term_eps, has_term != 0, acc, T, nullptr);
  float* o = out + row * 8 * P + p;
  o[0 * P] = acc[0];
  o[1 * P] = acc[1];
  o[2 * P] = acc[2];
  o[3 * P] = acc[3];
  o[4 * P] = T;
  o[5 * P] = save_state ? (float)applied : 0.0f;
  o[6 * P] = 0.0f;
  o[7 * P] = 0.0f;
}

}  // namespace

extern "C" int composite_sel_single_launch(
    const void* spay, const void* ids, const void* counts, void* out, int B,
    int TT, int T1, int K, int ts, int tx, float power_min, int has_pmin,
    float term_eps, int has_term, int save_state, void* stream) {
  if (B > 0 && TT > 0) {
    composite_single_fwd<<<dim3(TT, B), ts * ts, 0, (cudaStream_t)stream>>>(
        (const float*)spay, (const int*)ids, (const int*)counts, (float*)out,
        TT, T1, K, ts, tx, power_min, has_pmin, term_eps, has_term,
        save_state);
  }
  return (int)cudaGetLastError();
}
