// Kernel K3 forward: single-list selected-tile composite of depth-sorted
// tile lists, the moving camera's compositor.
//
// Replaces the TPU kernel _fwd_kernel_single / _call_single_fwd of
// sim_a_splat_tpu/ops/pallas_composite_sel.py (composite_sel_single), in
// both of its modes.
//
// Layout: spay float32 field-major rows [x, y, conic a b c, r, g, b, depth,
// opacity], K % 128 == 0, each list depth-sorted with its active entries
// first: per-env (B, T+1, 10, K) with counts (B, T+1), or shared by every
// env, (T+1, 10, K) with counts (T+1,); ids (B, TT) int32 tile ids (the pad
// id T names a zero-count row).  Slot (b, i) composites list ids[b, i] (of
// env b, or of the shared table) over the pixels of that tile.  Output out
// (B, T+1, 8, P), channel-major, written at the rows (b, ids[b, i]): rgb,
// accumulated depth, final transmittance, then the number of applied chunks
// (save_state, the training forward; 0 otherwise) and two zero rows; P =
// ts * ts.
//
// Design: K1f's chunk walk (composite_static_walk.cuh): each chunk staged
// entry-major with its cull boxes, one pixel a thread, warps owning 8 × 4
// pixel rectangles (pixels past a tile that is not a multiple of 8 masked),
// each warp visiting only the entries whose footprint can reach its
// rectangle, and each chunk composited from T = 1 into local sums that are
// applied as K1f's combine applies them, acc <- fmaf(tc, acc_l, acc),
// tc <- tc T_l, with the reference's chunk-granular stop (no pixel at
// tc >= term_eps) after each applied chunk.  So out equals K1f's on the
// same list bit for bit, and K3b's prefix rule holds across its restarts
// (see composite_static_walk.cuh).
//
// One block per (env, slot) walks the slot's applied chunks in order, with
// the local sums and the chunk-start state in registers.  K1f spreads the
// same work over one block per (tile, chunk) and a one-block-per-tile
// combine, for parallelism that K3's grid already has: B * TT = 4,096-8,192
// slot blocks, against K1's 256 tiles, most lists one chunk long.  On the
// moving camera's frames (B = 16, an H100 80GB HBM3 at 700 W) K1f's split
// took 0.168-0.171 ms against 0.107-0.114 ms (chip_levers.py, lever
// k3_split).
//
// What bounds it on an H100: neither bytes nor FLOPs.  At the moving
// camera's shapes (B = 16 or 32, T = 256, K = 640) the applied payload is
// ~12 MB and the work ~15 FLOP per (pixel, entry) of an applied chunk;
// each pixel's walk is sequential, so the kernel is bound by the latency of
// the walk, which the cull shortens to the entries that reach a warp.

#include <cuda_runtime.h>

#include "composite_static_walk.cuh"

using namespace splat;

namespace {

// The (env, slot) of a block: its output row (b, ids[b, i]), its list and
// count.
struct Slot {
  size_t row;           // b * (T+1) + tile
  int tile, count;
  const float* list;    // (ROWS, K)
  __device__ __forceinline__ Slot(const float* spay, const int* ids,
                                  const int* counts, int b, int i, int TT,
                                  int T1, int K, bool shared) {
    tile = ids[(size_t)b * TT + i];
    row = (size_t)b * T1 + tile;
    const size_t lrow = shared ? (size_t)tile : row;
    count = counts[lrow];
    list = spay + lrow * ROWS * K;
  }
};

__device__ __forceinline__ void write_out(float* out, size_t row, int P,
                                          int p, const float acc[4], float tc,
                                          float applied) {
  float* o = out + row * 8 * P + p;
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j * P] = acc[j];
  o[4 * P] = tc;
  o[5 * P] = applied;
  o[6 * P] = 0.0f;
  o[7 * P] = 0.0f;
}

__global__ void __launch_bounds__(stat::MAX_THREADS)
composite_single_fwd(const float* __restrict__ spay,
                     const int* __restrict__ ids,
                     const int* __restrict__ counts, float* __restrict__ out,
                     int TT, int T1, int K, int ts, int tx, float power_min,
                     int has_pmin, float term_eps, int has_term,
                     int save_state, int shared) {
  extern __shared__ float4 smem[];
  const Slot sl(spay, ids, counts, blockIdx.y, blockIdx.x, TT, T1, K,
                shared != 0);
  const int nc = K / CHUNK, P = ts * ts;
  const bool pm = has_pmin != 0;
  const sel::Smem s = sel::carve(smem, 0, blockDim.x >> 5);
  const stat::Pixel pix(ts, tx, sl.tile);

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, tc = 1.0f;
  int applied = 0;
  for (int c = 0; c < nc && c * CHUNK < sl.count; ++c) {
    const int c0 = c * CHUNK, n = min(CHUNK, sl.count - c0);
    if (c > 0) __syncthreads();          // the previous chunk fully read
    stat::stage_chunk(s, sl.list, K, c0, n, power_min, pm);
    __syncthreads();
    float local[4], tl;
    stat::composite_chunk(s, pix, n, power_min, pm, local, tl);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = fmaf(tc, local[j], acc[j]);
    tc = tc * tl;
    ++applied;
    if (has_term && !__syncthreads_or(pix.on && tc >= term_eps)) break;
  }
  if (pix.on)
    write_out(out, sl.row, P, pix.p, acc, tc,
              save_state ? (float)applied : 0.0f);
}

}  // namespace

// The caller checks the layout (ts <= 32, K % 128 == 0).
extern "C" int composite_sel_single_launch(
    const void* spay, const void* ids, const void* counts, void* out, int B,
    int TT, int T1, int K, int ts, int tx, float power_min, int has_pmin,
    float term_eps, int has_term, int save_state, int shared, void* stream) {
  if (B <= 0 || TT <= 0) return (int)cudaGetLastError();
  const int threads = stat::block_threads(ts);
  const size_t smem = stat::smem_bytes(threads / 32, false);
  composite_single_fwd<<<dim3(TT, B), threads, smem,
                         (cudaStream_t)stream>>>(
      (const float*)spay, (const int*)ids, (const int*)counts, (float*)out,
      TT, T1, K, ts, tx, power_min, has_pmin, term_eps, has_term,
      save_state, shared);
  return (int)cudaGetLastError();
}
