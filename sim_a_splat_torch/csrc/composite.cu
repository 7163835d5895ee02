// Kernel K1 forward: per-tile front-to-back alpha compositing of the static
// background's depth-sorted tile lists.
//
// Replaces the TPU kernel _fwd_kernel / _call_fwd of
// sim_a_splat_tpu/ops/pallas_composite.py (composite_pallas).
//
// Layout: payload (T, 10, K) float32 field-major rows [x, y, conic a b c,
// r, g, b, depth, opacity], K % 128 == 0, entries depth-sorted per tile with
// the active ones first; counts (T,) and skip (T,) int32.  Outputs:
// out (T, P, 8) [r, g, b, depth_acc, trans, 0, 0, 0] and carries (T, P, nc),
// the transmittance at the start of every 128-entry chunk, P = ts * ts; and
// the state K1b restarts from, chunk_acc (T, nc, 4, P): the r, g, b,
// depth_acc accumulators at the start of every chunk.  T may be B images of
// T_img tiles each, (B, T_img, ...) flattened (what jax.vmap of the
// reference's kernel over envs computes): list t covers tile t % T_img of
// its image, so a block takes its pixels from that tile.
//
// Design: two launches on one stream (composite_static_launch).
// 1. One block per (tile, chunk) composites its chunk from T = 1
//    (composite_static_walk.cuh): the chunk staged entry-major with its cull
//    boxes, one pixel a thread, warps owning 8 × 4 pixel rectangles, and
//    each warp visiting only the entries whose footprint can reach its
//    rectangle.  It writes the chunk's local sums to chunk_acc and its local
//    transmittance to carries.  Chunks at or past the tile's count (and all
//    chunks of a tile with skip == 0) do nothing.
// 2. One block per tile, one thread per pixel, combines the chunks in order
//    as the reference's _fwd_kernel does: while the tile is alive and the
//    chunk starts before the count, acc <- fmaf(tc, acc_l, acc) and
//    tc <- tc T_l, then the stop check over the whole tile; it overwrites
//    each chunk's local results with the chunk-start acc and tc (the saved
//    state) and writes out.  Chunks past the stop are read by no one.
//
// What bounds it on an H100: neither bytes nor FLOPs (the input is ~10 MB,
// the work ~24 FLOP per applied (pixel, entry) pair).  The first design
// walked each tile's chunks one after another in one block of 8 warps:
// 256 blocks on 132 SMs, the kernel as long as the 8-chunk tiles' walk of
// 1,024 dependent steps.  Here the walk is 128 steps at most, over ~1,300
// chunk blocks that fill the card, and the cull removes the entries a warp
// cannot touch; the combine is nc steps per pixel.

#include <cuda_runtime.h>

#include "composite_static_walk.cuh"

using namespace splat;

namespace {

__global__ void __launch_bounds__(stat::MAX_THREADS)
composite_static_chunks(const float* __restrict__ payload,
                        const int* __restrict__ counts,
                        const int* __restrict__ skip,
                        float* __restrict__ carries,
                        float* __restrict__ chunk_acc, int T_img, int K,
                        int ts, int tx, float power_min, int has_pmin) {
  extern __shared__ float4 smem[];
  const int t = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int count = skip[t] > 0 ? counts[t] : 0;
  const int c0 = c * CHUNK;
  if (c0 >= count) return;                     // uniform across the block
  const int n = min(CHUNK, count - c0);
  const bool pm = has_pmin != 0;
  const sel::Smem s = sel::carve(smem, 0, blockDim.x >> 5);
  const stat::Pixel pix(ts, tx, t % T_img);

  stat::stage_chunk(s, payload + (size_t)t * ROWS * K, K, c0, n, power_min,
                    pm);
  __syncthreads();
  float T, acc[4];
  stat::composite_chunk(s, pix, n, power_min, pm, acc, T);

  if (!pix.on) return;
  const int P = ts * ts;
  float* ca = chunk_acc + (size_t)(t * nc + c) * 4 * P + pix.p;
#pragma unroll
  for (int j = 0; j < 4; ++j) ca[j * P] = acc[j];
  carries[((size_t)t * P + pix.p) * nc + c] = T;
}

__global__ void __launch_bounds__(1024)
composite_static_combine(const int* __restrict__ counts,
                         const int* __restrict__ skip,
                         float* __restrict__ out, float* __restrict__ carries,
                         float* __restrict__ chunk_acc, int nc,
                         float term_eps, int has_term) {
  const int t = blockIdx.x, p = threadIdx.x, P = blockDim.x;
  const int count = skip[t] > 0 ? counts[t] : 0;
  float* car = carries + ((size_t)t * P + p) * nc;
  float* ca = chunk_acc + (size_t)t * nc * 4 * P + p;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float tc = 1.0f;
  bool alive = true;
  for (int c = 0; c < nc; ++c, ca += 4 * P) {
    const bool act = alive && c * CHUNK < count;   // uniform across the block
    float local[4], tl = 1.0f;
    if (act) {
#pragma unroll
      for (int j = 0; j < 4; ++j) local[j] = ca[j * P];
      tl = car[c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) ca[j * P] = acc[j];
    car[c] = tc;
    if (act) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(tc, local[j], acc[j]);
      tc = tc * tl;
      if (has_term) alive = __syncthreads_or(tc >= term_eps) != 0;
    }
  }
  float4* o = reinterpret_cast<float4*>(out + ((size_t)t * P + p) * 8);
  o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  o[1] = make_float4(tc, 0.0f, 0.0f, 0.0f);
}

}  // namespace

// The caller checks the layout (ts <= 32, K % 128 == 0, T_img divides T).
extern "C" int composite_static_launch(const void* payload, const void* counts,
                                       const void* skip, void* out,
                                       void* carries, void* chunk_acc, int T,
                                       int T_img, int K, int ts, int tx,
                                       float power_min, int has_pmin,
                                       float term_eps, int has_term,
                                       void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  const int nc = K / CHUNK;
  const int threads = stat::block_threads(ts);
  const size_t smem = stat::smem_bytes(threads / 32, false);
  composite_static_chunks<<<dim3(T, nc), threads, smem,
                            (cudaStream_t)stream>>>(
      (const float*)payload, (const int*)counts, (const int*)skip,
      (float*)carries, (float*)chunk_acc, T_img, K, ts, tx, power_min,
      has_pmin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  composite_static_combine<<<T, ts * ts, 0, (cudaStream_t)stream>>>(
      (const int*)counts, (const int*)skip, (float*)out, (float*)carries,
      (float*)chunk_acc, nc, term_eps, has_term);
  return (int)cudaGetLastError();
}
