// Kernel K4 backward: gradient of the merge-free composite of the shared
// static tile lists interleaved by depth with each env's dynamic lists.
//
// Replaces the TPU kernel _bwd_kernel / _call_bwd of
// sim_a_splat_tpu/ops/pallas_composite_pair.py (the backward of the custom
// VJP composite_pallas_pair, run under the per-env step's vmap).
//
// Layout: spay (T, 10, Ks), dpay (B, T, 10, Kd), counts_s (T,), counts_d
// (B, T) and skip (B, T) as in K4f (composite_pair.cu); ct (B, T, P, 8) the
// cotangent of out and out (B, T, P, 8) the forward's output.  Outputs:
// gs (T, 10, Ks), the gradient of the shared static lists summed over the
// envs, which the caller zeroes before the launch; gd (B, T, 10, Kd), each
// env's dynamic gradient, every column written (zero for skipped pairs and
// past the counts).
//
// Design: one block per (tile, env), one thread per pixel, as K4f.  The TPU
// kernel needs no saved state: pass A replays the forward's stop decisions,
// pass B takes the static gradients from union suffix sums, then the
// dynamic ones.  Here K4f's merged walk is replayed once (pair_walk_grad in
// composite_common.cuh): every stop decision is bit-identical
// to K4f's, and each entry's union suffix sum is ct . (out - prefix) with
// the prefixes rounded as K4f rounded out.
//
// The static gradient is shared by every env (the reference's vmap sums
// each env's (T, 10, Ks) gradient in its transpose).  A per-env buffer
// would be 1.34 GB at the main path's shape, and only the ~13 % of pairs a
// dynamic gaussian touches contribute.  So each block sums its entries over
// the pixels in shared memory (per-warp partials in warp order, no atomics)
// and adds the nonzero sums to its tile's row with atomicAdd: no buffer,
// no compaction of the touched pairs on the host, and a contention of at
// most B blocks per row.  The order of those float additions across envs
// changes from run to run.
//
// Where the warps' partials do not fit in a block's shared memory beside
// the dynamic list (Kd > 512 at ts 16), the block zeroes its pair's gd row
// and every warp adds its sums to gs and gd with atomicAdd instead.  Only
// there: at the main path's Kd = 128, ts 16 the atomic layout took 4.65 ms
// against 4.22 (+10 %, chip_levers.py lever atomic_sums, H100 80GB HBM3 at
// 700 W).
//
// What bounds it on an H100: the per-pixel sequential walk and the
// per-entry warp reductions of the touched pairs; the largest
// traffic is the dynamic gradient gd (168 MB at the main path's shape),
// written once, most of it zeros of skipped pairs.

#include <cuda_runtime.h>

#include "composite_common.cuh"

using namespace splat;

namespace {

// Shared memory of a K4b block: the dynamic list (ROWS, Kd) and one static
// chunk, and with partials each warp's per-entry sums of both.
size_t smem_bytes(int Kd, int warps, bool partials) {
  return sizeof(float) * ROWS * (Kd + CHUNK) * (1 + (partials ? warps : 0));
}

template <bool PARTIALS>
__global__ void __launch_bounds__(1024)
composite_pair_bwd(const float* __restrict__ spay,
                   const float* __restrict__ dpay,
                   const int* __restrict__ counts_s,
                   const int* __restrict__ counts_d,
                   const int* __restrict__ skip,
                   const float* __restrict__ ct,
                   const float* __restrict__ out, float* __restrict__ gs,
                   float* __restrict__ gd, int n_tiles, int Ks, int Kd,
                   int ts, int tx, float power_min, int has_pmin,
                   float term_eps, int has_term) {
  extern __shared__ float smem[];
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int warps = P >> 5;
  float* sd = smem;                              // (ROWS, Kd) dynamic list
  float* ss = sd + ROWS * Kd;                    // (ROWS, CHUNK) static chunk
  float* part_s = ss + ROWS * CHUNK;             // (warps, ROWS, CHUNK)
  float* part_d = part_s + warps * ROWS * CHUNK;  // (warps, ROWS, Kd)
  const int t = blockIdx.x;
  const size_t pair = (size_t)blockIdx.y * n_tiles + t;
  float* gd_pair = gd + pair * ROWS * Kd;
  if (skip[pair] <= 0) {                         // uniform across the block
    zero_cols(gd_pair, Kd, 0, Kd);
    return;
  }
  const int count_s = min(counts_s[t], Ks);
  const int count_d = min(counts_d[pair], Kd);

  const float* dsrc = dpay + pair * ROWS * Kd;
  for (int i = p; i < ROWS * Kd; i += P) sd[i] = dsrc[i];
  if (!PARTIALS) zero_cols(gd_pair, Kd, 0, Kd);
  __syncthreads();

  const size_t row = (pair * P + p) * 8;
  BwdPixel st;
  init_bwd_pixel(st, (float)(p % ts) + 0.5f + (float)((t % tx) * ts),
                 (float)(p / ts) + 0.5f + (float)((t / tx) * ts), ct + row,
                 out + row, 1);
  pair_walk_grad<true, PARTIALS>(
      ss, sd, Kd, count_d, spay + (size_t)t * ROWS * Ks, Ks, count_s,
      power_min, has_pmin != 0, term_eps, has_term != 0, st, part_s, part_d,
      gs + (size_t)t * ROWS * Ks, gd_pair);
}

template <bool PARTIALS>
int launch(const void* spay, const void* dpay, const void* counts_s,
           const void* counts_d, const void* skip, const void* ct,
           const void* out, void* gs, void* gd, int B, int T, int Ks, int Kd,
           int ts, int tx, float power_min, int has_pmin, float term_eps,
           int has_term, cudaStream_t stream) {
  const int threads = ts * ts;
  const size_t smem = smem_bytes(Kd, threads / 32, PARTIALS);
  cudaError_t err = cudaFuncSetAttribute(
      composite_pair_bwd<PARTIALS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  composite_pair_bwd<PARTIALS><<<dim3(T, B), threads, smem, stream>>>(
      (const float*)spay, (const float*)dpay, (const int*)counts_s,
      (const int*)counts_d, (const int*)skip, (const float*)ct,
      (const float*)out, (float*)gs, (float*)gd, T, Ks, Kd, ts, tx,
      power_min, has_pmin, term_eps, has_term);
  return (int)cudaGetLastError();
}

}  // namespace

// The caller checks the layout (ts² % 32 == 0) and the shared memory of the
// layout without partials, and zeroes gs.
extern "C" int composite_pair_bwd_launch(
    const void* spay, const void* dpay, const void* counts_s,
    const void* counts_d, const void* skip, const void* ct, const void* out,
    void* gs, void* gd, int B, int T, int Ks, int Kd, int ts, int tx,
    float power_min, int has_pmin, float term_eps, int has_term,
    void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaGetLastError();
  auto go = smem_bytes(Kd, ts * ts / 32, true) <= SMEM_OPTIN ? launch<true>
                                                             : launch<false>;
  return go(spay, dpay, counts_s, counts_d, skip, ct, out, gs, gd, B, T, Ks,
            Kd, ts, tx, power_min, has_pmin, term_eps, has_term,
            (cudaStream_t)stream);
}
