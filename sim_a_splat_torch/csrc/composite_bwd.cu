// Kernel K1 backward: gsplat's gradient of the static background's per-tile
// front-to-back composite, for all 10 payload rows.
//
// Replaces the TPU kernel _bwd_kernel / _call_bwd of
// sim_a_splat_tpu/ops/pallas_composite.py (the backward of the custom VJP
// composite_pallas).
//
// Layout: payload (T, 10, K), counts (T,), skip (T,) as in K1f
// (composite.cu); ct (T, P, 8) the cotangent of out, out (T, P, 8),
// carries (T, P, nc) and chunk_acc (T, nc, 4, P) the forward's outputs and
// saved state.  Output grad (T, 10, K): every column written once, zero for
// entries the forward never applied (past counts, skipped tiles, chunks
// after the early stop).
//
// Design: one block per (tile, chunk), K1f's chunk blocks again
// (composite_static_walk.cuh).  A block finds whether the forward applied
// its chunk as the reference does, from carries: the chunk starts before
// the count and, past chunk 0, some pixel's carries[c] reaches term_eps.
// A chunk that was not applied zeroes its 128 columns.  An applied chunk
// restarts from the forward's carries[c] and chunk_acc[c] and walks the
// chunk with K1f's cull, keeping the chunk's local sums with the forward's
// own operations, so each entry's suffix sum is ct . (out - prefix) with
// the prefix rounded as the forward rounded out (no float32 cancellation;
// see the note of composite_static_walk.cuh).  Per entry the warp sums its
// pixels' 10 rows by K2b's transposed exchange (12 shuffles, not 50) into
// per-warp partials in shared memory, and after
// the walk the block adds the warps' partials in warp order and writes its
// columns: deterministic, no atomics.
//
// What bounds it on an H100: the per-pixel gradient of the kept pairs and
// its IEEE division by 1 - alpha, not bytes (it reads the ~10 MB payload,
// ~6 MB of cotangent and forward outputs and the 8 MB chunk_acc, and
// writes a ~10 MB gradient).  The first design walked each tile's chunks
// one after another in one block of 8 warps (256 blocks on 132 SMs) with a
// 50-shuffle reduction of every entry a warp saw; here the chunks run in
// parallel, the cull skips the entries a warp cannot touch, and the
// reduction takes 12 shuffles.

#include <cuda_runtime.h>

#include "composite_static_walk.cuh"

using namespace splat;

namespace {

__global__ void __launch_bounds__(stat::MAX_THREADS)
composite_static_bwd(const float* __restrict__ payload,
                     const int* __restrict__ counts,
                     const int* __restrict__ skip,
                     const float* __restrict__ ct,
                     const float* __restrict__ out,
                     const float* __restrict__ carries,
                     const float* __restrict__ chunk_acc,
                     float* __restrict__ grad, int K, int ts, int tx,
                     float power_min, int has_pmin, float term_eps,
                     int has_term) {
  extern __shared__ float4 smem[];
  const int warps = blockDim.x >> 5;
  const int t = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int P = ts * ts;
  const int c0 = c * CHUNK;
  const int count = skip[t] > 0 ? counts[t] : 0;
  const stat::Pixel pix(ts, tx, t);
  float* gt = grad + (size_t)t * ROWS * K;

  bool applied = c0 < count;                   // uniform across the block
  if (applied && has_term && c > 0)
    applied = __syncthreads_or(
                  pix.on &&
                  carries[((size_t)t * P + pix.p) * nc + c] >= term_eps) != 0;
  if (!applied) {
    zero_cols(gt, K, c0, c0 + CHUNK);
    return;
  }
  const int n = min(CHUNK, count - c0);
  const bool pm = has_pmin != 0;
  const sel::Smem s = sel::carve(smem, 0, warps);
  stat::stage_chunk(s, payload + (size_t)t * ROWS * K, K, c0, n, power_min,
                    pm);

  stat::BwdPixel st;
  {
    const int p = pix.on ? pix.p : 0;
    const float* ctp = ct + ((size_t)t * P + p) * 8;
    const float* op = out + ((size_t)t * P + p) * 8;
    const float* ca = chunk_acc + (size_t)(t * nc + c) * 4 * P + p;
    st.px = pix.px;
    st.py = pix.py;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      st.ct[j] = ctp[j];
      st.out[j] = op[j];
      st.acc0[j] = ca[j * P];
      st.L[j] = 0.0f;
    }
    st.trans_term = ctp[4] * op[4];
    st.tc = carries[((size_t)t * P + p) * nc + c];
    st.Tl = 1.0f;
  }
  __syncthreads();

  float* part = s.part + (threadIdx.x >> 5) * ROWS * CHUNK;
  auto visit = [&](int i) {
    const float4 g0 = s.g0[i];
    const float2 g1 = s.g1[i];
    float g[ROWS];
    bool hit = false;
    if (pix.on) {
      const Geom G = geom_at(g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, st.px,
                             st.py, power_min, pm);
      hit = G.alpha > 0.0f;
      if (hit) {
        const float4 c4 = s.col[i];
        const float col[4] = {c4.x, c4.y, c4.z, c4.w};
        stat::chunk_grad(G, g0.z, g0.w, g1.x, col, st, g);
      }
    }
    if (!hit) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) g[r] = 0.0f;
    }
    sel::warp_sum_store(g, hit, part + i, CHUNK);
  };
  stat::chunk_walk(s, n, pix.rect, visit);
  __syncthreads();

  // each column: the sum over the warps that visited the entry, in warp
  // order; zero past the count
  for (int e = threadIdx.x; e < CHUNK; e += blockDim.x) {
    const unsigned m = e < n ? stat::visitors(s, warps, e) : 0u;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float v = 0.0f;
      for (unsigned mm = m; mm; mm &= mm - 1u)
        v += s.part[((__ffs(mm) - 1) * ROWS + r) * CHUNK + e];
      gt[r * K + c0 + e] = v;
    }
  }
}

}  // namespace

// The caller checks the layout (ts <= 32, K % 128 == 0) and the shared
// memory (stat::smem_bytes).
extern "C" int composite_static_bwd_launch(
    const void* payload, const void* counts, const void* skip, const void* ct,
    const void* out, const void* carries, const void* chunk_acc, void* grad,
    int T, int K, int ts, int tx, float power_min, int has_pmin,
    float term_eps, int has_term, void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  const int threads = stat::block_threads(ts);
  const size_t smem = stat::smem_bytes(threads / 32, true);
  cudaError_t err = cudaFuncSetAttribute(
      composite_static_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  composite_static_bwd<<<dim3(T, K / CHUNK), threads, smem,
                         (cudaStream_t)stream>>>(
      (const float*)payload, (const int*)counts, (const int*)skip,
      (const float*)ct, (const float*)out, (const float*)carries,
      (const float*)chunk_acc, (float*)grad, K, ts, tx, power_min, has_pmin,
      term_eps, has_term);
  return (int)cudaGetLastError();
}
