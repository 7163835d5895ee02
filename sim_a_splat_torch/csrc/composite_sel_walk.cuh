// The selected-tile walk of kernels K2f (composite_sel.cu) and K2b
// (composite_sel_bwd.cu): one static tile list and one dynamic list
// composited in one depth order, with each warp skipping the entries whose
// footprint cannot reach any of its pixels.
//
// Pixel layout.  A block composites one (env, slot) tile of ts × ts pixels
// with ts² / 2 threads.  Each warp owns a compact 8 × 8 rectangle of the
// tile: lane l sits at column l % 8 and row l / 8 of an 8 × 4 grid and
// holds PY = 2 pixels, 4 rows apart.  A row of 8 lanes stores 8 consecutive
// pixels, so the (8, P) output rows are written in whole 32-byte sectors.
//
// Warp-level cull.  A pixel receives nothing from an entry unless
// alpha >= ALPHA_MIN and, with a sigma cut-off, power >= power_min, where
// power = -q / 2 and q = a dx² + 2b dx dy + c dy² (composite_common.cuh).
// Both cuts bound q: alpha <= op exp(power) needs q <= 2 ln(op / ALPHA_MIN),
// the sigma cut q <= -2 power_min.  The ellipse q <= qmax lies inside the box
// |dx| <= sqrt(qmax c / det), |dy| <= sqrt(qmax a / det), det = ac - b².
// cull_box computes that box once per staged entry (in double precision,
// rounded outward to float) with margins that cover every float32 rounding
// of the kernels' step-by-step power: relative error at most
// (12 kappa + 1) u of q, kappa the conic's condition number and u = 2^-24,
// widened here to 32 (kappa + 1) u, plus 1e-4 on the alpha cut for expf and
// the opacity product, and 2^-10 px.  A warp whose rectangle of pixel
// centres misses the box skips the entry: every one of its pixels would get
// alpha = 0, so skipping changes no output bit.  Entries whose conic is not
// positive definite or too ill-conditioned for the margin, or whose values
// are not finite, are never culled; the other entries with op < ALPHA_MIN
// always are (alpha <= op).  The plain twin of this test, in the same order,
// is composite_sel.cull_boxes / warp_rects / culled.
//
// Entry-major staging.  Each staged entry is three 16-byte and one 8-byte
// shared-memory words (x y a b | r g b depth | cull box | c op), so a warp
// reads an entry with 3-4 vector loads.  The dynamic list is staged once
// per block at columns [0, Kd) and each static chunk at [Kd, Kd + CHUNK).
// When a chunk is staged, the thread that stages static entry e also finds
// merge[e], the number of dynamic entries strictly in front of it (binary
// search over the sorted dynamic depths): the walk composites the dynamic
// entries [jd, merge[e]) before static entry e (static first on equal
// depth, the merge-path rule of merge_sorted_lists).
//
// Walk.  Each warp takes the ballot of its unculled static entries of a
// chunk (32 at a time) and its unculled dynamic entries (computed once per
// block), and visits the two hit lists in merged order, so it spends
// nothing on a culled entry.  After each applied chunk the dynamic entries
// in front of its last static entry are composited, then the block checks
// the early stop over the whole tile (__syncthreads_or), as the reference
// does once per 128-entry chunk; the dynamic entries left after the last
// applied chunk are always composited.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "composite_common.cuh"

namespace splat {
namespace sel {

constexpr int LANES_X = 8;   // a warp's lanes as an 8 × 4 grid of pixels
constexpr int LANES_Y = 4;
// Pixels per thread: 2 shares each entry's loads and the walk between two
// pixels and keeps a warp's rectangle 8 × 8, small enough for the cull.  It
// divides every accepted tile size (8, 16, 24, 32: ts % 8 == 0 and
// ts² / 2 <= MAX_THREADS).
constexpr int PY = 2;

constexpr int MAX_THREADS = 512;   // launch bounds: at most 128 registers

// Shared memory of one block, L = Kd + CHUNK staged columns (dynamic list
// first, then the current static chunk).
struct Smem {
  float4* g0;         // (L) x, y, conic a, conic b
  float4* col;        // (L) r, g, b, depth
  float4* box;        // (L) cull box: xlo, xhi, ylo, yhi
  float2* g1;         // (L) conic c, opacity
  int* merge;         // (CHUNK) dynamic entries in front of each static one
  unsigned* dhit;     // (warps, Kd / 32) each warp's unculled dynamic entries
  unsigned* shit;     // (warps, CHUNK / 32) each warp's unculled static ones
  float* part;        // (warps, ROWS, L or CHUNK) the backward's per-warp sums
  int L, dwords;
};

// With dyn_partials (the backward's layout wherever it fits) the warps'
// partial sums cover all L staged columns, else only the static chunk's.
__host__ __device__ inline size_t smem_bytes(int Kd, int warps, bool bwd,
                                             bool dyn_partials = true) {
  const size_t L = (size_t)Kd + CHUNK;
  return L * (3 * sizeof(float4) + sizeof(float2)) + CHUNK * sizeof(int) +
         (size_t)warps * (Kd / 32 + CHUNK / 32) * sizeof(unsigned) +
         (bwd ? (size_t)warps * ROWS * (dyn_partials ? L : CHUNK) *
                    sizeof(float)
              : 0);
}

__device__ __forceinline__ Smem carve(void* base, int Kd, int warps) {
  Smem s;
  s.L = Kd + CHUNK;
  s.dwords = Kd / 32;
  s.g0 = reinterpret_cast<float4*>(base);
  s.col = s.g0 + s.L;
  s.box = s.col + s.L;
  s.g1 = reinterpret_cast<float2*>(s.box + s.L);
  s.merge = reinterpret_cast<int*>(s.g1 + s.L);
  s.dhit = reinterpret_cast<unsigned*>(s.merge + CHUNK);
  s.shit = s.dhit + warps * s.dwords;
  s.part = reinterpret_cast<float*>(s.shit + warps * (CHUNK / 32));
  return s;
}

// This thread's PY pixels and its warp's rectangle of pixel centres.
struct Pixels {
  int p[PY];                 // pixel indices in the tile, row-major
  float px, py[PY];          // pixel centres (the lane's pixels share x)
  float4 rect;               // rx0, rx1, ry0, ry1 of the warp's pixels

  __device__ __forceinline__ Pixels(int ts, int tx, int tile) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wgx = ts / LANES_X;
    const int wx = (warp % wgx) * LANES_X, wy = (warp / wgx) * LANES_Y * PY;
    const int x = wx + (lane % LANES_X);
    const float ox = (float)((tile % tx) * ts), oy = (float)((tile / tx) * ts);
    px = (float)x + 0.5f + ox;
#pragma unroll
    for (int k = 0; k < PY; ++k) {
      const int y = wy + lane / LANES_X + LANES_Y * k;
      p[k] = y * ts + x;
      py[k] = (float)y + 0.5f + oy;
    }
    rect = make_float4((float)wx + 0.5f + ox,
                       (float)(wx + LANES_X - 1) + 0.5f + ox,
                       (float)wy + 0.5f + oy,
                       (float)(wy + LANES_Y * PY - 1) + 0.5f + oy);
  }
};

// The box outside which no pixel centre can receive alpha > 0 from the
// entry (see the note above); (-inf, inf, -inf, inf) never culls, an empty
// box (inf, -inf, inf, -inf) always does.
__device__ __forceinline__ float4 cull_box(float x, float y, float a, float b,
                                           float c, float op,
                                           float power_min, bool has_pmin) {
  const float4 keep_all = make_float4(-INFINITY, INFINITY, -INFINITY,
                                      INFINITY);
  if (!(isfinite(x) && isfinite(y) && isfinite(a) && isfinite(b) &&
        isfinite(c) && isfinite(op)))
    return keep_all;
  const double A = a, B = b, C = c;
  const double det = A * C - B * B;        // exact: 24-bit products
  if (!(A > 0.0) || !(det > 0.0)) return keep_all;
  const double h = 0.5 * (A + C);
  const double lmax = h + sqrt(0.25 * (A - C) * (A - C) + B * B);
  const double kappa = lmax * lmax / det;  // lmax / lmin, lmin = det / lmax
  const double eps = 32.0 * 0x1p-24 * (kappa + 1.0);
  if (!(eps < 0.5)) return keep_all;
  if (op < ALPHA_MIN) return make_float4(INFINITY, -INFINITY, INFINITY,
                                         -INFINITY);
  double q = 2.0 * (log((double)op / (double)ALPHA_MIN) + 1e-4);
  if (has_pmin) q = fmin(q, -2.0 * (double)power_min);
  q = fmax(q, 0.0) / (1.0 - eps);
  const double hx = sqrt(q * C / det) * (1.0 + 1e-6) + 0x1p-10;
  const double hy = sqrt(q * A / det) * (1.0 + 1e-6) + 0x1p-10;
  return make_float4(__double2float_rd((double)x - hx),
                     __double2float_ru((double)x + hx),
                     __double2float_rd((double)y - hy),
                     __double2float_ru((double)y + hy));
}

// True when the rectangle of pixel centres misses the box.
__device__ __forceinline__ bool culled(const float4 box, const float4 rect) {
  return box.y < rect.x || box.x > rect.y || box.w < rect.z ||
         box.z > rect.w;
}

// Stage payload column j of a (ROWS, K) list into staged column i.
__device__ __forceinline__ float stage_entry(const Smem& s, int i,
                                             const float* src, int K, int j,
                                             float power_min, bool has_pmin) {
  float v[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) v[r] = src[r * K + j];
  s.g0[i] = make_float4(v[ROW_X], v[ROW_Y], v[ROW_CA], v[ROW_CB]);
  s.col[i] = make_float4(v[ROW_R], v[ROW_R + 1], v[ROW_R + 2], v[ROW_DEPTH]);
  s.g1[i] = make_float2(v[ROW_CC], v[ROW_OP]);
  s.box[i] = cull_box(v[ROW_X], v[ROW_Y], v[ROW_CA], v[ROW_CB], v[ROW_CC],
                      v[ROW_OP], power_min, has_pmin);
  return v[ROW_DEPTH];
}

// Stage the block's dynamic list (ROWS, Kd) of count_d entries, then (after
// a barrier) every warp's ballot of its unculled entries.  All threads.
__device__ __forceinline__ void stage_dynamic(const Smem& s, const float* dyn,
                                              int Kd, int count_d,
                                              float4 rect, float power_min,
                                              bool has_pmin) {
  for (int j = threadIdx.x; j < count_d; j += blockDim.x)
    stage_entry(s, j, dyn, Kd, j, power_min, has_pmin);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  unsigned* mine = s.dhit + (threadIdx.x >> 5) * s.dwords;
  for (int w = 0; w * 32 < count_d; ++w) {
    const int j = w * 32 + lane;
    const unsigned bits =
        __ballot_sync(0xffffffffu, j < count_d && !culled(s.box[j], rect));
    if (lane == 0) mine[w] = bits;
  }
  __syncwarp();
}

// Stage static entries [c0, c0 + n) of a (ROWS, Ks) tile list at columns
// [Kd, Kd + n), with their merge positions.  All threads; no barrier.
__device__ __forceinline__ void stage_static(const Smem& s, const float* tile,
                                             int Ks, int c0, int n, int Kd,
                                             int count_d, float power_min,
                                             bool has_pmin) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float ds =
        stage_entry(s, Kd + e, tile, Ks, c0 + e, power_min, has_pmin);
    int lo = 0, hi = count_d;    // first dynamic entry not in front of ds
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s.col[mid].w < ds) lo = mid + 1; else hi = mid;
    }
    s.merge[e] = lo;
  }
}

// The merged walk of one (static, dynamic) pair of lists for this warp, all
// threads of the block together.  visit(i) composites (or differentiates)
// staged column i for the warp's pixels; it is called warp-uniformly, in
// the merged depth order, for every entry the warp does not cull.
// chunk_end(c0, n) runs after each applied static chunk (all threads), and
// alive() says whether one of the thread's pixels is still at
// T >= term_eps.  The dynamic list must be staged (stage_dynamic).
template <class Visit, class ChunkEnd, class Alive>
__device__ __forceinline__ void merged_walk(const Smem& s, const float* tile,
                                            int Ks, int count_s, int Kd,
                                            int count_d, float4 rect,
                                            float power_min, bool has_pmin,
                                            bool has_term, Visit visit,
                                            ChunkEnd chunk_end, Alive alive) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned* dhit = s.dhit + warp * s.dwords;
  unsigned* shit = s.shit + warp * (CHUNK / 32);
  int jd = 0;                                  // next dynamic entry
  auto dynamic_until = [&](int lim) {
    while (jd < lim) {
      const int w = jd >> 5;
      const int end = min(lim, (w + 1) << 5);
      unsigned bits = dhit[w] & (0xffffffffu << (jd & 31));
      if (end & 31) bits &= (1u << (end & 31)) - 1u;
      while (bits) {
        visit((w << 5) + __ffs(bits) - 1);
        bits &= bits - 1u;
      }
      jd = end;
    }
  };
  for (int c0 = 0; c0 < count_s; c0 += CHUNK) {
    const int n = min(CHUNK, count_s - c0);
    __syncthreads();                           // previous chunk fully read
    stage_static(s, tile, Ks, c0, n, Kd, count_d, power_min, has_pmin);
    __syncthreads();
    for (int w = 0; w * 32 < n; ++w) {
      const int e = w * 32 + lane;
      unsigned bits = __ballot_sync(
          0xffffffffu, e < n && !culled(s.box[Kd + e], rect));
      if (lane == 0) shit[w] = bits;
      while (bits) {
        const int e_hit = (w << 5) + __ffs(bits) - 1;
        bits &= bits - 1u;
        dynamic_until(s.merge[e_hit]);
        visit(Kd + e_hit);
      }
    }
    dynamic_until(s.merge[n - 1]);
    chunk_end(c0, n);
    if (has_term && !__syncthreads_or(alive())) break;
  }
  dynamic_until(count_d);
}

// Sum v[ROWS] over the 32 lanes of the warp by a transposed halving
// exchange (12 shuffles: each step sends half of the values a lane holds)
// in a fixed order, and store row r's sum at dst[r * stride].  A warp where
// no lane has any set stores zeros without shuffling.  With ADD the nonzero
// sums are added to dst atomically instead (nothing where none is set).
// All 32 lanes call it.
template <bool ADD = false>
__device__ __forceinline__ void warp_sum_store(const float v[ROWS], bool any,
                                               float* dst, int stride) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  if (!__any_sync(full, any)) {
    if (!ADD && lane < ROWS) dst[lane * stride] = 0.0f;
    return;
  }
  // lanes with bit 4 set keep rows 5-9, the others rows 0-4
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float a[6];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float keep = b4 ? v[i + 5] : v[i], send = b4 ? v[i] : v[i + 5];
    a[i] = keep + __shfl_xor_sync(full, send, 16);
  }
  a[5] = 0.0f;
  // of the 5 (padded to 6): bit 3 keeps [3, 6), else [0, 3)
  float c[4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float keep = b3 ? a[i + 3] : a[i], send = b3 ? a[i] : a[i + 3];
    c[i] = keep + __shfl_xor_sync(full, send, 8);
  }
  c[3] = 0.0f;
  // of the 3 (padded to 4): bit 2 keeps [2, 4), else [0, 2)
  float d[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = b2 ? c[i + 2] : c[i], send = b2 ? c[i] : c[i + 2];
    d[i] = keep + __shfl_xor_sync(full, send, 4);
  }
  // of the 2: bit 1 keeps d[1], else d[0]
  float z = (b1 ? d[1] : d[0]) + __shfl_xor_sync(full, b1 ? d[0] : d[1], 2);
  z += __shfl_xor_sync(full, z, 1);
  // lane bits (4, 3, 2, 1) hold row 5·b4 + 3·b3 + 2·b2 + b1 where that
  // index stays inside each step's real (unpadded) values
  const int in5 = 3 * b3 + 2 * b2 + b1, in3 = 2 * b2 + b1;
  if (!(lane & 1) && in3 < 3 && in5 < 5) {
    if (!ADD)
      dst[(5 * b4 + in5) * stride] = z;
    else if (z != 0.0f)
      atomicAdd(dst + (5 * b4 + in5) * stride, z);
  }
}

}  // namespace sel
}  // namespace splat
