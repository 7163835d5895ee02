// The merged walk of kernels K2f / K2b (composite_sel.cu,
// composite_sel_bwd.cu) and K4f / K4b (composite_pair.cu,
// composite_pair_bwd.cu): one static tile list and one dynamic list
// composited in one depth order, with each warp skipping the entries whose
// footprint cannot reach any of its pixels.  K2 runs it on each selected
// (env, slot), K4 on each touched (env, tile) pair; both call the block
// bodies at the end of this file.
//
// Pixel layout.  A block composites one ts × ts tile, 1 <= ts <= 32, with
// ceil(ts / 8)² warps.  Each warp owns a compact 8 × 8 rectangle of the
// tile: lane l sits at column l % 8 and row l / 8 of an 8 × 4 grid and holds
// PY = 2 pixels, 4 rows apart.  A row of 8 lanes stores 8 consecutive
// pixels, so the output rows are written in whole 32-byte sectors.  Where
// ts is not a multiple of 8 the rectangles cover the tile rounded up; the
// pixels past the tile are masked: they blend nothing (the forward starts
// them at T = 0), cast no stop vote, add no gradient and are never
// written, and the warp's cull rectangle is cut to the tile.
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
// Entry-major staging in windows.  Each staged entry is three 16-byte and
// one 8-byte shared-memory words (x y a b | r g b depth | cull box | c op),
// so a warp reads an entry with 3-4 vector loads.  The dynamic list is
// staged W entries at a time: window [w0, w0 + W) at columns [0, W), each
// warp's ballot of its unculled entries of the window beside it.  W is the
// largest multiple of 128 (at most the capacity Kd) whose block still fits
// in shared memory (window(); mirrored by composite_sel.window), so any
// capacity runs, and the main path's Kd = 128 is one window.  Each static
// chunk is staged at columns [W, W + 128); the thread that stages static
// entry e also finds merge[e], the number of dynamic entries strictly in
// front of it (binary search over the sorted dynamic depths, in shared
// memory when the list is one window, else in device memory): the walk
// composites the dynamic entries [jd, merge[e]) before static entry e
// (static first on equal depth, the merge-path rule of merge_sorted_lists).
//
// Walk.  Each warp takes the ballot of its unculled static entries of a
// chunk and of the window's dynamic entries, and visits the two hit lists
// in merged order, so it spends nothing on a culled entry.  A chunk whose
// static entries need dynamic entries past the window is walked in
// sub-runs: the static entries whose predecessors all lie in the window,
// then the rest of the window, a block barrier, the window retired (the
// backward stores its sums) and the next one staged.  After each applied
// chunk the dynamic entries in front of its last static entry are
// composited, then the block checks the early stop over the whole tile
// (__syncthreads_or), as the reference does once per 128-entry chunk, and
// never at a sub-run or window edge; the dynamic entries left after the
// last applied chunk are always composited, window by window.  Windows and
// sub-runs change the order of nothing: every warp visits the merged order.
// The plain twin of this schedule is composite_sel.walk_schedule.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "composite_common.cuh"

namespace splat {
namespace sel {

constexpr int LANES_X = 8;   // a warp's lanes as an 8 × 4 grid of pixels
constexpr int LANES_Y = 4;
// Pixels per thread: 2 shares each entry's loads and the walk between two
// pixels and keeps a warp's rectangle 8 × 8, small enough for the cull.
constexpr int PY = 2;
constexpr int RECT_X = LANES_X;          // a warp's rectangle: 8 columns
constexpr int RECT_Y = LANES_Y * PY;     // and 8 rows
constexpr int MAX_TS = 32;               // tiles of at most 1,024 pixels
constexpr int MAX_THREADS =
    ((MAX_TS + RECT_X - 1) / RECT_X) * ((MAX_TS + RECT_Y - 1) / RECT_Y) * 32;

// Threads of a block at tile size ts (1 <= ts <= MAX_TS).
__host__ __device__ inline int block_threads(int ts) {
  return ((ts + RECT_X - 1) / RECT_X) * ((ts + RECT_Y - 1) / RECT_Y) * 32;
}

// Shared memory of one block with a dynamic window of W entries: L = W +
// CHUNK staged columns (the window, then the current static chunk), the
// chunk's merge positions, each warp's hit words and, for the backward,
// each warp's per-entry partial sums (ROWS) of all L columns.
__host__ __device__ inline size_t smem_bytes(int W, int warps, bool bwd) {
  const size_t L = (size_t)W + CHUNK;
  return L * (3 * sizeof(float4) + sizeof(float2)) + CHUNK * sizeof(int) +
         (size_t)warps * (W / 32 + CHUNK / 32) * sizeof(unsigned) +
         (bwd ? (size_t)warps * ROWS * L * sizeof(float) : 0);
}

// The dynamic window at capacity Kd (Kd % CHUNK == 0): the largest multiple
// of CHUNK, at most Kd, whose block fits in SMEM_OPTIN (one CHUNK always
// does, at every tile size).
inline int window(int Kd, int warps, bool bwd) {
  int W = Kd;
  while (W > CHUNK && smem_bytes(W, warps, bwd) > SMEM_OPTIN) W -= CHUNK;
  return W;
}

// Threads, dynamic window and shared memory of a block at (Kd, ts), and
// whether the list takes more than one window (the kernels' WINDOWS).
struct Layout {
  int threads, W;
  size_t smem;
  bool windows;
  Layout(int Kd, int ts, bool bwd) : threads(block_threads(ts)) {
    W = window(Kd, threads / 32, bwd);
    smem = smem_bytes(W, threads / 32, bwd);
    windows = W < Kd;
  }
};

struct Smem {
  float4* g0;         // (L) x, y, conic a, conic b
  float4* col;        // (L) r, g, b, depth
  float4* box;        // (L) cull box: xlo, xhi, ylo, yhi
  float2* g1;         // (L) conic c, opacity
  int* merge;         // (CHUNK) dynamic entries in front of each static one
  unsigned* dhit;     // (warps, W / 32) each warp's unculled window entries
  unsigned* shit;     // (warps, CHUNK / 32) each warp's unculled static ones
  float* part;        // (warps, ROWS, L) the backward's per-warp sums
  int W, L, dwords;
};

__device__ __forceinline__ Smem carve(void* base, int W, int warps) {
  Smem s;
  s.W = W;
  s.L = W + CHUNK;
  s.dwords = W / 32;
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

// This thread's PY pixels and its warp's rectangle of pixel centres (cut to
// the tile).
struct Pixels {
  int p[PY];                 // pixel indices in the tile, row-major
  bool on[PY];               // inside the tile
  float px, py[PY];          // pixel centres (the lane's pixels share x)
  float4 rect;               // rx0, rx1, ry0, ry1 of the warp's pixels

  __device__ __forceinline__ Pixels(int ts, int tx, int tile) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wgx = (ts + RECT_X - 1) / RECT_X;
    const int wx = (warp % wgx) * RECT_X, wy = (warp / wgx) * RECT_Y;
    const int x = wx + (lane % LANES_X);
    const float ox = (float)((tile % tx) * ts), oy = (float)((tile / tx) * ts);
    px = (float)x + 0.5f + ox;
#pragma unroll
    for (int k = 0; k < PY; ++k) {
      const int y = wy + lane / LANES_X + LANES_Y * k;
      on[k] = x < ts && y < ts;
      p[k] = on[k] ? y * ts + x : 0;
      py[k] = (float)y + 0.5f + oy;
    }
    rect = make_float4((float)wx + 0.5f + ox,
                       (float)(min(wx + RECT_X, ts) - 1) + 0.5f + ox,
                       (float)wy + 0.5f + oy,
                       (float)(min(wy + RECT_Y, ts) - 1) + 0.5f + oy);
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

// Stage the window [w0, w0 + W) of the dynamic list (ROWS, Kd) of count_d
// entries at columns [0, W), then (after a barrier) every warp's ballot of
// its unculled entries of the window.  All threads.
__device__ __forceinline__ void stage_window(const Smem& s, const float* dyn,
                                             int Kd, int w0, int count_d,
                                             float4 rect, float power_min,
                                             bool has_pmin) {
  const int n = min(s.W, count_d - w0);
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    stage_entry(s, j, dyn, Kd, w0 + j, power_min, has_pmin);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  unsigned* mine = s.dhit + (threadIdx.x >> 5) * s.dwords;
  for (int w = 0; w * 32 < n; ++w) {
    const int j = w * 32 + lane;
    const unsigned bits =
        __ballot_sync(0xffffffffu, j < n && !culled(s.box[j], rect));
    if (lane == 0) mine[w] = bits;
  }
  __syncwarp();
}

// The first of the count sorted depths depth_at(0 .. count) that is not in
// front of ds.
template <class DepthAt>
__device__ __forceinline__ int dynamic_in_front(int count, float ds,
                                                DepthAt depth_at) {
  int lo = 0, hi = count;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (depth_at(mid) < ds) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Stage static entries [c0, c0 + n) of a (ROWS, Ks) tile list at columns
// [W, W + n), with their merge positions in the whole dynamic list.  All
// threads; no barrier.
template <bool WINDOWS>
__device__ __forceinline__ void stage_static(const Smem& s, const float* tile,
                                             int Ks, int c0, int n,
                                             const float* dyn, int Kd,
                                             int count_d, float power_min,
                                             bool has_pmin) {
  // the list is staged whole
  const bool one_window = !WINDOWS || count_d <= s.W;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float ds =
        stage_entry(s, s.W + e, tile, Ks, c0 + e, power_min, has_pmin);
    s.merge[e] =
        one_window
            ? dynamic_in_front(count_d, ds,
                               [&](int j) { return s.col[j].w; })
            : dynamic_in_front(count_d, ds, [&](int j) {
                return __ldg(dyn + ROW_DEPTH * Kd + j);
              });
  }
}

// Bits [lo, hi) of a 32-bit word, lo and hi clamped to [0, 32].
__device__ __forceinline__ unsigned bit_range(int lo, int hi) {
  auto below = [](int k) {
    return k >= 32 ? 0xffffffffu : k <= 0 ? 0u : (1u << k) - 1u;
  };
  return below(hi) & ~below(lo);
}

// The merged walk of one (static, dynamic) pair of lists for this warp, all
// threads of the block together.  visit(i) composites (or differentiates)
// staged column i for the warp's pixels (a window column i < W, or static
// column W + e); it is called warp-uniformly, in the merged depth order,
// for every entry the warp does not cull.  chunk_end(c0, n) runs after each
// applied static chunk (all threads), and alive() says whether one of the
// thread's pixels is still at T >= term_eps.  retire(w0) runs (all threads,
// after a barrier) when the walk leaves window w0 for the next, before the
// next is staged.  Returns the start of the last window, which the caller
// retires itself.  Without WINDOWS (the host's choice where the capacity is
// one window, W == Kd, as on the main path) the code that moves the window
// is compiled out: it would never run, and its registers cost occupancy
// (K2f on the main path: 92 registers and 5 blocks per SM with it, 64 and 8
// without; chip_levers.py, lever windows_always).
template <bool WINDOWS, class Visit, class ChunkEnd, class Alive,
          class Retire>
__device__ __forceinline__ int merged_walk(
    const Smem& s, const float* tile, int Ks, int count_s, const float* dyn,
    int Kd, int count_d, float4 rect, float power_min, bool has_pmin,
    bool has_term, Visit visit, ChunkEnd chunk_end, Alive alive,
    Retire retire) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = s.W;
  const unsigned* dhit = s.dhit + warp * s.dwords;
  unsigned* shit = s.shit + warp * (CHUNK / 32);
  int w0 = 0;                                  // the staged window's start
  int jd = 0;                                  // next dynamic entry
  stage_window(s, dyn, Kd, 0, count_d, rect, power_min, has_pmin);
  auto dynamic_until = [&](int lim) {          // lim <= w0 + W
    while (jd < lim) {
      const int w = (jd - w0) >> 5;            // w0 % 32 == 0
      const int end = min(lim, w0 + ((w + 1) << 5));
      unsigned bits = dhit[w] & (0xffffffffu << (jd & 31));
      if (end & 31) bits &= (1u << (end & 31)) - 1u;
      while (bits) {
        visit((w << 5) + __ffs(bits) - 1);
        bits &= bits - 1u;
      }
      jd = end;
    }
  };
  // finish the (full) window, retire it and stage the next; all threads
  auto slide = [&]() {
    dynamic_until(w0 + W);
    __syncthreads();                           // every warp done with it
    retire(w0);
    w0 += W;
    stage_window(s, dyn, Kd, w0, count_d, rect, power_min, has_pmin);
  };
  for (int c0 = 0; c0 < count_s; c0 += CHUNK) {
    const int n = min(CHUNK, count_s - c0);
    __syncthreads();                           // previous chunk fully read
    stage_static<WINDOWS>(s, tile, Ks, c0, n, dyn, Kd, count_d, power_min,
                          has_pmin);
    __syncthreads();
    for (int w = 0; w * 32 < n; ++w) {
      const int e = w * 32 + lane;
      const unsigned bits = __ballot_sync(
          0xffffffffu, e < n && !culled(s.box[W + e], rect));
      if (lane == 0) shit[w] = bits;
    }
    __syncwarp();
    // sub-runs [e0, e1): the static entries whose dynamic predecessors all
    // lie in the staged window (merge[] is nondecreasing)
    for (int e0 = 0;;) {
      int e1 = n;
      if (WINDOWS && s.merge[n - 1] > w0 + W) {
        int hi = n - 1;
        for (e1 = e0; e1 < hi;) {
          const int mid = (e1 + hi) >> 1;
          if (s.merge[mid] > w0 + W) hi = mid; else e1 = mid + 1;
        }
      }
      for (int w = e0 >> 5; (w << 5) < e1; ++w) {
        unsigned bits = shit[w] & bit_range(e0 - (w << 5), e1 - (w << 5));
        while (bits) {
          const int e_hit = (w << 5) + __ffs(bits) - 1;
          bits &= bits - 1u;
          dynamic_until(s.merge[e_hit]);
          visit(W + e_hit);
        }
      }
      if (!WINDOWS || e1 == n) break;
      slide();
      e0 = e1;
    }
    dynamic_until(s.merge[n - 1]);
    chunk_end(c0, n);
    if (has_term && !__syncthreads_or(alive())) break;
  }
  while (WINDOWS && count_d > w0 + W) slide();
  dynamic_until(count_d);
  return w0;
}

// Sum v[ROWS] over the 32 lanes of the warp by a transposed halving
// exchange (12 shuffles: each step sends half of the values a lane holds)
// in a fixed order, and store row r's sum at dst[r * stride].  A warp where
// no lane has any set stores zeros without shuffling.  All 32 lanes call
// it.
__device__ __forceinline__ void warp_sum_store(const float v[ROWS], bool any,
                                               float* dst, int stride) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  if (!__any_sync(full, any)) {
    if (lane < ROWS) dst[lane * stride] = 0.0f;
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
  if (!(lane & 1) && in3 < 3 && in5 < 5) dst[(5 * b4 + in5) * stride] = z;
}

// ---- the block bodies of K2 and K4 ------------------------------------------
//
// Output of pixel p, channel c: o[c * P + p] (K2, channel-major) or
// o[p * 8 + c] (K4, PIXEL_MAJOR).

// One block's composite of the static list tile (ROWS, Ks) of count_s
// entries and the dynamic list dyn (ROWS, Kd) of count_d entries into o
// [r, g, b, depth_acc, trans, 0, 0, 0] at the tile's pixels.
template <bool PIXEL_MAJOR, bool WINDOWS>
__device__ __forceinline__ void composite_block(
    const Smem& s, const Pixels& pix, const float* tile, int Ks, int count_s,
    const float* dyn, int Kd, int count_d, float power_min, bool pm,
    float term_eps, bool has_term, float* o, int P) {
  // A masked pixel starts at T = 0: each blend then adds w = alpha * 0
  // and leaves T at 0, so the walk needs no test for it (a test of every
  // alpha costs K2f time even where no pixel is masked: chip_levers.py,
  // lever mask_test); it casts no stop vote and is never written.
  float T[PY], acc[PY][4];
#pragma unroll
  for (int k = 0; k < PY; ++k) {
    T[k] = pix.on[k] ? 1.0f : 0.0f;
    acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.0f;
  }
  // composite_entry's steps for each of the thread's pixels
  auto visit = [&](int i) {
    const float4 g0 = s.g0[i];
    const float2 g1 = s.g1[i];
    float a[PY];
    bool any = false;
#pragma unroll
    for (int k = 0; k < PY; ++k) {
      a[k] = geom_at(g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, pix.px, pix.py[k],
                     power_min, pm).alpha;
      any |= a[k] > 0.0f;
    }
    if (!any) return;
    const float4 c = s.col[i];
#pragma unroll
    for (int k = 0; k < PY; ++k) {
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
    for (int k = 0; k < PY; ++k) on |= pix.on[k] && T[k] >= term_eps;
    return on;
  };
  merged_walk<WINDOWS>(s, tile, Ks, count_s, dyn, Kd, count_d, pix.rect,
                       power_min, pm, has_term, visit, [](int, int) {},
                       alive, [](int) {});
#pragma unroll
  for (int k = 0; k < PY; ++k) {
    if (!pix.on[k]) continue;
    if (PIXEL_MAJOR) {
      float4* q = reinterpret_cast<float4*>(o + (size_t)pix.p[k] * 8);
      q[0] = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
      q[1] = make_float4(T[k], 0.0f, 0.0f, 0.0f);
    } else {
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
}

// Gradient of composite_block for the cotangent ct of its output o, given
// o itself (both laid out as o): the forward's walk replayed, T advanced by
// the very float operations the forward used (pixel_grad), so every stop
// decision and every cull is the forward's.  Along the walk each pixel
// keeps per-channel prefix sums over the merged order, so an entry's
// suffix is ct . (out - prefix), rounded as the forward rounded out.  Per
// entry a thread first sums its pixels in registers; the warp then sums its
// 10 rows (warp_sum_store) into per-warp partials in shared memory, and the
// block adds the warps' partials in warp order (deterministic): after each
// applied chunk the static sums go to gtile (ROWS, Ks) with atomicAdd (the
// caller zeroes it; nothing when gtile is null), and when a window retires
// its sums are stored once into gdyn (ROWS, Kd), every column of which is
// written once (zero past count_d).
template <bool PIXEL_MAJOR, bool WINDOWS>
__device__ __forceinline__ void grad_block(
    const Smem& s, const Pixels& pix, const float* tile, int Ks, int count_s,
    const float* dyn, int Kd, int count_d, float power_min, bool pm,
    float term_eps, bool has_term, const float* ct, const float* out, int P,
    float* gtile, float* gdyn) {
  const int warps = blockDim.x >> 5;
  BwdPixel st[PY];
#pragma unroll
  for (int k = 0; k < PY; ++k) {
    const size_t row = PIXEL_MAJOR ? (size_t)pix.p[k] * 8 : pix.p[k];
    init_bwd_pixel(st[k], pix.px, pix.py[k], ct + row, out + row,
                   PIXEL_MAJOR ? 1 : P);
  }
  float* part = s.part + (threadIdx.x >> 5) * ROWS * s.L;
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
    for (int k = 0; k < PY; ++k) {
      const Geom G = geom_at(g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, st[k].px,
                             st[k].py, power_min, pm);
      if (pix.on[k] && G.alpha > 0.0f) {
        float g[ROWS];
        pixel_grad(G, g0.z, g0.w, g1.x, col, st[k], g);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) sum[r] += g[r];
        any = true;
      }
    }
    warp_sum_store(sum, any, part + i, s.L);
  };
  // the warps (a bit mask) that visited staged column e of a hit list
  // (the window's, or the current static chunk's)
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
      v += s.part[((__ffs(m) - 1) * ROWS + r) * s.L + i];
    return v;
  };
  // after each applied chunk: each entry's sums go to the tile's row, one
  // entry per thread
  auto chunk_end = [&](int c0, int n) {
    __syncthreads();
    for (int e = threadIdx.x; e < n && gtile != nullptr; e += blockDim.x) {
      const unsigned m = visitors(s.shit, CHUNK / 32, e);
      if (!m) continue;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float v = warp_total(m, r, s.W + e);
        if (v != 0.0f) atomicAdd(gtile + r * Ks + c0 + e, v);
      }
    }
  };
  // a window's sums, each of its columns of gdyn written once
  auto retire = [&](int w0) {
    const int n = min(s.W, Kd - w0);
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const unsigned m = w0 + j < count_d ? visitors(s.dhit, s.dwords, j)
                                          : 0u;
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        gdyn[r * Kd + w0 + j] = warp_total(m, r, j);
    }
  };
  auto alive = [&]() {
    bool on = false;
#pragma unroll
    for (int k = 0; k < PY; ++k) on |= pix.on[k] && st[k].T >= term_eps;
    return on;
  };
  const int w0 = merged_walk<WINDOWS>(s, tile, Ks, count_s, dyn, Kd,
                                      count_d, pix.rect, power_min, pm,
                                      has_term, visit, chunk_end, alive,
                                      retire);
  __syncthreads();
  retire(w0);
  zero_cols(gdyn, Kd, min(w0 + s.W, Kd), Kd);
}

}  // namespace sel
}  // namespace splat
