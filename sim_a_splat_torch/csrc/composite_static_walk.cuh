// The chunk walk of kernels K1f (composite.cu) and K1b (composite_bwd.cu),
// and of K3f (composite_single.cu) and K3b (composite_single_bwd.cu): one
// 128-entry chunk of one tile's depth-sorted list, composited by one block
// from transmittance 1, with K2's warp-level footprint cull and entry-major
// staging (composite_sel_walk.cuh).
//
// Work split.  The reference composites a tile's chunks in order, but its
// algebra does not need the order: each chunk's transmittances are taken
// from 1 (_cumprod_lanes) and scaled by the chunk-start transmittance tc,
// w = alpha (cp / om) tc and tc' = tc cp[-1].  So one block per (tile,
// chunk) composites its chunk from T = 1 into local sums acc_l and a local
// transmittance T_l per pixel, and a short in-order combine per tile
// (composite.cu) applies the chunks while the tile is alive:
// acc <- fmaf(tc, acc_l, acc), tc <- tc T_l, and the reference's
// chunk-granular stop (no pixel at tc >= term_eps) after each applied chunk.
// Chunks past a tile's stop are composited too and thrown away.
//
// Pixel layout.  One pixel a thread; a warp owns an 8 × 4 rectangle of the
// tile (lane l at column l % 8, row l / 8).  The rectangles cover the tile
// rounded up to whole rectangles; pixels outside the tile (ts not a
// multiple of the rectangle) are computed by no one and written by no one.
// One pixel a thread was measured against two (8 × 8 rectangles, K2's
// layout) on the main path, on an H100 80GB HBM3 at 700 W: K1f 0.054 vs
// 0.060 ms, K1b 0.135-0.140 vs 0.161-0.164 ms (device time under the
// profiler; lever k1_py2 of an earlier chip_levers.py, which edited the
// walk's former pixels-per-thread constant).  A chunk block walks 128
// entries at most, so the smaller rectangle's finer cull and the doubled
// warps count for more than sharing an entry's loads between two pixels.
//
// K3f (composite_single.cu) applies the same combine in a block that walks
// one slot's chunks in order, and K3b restarts as K1b does.
//
// Cancellation rule of the backward.  K1b restarts chunk c from the
// forward's saved tc and acc at the chunk's start and keeps the chunk's
// local sums L with the very operations of the forward's walk
// (w_l = alpha T_l, L = fmaf(w_l, col, L), T_l = T_l (1 - alpha)); the
// prefix of the whole list through an entry is fmaf(tc, L, acc), the
// combine's own step.  At the end of the chunk that prefix equals the saved
// acc of chunk c + 1 bit for bit, and at the end of the last applied chunk
// it equals out, so the suffix ct . (out - prefix) does not cancel.
#pragma once

#include <cuda_runtime.h>

#include "composite_common.cuh"
#include "composite_sel_walk.cuh"

namespace splat {
namespace stat {

constexpr int RECT_X = sel::LANES_X;   // a warp's rectangle: 8 columns
constexpr int RECT_Y = sel::LANES_Y;   // and 4 rows
constexpr int MAX_THREADS = 32 * 32;   // ts <= 32

// Threads of a K1f chunk block or a K1b block at tile size ts.
__host__ __device__ inline int block_threads(int ts) {
  return ((ts + RECT_X - 1) / RECT_X) * ((ts + RECT_Y - 1) / RECT_Y) * 32;
}

// This thread's pixel and its warp's rectangle of pixel centres.
struct Pixel {
  int p;           // pixel index in the tile, row-major
  bool on;         // inside the tile
  float px, py;    // pixel centre
  float4 rect;     // rx0, rx1, ry0, ry1 of the warp's rectangle

  __device__ __forceinline__ Pixel(int ts, int tx, int tile) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wgx = (ts + RECT_X - 1) / RECT_X;
    const int wx = (warp % wgx) * RECT_X, wy = (warp / wgx) * RECT_Y;
    const int x = wx + lane % RECT_X, y = wy + lane / RECT_X;
    const float ox = (float)((tile % tx) * ts), oy = (float)((tile / tx) * ts);
    on = x < ts && y < ts;
    p = y * ts + x;
    px = (float)x + 0.5f + ox;
    py = (float)y + 0.5f + oy;
    rect = make_float4((float)wx + 0.5f + ox,
                       (float)(wx + RECT_X - 1) + 0.5f + ox,
                       (float)wy + 0.5f + oy,
                       (float)(wy + RECT_Y - 1) + 0.5f + oy);
  }
};

// Shared memory of a block: the chunk staged entry-major as K2 stages it
// (sel::Smem with an empty dynamic list) and, for K1b, each warp's
// per-entry partial sums.
__host__ __device__ inline size_t smem_bytes(int warps, bool bwd) {
  return sel::smem_bytes(0, warps, bwd);
}

// Stage entries [c0, c0 + n) of a (ROWS, K) tile list at columns [0, n),
// with their cull boxes.  All threads; no barrier.
__device__ __forceinline__ void stage_chunk(const sel::Smem& s,
                                            const float* tile, int K, int c0,
                                            int n, float power_min,
                                            bool has_pmin) {
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    sel::stage_entry(s, e, tile, K, c0 + e, power_min, has_pmin);
}

// visit(e) for every staged entry e < n that this warp does not cull, in
// order, warp-uniformly; the warp's ballots are kept in its hit words
// (s.shit, one per 32 entries).  The chunk must be staged.
template <class Visit>
__device__ __forceinline__ void chunk_walk(const sel::Smem& s, int n,
                                           float4 rect, Visit visit) {
  const int lane = threadIdx.x & 31;
  unsigned* hits = s.shit + (threadIdx.x >> 5) * (CHUNK / 32);
  for (int w = 0; w * 32 < n; ++w) {
    const int e = w * 32 + lane;
    unsigned bits = __ballot_sync(0xffffffffu,
                                  e < n && !sel::culled(s.box[e], rect));
    if (lane == 0) hits[w] = bits;
    while (bits) {
      visit((w << 5) + __ffs(bits) - 1);
      bits &= bits - 1u;
    }
  }
}

// Composite staged entries [0, n) at this thread's pixel from T = 1 into
// the chunk's local sums acc (r, g, b, depth) and local transmittance T,
// with the reference's front-to-back steps: w = alpha T, acc += w c,
// T *= 1 - alpha.  A pixel outside the tile composites nothing.
__device__ __forceinline__ void composite_chunk(const sel::Smem& s,
                                                const Pixel& pix, int n,
                                                float power_min, bool pm,
                                                float acc[4], float& T) {
  T = 1.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = 0.0f;
  auto visit = [&](int i) {
    const float4 g0 = s.g0[i];
    const float2 g1 = s.g1[i];
    const float a = pix.on ? geom_at(g0.x, g0.y, g0.z, g0.w, g1.x, g1.y,
                                     pix.px, pix.py, power_min, pm).alpha
                           : 0.0f;
    if (a > 0.0f) {
      const float4 col = s.col[i];
      const float w = a * T;
      acc[0] = fmaf(w, col.x, acc[0]);
      acc[1] = fmaf(w, col.y, acc[1]);
      acc[2] = fmaf(w, col.z, acc[2]);
      acc[3] = fmaf(w, col.w, acc[3]);
      T = T * (1.0f - a);
    }
  };
  chunk_walk(s, n, pix.rect, visit);
}

// The warps (a bit mask) that visited staged entry e < n, from their hit
// words.
__device__ __forceinline__ unsigned visitors(const sel::Smem& s, int warps,
                                             int e) {
  unsigned m = 0;
  for (int w = 0; w < warps; ++w)
    m |= ((s.shit[w * (CHUNK / 32) + (e >> 5)] >> (e & 31)) & 1u) << w;
  return m;
}

// store(r, e, v) for every row r and column e < CHUNK of the staged chunk:
// v the sum of the per-warp partials (s.part) of the warps that visited
// entry e < n, added in warp order (deterministic); 0 past n.  All threads,
// after a barrier that follows the walk.
template <class Store>
__device__ __forceinline__ void column_sums(const sel::Smem& s, int warps,
                                            int n, Store store) {
  for (int e = threadIdx.x; e < CHUNK; e += blockDim.x) {
    const unsigned m = e < n ? visitors(s, warps, e) : 0u;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float v = 0.0f;
      for (unsigned mm = m; mm; mm &= mm - 1u)
        v += s.part[((__ffs(mm) - 1) * ROWS + r) * CHUNK + e];
      store(r, e, v);
    }
  }
}

// Per-pixel state of K1b's walk of one chunk.
struct BwdPixel {
  float px, py;      // pixel centre
  float ct[4];       // cotangent of r, g, b, depth_acc
  float out[4];      // the forward's r, g, b, depth_acc
  float trans_term;  // ct_T * T_final
  float tc;          // the forward's transmittance at the chunk's start
  float acc0[4];     // the forward's accumulators at the chunk's start
  float Tl;          // transmittance in front of the next entry, from 1
  float L[4];        // the chunk's local sums of w_l c_j so far
};

// Gradient g[ROWS] at this pixel of an entry with geometry G (G.alpha > 0),
// conic (ca, cb, cc) and colour col = [r, g, b, depth]: pixel_grad of
// composite_common.cuh with the transmittance tc T_l and the prefix
// fmaf(tc, L, acc0) (see the note at the top); advances T_l and L as the
// forward's walk advanced its own.
__device__ __forceinline__ void chunk_grad(const Geom& G, float ca, float cb,
                                           float cc, const float col[4],
                                           BwdPixel& st, float g[ROWS]) {
  const float a = G.alpha;
  const float wl = a * st.Tl;          // the forward's local weight
  const float T = st.tc * st.Tl;       // transmittance in front of the entry
  const float w = st.tc * wl;
  float b = 0.0f, suffix = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float c = col[k];
    b = fmaf(st.ct[k], c, b);
    st.L[k] = fmaf(wl, c, st.L[k]);
    const float prefix = fmaf(st.tc, st.L[k], st.acc0[k]);
    suffix = fmaf(st.ct[k], st.out[k] - prefix, suffix);
    g[ROW_R + k] = st.ct[k] * w;
  }
  const float one_m = fmaxf(1.0f - a, 1.0f - ALPHA_CLAMP);
  const float dalpha = b * T - (suffix + st.trans_term) / one_m;
  const float dpower = G.active ? dalpha * a : 0.0f;
  g[ROW_X] = dpower * (ca * G.dx + cb * G.dy);
  g[ROW_Y] = dpower * (cc * G.dy + cb * G.dx);
  g[ROW_CA] = dpower * (-0.5f * G.dx * G.dx);
  g[ROW_CB] = dpower * (-G.dx * G.dy);
  g[ROW_CC] = dpower * (-0.5f * G.dy * G.dy);
  g[ROW_OP] = G.active ? dalpha * G.expp : 0.0f;
  st.Tl = st.Tl * (1.0f - a);
}

// The gradient walk of staged entries [0, n) from the restart state st
// (st.tc, st.acc0, st.L = 0, st.Tl = 1): each warp's per-entry sums of its
// pixels' 10 rows (K2b's 12-shuffle exchange, sel::warp_sum_store) into its
// partials s.part, for the entries it does not cull; column_sums adds them.
__device__ __forceinline__ void grad_chunk(const sel::Smem& s,
                                           const Pixel& pix, int n,
                                           float power_min, bool pm,
                                           BwdPixel& st) {
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
        chunk_grad(G, g0.z, g0.w, g1.x, col, st, g);
      }
    }
    if (!hit) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) g[r] = 0.0f;
    }
    sel::warp_sum_store(g, hit, part + i, CHUNK);
  };
  chunk_walk(s, n, pix.rect, visit);
}

}  // namespace stat
}  // namespace splat
