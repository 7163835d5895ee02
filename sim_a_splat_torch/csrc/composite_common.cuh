// Shared device helpers of the compositing kernels (K1: composite.cu,
// composite_bwd.cu; K2: composite_sel.cu, composite_sel_bwd.cu and K4:
// composite_pair.cu, composite_pair_bwd.cu, whose walk is in
// composite_sel_walk.cuh; K3: composite_single.cu, composite_single_bwd.cu).
//
// Alpha of one list entry at one pixel, term by term as the reference's
// _chunk_geometry (sim_a_splat_tpu/ops/pallas_composite.py:81-101) and the
// plain PyTorch versions compute it:
//   power = -0.5 * (a*dx*dx + c*dy*dy) - b*dx*dy
//   alpha = min(op * exp(min(power, 0)), ALPHA_CLAMP),
//   zeroed unless alpha >= ALPHA_MIN and power >= power_min.
// The geometry uses explicit round-to-nearest intrinsics so nvcc cannot
// contract it into FMAs: the ALPHA_MIN and sigma cut-offs are
// discontinuous, and a last-bit difference there would turn into a whole
// contribution of up to 1/255.  expf is the accurate libdevice expf (the
// build never passes --use_fast_math), the same one torch.exp uses.
#pragma once

#include <cuda_runtime.h>

namespace splat {

constexpr int CHUNK = 128;                           // list entries per chunk
constexpr float ALPHA_CLAMP = 0.9990000128746033f;   // float32(0.999)
constexpr float ALPHA_MIN = 0.003921568859368563f;   // float32(1 / 255)
// shared memory a block may opt into on Hopper (H100/H200: 227 KB)
constexpr size_t SMEM_OPTIN = 232448;

// payload rows: x, y, conic a, conic b, conic c, r, g, b, depth, opacity
constexpr int ROW_X = 0, ROW_Y = 1, ROW_CA = 2, ROW_CB = 3, ROW_CC = 4;
constexpr int ROW_R = 5, ROW_DEPTH = 8, ROW_OP = 9, ROWS = 10;

// Geometry of one list entry at one pixel: the alpha and what its gradient
// needs (the reference's _chunk_geometry returns the same tuple).
struct Geom {
  float alpha;   // zeroed unless kept (ALPHA_MIN, sigma cut-off)
  float expp;    // exp(min(power, 0))
  float dx, dy;  // pixel centre minus the gaussian's mean
  bool active;   // kept and not clamped: the clamp kills the gradient
};

// Geometry of an entry with centre (x, y), conic (ca, cb, cc) and opacity
// op at the pixel centre (px, py).
__device__ __forceinline__ Geom geom_at(float x, float y, float ca, float cb,
                                        float cc, float op, float px,
                                        float py, float power_min,
                                        bool has_pmin) {
  Geom g;
  g.dx = __fsub_rn(px, x);
  g.dy = __fsub_rn(py, y);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, g.dx), g.dx),
                               __fmul_rn(__fmul_rn(cc, g.dy), g.dy));
  const float power =
      __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(cb, g.dx), g.dy));
  g.expp = expf(fminf(power, 0.0f));
  const float raw = __fmul_rn(op, g.expp);
  const float alpha = fminf(raw, ALPHA_CLAMP);
  const bool keep = alpha >= ALPHA_MIN && (!has_pmin || power >= power_min);
  g.alpha = keep ? alpha : 0.0f;
  g.active = keep && raw < ALPHA_CLAMP;
  return g;
}

// geom_at of entry e of a (ROWS, stride) payload block.
__device__ __forceinline__ Geom entry_geom(const float* s, int stride, int e,
                                           float px, float py,
                                           float power_min, bool has_pmin) {
  return geom_at(s[ROW_X * stride + e], s[ROW_Y * stride + e],
                 s[ROW_CA * stride + e], s[ROW_CB * stride + e],
                 s[ROW_CC * stride + e], s[ROW_OP * stride + e], px, py,
                 power_min, has_pmin);
}

__device__ __forceinline__ float entry_alpha(const float* s, int stride,
                                             int e, float px, float py,
                                             float power_min, bool has_pmin) {
  return entry_geom(s, stride, e, px, py, power_min, has_pmin).alpha;
}

// Front-to-back step of one entry for this thread's pixel:
// w = alpha * T, acc += w * [r, g, b, depth], T *= 1 - alpha.
__device__ __forceinline__ void composite_entry(const float* s, int stride,
                                                int e, float px, float py,
                                                float power_min, bool has_pmin,
                                                float& T, float acc[4]) {
  const float a = entry_alpha(s, stride, e, px, py, power_min, has_pmin);
  if (a > 0.0f) {
    const float w = a * T;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc[k] = fmaf(w, s[(ROW_R + k) * stride + e], acc[k]);
    T = T * (1.0f - a);
  }
}

// Copy columns [c0, c0 + CHUNK) of a (ROWS, K) payload block into a
// (ROWS, CHUNK) shared buffer, all threads of the block cooperating.
__device__ __forceinline__ void stage_chunk(float* dst, const float* src,
                                            int K, int c0) {
  for (int i = threadIdx.x; i < ROWS * CHUNK; i += blockDim.x) {
    const int row = i / CHUNK, col = i - row * CHUNK;
    dst[i] = src[row * K + c0 + col];
  }
}

// Front-to-back walk of one depth-sorted list (ROWS, K) of `count` active
// entries for this thread's pixel, all threads of the block together: each
// chunk of CHUNK entries that starts before `count` is staged in the shared
// buffer s (ROWS * CHUNK floats) and composited into acc / T; with
// has_term, the walk stops after the first applied chunk that leaves no
// pixel of the block at T >= term_eps (the TPU kernels' chunk-granular
// stop).  carry, unless null, receives the transmittance at the start of
// every chunk.  Returns the number of chunks applied (the same in every
// thread).
__device__ __forceinline__ int composite_walk(float* s, const float* list,
                                              int K, int count, float px,
                                              float py, float power_min,
                                              bool has_pmin, float term_eps,
                                              bool has_term, float acc[4],
                                              float& T, float* carry) {
  const int nc = K / CHUNK;
  bool alive = true;
  int applied = 0;
  for (int c = 0; c < nc; ++c) {
    if (carry != nullptr) carry[c] = T;
    const int c0 = c * CHUNK;
    if (!alive || c0 >= count) continue;   // uniform across the block
    __syncthreads();                       // previous chunk fully read
    stage_chunk(s, list, K, c0);
    __syncthreads();
    const int n = min(CHUNK, count - c0);
    for (int e = 0; e < n; ++e)
      composite_entry(s, CHUNK, e, px, py, power_min, has_pmin, T, acc);
    ++applied;
    if (has_term) alive = __syncthreads_or(T >= term_eps) != 0;
  }
  return applied;
}

// ---- backward ---------------------------------------------------------------
//
// gsplat's gradient of one front-to-back composite, per pixel, entry by
// entry in the forward's order, the reference's _bwd_kernel
// (pallas_composite.py:161-235) term by term: with b_k = ct_rgbd . rgbd_k,
// w_k = alpha_k T_k and the suffix sum S_k = sum_{j>k} b_j w_j,
//   dalpha_k = b_k T_k - (S_k + ct_T T_final)
//                        / max(1 - alpha_k, 1 - ALPHA_CLAMP).
// The reference takes S_k = ct_rgbd . out_rgbd - sum_{j<=k} b_j w_j.  That
// difference cancels in float32 (and 1 / (1 - alpha) amplifies it up to
// 1000 times), unless both sides are rounded alike.  So the walk keeps one
// prefix per channel, P_c = sum_{j<=k} w_j c_j, accumulated with the very
// operations composite_entry uses for acc_c; at the end of the walk P_c
// equals the forward's out_c bit for bit, and
//   S_k = sum_c ct_c (out_c - P_c)
// is the same sum rounded consistently (the same value in exact
// arithmetic).

// Per-pixel state of the backward walk.
struct BwdPixel {
  float px, py;      // pixel centre
  float ct[4];       // cotangent of r, g, b, depth_acc
  float out[4];      // the forward's r, g, b, depth_acc
  float P[4];        // sum of w_j c_j over the entries walked so far
  float trans_term;  // ct_T * T_final
  float T;           // transmittance in front of the next entry
};

__device__ __forceinline__ void init_bwd_pixel(BwdPixel& st, float px,
                                               float py, const float* ct,
                                               const float* out, int step) {
  st.px = px;
  st.py = py;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    st.ct[k] = ct[k * step];
    st.out[k] = out[k * step];
    st.P[k] = 0.0f;
  }
  st.trans_term = ct[4 * step] * out[4 * step];
  st.T = 1.0f;
}

// Gradient g[ROWS] at this pixel of an entry with geometry G (G.alpha > 0),
// conic (ca, cb, cc) and colour col = [r, g, b, depth]; advances T and the
// channel prefixes exactly as composite_entry advances T and acc (so the
// forward's early-stop decisions replay bit for bit).
__device__ __forceinline__ void pixel_grad(const Geom& G, float ca, float cb,
                                           float cc, const float col[4],
                                           BwdPixel& st, float g[ROWS]) {
  const float a = G.alpha;
  const float w = a * st.T;
  float b = 0.0f, suffix = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float c = col[k];
    b = fmaf(st.ct[k], c, b);
    st.P[k] = fmaf(w, c, st.P[k]);
    suffix = fmaf(st.ct[k], st.out[k] - st.P[k], suffix);
    g[ROW_R + k] = st.ct[k] * w;
  }
  const float one_m = fmaxf(1.0f - a, 1.0f - ALPHA_CLAMP);
  const float dalpha = b * st.T - (suffix + st.trans_term) / one_m;
  const float dpower = G.active ? dalpha * a : 0.0f;
  g[ROW_X] = dpower * (ca * G.dx + cb * G.dy);
  g[ROW_Y] = dpower * (cc * G.dy + cb * G.dx);
  g[ROW_CA] = dpower * (-0.5f * G.dx * G.dx);
  g[ROW_CB] = dpower * (-G.dx * G.dy);
  g[ROW_CC] = dpower * (-0.5f * G.dy * G.dy);
  g[ROW_OP] = G.active ? dalpha * G.expp : 0.0f;
  st.T = st.T * (1.0f - a);
}

// Gradient g[ROWS] of entry e of a (ROWS, stride) block at this pixel
// (pixel_grad).  Returns alpha > 0: where it is 0 every component of g is 0
// and nothing advances.
__device__ __forceinline__ bool entry_grad(const float* s, int stride, int e,
                                           float power_min, bool has_pmin,
                                           BwdPixel& st, float g[ROWS]) {
  const Geom G = entry_geom(s, stride, e, st.px, st.py, power_min, has_pmin);
  if (!(G.alpha > 0.0f)) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) g[r] = 0.0f;
    return false;
  }
  float col[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) col[k] = s[(ROW_R + k) * stride + e];
  pixel_grad(G, s[ROW_CA * stride + e], s[ROW_CB * stride + e],
             s[ROW_CC * stride + e], col, st, g);
  return true;
}

// Sum g[ROWS] over the 32 lanes of the warp in a fixed order; lane 0 writes
// the sums to part[r * stride + col].  A warp where no lane has alpha > 0
// writes zeros without shuffling.  All 32 lanes must call it together.
__device__ __forceinline__ void warp_sum_rows(const float g[ROWS], bool any,
                                              float* part, int stride,
                                              int col) {
  const bool lane0 = (threadIdx.x & 31) == 0;
  if (!__any_sync(0xffffffffu, any)) {
    if (lane0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) part[r * stride + col] = 0.0f;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float v = g[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane0) part[r * stride + col] = v;
  }
}

// dst[r * dst_stride + col], col < n_cols: the sum over the block's warps
// of part[(warp * ROWS + r) * stride + col], added in warp order (the
// result does not depend on scheduling), for col < n_valid; 0 past it.
__device__ __forceinline__ void block_sum_rows(const float* part, int warps,
                                               int stride, int n_valid,
                                               int n_cols, float* dst,
                                               int dst_stride) {
  for (int i = threadIdx.x; i < ROWS * n_cols; i += blockDim.x) {
    const int r = i / n_cols, col = i - r * n_cols;
    float v = 0.0f;
    if (col < n_valid)
      for (int w = 0; w < warps; ++w) v += part[(w * ROWS + r) * stride + col];
    dst[r * dst_stride + col] = v;
  }
}

// Zero columns [lo, hi) of a (ROWS, stride) block of device memory.
__device__ __forceinline__ void zero_cols(float* dst, int stride, int lo,
                                          int hi) {
  const int n = hi - lo;
  for (int i = threadIdx.x; i < ROWS * n; i += blockDim.x) {
    const int r = i / n;
    dst[r * stride + lo + (i - r * n)] = 0.0f;
  }
}

}  // namespace splat
