// Shared device helpers of the compositing kernels (K1: composite.cu,
// composite_bwd.cu and K3: composite_single.cu, composite_single_bwd.cu,
// whose chunk walk is in composite_static_walk.cuh; K2: composite_sel.cu,
// composite_sel_bwd.cu and K4: composite_pair.cu, composite_pair_bwd.cu,
// whose walk is in composite_sel_walk.cuh; both walks stage entries with
// composite_sel_walk.cuh's stage_entry).
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
// operations the forward's walk uses for acc_c; at the end of the walk P_c
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
// channel prefixes exactly as the forward's walk advances T and acc (so
// the forward's early-stop decisions replay bit for bit).
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
