// Shared device helpers of the compositing kernels (K1 composite.cu,
// K2 composite_sel.cu).
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

// payload rows: x, y, conic a, conic b, conic c, r, g, b, depth, opacity
constexpr int ROW_X = 0, ROW_Y = 1, ROW_CA = 2, ROW_CB = 3, ROW_CC = 4;
constexpr int ROW_R = 5, ROW_DEPTH = 8, ROW_OP = 9, ROWS = 10;

__device__ __forceinline__ float entry_alpha(const float* s, int stride,
                                             int e, float px, float py,
                                             float power_min, bool has_pmin) {
  const float dx = __fsub_rn(px, s[ROW_X * stride + e]);
  const float dy = __fsub_rn(py, s[ROW_Y * stride + e]);
  const float quad =
      __fadd_rn(__fmul_rn(__fmul_rn(s[ROW_CA * stride + e], dx), dx),
                __fmul_rn(__fmul_rn(s[ROW_CC * stride + e], dy), dy));
  const float power = __fsub_rn(
      __fmul_rn(-0.5f, quad),
      __fmul_rn(__fmul_rn(s[ROW_CB * stride + e], dx), dy));
  const float alpha = fminf(
      __fmul_rn(s[ROW_OP * stride + e], expf(fminf(power, 0.0f))),
      ALPHA_CLAMP);
  const bool keep = alpha >= ALPHA_MIN && (!has_pmin || power >= power_min);
  return keep ? alpha : 0.0f;
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

}  // namespace splat
