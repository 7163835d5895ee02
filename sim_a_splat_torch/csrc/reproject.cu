// Kernel R1: the moving camera's candidate reprojection, every env's
// cached candidates in one launch.
//
// Replaces no Pallas kernel: the JAX package's `reproject_candidates`
// (sim_a_splat_tpu/ops/rasterize_moving.py) is plain jitted array code that
// XLA fuses.  The port's plain version (ops/rasterize_moving.py
// `_reproject_plain`) runs it as ~270 eager elementwise kernels over
// (B, T, Kc) candidates and a batched gemv for the SH contraction.  Here
// one thread reprojects one candidate: it reads the candidate's raw
// parameters once (mean 3, quaternion 4, log-scales 3, opacity 1, SH
// 16 × 3 at degree 3: 59 floats), keeps everything in registers, and
// writes its ten payload rows [u, v, conic a, b, c, r, g, b, z, op_eff]
// and its sort key once (11 floats).
//
// What bounds it on an H100: bytes.  280 B a candidate at degree 3 and
// ~250 flops: B = 8, T = 300, Kc = 512 is 344 MB, 0.103 ms at 3.35 TB/s,
// and 0.3 GFLOP, 0.005 ms at 67 TFLOP/s.  So the design is a stream: one
// thread a candidate with the Kc axis fastest, so that each of the 59
// field rows is read coalesced and each of the 11 output rows written
// coalesced; the grid is (ceil(Kc / THREADS), T, B), so a block never
// straddles an env or a tile: it reads its env's camera constants (w2c R,
// w2c t, w2c q, the pose's t, fx, fy, cx, cy, computed by the wrapper with
// the plain path's own torch calls) as broadcast loads and takes its
// tile's origin from blockIdx.y.  No shared memory.  The fields are read
// through their strides (the cache's fields are views of one gathered
// block, or whole tensors after a rebuild); only the Kc axis must be
// contiguous.
//
// Arithmetic is the plain path's on the card, op for op, in float32: this
// source is built with -fmad=false (no product and sum fused where the
// plain path rounds each), without fast math (IEEE division, sqrtf, expf,
// ceilf), each expression in the plain path's order, the clamps as
// PyTorch's (NaN passes through), and each Python scalar rounded to float32
// from its double as PyTorch rounds a scalar operand.  So every row but
// the three colours, and the key, are the plain path's bit for bit: the
// ceil'd radius and the tile test decide which candidates survive, and
// their count sets where K3f's 128-entry chunks start.  The colours sum
// the K coefficients in order k = 0 .. K-1, where the plain path's einsum
// goes through a gemv: they may differ by a few ulps.

#include <cuda_runtime.h>

// The candidate cache's fields and their strides in elements (the Kc axis
// is contiguous): mean, quat, log_scales (env, tile, field), opacity (env,
// tile), sh (env, tile, coefficient, channel).  Outside the anonymous
// namespace: the exported launch function takes it.
struct ReprojectInputs {
  const float* mean;
  const float* quat;
  const float* log_scales;
  const float* opacity;
  const float* sh;
  long long mean_s[3];
  long long quat_s[3];
  long long ls_s[3];
  long long op_s[2];
  long long sh_s[4];
};

namespace {

constexpr int THREADS = 128;
// an env's camera constants: w2c R row-major (9), w2c t (3), w2c q wxyz
// (4), the pose's t (3), fx, fy, cx, cy
constexpr int CAM = 23;
constexpr int ROWS = 10;

// the plain path's Python scalars, rounded to float32 from their doubles
constexpr float TINY = static_cast<float>(1e-12);
constexpr float LAM_MIN = static_cast<float>(0.01);
constexpr float SH_C0 = static_cast<float>(0.28209479177387814);
constexpr float SH_C1 = static_cast<float>(0.4886025119029199);
constexpr float SH_NC1 = static_cast<float>(-0.4886025119029199);
constexpr float SH_C2_0 = static_cast<float>(1.0925484305920792);
constexpr float SH_C2_1 = static_cast<float>(-1.0925484305920792);
constexpr float SH_C2_2 = static_cast<float>(0.31539156525252005);
constexpr float SH_C2_3 = static_cast<float>(-1.0925484305920792);
constexpr float SH_C2_4 = static_cast<float>(0.5462742152960396);
constexpr float SH_C3_0 = static_cast<float>(-0.5900435899266435);
constexpr float SH_C3_1 = static_cast<float>(2.890611442640554);
constexpr float SH_C3_2 = static_cast<float>(-0.4570457994644658);
constexpr float SH_C3_3 = static_cast<float>(0.3731763325901154);
constexpr float SH_C3_4 = static_cast<float>(-0.4570457994644658);
constexpr float SH_C3_5 = static_cast<float>(1.445305721320277);
constexpr float SH_C3_6 = static_cast<float>(-0.5900435899266435);

// torch.clamp(v, min=lo): NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

// The real-SH basis of degree DEG for a unit direction, as the plain path's
// `_sh_basis` stacks it.
template <int DEG>
__device__ __forceinline__ void sh_basis(float dx, float dy, float dz,
                                         float* b) {
  b[0] = SH_C0;
  if (DEG >= 1) {
    b[1] = SH_NC1 * dy;
    b[2] = SH_C1 * dz;
    b[3] = SH_NC1 * dx;
  }
  if (DEG >= 2) {
    const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
    const float xy = dx * dy, yz = dy * dz, xz = dx * dz;
    b[4] = SH_C2_0 * xy;
    b[5] = SH_C2_1 * yz;
    b[6] = SH_C2_2 * (2.0f * zz - xx - yy);
    b[7] = SH_C2_3 * xz;
    b[8] = SH_C2_4 * (xx - yy);
    if (DEG >= 3) {
      b[9] = SH_C3_0 * dy * (3.0f * xx - yy);
      b[10] = SH_C3_1 * xy * dz;
      b[11] = SH_C3_2 * dy * (4.0f * zz - xx - yy);
      b[12] = SH_C3_3 * dz * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      b[13] = SH_C3_4 * dx * (4.0f * zz - xx - yy);
      b[14] = SH_C3_5 * dz * (xx - yy);
      b[15] = SH_C3_6 * dx * (xx - 3.0f * yy);
    }
  }
}

template <int DEG>
__global__ void __launch_bounds__(THREADS)
reproject_candidates(ReprojectInputs in, const float* __restrict__ cams,
                     float* __restrict__ payload, float* __restrict__ keys,
                     int T, int Kc, int tx, int ts, float near, float eps2d) {
  constexpr int K = (DEG + 1) * (DEG + 1);
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= Kc) return;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const float* cam = cams + (long long)b * CAM;
  const float R00 = cam[0], R01 = cam[1], R02 = cam[2];
  const float R10 = cam[3], R11 = cam[4], R12 = cam[5];
  const float R20 = cam[6], R21 = cam[7], R22 = cam[8];
  const float tw0 = cam[9], tw1 = cam[10], tw2 = cam[11];
  const float pw = cam[12], px = cam[13], py = cam[14], pz = cam[15];
  const float pt0 = cam[16], pt1 = cam[17], pt2 = cam[18];
  const float fx = cam[19], fy = cam[20], cx = cam[21], cy = cam[22];

  const float* mp = in.mean + b * in.mean_s[0] + t * in.mean_s[1] + k;
  const float mx = mp[0], my = mp[in.mean_s[2]], mz = mp[2 * in.mean_s[2]];
  const float* qp = in.quat + b * in.quat_s[0] + t * in.quat_s[1] + k;
  const float rw = qp[0], rx = qp[in.quat_s[2]], ry = qp[2 * in.quat_s[2]],
              rz = qp[3 * in.quat_s[2]];
  const float* lp = in.log_scales + b * in.ls_s[0] + t * in.ls_s[1] + k;
  const float l0 = lp[0], l1 = lp[in.ls_s[2]], l2 = lp[2 * in.ls_s[2]];
  const float opacity = in.opacity[b * in.op_s[0] + t * in.op_s[1] + k];

  // camera frame and pixel position
  const float x = R00 * mx + R01 * my + R02 * mz + tw0;
  const float y = R10 * mx + R11 * my + R12 * mz + tw1;
  const float z = R20 * mx + R21 * my + R22 * mz + tw2;
  const float zc = clamp_min(z, near);
  const float u = fx * x / zc + cx;
  const float v = fy * y / zc + cy;

  // q_cam = w2c.q ⊗ q (Hamilton), normalized; M = R(q_cam)·S row by row
  float qw = pw * rw - px * rx - py * ry - pz * rz;
  float qx = pw * rx + px * rw + py * rz - pz * ry;
  float qy = pw * ry - px * rz + py * rw + pz * rx;
  float qz = pw * rz + px * ry - py * rx + pz * rw;
  const float qn = clamp_min(sqrtf(qw * qw + qx * qx + qy * qy + qz * qz),
                             TINY);
  qw = qw / qn;
  qx = qx / qn;
  qy = qy / qn;
  qz = qz / qn;
  const float s0 = expf(l0), s1 = expf(l1), s2 = expf(l2);
  const float m00 = (1.0f - 2.0f * (qy * qy + qz * qz)) * s0;
  const float m01 = (2.0f * (qx * qy - qw * qz)) * s1;
  const float m02 = (2.0f * (qx * qz + qw * qy)) * s2;
  const float m10 = (2.0f * (qx * qy + qw * qz)) * s0;
  const float m11 = (1.0f - 2.0f * (qx * qx + qz * qz)) * s1;
  const float m12 = (2.0f * (qy * qz - qw * qx)) * s2;
  const float m20 = (2.0f * (qx * qz - qw * qy)) * s0;
  const float m21 = (2.0f * (qy * qz + qw * qx)) * s1;
  const float m22 = (1.0f - 2.0f * (qx * qx + qy * qy)) * s2;

  // the Jacobian, the 2-D covariance, its conic and the ceil'd 3σ radius
  const float inv_z = 1.0f / zc;
  const float inv_z2 = inv_z * inv_z;
  const float j00 = fx * inv_z;
  const float j02 = -fx * x * inv_z2;
  const float j11 = fy * inv_z;
  const float j12 = -fy * y * inv_z2;
  const float a00 = j00 * m00 + j02 * m20;
  const float a01 = j00 * m01 + j02 * m21;
  const float a02 = j00 * m02 + j02 * m22;
  const float a10 = j11 * m10 + j12 * m20;
  const float a11 = j11 * m11 + j12 * m21;
  const float a12 = j11 * m12 + j12 * m22;
  const float a = a00 * a00 + a01 * a01 + a02 * a02 + eps2d;
  const float bb = a00 * a10 + a01 * a11 + a02 * a12;
  const float c = a10 * a10 + a11 * a11 + a12 * a12 + eps2d;
  const float det = a * c - bb * bb;
  const float det_safe = clamp_min(det, TINY);
  const float inv_det = 1.0f / det_safe;
  const float ca = c * inv_det, cb = -bb * inv_det, cc = a * inv_det;
  const float mid = 0.5f * (a + c);
  const float lam = mid + sqrtf(clamp_min(mid * mid - det_safe, LAM_MIN));
  const float radius = ceilf(3.0f * sqrtf(lam));

  // the exact SH colour for the current view direction
  const float dxw = mx - pt0, dyw = my - pt1, dzw = mz - pt2;
  const float dn = clamp_min(sqrtf(dxw * dxw + dyw * dyw + dzw * dzw), TINY);
  float basis[16];
  sh_basis<DEG>(dxw / dn, dyw / dn, dzw / dn, basis);
  const float* sp = in.sh + b * in.sh_s[0] + t * in.sh_s[1] + k;
  float col[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float* sc = sp + ch * in.sh_s[3];
    float acc = basis[0] * sc[0];
#pragma unroll
    for (int i = 1; i < K; ++i) acc = acc + basis[i] * sc[i * in.sh_s[2]];
    col[ch] = clamp_min(acc + 0.5f, 0.0f);
  }

  // the current footprint against its tile: a candidate whose 3σ box
  // misses the tile adds exactly 0 under sigma_cutoff <= 3
  const float ox = (float)((t % tx) * ts);
  const float oy = (float)((t / tx) * ts);
  const float tsf = (float)ts;
  const bool touches = (u + radius > ox) && (u - radius < ox + tsf) &&
                       (v + radius > oy) && (v - radius < oy + tsf);
  const float op_eff = (z > near && det > 0.0f && touches) ? opacity : 0.0f;

  const long long row = (long long)b * T + t;
  float* out = payload + row * ROWS * Kc + k;
  out[0] = u;
  out[Kc] = v;
  out[2 * Kc] = ca;
  out[3 * Kc] = cb;
  out[4 * Kc] = cc;
  out[5 * Kc] = col[0];
  out[6 * Kc] = col[1];
  out[7 * Kc] = col[2];
  out[8 * Kc] = z;
  out[9 * Kc] = op_eff;
  keys[row * Kc + k] = op_eff > 0.0f ? z : __int_as_float(0x7f800000);
}

}  // namespace

// One launch over B envs' (T, Kc) candidates of SH degree `degree` (0-3):
// payload (B, T, 10, Kc) and keys (B, T, Kc), contiguous; cams (B, 23).
// Returns the CUDA error code of the launch.
extern "C" int reproject_candidates_launch(ReprojectInputs in,
                                           const void* cams, void* payload,
                                           void* keys, int B, int T, int Kc,
                                           int tx, int ts, int degree,
                                           float near, float eps2d,
                                           void* stream) {
  if (B <= 0 || T <= 0 || Kc <= 0) return (int)cudaGetLastError();
  const dim3 grid((Kc + THREADS - 1) / THREADS, T, B);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* c = (const float*)cams;
  float* p = (float*)payload;
  float* kk = (float*)keys;
  switch (degree) {
    case 0:
      reproject_candidates<0><<<grid, THREADS, 0, s>>>(in, c, p, kk, T, Kc,
                                                       tx, ts, near, eps2d);
      break;
    case 1:
      reproject_candidates<1><<<grid, THREADS, 0, s>>>(in, c, p, kk, T, Kc,
                                                       tx, ts, near, eps2d);
      break;
    case 2:
      reproject_candidates<2><<<grid, THREADS, 0, s>>>(in, c, p, kk, T, Kc,
                                                       tx, ts, near, eps2d);
      break;
    case 3:
      reproject_candidates<3><<<grid, THREADS, 0, s>>>(in, c, p, kk, T, Kc,
                                                       tx, ts, near, eps2d);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
