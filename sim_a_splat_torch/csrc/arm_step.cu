// Kernel P2: the arm's control step, every env in one launch.
//
// Replaces no Pallas kernel: the JAX package's `ManipulatorEnvF.step`
// (sim_a_splat_tpu/envs/manipulator_envs.py) is jitted and XLA fuses it;
// the port's plain version (envs/manipulator_envs.py `step_plain`: the PD
// loop and the FK of physics/kinematics.py, four contact substeps of
// planar.py `solve_contacts`, `_get_info`'s two `torch.func.jvp`s of the
// FK) runs it as ~11,000 eager elementwise kernels a step, each a handful
// of flops for B envs.  Here one thread steps one env: it reads its env's
// state and action once, keeps everything in registers, and writes every
// output once.  In the plain path's order: the end effector's xy from the
// FK of the old joints; the PD loop (`pd_substeps` semi-implicit substeps
// with the velocity and position clips); the clock; the end effector's FK
// at the new joints, carried with its tangent along the new joint
// velocities; with the T-block, `contact_substeps` substeps of the swept
// end effector against the T's two boxes (the contacts of planar.py
// `circle_poly_contact`, the split-impulse PGS, the integration about the
// CoG); the reward and `terminated`; and `_get_info`, whose two J·q̇ are
// the tangents of the end effector's position and of its orientation
// error, carried through the same operations with the derivative rules of
// the plain path's ops.  No Jacobian is formed.
//
// The chain is data: `ArmConstants` holds it link by link (parent, joint
// type, actuated index, origin, axis, clipped limits) with the end
// effector's index and the weld, and the FK walks the end effector's
// ancestors in link order, so every URDF within ARM_MAX_LINKS links and
// ARM_MAX_DOF joints takes the same code.
//
// Arithmetic is the plain path's on the card, op for op, in float32: this
// source is built with -fmad=false (no product and sum fused where the
// plain path rounds each), without fast math (IEEE division, sqrtf, sinf,
// cosf, atan2f), the clamps as PyTorch's (NaN passes through), argmax and
// argmin taking the first index on ties, a tensor divided by a Python
// scalar as PyTorch's CUDA kernel does it (times the float32 reciprocal),
// and each `torch.sum` over a last axis of 3 or 4 in the order PyTorch's
// CUDA reduction adds (`sum3`, `sum4`).  Every slot runs every sweep,
// inactive ones with inv_k 0: nothing is skipped, so the new state is the
// plain path's on the card, bit for bit.
//
// What bounds it on an H100: one env's dependent chain, not bytes (~200 B
// an env) nor flops: 4 substeps × 10 sweeps × 2 slots × ~28 dependent
// float ops, the contacts, and two FKs (one with tangents, so counted
// twice), some 3,600 ops of >= 4 cycles, 7 µs at 1,980 MHz; ~50 µs
// measured at B = 1 to 256 (each IEEE division and square root in the
// chain is a check and a branch besides).  One thread an env in blocks of
// 32 (grid ceil(B / 32): B = 1 and B = 8 take the same launch); within a
// slot the velocity chain and the bias chain are independent, two-way ILP.

#include <cuda_runtime.h>

constexpr int ARM_MAX_LINKS = 8;
constexpr int ARM_MAX_DOF = 6;

// The chain's and the task's constants, each rounded to float32 on the
// host from the Python scalar the plain path uses
// (envs/manipulator_envs.py `ArmKernelConstants`).  Outside the anonymous
// namespace: the exported launch function takes it.
struct ArmConstants {
  int parent[ARM_MAX_LINKS];     // links in topological order, root 0
  int jtype[ARM_MAX_LINKS];      // 0 fixed, 1 revolute, 2 prismatic
  int qidx[ARM_MAX_LINKS];       // actuated joint index, or -1
  float origin_q[ARM_MAX_LINKS][4];
  float origin_t[ARM_MAX_LINKS][3];
  float axis[ARM_MAX_LINKS][3];
  float lo[ARM_MAX_DOF], hi[ARM_MAX_DOF], vmax[ARM_MAX_DOF];
  float weld_q[4], weld_t[3];
  int num_links, ndof, eef;
  // the PD loop: kp, kd, the substep, the card's 1 / dt, dt
  float kp, kd, pd_h, inv_dt, dt;
  int pd_substeps;
  // the T-block and its contacts
  float polys[2][4][2];          // local CCW vertices of the T's two boxes
  float cog[2];                  // body-local centre of gravity
  float radius, mu, inv_mass, inv_inertia;
  float bias_rate;               // the contact bias over the substep
  float slop, contact_h, done_below;
  int contact_substeps, iterations, env_objects;
};

// The launch's tensors: inputs read through their row strides (an expanded
// action's 0, a column slice's row length), outputs contiguous.
enum { IN_Q, IN_QD, IN_TARGET_PREV, IN_BLOCK_POS, IN_BLOCK_YAW, IN_BLOCK_VEL,
       IN_BLOCK_OMEGA, IN_GOAL, IN_T, IN_ACTION, N_IN };
enum { OUT_Q, OUT_QD, OUT_BLOCK_POS, OUT_BLOCK_YAW, OUT_BLOCK_VEL,
       OUT_BLOCK_OMEGA, OUT_PREV_EEF_XY, OUT_T, OUT_REWARD, OUT_EEF_POS,
       OUT_EEF_QUAT, OUT_EEF_POS_VEL, OUT_EEF_ROT_VEL, OUT_BLOCK_POSE,
       OUT_INFO_BLOCK_VEL, N_OUT_F32 };
enum { OUT_TERMINATED = N_OUT_F32, OUT_TRUNCATED, N_OUT };

namespace {

constexpr int THREADS = 32;
constexpr int JOINT_REVOLUTE = 1;
constexpr int JOINT_PRISMATIC = 2;

struct ArmIO {
  const float* in[N_IN];
  long long stride[N_IN];
  float* out[N_OUT_F32];
  bool* flag[N_OUT - N_OUT_F32];
};

// torch.clamp(x, min=lo), torch.clamp(x, lo, hi), torch.maximum and
// torch.minimum on the card: NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);
}
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fminf(a, b);
}

// A value and its tangent along the joint velocities: forward-mode
// derivatives with the rules of the plain path's ops.  Its value is
// computed by the same float operations as a float's, so an FK of Duals
// gives the float FK's values bit for bit.
struct Dual {
  float v, d;
  __device__ Dual(float value = 0.f, float tangent = 0.f)
      : v(value), d(tangent) {}
};
__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
  return Dual(a.v + b.v, a.d + b.d);
}
__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
  return Dual(a.v - b.v, a.d - b.d);
}
__device__ __forceinline__ Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, a.d * b.v + a.v * b.d);
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float r = a.v / b.v;
  return Dual(r, (a.d - r * b.d) / b.v);
}
__device__ __forceinline__ float sqrt_(float a) { return sqrtf(a); }
__device__ __forceinline__ Dual sqrt_(Dual a) {
  const float s = sqrtf(a.v);
  return Dual(s, a.d / (2.f * s));
}
__device__ __forceinline__ float cos_(float a) { return cosf(a); }
__device__ __forceinline__ Dual cos_(Dual a) {
  return Dual(cosf(a.v), -sinf(a.v) * a.d);
}
__device__ __forceinline__ float sin_(float a) { return sinf(a); }
__device__ __forceinline__ Dual sin_(Dual a) {
  return Dual(sinf(a.v), cosf(a.v) * a.d);
}
__device__ __forceinline__ float clamp_min_(float a, float lo) {
  return clamp_min(a, lo);
}
__device__ __forceinline__ Dual clamp_min_(Dual a, float lo) {
  return Dual(clamp_min(a.v, lo), a.v >= lo ? a.d : 0.f);
}

// torch.sum over a last axis of 4 (3) on the card: the reduction's two
// lanes take elements 0 and 2, and 1 and 3 (1), each adds its own, and a
// warp shuffle adds the lanes
template <typename T>
__device__ __forceinline__ T sum4(T a, T b, T c, T d) {
  return (a + c) + (b + d);
}
template <typename T>
__device__ __forceinline__ T sum3(T a, T b, T c) {
  return (a + c) + b;
}

// ops/quaternion.py, wxyz, in its grouping
template <typename T>
__device__ __forceinline__ void qmul(const T a[4], const T b[4], T o[4]) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

template <typename T>
__device__ __forceinline__ void normalize(const T q[4], T o[4]) {
  const T n = clamp_min_(
      sqrt_(sum4(q[0] * q[0], q[1] * q[1], q[2] * q[2], q[3] * q[3])),
      1e-12f);
  for (int k = 0; k < 4; ++k) o[k] = q[k] / n;
}

template <typename T>
__device__ __forceinline__ void cross(const T a[3], const T b[3], T o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// quat.rotate: v + w·t + u × t with t = 2 (u × v), q normalised
template <typename T>
__device__ __forceinline__ void rotate(const T q[4], const T v[3], T o[3]) {
  T n[4], t[3], ut[3];
  normalize(q, n);
  const T u[3] = {n[1], n[2], n[3]};
  cross(u, v, t);
  for (int k = 0; k < 3; ++k) t[k] = T(2.f) * t[k];
  cross(u, t, ut);
  for (int k = 0; k < 3; ++k) o[k] = v[k] + n[0] * t[k] + ut[k];
}

// kinematics.fk down to the end effector: the weld, then each of its
// ancestors (`path`, a bit a link) in link order, whose parent is the
// ancestor before it.  `x` the joints (with tangents for T = Dual).
template <typename T>
__device__ void fk_eef(const ArmConstants& c, unsigned path, const T x[],
                       T pq[4], T pt[3]) {
  for (int k = 0; k < 4; ++k) pq[k] = T(c.weld_q[k]);
  for (int k = 0; k < 3; ++k) pt[k] = T(c.weld_t[k]);
#pragma unroll
  for (int i = 1; i < ARM_MAX_LINKS; ++i) {
    if (!((path >> i) & 1u)) continue;
    T oq[4], lq[4], lt[3];
    for (int k = 0; k < 4; ++k) oq[k] = T(c.origin_q[i][k]);
    for (int k = 0; k < 3; ++k) lt[k] = T(c.origin_t[i][k]);
    T qv = T(0.f);             // the joint's value, selected (no local array)
#pragma unroll
    for (int d = 0; d < ARM_MAX_DOF; ++d)
      if (d == c.qidx[i]) qv = x[d];
    const T ax[3] = {T(c.axis[i][0]), T(c.axis[i][1]), T(c.axis[i][2])};
    if (c.jtype[i] == JOINT_REVOLUTE) {
      const T h = T(0.5f) * qv;
      const T s = sin_(h);
      const T jq[4] = {cos_(h), ax[0] * s, ax[1] * s, ax[2] * s};
      qmul(oq, jq, lq);
    } else {
      for (int k = 0; k < 4; ++k) lq[k] = oq[k];
      if (c.jtype[i] == JOINT_PRISMATIC) {
        const T v[3] = {ax[0] * qv, ax[1] * qv, ax[2] * qv};
        T r[3];
        rotate(oq, v, r);
        for (int k = 0; k < 3; ++k) lt[k] = lt[k] + r[k];
      }
    }
    T nq[4], r[3];
    qmul(pq, lq, nq);
    rotate(pq, lt, r);
    for (int k = 0; k < 3; ++k) pt[k] = r[k] + pt[k];
    for (int k = 0; k < 4; ++k) pq[k] = nq[k];
  }
}

struct Slot {
  float px, py;     // world contact point
  float nx, ny;     // impulse direction on the block
  float depth;
  bool active;
};

// planar.py `circle_poly_contact` of the circle (cx, cy, radius) against
// the world quad v, then the normal negated (the impulse on the block)
__device__ __forceinline__ Slot circle_quad(float cx, float cy, float radius,
                                            const float v[4][2]) {
  float dmax = 0.f, fnx = 0.f, fny = 0.f;       // deepest face
  float dmin = 0.f, ex_ = 0.f, ey_ = 0.f;       // nearest edge point
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int k1 = (k + 1) & 3;
    const float ex = v[k1][0] - v[k][0], ey = v[k1][1] - v[k][1];
    float nx = ey, ny = -ex;                    // -perp(edge)
    const float nn = clamp_min(sqrtf(nx * nx + ny * ny), 1e-9f);
    nx = nx / nn;
    ny = ny / nn;
    const float rx = cx - v[k][0], ry = cy - v[k][1];
    const float d = nx * rx + ny * ry;
    const float t = clamp((rx * ex + ry * ey) / clamp_min(ex * ex + ey * ey,
                                                          1e-9f),
                          0.f, 1.f);
    const float qx = cx - (v[k][0] + t * ex), qy = cy - (v[k][1] + t * ey);
    const float dist = sqrtf(qx * qx + qy * qy);
    if (k == 0 || d > dmax) {        // first index on ties
      dmax = d;
      fnx = nx;
      fny = ny;
    }
    if (k == 0 || dist < dmin) {
      dmin = dist;
      ex_ = qx;
      ey_ = qy;
    }
  }
  const bool inside = dmax < 0.f;
  const float den = clamp_min(dmin, 1e-9f);
  const float onx = ex_ / den, ony = ey_ / den;
  const float nx = inside ? fnx : onx, ny = inside ? fny : ony;
  const float depth = inside ? radius - dmax : radius - dmin;
  const float h = radius - depth * 0.5f;
  Slot s;
  s.px = cx - nx * h;
  s.py = cy - ny * h;
  s.nx = -nx;
  s.ny = -ny;
  s.depth = depth;
  s.active = depth > 0.f;
  return s;
}

// `_block_substep`: the end effector at (ex, ey) moving at (evx, evy)
// against the block at rest, solved and integrated over `contact_h`; cs and
// sn are cos and sin of the yaw, and are left those of the new yaw.
__device__ __forceinline__ void block_substep(
    const ArmConstants& c, float ex, float ey, float evx, float evy,
    float& bx, float& by, float& yaw, float& cs, float& sn, float& vx,
    float& vy, float& w) {
  const float ns = -sn;
  float v[2][4][2];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float lx = c.polys[b][k][0], ly = c.polys[b][k][1];
      v[b][k][0] = bx + (cs * lx + ns * ly);
      v[b][k][1] = by + (sn * lx + cs * ly);
    }
  const float gx = bx + (cs * c.cog[0] + ns * c.cog[1]);
  const float gy = by + (sn * c.cog[0] + cs * c.cog[1]);
  Slot s[2];
  s[0] = circle_quad(ex, ey, c.radius, v[0]);
  s[1] = circle_quad(ex, ey, c.radius, v[1]);

  // planar.py `solve_contacts` on the block at rest
  float prx[2], pry[2], rxn[2], rxt[2], ikn[2], ikt[2], bias[2], jn[2], jt[2],
      jb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float rx = s[i].px - gx, ry = s[i].py - gy;
    const float tnx = -s[i].ny, tny = s[i].nx;          // perp(normal)
    rxn[i] = rx * s[i].ny - ry * s[i].nx;
    rxt[i] = rx * tny - ry * tnx;
    const float kn = c.inv_mass + c.inv_inertia * rxn[i] * rxn[i];
    const float kt = c.inv_mass + c.inv_inertia * rxt[i] * rxt[i];
    ikn[i] = s[i].active ? 1.f / kn : 0.f;
    ikt[i] = s[i].active ? 1.f / kt : 0.f;
    bias[i] = c.bias_rate * clamp_min(s[i].depth - c.slop, 0.f);
    prx[i] = -ry;                                       // perp(r)
    pry[i] = rx;
    jn[i] = jt[i] = jb[i] = 0.f;
  }
  vx = vy = w = 0.f;
  float vbx = 0.f, vby = 0.f, wb = 0.f;
  for (int it = 0; it < c.iterations; ++it) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float nx = s[i].nx, ny = s[i].ny, tnx = -ny, tny = nx;
      // normal impulse
      float rel =
          nx * (vx + w * prx[i] - evx) + ny * (vy + w * pry[i] - evy);
      float dj = -rel * ikn[i];
      const float jn_new = clamp_min(jn[i] + dj, 0.f);
      dj = jn_new - jn[i];
      jn[i] = jn_new;
      vx = vx + dj * c.inv_mass * nx;
      vy = vy + dj * c.inv_mass * ny;
      w = w + dj * c.inv_inertia * rxn[i];
      // friction impulse, clamped by μ·jn
      rel = tnx * (vx + w * prx[i] - evx) + tny * (vy + w * pry[i] - evy);
      float djt = -rel * ikt[i];
      const float lim = c.mu * jn[i];
      const float jt_new = minimum(maximum(jt[i] + djt, -lim), lim);
      djt = jt_new - jt[i];
      jt[i] = jt_new;
      vx = vx + djt * c.inv_mass * tnx;
      vy = vy + djt * c.inv_mass * tny;
      w = w + djt * c.inv_inertia * rxt[i];
      // bias impulse (position correction only)
      const float relb = nx * (vbx + wb * prx[i]) + ny * (vby + wb * pry[i]);
      float djb = (bias[i] - relb) * ikn[i];
      const float jb_new = clamp_min(jb[i] + djb, 0.f);
      djb = jb_new - jb[i];
      jb[i] = jb_new;
      vbx = vbx + djb * c.inv_mass * nx;
      vby = vby + djb * c.inv_mass * ny;
      wb = wb + djb * c.inv_inertia * rxn[i];
    }
  }
  // integrate: the CoG and yaw, then the body origin from them
  const float ngx = gx + (vx + vbx) * c.contact_h;
  const float ngy = gy + (vy + vby) * c.contact_h;
  yaw = yaw + (w + wb) * c.contact_h;
  cs = cosf(yaw);
  sn = sinf(yaw);
  bx = ngx - (cs * c.cog[0] + (-sn) * c.cog[1]);
  by = ngy - (sn * c.cog[0] + cs * c.cog[1]);
}

// kinematics.orientation_error(p, p's value)'s tangent: the rotation
// vector from the current orientation to p, carried along p's tangent
__device__ void rotvec_tangent(const Dual p[4], float o[3]) {
  float pv[4], n[4];
  for (int k = 0; k < 4; ++k) pv[k] = p[k].v;
  normalize(pv, n);
  const Dual conj[4] = {Dual(n[0]), Dual(-n[1]), Dual(-n[2]), Dual(-n[3])};
  Dual dq[4];
  qmul(p, conj, dq);
  if (dq[0].v < 0.f)                                    // shortest arc
    for (int k = 0; k < 4; ++k) dq[k] = -dq[k];
  const Dual w(clamp(dq[0].v, -1.f, 1.f),
               dq[0].v >= -1.f && dq[0].v <= 1.f ? dq[0].d : 0.f);
  const Dual n2 = sum3(dq[1] * dq[1], dq[2] * dq[2], dq[3] * dq[3]);
  const Dual nrm = sqrt_(clamp_min_(n2, 1e-12f));
  // 2·atan2(nrm, w) and its tangent
  const float r2 = nrm.v * nrm.v + w.v * w.v;
  const Dual angle(2.f * atan2f(nrm.v, w.v),
                   2.f * ((nrm.d * w.v - w.d * nrm.v) / r2));
  const Dual scale = n2.v > 1e-12f ? angle / nrm : Dual(2.f);
  for (int k = 0; k < 3; ++k) o[k] = (dq[k + 1] * scale).d;
}

__global__ void __launch_bounds__(THREADS)
arm_step(const ArmIO io, int B, const ArmConstants c) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= B) return;
  const float* in[N_IN];
#pragma unroll
  for (int k = 0; k < N_IN; ++k) in[k] = io.in[k] + e * io.stride[k];
  float q[ARM_MAX_DOF], qd[ARM_MAX_DOF], tgt[ARM_MAX_DOF], qd_vel[ARM_MAX_DOF];
#pragma unroll
  for (int d = 0; d < ARM_MAX_DOF; ++d) {
    const bool on = d < c.ndof;
    q[d] = on ? in[IN_Q][d] : 0.f;
    qd[d] = on ? in[IN_QD][d] : 0.f;
    tgt[d] = on ? in[IN_ACTION][d] : 0.f;
    // (target − target_prev) / dt: the card's kernel takes the reciprocal
    qd_vel[d] = on ? (tgt[d] - in[IN_TARGET_PREV][d]) * c.inv_dt : 0.f;
  }
  unsigned path = 0;                    // the end effector's ancestors
  for (int j = c.eef; j > 0; j = c.parent[j]) path |= 1u << j;

  // 1. the end effector's previous xy, from the FK of the old joints
  float pq0[4], pt0[3];
  fk_eef(c, path, q, pq0, pt0);
  const float px = pt0[0], py = pt0[1];

  // 2. kinematics.arm_step
  for (int s = 0; s < c.pd_substeps; ++s) {
#pragma unroll
    for (int d = 0; d < ARM_MAX_DOF; ++d) {
      if (d >= c.ndof) continue;
      const float acc = c.kp * (tgt[d] - q[d]) + c.kd * (qd_vel[d] - qd[d]);
      qd[d] = minimum(maximum(qd[d] + acc * c.pd_h, -c.vmax[d]), c.vmax[d]);
      q[d] = minimum(maximum(q[d] + qd[d] * c.pd_h, c.lo[d]), c.hi[d]);
    }
  }

  // 3. the clock, then the end effector at the new joints, with tangents
  const float t = in[IN_T][0] + c.dt;
  Dual x[ARM_MAX_DOF], pq[4], pt[3];
#pragma unroll
  for (int d = 0; d < ARM_MAX_DOF; ++d) x[d] = Dual(q[d], qd[d]);
  fk_eef(c, path, x, pq, pt);
  const float nx = pt[0].v, ny = pt[1].v;

  // 4. the block pushed by the end effector swept over the substeps
  float bx = in[IN_BLOCK_POS][0], by = in[IN_BLOCK_POS][1];
  float yaw = in[IN_BLOCK_YAW][0];
  float vx = in[IN_BLOCK_VEL][0], vy = in[IN_BLOCK_VEL][1];
  float w = in[IN_BLOCK_OMEGA][0];
  const float* goal = in[IN_GOAL];
  float reward = 0.f;
  if (c.env_objects) {
    const float dx = nx - px, dy = ny - py;
    const float evx = dx * c.inv_dt, evy = dy * c.inv_dt;
    float cs = cosf(yaw), sn = sinf(yaw);
    for (int i = 0; i < c.contact_substeps; ++i) {
      // (i + 1.0) / contact_substeps as Python computes it, then float32
      const float frac = (float)((double)(i + 1) / (double)c.contact_substeps);
      block_substep(c, px + frac * dx, py + frac * dy, evx, evy, bx, by, yaw,
                    cs, sn, vx, vy, w);
    }
    // −‖goal[:3] − (block, 0)‖ − |goal yaw − yaw|
    const float gx = goal[0] - bx, gy = goal[1] - by, gz = goal[2] - 0.f;
    const float r1 = -sqrtf(sum3(gx * gx, gy * gy, gz * gz));
    reward = r1 + -fabsf(goal[3] - yaw);
  }

  // outputs
  float* const* out = io.out;
#pragma unroll
  for (int d = 0; d < ARM_MAX_DOF; ++d) {
    if (d >= c.ndof) continue;
    out[OUT_Q][e * c.ndof + d] = q[d];
    out[OUT_QD][e * c.ndof + d] = qd[d];
  }
  out[OUT_BLOCK_POS][2 * e] = bx;
  out[OUT_BLOCK_POS][2 * e + 1] = by;
  out[OUT_BLOCK_YAW][e] = yaw;
  out[OUT_BLOCK_VEL][2 * e] = vx;
  out[OUT_BLOCK_VEL][2 * e + 1] = vy;
  out[OUT_BLOCK_OMEGA][e] = w;
  out[OUT_PREV_EEF_XY][2 * e] = nx;
  out[OUT_PREV_EEF_XY][2 * e + 1] = ny;
  out[OUT_T][e] = t;
  out[OUT_REWARD][e] = reward;
  io.flag[OUT_TERMINATED - N_OUT_F32][e] = fabsf(reward) < c.done_below;
  io.flag[OUT_TRUNCATED - N_OUT_F32][e] = false;

  // 6. `_get_info`
  float pqv[4], eq[4], rv[3];
  for (int k = 0; k < 4; ++k) pqv[k] = pq[k].v;
  normalize(pqv, eq);
  rotvec_tangent(pq, rv);
  for (int k = 0; k < 3; ++k) {
    out[OUT_EEF_POS][3 * e + k] = pt[k].v;
    out[OUT_EEF_POS_VEL][3 * e + k] = pt[k].d;
    out[OUT_EEF_ROT_VEL][3 * e + k] = rv[k];
  }
  for (int k = 0; k < 4; ++k) out[OUT_EEF_QUAT][4 * e + k] = eq[k];
  // the block's pose [quat about z, x, y, 0] and velocity [0, 0, ω, v, 0]
  const float half = 0.5f * yaw, sh = sinf(half);
  const float pose[7] = {cosf(half), 0.f * sh, 0.f * sh, 1.f * sh, bx, by,
                         0.f};
  const float vel[6] = {0.f, 0.f, w, vx, vy, 0.f};
  for (int k = 0; k < 7; ++k) out[OUT_BLOCK_POSE][7 * e + k] = pose[k];
  for (int k = 0; k < 6; ++k) out[OUT_INFO_BLOCK_VEL][6 * e + k] = vel[k];
}

}  // namespace

// `in` the N_IN input pointers (float32, rows through `stride`, in
// elements), `out` the N_OUT output pointers (contiguous float32, then the
// two bool flags), for `B` envs; returns the launch's CUDA error code.
extern "C" int arm_step_launch(const void* const* in, const long long* stride,
                               void* const* out, int B, ArmConstants c,
                               void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  ArmIO io;
  for (int k = 0; k < N_IN; ++k) {
    io.in[k] = (const float*)in[k];
    io.stride[k] = stride[k];
  }
  for (int k = 0; k < N_OUT_F32; ++k) io.out[k] = (float*)out[k];
  for (int k = N_OUT_F32; k < N_OUT; ++k)
    io.flag[k - N_OUT_F32] = (bool*)out[k];
  arm_step<<<(B + THREADS - 1) / THREADS, THREADS, 0,
             (cudaStream_t)stream>>>(io, B, c);
  return (int)cudaGetLastError();
}
