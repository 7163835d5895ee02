// Kernel P1: the pushT control step, `substeps` physics substeps of every
// env in one launch.
//
// Replaces no Pallas kernel: the JAX package's `control_step`
// (sim_a_splat_tpu/physics/pusht.py) is a jitted `lax.scan` over substeps
// that XLA fuses; the port's plain version (physics/pusht.py
// `control_step_plain`, planar.py `solve_contacts`) runs it as ~55,000
// eager elementwise kernels a step, each a handful of flops for B envs.
// Here one thread steps one env through every substep: it reads its env's
// state and action once, keeps everything in registers, and writes the new
// state once.  Each substep, in the plain path's order: PD control of the
// agent, the block's velocities times `damp` (0 where damping is 0, as the
// plain path multiplies by it), the 10 contact slots (agent against box 0
// and box 1, then walls 0-3 × their two deepest T vertices, ties to the
// lower vertex index as a stable descending sort gives), the split-impulse
// PGS (`iterations` sweeps over the slots in that order), the integration
// of positions, and the agent-block contact count.
//
// Arithmetic is the plain path's, op for op, in float32: this source is
// built with -fmad=false (no product and sum fused where the plain path
// rounds each), without fast math (IEEE division, sqrtf, sinf, cosf), the
// clamps as PyTorch's (NaN passes through, else fmaxf/fminf), argmax and
// argmin taking the first index on ties.  Every slot runs every sweep,
// inactive ones with inv_k 0, and the friction impulse runs at μ = 0 too:
// nothing is skipped, so the state is the plain path's on the card.
//
// What bounds it on an H100: the dependent chain of one env's PGS, not
// bytes (48 B in, 44 B out an env) nor flops (~10^5 an env): 10 substeps ×
// 10 sweeps × 10 slots × ~28 dependent float ops of >= 4 cycles, at least
// 60 µs at 1,980 MHz (0.16 ms measured at B = 128 on an H100, the clamps'
// NaN tests and predicates in the chain besides).  The design takes the
// chain as it is: one thread an env in blocks of 32 (grid ceil(B / 32):
// B = 1 and B in the thousands take the same launch), the slots unrolled
// so their constants stay in registers, and within a slot the velocity
// chain (v, w, jn, jt) and the bias chain (vb, wb, jb) independent, which
// gives two-way ILP.

#include <cuda_runtime.h>

// The task's constants, rounded to float32 on the host as the plain
// path's Python scalars are (physics/pusht.py `KernelConstants`).  Outside
// the anonymous namespace: the exported launch function takes it.
struct PushTConstants {
  float polys[2][4][2];   // local CCW vertices of the T's two boxes
  float cog[2];           // body-local centre of gravity
  float wall_n[4][2];     // inner wall planes n·p >= b
  float wall_b[4];
  float inv_mass, inv_inertia;
  float bias_rate;        // bias_coef / dt
  float slop, k_p, k_v, dt, damp, friction, radius;
  int iterations;
};

namespace {

constexpr int SLOTS = 10;     // 2 agent-box contacts + 4 walls × 2 vertices
constexpr int THREADS = 32;

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

struct Slot {
  float px, py;     // world contact point
  float nx, ny;     // impulse direction on the block
  float depth;
  bool active;
};

// planar.py `circle_poly_contact` of the circle (cx, cy, radius) against
// the world quad v, then the normal negated (the impulse on the block).
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

__global__ void __launch_bounds__(THREADS)
pusht_step(const float* __restrict__ agent_pos,
           const float* __restrict__ agent_vel,
           const float* __restrict__ block_pos,
           const float* __restrict__ block_angle,
           const float* __restrict__ block_vel,
           const float* __restrict__ block_omega,
           const float* __restrict__ action,
           float* __restrict__ agent_pos_out,
           float* __restrict__ agent_vel_out,
           float* __restrict__ block_pos_out,
           float* __restrict__ block_angle_out,
           float* __restrict__ block_vel_out,
           float* __restrict__ block_omega_out,
           float* __restrict__ n_contacts_out, int B, int substeps,
           int has_action, const PushTConstants c) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= B) return;
  float ax = agent_pos[2 * e], ay = agent_pos[2 * e + 1];
  float avx = agent_vel[2 * e], avy = agent_vel[2 * e + 1];
  float bx = block_pos[2 * e], by = block_pos[2 * e + 1];
  float ang = block_angle[e];
  float bvx = block_vel[2 * e], bvy = block_vel[2 * e + 1];
  float om = block_omega[e];
  float nc = 0.f;   // the agent-block contacts of this launch's substeps
  const float tx = has_action ? action[2 * e] : 0.f;
  const float ty = has_action ? action[2 * e + 1] : 0.f;
  float cs = cosf(ang), sn = sinf(ang);

  for (int sub = 0; sub < substeps; ++sub) {
    // PD control of the agent
    if (has_action) {
      const float accx = c.k_p * (tx - ax) + c.k_v * (-avx);
      const float accy = c.k_p * (ty - ay) + c.k_v * (-avy);
      avx = avx + accx * c.dt;
      avy = avy + accy * c.dt;
    }
    float vx = bvx * c.damp, vy = bvy * c.damp, w = om * c.damp;
    float vbx = 0.f, vby = 0.f, wb = 0.f;

    // world geometry at the substep's start
    const float ns = -sn;
    const float gx = bx + (cs * c.cog[0] + ns * c.cog[1]);
    const float gy = by + (sn * c.cog[0] + cs * c.cog[1]);
    float v[2][4][2];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float lx = c.polys[b][k][0], ly = c.polys[b][k][1];
        v[b][k][0] = bx + (cs * lx + ns * ly);
        v[b][k][1] = by + (sn * lx + cs * ly);
      }

    // the 10 slots: agent vs box 0, box 1; walls 0-3 × two deepest vertices
    Slot s[SLOTS];
    s[0] = circle_quad(ax, ay, c.radius, v[0]);
    s[1] = circle_quad(ax, ay, c.radius, v[1]);
#pragma unroll
    for (int wl = 0; wl < 4; ++wl) {
      const float wx = c.wall_n[wl][0], wy = c.wall_n[wl][1];
      float pen[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        pen[j] = c.wall_b[wl] - (wx * v[j >> 2][j & 3][0] +
                                 wy * v[j >> 2][j & 3][1]);
      // the two deepest, ties to the lower index; the values ride along,
      // so nothing is indexed at run time (which would go to local memory)
      int i1 = 0;
      float p1 = pen[0], x1 = v[0][0][0], y1 = v[0][0][1];
#pragma unroll
      for (int j = 1; j < 8; ++j)
        if (pen[j] > p1) {
          i1 = j;
          p1 = pen[j];
          x1 = v[j >> 2][j & 3][0];
          y1 = v[j >> 2][j & 3][1];
        }
      bool second = false;
      float p2 = 0.f, x2 = 0.f, y2 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j != i1 && (!second || pen[j] > p2)) {
          second = true;
          p2 = pen[j];
          x2 = v[j >> 2][j & 3][0];
          y2 = v[j >> 2][j & 3][1];
        }
      s[2 + 2 * wl] = Slot{x1, y1, wx, wy, p1, p1 > 0.f};
      s[3 + 2 * wl] = Slot{x2, y2, wx, wy, p2, p2 > 0.f};
    }

    // planar.py `solve_contacts`: per-slot constants, then the sweeps
    float prx[SLOTS], pry[SLOTS], rxn[SLOTS], rxt[SLOTS], ikn[SLOTS],
        ikt[SLOTS], bias[SLOTS], jn[SLOTS], jt[SLOTS], jb[SLOTS];
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
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
    for (int it = 0; it < c.iterations; ++it) {
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        const float nx = s[i].nx, ny = s[i].ny, tnx = -ny, tny = nx;
        // the agent's velocity on its two slots; walls are still (0)
        const float ovx = i < 2 ? avx : 0.f, ovy = i < 2 ? avy : 0.f;
        const float mu = i < 2 ? c.friction : 0.f;
        // normal impulse
        float rel =
            nx * (vx + w * prx[i] - ovx) + ny * (vy + w * pry[i] - ovy);
        float dj = -rel * ikn[i];
        const float jn_new = clamp_min(jn[i] + dj, 0.f);
        dj = jn_new - jn[i];
        jn[i] = jn_new;
        vx = vx + dj * c.inv_mass * nx;
        vy = vy + dj * c.inv_mass * ny;
        w = w + dj * c.inv_inertia * rxn[i];
        // friction impulse, clamped by μ·jn
        rel = tnx * (vx + w * prx[i] - ovx) + tny * (vy + w * pry[i] - ovy);
        float djt = -rel * ikt[i];
        const float lim = mu * jn[i];
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

    // integrate: the CoG and angle, then the body origin from them
    const float ngx = gx + (vx + vbx) * c.dt, ngy = gy + (vy + vby) * c.dt;
    ang = ang + (w + wb) * c.dt;
    cs = cosf(ang);
    sn = sinf(ang);
    bx = ngx - (cs * c.cog[0] + (-sn) * c.cog[1]);
    by = ngy - (sn * c.cog[0] + cs * c.cog[1]);
    ax = ax + avx * c.dt;
    ay = ay + avy * c.dt;
    bvx = vx;
    bvy = vy;
    om = w;
    nc = nc + (float)((int)s[0].active + (int)s[1].active);
  }

  agent_pos_out[2 * e] = ax;
  agent_pos_out[2 * e + 1] = ay;
  agent_vel_out[2 * e] = avx;
  agent_vel_out[2 * e + 1] = avy;
  block_pos_out[2 * e] = bx;
  block_pos_out[2 * e + 1] = by;
  block_angle_out[e] = ang;
  block_vel_out[2 * e] = bvx;
  block_vel_out[2 * e + 1] = bvy;
  block_omega_out[e] = om;
  n_contacts_out[e] = nc;
}

}  // namespace

// The first six state fields in (B, 2) / (B,) float32 contiguous layout
// (not `n_contacts`: the count starts at 0), the action (B, 2) or null
// without one, the seven state fields out likewise (`n_contacts_out` the
// agent-block contacts of these substeps); returns the launch's CUDA error
// code.
extern "C" int pusht_step_launch(
    const void* agent_pos, const void* agent_vel, const void* block_pos,
    const void* block_angle, const void* block_vel, const void* block_omega,
    const void* action, void* agent_pos_out,
    void* agent_vel_out, void* block_pos_out, void* block_angle_out,
    void* block_vel_out, void* block_omega_out, void* n_contacts_out, int B,
    int substeps, int has_action, PushTConstants c, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  pusht_step<<<(B + THREADS - 1) / THREADS, THREADS, 0,
               (cudaStream_t)stream>>>(
      (const float*)agent_pos, (const float*)agent_vel,
      (const float*)block_pos, (const float*)block_angle,
      (const float*)block_vel, (const float*)block_omega,
      (const float*)action, (float*)agent_pos_out,
      (float*)agent_vel_out, (float*)block_pos_out, (float*)block_angle_out,
      (float*)block_vel_out, (float*)block_omega_out, (float*)n_contacts_out,
      B, substeps, has_action, c);
  return (int)cudaGetLastError();
}
