"""Plain reference of the pushT task physics, batched over envs.

A frozen copy of the port's plain physics (a circle agent under
velocity-level PD pushing a T-block of two boxes inside four walls: 10
substeps a control step, each a projected Gauss-Seidel contact solve with
Chipmunk's split impulses), kept here so that a later change to the program
cannot move the yardstick.  Every tensor carries a leading env axis B.
Constants are made in the dtype of the state, so the whole step runs in one
precision: float32 for the reference, bfloat16 for its control.

It imports torch and numpy only: nothing of the program.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Params:
    ws_x: float = 298.0
    ws_y: float = 512.0
    sim_hz: int = 100
    control_hz: int = 10
    k_p: float = 100.0
    k_v: float = 20.0
    agent_radius: float = 17.0
    wall_inset: float = 5.0
    wall_radius: float = 2.0
    scale: float = 30.0
    length: float = 4.0
    mass: float = 1.0
    friction: float = 0.0
    damping: float = 0.0
    solver_iters: int = 10
    slop: float = 0.1

    @property
    def dt(self) -> float:
        return 1.0 / self.sim_hz

    @property
    def bias_coef(self) -> float:
        return 1.0 - (1.0 - 0.1) ** (60.0 * self.dt)

    @property
    def substeps(self) -> int:
        return self.sim_hz // self.control_hz


class State(NamedTuple):
    agent_pos: torch.Tensor    # (B, 2)
    agent_vel: torch.Tensor    # (B, 2)
    block_pos: torch.Tensor    # (B, 2) body-origin position
    block_angle: torch.Tensor  # (B,)
    block_vel: torch.Tensor    # (B, 2) CoG velocity
    block_omega: torch.Tensor  # (B,)
    n_contacts: torch.Tensor   # (B,)


def tee_polys(scale: float = 30.0, length: float = 4.0) -> np.ndarray:
    """(2, 4, 2) CCW body-local vertices of the two T-block boxes."""
    v1 = [(-length * scale / 2, scale), (length * scale / 2, scale),
          (length * scale / 2, 0), (-length * scale / 2, 0)]
    v2 = [(-scale / 2, scale), (-scale / 2, length * scale),
          (scale / 2, length * scale), (scale / 2, scale)]
    return np.asarray([v1[::-1], v2[::-1]], np.float32)


def _moment_for_poly(mass: float, verts) -> float:
    v = np.asarray(verts, np.float64)
    s1 = s2 = 0.0
    for i in range(len(v)):
        v1, v2 = v[i], v[(i + 1) % len(v)]
        a = float(v2[0] * v1[1] - v2[1] * v1[0])
        s1 += a * float(v1 @ v1 + v1 @ v2 + v2 @ v2)
        s2 += a
    return mass * s1 / (6.0 * s2)


def _inertia(p: Params) -> float:
    """mass 1, twice the first box's moment: the task's own convention."""
    return 2.0 * _moment_for_poly(p.mass, tee_polys(p.scale, p.length)[0])


def _consts(p: Params, like: torch.Tensor) -> dict:
    polys = tee_polys(p.scale, p.length)
    m = p.wall_inset + p.wall_radius
    arrays = dict(
        polys=polys, cog=polys.mean(axis=1).mean(axis=0),
        wall_n=np.asarray([[1, 0], [0, 1], [-1, 0], [0, -1]], np.float32),
        wall_b=np.asarray([m, m, -(p.ws_x - m), -(p.ws_y - m)], np.float32))
    return {k: torch.as_tensor(v, device=like.device).to(like.dtype)
            for k, v in arrays.items()}


def _rotate2d(angle, v):
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x, y = v[..., 0:1], v[..., 1:2]
    return torch.cat([c * x + (-s) * y, s * x + c * y], dim=-1)


def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _perp(v):
    return torch.stack([-v[..., 1], v[..., 0]], dim=-1)


def _norm2(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _dot2(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


class Contact(NamedTuple):
    point: torch.Tensor
    normal: torch.Tensor
    depth: torch.Tensor
    active: torch.Tensor
    friction: torch.Tensor
    other_vel: torch.Tensor


def block_polys(p: Params, pos, angle):
    """(B, 2, 4, 2) world vertices of the block at origin ``pos``."""
    local = _consts(p, pos)["polys"]
    return pos[:, None, None, :] + _rotate2d(angle[:, None, None], local)


def _circle_poly(center, radius, poly, other_vel, friction):
    v0 = poly
    edges = torch.roll(poly, -1, dims=-2) - v0
    n = -_perp(edges)
    n = n / torch.clamp(_norm2(n), min=1e-9)[..., None]
    rel = center[..., None, :] - v0
    dmax, iface = torch.max(torch.sum(n * rel, dim=-1), dim=-1)
    t = torch.clamp(torch.sum(rel * edges, dim=-1)
                    / torch.clamp(torch.sum(edges * edges, dim=-1), min=1e-9),
                    0.0, 1.0)
    cp = v0 + t[..., None] * edges
    dist = _norm2(center[..., None, :] - cp)
    iedge = torch.argmin(dist, dim=-1)

    def pick(a, i):
        return a.gather(-2, i[..., None, None].expand(
            a.shape[:-2] + (1, 2)))[..., 0, :]

    dist_e = dist.gather(-1, iedge[..., None])[..., 0]
    inside = dmax < 0.0
    normal_out = ((center - pick(cp, iedge))
                  / torch.clamp(dist_e, min=1e-9)[..., None])
    normal = torch.where(inside[..., None], pick(n, iface), normal_out)
    depth = torch.where(inside, radius - dmax, radius - dist_e)
    point = center - normal * (radius - depth * 0.5)[..., None]
    return Contact(point, normal, depth, depth > 0.0,
                   torch.full_like(depth, friction), other_vel)


def _contacts(p: Params, s: State) -> Contact:
    """10 contact slots an env: 2 agent-block, then 4 walls × the two
    deepest block vertices."""
    polys = block_polys(p, s.block_pos, s.block_angle)
    B = polys.shape[0]
    ag = [_circle_poly(s.agent_pos, p.agent_radius, polys[:, i], s.agent_vel,
                       p.friction) for i in range(2)]
    agent_c = Contact(*(torch.stack(x, dim=1) for x in zip(*ag)))
    agent_c = agent_c._replace(normal=-agent_c.normal)
    c = _consts(p, polys)
    nw, bw = c["wall_n"], c["wall_b"]
    verts = polys.reshape(B, 8, 2)
    pen = bw[None, :, None] - (nw[None, :, None, 0] * verts[:, None, :, 0]
                               + nw[None, :, None, 1] * verts[:, None, :, 1])
    top_pen, top_idx = torch.sort(pen, dim=-1, descending=True, stable=True)
    top_pen, top_idx = top_pen[..., :2], top_idx[..., :2]
    wall_c = Contact(
        point=verts.gather(1, top_idx.reshape(B, 8, 1).expand(B, 8, 2)),
        normal=nw[None, :, None, :].expand(B, 4, 2, 2).reshape(B, 8, 2),
        depth=top_pen.reshape(B, 8),
        active=(top_pen > 0.0).reshape(B, 8),
        friction=verts.new_zeros((B, 8)),
        other_vel=verts.new_zeros((B, 8, 2)))
    return Contact(*(torch.cat([a, b], dim=1)
                     for a, b in zip(agent_c, wall_c)))


def _solve(cog, vel, omega, ct: Contact, inv_m, inv_i, dt, iters, bias, slop):
    C = ct.normal.shape[-2]
    tangents = _perp(ct.normal)
    r = ct.point - cog[..., None, :]
    rxn, rxt = _cross2(r, ct.normal), _cross2(r, tangents)
    zero = torch.zeros_like(rxn)
    inv_k_n = torch.where(ct.active, 1.0 / (inv_m + inv_i * rxn * rxn), zero)
    inv_k_t = torch.where(ct.active, 1.0 / (inv_m + inv_i * rxt * rxt), zero)
    bias_target = (bias / dt) * torch.clamp(ct.depth - slop, min=0.0)
    perp_r = _perp(r)
    v, w = vel, omega
    vb, wb = torch.zeros_like(v), torch.zeros_like(w)
    jn = [zero[..., i] for i in range(C)]
    jt, jb = list(jn), list(jn)
    for _ in range(iters):
        for i in range(C):
            n_i, t_i = ct.normal[..., i, :], tangents[..., i, :]
            pr_i, ov_i = perp_r[..., i, :], ct.other_vel[..., i, :]
            rel = _dot2(n_i, v + w[..., None] * pr_i - ov_i)
            jn_new = torch.clamp(jn[i] - rel * inv_k_n[..., i], min=0.0)
            dj, jn[i] = jn_new - jn[i], jn_new
            v = v + (dj * inv_m)[..., None] * n_i
            w = w + dj * inv_i * rxn[..., i]
            relt = _dot2(t_i, v + w[..., None] * pr_i - ov_i)
            lim = ct.friction[..., i] * jn[i]
            jt_new = torch.minimum(torch.maximum(
                jt[i] - relt * inv_k_t[..., i], -lim), lim)
            djt, jt[i] = jt_new - jt[i], jt_new
            v = v + (djt * inv_m)[..., None] * t_i
            w = w + djt * inv_i * rxt[..., i]
            relb = _dot2(n_i, vb + wb[..., None] * pr_i)
            jb_new = torch.clamp(
                jb[i] + (bias_target[..., i] - relb) * inv_k_n[..., i],
                min=0.0)
            djb, jb[i] = jb_new - jb[i], jb_new
            vb = vb + (djb * inv_m)[..., None] * n_i
            wb = wb + djb * inv_i * rxn[..., i]
    return v, w, vb, wb


def substep(p: Params, s: State, action) -> State:
    """One 100 Hz substep: PD on the agent, then damp, solve, integrate."""
    dt = p.dt
    agent_vel = s.agent_vel
    if action is not None:
        acc = p.k_p * (action - s.agent_pos) + p.k_v * (-agent_vel)
        agent_vel = agent_vel + acc * dt
    damp = p.damping ** dt if p.damping > 0 else 0.0
    cog_l = _consts(p, s.block_pos)["cog"]
    cog = s.block_pos + _rotate2d(s.block_angle, cog_l)
    ct = _contacts(p, s._replace(agent_vel=agent_vel))
    v, w, vb, wb = _solve(cog, s.block_vel * damp, s.block_omega * damp, ct,
                          1.0 / p.mass, 1.0 / _inertia(p), dt,
                          p.solver_iters, p.bias_coef, p.slop)
    new_cog = cog + (v + vb) * dt
    new_angle = s.block_angle + (w + wb) * dt
    return State(
        agent_pos=s.agent_pos + agent_vel * dt, agent_vel=agent_vel,
        block_pos=new_cog - _rotate2d(new_angle, cog_l),
        block_angle=new_angle, block_vel=v, block_omega=w,
        n_contacts=s.n_contacts + torch.sum(ct.active[:, :2], dim=-1))


def control_step(p: Params, s: State, action) -> State:
    """One 10 Hz control step: ``substeps`` substeps toward ``action``."""
    s = s._replace(n_contacts=torch.zeros_like(s.n_contacts))
    for _ in range(p.substeps):
        s = substep(p, s, action)
    return s


def reset(p: Params, vec: torch.Tensor) -> State:
    """Envs at rows [agent_x, agent_y, block_x, block_y, angle] of ``vec``
    (B, 5), settled by one substep without an action."""
    zero2 = torch.zeros_like(vec[:, :2])
    s = State(vec[:, :2], zero2, vec[:, 2:4], vec[:, 4], zero2,
              torch.zeros_like(vec[:, 4]), torch.zeros_like(vec[:, 4]))
    return substep(p, s, None)

