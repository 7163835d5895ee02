"""pushT task physics, batched over envs.

Port of ``sim_a_splat_tpu/physics/pusht.py`` (constants, state, contact
gathering, ``substep``, ``control_step``, ``set_state``, ``reset``): a
kinematic circle agent under velocity-level PD pushes a dynamic T-block
(two boxes) inside four walls, 10 substeps per control step, each a
projected Gauss-Seidel contact solve.  Every state field has a leading env
axis B (the reference's ``vmap``); its ``scan`` over substeps is a loop.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from sim_a_splat_torch import resolve_device
from sim_a_splat_torch.physics.planar import (
    Contact, PlanarBody, circle_poly_contact, moment_for_poly, rotate2d,
    solve_contacts,
)


@dataclasses.dataclass(frozen=True)
class PushTParams:
    """Static task parameters (the reference's defaults; its goal and
    reward fields belong to the env layer, not ported yet)."""

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
    bias: float | None = None
    slop: float = 0.1
    block_cog: tuple | None = None

    @property
    def dt(self) -> float:
        return 1.0 / self.sim_hz

    @property
    def bias_coef(self) -> float:
        if self.bias is not None:
            return self.bias
        return 1.0 - (1.0 - 0.1) ** (60.0 * self.dt)

    @property
    def substeps(self) -> int:
        return self.sim_hz // self.control_hz


class PushTState(NamedTuple):
    """Batched dynamic state: every field has a leading env axis B."""

    agent_pos: torch.Tensor    # (B, 2)
    agent_vel: torch.Tensor    # (B, 2)
    block_pos: torch.Tensor    # (B, 2) body-origin position
    block_angle: torch.Tensor  # (B,)
    block_vel: torch.Tensor    # (B, 2) CoG velocity
    block_omega: torch.Tensor  # (B,)
    n_contacts: torch.Tensor   # (B,) agent-block contacts this control step


def state_from_numpy(fields, device="cuda") -> PushTState:
    """PushTState from numpy arrays (a mapping by field name, or a sequence
    in field order), as float32 tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(fields, dict):
        fields = [fields[k] for k in PushTState._fields]
    return PushTState(*(torch.as_tensor(np.array(a, np.float32), device=dev)
                        for a in fields))


# --- geometry ---------------------------------------------------------------

def tee_polys_local(scale: float = 30.0, length: float = 4.0) -> np.ndarray:
    """(2, 4, 2) CCW local vertices of the two T-block boxes."""
    v1 = [(-length * scale / 2, scale), (length * scale / 2, scale),
          (length * scale / 2, 0), (-length * scale / 2, 0)]
    v2 = [(-scale / 2, scale), (-scale / 2, length * scale),
          (scale / 2, length * scale), (scale / 2, scale)]
    return np.asarray([v1[::-1], v2[::-1]], np.float32)


def cog_local(params: PushTParams) -> np.ndarray:
    """Body-local CoG: the ``block_cog`` override, else the mean of the two
    box centroids."""
    if params.block_cog is not None:
        return np.asarray(params.block_cog, np.float32)
    return tee_polys_local(params.scale, params.length).mean(axis=1).mean(axis=0)


def tee_inertia(params: PushTParams) -> float:
    """mass=1, I = 2·moment(box 1) — the reference's quirk."""
    v1 = tee_polys_local(params.scale, params.length)[0]
    return 2.0 * moment_for_poly(params.mass, v1)


@functools.lru_cache(maxsize=16)
def _constants(params: PushTParams, device: torch.device) -> dict:
    """The task's constant tensors on ``device``, made once: a host→device
    copy inside every substep would stall the stream on a GPU."""
    n, b = _wall_planes(params)
    return {k: torch.as_tensor(v, device=device) for k, v in dict(
        polys=tee_polys_local(params.scale, params.length),
        cog=cog_local(params), wall_n=n, wall_b=b).items()}


def block_polys_world(params: PushTParams, pos, angle) -> torch.Tensor:
    """(B, 2, 4, 2) world vertices at body-origin ``pos`` (B, 2) and
    ``angle`` (B,)."""
    local = _constants(params, pos.device)["polys"]
    return pos[:, None, None, :] + rotate2d(angle[:, None, None], local)


def block_cog_world(params: PushTParams, pos, angle) -> torch.Tensor:
    return pos + rotate2d(angle, _constants(params, pos.device)["cog"])


def _origin_from_cog(params: PushTParams, cog, angle) -> torch.Tensor:
    return cog - rotate2d(angle, _constants(params, cog.device)["cog"])


# --- contacts ---------------------------------------------------------------

def _wall_planes(params: PushTParams):
    """Inner contact planes of the 4 walls: n·p ≥ b."""
    m = params.wall_inset + params.wall_radius
    n = np.asarray([[1, 0], [0, 1], [-1, 0], [0, -1]], np.float32)
    b = np.asarray([m, m, -(params.ws_x - m), -(params.ws_y - m)], np.float32)
    return n, b


def _gather_contacts(params: PushTParams, state: PushTState) -> Contact:
    """Fixed 10-slot contact set per env: 2 agent-block + 4 walls × the 2
    deepest block vertices."""
    polys = block_polys_world(params, state.block_pos, state.block_angle)
    B = polys.shape[0]
    dev = polys.device
    ag = [circle_poly_contact(state.agent_pos, params.agent_radius,
                              polys[:, i], state.agent_vel, params.friction)
          for i in range(2)]
    agent_c = Contact(*(torch.stack(x, dim=1) for x in zip(*ag)))
    agent_c = agent_c._replace(normal=-agent_c.normal)

    consts = _constants(params, dev)
    nw, bw = consts["wall_n"], consts["wall_b"]
    verts = polys.reshape(B, 8, 2)
    # (B, 4 walls, 8 verts); the normals are axis-aligned ±1, so the
    # products are exact
    pen = bw[None, :, None] - (nw[None, :, None, 0] * verts[:, None, :, 0]
                               + nw[None, :, None, 1] * verts[:, None, :, 1])
    # top-2 per wall, ties to the lower vertex index (as lax.top_k)
    top_pen, top_idx = torch.sort(pen, dim=-1, descending=True, stable=True)
    top_pen, top_idx = top_pen[..., :2], top_idx[..., :2]
    wall_pts = verts.gather(1, top_idx.reshape(B, 8, 1).expand(B, 8, 2))
    wall_c = Contact(
        point=wall_pts,
        normal=nw[None, :, None, :].expand(B, 4, 2, 2).reshape(B, 8, 2),
        depth=top_pen.reshape(B, 8),
        active=(top_pen > 0.0).reshape(B, 8),
        friction=verts.new_zeros((B, 8)),
        other_vel=verts.new_zeros((B, 8, 2)),
    )
    return Contact(*(torch.cat([a, b], dim=1)
                     for a, b in zip(agent_c, wall_c)))


# --- stepping ---------------------------------------------------------------

def substep(params: PushTParams, state: PushTState,
            action: torch.Tensor | None) -> PushTState:
    """One 100 Hz physics substep (PD control, then Chipmunk's order:
    damp velocities → solve impulses → integrate positions)."""
    dt = params.dt
    agent_vel = state.agent_vel
    if action is not None:
        acc = params.k_p * (action - state.agent_pos) + params.k_v * (-agent_vel)
        agent_vel = agent_vel + acc * dt

    damp = params.damping ** dt if params.damping > 0 else 0.0
    cog = block_cog_world(params, state.block_pos, state.block_angle)
    body = PlanarBody(cog=cog, angle=state.block_angle,
                      vel=state.block_vel * damp,
                      omega=state.block_omega * damp)
    contacts = _gather_contacts(params, state._replace(agent_vel=agent_vel))
    inv_m = 1.0 / params.mass
    inv_i = 1.0 / tee_inertia(params)
    v, w, vb, wb, _ = solve_contacts(
        body, contacts, inv_m, inv_i, dt, iterations=params.solver_iters,
        bias=params.bias_coef, slop=params.slop)

    new_cog = body.cog + (v + vb) * dt
    new_angle = body.angle + (w + wb) * dt
    return PushTState(
        agent_pos=state.agent_pos + agent_vel * dt,
        agent_vel=agent_vel,
        block_pos=_origin_from_cog(params, new_cog, new_angle),
        block_angle=new_angle,
        block_vel=v,
        block_omega=w,
        n_contacts=state.n_contacts + torch.sum(contacts.active[:, :2], dim=-1),
    )


def control_step(params: PushTParams, state: PushTState,
                 action: torch.Tensor) -> PushTState:
    """One 10 Hz control step = ``substeps`` physics substeps for every env;
    ``action`` (B, 2) agent targets."""
    state = state._replace(n_contacts=torch.zeros_like(state.n_contacts))
    for _ in range(params.substeps):
        state = substep(params, state, action)
    return state


# --- reset / set-state -------------------------------------------------------

def set_state(params: PushTParams, state_vec: torch.Tensor) -> PushTState:
    """Reset every env to its row of [agent_x, agent_y, block_x, block_y,
    block_angle] (B, 5), then one velocity-free settling substep."""
    agent_pos = state_vec[:, :2]
    block_pos = state_vec[:, 2:4]
    angle = state_vec[:, 4]
    zero2 = torch.zeros_like(agent_pos)
    state = PushTState(agent_pos=agent_pos, agent_vel=zero2,
                       block_pos=block_pos, block_angle=angle,
                       block_vel=zero2, block_omega=torch.zeros_like(angle),
                       n_contacts=torch.zeros_like(angle))
    return substep(params, state, None)


def sample_reset_state(params: PushTParams, generator: torch.Generator,
                       batch: int) -> torch.Tensor:
    """(B, 5) draws of the reference's reset distribution: integer-grid
    agent/block positions, angle = 2π·N(0,1) − π.  Drawn on the
    generator's device; the numbers differ from ``jax.random``'s."""
    dev = generator.device

    def randint(lo, hi):
        return torch.randint(lo, hi, (batch,), generator=generator,
                             device=dev).float()

    return torch.stack([
        randint(50, int(params.ws_x) - 50),
        randint(50, int(params.ws_y) - 50),
        randint(100, int(params.ws_x) - 100),
        randint(100, int(params.ws_y) - 100),
        torch.randn(batch, generator=generator, device=dev) * 2.0 * math.pi
        - math.pi,
    ], dim=-1)


def reset(params: PushTParams, generator: torch.Generator,
          batch: int) -> PushTState:
    """Batched reset: ``batch`` random states drawn from ``generator`` and
    settled by one substep, on the generator's device."""
    return set_state(params, sample_reset_state(params, generator, batch))
