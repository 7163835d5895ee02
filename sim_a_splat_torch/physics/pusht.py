"""pushT task physics, batched over envs.

Port of ``sim_a_splat_tpu/physics/pusht.py``: a kinematic circle agent
under velocity-level PD pushes a dynamic T-block (two boxes) inside four
walls, 10 substeps per control step, each a projected Gauss-Seidel contact
solve; the reward is the share of the goal's area that the block covers
(exact convex clipping), and the observation [agent_xy, block_xy, angle].
Every state field has a leading env axis B (the reference's ``vmap``); its
``scan`` over substeps is a loop.

On the card the control step (and ``set_state``'s settling substep) is one
launch of the hand-written kernel ``csrc/pusht_step.cu``, a thread an env
through every substep, through the dispatcher operator
``sim_a_splat::pusht_step`` (``ops/_kernels.py``).  CPU tensors, and
inputs that need a gradient while grad mode is on (the kernel has no
backward), take the plain version, ``control_step_plain``: the CPU tests'
path and the card tests' oracle.  Other CUDA inputs (not float32, not
contiguous) raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from sim_a_splat_torch import resolve_device
from sim_a_splat_torch.ops import _kernels
from sim_a_splat_torch.physics.planar import (
    Contact, PlanarBody, _shoelace, circle_poly_contact, convex_clip_area,
    moment_for_poly, rotate2d, solve_contacts,
)
from sim_a_splat_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class PushTParams:
    """Static task parameters (the reference's defaults)."""

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
    goal_x: float = 149.0         # ws_x / 2
    goal_y: float = 256.0         # ws_y / 2
    goal_theta: float = float(np.pi / 4)
    success_threshold: float = 0.95
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

    @property
    def goal_pose(self) -> np.ndarray:
        return np.array([self.goal_x, self.goal_y, self.goal_theta])


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


def tee_cog_local(scale: float = 30.0, length: float = 4.0) -> np.ndarray:
    """CoG = mean of the two box centroids (a box's centroid is the mean of
    its vertices)."""
    return tee_polys_local(scale, length).mean(axis=1).mean(axis=0)


def cog_local(params: PushTParams) -> np.ndarray:
    """Body-local CoG: the ``block_cog`` override, else the shape's."""
    if params.block_cog is not None:
        return np.asarray(params.block_cog, np.float32)
    return tee_cog_local(params.scale, params.length)


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


@functools.lru_cache(maxsize=16)
def _goal(params: PushTParams, device: torch.device) -> tuple:
    """The goal T's world boxes (2, 4, 2) and its area, made once.  The
    area is each box's own (shoelace) area: the reference clips each box by
    itself, a degenerate clip (every vertex on a clip edge) whose result
    hangs on the signs of rounding errors; its jitted form folds it to half
    the stem's area (``ROADMAP.md`` §3)."""
    goal = block_polys_world(
        params, torch.tensor([[params.goal_x, params.goal_y]], device=device),
        torch.tensor([params.goal_theta], device=device))[0]
    four = torch.full((2,), 4, dtype=torch.long, device=device)
    area = torch.abs(_shoelace(goal, four))
    return goal, area[0] + area[1]


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


@span("physics.contacts")
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

def _damp(params: PushTParams) -> float:
    """The block's velocity factor a substep (0 without damping)."""
    return params.damping ** params.dt if params.damping > 0 else 0.0


def substep_plain(params: PushTParams, state: PushTState,
                  action: torch.Tensor | None) -> PushTState:
    """The plain version of :func:`substep` on any device: eager PyTorch,
    ``_gather_contacts`` then ``planar.solve_contacts``."""
    dt = params.dt
    agent_vel = state.agent_vel
    if action is not None:
        acc = params.k_p * (action - state.agent_pos) + params.k_v * (-agent_vel)
        agent_vel = agent_vel + acc * dt

    damp = _damp(params)
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


def control_step_plain(params: PushTParams, state: PushTState,
                       action: torch.Tensor) -> PushTState:
    """The plain version of :func:`control_step` on any device: eager
    PyTorch, substep by substep."""
    state = state._replace(n_contacts=torch.zeros_like(state.n_contacts))
    for _ in range(params.substeps):
        state = substep_plain(params, state, action)
    return state


class KernelConstants(ctypes.Structure):
    """The task's constants as ``csrc/pusht_step.cu`` takes them (its
    ``PushTConstants``, by value): each rounded to float32 from the Python
    float the plain path hands PyTorch, as PyTorch rounds a scalar operand
    of a float32 tensor."""

    _fields_ = [("polys", ctypes.c_float * 16), ("cog", ctypes.c_float * 2),
                ("wall_n", ctypes.c_float * 8), ("wall_b", ctypes.c_float * 4),
                *((f, ctypes.c_float) for f in (
                    "inv_mass", "inv_inertia", "bias_rate", "slop", "k_p",
                    "k_v", "dt", "damp", "friction", "radius")),
                ("iterations", ctypes.c_int)]


@functools.lru_cache(maxsize=16)
def kernel_constants(params: PushTParams) -> KernelConstants:
    """:class:`KernelConstants` of ``params`` (made once)."""
    n, b = _wall_planes(params)
    c = KernelConstants(
        inv_mass=1.0 / params.mass, inv_inertia=1.0 / tee_inertia(params),
        bias_rate=params.bias_coef / params.dt, slop=params.slop,
        k_p=params.k_p, k_v=params.k_v, dt=params.dt, damp=_damp(params),
        friction=params.friction, radius=params.agent_radius,
        iterations=params.solver_iters)
    for name, a in (("polys", tee_polys_local(params.scale, params.length)),
                    ("cog", cog_local(params)), ("wall_n", n),
                    ("wall_b", b)):
        getattr(c, name)[:] = [float(x) for x in np.ravel(a)]
    return c


def _on_kernel(state: PushTState, action: torch.Tensor | None) -> bool:
    """Whether the kernel steps these inputs: CUDA tensors, none of which
    needs a gradient while grad mode is on."""
    if state.agent_pos.device.type != "cuda":
        return False
    inputs = (*state, action) if action is not None else state
    return not (torch.is_grad_enabled()
                and any(t.requires_grad for t in inputs))


_STEP_ARGS = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3 + [
    KernelConstants, ctypes.c_void_p]


@_kernels.operator("pusht_step(Tensor[] state, Tensor? action, "
                   "int substeps, int constants) -> Tensor[]")
def _launch(state: list, action: torch.Tensor | None, substeps: int,
            constants: int) -> list:
    """One launch of ``csrc/pusht_step.cu``; ``constants`` is the address
    of a :class:`KernelConstants` the caller keeps alive."""
    dev = state[0].device
    B = state[0].shape[0]
    out = [torch.empty(t.shape, dtype=torch.float32, device=dev)
           for t in state] + [torch.empty(B, dtype=torch.float32, device=dev)]
    _kernels.launch("pusht_step", "pusht_step", _STEP_ARGS, dev,
                    *(t.data_ptr() for t in state),
                    None if action is None else action.data_ptr(),
                    *(t.data_ptr() for t in out), B, substeps,
                    int(action is not None),
                    KernelConstants.from_address(constants))
    return out


@span("physics.solve")
def _step_kernel(params: PushTParams, state: PushTState,
                 action: torch.Tensor | None, substeps: int) -> PushTState:
    """``substeps`` substeps of every env in one launch of
    ``csrc/pusht_step.cu`` (without ``action``: no PD control); the state's
    ``n_contacts`` is not read, the result's counts these substeps'
    contacts.  Raises on inputs it does not take."""
    dev = state.agent_pos.device
    B = state.agent_pos.shape[0]
    inputs = dict(state._asdict(), action=action)
    del inputs["n_contacts"]
    for name, t in inputs.items():
        want = (B,) if name in ("block_angle", "block_omega") else (B, 2)
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != want \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(
                f"pusht_step takes contiguous float32 {want} on {dev}; "
                f"{name} is {'' if t.is_contiguous() else 'non-contiguous '}"
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    c = kernel_constants(params)
    return PushTState(*torch.ops.sim_a_splat.pusht_step(
        list(state[:-1]), action, substeps, ctypes.addressof(c)))


def substep(params: PushTParams, state: PushTState,
            action: torch.Tensor | None) -> PushTState:
    """One 100 Hz physics substep (PD control, then Chipmunk's order:
    damp velocities → solve impulses → integrate positions); on the card
    one kernel launch."""
    if _on_kernel(state, action):
        out = _step_kernel(params, state, action, 1)
        return out._replace(n_contacts=state.n_contacts + out.n_contacts)
    return substep_plain(params, state, action)


@span("physics")
def control_step(params: PushTParams, state: PushTState,
                 action: torch.Tensor) -> PushTState:
    """One 10 Hz control step = ``substeps`` physics substeps for every env;
    ``action`` (B, 2) agent targets.  On the card one kernel launch."""
    if _on_kernel(state, action):
        return _step_kernel(params, state, action, params.substeps)
    return control_step_plain(params, state, action)


# --- reward / observation ---------------------------------------------------

def coverage(params: PushTParams, state: PushTState) -> torch.Tensor:
    """(B,) |block ∩ goal| / |goal| by exact convex clipping.  The two T
    boxes have disjoint interiors, so the intersection's area is the sum of
    the four pairwise box intersections (added in the reference's order)."""
    block = block_polys_world(params, state.block_pos, state.block_angle)
    goal, goal_area = _goal(params, block.device)
    pairs = convex_clip_area(block[:, [0, 0, 1, 1]], goal[[0, 1, 0, 1]])
    inter = pairs[:, 0] + pairs[:, 1] + pairs[:, 2] + pairs[:, 3]
    return inter / goal_area


def reward_done(params: PushTParams, state: PushTState):
    """(B,) reward clip(coverage / threshold, 0, 1) and done (coverage past
    the threshold)."""
    cov = coverage(params, state)
    reward = torch.clamp(cov / params.success_threshold, 0.0, 1.0)
    return reward, cov > params.success_threshold


def get_obs(state: PushTState) -> torch.Tensor:
    """(B, 5) [agent_xy, block_xy, block_angle mod 2π]."""
    return torch.cat([state.agent_pos, state.block_pos,
                      torch.remainder(state.block_angle,
                                      2.0 * math.pi)[:, None]], dim=-1)


# --- reset / set-state -------------------------------------------------------

def set_state(params: PushTParams, state_vec: torch.Tensor,
              legacy: bool = False) -> PushTState:
    """Reset every env to its row of [agent_x, agent_y, block_x, block_y,
    block_angle] (B, 5), then one velocity-free settling substep.
    ``legacy`` keeps the reference's ordering quirk of legacy data: the
    position was set before the angle, and the body rotates about its CoG,
    which moves its origin."""
    # contiguous copies of the columns, as the card's kernel takes them
    agent_pos = state_vec[:, :2].contiguous()
    block_pos = state_vec[:, 2:4].contiguous()
    angle = state_vec[:, 4].contiguous()
    if legacy:
        cog = _constants(params, state_vec.device)["cog"]
        block_pos = _origin_from_cog(params, block_pos + cog, angle)
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


def reset(params: PushTParams, generator: torch.Generator | None,
          batch: int, reset_to_state: torch.Tensor | None = None,
          legacy: bool = False) -> PushTState:
    """Batched reset: ``batch`` random states drawn from ``generator`` (on
    its device), or the rows of ``reset_to_state`` (B, 5), settled by one
    substep."""
    if reset_to_state is None:
        reset_to_state = sample_reset_state(params, generator, batch)
    return set_state(params, reset_to_state, legacy=legacy)
