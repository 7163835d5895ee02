"""Manipulator environment: joint-space arm + planar T-block task, batched
over envs.

Port of ``sim_a_splat_tpu/envs/manipulator_envs.py``: the PD closed loop
of ``physics/kinematics.arm_step`` (time step 1e-2), the end effector as a
circle of radius 0.013 pushing the T-block in the table plane with the
pushT contact solver (``physics/planar.py``, 4 substeps of a 10-iteration
PGS), reward −‖goal − block‖ − |Δyaw|, done at |reward| < 0.02, and
``draw_state``: the body poses in the order of ``schema``.

Every state field has a leading env axis B (the reference's ``vmap``);
its ``scan`` over contact substeps is a loop.  ``_get_info``'s end-effector
velocities, J(q)·q̇ for the reference's two ``jax.jacfwd`` Jacobians, are
one forward-mode derivative each (``torch.func.jvp`` along q̇).  ``reset``
draws from a ``torch.Generator``, whose numbers differ from
``jax.random``'s; ``reset_to_state`` gives the reference's states.

On the card the control step is one launch of the hand-written kernel
``csrc/arm_step.cu`` (P2), a thread an env through the PD loop, the FK,
the contact substeps and ``_get_info``'s J·q̇, through the dispatcher
operator ``sim_a_splat::arm_step`` (``ops/_kernels.py``).  CPU tensors,
inputs that need a gradient while grad mode is on (the kernel has no
backward), and a chain past the kernel's caps (``ARM_MAX_LINKS``,
``ARM_MAX_DOF``) take the plain version, ``step_plain``: the CPU tests'
path and the card tests' oracle.  Other CUDA inputs (not float32, a row
whose elements are not adjacent, a wrong shape) raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from sim_a_splat_torch import resolve_device
from sim_a_splat_torch.messaging.draw import (
    GEOM_MESH, DrawState, GeomSchema, LinkSchema, ROBOT_NUM_ROBOT,
    ROBOT_NUM_TASK, SceneSchema,
)
from sim_a_splat_torch.ops import _kernels
from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.ops.transforms import SE3
from sim_a_splat_torch.physics import kinematics as kin
from sim_a_splat_torch.physics import planar
from sim_a_splat_torch.utils.profiling import span

# csrc/arm_step.cu's caps on a chain: pusharm6 has 8 links and 6 joints
ARM_MAX_LINKS, ARM_MAX_DOF = 8, 6


@dataclasses.dataclass(frozen=True)
class TBlockParams:
    """The T-block's geometry and inertia (meters, kg)."""

    crossbar_half_x: float = 0.1
    crossbar_half_y: float = 0.025
    stem_half_x: float = 0.025
    stem_y0: float = -0.175
    stem_y1: float = -0.025
    mass: float = 0.2
    izz: float = 0.003755952380952381     # about the CoG
    cog_y: float = -0.042857142857142844
    mu: float = 1.0

    def polys_local(self) -> np.ndarray:
        """(2, 4, 2) CCW box vertices in the block frame."""
        cb = [(-self.crossbar_half_x, -self.crossbar_half_y),
              (self.crossbar_half_x, -self.crossbar_half_y),
              (self.crossbar_half_x, self.crossbar_half_y),
              (-self.crossbar_half_x, self.crossbar_half_y)]
        st = [(-self.stem_half_x, self.stem_y0),
              (self.stem_half_x, self.stem_y0),
              (self.stem_half_x, self.stem_y1),
              (-self.stem_half_x, self.stem_y1)]
        return np.asarray([cb, st], np.float32)


class ManipulatorState(NamedTuple):
    """Batched state: every leaf has a leading env axis B."""

    arm: kin.ArmState
    block_pos: torch.Tensor    # (B, 2) world xy (z = 0 on the table)
    block_yaw: torch.Tensor    # (B,) world yaw
    block_vel: torch.Tensor    # (B, 2)
    block_omega: torch.Tensor  # (B,)
    goal: torch.Tensor         # (B, 4) [x, y, z, yaw_world]
    prev_eef_xy: torch.Tensor  # (B, 2) for the EEF velocity at the contact
    t: torch.Tensor            # (B,) sim time


class Transition(NamedTuple):
    state: ManipulatorState
    obs: Any
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    info: dict


class ArmKernelConstants(ctypes.Structure):
    """The chain's and the task's constants as ``csrc/arm_step.cu`` takes
    them (its ``ArmConstants``, by value): each rounded to float32 from the
    Python scalar the plain path uses, as PyTorch rounds a scalar operand
    of a float32 tensor (:meth:`ManipulatorEnvF.kernel_constants`)."""

    _fields_ = [
        *((f, ctypes.c_int * ARM_MAX_LINKS)
          for f in ("parent", "jtype", "qidx")),
        ("origin_q", ctypes.c_float * (4 * ARM_MAX_LINKS)),
        ("origin_t", ctypes.c_float * (3 * ARM_MAX_LINKS)),
        ("axis", ctypes.c_float * (3 * ARM_MAX_LINKS)),
        *((f, ctypes.c_float * ARM_MAX_DOF) for f in ("lo", "hi", "vmax")),
        ("weld_q", ctypes.c_float * 4), ("weld_t", ctypes.c_float * 3),
        *((f, ctypes.c_int) for f in ("num_links", "ndof", "eef")),
        *((f, ctypes.c_float) for f in ("kp", "kd", "pd_h", "inv_dt", "dt")),
        ("pd_substeps", ctypes.c_int),
        ("polys", ctypes.c_float * 16), ("cog", ctypes.c_float * 2),
        *((f, ctypes.c_float) for f in (
            "radius", "mu", "inv_mass", "inv_inertia", "bias_rate", "slop",
            "contact_h", "done_below")),
        *((f, ctypes.c_int) for f in ("contact_substeps", "iterations",
                                      "env_objects"))]


# the kernel's inputs after the action, and its outputs: (name, width or
# None for a (B,) field), then the two (B,) bool flags
_KERNEL_INPUTS = ("q", "qd", "target_prev", "block_pos", "block_yaw",
                  "block_vel", "block_omega", "goal", "t")
_KERNEL_OUTPUTS = (("q", "dof"), ("qd", "dof"), ("block_pos", 2),
                   ("block_yaw", None), ("block_vel", 2),
                   ("block_omega", None), ("prev_eef_xy", 2), ("t", None),
                   ("reward", None), ("eef_pos", 3), ("eef_quat", 4),
                   ("eef_pos_vel", 3), ("eef_rot_vel", 3), ("block_pose", 7),
                   ("info_block_vel", 6))
_STEP_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int, ArmKernelConstants,
                                      ctypes.c_void_p]


def kernel_arguments(state: list, action: torch.Tensor, ndof: int):
    """The launch's outputs, allocated: ``_KERNEL_OUTPUTS``' tensors, then
    ``terminated`` and ``truncated``; and its three pointer arguments, as
    ctypes arrays (the inputs ``state`` and ``action``, their row strides
    in elements, the outputs).  Returns (outputs, arrays)."""
    dev = action.device
    B = action.shape[0]
    out = [torch.empty((B,) if w is None else (B, ndof if w == "dof" else w),
                       dtype=torch.float32, device=dev)
           for _, w in _KERNEL_OUTPUTS]
    out += [torch.empty(B, dtype=torch.bool, device=dev) for _ in range(2)]
    ins = [*state, action]
    return out, ((ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins)),
                 (ctypes.c_longlong * len(ins))(*(t.stride(0) for t in ins)),
                 (ctypes.c_void_p * len(out))(*(t.data_ptr() for t in out)))


@_kernels.operator("arm_step(Tensor[] state, Tensor action, int constants) "
                   "-> Tensor[]")
def _launch(state: list, action: torch.Tensor, constants: int) -> list:
    """One launch of ``csrc/arm_step.cu`` over the inputs ``state``
    (``_KERNEL_INPUTS``' tensors) and ``action``, each read row by row
    through its stride; ``constants`` is the address of an
    :class:`ArmKernelConstants` the caller keeps alive.  Returns
    :func:`kernel_arguments`' outputs."""
    c = ArmKernelConstants.from_address(constants)
    out, arrays = kernel_arguments(state, action, c.ndof)
    _kernels.launch("arm_step", "arm_step", _STEP_ARGS, action.device,
                    *(ctypes.addressof(a) for a in arrays), action.shape[0],
                    c)
    return out


def state_from_numpy(fields, device="cuda") -> ManipulatorState:
    """ManipulatorState from numpy arrays: a mapping by field name whose
    ``arm`` is a mapping or sequence (q, qd, target_prev), as float32
    tensors on ``device`` (the reference's batched state carried over)."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    arm = fields["arm"]
    if isinstance(arm, dict):
        arm = [arm[k] for k in kin.ArmState._fields]
    return ManipulatorState(
        kin.ArmState(*(f32(a) for a in arm)),
        *(f32(fields[k]) for k in ManipulatorState._fields[1:]))


@dataclasses.dataclass(frozen=True, eq=False)
class ManipulatorEnvF:
    """Functional manipulator env over a batch of envs.

    ``env_objects`` gates the T-block task; ``weld`` is the base weld
    transform (q wxyz, t).  ``contact_bias`` None takes Chipmunk's
    schedule 1 − ((1−0.1)⁶⁰)^dt per substep, as the pushT physics does.
    ``device`` is where ``reset`` puts the states ("cuda" unless asked)."""

    chain: kin.KinematicChain
    eef_link: str
    env_objects: bool = True
    weld: tuple = ((1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    time_step: float = 1e-2
    kp: float = 100.0
    kd: float = 20.0
    eef_radius: float = 0.013
    block: TBlockParams = TBlockParams()
    contact_substeps: int = 4
    contact_bias: float | None = None
    contact_slop: float = 1e-4
    default_goal: tuple = (0.475, 0.0, 0.2, 0.78539816)
    device: str = "cuda"

    @functools.lru_cache(maxsize=8)
    def _consts(self, device: torch.device) -> dict:
        """Constant tensors on ``device``, made once."""
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return dict(base=SE3(f32(self.weld[0]), f32(self.weld[1])),
                    polys=f32(self.block.polys_local()),
                    cog=f32([0.0, self.block.cog_y]), z=f32([0.0, 0.0, 1.0]))

    def _base(self, device=None) -> SE3:
        return self._consts(resolve_device(device or self.device))["base"]

    @property
    def num_dof(self) -> int:
        return self.chain.ndof

    # --- schema (the load-message analogue) ---

    def schema(self) -> SceneSchema:
        from sim_a_splat_torch.scenegraph.mesh_overlay import geom_of_visual

        links = []
        for i, n in enumerate(self.chain.link_names):
            vis = self.chain.visuals[i]
            geoms = (geom_of_visual(n, vis),) if vis is not None else ()
            links.append(LinkSchema(name=f"plant::{n}",
                                    robot_num=ROBOT_NUM_ROBOT, geoms=geoms))
        if self.env_objects:
            links.append(LinkSchema(
                name="plant::tblock_paper", robot_num=ROBOT_NUM_TASK,
                geoms=(GeomSchema(name="tblock_paper", type=GEOM_MESH,
                                  color=(0.956, 0.396, 0.365, 1.0),
                                  string_data="assets/tblock_paper/"
                                              "tblock_paper.obj"),)))
        return SceneSchema(links=tuple(links))

    def draw_state(self, state: ManipulatorState) -> DrawState:
        """Body poses (B, L, ·) ordered as :meth:`schema`: the links' FK,
        then the T-block on the table."""
        q = state.arm.q
        poses = kin.fk(self.chain, q, self._base(q.device))
        if self.env_objects:
            c = self._consts(q.device)
            bq = quat.from_axis_angle(c["z"], state.block_yaw)
            bt = torch.cat([state.block_pos,
                            torch.zeros_like(state.block_pos[:, :1])], -1)
            poses = SE3(torch.cat([poses.q, bq[:, None]], 1),
                        torch.cat([poses.t, bt[:, None]], 1))
        return DrawState(poses=poses)

    # --- reset -------------------------------------------------------------

    def reset(self, generator: Optional[torch.Generator] = None,
              reset_to_state: Optional[dict] = None,
              batch: int = 1) -> tuple[ManipulatorState, Any]:
        """``batch`` states on ``self.device``: random joints in [−π, π]
        and a random block pose from ``generator``, or ``reset_to_state``
        ({robot_pos, block_pos [x, y, z, yaw], goal_pos}, each one value
        for all envs or one per env).  The block's yaw and the goal's yaw
        are negated and their z zeroed, as the reference does."""
        dev = resolve_device(self.device)

        def f32(a):
            a = torch.as_tensor(np.asarray(a, np.float32), device=dev)
            return a.expand(batch, a.shape[-1]).clone()

        if reset_to_state is None:
            if generator is None:
                raise ValueError("reset needs a generator or reset_to_state")
            robot_pos = (torch.rand((batch, self.num_dof), generator=generator,
                                    device=dev) * 2.0 - 1.0) * math.pi
            lo = f32([0.4, -0.183, 0.2, -np.pi])
            hi = f32([0.55, 0.183, 0.2, np.pi])
            block_pos = lo + (hi - lo) * torch.rand(
                (batch, 4), generator=generator, device=dev)
            goal_pos = f32(self.default_goal)
        else:
            robot_pos = f32(reset_to_state["robot_pos"])
            block_pos = f32(reset_to_state.get("block_pos",
                                               (0.475, 0.0, 0.2, 0.0)))
            goal_pos = f32(reset_to_state.get("goal_pos", self.default_goal))
        goal = goal_pos.clone()
        goal[:, 2] = 0.0
        goal[:, 3] = -goal_pos[:, 3]
        zeros = torch.zeros(batch, device=dev)
        state = ManipulatorState(
            arm=kin.arm_init(self.chain, robot_pos),
            block_pos=block_pos[:, :2], block_yaw=-block_pos[:, 3],
            block_vel=torch.zeros((batch, 2), device=dev), block_omega=zeros,
            goal=goal, prev_eef_xy=torch.zeros((batch, 2), device=dev),
            t=zeros)
        state = state._replace(prev_eef_xy=self._eef_pose(state).t[:, :2])
        return state, self._get_obs(state)

    # --- step --------------------------------------------------------------

    def _eef_pose(self, state: ManipulatorState) -> SE3:
        q = state.arm.q
        return kin.link_pose(self.chain, q, self.eef_link, self._base(q.device))

    def _block_substep(self, state: ManipulatorState, eef_xy, eef_vel_xy,
                       dt: float) -> ManipulatorState:
        bp = self.block
        c = self._consts(eef_xy.device)
        R = planar.rot2d(state.block_yaw)                        # (B, 2, 2)
        polys = state.block_pos[:, None, None, :] + torch.sum(
            R[:, None, None] * c["polys"][None, :, :, None, :], -1)
        cs = [planar.circle_poly_contact(eef_xy, self.eef_radius,
                                         polys[:, i], eef_vel_xy, bp.mu)
              for i in range(2)]
        contacts = planar.Contact(*(torch.stack(f, dim=1) for f in zip(*cs)))
        contacts = contacts._replace(normal=-contacts.normal)
        cog = state.block_pos + torch.sum(R * c["cog"], -1)
        body = planar.PlanarBody(cog=cog, angle=state.block_yaw,
                                 vel=torch.zeros_like(cog),
                                 omega=torch.zeros_like(state.block_yaw))
        bias = (self.contact_bias if self.contact_bias is not None
                else 1.0 - ((1.0 - 0.1) ** 60.0) ** dt)
        v, w, vb, wb, _ = planar.solve_contacts(
            body, contacts, 1.0 / bp.mass, 1.0 / bp.izz, dt, iterations=10,
            bias=bias, slop=self.contact_slop)
        new_cog = cog + (v + vb) * dt
        new_yaw = state.block_yaw + (w + wb) * dt
        new_pos = new_cog - torch.sum(planar.rot2d(new_yaw) * c["cog"], -1)
        return state._replace(block_pos=new_pos, block_yaw=new_yaw,
                              block_vel=v, block_omega=w)

    @span("physics")
    def step(self, state: ManipulatorState,
             action: torch.Tensor) -> Transition:
        """One control step for every env: joint targets ``action`` (B,
        ndof) through the PD loop, then the block pushed by the end
        effector swept linearly over the contact substeps.  On the card
        one kernel launch (:meth:`_step_kernel`, in the span
        ``physics.solve``), else :meth:`step_plain`."""
        if self._on_kernel(state, action):
            return self._step_kernel(state, action)
        return self.step_plain(state, action)

    def _on_kernel(self, state: ManipulatorState,
                   action: torch.Tensor) -> bool:
        """Whether the kernel steps these inputs: CUDA tensors, none of
        which needs a gradient while grad mode is on, of a chain within the
        kernel's caps."""
        ch = self.chain
        if state.arm.q.device.type != "cuda" or ch.num_links > ARM_MAX_LINKS \
                or ch.ndof > ARM_MAX_DOF:
            return False
        return not (torch.is_grad_enabled() and any(
            t.requires_grad for t in (*state.arm, *state[1:], action)))

    @functools.lru_cache(maxsize=8)
    def kernel_constants(self) -> ArmKernelConstants:
        """:class:`ArmKernelConstants` of this env (made once): the chain,
        its clipped limits and the weld, and the scalars of
        :meth:`step_plain` (``kinematics.arm_step``'s 4 substeps, the
        10-iteration solve, done below 0.02), each as the plain path rounds
        it; the card's 1/dt is the float32 reciprocal PyTorch's CUDA
        division by a scalar multiplies with.  Raises for a chain past the
        kernel's caps."""
        ch = self.chain
        if ch.num_links > ARM_MAX_LINKS or ch.ndof > ARM_MAX_DOF:
            raise ValueError(
                f"arm_step takes chains of at most {ARM_MAX_LINKS} links and "
                f"{ARM_MAX_DOF} joints; this one has {ch.num_links} links "
                f"and {ch.ndof} joints")
        ct = kin.chain_tensors(ch, torch.device("cpu"))
        bp = self.block
        h = self.time_step / self.contact_substeps
        bias = (self.contact_bias if self.contact_bias is not None
                else 1.0 - ((1.0 - 0.1) ** 60.0) ** h)
        c = ArmKernelConstants(
            num_links=ch.num_links, ndof=ch.ndof,
            eef=ch.link_index(self.eef_link), kp=self.kp, kd=self.kd,
            pd_h=self.time_step / 4, dt=self.time_step,
            inv_dt=float(np.float32(1.0) / np.float32(self.time_step)),
            pd_substeps=4, radius=self.eef_radius, mu=bp.mu,
            inv_mass=1.0 / bp.mass, inv_inertia=1.0 / bp.izz,
            bias_rate=bias / h, slop=self.contact_slop, contact_h=h,
            done_below=0.02, contact_substeps=self.contact_substeps,
            iterations=10, env_objects=int(self.env_objects))
        L, D = ch.num_links, ch.ndof
        for name, a in (("parent", ch.parent), ("jtype", ch.jtype),
                        ("qidx", ch.qidx)):
            getattr(c, name)[:L] = [int(x) for x in a]
        for name, a in (("origin_q", ct["origin_q"]),
                        ("origin_t", ct["origin_t"]), ("axis", ct["axis"])):
            getattr(c, name)[:a.numel()] = a.flatten().tolist()
        for name in ("lo", "hi", "vmax"):
            getattr(c, name)[:D] = ct[name].tolist()
        c.weld_q[:] = [float(x) for x in self.weld[0]]
        c.weld_t[:] = [float(x) for x in self.weld[1]]
        c.polys[:] = bp.polys_local().ravel().tolist()
        c.cog[:] = [0.0, bp.cog_y]
        return c

    @span("physics.solve")
    def _step_kernel(self, state: ManipulatorState,
                     action: torch.Tensor) -> Transition:
        """The control step of every env in one launch of
        ``csrc/arm_step.cu``: the new state, reward, flags and info of
        :meth:`step_plain` (``target_prev`` is ``action``, ``goal`` the
        state's).  Raises on inputs it does not take."""
        c = self.kernel_constants()
        dev = state.arm.q.device
        B, D = state.arm.q.shape[0], self.chain.ndof
        inputs = {**state.arm._asdict(), **state._asdict(), "action": action}
        del inputs["arm"], inputs["prev_eef_xy"]           # prev: not read
        for name, t in inputs.items():
            want = ((B,) if name in ("block_yaw", "block_omega", "t")
                    else (B, 2) if name in ("block_pos", "block_vel")
                    else (B, 4) if name == "goal" else (B, D))
            rows = t.dim() != 2 or t.shape[1] < 2 or t.stride(1) == 1
            if t.dtype != torch.float32 or tuple(t.shape) != want \
                    or t.device != dev or not rows:
                raise ValueError(
                    f"arm_step takes float32 {want} on {dev}, each row's "
                    f"elements adjacent; {name} is "
                    f"{'' if rows else 'non-contiguous '}{t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
        out = torch.ops.sim_a_splat.arm_step(
            [inputs[n] for n in _KERNEL_INPUTS], action, ctypes.addressof(c))
        o = dict(zip((n for n, _ in _KERNEL_OUTPUTS), out))
        new = ManipulatorState(
            arm=kin.ArmState(o["q"], o["qd"], action),
            block_pos=o["block_pos"], block_yaw=o["block_yaw"],
            block_vel=o["block_vel"], block_omega=o["block_omega"],
            goal=state.goal, prev_eef_xy=o["prev_eef_xy"], t=o["t"])
        info = {k: o[k] for k in ("eef_pos", "eef_quat", "eef_pos_vel",
                                  "eef_rot_vel")}
        info["timestamp"] = o["t"]
        if self.env_objects:
            info["block_pose"] = o["block_pose"]
            info["block_vel"] = o["info_block_vel"]
        return Transition(state=new, obs=self._get_obs(new),
                          reward=o["reward"], terminated=out[-2],
                          truncated=out[-1], info=info)

    def step_plain(self, state: ManipulatorState,
                   action: torch.Tensor) -> Transition:
        """The plain version of :meth:`step` on any device: eager PyTorch.
        Spans: ``physics.arm`` (the PD loop and the end effector's FK),
        ``physics.solve`` (each substep's contact solve) and
        ``physics.info`` (:meth:`_get_info`)."""
        with span("physics.arm"):
            prev_eef = self._eef_pose(state).t[:, :2]
            arm = kin.arm_step(self.chain, state.arm, action,
                               dt=self.time_step, kp=self.kp, kd=self.kd)
            state = state._replace(arm=arm, t=state.t + self.time_step)
            eef = self._eef_pose(state)
        if self.env_objects:
            new_eef = eef.t[:, :2]
            eef_vel = (new_eef - prev_eef) / self.time_step
            h = self.time_step / self.contact_substeps
            for i in range(self.contact_substeps):
                frac = (i + 1.0) / self.contact_substeps
                exy = prev_eef + frac * (new_eef - prev_eef)
                state = self._block_substep(state, exy, eef_vel, h)
        state = state._replace(prev_eef_xy=eef.t[:, :2])
        reward = self._compute_reward(state)
        with span("physics.info"):
            info = self._get_info(state)
        return Transition(state=state, obs=self._get_obs(state),
                          reward=reward, terminated=torch.abs(reward) < 0.02,
                          truncated=torch.zeros_like(reward, dtype=torch.bool),
                          info=info)

    # --- obs / info / reward -----------------------------------------------

    def _get_obs(self, state: ManipulatorState):
        return {"robot_joint_pos": state.arm.q,
                "robot_joint_vel": state.arm.qd}

    def _get_info(self, state: ManipulatorState) -> dict:
        eef = self._eef_pose(state)
        base = self._base(eef.q.device)
        q, qd = state.arm.q, state.arm.qd
        q_eef = eef.q.detach()

        def pos_of(qj):
            return kin.link_pose(self.chain, qj, self.eef_link, base).t

        def rotvec_of(qj):
            p = kin.link_pose(self.chain, qj, self.eef_link, base)
            return kin.orientation_error(p.q, q_eef)

        # J(q)·q̇ of the reference's jacfwd Jacobians, env by env
        _, eef_pos_vel = torch.func.jvp(pos_of, (q,), (qd,))
        _, eef_rot_vel = torch.func.jvp(rotvec_of, (q,), (qd,))
        info = {"eef_pos": eef.t, "eef_quat": quat.normalize(eef.q),
                "eef_pos_vel": eef_pos_vel, "eef_rot_vel": eef_rot_vel,
                "timestamp": state.t}
        if self.env_objects:
            bq = quat.from_axis_angle(self._consts(q.device)["z"],
                                      state.block_yaw)
            z1 = torch.zeros_like(state.block_yaw)[:, None]
            info["block_pose"] = torch.cat([bq, state.block_pos, z1], -1)
            info["block_vel"] = torch.cat(
                [z1, z1, state.block_omega[:, None], state.block_vel, z1], -1)
        return info

    def _compute_reward(self, state: ManipulatorState) -> torch.Tensor:
        if not self.env_objects:
            return torch.zeros_like(state.t)
        block3 = torch.cat([state.block_pos,
                            torch.zeros_like(state.block_pos[:, :1])], -1)
        r1 = -quat.norm(state.goal[:, :3] - block3)[:, 0]
        r2 = -torch.abs(state.goal[:, 3] - state.block_yaw)
        return r1 + r2
