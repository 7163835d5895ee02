"""URDF kinematic chains: FK, damped-least-squares IK and the joint-space PD
closed loop, batched over envs.

Port of ``sim_a_splat_tpu/physics/kinematics.py``.  The URDF is parsed on
the host (numpy and ``xml.etree``, the reference's parser copied) into a
static :class:`KinematicChain`; ``fk`` unrolls its link tree into
quaternion products on ``q`` with any leading batch dims (the reference's
``vmap`` is that axis).  ``ik``'s Jacobian is ``torch.func.jacfwd`` of
the pose error under ``torch.func.vmap`` (the reference's ``jax.jacfwd``),
then one 6×6 solve per env; its ``fori_loop`` and ``arm_step``'s
``scan`` are Python loops.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import NamedTuple
import xml.etree.ElementTree as ET

import numpy as np
import torch

from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.ops.transforms import SE3

JOINT_FIXED = 0
JOINT_REVOLUTE = 1   # includes "continuous"
JOINT_PRISMATIC = 2


@dataclasses.dataclass(frozen=True)
class VisualInfo:
    """Host-side visual geometry of a link.  ``geom_type`` ∈ {"mesh",
    "box", "cylinder", "sphere"}; ``size`` the primitive's dimensions (box
    x/y/z, cylinder (radius, length), sphere (radius,)); ``color`` the URDF
    material rgba."""

    mesh_path: str | None
    origin_xyz: tuple
    origin_rpy: tuple
    scale: tuple
    geom_type: str = "mesh"
    size: tuple = ()
    color: tuple = (0.7, 0.7, 0.7, 1.0)


@dataclasses.dataclass(frozen=True, eq=False)
class KinematicChain:
    """Static (host, numpy) kinematic structure of a URDF robot.

    Links are in topological order (parents before children): ``parent[i]
    < i``, ``parent[root] == -1``.  Hashed by identity, so its per-device
    tensors are made once (:func:`chain_tensors`)."""

    link_names: tuple
    joint_names: tuple
    parent: np.ndarray        # (L,) int
    jtype: np.ndarray         # (L,) int — joint connecting link i to parent
    qidx: np.ndarray          # (L,) int — actuated dof index or -1
    origin_q: np.ndarray      # (L, 4) wxyz — fixed joint origin rotation
    origin_t: np.ndarray      # (L, 3)
    axis: np.ndarray          # (L, 3)
    lower: np.ndarray         # (ndof,)
    upper: np.ndarray         # (ndof,)
    velocity_limit: np.ndarray  # (ndof,)
    effort_limit: np.ndarray    # (ndof,)
    visuals: tuple            # (L,) VisualInfo or None

    @property
    def num_links(self) -> int:
        return len(self.link_names)

    @property
    def ndof(self) -> int:
        return len(self.lower)

    def link_index(self, name: str) -> int:
        return self.link_names.index(name)

    def actuated_joint_names(self) -> tuple:
        order = {}
        for i in range(self.num_links):
            if self.qidx[i] >= 0:
                order[int(self.qidx[i])] = self.joint_names[i]
        return tuple(order[i] for i in range(self.ndof))


def _rpy_to_quat_np(rpy: np.ndarray) -> np.ndarray:
    """Numpy twin of ``quaternion.from_rpy`` (R = Rz(y)·Ry(p)·Rx(r)), for
    the host-side parse."""
    r, p, y = rpy[0] * 0.5, rpy[1] * 0.5, rpy[2] * 0.5
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    return np.array([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    ])


def _rpy_xyz(el) -> tuple[np.ndarray, np.ndarray]:
    if el is None:
        return np.zeros(3), np.zeros(3)
    xyz = np.fromstring(el.get("xyz", "0 0 0"), sep=" ")
    rpy = np.fromstring(el.get("rpy", "0 0 0"), sep=" ")
    return rpy, xyz


def _rgba(el) -> tuple:
    return tuple(np.fromstring(el.get("rgba", "0.7 0.7 0.7 1"), sep=" "))


def _visual_of(vis, mat_colors: dict) -> VisualInfo | None:
    """The VisualInfo of one ``<visual>`` element (None without a mesh or
    primitive geometry)."""
    rpy, xyz = _rpy_xyz(vis.find("origin"))
    color = (0.7, 0.7, 0.7, 1.0)
    mat = vis.find("material")
    if mat is not None:
        c = mat.find("color")
        if c is not None:
            color = _rgba(c)
        elif mat.get("name") in mat_colors:
            color = mat_colors[mat.get("name")]
    common = dict(origin_xyz=tuple(xyz), origin_rpy=tuple(rpy), color=color)
    geo = vis.find("geometry/mesh")
    box = vis.find("geometry/box")
    cyl = vis.find("geometry/cylinder")
    sph = vis.find("geometry/sphere")
    if geo is not None:
        return VisualInfo(
            mesh_path=geo.get("filename"),
            scale=tuple(np.fromstring(geo.get("scale", "1 1 1"), sep=" ")),
            geom_type="mesh", **common)
    if box is not None:
        size = tuple(np.fromstring(box.get("size", "1 1 1"), sep=" "))
        return VisualInfo(mesh_path=None, scale=(1.0, 1.0, 1.0),
                          geom_type="box", size=size, **common)
    if cyl is not None:
        size = (float(cyl.get("radius", "0.05")),
                float(cyl.get("length", "0.1")))
        return VisualInfo(mesh_path=None, scale=(1.0, 1.0, 1.0),
                          geom_type="cylinder", size=size, **common)
    if sph is not None:
        return VisualInfo(mesh_path=None, scale=(1.0, 1.0, 1.0),
                          geom_type="sphere",
                          size=(float(sph.get("radius", "0.05")),), **common)
    return None


def load_chain(urdf_path: str | Path,
               root: str | None = None) -> KinematicChain:
    """Parse a URDF file into a :class:`KinematicChain` (the reference's
    ``load_chain``: materials by name, the first visual of each link,
    links in BFS order from the root, ``continuous`` joints unlimited)."""
    robot = ET.parse(str(urdf_path)).getroot()

    mat_colors: dict[str, tuple] = {}
    for m in robot.findall("material"):
        c = m.find("color")
        if m.get("name") and c is not None:
            mat_colors[m.get("name")] = _rgba(c)

    links = [l.get("name") for l in robot.findall("link")]
    visual_by_link = {}
    for l in robot.findall("link"):
        vis = l.find("visual")
        visual_by_link[l.get("name")] = (
            None if vis is None else _visual_of(vis, mat_colors))

    joints = []
    child_of = {}
    for j in robot.findall("joint"):
        jd = {"name": j.get("name"), "type": j.get("type"),
              "parent": j.find("parent").get("link"),
              "child": j.find("child").get("link")}
        jd["rpy"], jd["xyz"] = _rpy_xyz(j.find("origin"))
        ax = j.find("axis")
        jd["axis"] = (np.fromstring(ax.get("xyz"), sep=" ")
                      if ax is not None else np.array([1.0, 0, 0]))
        lim = j.find("limit")
        jd["limit"] = tuple(
            float(lim.get(k, d)) if lim is not None else float(d)
            for k, d in (("lower", "-inf"), ("upper", "inf"),
                         ("velocity", "inf"), ("effort", "inf")))
        joints.append(jd)
        child_of[jd["child"]] = jd

    if root is None:
        roots = [l for l in links if l not in child_of]
        if len(roots) != 1:
            raise ValueError(f"expected one root link, found {roots}")
        root = roots[0]

    children: dict[str, list] = {l: [] for l in links}
    for jd in joints:
        if jd["parent"] in children:
            children[jd["parent"]].append(jd["child"])
    order = [root]
    seen = {root}
    i = 0
    while i < len(order):
        for c in children[order[i]]:
            if c not in seen:
                seen.add(c)
                order.append(c)
        i += 1

    L = len(order)
    idx = {n: i for i, n in enumerate(order)}
    parent = np.full(L, -1, np.int32)
    jtype = np.zeros(L, np.int32)
    qidx = np.full(L, -1, np.int32)
    origin_q = np.tile(np.array([1.0, 0, 0, 0]), (L, 1)).astype(np.float32)
    origin_t = np.zeros((L, 3), np.float32)
    axis = np.tile(np.array([1.0, 0, 0]), (L, 1)).astype(np.float32)
    joint_names = [""] * L
    lower, upper, vlim, elim = [], [], [], []
    type_map = {"fixed": JOINT_FIXED, "revolute": JOINT_REVOLUTE,
                "continuous": JOINT_REVOLUTE, "prismatic": JOINT_PRISMATIC,
                "floating": JOINT_FIXED, "planar": JOINT_FIXED}
    ndof = 0
    for name in order[1:]:
        jd = child_of[name]
        i = idx[name]
        parent[i] = idx[jd["parent"]]
        jtype[i] = type_map.get(jd["type"], JOINT_FIXED)
        joint_names[i] = jd["name"]
        origin_q[i] = _rpy_to_quat_np(np.asarray(jd["rpy"], np.float64))
        origin_t[i] = jd["xyz"]
        a = jd["axis"]
        axis[i] = a / max(np.linalg.norm(a), 1e-9)
        if jtype[i] != JOINT_FIXED:
            qidx[i] = ndof
            ndof += 1
            lo, hi, v, e = jd["limit"]
            if jd["type"] == "continuous":
                lo, hi = -np.inf, np.inf
            lower.append(lo)
            upper.append(hi)
            vlim.append(v)
            elim.append(e)

    return KinematicChain(
        link_names=tuple(order), joint_names=tuple(joint_names),
        parent=parent, jtype=jtype, qidx=qidx,
        origin_q=origin_q, origin_t=origin_t, axis=axis,
        lower=np.asarray(lower, np.float32),
        upper=np.asarray(upper, np.float32),
        velocity_limit=np.asarray(vlim, np.float32),
        effort_limit=np.asarray(elim, np.float32),
        visuals=tuple(visual_by_link[n] for n in order),
    )


@functools.lru_cache(maxsize=32)
def chain_tensors(chain: KinematicChain, device: torch.device) -> dict:
    """The chain's float32 constants on ``device``, made once: joint
    origins and axes, and the position and velocity limits with the
    infinite ones replaced by ±1e6 (as the reference clips)."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def finite(a, big):
        return f32(np.where(np.isfinite(a), a, big))

    return dict(origin_q=f32(chain.origin_q), origin_t=f32(chain.origin_t),
                axis=f32(chain.axis), lo=finite(chain.lower, -1e6),
                hi=finite(chain.upper, 1e6),
                vmax=finite(chain.velocity_limit, 1e6))


def fk(chain: KinematicChain, q: torch.Tensor,
       base: SE3 | None = None) -> SE3:
    """World pose of every link: ``q`` (..., ndof) → SE3 (..., L, ·).

    The tree is unrolled in Python (parents first): quaternion products on
    ``q``, differentiable in ``q`` and ``base`` (the weld transform, one
    pose or one per env)."""
    c = chain_tensors(chain, q.device)
    lead = q.shape[:-1]
    if base is None:
        base = SE3.identity(lead, device=q.device)
    qs = [base.q.expand(lead + (4,))]
    ts = [base.t.expand(lead + (3,))]
    for i in range(1, chain.num_links):
        oq, ot = c["origin_q"][i], c["origin_t"][i]
        jt = int(chain.jtype[i])
        if jt == JOINT_REVOLUTE:
            jq = quat.from_axis_angle(c["axis"][i], q[..., int(chain.qidx[i])])
            lq, lt = quat.multiply(oq, jq), ot
        elif jt == JOINT_PRISMATIC:
            lq = oq
            lt = ot + quat.rotate(
                oq, c["axis"][i] * q[..., int(chain.qidx[i]), None])
        else:
            lq, lt = oq, ot
        p = int(chain.parent[i])
        qs.append(quat.multiply(qs[p], lq).expand(lead + (4,)))
        ts.append((quat.rotate(qs[p], lt) + ts[p]).expand(lead + (3,)))
    return SE3(torch.stack(qs, dim=-2), torch.stack(ts, dim=-2))


def link_pose(chain: KinematicChain, q: torch.Tensor, link: str | int,
              base: SE3 | None = None) -> SE3:
    i = chain.link_index(link) if isinstance(link, str) else int(link)
    poses = fk(chain, q, base)
    return SE3(poses.q[..., i, :], poses.t[..., i, :])


def orientation_error(q_target: torch.Tensor,
                      q_current: torch.Tensor) -> torch.Tensor:
    """Rotation-vector error (axis·angle) taking q_current to q_target.

    Gradient-safe at zero error: the norm's square root takes
    max(n², 1e-12), and below that the scale is the small-angle limit 2,
    so neither branch of the ``where`` has an infinite derivative."""
    dq = quat.multiply(q_target, quat.conjugate(quat.normalize(q_current)))
    dq = torch.where(dq[..., :1] < 0, -dq, dq)        # shortest arc
    w = torch.clamp(dq[..., 0], -1.0, 1.0)
    vec = dq[..., 1:]
    n2 = torch.sum(vec * vec, dim=-1)
    eps = 1e-12
    n = torch.sqrt(torch.clamp(n2, min=eps))
    angle = 2.0 * torch.atan2(n, w)
    scale = torch.where(n2 > eps, angle / n, torch.full_like(n, 2.0))
    return vec * scale[..., None]


class IKResult(NamedTuple):
    q: torch.Tensor
    pos_err: torch.Tensor     # final position error norm
    ori_err: torch.Tensor     # final orientation error angle (rad)
    converged: torch.Tensor   # bool, the reference's tolerances met


def ik(chain: KinematicChain, link: str | int, target: SE3, q0: torch.Tensor,
       base: SE3 | None = None, iterations: int = 60, damping: float = 1e-2,
       max_step: float = 0.3, pos_tol: float = 1e-4, theta_bound: float = 0.01,
       ori_weight: float = 1.0) -> IKResult:
    """Damped-least-squares IK to a full 6-DoF target, batched: ``q0``
    (B, ndof), ``target`` (B, ·) poses (or one pose for all envs).

    Each of ``iterations`` steps takes the error e (B, 6) and its
    Jacobian J (B, 6, ndof), dq = −Jᵀ (J Jᵀ + damping·I)⁻¹ e, scales it to
    at most ``max_step`` and clips to the joint limits.  ``converged``: position
    error ≤ 3·``pos_tol`` and orientation error ≤ ``theta_bound``."""
    i = chain.link_index(link) if isinstance(link, str) else int(link)
    c = chain_tensors(chain, q0.device)
    lo, hi = c["lo"], c["hi"]
    B = q0.shape[0]
    tq = quat.normalize(target.q).expand(B, 4)
    tt = target.t.expand(B, 3)
    if base is None:
        base = SE3.identity(device=q0.device)
    bq, bt = base.q.expand(B, 4), base.t.expand(B, 3)

    def err(qj, tq, tt, bq, bt):
        poses = fk(chain, qj, SE3(bq, bt))
        e_p = tt - poses.t[..., i, :]
        e_o = ori_weight * orientation_error(tq, poses.q[..., i, :])
        return torch.cat([e_p, e_o], dim=-1)

    def err_one(*args):
        # one env as a batch of one: under vmap a 0-dim tensor times a
        # Python float is computed in float64, so no value is left 0-dim
        return err(*(a[None] for a in args))[0]

    jac = torch.func.vmap(torch.func.jacfwd(err_one))
    eye = torch.eye(6, dtype=q0.dtype, device=q0.device)
    qj = q0
    for _ in range(iterations):
        e = err(qj, tq, tt, bq, bt)                             # (B, 6)
        J = jac(qj, tq, tt, bq, bt)                             # (B, 6, ndof)
        JJt = torch.matmul(J, J.transpose(-1, -2)) + damping * eye
        x = torch.linalg.solve(JJt, e[..., None])
        dq = -torch.matmul(J.transpose(-1, -2), x)[..., 0]
        n = quat.norm(dq)[..., 0]
        dq = dq * torch.clamp(max_step / torch.clamp(n, min=1e-9),
                              max=1.0)[..., None]
        qj = torch.minimum(torch.maximum(qj + dq, lo), hi)
    e = err(qj, tq, tt, bq, bt)
    pos_err = quat.norm(e[..., :3])[..., 0]
    ori_err = quat.norm(e[..., 3:])[..., 0] / ori_weight
    return IKResult(q=qj, pos_err=pos_err, ori_err=ori_err,
                    converged=(pos_err <= pos_tol * 3.0)
                    & (ori_err <= theta_bound))


# --- joint-space PD dynamics (the InverseDynamicsController closed loop) ----

class ArmState(NamedTuple):
    q: torch.Tensor            # (B, ndof)
    qd: torch.Tensor           # (B, ndof)
    target_prev: torch.Tensor  # (B, ndof) previous position target


def arm_init(chain: KinematicChain, q: torch.Tensor) -> ArmState:
    q = q.to(torch.float32)
    return ArmState(q=q, qd=torch.zeros_like(q), target_prev=q)


def arm_step(chain: KinematicChain, state: ArmState, target: torch.Tensor,
             dt: float = 1e-2, kp: float = 100.0, kd: float = 20.0,
             substeps: int = 4) -> ArmState:
    """One control step of the PD closed loop: q̈ = kp (target − q) +
    kd (q̇_d − q̇) with q̇_d = (target − target_prev)/dt, ``substeps``
    semi-implicit Euler substeps with the velocity and position limits
    clipped."""
    c = chain_tensors(chain, target.device)
    lo, hi, vmax = c["lo"], c["hi"], c["vmax"]
    qd_vel = (target - state.target_prev) / dt
    h = dt / substeps
    qj, qdj = state.q, state.qd
    for _ in range(substeps):
        acc = kp * (target - qj) + kd * (qd_vel - qdj)
        qdj = torch.minimum(torch.maximum(qdj + acc * h, -vmax), vmax)
        qj = torch.minimum(torch.maximum(qj + qdj * h, lo), hi)
    return ArmState(q=qj, qd=qdj, target_prev=target)
