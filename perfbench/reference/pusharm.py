"""Plain reference of the arm deployment: ``pusharm6`` pushing a T-block in
a splat scene, seen by a fixed viewport and by a camera on its end
effector.

What it holds the program to, written out plainly:

- the URDF chain, parsed here with ``xml.etree`` (links breadth-first from
  the root, revolute and continuous joints actuated in that order, the
  joint origins' roll-pitch-yaw as quaternions), and its forward
  kinematics as quaternion products, the base at the identity;
- one control step of every env: the joint-space PD loop (q̈ = kp (target
  − q) + kd ((target − target_prev)/dt − q̇), ``arm_substeps``
  semi-implicit Euler substeps, velocities and positions clipped to the
  URDF's limits), then the T-block pushed by the end effector, a circle of
  ``eef_radius`` swept linearly from its old to its new table position
  over ``contact_substeps`` substeps, each a contact against the block's
  two boxes and a 10-iteration projected Gauss-Seidel solve from rest
  (``pusht_physics``'s contact and solver);
- the scene posed by each env's draw state: link k's gaussians moved by
  its pose times the inverse of its rest pose (the FK at q = 0), the
  block's by its pose on the table (yaw about z);
- the viewport: the static gaussians' tile lists (``tile_capacity``) and
  each env's dynamic lists (``dyn_capacity``, ``dyn_max_tiles`` slots),
  merged by depth and composited (``splat_render``); touched tiles past
  ``sel_tiles`` are severe, dynamic lists over capacity and gaussians cut
  at their slots bounded;
- the end-effector camera over its candidate cache.  At the cache's build
  state the static gaussians within ``z_split`` in front of the lens (and
  up to ``t_max`` behind it) form the near set, its first ``near_cap`` by
  index, the overflow severe; the others are binned with their footprints
  dilated by ``margin`` pixels (every bucket widened by the dilation's
  extra tiles) and each tile keeps its ``kc`` nearest by build depth
  (tiles cut at ``kc`` and gaussians cut at their slots: bounded, counted
  in every frame rendered from that cache).  At the rendered pose each
  candidate is reprojected and kept where it lies in front of the lens
  and its 3σ box touches its tile; the env's posed dynamics and the near
  set are binned afresh (``dyn_capacity``, ``dyn_max_tiles``; their
  truncations bounded), merged with the candidates by depth (candidates
  first on ties) and composited.  The margin budget a pose uses
  (:func:`budget_used`) is the program's bound, term by term; past 1 the
  cache may miss gaussians: the frame is severe, and the collect step
  rebuilds that env's cache from the new state first.

The reference follows the program step by step from the program's own
states: the input state and action of a step, and for the end-effector
camera the state its cache was built at.  Departures from the source:
the composite runs every list to its end (the program stops a tile's
chunks once every pixel's transmittance is under ``term_eps``); sorts are
stable where the source's order of equal keys is unspecified; a budget
within ``rebuild_band`` of the threshold admits either decision.

It imports torch, numpy and the standard library only: nothing of the
program.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from perfbench.reference import pusht_physics as pp
from perfbench.reference import splat_render as sr

ROOT = Path(__file__).resolve().parents[2]
FIELDS = ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
          "sh_rest")
NEAR = 0.01


# --- the chain ------------------------------------------------------------

class Chain(NamedTuple):
    names: tuple            # link names, breadth-first from the root
    parent: list            # parent index, -1 at the root
    qidx: list              # actuated joint index, -1 where fixed
    origin_q: np.ndarray    # (L, 4) wxyz of each joint's origin
    origin_t: np.ndarray    # (L, 3)
    axis: np.ndarray        # (L, 3) unit joint axis
    lower: np.ndarray       # (ndof,) position limits
    upper: np.ndarray
    vmax: np.ndarray        # (ndof,) velocity limits


def _rpy_quat(r, p, y) -> np.ndarray:
    """wxyz of R = Rz(y)·Ry(p)·Rx(r)."""
    cr, sr_ = math.cos(r / 2), math.sin(r / 2)
    cp, sp = math.cos(p / 2), math.sin(p / 2)
    cy, sy = math.cos(y / 2), math.sin(y / 2)
    return np.array([cr * cp * cy + sr_ * sp * sy,
                     sr_ * cp * cy - cr * sp * sy,
                     cr * sp * cy + sr_ * cp * sy,
                     cr * cp * sy - sr_ * sp * cy])


def load_chain(path) -> Chain:
    robot = ET.parse(str(path)).getroot()
    links = [l.get("name") for l in robot.findall("link")]
    joints = {}
    for j in robot.findall("joint"):
        joints[j.find("child").get("link")] = j
    root = [l for l in links if l not in joints]
    if len(root) != 1:
        raise ValueError(f"expected one root link, found {root}")
    order = [root[0]]
    for name in order:                      # grows while it is walked
        for j in robot.findall("joint"):
            if j.find("parent").get("link") == name:
                order.append(j.find("child").get("link"))
    L = len(order)
    parent, qidx = [-1] * L, [-1] * L
    origin_q = np.tile([1.0, 0.0, 0.0, 0.0], (L, 1))
    origin_t = np.zeros((L, 3))
    axis = np.tile([1.0, 0.0, 0.0], (L, 1))
    lower, upper, vmax = [], [], []
    for i, name in enumerate(order[1:], start=1):
        j = joints[name]
        parent[i] = order.index(j.find("parent").get("link"))
        o = j.find("origin")
        xyz = [0.0] * 3 if o is None else [float(v) for v in
                                           o.get("xyz", "0 0 0").split()]
        rpy = [0.0] * 3 if o is None else [float(v) for v in
                                           o.get("rpy", "0 0 0").split()]
        origin_q[i] = _rpy_quat(*rpy)
        origin_t[i] = xyz
        a = j.find("axis")
        ax = np.array([1.0, 0, 0]) if a is None else np.array(
            [float(v) for v in a.get("xyz").split()])
        axis[i] = ax / max(np.linalg.norm(ax), 1e-9)
        kind = j.get("type")
        if kind in ("revolute", "continuous"):
            qidx[i] = len(lower)
            lim = j.find("limit")

            def get(k, d):
                return float(lim.get(k, d)) if lim is not None else float(d)
            lo, hi = get("lower", "-inf"), get("upper", "inf")
            if kind == "continuous":
                lo, hi = -math.inf, math.inf
            lower.append(lo)
            upper.append(hi)
            vmax.append(get("velocity", "inf"))
        elif kind not in ("fixed", None):
            raise ValueError(f"joint {j.get('name')}: {kind} not modelled")
    return Chain(tuple(order), parent, qidx, origin_q, origin_t, axis,
                 np.array(lower), np.array(upper), np.array(vmax))


# The float32 expressions below follow the program's term by term (its
# quaternion helpers, its projection and its reprojection of cached
# candidates): the bucketed binning and the capacity cuts turn a last-bit
# difference of a radius or a depth into another list (one gaussian into
# another bucket, another gaussian cut at a tile's capacity), which moves a
# pixel by up to ~0.07 and a bounded count by one.  Everything past the
# projection (binning, caches, compositing, budget) is written here anew.
qmul = sr.qmul


def _normalize(q):
    return q / torch.clamp(torch.sqrt(torch.sum(q * q, dim=-1,
                                                keepdim=True)), min=1e-12)


def _cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def qrot(q, v):
    """Rotate vectors ``v`` (..., 3) by quaternions ``q`` (..., 4)."""
    q = _normalize(q)
    w, u = q[..., :1], q[..., 1:]
    t = 2.0 * _cross(u, v)
    return v + w * t + _cross(u, t)


def conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def _rows(q):
    """Rows of R(q), ``q`` normalised first."""
    q = _normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], dim=-1))


class View(NamedTuple):
    """A pinhole camera: its world-to-camera rotation (quaternion ``q`` and
    matrix ``R``) and translation ``t``, intrinsics, image size, and its
    centre in the world (for the SH view directions)."""
    q: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int
    center: torch.Tensor


def project(means, quats, log_scales, cam: View, dilate: float = 0.0):
    """EWA projection of gaussians (means (N, 3), wxyz quats, log-scales)
    under ``cam``: a dict of u, v, z, conic (N, 3), the 3σ radius
    ceil(3·sqrt(λmax)) + ``dilate``, det, the distance to the lens, and
    ``valid`` (in front of the near plane, det > 0, the dilated footprint
    on the image)."""
    R = cam.R
    p = (means[..., 0:1] * R[None, :, 0] + means[..., 1:2] * R[None, :, 1]
         + means[..., 2:3] * R[None, :, 2]) + cam.t
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r0, r1, r2 = _rows(qmul(cam.q[None], quats))
    sc = torch.exp(log_scales)
    m0, m1, m2 = r0 * sc, r1 * sc, r2 * sc
    zc = torch.clamp(z, min=NEAR)
    u = cam.fx * x / zc + cam.cx
    v = cam.fy * y / zc + cam.cy
    inv_z = 1.0 / zc
    inv_z2 = inv_z * inv_z
    j00, j02 = cam.fx * inv_z, -cam.fx * x * inv_z2
    j11, j12 = cam.fy * inv_z, -cam.fy * y * inv_z2
    a0 = j00[..., None] * m0 + j02[..., None] * m2
    a1 = j11[..., None] * m1 + j12[..., None] * m2

    def dot(a, b):
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
            + a[..., 2] * b[..., 2]
    a, b, c = dot(a0, a0) + sr.BLUR_2D, dot(a0, a1), dot(a1, a1) + sr.BLUR_2D
    det = a * c - b * b
    det_safe = torch.clamp(det, min=1e-12)
    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det_safe, min=0.01))
    r = torch.ceil(3.0 * torch.sqrt(lam)) + dilate
    valid = ((z > NEAR) & (det > 0.0) & (u + r > 0.0) & (u - r < cam.width)
             & (v + r > 0.0) & (v - r < cam.height))
    return dict(u=u, v=v, z=z, conic=conic, r=r, det=det, valid=valid,
                dist=torch.sqrt(x * x + y * y + z * z))


def projected(e) -> sr.Projected:
    """``splat_render``'s Projected of :func:`project`'s dict (the radius
    0 where not valid)."""
    return sr.Projected(torch.stack([e["u"], e["v"]], -1), e["z"],
                        e["conic"], torch.where(e["valid"], e["r"],
                                                torch.zeros_like(e["r"])),
                        e["valid"])


def reproject(means, quats, log_scales, cam: View):
    """The cached candidates' projection (means (T, K, 3) …) with the
    program's expressions for it: u, v, z, conic, the 3σ radius, det."""
    R, t = cam.R, cam.t
    mx, my, mz = means[..., 0], means[..., 1], means[..., 2]
    x = R[0, 0] * mx + R[0, 1] * my + R[0, 2] * mz + t[0]
    y = R[1, 0] * mx + R[1, 1] * my + R[1, 2] * mz + t[1]
    z = R[2, 0] * mx + R[2, 1] * my + R[2, 2] * mz + t[2]
    zc = torch.clamp(z, min=NEAR)
    u = cam.fx * x / zc + cam.cx
    v = cam.fy * y / zc + cam.cy
    pw, px, py, pz = cam.q[0], cam.q[1], cam.q[2], cam.q[3]
    rw, rx, ry, rz = (quats[..., i] for i in range(4))
    qw = pw * rw - px * rx - py * ry - pz * rz
    qx = pw * rx + px * rw + py * rz - pz * ry
    qy = pw * ry - px * rz + py * rw + pz * rx
    qz = pw * rz + px * ry - py * rx + pz * rw
    qn = torch.clamp(torch.sqrt(qw * qw + qx * qx + qy * qy + qz * qz),
                     min=1e-12)
    qw, qx, qy, qz = qw / qn, qx / qn, qy / qn, qz / qn
    s0, s1, s2 = (torch.exp(log_scales[..., i]) for i in range(3))
    m00 = (1 - 2 * (qy * qy + qz * qz)) * s0
    m01 = (2 * (qx * qy - qw * qz)) * s1
    m02 = (2 * (qx * qz + qw * qy)) * s2
    m10 = (2 * (qx * qy + qw * qz)) * s0
    m11 = (1 - 2 * (qx * qx + qz * qz)) * s1
    m12 = (2 * (qy * qz - qw * qx)) * s2
    m20 = (2 * (qx * qz - qw * qy)) * s0
    m21 = (2 * (qy * qz + qw * qx)) * s1
    m22 = (1 - 2 * (qx * qx + qy * qy)) * s2
    inv_z = 1.0 / zc
    inv_z2 = inv_z * inv_z
    j00, j02 = cam.fx * inv_z, -cam.fx * x * inv_z2
    j11, j12 = cam.fy * inv_z, -cam.fy * y * inv_z2
    a00, a01, a02 = j00 * m00 + j02 * m20, j00 * m01 + j02 * m21, \
        j00 * m02 + j02 * m22
    a10, a11, a12 = j11 * m10 + j12 * m20, j11 * m11 + j12 * m21, \
        j11 * m12 + j12 * m22
    a = a00 * a00 + a01 * a01 + a02 * a02 + sr.BLUR_2D
    b = a00 * a10 + a01 * a11 + a02 * a12
    c = a10 * a10 + a11 * a11 + a12 * a12 + sr.BLUR_2D
    det = a * c - b * b
    det_safe = torch.clamp(det, min=1e-12)
    inv_det = 1.0 / det_safe
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det_safe, min=0.01))
    return dict(u=u, v=v, z=z, det=det, r=torch.ceil(3.0 * torch.sqrt(lam)),
                conic=torch.stack([c * inv_det, -b * inv_det, a * inv_det],
                                  dim=-1))


def axis_angle(axis, angle):
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None],
                      axis * torch.sin(half)[..., None]], -1)


# --- the state ------------------------------------------------------------

class Arm(NamedTuple):
    q: torch.Tensor
    qd: torch.Tensor
    target_prev: torch.Tensor


class State(NamedTuple):
    """The program's state fields, by name."""
    arm: Arm
    block_pos: torch.Tensor
    block_yaw: torch.Tensor
    block_vel: torch.Tensor
    block_omega: torch.Tensor
    goal: torch.Tensor
    prev_eef_xy: torch.Tensor
    t: torch.Tensor


def as_state(s, dtype) -> State:
    """Any state with the program's field names, in ``dtype``."""
    return State(Arm(*(getattr(s.arm, k).to(dtype) for k in Arm._fields)),
                 *(getattr(s, k).to(dtype) for k in State._fields[1:]))


class Reference:
    """The deployment's plain reference in one dtype (float32; bfloat16 for
    the control).  ``leaves`` maps :data:`FIELDS` to the scene's tensors
    and ``link_ids`` (N,) names each gaussian's body: 0 static, k the
    chain's link k − 1, the last the block."""

    def __init__(self, cfg: dict, leaves: dict, link_ids,
                 dtype=torch.float32):
        self.cfg, self.dtype = cfg, dtype
        self.lv = {k: leaves[k].detach().to(dtype) for k in FIELDS}
        dev = self.dev = self.lv["means"].device
        self.chain = load_chain(ROOT / cfg["urdf"])
        ch = self.chain

        def t(a):
            return torch.as_tensor(np.asarray(a), device=dev).to(dtype)
        self.c = dict(oq=t(ch.origin_q), ot=t(ch.origin_t), axis=t(ch.axis),
                      lo=t(np.where(np.isfinite(ch.lower), ch.lower, -1e6)),
                      hi=t(np.where(np.isfinite(ch.upper), ch.upper, 1e6)),
                      vmax=t(np.where(np.isfinite(ch.vmax), ch.vmax, 1e6)))
        ph = cfg["physics"]
        bk = ph["block"]
        cb = [(-bk["crossbar_half_x"], -bk["crossbar_half_y"]),
              (bk["crossbar_half_x"], -bk["crossbar_half_y"]),
              (bk["crossbar_half_x"], bk["crossbar_half_y"]),
              (-bk["crossbar_half_x"], bk["crossbar_half_y"])]
        st = [(-bk["stem_half_x"], bk["stem_y0"]),
              (bk["stem_half_x"], bk["stem_y0"]),
              (bk["stem_half_x"], bk["stem_y1"]),
              (-bk["stem_half_x"], bk["stem_y1"])]
        self.polys = t(np.asarray([cb, st], np.float32))
        self.cog = t([0.0, bk["cog_y"]])
        self.eef = ch.names.index(cfg["eef_link"])
        ids = torch.as_tensor(link_ids, device=dev).long()
        self.stat = torch.nonzero(ids == 0)[:, 0]
        self.dyn = torch.nonzero(ids > 0)[:, 0]
        self.dyn_body = ids[self.dyn]
        # rest poses (bodies 1..L the links at q = 0, L + 1 the block)
        rq, rt = self.fk(torch.zeros((1, len(ch.lower)), dtype=dtype,
                                     device=dev))
        one = t([[1.0, 0.0, 0.0, 0.0]])
        self.rest_q = torch.cat([one, rq[0], one])
        self.rest_t = torch.cat([t([[0.0, 0.0, 0.0]]), rt[0],
                                 t([cfg["block_rest"]])])
        H, W = cfg["render_size"]
        self.H, self.W = int(H), int(W)
        self.ts = int(cfg["tile_size"])
        self.tx, self.ty = -(-self.W // self.ts), -(-self.H // self.ts)
        self.degree = int(cfg["sh_degree"])
        self.black = torch.zeros(3, dtype=dtype, device=dev)
        vp = cfg["viewport"]
        self.view_cam = self.camera(t(vp["q"]), t(vp["t"]))
        self._static_view = None

    # --- physics --------------------------------------------------------
    def fk(self, q):
        """World poses (B, L, 4) wxyz and (B, L, 3) of every link."""
        ch, c = self.chain, self.c
        B = q.shape[0]
        qs = [torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=q.dtype,
                           device=q.device).expand(B, 4)]
        ts = [q.new_zeros((B, 3))]
        for i in range(1, len(ch.names)):
            lq = c["oq"][i].expand(B, 4)
            if ch.qidx[i] >= 0:
                lq = qmul(lq, axis_angle(c["axis"][i], q[:, ch.qidx[i]]))
            p = ch.parent[i]
            qs.append(qmul(qs[p], lq))
            ts.append(qrot(qs[p], c["ot"][i].expand(B, 3)) + ts[p])
        return torch.stack(qs, 1), torch.stack(ts, 1)

    def eef_xy(self, q):
        return self.fk(q)[1][:, self.eef, :2]

    def pd_step(self, arm: Arm, target) -> Arm:
        ph, c = self.cfg["physics"], self.c
        dt, n = ph["time_step"], int(ph["arm_substeps"])
        qd_des = (target - arm.target_prev) / dt
        h = dt / n
        q, qd = arm.q, arm.qd
        for _ in range(n):
            acc = ph["kp"] * (target - q) + ph["kd"] * (qd_des - qd)
            qd = torch.minimum(torch.maximum(qd + acc * h, -c["vmax"]),
                               c["vmax"])
            q = torch.minimum(torch.maximum(q + qd * h, c["lo"]), c["hi"])
        return Arm(q, qd, target)

    def block_substep(self, s: State, exy, evel, h) -> State:
        ph = self.cfg["physics"]
        bk = ph["block"]
        ang = s.block_yaw
        polys = s.block_pos[:, None, None, :] + pp._rotate2d(
            ang[:, None, None], self.polys)                     # (B, 2, 4, 2)
        cs = [pp._circle_poly(exy, ph["eef_radius"], polys[:, i], evel,
                              bk["mu"]) for i in range(2)]
        ct = pp.Contact(*(torch.stack(f, 1) for f in zip(*cs)))
        ct = ct._replace(normal=-ct.normal)
        cog = s.block_pos + pp._rotate2d(ang, self.cog)
        bias = 1.0 - ((1.0 - 0.1) ** 60.0) ** h
        zero2 = torch.zeros_like(cog)
        v, w, vb, wb = pp._solve(cog, zero2, torch.zeros_like(ang), ct,
                                 1.0 / bk["mass"], 1.0 / bk["izz"], h,
                                 int(ph["pgs_iterations"]), bias,
                                 ph["contact_slop"])
        new_cog = cog + (v + vb) * h
        new_yaw = ang + (w + wb) * h
        return s._replace(block_pos=new_cog - pp._rotate2d(new_yaw, self.cog),
                          block_yaw=new_yaw, block_vel=v, block_omega=w)

    def step(self, state, action) -> State:
        """One control step of every env from ``state`` (the program's)."""
        ph = self.cfg["physics"]
        s = as_state(state, self.dtype)
        a = action.to(self.dtype)
        prev = self.eef_xy(s.arm.q)
        s = s._replace(arm=self.pd_step(s.arm, a), t=s.t + ph["time_step"])
        new = self.eef_xy(s.arm.q)
        vel = (new - prev) / ph["time_step"]
        n = int(ph["contact_substeps"])
        h = ph["time_step"] / n
        for i in range(n):
            s = self.block_substep(s, prev + (i + 1.0) / n * (new - prev),
                                   vel, h)
        return s._replace(prev_eef_xy=new)

    # --- cameras and posing ---------------------------------------------
    def camera(self, q, t) -> View:
        """The pinhole camera at camera-to-world pose (q wxyz, t)."""
        wq = conj(_normalize(q))
        q2 = _normalize(wq)
        w, x, y, z = q2[0], q2[1], q2[2], q2[3]
        xx, yy, zz = x * x, y * y, z * z
        wx, wy, wz = w * x, w * y, w * z
        xy, xz, yz = x * y, x * z, y * z
        R = torch.stack([1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz),
                         2.0 * (xz + wy), 2.0 * (xy + wz),
                         1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
                         2.0 * (xz - wy), 2.0 * (yz + wx),
                         1.0 - 2.0 * (xx + yy)]).reshape(3, 3)
        half = 0.5 * torch.tensor(self.cfg["fov"], dtype=self.dtype,
                                  device=self.dev)
        f = 0.5 * self.H / torch.tan(half)

        def scalar(v):
            return torch.tensor(v, dtype=self.dtype, device=self.dev)
        return View(wq, R, -qrot(wq, t), f, f, scalar(self.W / 2.0),
                    scalar(self.H / 2.0), self.W, self.H, t)

    def eef_camera(self, q_arm) -> View:
        """One env's end-effector camera, joints ``q_arm`` (ndof,)."""
        return self.camera(*self._eef_pose(q_arm))

    def _eef_pose(self, q_arm):
        """The end-effector camera's pose: the link's, its offset's
        translation in world axes."""
        lq, lt = self.fk(q_arm.to(self.dtype)[None])
        off = self.cfg["eef_camera"]
        oq = torch.tensor(off["q"], dtype=self.dtype, device=self.dev)
        ot = torch.tensor(off["t"], dtype=self.dtype, device=self.dev)
        return qmul(lq[0, self.eef], oq), lt[0, self.eef] + ot

    def posed(self, s: State, b: int):
        """Means and quats of env b's dynamic gaussians at state ``s``."""
        lq, lt = self.fk(s.arm.q[b:b + 1].to(self.dtype))
        yaw = s.block_yaw[b].to(self.dtype)
        z = torch.tensor([0.0, 0.0, 1.0], dtype=self.dtype, device=self.dev)
        bq = axis_angle(z, yaw)[None]
        bt = torch.cat([s.block_pos[b].to(self.dtype), yaw.new_zeros(1)])[None]
        one = torch.tensor([[1.0, 0.0, 0.0, 0.0]], dtype=self.dtype,
                           device=self.dev)
        pq = torch.cat([one, lq[0], bq])
        pt = torch.cat([torch.zeros_like(bt), lt[0], bt])
        inv_q = conj(_normalize(self.rest_q))
        rel_q = qmul(pq, inv_q)
        rel_t = qrot(pq, -qrot(inv_q, self.rest_t)) + pt
        k = self.dyn_body
        d = self.dyn
        return (qrot(rel_q[k], self.lv["means"][d]) + rel_t[k],
                qmul(rel_q[k], self.lv["quats"][d]))

    # --- the viewport ---------------------------------------------------
    def _bin(self, proj, capacity, max_tiles):
        return sr.bin_tiles(proj, self.ts, self.tx, self.ty, capacity,
                            max_tiles, self.cfg["buckets"])

    def _composite(self, lists):
        key = torch.where(lists[..., 9] > 0, lists[..., 8],
                          torch.full_like(lists[..., 8], math.inf))
        order = torch.sort(key, dim=1, stable=True).indices
        merged = torch.gather(lists, 1, order[..., None].expand_as(lists))
        return sr.composite(merged, self.ts, self.tx, self.ty, self.H,
                            self.W, self.cfg["sigma_cutoff"], self.black)

    def _dyn_lists(self, means, quats, cam):
        """(fields (T, Kd, 10), Lists) of one env's posed dynamics."""
        c, lv, d = self.cfg, self.lv, self.dyn
        proj = projected(project(means, quats, lv["log_scales"][d], cam))
        cols = sr.sh_colors(lv["sh_dc"][d], lv["sh_rest"][d], means, cam,
                            self.degree)
        lists = self._bin(proj, int(c["dyn_capacity"]),
                          int(c["dyn_max_tiles"]))
        return sr.fields(proj, cols, torch.sigmoid(lv["logit_opacities"][d]),
                         lists.ids), lists

    def viewport(self, s: State, b: int):
        """(image (3, H, W), severe, bounded) of env b's viewport."""
        c, lv, cam = self.cfg, self.lv, self.view_cam
        if self._static_view is None:
            st = self.stat
            proj = projected(project(lv["means"][st], lv["quats"][st],
                                     lv["log_scales"][st], cam))
            cols = sr.sh_colors(lv["sh_dc"][st], lv["sh_rest"][st],
                                lv["means"][st], cam, self.degree)
            lists = self._bin(proj, int(c["tile_capacity"]),
                              int(c["max_tiles_per_gaussian"]))
            self._static_view = sr.fields(
                proj, cols, torch.sigmoid(lv["logit_opacities"][st]),
                lists.ids)
        means, quats = self.posed(s, b)
        dyn, lists = self._dyn_lists(means, quats, cam)
        img = self._composite(torch.cat([self._static_view, dyn], 1))
        severe = max(0, int((lists.counts > 0).sum()) - int(c["sel_tiles"]))
        bounded = (int((lists.counts > int(c["dyn_capacity"])).sum())
                   + lists.slot_truncated)
        return img, severe, bounded

    # --- the end-effector camera ----------------------------------------
    def build(self, q_arm, lists: bool = True) -> dict:
        """One env's candidate cache at joints ``q_arm``: the candidate
        lists, the near set and the build-time counts (without ``lists``
        none of them), and the margin-budget statistics."""
        c = self.cfg
        cam = self.eef_camera(q_arm)
        margin, z_split, t_max = (float(c["margin"]), float(c["z_split"]),
                                  float(c["t_max"]))
        ts, tx, ty = self.ts, self.tx, self.ty
        lv, st = self.lv, self.stat
        e = project(lv["means"][st], lv["quats"][st], lv["log_scales"][st],
                    cam, dilate=margin)
        u, v, z, rd = e["u"], e["v"], e["z"], e["r"]
        r = rd - margin
        near = (z < z_split) & (z > -t_max) if z_split > 0 \
            else torch.zeros_like(z, dtype=torch.bool)
        valid = e["valid"] & ~near
        proj = sr.Projected(torch.stack([u, v], -1), z, e["conic"],
                            torch.where(valid, rd, torch.zeros_like(rd)),
                            valid)
        # every bucket widened by the dilation's extra tiles a side
        extra = -(-int(2 * margin) // ts) + 1
        buckets = [((int(round(m ** 0.5)) + extra) ** 2, f)
                   for m, f in c["buckets"]]
        m_max = max(m for m, _ in buckets)
        kc = int(c["kc"])
        out = {}
        if lists:
            bins = sr.bin_tiles(proj, ts, tx, ty, kc, m_max, buckets)
            cap = min(int(c["near_cap"]) if z_split > 0 else 8,
                      self.stat.numel())
            order = torch.sort((~near).to(torch.int32), stable=True).indices
            n_near = int(near.sum())
            out = dict(
                ids=bins.ids,
                truncated=int((bins.counts > kc).sum()) + bins.slot_truncated,
                near=order[:cap],
                near_live=torch.arange(cap, device=self.dev) < n_near,
                near_over=max(0, n_near - cap))
        # margin statistics over the counted gaussians (not the near set,
        # not those whose dilated footprint covers the whole grid)
        full = ((u - rd <= ts) & (u + rd >= (tx - 1) * ts)
                & (v - rd <= ts) & (v + rd >= (ty - 1) * ts))
        counted = (z > max(NEAR, z_split)) & (e["det"] > 0) & ~full
        f = torch.maximum(cam.fx, cam.fy)
        g = torch.maximum((u - cam.cx).abs(), (v - cam.cy).abs())
        gap_x = torch.clamp(torch.maximum(-(u + rd), (u - rd) - self.W),
                            min=0.0)
        gap_y = torch.clamp(torch.maximum(-(v + rd), (v - rd) - self.H),
                            min=0.0)
        allow = (margin - 1.0) + torch.maximum(gap_x, gap_y)
        P = torch.where(counted, (f + g + 2.0 * r)
                        / torch.clamp(z, min=NEAR), torch.zeros_like(z))
        inf = torch.full_like(z, math.inf)
        behind = z <= (NEAR if z_split <= 0 else -t_max)
        gap = NEAR - z
        q_cam, t_cam = self._eef_pose(q_arm)
        return dict(
            out, q=q_cam, t=t_cam,
            s_trans=float((P / allow).max()),
            s_rot=float((P * e["dist"] / allow).max()),
            z_min=float(torch.where(counted, z, inf).min()),
            near_gap=float(torch.where(behind, gap, inf).min()),
            g_gap=float(torch.where(behind, e["dist"] / gap,
                                    torch.zeros_like(z)).max()))

    def budget_used(self, cache: dict, q_arm) -> float:
        """Share of ``cache``'s margin budget the camera at joints
        ``q_arm`` uses (past 1 the cache may miss gaussians)."""
        q, t = self._eef_pose(q_arm)
        dq = float((cache["q"] * q).sum().abs())
        theta = 2.0 * math.acos(min(max(dq, 0.0), 1.0))
        dt = float((t - cache["t"]).norm())
        sin_h = math.sin(min(theta / 2.0, math.pi / 2.0))
        z_min = cache["z_min"]
        if math.isfinite(z_min):
            corr = z_min / max(z_min - dt, 1e-12) if dt < z_min else math.inf
            used_far = corr * (dt * cache["s_trans"] + 2.0 * sin_h
                               * (cache["s_rot"] + dt * cache["s_trans"]))
        else:
            used_far = 0.0
        used_gap = dt / cache["near_gap"] + 2.0 * sin_h * cache["g_gap"]
        return max(used_far, used_gap)

    def eef_frame(self, cache: dict, s: State, b: int):
        """(image (3, H, W), severe, bounded) of env b's end-effector
        camera at state ``s`` over ``cache``."""
        c, lv = self.cfg, self.lv
        cam = self.eef_camera(s.arm.q[b])
        ts, tx = self.ts, self.tx
        # the candidates, reprojected and kept where they touch their tile
        ids = cache["ids"]                                   # (T, kc)
        g = self.stat[ids.clamp(min=0)]
        T, kc = ids.shape
        e = reproject(lv["means"][g], lv["quats"][g], lv["log_scales"][g],
                      cam)
        tile = torch.arange(T, device=self.dev)[:, None]
        ox = ((tile % tx) * ts).to(self.dtype)
        oy = ((tile // tx) * ts).to(self.dtype)
        u, v, r = e["u"], e["v"], e["r"]
        touches = ((u + r > ox) & (u - r < ox + ts) & (v + r > oy)
                   & (v - r < oy + ts))
        op = torch.clamp(torch.sigmoid(lv["logit_opacities"][g]), 0.0, 1.0)
        op = torch.where((ids >= 0) & (e["z"] > NEAR) & (e["det"] > 0)
                         & touches, op, torch.zeros_like(op))
        flat = g.reshape(-1)
        cols = sr.sh_colors(lv["sh_dc"][flat], lv["sh_rest"][flat],
                            lv["means"][flat], cam, self.degree).reshape(
                                T, kc, 3)
        cand = torch.cat([u[..., None], v[..., None], e["conic"], cols,
                          e["z"][..., None], op[..., None]], -1)
        # the env's dynamics and the near set, binned afresh
        means, quats = self.posed(s, b)
        nidx = self.stat[cache["near"]]
        live = torch.cat([torch.ones(self.dyn.numel(), dtype=torch.bool,
                                     device=self.dev), cache["near_live"]])
        all_means = torch.cat([means, lv["means"][nidx]])
        proj = projected(project(all_means,
                                 torch.cat([quats, lv["quats"][nidx]]),
                                 torch.cat([lv["log_scales"][self.dyn],
                                            lv["log_scales"][nidx]]), cam))
        proj = proj._replace(valid=proj.valid & live,
                             radius=torch.where(live, proj.radius,
                                                torch.zeros_like(proj.radius)))
        sh_dc = torch.cat([lv["sh_dc"][self.dyn], lv["sh_dc"][nidx]])
        sh_rest = torch.cat([lv["sh_rest"][self.dyn], lv["sh_rest"][nidx]])
        cols = sr.sh_colors(sh_dc, sh_rest, all_means, cam, self.degree)
        opac = torch.sigmoid(torch.cat([lv["logit_opacities"][self.dyn],
                                        lv["logit_opacities"][nidx]]))
        opac = torch.where(live, opac, torch.zeros_like(opac))
        lists = self._bin(proj, int(c["dyn_capacity"]),
                          int(c["dyn_max_tiles"]))
        dyn = sr.fields(proj, cols, opac, lists.ids)
        img = self._composite(torch.cat([cand, dyn], 1))
        severe = cache["near_over"] + int(
            self.budget_used(cache, s.arm.q[b])
            > float(c["rebuild_budget"]) + float(c["rebuild_band"]))
        bounded = (int((lists.counts > int(c["dyn_capacity"])).sum())
                   + lists.slot_truncated + cache["truncated"])
        return img, severe, bounded

    def frames(self, state, build_q, envs):
        """Both cameras of ``envs`` at ``state`` (the end-effector camera's
        cache built at joints ``build_q`` (B, ndof)): images (len(envs), 3,
        H, W) of the end-effector camera and of the viewport, and the
        severe and bounded counts summed over them."""
        s = as_state(state, self.dtype)
        eef, view, severe, bounded = [], [], 0, 0
        with torch.no_grad():
            for b in envs:
                img, sv, bd = self.eef_frame(self.build(build_q[b]), s, b)
                eef.append(img)
                severe, bounded = severe + sv, bounded + bd
                img, sv, bd = self.viewport(s, b)
                view.append(img)
                severe, bounded = severe + sv, bounded + bd
        return torch.stack(eef), torch.stack(view), severe, bounded
