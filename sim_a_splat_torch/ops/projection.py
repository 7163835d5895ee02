"""Perspective camera model and EWA splat projection (float32 throughout).

Port of ``sim_a_splat_tpu/ops/projection.py``: ``Camera.from_fov``,
``Projected``, ``project_raw`` (with ``_rotation_rows`` and
``_finish_projection``) and ``view_directions``.  Conventions follow gsplat
"classic" mode: OpenCV camera-to-world pose, pinhole intrinsics, 2-D
covariance J W Σ Wᵀ Jᵀ + 0.3·I, radius = ceil(3·sqrt(λmax)).

Everything stays float32: screen coordinates reach 512 px and the conic
enters ``exp`` (``PRECISION.md``).  No matrix product goes through
``torch.matmul``: the 3×3 camera rotation is applied as three explicit
row sums, so TF32 can never touch it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.ops.transforms import SE3

# gsplat classic-mode screen-space dilation of the 2-D covariance diagonal
BLUR_2D = 0.3


@dataclass(frozen=True)
class Camera:
    """Pinhole camera. ``pose`` maps camera coords → world coords (OpenCV).
    ``fx, fy, cx, cy`` are 0-d float32 tensors on the camera's device."""

    pose: SE3
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int = 256
    height: int = 256

    @staticmethod
    def from_fov(pose: SE3, fov_y: float, width: int, height: int) -> "Camera":
        """Build from a vertical field of view (radians), square pixels."""
        dev = pose.t.device
        half = 0.5 * torch.tensor(fov_y, dtype=torch.float32, device=dev)
        fy = 0.5 * height / torch.tan(half)
        f32 = dict(dtype=torch.float32, device=dev)
        return Camera(pose=pose, fx=fy, fy=fy,
                      cx=torch.tensor(width / 2.0, **f32),
                      cy=torch.tensor(height / 2.0, **f32),
                      width=width, height=height)


class Projected(NamedTuple):
    """Per-gaussian screen-space quantities (leading batch dims allowed)."""

    xy: torch.Tensor       # (..., N, 2) pixel coords of the projected mean
    depth: torch.Tensor    # (..., N) camera-frame z
    conic: torch.Tensor    # (..., N, 3) upper triangle (a, b, c) of Σ₂⁻¹
    radius: torch.Tensor   # (..., N) 3σ screen radius in pixels (0 ⇒ culled)
    valid: torch.Tensor    # (..., N) bool


def _apply_rotation(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``v @ R.T`` for a (3, 3) ``R`` as explicit float32 row sums."""
    return (v[..., 0:1] * R[:, 0] + v[..., 1:2] * R[:, 1]
            + v[..., 2:3] * R[:, 2])


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _finish_projection(p_cam, m0, m1, m2, camera: Camera, near: float,
                       eps2d: float) -> Projected:
    """Perspective Jacobian, 2-D conic, radius and culling from camera-frame
    means and the rows of M = R_cam·S (Σ_cam = M Mᵀ)."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    zc = torch.clamp(z, min=near)
    u = camera.fx * x / zc + camera.cx
    v = camera.fy * y / zc + camera.cy
    xy = torch.stack([u, v], dim=-1)

    inv_z = 1.0 / zc
    inv_z2 = inv_z * inv_z
    j00 = camera.fx * inv_z
    j02 = -camera.fx * x * inv_z2
    j11 = camera.fy * inv_z
    j12 = -camera.fy * y * inv_z2

    a0 = j00[..., None] * m0 + j02[..., None] * m2
    a1 = j11[..., None] * m1 + j12[..., None] * m2
    a = _dot3(a0, a0) + eps2d
    b = _dot3(a0, a1)
    c = _dot3(a1, a1) + eps2d

    det = a * c - b * b
    det_safe = torch.clamp(det, min=1e-12)
    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det_safe, min=0.01))
    radius = torch.ceil(3.0 * torch.sqrt(lam))

    valid = (z > near) & (det > 0.0)
    inside = ((u + radius > 0.0) & (u - radius < camera.width)
              & (v + radius > 0.0) & (v - radius < camera.height))
    valid = valid & inside
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return Projected(xy=xy, depth=z, conic=conic, radius=radius, valid=valid)


def _rotation_rows(q: torch.Tensor):
    """Rows of R(q) for batched wxyz quaternions (normalizing q)."""
    q = quat.normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                      2 * (x * z + w * y)], dim=-1)
    r1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                      2 * (y * z - w * x)], dim=-1)
    r2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                      1 - 2 * (x * x + y * y)], dim=-1)
    return r0, r1, r2


def project_raw(means: torch.Tensor, quats: torch.Tensor,
                log_scales: torch.Tensor, camera: Camera, near: float = 0.01,
                eps2d: float = BLUR_2D) -> Projected:
    """EWA projection straight from raw gaussian parameters: with
    M = R_w2c·R(q)·S, Σ₂ = (J M)(J M)ᵀ + eps2d·I, no (N, 3, 3) temps."""
    w2c = camera.pose.inverse()
    R = w2c.rotation_matrix()
    p_cam = _apply_rotation(R, means) + w2c.t
    q_cam = quat.multiply(w2c.q, quats)
    r0, r1, r2 = _rotation_rows(q_cam)
    s = torch.exp(log_scales)
    return _finish_projection(p_cam, r0 * s, r1 * s, r2 * s, camera, near,
                              eps2d)


def view_directions(means: torch.Tensor, camera: Camera) -> torch.Tensor:
    """Unit directions camera-origin → gaussian (for SH evaluation)."""
    d = means - camera.pose.t
    return d / torch.clamp(quat.norm(d), min=1e-12)
