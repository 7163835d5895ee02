"""Batched quaternion math (wxyz convention) on torch tensors.

Port of ``sim_a_splat_tpu/ops/quaternion.py``, every function.  Every
function takes arbitrary leading batch dimensions.  The expressions keep
the reference's operation order so float32 rounding matches it term by
term.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, kept as a size-1 axis."""
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize quaternion(s) to unit norm. Shape (..., 4), wxyz."""
    return q / torch.clamp(norm(q), min=_EPS)


def to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) wxyz → rotation matrix (..., 3, 3)."""
    q = normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    r = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def from_rotation_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) → unit quaternion (..., 4) wxyz, w ≥ 0:
    the four Shepperd candidates, each taken where its seed (the largest
    diagonal combination) is largest, as the reference selects them."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def seeded(v):
        return torch.sqrt(torch.clamp(v, min=_EPS)) * 2.0

    sw = seeded(1.0 + tr)
    qw = torch.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw,
                      (m10 - m01) / sw], dim=-1)
    sx = seeded(1.0 + m00 - m11 - m22)
    qx = torch.stack([(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx,
                      (m02 + m20) / sx], dim=-1)
    sy = seeded(1.0 - m00 + m11 - m22)
    qy = torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy,
                      (m12 + m21) / sy], dim=-1)
    sz = seeded(1.0 - m00 - m11 + m22)
    qz = torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz,
                      0.25 * sz], dim=-1)
    seeds = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                         m22 - m00 - m11], dim=-1)
    choice = torch.argmax(seeds, dim=-1)          # first of equal seeds
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4)
    q = torch.gather(cands, -2, choice[..., None, None].expand(
        *choice.shape, 1, 4))[..., 0, :]
    q = torch.where(q[..., :1] < 0.0, -q, q)       # canonical sign: w ≥ 0
    return normalize(q)


def multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2 (both (..., 4), wxyz; broadcasting)."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3-vector cross product over the last axis (broadcasting)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4), normalizing q
    (the 2-cross-product formula)."""
    q = normalize(q)
    w = q[..., :1]
    u = q[..., 1:]
    t = 2.0 * cross(u, v)
    return v + w * t + cross(u, t)


def from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit axis (..., 3) and angle (...,) → quaternion (..., 4)."""
    half = 0.5 * angle
    return torch.cat(
        [torch.cos(half)[..., None], axis * torch.sin(half)[..., None]],
        dim=-1)


def to_angle_axis(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) wxyz → angle-axis vector (..., 3); where
    sin(θ/2) < 1e-6 the scale takes its Taylor value 2."""
    q = normalize(q)
    w = q[..., 0]
    v = q[..., 1:]
    sin_half = norm(v)[..., 0]
    half = torch.atan2(torch.where(w < 0, -sin_half, sin_half),
                       torch.where(w < 0, -w, w))
    small = sin_half < 1e-6
    k = torch.where(small, torch.full_like(half, 2.0),
                    2.0 * half / torch.clamp(sin_half, min=_EPS))
    return v * k[..., None]


def from_angle_axis(aa: torch.Tensor) -> torch.Tensor:
    """Angle-axis vector (..., 3) → quaternion (..., 4) wxyz (the sinc's
    Taylor value for θ < 1e-6)."""
    theta = norm(aa)[..., 0]
    half = 0.5 * theta
    small = theta < 1e-6
    s = torch.where(small, 0.5 - theta * theta / 48.0,
                    torch.sin(half) / torch.clamp(theta, min=_EPS))
    return torch.cat([torch.cos(half)[..., None], aa * s[..., None]], dim=-1)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) → (..., 3, 3) cross-product matrices [v]×."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zeros = torch.zeros_like(x)
    return torch.stack([zeros, -z, y, z, zeros, -x, -y, x, zeros],
                       dim=-1).reshape(v.shape[:-1] + (3, 3))


def angle_axis_to_rotation_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Angle-axis (..., 3) → rotation matrix (..., 3, 3) by Rodrigues; for
    θ < 1e-6 the first-order I + [aa]×."""
    theta = norm(aa)[..., 0]
    small = theta < 1e-6
    K = _skew(aa / torch.clamp(theta, min=_EPS)[..., None])
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    s, c = torch.sin(theta), torch.cos(theta)
    KK = (K[..., :, :, None] * K[..., None, :, :]).sum(-2)   # K @ K, exact f32
    R_full = eye + s[..., None, None] * K + (1.0 - c)[..., None, None] * KK
    return torch.where(small[..., None, None], eye + _skew(aa), R_full)


def from_rpy(rpy: torch.Tensor) -> torch.Tensor:
    """Roll-pitch-yaw (..., 3) → quaternion, Drake's ``RollPitchYaw``
    convention R = Rz(y)·Ry(p)·Rx(r)."""
    r, p, y = rpy[..., 0] * 0.5, rpy[..., 1] * 0.5, rpy[..., 2] * 0.5
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    ], dim=-1)


def to_rpy(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) → roll-pitch-yaw (..., 3), inverse of
    :func:`from_rpy`."""
    q = normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)
