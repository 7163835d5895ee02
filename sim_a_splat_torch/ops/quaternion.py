"""Batched quaternion math (wxyz convention) on torch tensors.

Port of ``sim_a_splat_tpu/ops/quaternion.py`` (the functions the pushT step
needs).  Every function takes arbitrary leading batch dimensions.  The
expressions keep the reference's operation order so float32 rounding
matches it term by term.
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
