"""SE(3) and Sim(3) transforms on torch tensors.

Port of ``sim_a_splat_tpu/ops/transforms.py``: a pose is a plain
``(quat wxyz, translation)`` pair with any leading batch shape; ``Sim3``
adds the scale of the offline ICP similarity (s·R | t), factored out of a
4×4 matrix with the reference's orthogonality and isotropy checks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sim_a_splat_torch.ops import quaternion as quat


def _matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) homogeneous matrices from (..., 3, 3) blocks and
    (..., 3) translations."""
    m = t.new_zeros(t.shape[:-1] + (4, 4))
    m[..., :3, :3] = R
    m[..., :3, 3] = t
    m[..., 3, 3] = 1.0
    return m


class SE3(NamedTuple):
    """Rigid transform: x ↦ R(q) x + t.  Batchable: (..., 4) / (..., 3)."""

    q: torch.Tensor  # wxyz quaternion
    t: torch.Tensor  # translation

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32,
                 device="cpu") -> "SE3":
        q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)
        return SE3(q.expand(tuple(batch_shape) + (4,)),
                   torch.zeros(tuple(batch_shape) + (3,), dtype=dtype,
                               device=device))

    @staticmethod
    def from_matrix(m: torch.Tensor) -> "SE3":
        return SE3(quat.from_rotation_matrix(m[..., :3, :3]), m[..., :3, 3])

    def as_matrix(self) -> torch.Tensor:
        return _matrix(quat.to_rotation_matrix(self.q), self.t)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Apply to points x (..., 3)."""
        return quat.rotate(self.q, x) + self.t

    def compose(self, other: "SE3") -> "SE3":
        """self ∘ other (apply ``other`` first); batch shapes broadcast."""
        return SE3(quat.multiply(self.q, other.q),
                   quat.rotate(self.q, other.t) + self.t)

    def inverse(self) -> "SE3":
        qinv = quat.conjugate(quat.normalize(self.q))
        return SE3(qinv, -quat.rotate(qinv, self.t))

    def rotation_matrix(self) -> torch.Tensor:
        return quat.to_rotation_matrix(self.q)

    def to(self, device) -> "SE3":
        return SE3(self.q.to(device), self.t.to(device))


class Sim3(NamedTuple):
    """Similarity transform: x ↦ s·R(q) x + t (the shape of the offline ICP
    registration, whose 4×4 matrix has rotation block s·R)."""

    q: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor  # scalar (or batch of scalars)

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32,
                 device="cpu") -> "Sim3":
        se3 = SE3.identity(batch_shape, dtype, device)
        return Sim3(se3.q, se3.t, torch.ones(tuple(batch_shape), dtype=dtype,
                                             device=device))

    @staticmethod
    def from_matrix(m, rtol: float = 1e-5, device="cpu") -> "Sim3":
        """Factor a 4×4 similarity matrix into (q, t, s), checked on the host
        in float64 as the reference checks it: (sR)ᵀ(sR) must be s²·I
        (off-diagonal below 1e-5, the diagonal isotropic within
        1e-5 + rtol·s²); raises ``ValueError`` otherwise."""
        m = np.asarray(m.detach().cpu() if torch.is_tensor(m) else m,
                       dtype=np.float64)
        cR = m[:3, :3]
        cI = cR.T @ cR
        off = cI[~np.eye(3, dtype=bool)]
        if not np.all(np.abs(off) < 1e-5):
            raise ValueError("similarity matrix rotation block not "
                             f"orthogonal: off-diag {off}")
        s2 = float(np.mean(np.diag(cI)))
        if not np.all(np.abs(np.diag(cI) - s2) < 1e-5 + rtol * s2):
            raise ValueError("similarity matrix scale is anisotropic")
        s = float(np.sqrt(s2))

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return Sim3(quat.from_rotation_matrix(f32(cR / s)), f32(m[:3, 3]),
                    f32(s))

    def se3(self) -> SE3:
        """The rigid part (scale dropped)."""
        return SE3(self.q, self.t)

    def inverse(self) -> "Sim3":
        qinv = quat.conjugate(quat.normalize(self.q))
        s_inv = 1.0 / self.s
        return Sim3(qinv, -s_inv * quat.rotate(qinv, self.t), s_inv)

    def compose(self, other: "Sim3") -> "Sim3":
        """self ∘ other (apply ``other`` first): s₁R₁(s₂R₂x + t₂) + t₁."""
        return Sim3(quat.multiply(self.q, other.q),
                    self.s * quat.rotate(self.q, other.t) + self.t,
                    self.s * other.s)

    def compose_se3(self, other: SE3) -> "Sim3":
        return self.compose(Sim3(other.q, other.t, torch.ones_like(self.s)))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        s = self.s[..., None] if self.s.dim() else self.s
        return s * quat.rotate(self.q, x) + self.t

    def as_matrix(self) -> torch.Tensor:
        return _matrix(quat.to_rotation_matrix(self.q) * self.s, self.t)
