"""SE(3) transforms on torch tensors.

Port of ``SE3`` from ``sim_a_splat_tpu/ops/transforms.py``: a pose is a
plain ``(quat wxyz, translation)`` pair with any leading batch shape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sim_a_splat_torch.ops import quaternion as quat


class SE3(NamedTuple):
    """Rigid transform: x ↦ R(q) x + t.  Batchable: (..., 4) / (..., 3)."""

    q: torch.Tensor  # wxyz quaternion
    t: torch.Tensor  # translation

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
