"""Articulated splat scene graph.

Port of ``SceneGraph`` (``sim_a_splat_tpu/scenegraph/graph.py``): a scene,
one body id per gaussian (0 = static background) and the inverse rest pose
of every body; posing moves each gaussian by its body's X_l · X_l,rest⁻¹.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.ops.transforms import SE3
from sim_a_splat_torch.splat.scene import GaussianScene


class SceneGraph(NamedTuple):
    """Splat scene + per-gaussian body assignment, all world-frame."""

    scene: GaussianScene
    link_ids: torch.Tensor   # (N,) int64, 0 = static
    rest_inv: SE3            # (L+1,) batched; index 0 = identity

    def posed(self, body_poses: SE3) -> GaussianScene:
        """Scene with every gaussian moved to its body's pose; ``body_poses``
        is (..., L+1) batched and the result gains its leading dims."""
        rel = body_poses.compose(self.rest_inv)
        q_g = rel.q[..., self.link_ids, :]
        t_g = rel.t[..., self.link_ids, :]
        s = self.scene
        return s._replace(means=quat.rotate(q_g, s.means) + t_g,
                          quats=quat.multiply(q_g, s.quats))
