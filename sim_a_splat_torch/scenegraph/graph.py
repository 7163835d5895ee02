"""Articulated splat scene graph.

Port of ``sim_a_splat_tpu/scenegraph/graph.py``: a scene, one body id per
gaussian (0 = static background) and the inverse rest pose of every body;
posing moves each gaussian by its body's X_l · X_l,rest⁻¹.  A graph is
built from per-body masks (the last mask that holds a gaussian wins).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.ops.transforms import SE3
from sim_a_splat_torch.splat.scene import GaussianScene


class SceneGraph(NamedTuple):
    """Splat scene + per-gaussian body assignment, all world-frame."""

    scene: GaussianScene
    link_ids: torch.Tensor   # (N,) int64, 0 = static
    rest_inv: SE3            # (L+1,) batched; index 0 = identity

    @property
    def num_bodies(self) -> int:
        """L+1 (including the static slot 0)."""
        return self.rest_inv.q.shape[0]

    def posed(self, body_poses: SE3) -> GaussianScene:
        """Scene with every gaussian moved to its body's pose; ``body_poses``
        is (..., L+1) batched and the result gains its leading dims."""
        rel = body_poses.compose(self.rest_inv)
        q_g = rel.q[..., self.link_ids, :]
        t_g = rel.t[..., self.link_ids, :]
        s = self.scene
        return s._replace(means=quat.rotate(q_g, s.means) + t_g,
                          quats=quat.multiply(q_g, s.quats))

    @staticmethod
    def from_masks(scene: GaussianScene, masks,
                   rest_poses: Optional[SE3] = None) -> "SceneGraph":
        """Build from L boolean masks (N,), body ids 1..L in list order:
        gaussians in no mask are static (id 0), and a gaussian in several
        masks goes to the last one.  ``rest_poses`` (L+1,) are the bodies'
        capture-time world poses (slot 0 ignored; default identity)."""
        dev = scene.means.device
        link_ids = torch.zeros(scene.num_gaussians, dtype=torch.long,
                               device=dev)
        for i, m in enumerate(masks):
            m = torch.as_tensor(m, dtype=torch.bool, device=dev)
            link_ids = torch.where(m, torch.full_like(link_ids, i + 1),
                                   link_ids)
        if rest_poses is None:
            rest_inv = SE3.identity((len(masks) + 1,),
                                    dtype=scene.means.dtype, device=dev)
        else:
            inv = rest_poses.inverse()
            q, t = inv.q.clone(), inv.t.clone()
            q[0] = q.new_tensor([1.0, 0.0, 0.0, 0.0])
            t[0] = 0.0
            rest_inv = SE3(q, t)
        return SceneGraph(scene, link_ids, rest_inv)


def body_poses_from_parts(quats, translations) -> SE3:
    """Stack (L+1, 4) wxyz + (L+1, 3) into a batched SE3."""
    return SE3(torch.as_tensor(quats), torch.as_tensor(translations))
