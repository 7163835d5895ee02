"""Segmentation/registration artifacts and the similarity fold-in.

Port of ``sim_a_splat_tpu/scenegraph/registration.py``.  The offline
matcher writes per-link gaussian masks and a 4×4 similarity (robot/world →
splat coordinates).  ``canonicalize`` folds the similarity into the scene
once (the scale into ``log_scales``), so that at run time every pose is a
world-frame SE(3); the conjugated link transform and the attached-camera
frame of the splat-frame formulation are kept for comparisons.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.ops.transforms import SE3, Sim3
from sim_a_splat_torch.splat.scene import GaussianScene


def load_link_masks(path: str | Path) -> dict[str, np.ndarray]:
    """Load a pickled {link name: (N,) bool} mask dict (``.npy``)."""
    d = np.load(path, allow_pickle=True).item()
    return {str(k): np.asarray(v, bool) for k, v in d.items()}


def load_icp_sim3(path: str | Path, device="cpu") -> Sim3:
    """Load a 4×4 similarity (``.npy``), checked for orthogonality and
    isotropic scale (``Sim3.from_matrix``)."""
    return Sim3.from_matrix(np.load(path), device=device)


def canonicalize(scene: GaussianScene, icp: Sim3) -> GaussianScene:
    """Map a splat-frame scene into the world frame: ``icp⁻¹`` applied to
    every gaussian (means through the similarity, quats through its
    rotation, its scale added to ``log_scales``)."""
    inv = icp.inverse()
    return scene._replace(
        means=inv.apply(scene.means),
        quats=quat.multiply(inv.q, scene.quats),
        log_scales=scene.log_scales + torch.log(inv.s))


def splat_to_world_pose(pose: SE3, icp: Sim3) -> SE3:
    """A pose in splat coordinates → world coordinates."""
    inv = icp.inverse()
    return SE3(quat.multiply(inv.q, pose.q), inv.apply(pose.t))


def world_to_splat_pose(pose: SE3, icp: Sim3) -> SE3:
    return SE3(quat.multiply(icp.q, pose.q), icp.apply(pose.t))


def conjugated_link_transform(icp: Sim3, x_now: SE3, x_rest: SE3) -> SE3:
    """A link's motion in splat coordinates,
    ``icp ∘ x_now ∘ x_rest⁻¹ ∘ icp⁻¹`` (the scale cancels: an SE(3))."""
    m = icp.compose_se3(x_now.compose(x_rest.inverse())).compose(icp.inverse())
    return SE3(m.q, m.t)


def attached_frame(icp: Sim3, link_pose_world: SE3,
                   local_offset: torch.Tensor,
                   rotate_offset: bool = False) -> SE3:
    """Splat-frame pose of a link-attached camera: icp's rigid part ∘
    (q_link, s·(t_link + offset)), the offset in world axes unless
    ``rotate_offset``."""
    off = (quat.rotate(link_pose_world.q, local_offset) if rotate_offset
           else local_offset)
    p = SE3(link_pose_world.q, icp.s * (link_pose_world.t + off))
    return icp.se3().compose(p)


def attached_frame_world(link_pose_world: SE3, local_offset: torch.Tensor,
                         rotate_offset: bool = False) -> SE3:
    """World-frame link-attached camera pose (for canonicalized scenes)."""
    off = (quat.rotate(link_pose_world.q, local_offset) if rotate_offset
           else local_offset)
    return SE3(link_pose_world.q, link_pose_world.t + off)
