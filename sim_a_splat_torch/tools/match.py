"""Offline splat↔robot matching pipeline, the ``match_splat.py`` twin.

Port of ``sim_a_splat_tpu/tools/match.py``.  It writes the same artifacts
under the same file names as the reference (which the runtime reads):

- ``joint_config.npy``            robot configuration at capture
- ``polygon_bounds.npy``          the crop polygon (where one is given)
- ``trans_init.npy``              initial similarity guess
- ``icp_transformation.npy``      scaled-ICP similarity, 4×4
- ``link_masks_global_dict.npy``  {link_name: (N,) bool}
- ``point_cloud.npy``             sampled robot point cloud

The two human-in-the-loop stages of the original script (the polygon crop
and the manual initial rotation) are arguments with automatic defaults, so
the pipeline runs end to end from a script.  Everything is host-side
numpy; the link poses come from the port's forward kinematics
(``physics/kinematics.py``) on the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path

import numpy as np
import torch

from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.ops.transforms import SE3
from sim_a_splat_torch.physics import kinematics as kin
from sim_a_splat_torch.splat.scene import GaussianScene
from sim_a_splat_torch.tools import masks as mask_mod
from sim_a_splat_torch.tools import meshio, registration

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class MatchResult:
    icp_transformation: np.ndarray
    link_masks: dict
    joint_config: np.ndarray
    rmse: float
    fitness: float
    scale: float


def load_link_meshes(chain: kin.KinematicChain, urdf_dir: Path,
                     joint_config: np.ndarray) -> dict:
    """FK-posed visual meshes per link.  Resolves ``package://`` URIs
    relative to the URDF's package root as the reference rewrites them;
    links whose visual is not a mesh file are left out, as there."""
    poses = kin.fk(chain, torch.as_tensor(np.asarray(joint_config),
                                          dtype=torch.float32))
    out = {}
    for i, name in enumerate(chain.link_names):
        vis = chain.visuals[i]
        if vis is None or vis.mesh_path is None:
            continue
        mp = vis.mesh_path
        if mp.startswith("package://"):
            rel = mp[len("package://"):]
            # walk up from the urdf dir to find the package root
            cand = None
            for base in [urdf_dir] + list(urdf_dir.parents):
                if (base / rel).exists():
                    cand = base / rel
                    break
                tail = Path(rel)
                if (base / Path(*tail.parts[1:])).exists():
                    cand = base / Path(*tail.parts[1:])
                    break
            if cand is None:
                logger.warning("mesh not found: %s", mp)
                continue
            mp = cand
        else:
            mp = urdf_dir / mp
        mesh = meshio.load_mesh(mp).scaled(vis.scale)
        vis_q = quat.from_rpy(torch.tensor(vis.origin_rpy,
                                           dtype=torch.float32))
        vis_T = np.eye(4)
        vis_T[:3, :3] = quat.to_rotation_matrix(vis_q).numpy()
        vis_T[:3, 3] = vis.origin_xyz
        link_T = SE3(poses.q[i], poses.t[i]).as_matrix().numpy()
        out[name] = mesh.transformed(link_T @ vis_T)
    return out


def initial_guess(robot_pcd: np.ndarray, splat_pcd: np.ndarray,
                  manual_rotation: np.ndarray | None = None,
                  scale_hint: float | None = None) -> np.ndarray:
    """Centroid-offset initial similarity (match_splat.py:178-203); the
    reference's hand-entered rotation can be passed via
    ``manual_rotation`` (3×3)."""
    R = np.eye(3) if manual_rotation is None else np.asarray(manual_rotation)
    if scale_hint is None:
        # ratio of RMS spreads as a scale seed
        s = (np.std(splat_pcd - splat_pcd.mean(0)) /
             max(np.std(robot_pcd - robot_pcd.mean(0)), 1e-12))
    else:
        s = scale_hint
    t = splat_pcd.mean(0) - s * R @ robot_pcd.mean(0)
    m = np.eye(4)
    m[:3, :3] = s * R
    m[:3, 3] = t
    return m


def match(
    urdf_path: str | Path,
    scene: GaussianScene,
    joint_config: np.ndarray,
    output_dir: str | Path,
    crop_polygon: np.ndarray | None = None,
    crop_axis_range: tuple | None = None,
    trans_init: np.ndarray | None = None,
    manual_rotation: np.ndarray | None = None,
    n_sample_points: int = 20000,
    max_correspondence_distance: float = 0.3,
    distance_threshold: float = 0.015,
    link_names: list | None = None,
    seed: int = 0,
) -> MatchResult:
    """Full pipeline: FK meshes → sampled pcd → crop → ICP → masks → save."""
    urdf_path = Path(urdf_path)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    joint_config = np.asarray(joint_config, np.float64)

    chain = kin.load_chain(urdf_path)
    meshes = load_link_meshes(chain, urdf_path.parent, joint_config)
    if link_names is None:
        link_names = list(meshes)
    logger.info("links with visual meshes: %s", link_names)

    combined = None
    for n in link_names:
        combined = meshes[n] if combined is None else combined.concat(meshes[n])
    robot_pcd = meshio.sample_poisson_disk(combined, n_sample_points, seed)

    splat_means = scene.means.detach().cpu().numpy().astype(np.float64)
    if crop_polygon is not None:
        crop_mask = registration.crop_polygon(
            splat_means, crop_polygon, axis_range=crop_axis_range)
        np.save(output_dir / "polygon_bounds.npy",
                np.asarray(crop_polygon))
    else:
        crop_mask = np.ones(len(splat_means), bool)
    cropped = splat_means[crop_mask]

    if trans_init is None:
        trans_init = initial_guess(robot_pcd, cropped, manual_rotation)
    res = registration.icp(
        robot_pcd, cropped, max_correspondence_distance,
        init=trans_init, with_scaling=True)
    logger.info("ICP: rmse=%.5f fitness=%.3f iters=%d",
                res.rmse, res.fitness, res.iterations)

    T = res.transformation
    sR = T[:3, :3]
    scale = float(np.sqrt(np.mean(np.diag(sR.T @ sR))))     # validation
    # (the runtime re-validates orthogonality: Sim3.from_matrix)

    # per-link masks: bring the cropped splat means into robot coords and
    # test against each FK-posed link mesh
    Tinv = np.linalg.inv(T)
    cropped_robot = cropped @ Tinv[:3, :3].T + Tinv[:3, 3]
    link_masks_global = {}
    for i, n in enumerate(link_names):
        m_local = mask_mod.link_mask(cropped_robot, meshes[n],
                                     distance_threshold)
        g = np.zeros(len(splat_means), bool)
        g[np.flatnonzero(crop_mask)[m_local]] = True
        link_masks_global[f"link{i}"] = g
        logger.info("link%d (%s): %d splats", i, n, int(g.sum()))

    np.save(output_dir / "joint_config.npy", joint_config)
    np.save(output_dir / "trans_init.npy", trans_init)
    np.save(output_dir / "icp_transformation.npy", T)
    np.save(output_dir / "link_masks_global_dict.npy",
            np.asarray(link_masks_global, dtype=object))
    np.save(output_dir / "point_cloud.npy", robot_pcd)

    return MatchResult(icp_transformation=T, link_masks=link_masks_global,
                       joint_config=joint_config, rmse=res.rmse,
                       fitness=res.fitness, scale=scale)
