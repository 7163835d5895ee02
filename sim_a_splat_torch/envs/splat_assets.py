"""The splat env built from asset files, without Gymnasium.

The gym-free core of ``sim_a_splat_tpu/envs/splat_gym.py``'s
``SplatEnvWrapper`` (the Gym shell is ``envs/splat_gym.py``): its
constructor's asset loading and its ``_configure_cameras``.

- :meth:`SplatAssets.load` reads the offline matcher's artifacts
  (``masks/<name>/{link_masks_global_dict, icp_transformation,
  joint_config}.npy``) and the trained splat (``splatfacto/<run>/...``:
  a nerfstudio run, ``.ply``, ``.json`` or ``.npz``); turns the task mesh
  into disk gaussians in the splat frame, appended under
  :data:`TASK_MASK_KEY`; and, with ``robot_mesh_overlay``, the URDF link
  visuals into gaussians added to each link's mask.
- :meth:`SplatAssets.configure_cameras` binds the robot masks (sorted by
  length, then name) in order to the chain's non-world links at their
  capture-time poses and builds the :class:`SplatEnvWrapperF`; camera
  poses are given in the splat frame.
- :func:`render_cameras` renders every camera of one env (kernel K1 on the
  card, the full-grid route) and copies the images to the host at once.

Everything lives on the functional env's device.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from sim_a_splat_torch import resolve_device
from sim_a_splat_torch.envs.manipulator_envs import ManipulatorEnvF
from sim_a_splat_torch.envs.splat_wrapper import CameraSpec, SplatEnvWrapperF
from sim_a_splat_torch.messaging.draw import DrawState
from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
from sim_a_splat_torch.ops.transforms import SE3, Sim3
from sim_a_splat_torch.physics import kinematics as kin
from sim_a_splat_torch.scenegraph.mesh_overlay import visual_mesh
from sim_a_splat_torch.scenegraph.registration import (
    load_icp_sim3, load_link_masks,
)
from sim_a_splat_torch.splat import loaders
from sim_a_splat_torch.splat.scene import GaussianScene
from sim_a_splat_torch.tools.mesh_to_splat import concat_scenes, mesh_to_splat
from sim_a_splat_torch.tools.meshio import load_mesh

TASK_MASK_KEY = "__task__"
DEFAULT_RASTER = RasterConfig(tile_capacity=1024, chunk=128)


def as_pose_tuple(local_frame) -> tuple:
    """A camera or local frame as ((q wxyz), (t)) tuples: viser-style
    objects (``.wxyz_xyz`` or ``.rotation()`` / ``.translation()``), a 4×4
    matrix, or a (q, t) pair."""
    if hasattr(local_frame, "wxyz_xyz"):
        v = np.asarray(local_frame.wxyz_xyz, np.float64)
        return tuple(v[:4]), tuple(v[4:])
    if hasattr(local_frame, "rotation"):
        q = np.asarray(local_frame.rotation().wxyz)
        t = np.asarray(local_frame.translation())
        return tuple(q), tuple(t)
    arr = np.asarray(local_frame, dtype=object)
    if arr.shape == (4, 4):
        m = SE3.from_matrix(torch.as_tensor(np.asarray(local_frame,
                                                       np.float32)))
        return tuple(m.q.numpy()), tuple(m.t.numpy())
    q, t = local_frame
    return tuple(np.asarray(q, np.float64)), tuple(np.asarray(t, np.float64))


def _load_scene(assets: Path, splat_config_name: str,
                device) -> GaussianScene:
    cand = assets / "splatfacto" / splat_config_name
    if not cand.exists():
        cand = assets / splat_config_name
    if cand.name == "config.yml":
        cand = cand.parent
    return loaders.load(cand, device)


def _into_splat_frame(part: GaussianScene, icp: Sim3,
                      pose: Optional[SE3] = None) -> GaussianScene:
    """Gaussians in a body frame (at ``pose`` in the world, else in it)
    moved through the similarity into the splat frame."""
    means, quats = part.means, part.quats
    if pose is not None:
        means = quat.rotate(pose.q, means) + pose.t
        quats = quat.multiply(pose.q, quats)
    return part._replace(means=icp.apply(means),
                         quats=quat.multiply(icp.q, quats),
                         log_scales=part.log_scales + torch.log(icp.s))


@dataclasses.dataclass(frozen=True, eq=False)
class SplatAssets:
    """The scene in the splat frame with every gaussian mask, the
    similarity world → splat and the capture-time joint configuration."""

    env: ManipulatorEnvF
    scene_splat_frame: GaussianScene
    link_masks: dict          # the segmentation as loaded
    masks: dict               # with the task and the overlay appended
    icp: Sim3
    joint_config: np.ndarray
    task_mask_key: Optional[str]

    @staticmethod
    def load(env: ManipulatorEnvF, splat_assets_path: str | Path,
             match_object_name: str, splat_config_name: str,
             task_assets_path: Optional[str | Path] = None,
             task_assets_name: Optional[str] = None,
             task_splat_count: int = 2000, robot_mesh_overlay: bool = False,
             robot_mesh_splat_count: int = 600,
             package_path: Optional[str] = None) -> "SplatAssets":
        """Load the asset tree for ``env`` (its chain and device);
        ``package_path`` resolves the overlay's ``package://`` mesh URIs."""
        dev = resolve_device(env.device)
        assets = Path(splat_assets_path)
        masks_dir = assets / "masks" / match_object_name
        link_masks = load_link_masks(masks_dir / "link_masks_global_dict.npy")
        icp = load_icp_sim3(masks_dir / "icp_transformation.npy", device=dev)
        joint_config = np.load(masks_dir / "joint_config.npy")
        scene = _load_scene(assets, splat_config_name, dev)

        masks = dict(link_masks)
        task_mask_key = None
        if task_assets_path is not None and task_assets_name is not None:
            mesh = load_mesh(Path(task_assets_path) / task_assets_name)
            task = _into_splat_frame(
                mesh_to_splat(mesh, n=task_splat_count,
                              color=(0.8, 0.3, 0.25), device=dev), icp)
            n_scene, n_task = scene.num_gaussians, task.num_gaussians
            scene = concat_scenes(scene, task)
            masks = {k: np.concatenate([v, np.zeros(n_task, bool)])
                     for k, v in masks.items()}
            masks[TASK_MASK_KEY] = np.concatenate(
                [np.zeros(n_scene, bool), np.ones(n_task, bool)])
            task_mask_key = TASK_MASK_KEY
        if robot_mesh_overlay:
            # URDF visuals → disk gaussians, each added to its link's mask
            # (the j-th robot key pairs with the j-th non-world link)
            rest_fk = kin.fk(env.chain, torch.as_tensor(
                joint_config.astype(np.float32), device=dev), env._base(dev))
            robot_keys = sorted(link_masks, key=lambda s: (len(s), s))

            def resolve(uri: str) -> Path:
                if uri.startswith("package://") and package_path is not None:
                    return Path(package_path) / uri[len("package://"):]
                return Path(uri)

            j = 0
            for i, name in enumerate(env.chain.link_names):
                if name == "world":
                    continue
                if j >= len(robot_keys):
                    break
                key = robot_keys[j]
                j += 1
                vis = env.chain.visuals[i]
                if vis is None:
                    continue
                part = _into_splat_frame(
                    mesh_to_splat(visual_mesh(vis, resolve),
                                  n=robot_mesh_splat_count,
                                  color=tuple(vis.color[:3]), seed=11 + i,
                                  device=dev),
                    icp, SE3(rest_fk.q[i], rest_fk.t[i]))
                scene = concat_scenes(scene, part)
                masks = {k: np.concatenate([v, np.full(part.num_gaussians,
                                                       k == key)])
                         for k, v in masks.items()}
        return SplatAssets(env=env, scene_splat_frame=scene,
                           link_masks=link_masks, masks=masks, icp=icp,
                           joint_config=joint_config,
                           task_mask_key=task_mask_key)

    def configure_cameras(self, camera_setup_info: dict,
                          raster: RasterConfig = DEFAULT_RASTER
                          ) -> SplatEnvWrapperF:
        """The wrapper over ``env`` for cameras given as the reference's
        dicts ({key: {type, render_size, local_frame, link_name, fov}},
        fixed cameras' poses in the splat frame).  The robot masks bind
        positionally to the chain's non-world links, so their counts must
        match, or ``ValueError``."""
        specs = {}
        for key, info in camera_setup_info.items():
            specs[key] = CameraSpec(
                type=info["type"],
                render_size=tuple(info["render_size"]),
                local_frame=as_pose_tuple(info["local_frame"]),
                link_name=info.get("link_name"),
                fov=float(info.get("fov", 1.3089)))

        env = self.env
        dev = self.scene_splat_frame.means.device
        rest_fk = kin.fk(env.chain, torch.as_tensor(
            self.joint_config.astype(np.float32), device=dev), env._base(dev))
        robot_keys = sorted([k for k in self.masks
                             if k != self.task_mask_key],
                            key=lambda s: (len(s), s))
        links = [i for i, n in enumerate(env.chain.link_names)
                 if n != "world"]
        if len(robot_keys) != len(links):
            raise ValueError(
                f"link-mask/chain mismatch: {len(robot_keys)} robot mask "
                f"keys {robot_keys} vs {len(links)} non-world chain links "
                f"{[env.chain.link_names[i] for i in links]}; the pairing "
                "is positional, so counts must match exactly")
        # body 0 static, bodies 1.. the links at the capture pose, then the
        # task (its gaussians were made in the block's own frame)
        ident = SE3.identity((1,), device=dev)
        rest_q = [ident.q, rest_fk.q[links]]
        rest_t = [ident.t, rest_fk.t[links]]
        if self.task_mask_key is not None:
            rest_q.append(ident.q)
            rest_t.append(ident.t)
        return SplatEnvWrapperF.build(
            env=env, scene=self.scene_splat_frame, link_masks=self.masks,
            camera_setup_info=specs, icp=self.icp,
            rest_poses_world=SE3(torch.cat(rest_q), torch.cat(rest_t)),
            task_mask_key=self.task_mask_key, scene_frame="splat",
            raster=raster)


def render_cameras(wrapper: SplatEnvWrapperF, draw: DrawState) -> list:
    """One (H, W, 3) float32 numpy image per camera, in render order, of
    the one env of ``draw`` (poses (1, L, ·)): rendered on the device
    (``SplatEnvWrapperF.render``) and copied to the host in one transfer."""
    imgs = wrapper.render(None, draw)
    flat = torch.cat([i[0].reshape(-1) for i in imgs]).cpu().numpy()
    out, o = [], 0
    for i in imgs:
        n = i[0].numel()
        out.append(flat[o:o + n].reshape(i.shape[1:]))
        o += n
    return out
