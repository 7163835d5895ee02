"""Stateful Gymnasium splat wrapper, built from asset paths.

Port of ``sim_a_splat_tpu/envs/splat_gym.py``: the reference's
``SplatEnvWrapper(env, splat_assets_path, match_object_name,
splat_config_name, task_assets_path, task_assets_name)`` with
``_configure_cameras(dict)`` / ``reset`` / ``step(action, noobs)`` /
``render`` / ``render_free_camera`` / ``_get_obs`` / ``close``, over one
env of the port's ``ManipulatorSimEnv`` (optionally under its
``ManipulatorEEFWrapper``).  The asset loading and the camera
configuration are the gym-free ``envs/splat_assets.py``; each step renders
every camera on the env's device (kernel K1 on the card) and copies the
images to the host once.

This module imports ``gymnasium``, which the card's machine does not have:
nothing on the port's card path imports it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import gymnasium as gym

from sim_a_splat_torch.envs.splat_assets import (
    DEFAULT_RASTER, SplatAssets, render_cameras,
)
from sim_a_splat_torch.envs.splat_wrapper import SplatEnvWrapperF
from sim_a_splat_torch.messaging.draw import DrawState
from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
from sim_a_splat_torch.ops.transforms import SE3


class SplatEnvWrapper(gym.Wrapper):
    """The reference's ``SplatEnvWrapper``: splat cameras over a
    manipulator env, the scene and masks loaded from asset files."""

    def __init__(
        self,
        env: gym.Env,
        splat_assets_path: str | Path,
        match_object_name: str,
        splat_config_name: str,
        task_assets_path: Optional[str | Path] = None,
        task_assets_name: Optional[str] = None,
        raster: RasterConfig = DEFAULT_RASTER,
        task_splat_count: int = 2000,
        robot_mesh_overlay: bool = False,
        robot_mesh_splat_count: int = 600,
    ):
        super().__init__(env)
        self._raster = raster
        self.assets = SplatAssets.load(
            self.unwrapped.env_f, splat_assets_path, match_object_name,
            splat_config_name, task_assets_path, task_assets_name,
            task_splat_count=task_splat_count,
            robot_mesh_overlay=robot_mesh_overlay,
            robot_mesh_splat_count=robot_mesh_splat_count,
            package_path=getattr(self.unwrapped, "package_path", None))
        self.link_masks = self.assets.link_masks
        self.icp = self.assets.icp
        self.joint_config = self.assets.joint_config
        self.scene_splat_frame = self.assets.scene_splat_frame
        self.wrapper_f: SplatEnvWrapperF | None = None
        self.camera_setup_info: dict = {}
        self.render_cam_keys: list = []

    def _configure_cameras(self, camera_setup_info: dict) -> None:
        self.wrapper_f = self.assets.configure_cameras(camera_setup_info,
                                                       self._raster)
        self.camera_setup_info = camera_setup_info
        self.render_cam_keys = [k for k, _ in self.wrapper_f.cameras]

    # --- env API ---------------------------------------------------------------

    def reset(self, seed: Optional[int] = None, reset_to_state=None):
        """The unwrapped env's observation (no camera images)."""
        obs = self.unwrapped.reset(seed=seed, reset_to_state=reset_to_state)
        self.draw_msg = self.unwrapped._generate_draw_msg()
        return obs

    def step(self, action, noobs: bool = False):
        obs_in, reward, terminated, truncated, info_in = self.env.step(action)
        self.draw_msg = self.unwrapped._generate_draw_msg()
        observation = None if noobs else self._get_obs()
        return observation, reward, terminated, truncated, info_in

    def _get_obs(self) -> dict:
        obs = self.unwrapped._get_obs()
        for i, img in enumerate(self.render()):
            obs[f"camera_{i}"] = np.moveaxis(img, -1, 0)
        return obs

    def _draw(self) -> DrawState:
        """The current draw message with the env axis the wrapper takes."""
        if self.wrapper_f is None:
            raise RuntimeError(
                "cameras not configured — call _configure_cameras first")
        if not hasattr(self, "draw_msg"):
            self.draw_msg = self.unwrapped._generate_draw_msg()
        p = self.draw_msg.poses
        return DrawState(poses=SE3(p.q[None], p.t[None]))

    def render(self, mode: str = "rgb_array") -> list:
        """One (H, W, 3) float image per configured camera, in
        ``render_cam_keys`` order (moving first, then fixed)."""
        return render_cameras(self.wrapper_f, self._draw())

    def render_free_camera(self, camera) -> np.ndarray:
        """The current scene from ``camera`` (a world-frame ``Camera``) →
        (H, W, 3)."""
        draw = self._draw()
        return self.wrapper_f.render_camera(draw, camera)[0].cpu().numpy()

    def close(self):
        self.env.close()
