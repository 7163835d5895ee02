"""Stateful one-env shells over the functional envs, without Gymnasium.

The reference's Gym classes hold one env (B = 1) of a functional env and
its state, and return numpy.  Their stateful part lives here, once:

- :class:`PushTSingleEnv`: ``gym_adapter.PushTEnv``'s seeding, ``reset``,
  ``step``, ``render``, ``_get_info``, ``goal_pose``, ``teleop_agent`` and
  ``_set_state(_local)`` over :class:`PushTEnvF`;
- :class:`ManipulatorSingleEnv`: ``manipulator_gym.ManipulatorSimEnv``'s
  URDF lookup, base weld, ``reset(seed, reset_to_state)``, ``step`` and
  draw message over :class:`ManipulatorEnvF`;
- :class:`ManipulatorEEFSingleEnv`: ``ManipulatorEEFWrapper``'s task-space
  step (``RuntimeError`` where IK fails) over
  :class:`ManipulatorEEFWrapperF`;
- :class:`SplatSingleEnv`: ``splat_gym.SplatEnvWrapper``'s asset loading,
  ``_configure_cameras``, ``step(action, noobs)`` with each camera's image
  as ``camera_{i}``, ``render`` and ``render_free_camera``.

The Gym classes (``gym_adapter``, ``manipulator_gym``, ``splat_gym``) are
these plus their observation and action spaces; the example drivers stack
these directly, as the reference's demos stack the Gym classes, so they
run where ``gymnasium`` is missing.  Every shell works on ``device``
("cuda" unless asked).  Random draws come from a ``torch.Generator``
seeded by ``seed``, so a seed gives other states than the reference's.
"""

from __future__ import annotations

import collections
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from sim_a_splat_torch import resolve_device
from sim_a_splat_torch.envs.eef_wrapper import ManipulatorEEFWrapperF
from sim_a_splat_torch.envs.manipulator_envs import ManipulatorEnvF
from sim_a_splat_torch.envs.pusht_envs import PushTEnvF
from sim_a_splat_torch.envs.splat_assets import (
    DEFAULT_RASTER, SplatAssets, render_cameras,
)
from sim_a_splat_torch.envs.splat_wrapper import SplatEnvWrapperF
from sim_a_splat_torch.messaging.draw import DrawState
from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
from sim_a_splat_torch.ops.transforms import SE3
from sim_a_splat_torch.physics import kinematics as kin
from sim_a_splat_torch.physics import pusht
from sim_a_splat_torch.physics.pusht import PushTParams


def _numpy(x):
    """One env's entry (the leading axis dropped) of a tensor or dict."""
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    return x[0].detach().cpu().numpy()


def _generator(device: torch.device, seed=None):
    """(seed, a generator on ``device`` seeded by it; a random seed where
    ``seed`` is None)."""
    if seed is None:
        seed = np.random.randint(0, 25536)
    return seed, torch.Generator(device=device).manual_seed(int(seed))


# --- pushT -------------------------------------------------------------------

class PushTSingleEnv:
    """One pushT env: ``reset() -> obs``, ``step() -> (obs, reward, done,
    info)``, with the reference's ``PushTEnv`` constructor keywords."""

    def __init__(self, legacy=False, block_cog=None, damping=None,
                 render_action=True, render_size=96, reset_to_state=None,
                 obs_mode="state", keypoint_visible_rate=1.0,
                 agent_keypoints=False, local_keypoint_map=None, seed=None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.env_f = PushTEnvF(
            params=PushTParams(),
            obs_mode=obs_mode,
            render_size=render_size,
            keypoint_visible_rate=keypoint_visible_rate,
            agent_keypoints=agent_keypoints,
            legacy=legacy,
            render_action=render_action,
            local_keypoint_map=local_keypoint_map,
            damping=damping,
            block_cog=None if block_cog is None else tuple(
                np.asarray(block_cog, np.float64).tolist()),
            device=str(self.device),
        )
        self.reset_to_state = reset_to_state
        self.latest_action = None
        self._state = None
        self.seed(seed)

    @property
    def unwrapped(self):
        return self

    def seed(self, seed=None):
        self._seed, self._gen = _generator(self.device, seed)

    def reset(self):
        self._state, obs = self.env_f.reset(self._gen, self.reset_to_state)
        self.latest_action = None
        return _numpy(obs)

    def step(self, action):
        self.latest_action = torch.as_tensor(
            np.asarray(action, np.float32), device=self.device).reshape(1, 2)
        tr = self.env_f.step(self._state, self.latest_action, self._gen)
        self._state = tr.state
        return (_numpy(tr.obs), float(tr.reward[0]), bool(tr.done[0]),
                _numpy(tr.info))

    def render(self, mode="rgb_array"):
        img = self.env_f.render(self._state, self.latest_action)
        return (_numpy(img) * 255).astype(np.uint8)

    def _get_obs(self):
        return _numpy(self.env_f.observe(self._state, generator=self._gen,
                                         action=self.latest_action))

    def _get_info(self):
        return _numpy(self.env_f.info(self._state))

    @property
    def goal_pose(self):
        return np.asarray(self.env_f._params().goal_pose)

    def teleop_agent(self):
        """Mouse-teleop agent: ``act(obs)`` returns the mouse position
        while the button is held near the agent, else None.  Needs a
        pygame display."""
        TeleopAgent = collections.namedtuple("TeleopAgent", ["act"])

        def act(obs):
            import pygame
            act = None
            mouse_position = pygame.mouse.get_pos()
            agent_pos = np.asarray(obs[:2], np.float64)
            lmb = pygame.mouse.get_pressed()[0]
            if lmb and (
                    self.teleop
                    or np.linalg.norm(np.asarray(mouse_position) - agent_pos)
                    < 30):
                self.teleop = True
                act = np.asarray(mouse_position, np.float64)
            return act

        self.teleop = False
        return TeleopAgent(act)

    def _set_state(self, state_vec):
        self._state = pusht.set_state(
            self.env_f._params(), torch.as_tensor(
                np.asarray(state_vec, np.float32),
                device=self.device).reshape(1, 5),
            legacy=self.env_f.legacy)
        return self._get_obs()

    def _set_state_local(self, state_local):
        """Goal-relative state: the local block pose composes with the
        goal pose; the agent position is given in the local block frame."""
        state_local = np.asarray(state_local, np.float64)
        agent_local = state_local[:2]
        block_local = state_local[2:]

        def affine(tx, ty, r):
            c, s = np.cos(r), np.sin(r)
            return np.array([[c, -s, tx], [s, c, ty], [0.0, 0.0, 1.0]])

        g = self.goal_pose
        m = affine(g[0], g[1], g[2]) @ affine(block_local[0], block_local[1],
                                              block_local[2])
        agent_new = (m @ np.array([agent_local[0], agent_local[1], 1.0]))[:2]
        new_state = np.array([*agent_new, m[0, 2], m[1, 2],
                              np.arctan2(m[1, 0], m[0, 0])])
        self._set_state(new_state)
        return new_state

    def close(self):
        pass


# --- the arm -----------------------------------------------------------------

def resolve_urdf(package_path: str, package_name: str, urdf_name: str) -> Path:
    """The URDF at ``<package_path>/<package_name>/urdf/<urdf_name>`` (or
    directly under the package or the package path)."""
    base = Path(package_path) / package_name
    for cand in (base / "urdf" / urdf_name, base / urdf_name,
                 Path(package_path) / urdf_name):
        if cand.exists():
            return cand
    raise FileNotFoundError(
        f"URDF {urdf_name!r} not found under {package_path}/{package_name}")


def weld_pose(weld_frame_transform=None) -> tuple:
    """The arm's base weld as ((q wxyz), (t)) float tuples, from a (q, t)
    pair or a 4×4 matrix (``None``: the identity)."""
    w = weld_frame_transform
    if w is None:
        return ((1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    if isinstance(w, (tuple, list)) and len(w) == 2 and len(w[0]) == 4:
        return (tuple(float(x) for x in w[0]), tuple(float(x) for x in w[1]))
    se3 = SE3.from_matrix(torch.as_tensor(np.asarray(w, np.float32)))
    return tuple(se3.q.tolist()), tuple(se3.t.tolist())


class ManipulatorSingleEnv:
    """One joint-space arm env: ``step() → (obs, reward, terminated,
    truncated, info)``, with the reference's ``ManipulatorSimEnv``
    constructor keywords (a URDF found from package path, package name and
    file name, as ``sak.URDFutils`` finds it)."""

    def __init__(
        self,
        env_objects: bool = True,
        visualise_flag: bool = False,          # no meshcat; kept for parity
        eef_link_name: str = None,
        package_path: str = None,
        package_name: str = None,
        urdf_name: str = None,
        num_dof: int = None,
        weld_frame_transform=None,             # (q wxyz, t) tuple or 4×4
        urdf_path: str | Path | None = None,   # direct alternative
        seed: Optional[int] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if urdf_path is None:
            urdf_path = resolve_urdf(package_path, package_name, urdf_name)
        chain = kin.load_chain(urdf_path)
        if num_dof is not None and chain.ndof != num_dof:
            raise ValueError(
                f"URDF has {chain.ndof} dof, expected {num_dof}")
        self.env_f = ManipulatorEnvF(
            chain=chain, eef_link=eef_link_name, env_objects=env_objects,
            weld=weld_pose(weld_frame_transform), device=str(self.device))
        self.num_dof = chain.ndof
        self.time_step = self.env_f.time_step
        # package root for package:// mesh URIs
        self.package_path = package_path
        self.package_name = package_name
        self.seed(seed)
        self._state = None

    @property
    def unwrapped(self):
        return self

    def seed(self, seed=None):
        self._seed, self._gen = _generator(self.device, seed)

    def reset(self, seed: Optional[int] = None, reset_to_state=None):
        if seed is not None:
            self.seed(seed)
        self._state, obs = self.env_f.reset(self._gen, reset_to_state)
        return _numpy(obs)

    def step(self, action, no_obs: bool = False):
        tr = self.env_f.step(self._state, torch.as_tensor(
            np.asarray(action, np.float32), device=self.device).reshape(1, -1))
        self._state = tr.state
        return (_numpy(tr.obs), float(tr.reward[0]), bool(tr.terminated[0]),
                bool(tr.truncated[0]), _numpy(tr.info))

    # the sim → splat bridge
    def _generate_loader_msg(self):
        return self.env_f.schema()

    def _generate_draw_msg(self) -> DrawState:
        """The body poses (L, ·) ordered as the schema."""
        p = self.env_f.draw_state(self._state).poses
        return DrawState(poses=SE3(p.q[0], p.t[0]))

    def _get_obs(self):
        return _numpy(self.env_f._get_obs(self._state))

    def _get_info(self):
        return _numpy(self.env_f._get_info(self._state))

    def get_simulation_time(self):
        return float(self._state.t[0])

    def get_simulation_frequency(self):
        return self.time_step

    def render(self):
        pass

    def close(self):
        pass


class ManipulatorEEFSingleEnv:
    """Task-space actions {"eef_pos": (3,), "eef_ori": (3,) roll-pitch-yaw}
    over a :class:`ManipulatorSingleEnv` (the reference's
    ``ManipulatorEEFWrapper``): raises ``RuntimeError`` where inverse
    kinematics fails."""

    def __init__(self, env: ManipulatorSingleEnv, theta_bound: float = 1e-4):
        self.env = env
        self.wrapper_f = ManipulatorEEFWrapperF(
            env=env.unwrapped.env_f, theta_bound=theta_bound)
        self.theta_bound = theta_bound

    @property
    def unwrapped(self):
        return self.env.unwrapped

    def eefpose2config(self, eefpose):
        res = self.wrapper_f.eefpose2config(
            self.unwrapped._state, torch.as_tensor(
                np.asarray(eefpose, np.float32),
                device=self.unwrapped.device).reshape(1, 6))
        if not bool(res.converged[0]):
            raise RuntimeError("Inverse kinematics failed")
        return _numpy(res.q)

    def reset(self, **kwargs):
        self.env.reset(**kwargs)
        return _numpy(self.wrapper_f._obs(self.unwrapped._state))

    def step(self, action):
        arm = self.unwrapped
        action = {k: torch.as_tensor(np.asarray(v, np.float32),
                                     device=arm.device).reshape(1, -1)
                  for k, v in action.items()}
        tr = self.wrapper_f.step(arm._state, action)
        if not bool(tr.info["ik_converged"][0]):
            raise RuntimeError("Inverse kinematics failed")
        arm._state = tr.state
        return (_numpy(tr.obs), float(tr.reward[0]), bool(tr.terminated[0]),
                bool(tr.truncated[0]), _numpy(tr.info))

    def close(self):
        self.env.close()


# --- the splat cameras -------------------------------------------------------

class SplatSingleEnv:
    """Splat cameras over an arm env (a :class:`ManipulatorSingleEnv`,
    optionally under a :class:`ManipulatorEEFSingleEnv`), the scene and
    masks loaded from asset files (the reference's ``SplatEnvWrapper``).
    The asset loading and the camera configuration are the gym-free
    ``envs/splat_assets.py``; each step renders every camera on the env's
    device (kernel K1 on the card) and copies the images to the host once."""

    def __init__(
        self,
        env,
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
        self.env = env
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

    @property
    def unwrapped(self):
        return self.env.unwrapped

    def _configure_cameras(self, camera_setup_info: dict) -> None:
        self.wrapper_f = self.assets.configure_cameras(camera_setup_info,
                                                       self._raster)
        self.camera_setup_info = camera_setup_info
        self.render_cam_keys = [k for k, _ in self.wrapper_f.cameras]

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
