"""Gymnasium adapters for the manipulator env family.

Port of ``sim_a_splat_tpu/envs/manipulator_gym.py``: the reference's
constructor keywords (a URDF found from package path, package name and
file name, as ``sak.URDFutils`` finds it), observation and action spaces,
and ``step() → (obs, reward, terminated, truncated, info)``, over one env
(B = 1) of :class:`ManipulatorEnvF` on ``device`` ("cuda" unless asked).
Random resets draw from a ``torch.Generator`` seeded by
:meth:`ManipulatorSimEnv.seed`.

This module imports ``gymnasium``, which the card's machine does not have:
nothing on the port's card path imports it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import gymnasium as gym
import torch

from sim_a_splat_torch import resolve_device
from sim_a_splat_torch.envs.eef_wrapper import ManipulatorEEFWrapperF
from sim_a_splat_torch.envs.gym_adapter import _numpy
from sim_a_splat_torch.envs.manipulator_envs import ManipulatorEnvF
from sim_a_splat_torch.messaging.draw import DrawState
from sim_a_splat_torch.ops.transforms import SE3
from sim_a_splat_torch.physics import kinematics as kin


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


class ManipulatorSimEnv(gym.Env):
    """Joint-space arm env (the reference's ``ManipulatorSimEnv``)."""

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
        weld = ((1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
        if weld_frame_transform is not None:
            w = weld_frame_transform
            if (isinstance(w, (tuple, list)) and len(w) == 2
                    and len(w[0]) == 4):
                weld = (tuple(float(x) for x in w[0]),
                        tuple(float(x) for x in w[1]))
            else:
                se3 = SE3.from_matrix(torch.as_tensor(
                    np.asarray(w, np.float32)))
                weld = (tuple(se3.q.tolist()), tuple(se3.t.tolist()))
        self.env_f = ManipulatorEnvF(
            chain=chain, eef_link=eef_link_name, env_objects=env_objects,
            weld=weld, device=str(self.device))
        self.num_dof = chain.ndof
        self.time_step = self.env_f.time_step
        # package root for package:// mesh URIs
        self.package_path = package_path
        self.package_name = package_name

        self.observation_space = gym.spaces.Dict({
            "robot_joint_pos": gym.spaces.Box(-np.pi, np.pi,
                                              (self.num_dof,), np.float32),
            "robot_joint_vel": gym.spaces.Box(-np.inf, np.inf,
                                              (self.num_dof,), np.float32),
        })
        self.action_space = gym.spaces.Box(-np.pi, np.pi, (self.num_dof,),
                                           np.float32)
        self.seed(seed)
        self._state = None

    def seed(self, seed=None):
        if seed is None:
            seed = np.random.randint(0, 25536)
        self._seed = seed
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))

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


class ManipulatorEEFWrapper(gym.Wrapper):
    """Task-space action wrapper (the reference's
    ``ManipulatorEEFWrapper``): raises ``RuntimeError`` where inverse
    kinematics fails."""

    def __init__(self, env: ManipulatorSimEnv, theta_bound: float = 1e-4):
        super().__init__(env)
        self.wrapper_f = ManipulatorEEFWrapperF(
            env=env.env_f, theta_bound=theta_bound)
        self.observation_space = gym.spaces.Dict({
            "eef_pos": gym.spaces.Box(-np.inf, np.inf, (3,), np.float32),
            "eef_quat": gym.spaces.Box(-np.inf, np.inf, (4,), np.float32),
            "eef_pos_vel": gym.spaces.Box(-np.inf, np.inf, (3,), np.float32),
            "eef_rot_vel": gym.spaces.Box(-np.inf, np.inf, (3,), np.float32),
        })
        self.action_space = gym.spaces.Dict({
            "eef_pos": gym.spaces.Box(-1.0, 1.0, (3,), float),
            "eef_ori": gym.spaces.Box(-np.pi, np.pi, (3,), float),
        })
        self.theta_bound = theta_bound

    def eefpose2config(self, eefpose):
        res = self.wrapper_f.eefpose2config(
            self.env._state, torch.as_tensor(
                np.asarray(eefpose, np.float32),
                device=self.env.device).reshape(1, 6))
        if not bool(res.converged[0]):
            raise RuntimeError("Inverse kinematics failed")
        return _numpy(res.q)

    def reset(self, **kwargs):
        self.env.reset(**kwargs)
        return _numpy(self.wrapper_f._obs(self.env._state))

    def step(self, action):
        action = {k: torch.as_tensor(np.asarray(v, np.float32),
                                     device=self.env.device).reshape(1, -1)
                  for k, v in action.items()}
        tr = self.wrapper_f.step(self.env._state, action)
        if not bool(tr.info["ik_converged"][0]):
            raise RuntimeError("Inverse kinematics failed")
        self.env._state = tr.state
        return (_numpy(tr.obs), float(tr.reward[0]), bool(tr.terminated[0]),
                bool(tr.truncated[0]), _numpy(tr.info))
