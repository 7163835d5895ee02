"""Gymnasium adapters for the manipulator env family.

Port of ``sim_a_splat_tpu/envs/manipulator_gym.py``: the reference's
constructor keywords (a URDF found from package path, package name and
file name, as ``sak.URDFutils`` finds it), observation and action spaces,
and ``step() → (obs, reward, terminated, truncated, info)``, over one env
(B = 1) of :class:`ManipulatorEnvF` on ``device`` ("cuda" unless asked).
The stateful part is the gym-free ``single_env.ManipulatorSingleEnv`` and
``ManipulatorEEFSingleEnv``; these classes add the spaces.

This module imports ``gymnasium``, which the card's machine does not have:
nothing on the port's card path imports it.
"""

from __future__ import annotations

import numpy as np
import gymnasium as gym

from sim_a_splat_torch.envs.single_env import (  # noqa: F401 (re-exported)
    ManipulatorEEFSingleEnv, ManipulatorSingleEnv, resolve_urdf,
)


class ManipulatorSimEnv(ManipulatorSingleEnv, gym.Env):
    """Joint-space arm env (the reference's ``ManipulatorSimEnv``): the
    gym-free :class:`ManipulatorSingleEnv` (same constructor) with its
    spaces."""

    def __init__(self, *args, **kwargs):
        ManipulatorSingleEnv.__init__(self, *args, **kwargs)
        self.observation_space = gym.spaces.Dict({
            "robot_joint_pos": gym.spaces.Box(-np.pi, np.pi,
                                              (self.num_dof,), np.float32),
            "robot_joint_vel": gym.spaces.Box(-np.inf, np.inf,
                                              (self.num_dof,), np.float32),
        })
        self.action_space = gym.spaces.Box(-np.pi, np.pi, (self.num_dof,),
                                           np.float32)


class ManipulatorEEFWrapper(ManipulatorEEFSingleEnv, gym.Wrapper):
    """Task-space action wrapper (the reference's
    ``ManipulatorEEFWrapper``): the gym-free
    :class:`ManipulatorEEFSingleEnv` with its spaces; raises
    ``RuntimeError`` where inverse kinematics fails."""

    def __init__(self, env: ManipulatorSimEnv, theta_bound: float = 1e-4):
        gym.Wrapper.__init__(self, env)
        ManipulatorEEFSingleEnv.__init__(self, env, theta_bound)
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
