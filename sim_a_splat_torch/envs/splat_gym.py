"""Stateful Gymnasium splat wrapper, built from asset paths.

Port of ``sim_a_splat_tpu/envs/splat_gym.py``: the reference's
``SplatEnvWrapper(env, splat_assets_path, match_object_name,
splat_config_name, task_assets_path, task_assets_name)`` with
``_configure_cameras(dict)`` / ``reset`` / ``step(action, noobs)`` /
``render`` / ``render_free_camera`` / ``_get_obs`` / ``close``, over one
env of the port's ``ManipulatorSimEnv`` (optionally under its
``ManipulatorEEFWrapper``).  The stateful part is the gym-free
``single_env.SplatSingleEnv``; this class makes it a ``gym.Wrapper``.

This module imports ``gymnasium``, which the card's machine does not have:
nothing on the port's card path imports it.
"""

from __future__ import annotations

import gymnasium as gym

from sim_a_splat_torch.envs.single_env import SplatSingleEnv


class SplatEnvWrapper(SplatSingleEnv, gym.Wrapper):
    """The reference's ``SplatEnvWrapper``: splat cameras over a
    manipulator env, the scene and masks loaded from asset files (the
    constructor of :class:`SplatSingleEnv`)."""

    def __init__(self, env: gym.Env, *args, **kwargs):
        gym.Wrapper.__init__(self, env)
        SplatSingleEnv.__init__(self, env, *args, **kwargs)
