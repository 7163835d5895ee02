"""Stateful Gymnasium adapters over the functional pushT env.

Port of ``sim_a_splat_tpu/envs/gym_adapter.py``: the reference's
constructor signatures, observation and action spaces, and ``reset() ->
obs`` / ``step() -> (obs, reward, done, info)`` return shapes, over one env
(B = 1) of :class:`PushTEnvF` on ``device`` ("cuda" unless asked).  The
stateful part is the gym-free ``single_env.PushTSingleEnv``; these classes
add the spaces.

This module imports ``gymnasium``, which the card's machine does not have:
nothing on the port's card path imports it.  :func:`register_envs`
registers ``pusht-keypoints-torch-v0`` (the reference's id,
``pusht-keypoints-v0``, stays the reference's).
"""

from __future__ import annotations

import numpy as np
import gymnasium as gym
from gymnasium import spaces

from sim_a_splat_torch.envs.single_env import PushTSingleEnv

ENV_ID = "pusht-keypoints-torch-v0"


class PushTEnv(PushTSingleEnv, gym.Env):
    """State-obs pushT (the reference's ``PushTEnv``): the gym-free
    :class:`PushTSingleEnv` (same constructor) with its spaces."""

    metadata = {"render.modes": ["human", "rgb_array"],
                "video.frames_per_second": 10}
    reward_range = (0.0, 1.0)

    def __init__(self, *args, **kwargs):
        PushTSingleEnv.__init__(self, *args, **kwargs)
        p = self.env_f._params()
        ws_x, ws_y = p.ws_x, p.ws_y
        obs_mode, render_size = self.env_f.obs_mode, self.env_f.render_size
        if obs_mode == "state":
            self.observation_space = spaces.Box(
                low=np.array([0, 0, 0, 0, 0], dtype=np.float64),
                high=np.array([ws_x, ws_y, ws_x, ws_y, np.pi * 2],
                              dtype=np.float64),
                shape=(5,), dtype=np.float64)
        elif obs_mode == "keypoints":
            do = self.env_f.obs_dim // 2
            ws = max(ws_x, ws_y)
            low = np.zeros(do * 2, dtype=np.float64)
            high = np.full_like(low, ws)
            high[do:] = 1.0
            self.observation_space = spaces.Box(low=low, high=high,
                                                dtype=np.float64)
        elif obs_mode == "image":
            self.observation_space = spaces.Dict({
                "image": spaces.Box(0.0, 1.0, (3, render_size, render_size),
                                    np.float32),
                "agent_pos": spaces.Box(
                    np.zeros(2), np.array([ws_x, ws_y]), dtype=np.float32),
            })
        self.action_space = spaces.Box(
            low=np.zeros(2, dtype=np.float64),
            high=np.array([ws_x, ws_y], dtype=np.float64),
            shape=(2,), dtype=np.float64)


class PushTKeypointsEnv(PushTEnv):
    """Keypoint-obs pushT (the reference's ``PushTKeypointsEnv``)."""

    def __init__(self, legacy=False, block_cog=None, damping=None,
                 render_size=96, keypoint_visible_rate=1.0,
                 agent_keypoints=False, draw_keypoints=False,
                 reset_to_state=None, render_action=True,
                 local_keypoint_map=None, color_map=None, seed=None,
                 device="cuda"):
        super().__init__(
            legacy=legacy, block_cog=block_cog, damping=damping,
            render_action=render_action, render_size=render_size,
            reset_to_state=reset_to_state, obs_mode="keypoints",
            keypoint_visible_rate=keypoint_visible_rate,
            agent_keypoints=agent_keypoints,
            local_keypoint_map=local_keypoint_map, seed=seed, device=device)
        self.draw_keypoints = draw_keypoints

    @classmethod
    def genenerate_keypoint_manager_params(cls):
        """The default keypoint configuration (the reference's spelling)."""
        from sim_a_splat_torch.envs.keypoints import default_keypoint_map
        return {"local_keypoint_map": default_keypoint_map(),
                "color_map": None}


class PushTImageEnv(PushTEnv):
    """Image-obs pushT (the reference's ``PushTImageEnv``)."""

    def __init__(self, legacy=False, block_cog=None, damping=None,
                 render_size=96, seed=None, device="cuda"):
        super().__init__(legacy=legacy, block_cog=block_cog, damping=damping,
                         render_size=render_size, obs_mode="image", seed=seed,
                         device=device)


def register_envs():
    """Register :data:`ENV_ID` (the keypoint env, 200 steps an episode)."""
    from gymnasium.envs.registration import register, registry
    if ENV_ID not in registry:
        register(
            id=ENV_ID,
            entry_point="sim_a_splat_torch.envs.gym_adapter:PushTKeypointsEnv",
            max_episode_steps=200,
            reward_threshold=1.0,
        )
