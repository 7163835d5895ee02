"""Stateful Gymnasium adapters over the functional pushT env.

Port of ``sim_a_splat_tpu/envs/gym_adapter.py``: the reference's
constructor signatures, observation and action spaces, and ``reset() ->
obs`` / ``step() -> (obs, reward, done, info)`` return shapes, over one env
(B = 1) of :class:`PushTEnvF` on ``device`` ("cuda" unless asked).  Random
draws come from a ``torch.Generator`` seeded by :meth:`PushTEnv.seed`, so a
seed gives other states than the reference's.

This module imports ``gymnasium``, which the card's machine does not have:
nothing on the port's card path imports it.  :func:`register_envs`
registers ``pusht-keypoints-torch-v0`` (the reference's id,
``pusht-keypoints-v0``, stays the reference's).
"""

from __future__ import annotations

import collections

import numpy as np
import gymnasium as gym
from gymnasium import spaces
import torch

from sim_a_splat_torch import resolve_device
from sim_a_splat_torch.envs.pusht_envs import PushTEnvF
from sim_a_splat_torch.physics import pusht
from sim_a_splat_torch.physics.pusht import PushTParams

ENV_ID = "pusht-keypoints-torch-v0"


def _numpy(x):
    """One env's entry (the leading axis dropped) of a tensor or dict."""
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    return x[0].detach().cpu().numpy()


class PushTEnv(gym.Env):
    """State-obs pushT (the reference's ``PushTEnv``)."""

    metadata = {"render.modes": ["human", "rgb_array"],
                "video.frames_per_second": 10}
    reward_range = (0.0, 1.0)

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
        p = self.env_f._params()
        ws_x, ws_y = p.ws_x, p.ws_y
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

        self.reset_to_state = reset_to_state
        self.latest_action = None
        self._state = None
        self.seed(seed)

    def seed(self, seed=None):
        if seed is None:
            seed = np.random.randint(0, 25536)
        self._seed = seed
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))

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
