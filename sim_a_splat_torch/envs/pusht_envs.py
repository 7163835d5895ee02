"""Functional pushT environment family (state / keypoints / image obs),
batched over envs.

Port of ``sim_a_splat_tpu/envs/pusht_envs.py``: one functional env over
:class:`PushTState` with the observation mode as static configuration;
every state, observation, reward and info entry carries a leading env axis
B.  ``reset`` and the keypoint visibility draw from a ``torch.Generator``,
whose numbers differ from ``jax.random``'s; ``reset_to_state`` gives the
reference's states.  The Gymnasium adapters are ``envs/gym_adapter.py``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from sim_a_splat_torch import resolve_device
from sim_a_splat_torch.envs import keypoints as kp_mod
from sim_a_splat_torch.envs import render2d
from sim_a_splat_torch.physics import pusht
from sim_a_splat_torch.physics.pusht import PushTParams, PushTState


class Transition(NamedTuple):
    state: PushTState
    obs: Any
    reward: torch.Tensor
    done: torch.Tensor
    info: dict


@dataclasses.dataclass(frozen=True, eq=False)
class PushTEnvF:
    """Functional pushT env.  ``obs_mode``: "state" | "keypoints" | "image".

    - "state" obs (B, 5) = [agent_xy, block_xy, angle mod 2π];
    - "keypoints" obs (B, 2·Do) = [block keypoints (18) (+ agent keypoints
      (6)), agent_pos (2) unless ``agent_keypoints``, the visibility mask
      (Do)];
    - "image" obs = {"image": (B, 3, rs, rs) in [0, 1], "agent_pos": (B, 2)}.

    ``device`` is where ``reset`` puts ``reset_to_state`` ("cuda" unless
    asked); random states are drawn on the generator's device."""

    params: PushTParams = PushTParams()
    obs_mode: str = "state"
    render_size: int = 96
    keypoint_visible_rate: float = 1.0
    agent_keypoints: bool = False
    legacy: bool = False
    render_action: bool = True
    local_keypoint_map: Optional[dict] = None
    damping: Optional[float] = None
    block_cog: Optional[tuple] = None
    max_episode_steps: int = 200
    device: str = "cuda"

    def _params(self) -> PushTParams:
        p = self.params
        if self.damping is not None:
            p = dataclasses.replace(p, damping=self.damping)
        if self.block_cog is not None:
            p = dataclasses.replace(p, block_cog=tuple(self.block_cog))
        return p

    def _kp_map(self) -> dict:
        if self.local_keypoint_map is not None:
            return self.local_keypoint_map
        return self._default_kp_map

    @functools.cached_property
    def _default_kp_map(self) -> dict:
        return kp_mod.default_keypoint_map(self._params())

    @functools.lru_cache(maxsize=8)
    def _consts(self, device: torch.device) -> dict:
        """The local keypoints and the goal pose on ``device``, made once."""
        arrays = dict(self._kp_map(), goal_pose=self._params().goal_pose)
        return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                for k, v in arrays.items()}

    # --- functional API ---

    def reset(self, generator: Optional[torch.Generator] = None,
              reset_to_state=None,
              batch: int = 1) -> tuple[PushTState, Any]:
        """``batch`` random states from ``generator``, or ``reset_to_state``
        (one [agent_x, agent_y, block_x, block_y, angle] for all envs, or
        one row per env), settled by one substep; and their observations
        (keypoint visibility drawn from ``generator``)."""
        vec = None
        if reset_to_state is not None:
            vec = torch.as_tensor(np.asarray(reset_to_state, np.float32),
                                  device=resolve_device(self.device))
            if vec.dim() == 1:
                vec = vec.expand(batch, 5)
        elif generator is None:
            raise ValueError("reset needs a generator or reset_to_state")
        state = pusht.reset(self._params(), generator, batch, vec,
                            legacy=self.legacy)
        return state, self.observe(state, generator=generator)

    def step(self, state: PushTState, action: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> Transition:
        """One control step of every env toward ``action`` (B, 2)."""
        p = self._params()
        state = pusht.control_step(p, state, action)
        reward, done = pusht.reward_done(p, state)
        obs = self.observe(state, generator=generator, action=action)
        return Transition(state=state, obs=obs, reward=reward, done=done,
                          info=self.info(state))

    def observe(self, state: PushTState,
                generator: Optional[torch.Generator] = None,
                action: Optional[torch.Tensor] = None):
        if self.obs_mode == "state":
            return pusht.get_obs(state)
        if self.obs_mode == "keypoints":
            return self._keypoint_obs(state, generator)
        if self.obs_mode == "image":
            img = self.render(state, action)
            return {"image": img.permute(0, 3, 1, 2),
                    "agent_pos": state.agent_pos}
        raise ValueError(f"unknown obs_mode {self.obs_mode}")

    def _keypoint_obs(self, state: PushTState,
                      generator: Optional[torch.Generator]):
        kmap = self._consts(state.block_pos.device)
        parts = [kp_mod.keypoints_global(kmap["block"], state.block_pos,
                                         state.block_angle)]
        if self.agent_keypoints:
            parts.append(kp_mod.keypoints_global(
                kmap["agent"], state.agent_pos,
                torch.zeros_like(state.block_angle)))
        kps = torch.cat(parts, dim=1)                       # (B, n, 2)
        B, n = kps.shape[:2]
        if generator is None or self.keypoint_visible_rate >= 1.0:
            visible = torch.ones((B, n), dtype=torch.bool, device=kps.device)
        else:
            visible = torch.rand((B, n), generator=generator,
                                 device=kps.device) \
                < self.keypoint_visible_rate
        obs = kps.reshape(B, -1)
        obs_mask = visible.repeat_interleave(2, dim=1)
        if not self.agent_keypoints:
            obs = torch.cat([obs, state.agent_pos], dim=1)
            obs_mask = torch.cat([obs_mask, torch.ones_like(obs_mask[:, :2])],
                                 dim=1)
        return torch.cat([obs, obs_mask.to(obs.dtype)], dim=1)

    def info(self, state: PushTState) -> dict:
        p = self._params()
        B = state.agent_pos.shape[0]
        return {
            "pos_agent": state.agent_pos,
            "vel_agent": state.agent_vel,
            "block_pose": torch.cat([state.block_pos,
                                     state.block_angle[:, None]], dim=1),
            "goal_pose": self._consts(state.agent_pos.device)[
                "goal_pose"].expand(B, 3),
            "n_contacts": torch.ceil(state.n_contacts / p.substeps),
        }

    def render(self, state: PushTState,
               action: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, rs, rs, 3) frames, the action marker where ``action`` is
        given and ``render_action`` is set."""
        return render2d.render_frame(
            self._params(), state, self.render_size,
            action=action if self.render_action else None)

    @property
    def obs_dim(self) -> int:
        if self.obs_mode == "state":
            return 5
        if self.obs_mode == "keypoints":
            kmap = self._kp_map()
            do = int(np.prod(kmap["block"].shape))
            do += int(np.prod(kmap["agent"].shape)) if self.agent_keypoints else 2
            return do * 2
        raise ValueError("image obs is a dict")
