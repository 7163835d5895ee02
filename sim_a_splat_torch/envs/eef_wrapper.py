"""Task-space (EEF) action wrapper over the manipulator env, batched.

Port of ``sim_a_splat_tpu/envs/eef_wrapper.py``: an action {eef_pos (B, 3),
eef_ori (B, 3) roll-pitch-yaw} goes through damped-least-squares IK from
the current joints (``physics/kinematics.ik``) to a joint-target step; the
observation is the end effector's pose and velocities.  IK failure is
``info["ik_converged"]`` False (the reference's Gym adapter raises on it).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from sim_a_splat_torch.envs.manipulator_envs import (
    ManipulatorEnvF, ManipulatorState,
)
from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.ops.transforms import SE3
from sim_a_splat_torch.physics import kinematics as kin


class EEFTransition(NamedTuple):
    state: ManipulatorState
    obs: dict
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    info: dict


@dataclasses.dataclass(frozen=True, eq=False)
class ManipulatorEEFWrapperF:
    env: ManipulatorEnvF
    theta_bound: float = 1e-4
    ik_iterations: int = 60

    def eefpose2config(self, state: ManipulatorState,
                       eefpose: torch.Tensor) -> kin.IKResult:
        """[x, y, z, roll, pitch, yaw] (B, 6) → joint configs, IK from the
        current q; the orientation bound is at least 1e-3."""
        target = SE3(quat.from_rpy(eefpose[:, 3:]), eefpose[:, :3])
        return kin.ik(
            self.env.chain, self.env.eef_link, target, q0=state.arm.q,
            base=self.env._base(eefpose.device),
            iterations=self.ik_iterations, pos_tol=1e-4,
            theta_bound=max(self.theta_bound, 1e-3))

    def reset(self, generator=None, reset_to_state=None, batch: int = 1):
        state, _ = self.env.reset(generator, reset_to_state, batch)
        return state, self._obs(state)

    def step(self, state: ManipulatorState, action: dict) -> EEFTransition:
        dev = state.arm.q.device
        eefpose = torch.cat([
            torch.as_tensor(action["eef_pos"], dtype=torch.float32,
                            device=dev),
            torch.as_tensor(action["eef_ori"], dtype=torch.float32,
                            device=dev)], dim=-1)
        res = self.eefpose2config(state, eefpose)
        tr = self.env.step(state, res.q)
        info = {"robot_joint_pos": tr.obs["robot_joint_pos"],
                "robot_joint_vel": tr.obs["robot_joint_vel"],
                "timestamp": tr.info["timestamp"],
                "ik_converged": res.converged, "ik_pos_err": res.pos_err}
        if "block_pose" in tr.info:
            info["block_pose"] = tr.info["block_pose"]
        return EEFTransition(state=tr.state,
                             obs=self._obs_from_info(tr.info),
                             reward=tr.reward, terminated=tr.terminated,
                             truncated=tr.truncated, info=info)

    def _obs(self, state: ManipulatorState) -> dict:
        return self._obs_from_info(self.env._get_info(state))

    @staticmethod
    def _obs_from_info(info: dict) -> dict:
        return {k: info[k] for k in ("eef_pos", "eef_quat", "eef_pos_vel",
                                     "eef_rot_vel")}
