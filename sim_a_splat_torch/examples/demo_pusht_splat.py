"""Teleop / datagen demo: a pushT task driving the arm splat env.

The port of ``examples/demo_pusht_splat.py``: a 2-D pushT env provides end
effector targets (the agent's position), mapped from pixel space to the
arm's workspace; IK turns them into joint targets; the splat env renders
its two cameras every control step (kernel K1 on the card).

pushT is the gym-free ``envs/single_env.PushTSingleEnv`` in keypoint mode
(the stateful part of the port's ``PushTKeypointsEnv``).  Headless,
``--steps N`` runs a scripted pushing policy and writes the splat camera
frames as PPM files to ``--out``.  With ``--steps 0`` it is interactive:
the mouse drags the agent (``pygame``, imported only then; r = retry,
q = quit).

    python -m sim_a_splat_torch.examples.demo_pusht_splat --steps 20 --out /tmp/f
    python -m sim_a_splat_torch.examples.demo_pusht_splat --steps 3 --device cpu
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from sim_a_splat_torch import resolve_device
from sim_a_splat_torch.envs.keypoints import default_keypoint_map
from sim_a_splat_torch.envs.single_env import PushTSingleEnv
from sim_a_splat_torch.examples.common import (
    HOME_Q, add_device_option, log, make_manipulator_splat_env, save_ppm,
)
from sim_a_splat_torch.ops import quaternion as quat


def map_actions(act):
    """pushT pixel coords → arm workspace meters (reference
    demo_pusht_splat.py:102-105, ranges fit to the pusharm6 reach)."""
    if act is None:
        return None
    return np.array([0.30 + 0.22 * act[0] / 298, 0.20 - 0.40 * act[1] / 512,
                     0.2])


def scripted_policy(obs, info, goal_pose):
    """Push the block toward the goal: aim the agent at the point behind
    the block along the block→goal line."""
    block = np.asarray(info["block_pose"][:2], np.float64)
    goal = np.asarray(goal_pose[:2], np.float64)
    d = goal - block
    d /= max(np.linalg.norm(d), 1e-6)
    return block - 40.0 * d


def pusht_keypoints_env(render_size: int = 96, seed=None,
                        device="cuda") -> PushTSingleEnv:
    """The demo's pushT env: keypoint observations, the reference's
    default keypoint map, no action marker drawn (reference
    demo_pusht_splat.py:62-65)."""
    return PushTSingleEnv(obs_mode="keypoints", render_size=render_size,
                          render_action=False,
                          local_keypoint_map=default_keypoint_map(),
                          seed=seed, device=device)


def start_episode(pusht_env, splat_env):
    """Reset pushT (at random) and the arm (at the push-ready home) →
    (pushT obs, the end effector's roll-pitch-yaw, held for the episode)."""
    obs = pusht_env.reset()
    splat_env.reset(reset_to_state={
        "robot_pos": HOME_Q[:splat_env.unwrapped.num_dof],
        "block_pos": [0.0, 0.0, 0.0, 0.0],
        "goal_pos": [0.0, 0.0, 0.0, 0.0]})
    eef_ori = quat.to_rpy(torch.as_tensor(
        splat_env.unwrapped._get_info()["eef_quat"]))
    return obs, eef_ori.numpy()


def demo_step(pusht_env, splat_env, act, eef_ori):
    """One control step of the demo: pushT takes ``act`` (pixels), the arm
    its mapped end-effector target → (obs, reward, done, info of pushT;
    the splat env's obs with ``camera_{i}``, its reward)."""
    obs, reward, done, info = pusht_env.step(act)
    sobs, srew, _, _, _ = splat_env.step(
        {"eef_pos": map_actions(act), "eef_ori": eef_ori}, noobs=False)
    return obs, reward, done, info, sobs, srew


def save_frames(out_dir: Path, sobs: dict, n_cams: int, prefix: str) -> None:
    for ci in range(n_cams):
        save_ppm(out_dir / f"{prefix}_cam{ci}.ppm",
                 np.moveaxis(sobs[f"camera_{ci}"], 0, -1))


def run_headless(pusht_env, splat_env, steps: int, out_dir=None) -> int:
    """The scripted loop: ``steps`` control steps of an episode (a new
    episode where pushT is done) → the steps taken."""
    taken = episode = 0
    while True:
        obs, eef_ori = start_episode(pusht_env, splat_env)
        goal_pose = pusht_env.goal_pose
        for t in range(steps):
            act = scripted_policy(obs, pusht_env._get_info(), goal_pose)
            obs, reward, done, _, sobs, srew = demo_step(
                pusht_env, splat_env, act, eef_ori)
            taken += 1
            if out_dir is not None:
                save_frames(out_dir, sobs, len(splat_env.render_cam_keys),
                            f"ep{episode}_t{t:04d}")
            log(f"ep {episode} t {t} pusht_reward {reward:.3f} "
                f"sim_reward {srew:.3f}")
            if done:
                break
        else:
            log(f"episode {episode}: completed {steps} scripted steps")
            return taken
        episode += 1


def run_interactive(splat_env, render_size: int, control_hz: int, out_dir,
                    device) -> None:
    """Mouse teleop in a pygame window (r = retry, q = quit)."""
    import pygame

    env = pusht_keypoints_env(render_size, device=device)
    pygame.init()
    screen = pygame.display.set_mode((298, 512))
    clock = pygame.time.Clock()
    agent = env.teleop_agent()
    episode = 0
    while True:
        obs, eef_ori = start_episode(env, splat_env)
        t = 0
        while True:
            for event in pygame.event.get():
                if event.type == pygame.QUIT:
                    return
                if event.type == pygame.KEYDOWN:
                    if event.key == pygame.K_q:
                        return
                    if event.key == pygame.K_r:
                        t = -1
            act = agent.act(obs)
            if t < 0:
                break
            if act is not None:
                obs, reward, done, _, sobs, srew = demo_step(
                    env, splat_env, act, eef_ori)
                if out_dir is not None:
                    save_frames(out_dir, sobs, len(splat_env.render_cam_keys),
                                f"ep{episode}_t{t:04d}")
                log(f"ep {episode} t {t} pusht_reward {reward:.3f} "
                    f"sim_reward {srew:.3f}")
                if done:
                    break
            frame = env.render("rgb_array")
            surf = pygame.surfarray.make_surface(
                np.transpose(frame, (1, 0, 2)))
            screen.blit(pygame.transform.scale(surf, (298, 512)), (0, 0))
            pygame.display.flip()
            clock.tick(control_hz)
            t += 1
        episode += 1


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-rs", "--render_size", default=96, type=int,
                   help="pushT frame size")
    p.add_argument("-hz", "--control_hz", default=10, type=int)
    p.add_argument("--steps", default=0, type=int,
                   help="scripted steps (0 = interactive teleop)")
    p.add_argument("--out", default="", help="frame output dir")
    add_device_option(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    splat_env = make_manipulator_splat_env(eef=True, device=device)
    out_dir = Path(args.out) if args.out else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    if args.steps == 0:
        run_interactive(splat_env, args.render_size, args.control_hz,
                        out_dir, device)
    else:
        run_headless(pusht_keypoints_env(args.render_size, device=device),
                     splat_env, args.steps, out_dir)


if __name__ == "__main__":
    main()
