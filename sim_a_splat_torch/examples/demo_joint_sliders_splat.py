"""Joint-slider demo: drive the arm splat env joint by joint at 10 Hz.

The port of ``examples/demo_joint_sliders_splat.py`` (the reference's
meshcat-slider demo, one slider a joint, stepping the splat env with the
slider values):

- default: a scripted slider sweep — joint t // 40 sines through ±0.8 rad
  while the others decay by 0.95 a step, rendering both cameras every step
  when ``--out`` saves the frames (``--steps`` bounds the run, 0 = forever);
- ``--interactive``: slider values from stdin as ``<joint> <value>`` lines
  (e.g. ``2 0.7``; ``q`` quits), stepping at ``--control_hz`` between
  inputs;
- ``--meshes``: the URDF link meshes drawn as gaussians beside the splats.

    python -m sim_a_splat_torch.examples.demo_joint_sliders_splat --steps 40 --out /tmp/f
"""

from __future__ import annotations

import argparse
import select
import sys
from pathlib import Path

import numpy as np

from sim_a_splat_torch import resolve_device
from sim_a_splat_torch.examples.common import (
    add_device_option, log, make_manipulator_splat_env, save_ppm,
)

SWEEP_PERIOD, SWEEP_AMPLITUDE, SWEEP_DECAY = 40, 0.8, 0.95


def sweep(joint_values: np.ndarray, t: int) -> np.ndarray:
    """The scripted sweep's joint values at step ``t`` from the last ones:
    joint (t // 40) % ndof on its sine, the others decayed."""
    j = (t // SWEEP_PERIOD) % len(joint_values)
    joint_values = joint_values * SWEEP_DECAY
    joint_values[j] = SWEEP_AMPLITUDE * np.sin(
        2 * np.pi * (t % SWEEP_PERIOD) / SWEEP_PERIOD)
    return joint_values


def read_slider(joint_values: np.ndarray, timeout: float):
    """One ``<joint> <value>`` line from stdin within ``timeout`` s into
    ``joint_values`` (in place); False on ``q`` or end of input."""
    ready, _, _ = select.select([sys.stdin], [], [], timeout)
    if ready:
        line = sys.stdin.readline().split()
        if not line or line[0] in ("q", "quit"):
            return False
        joint_values[int(line[0]) % len(joint_values)] = float(line[1])
    return True


def run(splat_env, steps: int, out_dir=None, interactive: bool = False,
        control_hz: int = 10) -> int:
    """Step the env with the slider values (each step's frames to
    ``out_dir``, rendered only then) → the steps taken."""
    joint_values = np.zeros(splat_env.unwrapped.num_dof)
    t = 0
    while steps == 0 or t < steps:
        if interactive:
            if not read_slider(joint_values, 1.0 / control_hz):
                break
        else:
            joint_values = sweep(joint_values, t)
        log(f"Joint values: {np.round(joint_values, 3)}")
        obs, _, _, _, _ = splat_env.step(joint_values, noobs=out_dir is None)
        if out_dir is not None:
            for ci in range(len(splat_env.render_cam_keys)):
                save_ppm(out_dir / f"t{t:04d}_cam{ci}.ppm",
                         np.moveaxis(obs[f"camera_{ci}"], 0, -1))
        t += 1
    return t


def make_env(meshes: bool = False, device="cuda", render_size=(240, 320)):
    """The demo's env (joint space, the overlay with ``meshes``), reset to
    the zero configuration."""
    splat_env = make_manipulator_splat_env(eef=False, render_size=render_size,
                                           robot_mesh_overlay=meshes,
                                           device=device)
    splat_env.reset(reset_to_state={
        "robot_pos": [0.0] * splat_env.unwrapped.num_dof,
        "block_pos": [0.0, 0.0, 0.0, 0.0],
        "goal_pos": [0.0, 0.0, 0.0, 0.0],
    })
    return splat_env


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", default=0, type=int, help="0 = run forever")
    p.add_argument("--out", default="", help="frame output dir")
    p.add_argument("--interactive", action="store_true",
                   help="read '<joint> <value>' lines from stdin")
    p.add_argument("-hz", "--control_hz", default=10, type=int)
    p.add_argument("--meshes", action="store_true",
                   help="overlay URDF link meshes on the splats")
    add_device_option(p)
    args = p.parse_args(argv)
    splat_env = make_env(args.meshes, resolve_device(args.device))
    out_dir = Path(args.out) if args.out else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    run(splat_env, args.steps, out_dir, args.interactive, args.control_hz)


if __name__ == "__main__":
    main()
