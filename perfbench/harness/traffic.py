"""The general traffic generator: every mix is a data file of parameters
(``perfbench/traffic/<mix>.json``) that this module turns into a run's
inputs from the run's seed.

A pushT mix's keys:

- ``loop``: what a step of the window does (``datagen``: the forward env
  step; ``train``: the step's loss and its gradient to the scene);
- ``batch``: envs stepped together, in a closed loop (a step starts when
  the last one has ended);
- ``reset``: integer ranges ``[lo, hi)`` of the agent's and the block's
  reset positions (``agent_x`` ...) and the angle's law, 2π·N(0, 1) − π;
- ``walk``: each env's action, the agent's target, is a random walk from
  the agent's reset position with steps N(0, ``sigma``²) a control step on
  each axis, clipped to ``[lo, hi]``; ``steps`` of it are drawn, and a
  longer window walks them again from the start;
- ``check``: the correctness sample, ``steps`` step indices drawn from
  ``[1, before)`` besides the window's first and last step, and ``envs``
  envs of each drawn from the batch (all of them where it equals ``batch``);
- ``trace_steps``: the steps a ``--trace 1`` run profiles after its window.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

TRAFFIC_DIR = Path(__file__).resolve().parent.parent / "traffic"


def load(name: str, root: Path = TRAFFIC_DIR) -> dict:
    path = root / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def generator(seed: int, device, salt: int = 0) -> torch.Generator:
    """A generator on ``device`` for ``seed`` (any whole number: folded to
    64 bits) and a stream ``salt``."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + salt) % (1 << 63))


def reset_vectors(mix: dict, gen: torch.Generator) -> torch.Tensor:
    """(B, 5) reset rows [agent_x, agent_y, block_x, block_y, angle]."""
    r, B, dev = mix["reset"], int(mix["batch"]), gen.device

    def randint(key):
        lo, hi = r[key]
        return torch.randint(int(lo), int(hi), (B,), generator=gen,
                             device=dev).float()

    angle = torch.randn(B, generator=gen, device=dev) * 2.0 * math.pi - math.pi
    return torch.stack([randint("agent_x"), randint("agent_y"),
                        randint("block_x"), randint("block_y"), angle], -1)


def action_walk(mix: dict, start: torch.Tensor,
                gen: torch.Generator) -> torch.Tensor:
    """(steps, B, 2) agent targets: the clipped random walk from ``start``
    (B, 2)."""
    w = mix["walk"]
    steps = int(w["steps"])
    lo = torch.tensor(w["lo"], dtype=torch.float32, device=start.device)
    hi = torch.tensor(w["hi"], dtype=torch.float32, device=start.device)
    noise = torch.randn((steps,) + tuple(start.shape), generator=gen,
                        device=start.device) * float(w["sigma"])
    out = torch.empty_like(noise)
    pos = torch.minimum(torch.maximum(start.float(), lo), hi)
    for t in range(steps):
        pos = torch.minimum(torch.maximum(pos + noise[t], lo), hi)
        out[t] = pos
    return out


def check_sample(mix: dict, seed: int) -> tuple:
    """(step indices, env indices) of the correctness sample, drawn from
    the seed on the host: ``check.steps`` steps from ``[1, before)`` (the
    window's first and last step are added by the run) and ``check.envs``
    envs of the batch."""
    c, B = mix["check"], int(mix["batch"])
    g = torch.Generator().manual_seed(int(seed) % (1 << 63))
    steps = sorted((1 + torch.randperm(int(c["before"]) - 1, generator=g)
                    [:int(c["steps"])]).tolist())
    envs = sorted(torch.randperm(B, generator=g)[:int(c["envs"])].tolist())
    return steps, envs
