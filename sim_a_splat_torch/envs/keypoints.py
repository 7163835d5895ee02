"""Keypoint sampling and mapping for pushT observations.

Port of ``sim_a_splat_tpu/envs/keypoints.py``: keypoints are farthest-point
sampled (numpy, deterministic per seed) from dense points in the T-block's
and the agent's analytic shapes ((N, 2) local keypoints per body, 9 block /
3 agent by default), and posed into the world per env.
"""

from __future__ import annotations

import numpy as np
import torch

from sim_a_splat_torch.physics import pusht
from sim_a_splat_torch.physics.planar import rotate2d
from sim_a_splat_torch.physics.pusht import PushTParams


def farthest_point_sampling(points: np.ndarray, n_points: int,
                            init_idx: int = 0) -> np.ndarray:
    """Greedy farthest-point sampling of ``n_points`` rows of ``points``,
    starting at ``init_idx``."""
    assert n_points >= 1
    chosen = [points[init_idx]]
    dists = np.linalg.norm(points - points[init_idx], axis=-1)
    for _ in range(n_points - 1):
        nxt = int(np.argmax(dists))
        chosen.append(points[nxt])
        dists = np.minimum(dists, np.linalg.norm(points - points[nxt], axis=-1))
    return np.asarray(chosen)


def _dense_block_points(params: PushTParams, spacing: float = 3.0) -> np.ndarray:
    polys = np.asarray(pusht.tee_polys_local(params.scale, params.length))
    pts = []
    for p in polys:
        lo, hi = p.min(0), p.max(0)
        xs = np.arange(lo[0], hi[0] + 1e-6, spacing)
        ys = np.arange(lo[1], hi[1] + 1e-6, spacing)
        pts.append(np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2))
    return np.concatenate(pts)


def _dense_agent_points(params: PushTParams, spacing: float = 3.0) -> np.ndarray:
    r = params.agent_radius
    xs = np.arange(-r, r + 1e-6, spacing)
    g = np.stack(np.meshgrid(xs, xs), -1).reshape(-1, 2)
    return g[np.linalg.norm(g, axis=-1) <= r]


def default_keypoint_map(params: PushTParams = PushTParams(),
                         n_block_kps: int = 9, n_agent_kps: int = 3,
                         seed: int = 0,
                         jitter: float = 1.0) -> dict[str, np.ndarray]:
    """{'block': (9, 2), 'agent': (3, 2)} float32 local keypoints, with a
    small N(0, jitter²) sampling jitter drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    block = farthest_point_sampling(_dense_block_points(params), n_block_kps)
    agent = farthest_point_sampling(_dense_agent_points(params), n_agent_kps)
    if jitter:
        block = block + rng.normal(0, jitter, block.shape)
        agent = agent + rng.normal(0, jitter, agent.shape)
    return {"block": block.astype(np.float32),
            "agent": agent.astype(np.float32)}


def keypoints_global(local_kps: torch.Tensor, pos: torch.Tensor,
                     angle: torch.Tensor) -> torch.Tensor:
    """Local keypoints (N, 2) → world (B, N, 2) at each env's body pose
    ``pos`` (B, 2), ``angle`` (B,)."""
    return pos[:, None, :] + rotate2d(angle[:, None], local_kps)
