"""Analytic 2-D rasterizer for pushT image observations, batched over envs.

Port of ``sim_a_splat_tpu/envs/render2d.py``: every output pixel centre is
mapped to workspace coordinates and classified against the scene's shapes
(white canvas → goal T → walls → agent → block, the reference's palette),
elementwise for every env at once.  The action marker keeps the reference's
``coord = action / 512 * 96`` mapping, both axes divided by 512.
"""

from __future__ import annotations

import torch

from sim_a_splat_torch.physics import pusht
from sim_a_splat_torch.physics.pusht import PushTParams, PushTState

# reference palette (pygame color names)
COL_BG = (255, 255, 255)
COL_WALL = (211, 211, 211)        # LightGray
COL_GOAL = (144, 238, 144)        # LightGreen
COL_AGENT = (65, 105, 225)        # RoyalBlue
COL_BLOCK = (119, 136, 153)       # LightSlateGray
COL_MARKER = (255, 0, 0)


def _point_in_box(pts: torch.Tensor, poly: torch.Tensor) -> torch.Tensor:
    """Pixels ``pts`` (H, W, 2) inside each convex CCW quad ``poly``
    (B, 4, 2), all four edge cross products ≥ 0 → (B, H, W)."""
    v0 = poly[:, None, None]                           # (B, 1, 1, 4, 2)
    e = torch.roll(poly, -1, dims=-2)[:, None, None] - v0
    d = pts[None, :, :, None, :] - v0                  # (B, H, W, 4, 2)
    cross = e[..., 0] * d[..., 1] - e[..., 1] * d[..., 0]
    return torch.all(cross >= 0.0, dim=-1)


def _pixel_grid(params: PushTParams, rs: int, dtype, device) -> torch.Tensor:
    """(rs, rs, 2) workspace coordinates [x, y] of the pixel centres (the
    298 × 512 workspace squashed into a square), row = y."""
    u = (torch.arange(rs, dtype=dtype, device=device) + 0.5) / rs
    X, Y = torch.meshgrid(u * params.ws_x, u * params.ws_y, indexing="xy")
    return torch.stack([X, Y], dim=-1)


def _paint(img: torch.Tensor, mask: torch.Tensor, color) -> torch.Tensor:
    c = torch.as_tensor(color, dtype=img.dtype, device=img.device) / 255.0
    return torch.where(mask[..., None], c, img)


def render_frame(params: PushTParams, state: PushTState,
                 render_size: int = 96, action: torch.Tensor | None = None,
                 dtype=torch.float32) -> torch.Tensor:
    """(B, rs, rs, 3) RGB in [0, 1] of every env; ``action`` (B, 2) draws
    the red marker."""
    rs = render_size
    dev = state.agent_pos.device
    B = state.agent_pos.shape[0]
    P = _pixel_grid(params, rs, dtype, dev)
    X, Y = P[..., 0], P[..., 1]
    img = torch.ones((B, rs, rs, 3), dtype=dtype, device=dev) \
        * torch.as_tensor(COL_BG, dtype=dtype, device=dev) / 255.0

    goal = pusht.block_polys_world(
        params, torch.tensor([[params.goal_x, params.goal_y]], dtype=dtype,
                             device=dev),
        torch.tensor([params.goal_theta], dtype=dtype, device=dev))[0]
    goal_mask = _point_in_box(P, goal[:1]) | _point_in_box(P, goal[1:])
    img = _paint(img, goal_mask, COL_GOAL)

    # walls: fat segments at inset 5, radius 2, within the walls' outline
    m, r = params.wall_inset, params.wall_radius
    wall = ((torch.abs(X - m) <= r) | (torch.abs(X - (params.ws_x - m)) <= r)
            | (torch.abs(Y - m) <= r)
            | (torch.abs(Y - (params.ws_y - m)) <= r))
    span = ((X >= m - r) & (X <= params.ws_x - m + r)
            & (Y >= m - r) & (Y <= params.ws_y - m + r))
    img = _paint(img, wall & span, COL_WALL)

    d = P - state.agent_pos.to(dtype)[:, None, None, :]
    agent = torch.sqrt(torch.sum(d * d, dim=-1)) <= params.agent_radius
    img = _paint(img, agent, COL_AGENT)

    # the block last, on top (the reference's insertion order)
    polys = pusht.block_polys_world(params, state.block_pos,
                                    state.block_angle).to(dtype)
    block = _point_in_box(P, polys[:, 0]) | _point_in_box(P, polys[:, 1])
    img = _paint(img, block, COL_BLOCK)

    if action is not None:
        coord = torch.as_tensor(action, dtype=dtype, device=dev) \
            / 512.0 * 96.0 * (rs / 96.0)
        msz = (8.0 / 96.0 * rs) / 2.0
        th = max(float(int(1.0 / 96.0 * rs)), 1.0) / 2.0
        ar = torch.arange(rs, dtype=dtype, device=dev)
        row, col = torch.meshgrid(ar, ar, indexing="ij")
        # [row, col] − the action's [x, y], as the reference pairs them
        dx = torch.abs(col - coord[:, None, None, 1])
        dy = torch.abs(row - coord[:, None, None, 0])
        cross = ((dx <= th) | (dy <= th)) & (dx <= msz) & (dy <= msz)
        img = _paint(img, cross, COL_MARKER)
    return img


def keypoint_overlay(img: torch.Tensor, keypoints: torch.Tensor,
                     visible: torch.Tensor, params: PushTParams,
                     color=(31, 119, 180),
                     radius: float | None = None) -> torch.Tensor:
    """Draw each env's visible keypoints (B, N, 2) (workspace coordinates,
    ``visible`` (B, N) bool) as dots on ``img`` (B, rs, rs, 3)."""
    rs = img.shape[1]
    if radius is None:
        radius = rs / 96.0
    P = _pixel_grid(params, rs, img.dtype, img.device)
    # workspace → pixel is anisotropic; compare in pixel space
    scale = torch.tensor([rs / params.ws_x, rs / params.ws_y],
                         dtype=img.dtype, device=img.device)
    d = (P[None, :, :, None, :] - keypoints[:, None, None, :, :]) * scale
    hit = (torch.sqrt(torch.sum(d * d, dim=-1)) <= radius) \
        & visible[:, None, None, :]
    return _paint(img, torch.any(hit, dim=-1), color)
