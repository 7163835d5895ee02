"""Slow, dense golden renderer for 3D gaussian splatting, and the gsplat
"classic" compositing constants shared by the tile rasterizer and the
kernels.

Port of ``sim_a_splat_tpu/ops/rasterize_reference.py``: every gaussian is
evaluated at every pixel, with no tiling, binning or capacity limit, and
the front-to-back recurrence is the cumulative-product form
w_k = α_k · Π_{j<k} (1 − α_j) over the depth order.  O(N·H·W): tests and
verification only.  Differentiable end to end.
"""

from __future__ import annotations

from typing import Optional

import torch

from sim_a_splat_torch.ops import sh as sh_ops
from sim_a_splat_torch.ops.projection import project, view_directions

ALPHA_CLAMP = 0.999      # max per-gaussian alpha
ALPHA_MIN = 1.0 / 255.0  # contributions below this are dropped


def render_reference(means: torch.Tensor, covs: torch.Tensor,
                     colors: torch.Tensor, opacities: torch.Tensor, camera,
                     background: Optional[torch.Tensor] = None,
                     return_depth: bool = False,
                     sigma_cutoff: Optional[float] = None):
    """(H, W, 3) image (and, with ``return_depth``, the (H, W) depth and
    alpha) of world-space gaussians: means (N, 3), covariances (N, 3, 3),
    colours (N, 3), opacities (N,) under one camera; ``sigma_cutoff``
    drops contributions beyond nσ, as the tile rasterizer's footprint
    does."""
    H, W = camera.height, camera.width
    proj = project(means, covs, camera)
    # front to back; invalid gaussians last (stable on equal depth)
    depth_key = torch.where(proj.valid, proj.depth,
                            torch.full_like(proj.depth, float("inf")))
    order = torch.sort(depth_key, stable=True).indices
    xy, conic, valid = proj.xy[order], proj.conic[order], proj.valid[order]
    cols = colors[order]
    opac = torch.clamp(opacities[order], 0.0, 1.0)
    depth_sorted = proj.depth[order]

    dev = means.device
    px = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    py = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    pgy, pgx = torch.meshgrid(py, px, indexing="ij")         # (H, W)
    pix = torch.stack([pgx, pgy], dim=-1).reshape(-1, 2)     # (P, 2)

    d = pix[:, None, :] - xy[None, :, :]                     # (P, N, 2)
    dx, dy = d[..., 0], d[..., 1]
    a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp(opac * torch.exp(torch.clamp(power, max=0.0)),
                        max=ALPHA_CLAMP)
    keep = (alpha >= ALPHA_MIN) & valid & (power <= 0.0)
    if sigma_cutoff is not None:
        keep &= power >= -0.5 * sigma_cutoff**2
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))

    trans = torch.cumprod(1.0 - alpha, dim=-1)
    trans_excl = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]],
                           dim=-1)
    w = alpha * trans_excl                                   # (P, N)
    rgb = w @ cols                                           # (P, 3)
    alpha_total = torch.sum(w, dim=-1)
    if background is None:
        background = rgb.new_zeros(3)
    rgb = rgb + (1.0 - alpha_total)[:, None] * background
    img = rgb.reshape(H, W, 3)
    if not return_depth:
        return img
    depth = (w @ depth_sorted[:, None])[:, 0]
    depth = depth / torch.clamp(alpha_total, min=1e-10)
    return img, depth.reshape(H, W), alpha_total.reshape(H, W)


def render_reference_sh(means, covs, sh_coeffs, opacities, camera,
                        sh_degree: int, background=None, **kw):
    """:func:`render_reference` with view-dependent SH colours (degree
    0..3)."""
    colors = sh_ops.eval_sh_color(sh_coeffs, view_directions(means, camera),
                                  sh_degree)
    return render_reference(means, covs, colors, opacities, camera,
                            background, **kw)
