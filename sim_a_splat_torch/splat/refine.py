"""Gaussian refinement ops: cull / split / duplicate.

Port of ``sim_a_splat_tpu/splat/refine.py`` (splatfacto's
``cull_gaussians_refinement`` / ``split_gaussians``): pure functions from a
:class:`GaussianScene` to a new one, with the reference's output order.
Culling keeps rows by a device mask; a split replaces each masked gaussian
by ``n`` samples of its own distribution with scales shrunk by 1.6 (the
splatfacto constant).  The samples' standard-normal draws come from a
``torch.Generator`` seeded with ``seed`` (the reference's
``jax.random.normal`` stream cannot be reproduced), and the rest of the
split is :func:`split_with_draws`, which takes the draws as input.
"""

from __future__ import annotations

import numpy as np
import torch

from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.splat.scene import GaussianScene
from sim_a_splat_torch.tools.mesh_to_splat import concat_scenes

SPLIT_SCALE_SHRINK = 1.6   # splatfacto's size_fac
# float32 log(1.6) as the reference computes it (0.47000366, one ulp above
# the correctly rounded 0.47000363 of math.log)
_LOG_SHRINK = np.log(np.float32(SPLIT_SCALE_SHRINK))


def rows(scene: GaussianScene, mask: torch.Tensor) -> GaussianScene:
    """The scene's rows where ``mask`` (N,) is set."""
    return GaussianScene(*(None if f is None else f[mask] for f in scene))


def _device_mask(scene: GaussianScene, mask) -> torch.Tensor:
    """A numpy or torch (N,) mask as a bool tensor on the scene's device."""
    if not torch.is_tensor(mask):
        mask = torch.as_tensor(np.asarray(mask, bool))
    return mask.to(device=scene.means.device, dtype=torch.bool)


def cull_mask(scene: GaussianScene, cull_alpha_thresh: float = 0.1,
              cull_scale_thresh: float = 0.5) -> torch.Tensor:
    """(N,) bool, on the scene's device: the gaussians a cull keeps, those
    with opacity ≥ α-thresh and max scale ≤ scale-thresh."""
    return ((scene.opacities() >= cull_alpha_thresh)
            & (scene.scales().amax(-1) <= cull_scale_thresh))


def cull_gaussians(
    scene: GaussianScene,
    cull_alpha_thresh: float = 0.1,
    cull_scale_thresh: float = 0.5,
) -> GaussianScene:
    """Drop gaussians with opacity < α-thresh or max scale > scale-thresh
    (splatfacto's cull_params)."""
    return rows(scene, cull_mask(scene, cull_alpha_thresh,
                                  cull_scale_thresh))


def standard_normal(seed: int, shape, device) -> torch.Tensor:
    """The split's (n, m, 3) standard-normal draws: a CPU
    ``torch.Generator`` seeded with ``seed``, so that every device draws
    the same numbers."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device)


def split_with_draws(scene: GaussianScene, mask: torch.Tensor,
                     eps: torch.Tensor) -> GaussianScene:
    """The split of the ``mask``ed gaussians given their draws ``eps``
    (n, m, 3): offsets eps·scales in each gaussian's frame, rotated to the
    world; the kept gaussians first, then the n samples, sample-major."""
    n = eps.shape[0]
    sel = rows(scene, mask)
    m = sel.num_gaussians
    offsets = eps * sel.scales()[None]                      # local frame
    world_off = quat.rotate(sel.quats.expand(n, m, 4), offsets)
    new_means = (sel.means[None] + world_off).reshape(-1, 3)

    def rep(a):
        return a.repeat((n,) + (1,) * (a.dim() - 1))

    split = GaussianScene(
        means=new_means,
        quats=rep(sel.quats),
        log_scales=rep(sel.log_scales) - float(_LOG_SHRINK),
        logit_opacities=rep(sel.logit_opacities),
        sh_dc=rep(sel.sh_dc),
        sh_rest=None if sel.sh_rest is None else rep(sel.sh_rest),
    )
    keep = rows(scene, ~mask)
    if keep.num_gaussians == 0:
        return split
    return concat_scenes(keep, split)


def split_gaussians(
    scene: GaussianScene,
    split_mask=None,
    n_split_samples: int = 2,
    seed: int = 0,
) -> GaussianScene:
    """Replace masked gaussians (all, without a mask) by ``n`` samples from
    their own distribution with scales shrunk by 1.6 (splatfacto's
    split_params)."""
    dev = scene.means.device
    mask = (torch.ones(scene.num_gaussians, dtype=torch.bool, device=dev)
            if split_mask is None else _device_mask(scene, split_mask))
    m = int(mask.sum())
    return split_with_draws(scene, mask, standard_normal(
        seed, (n_split_samples, m, 3), dev))


def duplicate_gaussians(scene: GaussianScene, dup_mask) -> GaussianScene:
    """Append copies of the masked gaussians (splatfacto dup_gaussians)."""
    return concat_scenes(scene, rows(scene, _device_mask(scene, dup_mask)))
