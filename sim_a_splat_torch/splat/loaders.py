"""Scene loaders.

Port of ``synthetic_scene`` from ``sim_a_splat_tpu/splat/loaders.py``: the
deterministic random toy scene, drawn with numpy in the reference's order
so that both packages build the same scene from a seed.  (The file formats
come with the scene IO of the trainer.)
"""

from __future__ import annotations

import numpy as np
import torch

from sim_a_splat_torch import resolve_device
from sim_a_splat_torch.ops import sh as sh_ops
from sim_a_splat_torch.splat.scene import GaussianScene


def synthetic_scene(n: int = 64, seed: int = 0, extent: float = 1.0,
                    scale_range: tuple[float, float] = (0.02, 0.08),
                    sh_degree: int = 0, device="cuda") -> GaussianScene:
    """N random gaussians in [-extent, extent]³ on ``device``: unit quats,
    log-uniform scales in ``scale_range``, logit opacities in [0.5, 3],
    DC colours from RGB in [0.1, 0.9], and with ``sh_degree`` > 0 rest
    bands ~ N(0, 0.1²)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    means = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    log_scales = np.log(
        rng.uniform(scale_range[0], scale_range[1], (n, 3))).astype(np.float32)
    logit_opacities = rng.uniform(0.5, 3.0, (n,)).astype(np.float32)
    rgb = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    sh_dc = sh_ops.rgb_to_sh(torch.as_tensor(rgb))
    sh_rest = None
    if sh_degree > 0:
        k = (sh_degree + 1) ** 2 - 1
        sh_rest = torch.as_tensor(
            (rng.normal(size=(n, k, 3)) * 0.1).astype(np.float32))
    return GaussianScene(*(None if a is None else
                           torch.as_tensor(a, dtype=torch.float32).to(dev)
                           for a in (means, quats, log_scales,
                                     logit_opacities, sh_dc, sh_rest)))
