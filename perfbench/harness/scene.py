"""A configuration's scene, made on the device from the run's seed in a
few large draws: the weights of this system.

The pushT scene (``scene.kind`` "pusht"): a floor of gaussians spread over
the table at one height, a T-block of gaussians drawn in the bounding boxes
of its two boxes, and an agent of gaussians drawn around its centre, each
part with random unit quaternions, log-scales uniform in [log s/2, log s],
one opacity logit, a colour with N(0, 0.05) noise as its DC coefficient and
N(0, 0.02) higher SH bands.  Link id 0 is the static floor, 1 the block,
2 the agent.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SH_C0 = 0.28209479177387814


def tee_boxes(scale: float, length: float) -> np.ndarray:
    """(2, 2, 2) [lo, hi] corners of the T-block's two boxes in its frame."""
    return np.asarray([[[-length * scale / 2, 0.0],
                        [length * scale / 2, scale]],
                       [[-scale / 2, scale], [scale / 2, length * scale]]],
                      np.float32)


def pusht_scene(cfg: dict, gen: torch.Generator) -> tuple:
    """(leaves, link_ids): the scene's six fields (float32, on the
    generator's device) and (N,) int64 body ids."""
    sc, dev = cfg["scene"], gen.device
    N = int(cfg["n_gaussians"])
    n_block, n_agent = int(cfg["n_block"]), int(cfg["n_agent"])
    n_bg = N - n_block - n_agent
    degree = int(cfg["sh_degree"])

    def uniform(n, lo, hi):
        lo = torch.as_tensor(lo, dtype=torch.float32, device=dev)
        hi = torch.as_tensor(hi, dtype=torch.float32, device=dev)
        return lo + (hi - lo) * torch.rand((n,) + tuple(lo.shape),
                                           generator=gen, device=dev)

    boxes = tee_boxes(sc["tee_scale"], sc["tee_length"])
    half = n_block // 2
    xy = torch.cat([
        uniform(n_bg, [0.0, 0.0], sc["floor_xy"]),
        uniform(half, boxes[0, 0], boxes[0, 1]),
        uniform(n_block - half, boxes[1, 0], boxes[1, 1]),
        torch.randn((n_agent, 2), generator=gen, device=dev)
        * float(sc["agent_spread"])])
    z = torch.cat([torch.full((n_bg,), float(sc["floor_z"]), device=dev),
                   torch.zeros(n_block + n_agent, device=dev)])
    sizes = (n_bg, n_block, n_agent)
    parts = ("floor", "block", "agent")
    scale = torch.cat([torch.full((n,), float(sc[p]["scale"]), device=dev)
                       for n, p in zip(sizes, parts)])
    color = torch.cat([torch.tensor(sc[p]["color"], dtype=torch.float32,
                                    device=dev).expand(n, 3)
                       for n, p in zip(sizes, parts)])
    q = torch.randn((N, 4), generator=gen, device=dev)
    u = torch.rand((N, 3), generator=gen, device=dev)
    log_s = (torch.log(0.5 * scale) + u.T * math.log(2.0)).T
    dc = (color + 0.05 * torch.randn((N, 3), generator=gen, device=dev)
          - 0.5) / SH_C0
    k_rest = (degree + 1) ** 2 - 1
    leaves = dict(
        means=torch.cat([xy, z[:, None]], 1),
        quats=q / q.norm(dim=-1, keepdim=True),
        log_scales=log_s,
        logit_opacities=torch.full((N,), float(sc["opacity_logit"]),
                                   device=dev),
        sh_dc=dc,
        sh_rest=0.02 * torch.randn((N, k_rest, 3), generator=gen, device=dev)
        if degree > 0 else None)
    link_ids = torch.cat([torch.full((n,), i, dtype=torch.long, device=dev)
                          for i, n in enumerate(sizes)])
    return leaves, link_ids
