"""The splatfacto deployment's capture, drawn from the run's seed: the scene
a splatfacto run has part-way through, the scene it is fitting, and the
300 posed cameras of its video, in nerfstudio's normalised frame.

- The ground truth is the arm lab scene (``pusharm_scene.arm_scene``, the
  source's product bench draws, here at the configuration's
  ``n_gaussians`` and cluster shares), moved into nerfstudio's normalised
  frame: centred on the orbit's centre and divided by the orbit's radius,
  so that the cameras lie in [-1, 1]^3 (the dataparser's
  ``auto_scale_poses``) and the world-unit thresholds of splatfacto (the
  cull's 0.5) read as they do there.
- The scene under training is the ground truth with its means moved by
  N(0, (``means_scale`` · the gaussian's mean scale)^2) on each axis, its
  DC coefficients by N(0, ``sh_dc``^2) and its opacity logits by
  N(0, ``logit_opacity``^2): a run part-way through, whose loss and
  gradients are those of a scene close to, and not at, its target.
- The cameras are a handheld video's orbit: ``views`` frames evenly spaced
  in azimuth over one turn, the elevation swinging ``waves`` times between
  the two ``elevation_deg`` bounds, each looking at the orbit's centre
  with the world's +z up (OpenCV axes: +z forward, +y down); positions
  divided by their largest coordinate (so the largest is 1); one focal
  length in pixels, the principal point at the image's centre.

Everything is float32.  It imports numpy, torch and the benchmark's own
modules: nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from perfbench.reference.pusharm_scene import arm_scene


class Views(NamedTuple):
    """V cameras: camera-to-world quaternions ``q`` (V, 4) wxyz and centres
    ``center`` (V, 3) in the normalised frame; intrinsics in pixels."""

    q: torch.Tensor
    center: torch.Tensor
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


def quat_of_matrix(R: np.ndarray) -> np.ndarray:
    """wxyz quaternion (w ≥ 0) of a rotation matrix (float64)."""
    m = R
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s]
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = 2.0 * np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2])
        q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s,
             (m[0, 2] + m[2, 0]) / s]
    elif m[1, 1] > m[2, 2]:
        s = 2.0 * np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2])
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s,
             (m[1, 2] + m[2, 1]) / s]
    else:
        s = 2.0 * np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1])
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
             (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    q = np.asarray(q)
    return q if q[0] >= 0 else -q


def orbit(cfg: dict, device) -> Views:
    """The configuration's ``views`` cameras (see the module's notes)."""
    o = cfg["orbit"]
    V = int(cfg["views"])
    H, W = (int(v) for v in cfg["resolution"])
    i = np.arange(V, dtype=np.float64)
    phi = 2.0 * np.pi * i / V
    lo, hi = np.radians(o["elevation_deg"])
    theta = lo + (hi - lo) * 0.5 * (1.0 - np.cos(2.0 * np.pi * o["waves"]
                                                 * i / V))
    pos = np.stack([np.cos(theta) * np.cos(phi), np.cos(theta) * np.sin(phi),
                    np.sin(theta)], -1)
    pos /= np.abs(pos).max()
    up = np.array([0.0, 0.0, 1.0])
    qs = []
    for p in pos:
        z = -p / np.linalg.norm(p)
        x = np.cross(z, up)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        qs.append(quat_of_matrix(np.stack([x, y, z], -1)))
    f = float(o["focal_px"])

    def on(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Views(on(qs), on(pos), f, f, W / 2.0, H / 2.0, W, H)


def scenes(cfg: dict, seed: int, gen: torch.Generator) -> tuple:
    """(ground truth, scene under training): each a dict of the six fields
    (float32, on the generator's device), in the normalised frame; the
    perturbation's draws from ``gen``."""
    leaves, _, _ = arm_scene(cfg, int(seed) % (1 << 63), gen.device)
    o = cfg["orbit"]
    c0 = torch.tensor(o["center"], dtype=torch.float32, device=gen.device)
    radius = float(o["radius_m"])
    gt = dict(leaves, means=(leaves["means"] - c0) / radius,
              log_scales=leaves["log_scales"] - float(np.log(radius)))
    p = cfg["perturb"]
    N = gt["means"].shape[0]

    def noise(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    size = torch.exp(gt["log_scales"]).mean(-1, keepdim=True)
    init = dict(gt,
                means=gt["means"] + noise(N, 3) * size * float(
                    p["means_scale"]),
                sh_dc=gt["sh_dc"] + noise(N, 3) * float(p["sh_dc"]),
                logit_opacities=gt["logit_opacities"] + noise(N) * float(
                    p["logit_opacity"]))
    return gt, init


def view_order(seed: int, views: int, steps: int) -> list:
    """The views of ``steps`` iterations: nerfstudio's per-epoch sampling
    (every view once an epoch, each epoch a fresh shuffle), drawn from the
    seed on the host."""
    g = torch.Generator().manual_seed(int(seed) % (1 << 63) + 7)
    out = []
    while len(out) < steps:
        out += torch.randperm(views, generator=g).tolist()
    return out[:steps]
