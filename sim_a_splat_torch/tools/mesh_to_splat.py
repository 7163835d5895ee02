"""Gaussians from a triangle mesh (task objects without trained splats).

Port of ``sim_a_splat_tpu/tools/mesh_to_splat.py``: the renderer draws one
gaussian batch, so a mesh becomes surface-sampled "flat" gaussians, disks
aligned to the local surface normal, drawn with numpy in the reference's
order (the same gaussians from a seed).
"""

from __future__ import annotations

import numpy as np
import torch

from sim_a_splat_torch import resolve_device
from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.ops import sh as sh_ops
from sim_a_splat_torch.splat.scene import GaussianScene
from sim_a_splat_torch.tools.meshio import TriMesh


def mesh_to_splat(mesh: TriMesh, n: int = 2000, color=(0.7, 0.7, 0.7),
                  thickness_ratio: float = 0.1, opacity: float = 0.95,
                  seed: int = 0, device="cuda") -> GaussianScene:
    """``n`` disk gaussians sampled on the mesh's surface (area-weighted),
    each of radius 0.8·√(area / n) and thickness ``thickness_ratio`` of
    it, its +z along the face normal; DC colour ``color``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    areas = mesh.face_areas()
    probs = areas / max(areas.sum(), 1e-12)
    fi = rng.choice(mesh.num_faces, n, p=probs)
    u, v = rng.uniform(size=(2, n, 1))
    flip = (u + v) > 1.0
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    a = mesh.vertices[mesh.faces[fi, 0]]
    b = mesh.vertices[mesh.faces[fi, 1]]
    c = mesh.vertices[mesh.faces[fi, 2]]
    pts = a + u * (b - a) + v * (c - a)

    normals = np.cross(b - a, c - a)
    normals /= np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True),
                          1e-12)
    radius = np.sqrt(areas.sum() / n) * 0.8
    scales = np.stack([np.full(n, radius), np.full(n, radius),
                       np.full(n, radius * thickness_ratio)], -1)

    # the rotation taking +z to the surface normal
    z = np.array([0.0, 0.0, 1.0])
    vaxis = np.cross(np.tile(z, (n, 1)), normals)
    s = np.linalg.norm(vaxis, axis=-1)
    angle = np.arctan2(s, normals @ z)
    axis = np.where(s[:, None] > 1e-8, vaxis / np.maximum(s[:, None], 1e-12),
                    np.tile([1.0, 0, 0], (n, 1)))
    quats = quat.from_axis_angle(torch.as_tensor(axis, dtype=torch.float32),
                                 torch.as_tensor(angle, dtype=torch.float32))
    col = torch.as_tensor(np.tile(np.asarray(color, np.float32), (n, 1)))

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return GaussianScene(
        means=f32(pts), quats=quats.to(dev),
        log_scales=f32(np.log(np.maximum(scales, 1e-8))),
        logit_opacities=torch.full((n,), float(np.log(opacity / (1 - opacity))),
                                   dtype=torch.float32, device=dev),
        sh_dc=sh_ops.rgb_to_sh(col).to(dev))


def concat_scenes(*scenes: GaussianScene) -> GaussianScene:
    """Concatenate gaussian batches; a scene without ``sh_rest`` gets zero
    rest bands where another has them."""
    if any(s.sh_rest is not None for s in scenes):
        k = max(s.sh_rest.shape[1] for s in scenes if s.sh_rest is not None)
        scenes = tuple(
            s if s.sh_rest is not None else s._replace(
                sh_rest=s.means.new_zeros((s.num_gaussians, k, 3)))
            for s in scenes)
    return GaussianScene(*(None if f[0] is None else torch.cat(f)
                           for f in zip(*scenes)))
