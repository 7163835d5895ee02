"""Splat exports: ellipsoid meshes and standard .ply dumps.

Port of ``sim_a_splat_tpu/splat/export.py``: ``ellipsoid_mesh`` (one
scaled, rotated and translated icosphere per gaussian), its ascii .ply
writer, and the 3DGS-standard binary .ply writer that
``splat/loaders.py::load_ply`` reads back.  All of it runs on the host.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.splat.scene import GaussianScene
from sim_a_splat_torch.tools.meshio import TriMesh, icosphere


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy()


def ellipsoid_mesh(
    scene: GaussianScene,
    n_sigma: float = 1.0,
    subdivisions: int = 1,
    max_gaussians: int | None = 2000,
    seed: int = 0,
) -> tuple[TriMesh, np.ndarray]:
    """One ellipsoid per gaussian → (mesh, per-vertex colors): an icosphere
    scaled by n_sigma·scales, rotated by R(q), translated to the mean;
    subsampled to ``max_gaussians`` (numpy's ``default_rng(seed)``)."""
    ico = icosphere(subdivisions)
    means = _np(scene.means)
    scales = _np(scene.scales())
    R = _np(quat.to_rotation_matrix(scene.quats))
    colors = np.clip(_np(scene.colors_dc()), 0.0, 1.0)

    n = len(means)
    idx = np.arange(n)
    if max_gaussians is not None and n > max_gaussians:
        idx = np.random.default_rng(seed).choice(n, max_gaussians,
                                                 replace=False)
    V = len(ico.vertices)
    verts = (ico.vertices[None] * (n_sigma * scales[idx][:, None]))
    verts = np.einsum("nij,nvj->nvi", R[idx], verts) + means[idx][:, None]
    faces = (ico.faces[None] + (np.arange(len(idx)) * V)[:, None, None])
    vcolors = np.repeat(colors[idx], V, axis=0)
    return TriMesh(verts.reshape(-1, 3), faces.reshape(-1, 3)), vcolors


def save_ellipsoid_ply(path: str | Path, scene: GaussianScene, **kw) -> None:
    """Colored ellipsoid mesh as ascii .ply."""
    mesh, colors = ellipsoid_mesh(scene, **kw)
    c8 = (colors * 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(mesh.vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(mesh.faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v, c in zip(mesh.vertices, c8):
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f} {c[0]} {c[1]} {c[2]}\n")
        for a, b, cc in mesh.faces:
            f.write(f"3 {a} {b} {cc}\n")


def save_ply(path: str | Path, scene: GaussianScene) -> None:
    """Standard INRIA/gsplat splat .ply (binary little-endian), the format
    ``loaders.load_ply`` reads back."""
    n = scene.num_gaussians
    sh_rest = scene.sh_rest
    k = 0 if sh_rest is None else sh_rest.shape[1]
    props = (["x", "y", "z", "nx", "ny", "nz",
              "f_dc_0", "f_dc_1", "f_dc_2"]
             + [f"f_rest_{i}" for i in range(3 * k)]
             + ["opacity", "scale_0", "scale_1", "scale_2",
                "rot_0", "rot_1", "rot_2", "rot_3"])
    cols = [_np(scene.means), np.zeros((n, 3), np.float32), _np(scene.sh_dc)]
    if k:
        # channel-major layout (all R coeffs, all G, all B)
        cols.append(_np(sh_rest).transpose(0, 2, 1).reshape(n, 3 * k))
    cols += [_np(scene.logit_opacities).reshape(n, 1),
             _np(scene.log_scales), _np(scene.quats)]
    data = np.concatenate([c.astype(np.float32) for c in cols],
                          axis=1).astype("<f4")
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}"]
        header += [f"property float {p}" for p in props]
        header += ["end_header"]
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(data.tobytes())
