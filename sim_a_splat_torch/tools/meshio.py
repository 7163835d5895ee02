"""Minimal host-side triangle-mesh IO and sampling (numpy only).

A copy of ``sim_a_splat_tpu/tools/meshio.py`` (it imports no JAX; the port
keeps its own copy so that it imports nothing of the JAX package).

Replaces the reference's Open3D mesh IO + Poisson-disk sampling
(match_splat.py:74-105, splat_handler.py:165-175, native component N10):
OBJ/STL parsing and blue-noise-like surface sampling (uniform area-weighted
oversample + farthest-point thinning) with no native dependency.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


class TriMesh:
    """Vertices (V, 3) float64 + faces (F, 3) int32."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        self.vertices = np.asarray(vertices, np.float64).reshape(-1, 3)
        self.faces = np.asarray(faces, np.int64).reshape(-1, 3)

    def transformed(self, matrix4: np.ndarray) -> "TriMesh":
        v = self.vertices @ matrix4[:3, :3].T + matrix4[:3, 3]
        return TriMesh(v, self.faces)

    def scaled(self, s) -> "TriMesh":
        return TriMesh(self.vertices * np.asarray(s), self.faces)

    def face_areas(self) -> np.ndarray:
        v = self.vertices
        a, b, c = (v[self.faces[:, i]] for i in range(3))
        return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)

    @property
    def num_faces(self) -> int:
        return len(self.faces)

    def concat(self, other: "TriMesh") -> "TriMesh":
        return TriMesh(
            np.concatenate([self.vertices, other.vertices]),
            np.concatenate([self.faces, other.faces + len(self.vertices)]),
        )


def load_obj(path: str | Path) -> TriMesh:
    verts, faces = [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                # triangulate polygons as a fan; OBJ is 1-based
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0] - 1, idx[k] - 1, idx[k + 1] - 1])
    return TriMesh(np.asarray(verts), np.asarray(faces))


def load_stl(path: str | Path) -> TriMesh:
    raw = Path(path).read_bytes()
    if raw[:5].lower() == b"solid" and b"facet" in raw[:500]:
        # ascii STL
        verts = []
        for line in raw.decode(errors="replace").splitlines():
            t = line.split()
            if t[:1] == ["vertex"]:
                verts.append([float(x) for x in t[1:4]])
        v = np.asarray(verts).reshape(-1, 3)
        f = np.arange(len(v)).reshape(-1, 3)
        return TriMesh(v, f)
    n = struct.unpack("<I", raw[80:84])[0]
    data = np.frombuffer(raw[84:84 + n * 50], dtype=np.uint8).reshape(n, 50)
    tri = data[:, 12:48].copy().view("<f4").reshape(n, 3, 3)
    v = tri.reshape(-1, 3).astype(np.float64)
    f = np.arange(len(v)).reshape(-1, 3)
    return TriMesh(v, f)


def load_mesh(path: str | Path) -> TriMesh:
    ext = Path(path).suffix.lower()
    if ext == ".obj":
        return load_obj(path)
    if ext == ".stl":
        return load_stl(path)
    raise ValueError(f"unsupported mesh format: {path}")


def sample_surface(mesh: TriMesh, n: int, seed: int = 0) -> np.ndarray:
    """Uniform area-weighted surface sampling → (n, 3)."""
    rng = np.random.default_rng(seed)
    areas = mesh.face_areas()
    probs = areas / max(areas.sum(), 1e-12)
    fi = rng.choice(mesh.num_faces, n, p=probs)
    u = rng.uniform(size=(n, 1))
    v = rng.uniform(size=(n, 1))
    flip = (u + v) > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    a = mesh.vertices[mesh.faces[fi, 0]]
    b = mesh.vertices[mesh.faces[fi, 1]]
    c = mesh.vertices[mesh.faces[fi, 2]]
    return a + u * (b - a) + v * (c - a)


def sample_poisson_disk(mesh: TriMesh, n: int, seed: int = 0,
                        oversample: int = 5) -> np.ndarray:
    """Blue-noise-ish sampling: oversample uniformly, thin by farthest-point
    (the role of Open3D's sample_points_poisson_disk in match_splat.py:99)."""
    pts = sample_surface(mesh, n * oversample, seed)
    chosen = np.zeros(n, np.int64)
    d = np.linalg.norm(pts - pts[0], axis=-1)
    for i in range(1, n):
        chosen[i] = int(np.argmax(d))
        d = np.minimum(d, np.linalg.norm(pts - pts[chosen[i]], axis=-1))
    return pts[chosen]


def save_obj(path: str | Path, mesh: TriMesh) -> None:
    with open(path, "w") as f:
        for v in mesh.vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for a, b, c in mesh.faces + 1:
            f.write(f"f {a} {b} {c}\n")


def icosphere(subdivisions: int = 1) -> TriMesh:
    """Unit icosphere (for ellipsoid mesh export, ellipsoids/mesh_utils.py)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.asarray([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    f = np.asarray([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdivisions):
        mid = {}
        nv = list(v)
        nf = []
        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in mid:
                m = (v[i] + v[j]) / 2.0
                m /= np.linalg.norm(m)
                mid[key] = len(nv)
                nv.append(m)
            return mid[key]
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(nv)
        f = np.asarray(nf)
    return TriMesh(v, f)


def box_mesh(sx: float, sy: float, sz: float) -> TriMesh:
    """Axis-aligned box centered at the origin (URDF <box size=.../>)."""
    hx, hy, hz = sx / 2.0, sy / 2.0, sz / 2.0
    v = np.asarray([[x, y, z] for x in (-hx, hx) for y in (-hy, hy)
                    for z in (-hz, hz)], np.float64)
    f = np.asarray([
        [0, 1, 3], [0, 3, 2],          # -x
        [4, 6, 7], [4, 7, 5],          # +x
        [0, 4, 5], [0, 5, 1],          # -y
        [2, 3, 7], [2, 7, 6],          # +y
        [0, 2, 6], [0, 6, 4],          # -z
        [1, 5, 7], [1, 7, 3],          # +z
    ], np.int64)
    return TriMesh(v, f)


def cylinder_mesh(radius: float, length: float, segments: int = 24) -> TriMesh:
    """Z-axis cylinder centered at the origin (URDF <cylinder .../>)."""
    ang = 2.0 * np.pi * np.arange(segments) / segments
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang)], -1)
    lo = np.concatenate([ring, np.full((segments, 1), -length / 2.0)], -1)
    hi = np.concatenate([ring, np.full((segments, 1), length / 2.0)], -1)
    v = np.concatenate([lo, hi,
                        [[0.0, 0.0, -length / 2.0]],
                        [[0.0, 0.0, length / 2.0]]])
    cb, ct = 2 * segments, 2 * segments + 1
    f = []
    for i in range(segments):
        j = (i + 1) % segments
        f += [[i, j, segments + i], [j, segments + j, segments + i]]  # side
        f += [[cb, j, i], [ct, segments + i, segments + j]]           # caps
    return TriMesh(v, np.asarray(f, np.int64))
