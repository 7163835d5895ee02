"""Similarity registration: Umeyama + scaled ICP (host-side numpy).

Port of ``sim_a_splat_tpu/tools/registration.py``, the replacement of
Open3D's ``registration_icp(..., with_scaling=True)``.  Correspondences
come from the native C++ KD-tree (``sim_a_splat_torch.native``, compiled on
first use), else scipy's cKDTree, as in the reference; the per-iteration
similarity fit is the closed-form Umeyama alignment.  The output is the
same 4×4 similarity matrix (``icp_transformation.npy``) that the runtime
factors with ``Sim3.from_matrix``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _nn_index(points: np.ndarray):
    """Nearest-neighbour index with a ``query(q) → (dist, idx)`` method:
    the native C++ KD-tree when buildable, else scipy."""
    from sim_a_splat_torch import native

    if native.available():
        return native.KDTree(points)
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    return type("_SciPyNN", (), {
        "query": staticmethod(lambda q: tree.query(q, k=1)),
    })()


def umeyama(src: np.ndarray, dst: np.ndarray,
            with_scaling: bool = True) -> np.ndarray:
    """Least-squares similarity transform mapping src → dst, as 4×4.

    Closed form (Umeyama 1991): R from the SVD of the demeaned covariance,
    s = trace(DS)/σ²_src, t = μ_dst − sR μ_src.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scaling:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    m = np.eye(4)
    m[:3, :3] = s * R
    m[:3, 3] = t
    return m


@dataclasses.dataclass
class ICPResult:
    transformation: np.ndarray   # 4×4 similarity
    rmse: float
    fitness: float               # inlier fraction
    iterations: int


def icp(
    source: np.ndarray,
    target: np.ndarray,
    max_correspondence_distance: float,
    init: np.ndarray | None = None,
    with_scaling: bool = True,
    max_iterations: int = 50,
    tol: float = 1e-7,
) -> ICPResult:
    """Point-to-point ICP with optional scale — the Open3D call signature
    shape of match_splat.py:208-216."""
    src = np.asarray(source, np.float64)
    tgt = np.asarray(target, np.float64)
    T = np.eye(4) if init is None else np.asarray(init, np.float64).copy()
    tree = _nn_index(tgt)
    prev_rmse = np.inf
    it = 0
    rmse, fitness = np.inf, 0.0
    for it in range(1, max_iterations + 1):
        cur = src @ T[:3, :3].T + T[:3, 3]
        dist, idx = tree.query(cur)
        inlier = dist < max_correspondence_distance
        if inlier.sum() < 3:
            break
        rmse = float(np.sqrt((dist[inlier] ** 2).mean()))
        fitness = float(inlier.mean())
        T_new = umeyama(src[inlier], tgt[idx[inlier]], with_scaling)
        if with_scaling:
            # guard against the scale-collapse mode of scaled ICP under bad
            # correspondences: limit the per-iteration scale change
            s_old = float(np.sqrt(np.mean(np.diag(T[:3, :3].T @ T[:3, :3]))))
            sR = T_new[:3, :3]
            s_new = float(np.sqrt(np.mean(np.diag(sR.T @ sR))))
            s_cl = float(np.clip(s_new, s_old / 1.5, s_old * 1.5))
            if s_new > 0 and s_cl != s_new:
                T_new[:3, :3] *= s_cl / s_new
        T = T_new
        if abs(prev_rmse - rmse) < tol:
            break
        prev_rmse = rmse
    return ICPResult(transformation=T, rmse=rmse, fitness=fitness,
                     iterations=it)


def crop_polygon(points: np.ndarray, polygon: np.ndarray,
                 axis: int = 2,
                 axis_range: tuple | None = None) -> np.ndarray:
    """Boolean mask of points inside a polygon prism — the
    ``SelectionPolygonVolume`` analogue (match_splat.py:138-169).

    ``polygon``: (P, 2) vertices in the plane orthogonal to ``axis``.
    """
    pts2 = np.delete(np.asarray(points), axis, axis=1)
    px, py = pts2[:, 0], pts2[:, 1]
    poly = np.asarray(polygon, np.float64)
    inside = np.zeros(len(pts2), bool)
    j = len(poly) - 1
    for i in range(len(poly)):
        xi, yi = poly[i]
        xj, yj = poly[j]
        cond = (yi > py) != (yj > py)
        xint = (xj - xi) * (py - yi) / (yj - yi + 1e-300) + xi
        inside ^= cond & (px < xint)
        j = i
    if axis_range is not None:
        z = np.asarray(points)[:, axis]
        inside &= (z >= axis_range[0]) & (z <= axis_range[1])
    return inside
