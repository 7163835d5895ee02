"""The arm deployment's scene, drawn from the run's seed as the source's
product bench draws it (the JAX package's
``benchmarks/bench_product.py:27-127``), in numpy, independent of the
program: a background cloud, one cluster per link of the chain at its rest
pose and a T-block cluster at the block's rest position.

Each cluster has ``n`` gaussians with random unit quaternions, a colour
with N(0, ``color_noise``) noise (clipped to [0, 1]) as its DC coefficient,
means N(0, ``spread``) about its centre, log-scales uniform in [log
``scale[0]``, log ``scale[1]``] and one opacity logit; then every gaussian
gets N(0, ``sh_rest_std``) higher SH bands.  The draws are the source's
``numpy.random.default_rng(seed)`` calls in its order.  The links' rest
positions are the chain's joint origins composed from the root (the
forward kinematics at q = 0) on the reference's own parse of the URDF.

Sizes: ``n_gaussians // link_share`` a link, ``n_gaussians //
block_share`` the block (each at least ``min_cluster``), the background
the rest.  Link id 0 is the background (static), k the chain's link k − 1,
the last the block; the masks are the source's (``link{i}`` for link i,
``task`` for the block).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.pusharm import ROOT, load_chain

SH_C0 = 0.28209479177387814


def _qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw])


def _rotate(q, v):
    w, u = q[0], q[1:]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def rest_positions(chain) -> np.ndarray:
    """(L, 3) world positions of the chain's links at q = 0."""
    L = len(chain.names)
    q, t = np.zeros((L, 4)), np.zeros((L, 3))
    q[0, 0] = 1.0
    for i in range(1, L):
        p = chain.parent[i]
        q[i] = _qmul(q[p], chain.origin_q[i])
        t[i] = _rotate(q[p], chain.origin_t[i]) + t[p]
    return t


def arm_scene(cfg: dict, seed: int, device) -> tuple:
    """(leaves, link_ids, masks): the scene's six fields (float32, on
    ``device``), (N,) int64 body ids on ``device``, and the program's link
    masks (numpy booleans, by name)."""
    sc = cfg["scene"]
    rng = np.random.default_rng(seed)
    rest = rest_positions(load_chain(ROOT / cfg["urdf"]))
    n_total = int(cfg["n_gaussians"])
    n_min = int(sc["min_cluster"])
    n_link = max(n_total // int(cfg["link_share"]), n_min)
    n_block = max(n_total // int(cfg["block_share"]), n_min)
    n_bg = n_total - len(rest) * n_link - n_block
    lo, hi = np.log(sc["scale"][0]), np.log(sc["scale"][1])

    def cluster(center, n, part):
        c = np.asarray(center, np.float32)
        q = rng.normal(size=(n, 4))
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        rgb = np.clip(np.asarray(part["color"])
                      + rng.normal(0, sc["color_noise"], (n, 3)), 0, 1)
        means = rng.normal(size=(n, 3)) * part["spread"] + c
        return dict(means=means, quats=q,
                    log_scales=rng.uniform(lo, hi, (n, 3)),
                    logit_opacities=np.full(n, sc["opacity_logit"]),
                    sh_dc=(rgb - 0.5) / SH_C0)

    parts = [cluster(sc["background"]["center"], n_bg, sc["background"])]
    sizes = [n_bg]
    for t in rest:
        parts.append(cluster(t, n_link, sc["link"]))
        sizes.append(n_link)
    parts.append(cluster(cfg["block_rest"], n_block, sc["block"]))
    sizes.append(n_block)
    n = sum(sizes)
    k_rest = (int(cfg["sh_degree"]) + 1) ** 2 - 1
    fields = {k: np.concatenate([p[k] for p in parts])
              for k in ("means", "quats", "log_scales", "logit_opacities",
                        "sh_dc")}
    if k_rest:
        fields["sh_rest"] = rng.normal(0, sc["sh_rest_std"], (n, k_rest, 3))
    leaves = {k: torch.as_tensor(v.astype(np.float32)).to(device)
              for k, v in fields.items()}
    leaves.setdefault("sh_rest", None)
    ids = np.repeat(np.arange(len(sizes)), sizes)
    masks = {f"link{i}": ids == i + 1 for i in range(len(rest))}
    masks["task"] = ids == len(sizes) - 1
    return leaves, torch.as_tensor(ids).to(device), masks
