"""Synthetic demo assets: a "trained splat" and its segmentation artifacts.

Port of ``sim_a_splat_tpu/tools/demo_assets.py``.  It writes a
self-contained stand-in for a registered splatfacto scene with the offline
matcher's artifact schema:

- ``<assets>/splatfacto/<run>/splat.npz``          the scene, splat frame
- ``<assets>/masks/<name>/link_masks_global_dict.npy``
- ``<assets>/masks/<name>/icp_transformation.npy`` 4×4 similarity
- ``<assets>/masks/<name>/joint_config.npy``       capture joint config
- ``<assets>/tblock_paper/tblock_paper.obj``       task mesh

The robot is drawn as per-link gaussian "capsules" along the kinematic
chain at the capture configuration, on a checkered ground plane, then
mapped into a splat frame by a similarity of scale 0.2112.  The numpy draws
are the reference's calls in its order, so both packages write the same
tree from a seed (to float32 rounding of the forward kinematics and the
similarity).  Everything runs on the host.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from sim_a_splat_torch.envs.manipulator_envs import TBlockParams
from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.ops.sh import rgb_to_sh
from sim_a_splat_torch.ops.transforms import Sim3
from sim_a_splat_torch.physics import kinematics as kin
from sim_a_splat_torch.splat import loaders
from sim_a_splat_torch.splat.scene import GaussianScene
from sim_a_splat_torch.tools.meshio import TriMesh, save_obj

LINK_COLORS = np.asarray([
    [0.35, 0.35, 0.40], [0.85, 0.30, 0.25], [0.90, 0.65, 0.20],
    [0.35, 0.70, 0.30], [0.25, 0.55, 0.85], [0.55, 0.35, 0.80],
    [0.85, 0.40, 0.65], [0.45, 0.75, 0.75],
])


def _sh_of(rgb: np.ndarray) -> np.ndarray:
    return rgb_to_sh(torch.as_tensor(rgb, dtype=torch.float32)).numpy()


def _capsule(rng, p0, p1, radius, n, color):
    """Gaussian cluster along the segment p0 → p1 (one link's 'visual')."""
    t = rng.uniform(0.0, 1.0, (n, 1))
    axis_pts = p0[None, :] + t * (p1 - p0)[None, :]
    pts = axis_pts + rng.normal(0, radius * 0.5, (n, 3))
    return dict(
        means=pts,
        quats=np.tile([1.0, 0, 0, 0], (n, 1)),
        log_scales=rng.uniform(np.log(radius * 0.4), np.log(radius * 0.8),
                               (n, 3)),
        logit_opacities=np.full(n, 2.5),
        sh_dc=_sh_of(np.clip(color + rng.normal(0, 0.03, (n, 3)), 0, 1)),
    )


def _ground(rng, n, extent=1.2, z=-0.01):
    pts = np.concatenate([rng.uniform(-extent, extent, (n, 2)),
                          np.full((n, 1), z)], 1)
    checker = ((pts[:, 0] // 0.15 + pts[:, 1] // 0.15) % 2)[:, None]
    color = np.where(checker > 0, [0.82, 0.80, 0.75], [0.68, 0.67, 0.64])
    return dict(
        means=pts,
        quats=np.tile([1.0, 0, 0, 0], (n, 1)),
        log_scales=np.concatenate([
            rng.uniform(np.log(0.02), np.log(0.05), (n, 2)),
            np.full((n, 1), np.log(0.003))], 1),
        logit_opacities=np.full(n, 3.0),
        sh_dc=_sh_of(np.clip(color + rng.normal(0, 0.02, (n, 3)), 0, 1)),
    )


def tblock_mesh(params: TBlockParams = TBlockParams(),
                height: float = 0.04) -> TriMesh:
    """Extruded T-block (crossbar and stem boxes, ``height`` tall), 24
    triangles."""
    verts, faces = [], []
    for poly in params.polys_local():          # (4, 2) CCW
        base = len(verts)
        for z in (0.0, height):
            for x, y in poly:
                verts.append([x, y, z])
        quads = [(0, 1, 2, 3)[::-1],           # bottom (faces down)
                 (4, 5, 6, 7)]                 # top
        for i in range(4):                     # sides
            j = (i + 1) % 4
            quads.append((i, j, j + 4, i + 4))
        for a, b, c, d in quads:
            faces.append([base + a, base + b, base + c])
            faces.append([base + a, base + c, base + d])
    return TriMesh(np.asarray(verts, np.float32),
                   np.asarray(faces, np.int32))


def build_demo_assets(
    assets_dir: str | Path,
    urdf_path: str | Path,
    match_object_name: str = "pusharm6",
    run_name: str = "demo-run",
    joint_config=None,
    n_per_link: int = 350,
    n_ground: int = 4000,
    seed: int = 0,
    icp_scale: float = 0.2112,
) -> dict:
    """Write the demo asset tree (``n_per_link`` gaussians on each
    non-world link, ``n_ground`` on the ground); returns the paths dict
    that the splat env's constructor takes."""
    assets = Path(assets_dir)
    rng = np.random.default_rng(seed)
    chain = kin.load_chain(urdf_path)
    if joint_config is None:
        joint_config = np.zeros(chain.ndof, np.float32)
    joint_config = np.asarray(joint_config, np.float32)
    fk = kin.fk(chain, torch.as_tensor(joint_config))
    fk_t = fk.t.numpy()

    # per-link capsules: from each link origin to the mean of its children
    # (leaf links get a short stub along their z axis)
    children: dict[int, list] = {i: [] for i in range(chain.num_links)}
    for i in range(1, chain.num_links):
        children[int(chain.parent[i])].append(i)
    parts, names = [], []
    li = 0
    for i, name in enumerate(chain.link_names):
        if name == "world":
            continue
        p0 = fk_t[i]
        if children[i]:
            p1 = np.mean([fk_t[c] for c in children[i]], axis=0)
        else:
            R = quat.to_rotation_matrix(fk.q[i]).numpy()
            p1 = p0 + R @ np.asarray([0.0, 0, 0.05])
        radius = 0.035 if children[i] else 0.02
        parts.append(_capsule(rng, p0, p1, radius, n_per_link,
                              LINK_COLORS[li % len(LINK_COLORS)]))
        names.append(f"link{li}")
        li += 1
    ground = _ground(rng, n_ground)

    def cat(k):
        return torch.as_tensor(np.concatenate(
            [p[k] for p in parts] + [ground[k]]).astype(np.float32))

    scene_world = GaussianScene(cat("means"), cat("quats"), cat("log_scales"),
                                cat("logit_opacities"), cat("sh_dc"))

    # masks over the global gaussian order (robot parts first, then ground)
    sizes = [p["means"].shape[0] for p in parts] + [n_ground]
    off = np.cumsum([0] + sizes)
    masks = {}
    for j, name in enumerate(names):
        m = np.zeros(off[-1], bool)
        m[off[j]:off[j + 1]] = True
        masks[name] = m

    # similarity world → splat frame (what ICP would have recovered)
    icp = Sim3(quat.from_rpy(torch.tensor([0.15, -0.1, 0.4])),
               torch.tensor([0.25, -0.15, 0.08]), torch.tensor(icp_scale))
    scene_splat = scene_world._replace(
        means=icp.apply(scene_world.means),
        quats=quat.multiply(icp.q, scene_world.quats),
        log_scales=scene_world.log_scales + torch.log(icp.s),
    )

    run_dir = assets / "splatfacto" / run_name
    run_dir.mkdir(parents=True, exist_ok=True)
    loaders.save_npz(run_dir / "splat.npz", scene_splat)

    masks_dir = assets / "masks" / match_object_name
    masks_dir.mkdir(parents=True, exist_ok=True)
    np.save(masks_dir / "link_masks_global_dict.npy",
            np.asarray(masks, dtype=object))
    np.save(masks_dir / "icp_transformation.npy",
            icp.as_matrix().numpy().astype(np.float64))
    np.save(masks_dir / "joint_config.npy", joint_config)

    task_dir = assets / "tblock_paper"
    task_dir.mkdir(parents=True, exist_ok=True)
    save_obj(task_dir / "tblock_paper.obj", tblock_mesh())

    return {
        "assets": assets,
        "splat_config_name": f"{run_name}/splat.npz",
        "match_object_name": match_object_name,
        "masks_dir": masks_dir,
        "task_assets_path": task_dir,
        "task_assets_name": "tblock_paper.obj",
        "joint_config": joint_config,
    }
