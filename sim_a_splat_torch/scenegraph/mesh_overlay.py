"""URDF link-mesh overlay: robot visual geometry drawn next to the splats.

Port of ``sim_a_splat_tpu/scenegraph/mesh_overlay.py``.  The renderer draws
one gaussian batch, so link visuals become surface-sampled disk gaussians
(``tools/mesh_to_splat.py``) assembled into a :class:`SceneGraph` whose
body ids follow the kinematic chain: per-frame FK poses move them as they
move the splat links, and one rasterizer call draws scene and overlay.
``geom_of_visual`` gives a visual as a viewer geometry record (the
manipulator env's schema).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from sim_a_splat_torch import resolve_device
from sim_a_splat_torch.messaging.draw import (
    GEOM_BOX, GEOM_CYLINDER, GEOM_MESH, GEOM_SPHERE, GeomSchema,
)
from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.ops.transforms import SE3
from sim_a_splat_torch.physics import kinematics as kin
from sim_a_splat_torch.scenegraph.graph import SceneGraph
from sim_a_splat_torch.tools.mesh_to_splat import concat_scenes, mesh_to_splat
from sim_a_splat_torch.tools.meshio import (
    TriMesh, box_mesh, cylinder_mesh, icosphere, load_mesh,
)

_TYPE_OF = {"box": GEOM_BOX, "sphere": GEOM_SPHERE,
            "cylinder": GEOM_CYLINDER, "mesh": GEOM_MESH}


def geom_of_visual(link_name: str, vis: kin.VisualInfo) -> GeomSchema:
    """VisualInfo (URDF parse) → GeomSchema record: the visual's origin as
    position and quaternion, its colour, mesh path, and the mesh scale or
    the primitive's dimensions as ``float_data``."""
    q = kin._rpy_to_quat_np(np.asarray(vis.origin_rpy, np.float64))
    fdata = tuple(vis.scale) if vis.geom_type == "mesh" else tuple(vis.size)
    return GeomSchema(
        name=link_name, type=_TYPE_OF[vis.geom_type],
        position=tuple(vis.origin_xyz), quaternion=tuple(q),
        color=tuple(vis.color), string_data=vis.mesh_path or "",
        float_data=fdata)


def visual_mesh(vis: kin.VisualInfo,
                resolve: Optional[Callable[[str], Path]] = None) -> TriMesh:
    """The TriMesh of one URDF visual in its link's frame (the visual's
    origin applied); ``resolve`` maps a mesh URI to a path."""
    if vis.geom_type == "mesh":
        path = vis.mesh_path
        if resolve is not None:
            path = resolve(path)
        mesh = load_mesh(path)
        mesh = TriMesh(mesh.vertices * np.asarray(vis.scale, np.float64),
                       mesh.faces)
    elif vis.geom_type == "box":
        mesh = box_mesh(*vis.size)
    elif vis.geom_type == "cylinder":
        mesh = cylinder_mesh(*vis.size)
    elif vis.geom_type == "sphere":
        m = icosphere(2)
        mesh = TriMesh(m.vertices * vis.size[0], m.faces)
    else:
        raise ValueError(f"unknown geom type {vis.geom_type}")
    q = kin._rpy_to_quat_np(np.asarray(vis.origin_rpy, np.float64))
    R = quat.to_rotation_matrix(
        torch.as_tensor(q, dtype=torch.float32)).numpy().astype(np.float64)
    return TriMesh(mesh.vertices @ R.T + np.asarray(vis.origin_xyz),
                   mesh.faces)


def _with_identity0(q: torch.Tensor, t: torch.Tensor) -> SE3:
    """Poses (..., L, ·) with an identity slot 0 prepended → (..., L+1)."""
    ident = q.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(*q.shape[:-2], 1, 4)
    return SE3(torch.cat([ident, q], -2),
               torch.cat([t.new_zeros(*t.shape[:-2], 1, 3), t], -2))


def urdf_overlay_graph(
    chain: kin.KinematicChain,
    q_rest,
    n_per_link: int = 600,
    resolve: Optional[Callable[[str], Path]] = None,
    base: Optional[SE3] = None,
    seed: int = 0,
    device="cuda",
) -> Optional[SceneGraph]:
    """SceneGraph of disk-gaussian link visuals posed at ``q_rest``, link i
    as body i + 1; ``posed(overlay_frame_poses(chain, q))`` moves them with
    the arm.  None when no link has a visual."""
    dev = resolve_device(device)
    if base is None:
        base = SE3.identity(device=dev)
    rest = kin.fk(chain, torch.as_tensor(np.asarray(q_rest, np.float32),
                                         device=dev), base)
    parts, ids = [], []
    for i in range(chain.num_links):
        vis = chain.visuals[i]
        if vis is None:
            continue
        local = mesh_to_splat(visual_mesh(vis, resolve), n=n_per_link,
                              color=tuple(vis.color[:3]), seed=seed + i,
                              device=dev)
        # into the world at the rest configuration
        q_i, t_i = rest.q[i], rest.t[i]
        parts.append(local._replace(
            means=quat.rotate(q_i, local.means) + t_i,
            quats=quat.multiply(q_i, local.quats)))
        ids.append(np.full(local.num_gaussians, i, np.int64))
    if not parts:
        return None
    link_ids = torch.as_tensor(np.concatenate(ids) + 1, device=dev)
    return SceneGraph(scene=concat_scenes(*parts), link_ids=link_ids,
                      rest_inv=_rest_inv_with_identity0(
                          _with_identity0(rest.q, rest.t)))


def _rest_inv_with_identity0(rest_poses: SE3) -> SE3:
    """The inverses of ``rest_poses`` (L+1,) with slot 0 the identity."""
    inv = rest_poses.inverse()
    return _with_identity0(inv.q[1:], inv.t[1:])


def overlay_frame_poses(chain: kin.KinematicChain, q: torch.Tensor,
                        base: Optional[SE3] = None) -> SE3:
    """Body poses (..., L+1) for ``SceneGraph.posed``: the identity in slot
    0, then the FK world poses at ``q`` (..., ndof)."""
    fkp = kin.fk(chain, q, base)
    return _with_identity0(fkp.q, fkp.t)
