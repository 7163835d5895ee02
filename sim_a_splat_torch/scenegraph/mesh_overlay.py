"""URDF link visuals as viewer geometry records.

Port of ``geom_of_visual`` from ``sim_a_splat_tpu/scenegraph/
mesh_overlay.py`` (the manipulator env's schema needs it).  The rest of
that module samples link meshes into gaussians and needs the mesh tools,
which the port does not have yet.
"""

from __future__ import annotations

import numpy as np

from sim_a_splat_torch.messaging.draw import (
    GEOM_BOX, GEOM_CYLINDER, GEOM_MESH, GEOM_SPHERE, GeomSchema,
)
from sim_a_splat_torch.physics import kinematics as kin

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
