"""Typed sim → splat bridge structs.

Port of ``sim_a_splat_tpu/messaging/draw.py``: a static host-side schema
of the drawable links (the viewer's load message) and the per-frame body
poses (its draw message) as one batched SE(3).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

from sim_a_splat_torch.ops.transforms import SE3

# geometry type codes of the viewer's geometry records
GEOM_BOX = 1
GEOM_SPHERE = 2
GEOM_CYLINDER = 3
GEOM_MESH = 4


@dataclasses.dataclass(frozen=True)
class GeomSchema:
    """One visual geometry attached to a link.  ``position`` /
    ``quaternion`` are its fixed offset in the link frame; ``float_data``
    the primitive's dimensions (box x/y/z, sphere r, cylinder r/l) or the
    mesh scale; ``string_data`` the mesh path for GEOM_MESH."""

    name: str
    type: int                       # GEOM_* code
    position: tuple = (0.0, 0.0, 0.0)
    quaternion: tuple = (1.0, 0.0, 0.0, 0.0)   # wxyz
    color: tuple = (0.7, 0.7, 0.7, 1.0)        # rgba
    string_data: str = ""
    float_data: tuple = ()


@dataclasses.dataclass(frozen=True)
class LinkSchema:
    """One drawable body: its name, model-instance number (robot 3, task
    object 2) and geometry records."""

    name: str
    robot_num: int
    geoms: tuple = ()


@dataclasses.dataclass(frozen=True)
class SceneSchema:
    """Ordered link declarations: index i of the schema is index i of
    ``DrawState.poses``."""

    links: tuple

    @property
    def names(self) -> tuple:
        return tuple(l.name for l in self.links)

    def index_of(self, name: str) -> int:
        return self.names.index(name)


class DrawState(NamedTuple):
    """Per-frame body poses ordered as the schema: SE3 (..., L, ·), with a
    leading env axis for a batch of envs."""

    poses: SE3


ROBOT_NUM_TASK = 2
ROBOT_NUM_ROBOT = 3
