"""Dataclass config system.

Port of ``sim_a_splat_tpu/utils/config.py``: one serializable config tree
for an experiment (robot/package paths, splat assets, the camera dict,
physics and rasterizer knobs) with the reference's dataclasses, field
names and JSON schema, so each package loads the other's files.

``RasterSettings.to_raster_config`` gives the port's ``RasterConfig``.
The schema carries no ``backend`` field (the reference's ``RasterConfig``
has one, but its settings never set it); the port has no backend to
choose, since it always composites with its kernels.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional


@dataclasses.dataclass
class CameraConfig:
    """One entry of the reference camera dict (type viewport|static|moving,
    link_name, local_frame (q wxyz, t), render_size (h, w))."""

    type: str = "viewport"
    render_size: tuple = (240, 320)
    local_frame_q: tuple = (1.0, 0.0, 0.0, 0.0)
    local_frame_t: tuple = (0.0, 0.0, 0.0)
    link_name: Optional[str] = None
    fov: float = 1.3089


@dataclasses.dataclass
class RobotConfig:
    package_path: str = ""
    package_name: str = ""
    urdf_name: str = ""
    eef_link_name: str = ""
    num_dof: int = 6
    weld_q: tuple = (1.0, 0.0, 0.0, 0.0)
    weld_t: tuple = (0.0, 0.0, 0.0)


@dataclasses.dataclass
class SplatAssetConfig:
    splat_assets_path: str = ""
    match_object_name: str = ""
    splat_config_name: str = ""
    task_assets_path: Optional[str] = None
    task_assets_name: Optional[str] = None


@dataclasses.dataclass
class RasterSettings:
    tile_size: int = 16
    tile_capacity: int = 1024
    max_tiles_per_gaussian: int = 16
    chunk: int = 64
    sigma_cutoff: Optional[float] = 3.0

    def to_raster_config(self) -> RasterConfig:
        # imported here: the ops import the tracer of this package
        from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
        return RasterConfig(
            tile_size=self.tile_size, tile_capacity=self.tile_capacity,
            max_tiles_per_gaussian=self.max_tiles_per_gaussian,
            chunk=self.chunk, sigma_cutoff=self.sigma_cutoff)


@dataclasses.dataclass
class ExperimentConfig:
    robot: RobotConfig = dataclasses.field(default_factory=RobotConfig)
    splat: SplatAssetConfig = dataclasses.field(
        default_factory=SplatAssetConfig)
    raster: RasterSettings = dataclasses.field(default_factory=RasterSettings)
    cameras: dict = dataclasses.field(default_factory=dict)
    env_objects: bool = True
    control_hz: int = 10
    render_size: int = 96
    seed: int = 0

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(dataclasses.asdict(self), indent=2))

    @staticmethod
    def load(path: str | Path) -> "ExperimentConfig":
        data = json.loads(Path(path).read_text())
        cameras = {int(k): CameraConfig(**v)
                   for k, v in data.pop("cameras", {}).items()}
        return ExperimentConfig(
            robot=RobotConfig(**_detuple(data.pop("robot", {}))),
            splat=SplatAssetConfig(**data.pop("splat", {})),
            raster=RasterSettings(**data.pop("raster", {})),
            cameras=cameras,
            **data,
        )


def _detuple(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
