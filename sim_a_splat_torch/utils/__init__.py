"""Utilities: profiling, configuration, episode storage, checkpointing."""

from sim_a_splat_torch.utils.config import (
    CameraConfig, ExperimentConfig, RasterSettings, RobotConfig,
    SplatAssetConfig,
)
from sim_a_splat_torch.utils.episodes import (
    EpisodeRecorder, restore_checkpoint, save_checkpoint,
)
from sim_a_splat_torch.utils.profiling import device_trace, time_jitted

__all__ = [
    "CameraConfig", "ExperimentConfig", "RasterSettings", "RobotConfig",
    "SplatAssetConfig", "EpisodeRecorder", "restore_checkpoint",
    "save_checkpoint", "device_trace", "time_jitted",
]
