"""Interactive browser viewer for splat scenes: an in-process renderer
behind a stdlib HTTP server that streams frames and takes orbit-camera and
slider input (``viewer/server.py``)."""

from sim_a_splat_torch.viewer.server import (
    SliderSpec, SplatViewer, orbit_pose, scene_render_fn,
)

__all__ = ["SliderSpec", "SplatViewer", "orbit_pose", "scene_render_fn"]
