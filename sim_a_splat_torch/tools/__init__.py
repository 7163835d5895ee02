"""Offline tooling: mesh IO, gaussians from meshes and the demo assets."""

from sim_a_splat_torch.tools import meshio
from sim_a_splat_torch.tools.mesh_to_splat import concat_scenes, mesh_to_splat

__all__ = ["meshio", "concat_scenes", "mesh_to_splat"]
