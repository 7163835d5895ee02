"""Offline tooling: mesh IO, gaussians from meshes, the demo assets,
registration/ICP, mask extraction and the splat↔robot matcher."""

from sim_a_splat_torch.tools import masks, match, meshio, registration
from sim_a_splat_torch.tools.match import match as run_match
from sim_a_splat_torch.tools.mesh_to_splat import concat_scenes, mesh_to_splat
from sim_a_splat_torch.tools.registration import icp, umeyama

__all__ = ["masks", "match", "meshio", "registration", "run_match",
           "concat_scenes", "mesh_to_splat", "icp", "umeyama"]
