"""Gaussian splat scene container, loaders, refinement, pipeline, exports
(the names of the reference's ``sim_a_splat_tpu.splat``).  Importing it
does not import PIL: the dataset reads images with it where it reads
one."""

from sim_a_splat_torch.splat.scene import GaussianScene
from sim_a_splat_torch.splat import loaders
from sim_a_splat_torch.splat.loaders import (
    load, load_json, load_ply, load_npz, save_npz, load_nerfstudio,
    synthetic_scene, aabb_mask,
)
from sim_a_splat_torch.splat.refine import (
    cull_gaussians, duplicate_gaussians, split_gaussians,
)
from sim_a_splat_torch.splat.pipeline import (
    GaussianSplatPipeline, load_dataparser_transform,
)
from sim_a_splat_torch.splat.dataset import (
    SplatDataset, load_dataset, train_eval_split_fraction,
)
from sim_a_splat_torch.splat.export import (
    ellipsoid_mesh, save_ellipsoid_ply, save_ply,
)

__all__ = [
    "GaussianScene", "loaders", "load", "load_json", "load_ply", "load_npz",
    "save_npz", "load_nerfstudio", "synthetic_scene", "aabb_mask",
    "cull_gaussians", "duplicate_gaussians", "split_gaussians",
    "GaussianSplatPipeline", "load_dataparser_transform",
    "SplatDataset", "load_dataset", "train_eval_split_fraction",
    "ellipsoid_mesh", "save_ellipsoid_ply", "save_ply",
]
