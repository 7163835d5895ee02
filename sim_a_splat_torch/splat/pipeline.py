"""High-level splat pipeline — the ``GaussianSplat`` wrapper twin.

Port of ``sim_a_splat_tpu/splat/pipeline.py``: loading a trained run,
rendering poses, exporting (densified/culled) point clouds, RGB-D
back-projection, and LERF-style semantic relevancy, on the port's stack:

- :meth:`GaussianSplatPipeline.load_run` reads the checkpoint and
  ``dataparser_transforms.json`` (world scale/transform) onto ``device``
  ("cuda" unless asked);
- :meth:`GaussianSplatPipeline.render` renders any pose through the tile
  rasterizer (kernel K1) where the scene lies: the ``{"rgb", "depth",
  "accumulation"}`` output dict of splatfacto;
- ``generate_point_cloud`` with optional densify/cull (``splat/refine.py``);
- ``generate_rgbd_point_cloud`` back-projects the rendered depth through
  the intrinsics, on the host;
- ``semantic_relevancy``, the positive/negative paired-softmax scoring
  over per-gaussian CLIP embeddings (numpy; the text embedding is the
  caller's).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from sim_a_splat_torch.ops.projection import Camera
from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig, rasterize_sh
from sim_a_splat_torch.ops.transforms import SE3, Sim3
from sim_a_splat_torch.splat import loaders
from sim_a_splat_torch.splat.refine import cull_gaussians, split_gaussians
from sim_a_splat_torch.splat.scene import GaussianScene


def load_dataparser_transform(run_dir: str | Path) -> Sim3:
    """``dataparser_transforms.json`` → Sim3 (the nerfstudio world scale);
    the identity where the file is missing."""
    p = Path(run_dir) / "dataparser_transforms.json"
    if not p.exists():
        return Sim3.identity()
    data = json.loads(p.read_text())
    m = np.eye(4)
    m[:3, :4] = np.asarray(data["transform"], np.float64)
    s = float(data.get("scale", 1.0))
    m[:3] *= s
    return Sim3.from_matrix(m)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy()


@dataclasses.dataclass(frozen=True, eq=False)
class GaussianSplatPipeline:
    """A scene and its dataparser transform; renders on the scene's
    device."""

    scene: GaussianScene
    dataparser: Sim3
    raster: RasterConfig = RasterConfig(tile_capacity=1024, chunk=128)
    dataset: Optional["SplatDataset"] = None   # noqa: F821

    @staticmethod
    def load_run(run_dir: str | Path,
                 raster: RasterConfig = RasterConfig(tile_capacity=1024,
                                                     chunk=128),
                 data_dir: str | Path | None = None,
                 dataset_mode: str = "val", device="cuda"):
        """Load a nerfstudio splatfacto run dir onto ``device``.
        ``data_dir`` (the processed dataset dir holding
        ``transforms.json``) also loads the dataset split."""
        from sim_a_splat_torch.splat.dataset import load_dataset

        scene = loaders.load_nerfstudio(run_dir, device=device)
        dp = load_dataparser_transform(run_dir)
        ds = (load_dataset(data_dir, dataset_mode, dataparser=dp,
                           device=device)
              if data_dir is not None else None)
        return GaussianSplatPipeline(
            scene=scene, dataparser=dp, raster=raster, dataset=ds)

    # --- dataset side ------------------------------------------------------

    def cameras(self, res_factor: float | None = None) -> list:
        """Render-ready cameras of the loaded split."""
        if self.dataset is None:
            raise ValueError("pipeline loaded without data_dir")
        return self.dataset.cameras(res_factor)

    def render_view(self, i: int, res_factor: float | None = None,
                    background=None) -> dict:
        """Render dataset view ``i`` from its own camera."""
        if self.dataset is None:
            raise ValueError("pipeline loaded without data_dir")
        cam = self.dataset.camera(i, res_factor)
        return self.render(cam.pose, camera=cam, background=background)

    def render(self, pose: SE3, fov_y: float = 1.0, width: int = 640,
               height: int = 480, camera: Camera | None = None,
               background=None) -> dict:
        """Render a camera pose → {"rgb" (H, W, 3), "depth" (H, W),
        "accumulation" (H, W)} tensors on the scene's device."""
        dev = self.scene.means.device
        cam = (camera if camera is not None else Camera.from_fov(
            pose.to(dev), fov_y, width, height)).to(dev)
        if background is not None:
            background = torch.as_tensor(background, dtype=torch.float32,
                                         device=dev)
        s = self.scene
        img, aux = rasterize_sh(s.means, s.covs(), s.sh_coeffs(),
                                s.opacities(), cam, s.sh_degree, self.raster,
                                background=background)
        return {"rgb": img, "depth": aux.depth, "accumulation": aux.alpha}

    # --- point clouds ------------------------------------------------------

    def generate_point_cloud(
        self,
        use_bounding_box: bool = False,
        bounding_box_min=(-1.0, -1.0, -1.0),
        bounding_box_max=(1.0, 1.0, 1.0),
        densify_scene: bool = False,
        split_params: dict | None = None,
        cull_scene: bool = False,
        cull_params: dict | None = None,
    ) -> dict:
        scene = self.scene
        if densify_scene:
            if cull_scene:
                cp = cull_params or {"cull_alpha_thresh": 0.1,
                                     "cull_scale_thresh": 0.5}
                scene = cull_gaussians(scene, **cp)
            sp = split_params or {"n_split_samples": 2}
            scene = split_gaussians(scene, None, **sp)
        pts = _np(scene.means)
        cols = np.clip(_np(scene.colors_dc()), 0.0, 1.0)
        if use_bounding_box:
            lo = np.asarray(bounding_box_min)
            hi = np.asarray(bounding_box_max)
            m = np.all((pts >= lo) & (pts <= hi), axis=1)
            pts, cols = pts[m], cols[m]
        return {"points": pts, "colors": cols}

    def generate_rgbd_point_cloud(
        self, pose: SE3, fov_y: float = 1.0, width: int = 320,
        height: int = 240, accumulation_thresh: float = 0.3,
    ) -> dict:
        """Back-project rendered depth through the pinhole intrinsics:
        world-frame colored point cloud of one view (numpy)."""
        pose = pose.to(self.scene.means.device)
        cam = Camera.from_fov(pose, fov_y, width, height)
        out = self.render(pose, camera=cam)
        depth = _np(out["depth"])
        rgb = _np(out["rgb"])
        acc = _np(out["accumulation"])
        u = np.arange(width) + 0.5
        v = np.arange(height) + 0.5
        uu, vv = np.meshgrid(u, v)
        z = depth
        x = (uu - float(cam.cx)) / float(cam.fx) * z
        y = (vv - float(cam.cy)) / float(cam.fy) * z
        pts_cam = np.stack([x, y, z], -1).reshape(-1, 3)
        keep = (acc.reshape(-1) > accumulation_thresh) & (pts_cam[:, 2] > 0)
        R = _np(pose.rotation_matrix())
        t = _np(pose.t)
        pts_world = pts_cam[keep] @ R.T + t
        return {"points": pts_world,
                "colors": np.clip(rgb.reshape(-1, 3)[keep], 0, 1),
                "depth": depth, "rgb": rgb, "accumulation": acc}

    # --- semantics ---------------------------------------------------------

    @staticmethod
    def semantic_relevancy(
        clip_embeds: np.ndarray,
        positive_embeds: np.ndarray,
        negative_embeds: np.ndarray,
        softmax_temp: float = 10.0,
    ) -> np.ndarray:
        """LERF-style relevancy: for each point, pairwise softmax of the
        positive similarity against every negative; score = min over
        negatives.  Shapes: (N, D), (P, D), (Q, D) → (N, P)."""
        def norm(a):
            a = np.asarray(a, np.float64)
            return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True),
                                  1e-12)
        x = norm(clip_embeds)
        pos = norm(positive_embeds)
        neg = norm(negative_embeds)
        sp = x @ pos.T                                      # (N, P)
        sn = x @ neg.T                                      # (N, Q)
        ep = np.exp(softmax_temp * sp)[:, :, None]          # (N, P, 1)
        en = np.exp(softmax_temp * sn)[:, None, :]          # (N, 1, Q)
        rel = ep / (ep + en)                                # (N, P, Q)
        return rel.min(axis=-1)
