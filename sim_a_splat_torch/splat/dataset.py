"""Dataset-side pipeline utilities — the nerfstudio ``load_dataset`` twin.

Port of ``sim_a_splat_tpu/splat/dataset.py``: reads a nerfstudio-format
``transforms.json`` directly:

- global or per-frame intrinsics (fl_x/fl_y/cx/cy/w/h), OPENCV model;
- ``transform_matrix`` camera-to-world poses in the OpenGL convention
  nerfstudio stores (x right, y up, z backward);
- nerfstudio's exact fraction split (``train_split_fraction`` 0.9,
  ``np.linspace(0, n-1, num_train, dtype=int)``);
- the run's ``dataparser_transforms.json`` Sim3 mapping original world →
  model world, so cameras land in the frame the gaussians live in.

Frames are sorted by ``file_path`` (nerfstudio sorts filenames before
splitting), and cameras convert OpenGL → the renderer's OpenCV convention
(+z forward) by negating the y/z columns.  Poses are computed on the host
in float64, as the reference computes them; the cameras are made on the
dataset's ``device`` ("cuda" unless asked).  Images are read with PIL,
imported where an image is read.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import torch

from sim_a_splat_torch import resolve_device
from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.ops.projection import Camera
from sim_a_splat_torch.ops.transforms import SE3, Sim3

# OpenGL (x right, y up, z backward) → OpenCV (x right, y down, z forward)
_GL_TO_CV = np.diag([1.0, -1.0, -1.0])


def train_eval_split_fraction(num_images: int,
                              train_split_fraction: float = 0.9):
    """nerfstudio's ``get_train_eval_split_fraction``: evenly-spaced train
    indices via ``np.linspace(..., dtype=int)``, eval = the complement."""
    num_train = math.ceil(num_images * train_split_fraction)
    i_all = np.arange(num_images)
    i_train = np.linspace(0, num_images - 1, num_train, dtype=int)
    i_eval = np.setdiff1d(i_all, i_train)
    return i_train, i_eval


@dataclasses.dataclass(frozen=True)
class SplatDataset:
    """One split of a nerfstudio-format dataset.

    ``camera_to_worlds`` are (N, 4, 4) OpenGL-convention poses in the
    ORIGINAL (pre-dataparser) world frame, exactly as stored in
    ``transforms.json``; ``cameras()`` applies the dataparser Sim3 and the
    GL→CV conversion to produce render-ready :class:`Camera` objects on
    ``device``.
    """

    data_dir: Path
    image_filenames: tuple            # (N,) relative paths
    camera_to_worlds: np.ndarray      # (N, 4, 4) float64, OpenGL
    fx: np.ndarray                    # (N,)
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    width: np.ndarray                 # (N,) int
    height: np.ndarray
    dataparser: Sim3 = dataclasses.field(default_factory=Sim3.identity)
    device: str = "cuda"

    def __len__(self) -> int:
        return len(self.image_filenames)

    def get_poses(self) -> np.ndarray:
        """(N, 4, 4) camera-to-world, OpenGL convention."""
        return self.camera_to_worlds

    def get_camera_intrinsics(self, i: int = 0):
        """(H, W, K) of frame ``i``."""
        K = np.array([[self.fx[i], 0.0, self.cx[i]],
                      [0.0, self.fy[i], self.cy[i]],
                      [0.0, 0.0, 1.0]])
        return int(self.height[i]), int(self.width[i]), K

    def get_image_float32(self, i: int) -> np.ndarray:
        """(H, W, 3) float32 in [0, 1]."""
        from PIL import Image

        p = Path(self.data_dir) / self.image_filenames[i]
        img = np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
        return img

    def get_images(self) -> list:
        return [self.get_image_float32(i) for i in range(len(self))]

    def model_pose(self, i: int) -> SE3:
        """Camera-to-world of frame ``i`` in the MODEL world frame
        (dataparser Sim3 applied; nerfstudio scales translations only),
        OpenCV convention, on the dataset's device — directly renderable."""
        dev = resolve_device(self.device)
        c2w = self.camera_to_worlds[i]
        dp = self.dataparser
        R_d = np.asarray(SE3(dp.q, dp.t).rotation_matrix().detach().cpu(),
                         np.float64)
        t_d = np.asarray(dp.t.detach().cpu(), np.float64)
        s = float(dp.s)
        R = R_d @ c2w[:3, :3] @ _GL_TO_CV
        t = s * (R_d @ c2w[:3, 3] + t_d)
        q = quat.from_rotation_matrix(torch.as_tensor(R, dtype=torch.float32))
        return SE3(q.to(dev), torch.as_tensor(t, dtype=torch.float32,
                                              device=dev))

    def camera(self, i: int, res_factor: float | None = None) -> Camera:
        """Render-ready camera for frame ``i`` (``rescale_output_resolution``
        via ``res_factor``)."""
        dev = resolve_device(self.device)
        f = 1.0 if res_factor is None else float(res_factor)

        def a(x):
            return torch.tensor(x, dtype=torch.float32, device=dev)

        return Camera(
            pose=self.model_pose(i),
            fx=a(self.fx[i] * f), fy=a(self.fy[i] * f),
            cx=a(self.cx[i] * f), cy=a(self.cy[i] * f),
            width=int(round(self.width[i] * f)),
            height=int(round(self.height[i] * f)),
        )

    def cameras(self, res_factor: float | None = None) -> list:
        return [self.camera(i, res_factor) for i in range(len(self))]


def load_dataset(
    data_path: str | Path,
    dataset_mode: str = "train",
    train_split_fraction: float = 0.9,
    dataparser: Sim3 | None = None,
    device="cuda",
) -> SplatDataset:
    """Read ``<data_path>/transforms.json`` → one split's SplatDataset.

    ``dataset_mode``: "train" | "val" | "test" | "all" — val/test are the
    eval complement and "all" disables the split.  Its cameras are made on
    ``device``.
    """
    resolve_device(device)
    data_path = Path(data_path)
    tj = data_path / "transforms.json"
    meta = json.loads(tj.read_text())

    frames = sorted(meta["frames"], key=lambda f: f["file_path"])

    def per_frame(key, default=None):
        g = meta.get(key, default)
        return np.asarray([f.get(key, g) for f in frames], np.float64)

    c2w = np.asarray([f["transform_matrix"] for f in frames], np.float64)
    names = tuple(f["file_path"] for f in frames)
    fx = per_frame("fl_x")
    fy = per_frame("fl_y")
    cx = per_frame("cx")
    cy = per_frame("cy")
    w = per_frame("w").astype(int)
    h = per_frame("h").astype(int)

    n = len(frames)
    if dataset_mode == "all":
        idx = np.arange(n)
    else:
        i_train, i_eval = train_eval_split_fraction(n, train_split_fraction)
        idx = i_train if dataset_mode == "train" else i_eval

    return SplatDataset(
        data_dir=data_path,
        image_filenames=tuple(names[i] for i in idx),
        camera_to_worlds=c2w[idx],
        fx=fx[idx], fy=fy[idx], cx=cx[idx], cy=cy[idx],
        width=w[idx], height=h[idx],
        dataparser=dataparser if dataparser is not None else Sim3.identity(),
        device=str(device),
    )
