"""Shared plumbing of the example drivers (the port of ``examples/common.py``).

The demos read the repository's demo asset tree, ``examples/assets`` (the
offline matcher's artifacts and a 6,800-gaussian splat of ``pusharm6``,
the files the JAX package's demos read), and never write there.  Where that
tree is missing, :func:`ensure_demo_assets` writes one with
``tools/demo_assets.build_demo_assets`` into
``sim_a_splat_torch/_build/demo_assets/``, once.

:func:`make_manipulator_splat_env` builds the reference demos' stack — the
arm env, optionally its task-space (IK) wrapper, and the splat cameras: a
viewport onto the arm and a camera on the end effector — from the gym-free
one-env shells of ``envs/single_env.py``, which the port's Gym classes are
too: the reference Gym stack's ``reset`` / ``step(action, noobs)`` and its
``camera_{i}`` observations, every camera rendered by kernel K1 on the
card.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from sim_a_splat_torch.envs.single_env import (
    ManipulatorEEFSingleEnv, ManipulatorSingleEnv, SplatSingleEnv,
)
from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.ops.transforms import SE3
from sim_a_splat_torch.scenegraph.registration import (
    load_icp_sim3, world_to_splat_pose,
)

REPO = Path(__file__).resolve().parents[2]
PACKAGE_PATH = REPO / "robot_description"
ASSETS = REPO / "examples" / "assets"
BUILT_ASSETS = Path(__file__).resolve().parents[1] / "_build" / "demo_assets"
URDF = PACKAGE_PATH / "pusharm6" / "urdf" / "pusharm6.urdf"
EEF_LINK = "push_tool"
NUM_DOF = 6
JOINT_CONFIG = np.asarray([0.0, -0.45, 0.85, 0.0, 0.35, 0.0], np.float32)
# push-ready home: tool pointing down, EEF near the workspace center
HOME_Q = np.asarray([0.0, 0.785, 0.89, 0.0, 1.466, 0.0], np.float32)
MATCH_OBJECT = "pusharm6"
_MARKER = Path("masks") / MATCH_OBJECT / "link_masks_global_dict.npy"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _paths(assets: Path) -> dict:
    return {
        "assets": assets,
        "splat_config_name": "demo-run/splat.npz",
        "match_object_name": MATCH_OBJECT,
        "task_assets_path": assets / "tblock_paper",
        "task_assets_name": "tblock_paper.obj",
        "joint_config": JOINT_CONFIG,
    }


def ensure_demo_assets() -> dict:
    """The paths of the demo asset tree: ``examples/assets``, else the
    port's own under ``_build/demo_assets``, written on first use."""
    for root in (ASSETS, BUILT_ASSETS):
        if (root / _MARKER).exists():
            return _paths(root)
    from sim_a_splat_torch.tools.demo_assets import build_demo_assets
    log(f"building the demo assets into {BUILT_ASSETS} (first run only)...")
    return build_demo_assets(BUILT_ASSETS, URDF, joint_config=JOINT_CONFIG)


def look_at(eye, target, up=(0.0, 0.0, 1.0)):
    """OpenCV camera-to-world pose (+z forward, +y down) → (q wxyz, t)."""
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target, np.float64) - eye
    z /= max(np.linalg.norm(z), 1e-12)
    x = np.cross(z, np.asarray(up, np.float64))
    x /= max(np.linalg.norm(x), 1e-12)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=1)
    q = quat.from_rotation_matrix(torch.as_tensor(R, dtype=torch.float32))
    return tuple(q.numpy()), tuple(eye)


def camera_setup(render_size=(240, 320), assets: Path | None = None) -> dict:
    """Viewport + EEF-mounted moving camera, splat-frame poses (the two
    cameras of the reference's demo_pusht_splat.py:54-78)."""
    assets = ensure_demo_assets()["assets"] if assets is None else assets
    icp = load_icp_sim3(assets / "masks" / MATCH_OBJECT
                        / "icp_transformation.npy")
    q, t = look_at([1.1, -0.9, 0.9], [0.35, 0.0, 0.25])
    view = world_to_splat_pose(
        SE3(torch.tensor(q, dtype=torch.float32),
            torch.tensor(t, dtype=torch.float32)), icp)
    return {
        0: {
            "link_name": "world",
            "local_frame": (tuple(view.q.numpy()), tuple(view.t.numpy())),
            "type": "viewport",
            "render_size": list(render_size),
        },
        1: {
            "link_name": EEF_LINK,
            "local_frame": ((1.0, 0.0, 0.0, 0.0), (-0.1, 0.0, 0.033)),
            "type": "moving",
            "render_size": list(render_size),
        },
    }


def make_manipulator_splat_env(eef: bool = True, render_size=(240, 320),
                               weld_frame_transform=None,
                               robot_mesh_overlay: bool = False,
                               device="cuda") -> SplatSingleEnv:
    """The full demo stack (reference demo_pusht_splat.py:44-87) on
    ``device``: ``robot_mesh_overlay`` also draws the URDF link visuals
    beside the splats."""
    paths = ensure_demo_assets()
    env = ManipulatorSingleEnv(
        env_objects=True,
        visualise_flag=False,
        eef_link_name=EEF_LINK,
        package_path=str(PACKAGE_PATH),
        package_name="pusharm6",
        urdf_name="pusharm6.urdf",
        num_dof=NUM_DOF,
        weld_frame_transform=weld_frame_transform,
        device=device,
    )
    if eef:
        env = ManipulatorEEFSingleEnv(env)
    splat_env = SplatSingleEnv(
        env,
        splat_assets_path=paths["assets"],
        match_object_name=paths["match_object_name"],
        splat_config_name=paths["splat_config_name"],
        task_assets_path=paths["task_assets_path"],
        task_assets_name=paths["task_assets_name"],
        robot_mesh_overlay=robot_mesh_overlay,
    )
    splat_env._configure_cameras(camera_setup(render_size, paths["assets"]))
    return splat_env


def save_ppm(path: str | Path, img: np.ndarray) -> None:
    """Write an (H, W, 3) float image as binary PPM (no image-lib dep)."""
    arr = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())


def add_device_option(parser) -> None:
    """``--device``: where the demo runs (``cuda`` unless asked; without a
    card a demo raises rather than fall back to the CPU)."""
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu only when "
                             "asked)")
