"""Browser-viewer demo: orbit the arm splat scene and drive joints live.

The port of ``examples/demo_viewer.py``: the browser is a thin display —
frames are rendered in this process (kernel K1 on the card) through the
viewer's orbit camera and streamed as JPEGs; one slider a joint posts
joint values back.

    python -m sim_a_splat_torch.examples.demo_viewer              # serve until ctrl-c
    python -m sim_a_splat_torch.examples.demo_viewer --selftest   # one frame, then exit
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from sim_a_splat_torch import resolve_device
from sim_a_splat_torch.examples.common import (
    add_device_option, log, make_manipulator_splat_env,
)
from sim_a_splat_torch.ops.projection import Camera
from sim_a_splat_torch.ops.transforms import SE3
from sim_a_splat_torch.viewer import SliderSpec, SplatViewer

FOV = 1.05
ORBIT = dict(dist=1.8, elev=0.6, target=(0.35, 0.0, 0.2))


def create_splat_env(size: int, device="cuda"):
    splat_env = make_manipulator_splat_env(eef=False, render_size=(size, size),
                                           device=device)
    splat_env.reset(reset_to_state={
        "robot_pos": [0.0] * splat_env.unwrapped.num_dof,
        "block_pos": [0.35, 0.1, 0.0, 0.0],
        "goal_pos": [0.45, -0.1, 0.0, 0.0],
    })
    return splat_env


def render_fn(splat_env, size: int):
    """The viewer's callback: the sliders' joints stepped (no camera
    observation), then the scene from the orbit pose (q, t) at size²."""
    def render(q, t, sliders):
        ndof = splat_env.unwrapped.num_dof
        joints = np.asarray([sliders.get(f"joint{i}", 0.0)
                             for i in range(ndof)], np.float32)
        splat_env.step(joints, noobs=True)
        dev = splat_env.unwrapped.device
        cam = Camera.from_fov(SE3(torch.as_tensor(q, device=dev),
                                  torch.as_tensor(t, device=dev)),
                              FOV, size, size)
        return splat_env.render_free_camera(cam)
    return render


def make_viewer(splat_env, size: int, port: int = 0) -> SplatViewer:
    return SplatViewer(
        render_fn(splat_env, size),
        sliders=[SliderSpec(f"joint{i}", -3.14, 3.14, 0.0)
                 for i in range(splat_env.unwrapped.num_dof)],
        port=port, **ORBIT)


def selftest(viewer: SplatViewer) -> bytes:
    """One frame as a JPEG, checked to be one."""
    jpg = viewer.render_jpeg()
    if jpg[:2] != b"\xff\xd8" or len(jpg) <= 1000:
        raise RuntimeError(f"the viewer's frame is not a JPEG ({len(jpg)} B)")
    log(f"selftest ok: {len(jpg)} byte frame")
    return jpg


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--port", default=8787, type=int)
    p.add_argument("--size", default=320, type=int, help="render height")
    p.add_argument("--selftest", action="store_true",
                   help="render one frame and exit")
    add_device_option(p)
    args = p.parse_args(argv)
    splat_env = create_splat_env(args.size, resolve_device(args.device))
    viewer = make_viewer(splat_env, args.size,
                         0 if args.selftest else args.port)
    log(f"viewer serving at {viewer.url}")
    try:
        if args.selftest:
            selftest(viewer)
            return
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        viewer.close()
        splat_env.close()


if __name__ == "__main__":
    main()
