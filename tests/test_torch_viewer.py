"""The port's viewer (``sim_a_splat_torch/viewer``) against the reference's:
the orbit camera's pose, the HTTP endpoints and their render cache, and one
frame of a splat scene rendered through the port's ``rasterize_sh`` (its
callback ``scene_render_fn``) against the reference's ``rasterize_sh``."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sim_a_splat_tpu.ops.projection import Camera as JCamera
from sim_a_splat_tpu.ops.rasterize_tiles import (
    RasterConfig as JRasterConfig, rasterize_sh as jrasterize_sh,
)
from sim_a_splat_tpu.ops.transforms import SE3 as JSE3
from sim_a_splat_tpu.splat import synthetic_scene as jsynthetic_scene
from sim_a_splat_tpu.viewer.server import orbit_pose as jorbit_pose

from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
from sim_a_splat_torch.splat.scene import GaussianScene
from sim_a_splat_torch.viewer import (
    SliderSpec, SplatViewer, orbit_pose, scene_render_fn,
)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status


@pytest.mark.parametrize("azim,elev,dist,target", [
    (0.3, 0.4, 2.5, (1.0, -2.0, 0.5)),
    (-1.57, 0.5, 4.0, (0.0, 0.0, 0.0)),
    (2.9, -1.2, 0.7, (0.2, 0.1, -0.3)),
    (0.0, 0.0, 1.0, (0.0, 0.0, 0.0)),        # w ≈ 0.5: the trace branch
    (np.pi, 0.0, 1.0, (0.0, 0.0, 0.0)),      # w ≈ 0: the fallback branch
])
def test_orbit_pose_matches_reference(azim, elev, dist, target):
    q, t = orbit_pose(azim, elev, dist, target)
    jq, jt = jorbit_pose(azim, elev, dist, target)
    assert q.dtype == np.float32 and t.dtype == np.float32
    np.testing.assert_allclose(q, jq, atol=1e-6)
    np.testing.assert_allclose(t, jt, atol=1e-6)


def test_viewer_endpoints_and_rerender():
    calls = []

    def render(q, t, sliders):
        calls.append((q.copy(), t.copy(), dict(sliders)))
        img = torch.zeros((32, 48, 3))         # a tensor, as the port's own
        img[..., 0] = sliders.get("joint1", 0.0)
        return img

    v = SplatViewer(render, sliders=[SliderSpec("joint1", -1.0, 1.0, 0.0)])
    try:
        code, ctype, body = _get(v.url)
        assert code == 200 and "text/html" in ctype
        assert b"sim-a-splat" in body and b"joint1" in body

        code, ctype, body = _get(v.url + "frame.jpg")
        assert code == 200 and ctype == "image/jpeg"
        assert body[:2] == b"\xff\xd8"            # JPEG magic
        assert len(calls) == 1

        _get(v.url + "frame.jpg")                # cached: no re-render
        assert len(calls) == 1

        assert _post(v.url + "camera", {"azim": 1.0}) == 200
        _get(v.url + "frame.jpg")
        assert len(calls) == 2
        q, t = orbit_pose(1.0, 0.5, 4.0, (0.0, 0.0, 0.0))
        np.testing.assert_array_equal(calls[-1][0], q)
        np.testing.assert_array_equal(calls[-1][1], t)

        assert _post(v.url + "sliders", {"joint1": 0.5}) == 200
        _get(v.url + "frame.jpg")
        assert calls[-1][2]["joint1"] == 0.5

        code, _, body = _get(v.url + "state")
        state = json.loads(body)
        assert state["camera"]["azim"] == 1.0
        assert state["sliders"]["joint1"] == 0.5
        with pytest.raises(urllib.error.HTTPError, match="404"):
            _get(v.url + "nothing")
        v.invalidate()
        _get(v.url + "frame.jpg")
        assert len(calls) == 4
    finally:
        v.close()


def test_ppm_frame_without_pil(monkeypatch):
    """Where PIL does not import, the frame is a raw PPM of the image."""
    import builtins
    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *args, **kw)

    img = np.zeros((4, 6, 3), np.float32)
    img[1, 2] = (1.0, 0.5, 0.0)
    v = SplatViewer(lambda q, t, s: img)
    try:
        monkeypatch.setattr(builtins, "__import__", no_pil)
        data = v.render_jpeg()
    finally:
        monkeypatch.setattr(builtins, "__import__", real_import)
        v.close()
    header = b"P6 6 4 255\n"
    assert data[:len(header)] == header
    px = np.frombuffer(data[len(header):], np.uint8).reshape(4, 6, 3)
    np.testing.assert_array_equal(px, (np.clip(img, 0, 1) * 255).astype(
        np.uint8))


def test_scene_frame_matches_reference():
    """One frame of an SH-1 scene at an orbit pose through the port's
    callback (``rasterize_sh`` → K1's plain version on the CPU) against the
    reference's ``rasterize_sh`` on a white background."""
    js = jsynthetic_scene(300, seed=2, extent=0.8, scale_range=(0.03, 0.08),
                          sh_degree=1)
    scene = GaussianScene(*(torch.tensor(np.asarray(f)) for f in (
        js.means, js.quats, js.log_scales, js.logit_opacities, js.sh_dc,
        js.sh_rest)))
    cfg = dict(tile_capacity=512, sigma_cutoff=3.0)
    render = scene_render_fn(scene, width=48, height=32, fov=0.9,
                             raster=RasterConfig(**cfg), device="cpu")
    q, t = orbit_pose(0.4, 0.3, 3.0, (0.0, 0.0, 0.0))
    img = render(q, t, {}).numpy()
    cam = JCamera.from_fov(JSE3(jnp.asarray(q), jnp.asarray(t)), 0.9, 48, 32)
    ref, _ = jrasterize_sh(js.means, js.covs(), js.sh_coeffs(),
                           js.opacities(), cam, 1, JRasterConfig(**cfg),
                           background=jnp.ones(3))
    assert img.shape == (32, 48, 3) and img.std() > 0.01
    np.testing.assert_allclose(img, np.asarray(ref), atol=1e-4, rtol=0)
