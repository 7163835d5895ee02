"""The port's dataset reader, pipeline and exports against the JAX
reference, on the CPU; and the splat package's imports without PIL.

Inputs are written by the tests from seeds: a nerfstudio-format data
directory (``transforms.json`` and PNG frames written with PIL, as
``tests/test_dataset.py`` writes them) with a dataparser transform that
rotates, translates and scales, and the reference's ``synthetic_scene``.

Tolerances, and why:
- the dataset's split, file names, poses, intrinsics and images exactly
  (the same float64 numpy arithmetic and the same PNG bytes); the model
  pose's quaternion and translation atol 1e-6 (float32 rotation matrices
  of two libraries), its cameras' intrinsics exactly;
- ``render``: rgb, depth and accumulation atol 5e-5, as
  ``test_torch_uncached.py`` holds the full-grid render (float32
  projection and compositing of two libraries); the RGB-D point cloud from
  the same pixels at atol 1e-4 (depth × pixel rays of ~1 m);
- the point cloud exactly without densify (the same float32 values and
  numpy), by counts with it (the split's normal draws come from another
  generator); the relevancy exactly (a numpy copy); the dataparser
  transform atol 1e-6;
- ``save_ply``: the file byte for byte the reference's; ``ellipsoid_mesh``:
  faces and colours exactly, vertices atol 1e-6 (float32 rotation
  matrices).
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_dataset import make_run
from test_torch_helpers import np_of

from sim_a_splat_tpu.ops.transforms import SE3 as JSE3
from sim_a_splat_tpu.splat import dataset as jdataset
from sim_a_splat_tpu.splat import export as jexport
from sim_a_splat_tpu.splat import loaders as jloaders
from sim_a_splat_tpu.splat import pipeline as jpipeline

from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
from sim_a_splat_torch.ops.transforms import SE3
from sim_a_splat_torch.splat import dataset, export, loaders, pipeline
from sim_a_splat_torch.splat.scene import scene_from_numpy

REPO = Path(__file__).resolve().parent.parent
RASTER = dict(tile_size=16, tile_capacity=128, max_tiles_per_gaussian=9,
              sigma_cutoff=3.0)


def write_dataparser(run, angle=0.3, t=(0.5, -0.2, 0.1), scale=0.4):
    """A ``dataparser_transforms.json`` that rotates about z, translates and
    scales."""
    c, s = np.cos(angle), np.sin(angle)
    m = [[c, -s, 0.0, t[0]], [s, c, 0.0, t[1]], [0.0, 0.0, 1.0, t[2]]]
    (run / "dataparser_transforms.json").write_text(json.dumps(
        {"transform": m, "scale": scale}))


def scene_pair(n=80, seed=0, sh_degree=1, **kw):
    js = jloaders.synthetic_scene(n, seed=seed, sh_degree=sh_degree,
                                  **{"extent": 0.5,
                                     "scale_range": (0.05, 0.12), **kw})
    return js, scene_from_numpy({k: None if v is None else np.asarray(v)
                                 for k, v in js._asdict().items()}, "cpu")


def pipeline_pair(n=80, sh_degree=1, dataset_pair=(None, None)):
    js, ts = scene_pair(n, sh_degree=sh_degree)
    jp = jpipeline.GaussianSplatPipeline(
        scene=js, dataparser=jpipeline.Sim3.identity(),
        raster=jpipeline.RasterConfig(chunk=64, **RASTER),
        dataset=dataset_pair[1])
    tp = pipeline.GaussianSplatPipeline(
        scene=ts, dataparser=pipeline.Sim3.identity(),
        raster=RasterConfig(**RASTER), dataset=dataset_pair[0])
    return tp, jp


def pose_pair(q=(1.0, 0.0, 0.0, 0.0), t=(0.0, 0.0, -3.0)):
    q = (np.asarray(q) / np.linalg.norm(q)).astype(np.float32)
    t = np.asarray(t, np.float32)
    return (SE3(torch.as_tensor(q), torch.as_tensor(t)),
            JSE3(jnp.asarray(q), jnp.asarray(t)))


def assert_render_close(got, want):
    assert set(got) == {"rgb", "depth", "accumulation"}
    for k in got:
        assert got[k].shape == tuple(want[k].shape), k
        np.testing.assert_allclose(np_of(got[k]), np.asarray(want[k]),
                                   atol=5e-5, rtol=0, err_msg=k)


# --- the dataset ------------------------------------------------------------

@pytest.mark.parametrize("mode", ["all", "train", "val"])
def test_dataset_matches_reference(tmp_path, mode):
    data, run, _ = make_run(tmp_path)
    write_dataparser(run)
    dp_j = jpipeline.load_dataparser_transform(run)
    dp_t = pipeline.load_dataparser_transform(run)
    got = dataset.load_dataset(data, mode, dataparser=dp_t, device="cpu")
    want = jdataset.load_dataset(data, mode, dataparser=dp_j)
    assert len(got) == len(want) and got.image_filenames == \
        want.image_filenames
    for k in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width",
              "height"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    np.testing.assert_array_equal(got.get_poses(), want.get_poses())
    for i in range(len(got)):
        H, W, K = got.get_camera_intrinsics(i)
        assert (H, W) == want.get_camera_intrinsics(i)[:2]
        np.testing.assert_array_equal(K, want.get_camera_intrinsics(i)[2])
        np.testing.assert_array_equal(got.get_image_float32(i),
                                      want.get_image_float32(i))
        pg, pw = got.model_pose(i), want.model_pose(i)
        np.testing.assert_allclose(np_of(pg.q), np.asarray(pw.q), atol=1e-6)
        np.testing.assert_allclose(np_of(pg.t), np.asarray(pw.t), atol=1e-6)
        for f in (None, 0.5):
            cg, cw = got.camera(i, f), want.camera(i, f)
            assert (cg.width, cg.height) == (cw.width, cw.height)
            for a in ("fx", "fy", "cx", "cy"):
                assert float(getattr(cg, a)) == float(getattr(cw, a))
    assert len(got.cameras()) == len(got)
    np.testing.assert_array_equal(dataset.train_eval_split_fraction(293)[1],
                                  jdataset.train_eval_split_fraction(293)[1])


def test_dataparser_transform_matches_reference(tmp_path):
    write_dataparser(tmp_path)
    got = pipeline.load_dataparser_transform(tmp_path)
    want = jpipeline.load_dataparser_transform(tmp_path)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_of(a), np.asarray(b), atol=1e-6)
    ident = pipeline.load_dataparser_transform(tmp_path / "missing")
    np.testing.assert_array_equal(np_of(ident.q), [1.0, 0.0, 0.0, 0.0])
    assert float(ident.s) == 1.0


# --- the pipeline ---------------------------------------------------------

def test_render_matches_reference():
    tp, jp = pipeline_pair()
    pose_t, pose_j = pose_pair((0.98, 0.1, -0.15, 0.05), (0.1, -0.2, -2.6))
    got = tp.render(pose_t, fov_y=0.8, width=48, height=32)
    want = jp.render(pose_j, fov_y=0.8, width=48, height=32)
    assert_render_close(got, want)
    assert float(got["accumulation"].max()) > 0.5
    bg = (0.2, 0.4, 0.6)
    assert_render_close(tp.render(pose_t, 0.8, 48, 32, background=bg),
                        jp.render(pose_j, 0.8, 48, 32,
                                  background=jnp.asarray(bg)))


def test_render_view_of_the_dataset_matches_reference(tmp_path):
    data, run, _ = make_run(tmp_path)
    write_dataparser(run, scale=1.0)
    dp = (pipeline.load_dataparser_transform(run),
          jpipeline.load_dataparser_transform(run))
    ds = (dataset.load_dataset(data, "val", dataparser=dp[0], device="cpu"),
          jdataset.load_dataset(data, "val", dataparser=dp[1]))
    tp, jp = pipeline_pair(dataset_pair=ds)
    assert len(tp.cameras()) == len(jp.cameras()) == 1
    got, want = tp.render_view(0), jp.render_view(0)
    assert_render_close(got, want)
    assert got["rgb"].shape == (24, 32, 3)
    with pytest.raises(ValueError, match="data_dir"):
        pipeline_pair()[0].cameras()


def test_rgbd_point_cloud_matches_reference():
    tp, jp = pipeline_pair()
    pose_t, pose_j = pose_pair(t=(0.0, 0.0, -2.4))
    got = tp.generate_rgbd_point_cloud(pose_t, fov_y=0.7, width=40,
                                       height=32)
    want = jp.generate_rgbd_point_cloud(pose_j, fov_y=0.7, width=40,
                                        height=32)
    for k in ("depth", "rgb", "accumulation"):
        np.testing.assert_allclose(got[k], want[k], atol=5e-5, err_msg=k)
    assert got["points"].shape == want["points"].shape
    assert len(got["points"]) > 100
    np.testing.assert_allclose(got["points"], want["points"], atol=1e-4)
    np.testing.assert_allclose(got["colors"], want["colors"], atol=5e-5)


def test_point_cloud_matches_reference():
    tp, jp = pipeline_pair()
    for kw in ({}, dict(use_bounding_box=True,
                        bounding_box_min=(-0.2, -0.3, -0.2),
                        bounding_box_max=(0.3, 0.2, 0.2))):
        got, want = tp.generate_point_cloud(**kw), \
            jp.generate_point_cloud(**kw)
        np.testing.assert_array_equal(got["points"], want["points"])
        np.testing.assert_array_equal(got["colors"], want["colors"])
    assert 0 < len(got["points"]) < 80
    # densify (split every gaussian) and cull: counts
    scene = tp.scene._replace(logit_opacities=tp.scene.logit_opacities
                              .clone().index_fill_(0, torch.arange(30),
                                                   -5.0))
    jscene = jp.scene._replace(logit_opacities=jp.scene.logit_opacities
                               .at[:30].set(-5.0))
    for cull in (False, True):
        kw = dict(densify_scene=True, cull_scene=cull,
                  split_params={"n_split_samples": 3})
        got = pipeline.GaussianSplatPipeline(
            scene, tp.dataparser).generate_point_cloud(**kw)
        want = jpipeline.GaussianSplatPipeline(
            jscene, jp.dataparser).generate_point_cloud(**kw)
        assert len(got["points"]) == len(want["points"]) == \
            3 * (50 if cull else 80)


def test_semantic_relevancy_matches_reference():
    rng = np.random.default_rng(0)
    x, pos, neg = (rng.normal(size=s) for s in ((20, 8), (2, 8), (3, 8)))
    got = pipeline.GaussianSplatPipeline.semantic_relevancy(x, pos, neg)
    want = jpipeline.GaussianSplatPipeline.semantic_relevancy(x, pos, neg)
    assert got.shape == (20, 2)
    np.testing.assert_array_equal(got, want)


# --- the exports ------------------------------------------------------------

@pytest.mark.parametrize("sh_degree", [0, 2])
def test_save_ply_is_the_references_file(tmp_path, sh_degree):
    js, ts = scene_pair(25, seed=3, sh_degree=sh_degree)
    export.save_ply(tmp_path / "port.ply", ts)
    jexport.save_ply(tmp_path / "ref.ply", js)
    assert (tmp_path / "port.ply").read_bytes() == \
        (tmp_path / "ref.ply").read_bytes()
    back = loaders.load_ply(tmp_path / "port.ply", device="cpu")
    for a, b in zip(ts, back):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(np_of(a), np_of(b))


def test_ellipsoid_mesh_matches_reference(tmp_path):
    js, ts = scene_pair(30, seed=4)
    for kw in (dict(subdivisions=0), dict(subdivisions=1, max_gaussians=12,
                                          n_sigma=2.0, seed=3)):
        (mesh, colors), (jmesh, jcolors) = (export.ellipsoid_mesh(ts, **kw),
                                            jexport.ellipsoid_mesh(js, **kw))
        np.testing.assert_array_equal(mesh.faces, jmesh.faces)
        np.testing.assert_array_equal(colors, jcolors)
        np.testing.assert_allclose(mesh.vertices, jmesh.vertices, atol=1e-6)
    export.save_ellipsoid_ply(tmp_path / "e.ply", ts, subdivisions=0)
    jexport.save_ellipsoid_ply(tmp_path / "j.ply", js, subdivisions=0)
    got = (tmp_path / "e.ply").read_text().splitlines()
    want = (tmp_path / "j.ply").read_text().splitlines()
    assert len(got) == len(want) and got[:12] == want[:12]
    assert got[12 + 360:] == want[12 + 360:]        # the faces
    np.testing.assert_allclose(
        np.loadtxt(got[12:12 + 360]), np.loadtxt(want[12:12 + 360]),
        atol=2e-6)


def test_splat_package_imports_without_pil():
    """``sim_a_splat_torch.splat`` (its dataset, pipeline, exports and the
    trainer) imports with PIL unavailable; reading an image then fails
    (checked in a fresh interpreter)."""
    code = textwrap.dedent("""
        import sys
        sys.modules["PIL"] = None
        import sim_a_splat_torch.splat
        import sim_a_splat_torch.splat.train, sim_a_splat_torch.entry
        from sim_a_splat_torch.splat import load_dataset
        try:
            load_dataset.__globals__["SplatDataset"](
                ".", ("x.png",), None, *[None] * 6,
                device="cpu").get_image_float32(0)
        except ImportError:
            print("images need PIL")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "images need PIL"
