"""The port's scene IO, mesh tools, demo assets, mesh overlay and the splat
env built from asset files against the JAX reference, on the CPU; and the
card path's imports without ``gymnasium``.

Inputs are written by the tests from seeds: scene files from the
reference's ``synthetic_scene`` (a splatfacto checkpoint with
``torch.save``, since the reference's are git-LFS stubs), the demo asset
tree of ``tests/test_splat_gym.py`` (``pusharm6``, 80 gaussians a link,
500 on the ground, a 300-gaussian task mesh, two 48 × 64 cameras) by the
reference's ``build_demo_assets``.

Tolerances, and why:
- loaders: exact (the same float32 values read from the same file); RGB
  colours turned into SH atol 1e-6;
- ``meshio``: exact (a copy of the reference's module, numpy only);
- ``mesh_to_splat``: means, scales, opacities and colours exact (numpy and
  the same float32 operations), quaternions atol 1e-6 (float32 sin/cos of
  two libraries);
- the two packages' demo asset trees: masks, joint configuration and every
  scene field but the means exact, means and the similarity atol 1e-5
  (float32 forward kinematics and ``from_rpy`` of two libraries);
- ``visual_mesh`` atol 1e-7 (float64 vertices ≤ 1 m through the float32
  rotation matrix of either package, whose entries differ in the last
  bit), the overlay graph and its frame poses atol 1e-5;
- the splat env: images atol 1e-4 (the uncached render's float32
  projection and compositing in two libraries; measured ≤ 4e-6), the arm's
  observation as ``test_torch_gym.py`` holds it.
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

from test_torch_helpers import np_of

from sim_a_splat_tpu.envs import manipulator_gym as jmgym
from sim_a_splat_tpu.envs import splat_gym as jsplat_gym
from sim_a_splat_tpu.ops.projection import Camera as JCamera
from sim_a_splat_tpu.ops.rasterize_tiles import RasterConfig as JRaster
from sim_a_splat_tpu.ops.transforms import SE3 as JSE3
from sim_a_splat_tpu.physics import kinematics as jkin
from sim_a_splat_tpu.scenegraph import load_icp_sim3, world_to_splat_pose
from sim_a_splat_tpu.scenegraph import mesh_overlay as jmo
from sim_a_splat_tpu.splat import loaders as jloaders
from sim_a_splat_tpu.tools import demo_assets as jdemo
from sim_a_splat_tpu.tools.mesh_to_splat import (
    concat_scenes as jconcat, mesh_to_splat as jmesh_to_splat,
)
from sim_a_splat_tpu.tools import meshio as jmeshio

from sim_a_splat_torch.envs import manipulator_gym, splat_assets, splat_gym
from sim_a_splat_torch.ops.projection import Camera
from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
from sim_a_splat_torch.ops.transforms import SE3
from sim_a_splat_torch.physics import kinematics as kin
from sim_a_splat_torch.scenegraph import mesh_overlay as mo
from sim_a_splat_torch.splat import loaders
from sim_a_splat_torch.tools import demo_assets, meshio
from sim_a_splat_torch.tools.mesh_to_splat import concat_scenes, mesh_to_splat

REPO = Path(__file__).resolve().parent.parent
DESC = REPO / "robot_description"
URDF = DESC / "pusharm6" / "urdf" / "pusharm6.urdf"
SCARA = DESC / "pushscara3" / "urdf" / "pushscara3.urdf"
JOINT_CONFIG = np.asarray([0.0, -0.45, 0.85, 0.0, 0.35, 0.0], np.float32)
FIELDS = ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
          "sh_rest")


def _same_scene(got, want, atol=0.0, what=""):
    for k in FIELDS:
        g, w = getattr(got, k), getattr(want, k)
        if w is None:
            assert g is None, f"{what}{k}"
            continue
        np.testing.assert_allclose(np_of(g), np.asarray(w), atol=atol,
                                   rtol=0, err_msg=f"{what}{k}")


def _write_scene_file(fmt, scene, path):
    """``scene`` (the reference's) written as ``fmt``; returns the path
    that the loaders take."""
    a = {k: np.asarray(getattr(scene, k)) for k in FIELDS
         if getattr(scene, k) is not None}
    n = len(a["means"])
    if fmt == "json":
        p = path / "scene.json"
        p.write_text(json.dumps({
            "means": a["means"].tolist(), "rotations": a["quats"].tolist(),
            "scalings": a["log_scales"].tolist(),
            "opacities": a["logit_opacities"].tolist(),
            "colors": a["sh_dc"].tolist()}))
    elif fmt == "json_rgb":
        p = path / "scene_rgb.json"
        p.write_text(json.dumps({
            "means": a["means"].tolist(), "rotations": a["quats"].tolist(),
            "scalings": a["log_scales"].tolist(),
            "opacities": a["logit_opacities"].tolist(),
            "colors": (a["sh_dc"] * 0.28209479 + 0.5).tolist(),
            "colors_are_sh": False}))
    elif fmt == "ply":
        k = a["sh_rest"].shape[1]
        props = (["x", "y", "z", "nx", "ny", "nz"]
                 + [f"f_dc_{i}" for i in range(3)]
                 + [f"f_rest_{i}" for i in range(3 * k)] + ["opacity"]
                 + [f"scale_{i}" for i in range(3)]
                 + [f"rot_{i}" for i in range(4)])
        table = np.concatenate([
            a["means"], np.zeros((n, 3), np.float32), a["sh_dc"],
            a["sh_rest"].transpose(0, 2, 1).reshape(n, -1),
            a["logit_opacities"][:, None], a["log_scales"], a["quats"]],
            axis=1).astype("<f4")
        p = path / "scene.ply"
        hdr = (["ply", "format binary_little_endian 1.0",
                f"element vertex {n}"]
               + [f"property float {q}" for q in props] + ["end_header"])
        p.write_bytes(("\n".join(hdr) + "\n").encode("ascii")
                      + table.tobytes())
    elif fmt == "npz":
        p = path / "scene.npz"
        np.savez_compressed(p, **a)
    else:                   # a splatfacto run directory
        p = path / "run"
        (p / "nerfstudio_models").mkdir(parents=True)
        names = dict(means="means", quats="quats", log_scales="scales",
                     logit_opacities="opacities", sh_dc="features_dc",
                     sh_rest="features_rest")
        torch.save({"step": 29999, "pipeline": {
            f"_model.gauss_params.{names[k]}": torch.as_tensor(v)
            for k, v in a.items()}},
            p / "nerfstudio_models" / "step-000029999.ckpt")
    return p


@pytest.mark.parametrize("fmt", ["json", "json_rgb", "ply", "npz",
                                 "nerfstudio"])
def test_loaders_match_reference(fmt, tmp_path):
    scene = jloaders.synthetic_scene(
        40, seed=3, sh_degree=0 if fmt.startswith("json") else 2)
    p = _write_scene_file(fmt, scene, tmp_path)
    want = jloaders.load(p)
    got = loaders.load(p, device="cpu")
    _same_scene(got, want, atol=1e-6 if fmt == "json_rgb" else 0.0)
    if fmt == "nerfstudio":
        _same_scene(loaders.load_nerfstudio(p, device="cpu"), want)
        with pytest.raises(FileNotFoundError):
            loaders.load_nerfstudio(tmp_path / "nowhere", device="cpu")


def test_save_npz_and_aabb_mask(tmp_path):
    scene = loaders.synthetic_scene(50, seed=4, sh_degree=1, device="cpu")
    loaders.save_npz(tmp_path / "s.npz", scene)
    _same_scene(loaders.load_npz(tmp_path / "s.npz", device="cpu"),
                jloaders.load_npz(tmp_path / "s.npz"))
    bounds = np.asarray([[-0.5, 0.5], [-0.2, 0.9], [-1.0, 0.1]])
    want = jloaders.aabb_mask(jloaders.load_npz(tmp_path / "s.npz"), bounds)
    np.testing.assert_array_equal(np_of(loaders.aabb_mask(scene, bounds)),
                                  np.asarray(want))
    with pytest.raises(ValueError, match="unsupported"):
        loaders.load(tmp_path / "s.txt", device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        loaders.load_npz(tmp_path / "s.npz")         # device="cuda" default


def test_meshio_matches_reference(tmp_path):
    for mod in (meshio, jmeshio):
        mod.save_obj(tmp_path / f"{mod.__name__}.obj", mod.icosphere(2))
    a = meshio.load_mesh(tmp_path / f"{jmeshio.__name__}.obj")
    b = jmeshio.load_mesh(tmp_path / f"{meshio.__name__}.obj")
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    # binary STL
    tri = np.asarray(jmeshio.box_mesh(0.2, 0.1, 0.3).vertices)[
        np.asarray(jmeshio.box_mesh(0.2, 0.1, 0.3).faces)].astype("<f4")
    rec = np.zeros(len(tri), dtype=[("n", "<f4", 3), ("v", "<f4", (3, 3)),
                                    ("a", "<u2")])
    rec["v"] = tri
    (tmp_path / "b.stl").write_bytes(b"\0" * 80 + np.uint32(len(tri)).tobytes()
                                     + rec.tobytes())
    for m, r in [(meshio.load_stl(tmp_path / "b.stl"),
                  jmeshio.load_stl(tmp_path / "b.stl")),
                 (meshio.cylinder_mesh(0.05, 0.2, 12),
                  jmeshio.cylinder_mesh(0.05, 0.2, 12)),
                 (meshio.box_mesh(1, 2, 3), jmeshio.box_mesh(1, 2, 3))]:
        np.testing.assert_array_equal(m.vertices, r.vertices)
        np.testing.assert_array_equal(m.faces, r.faces)
        np.testing.assert_array_equal(m.face_areas(), r.face_areas())
    mesh = meshio.icosphere(1)
    np.testing.assert_array_equal(
        meshio.sample_surface(mesh, 100, seed=2),
        jmeshio.sample_surface(jmeshio.icosphere(1), 100, seed=2))
    np.testing.assert_array_equal(
        meshio.sample_poisson_disk(mesh, 30, seed=1),
        jmeshio.sample_poisson_disk(jmeshio.icosphere(1), 30, seed=1))


def test_mesh_to_splat_and_concat_match_reference():
    mesh = demo_assets.tblock_mesh()
    jmesh = jdemo.tblock_mesh()
    np.testing.assert_array_equal(mesh.vertices, jmesh.vertices)
    np.testing.assert_array_equal(mesh.faces, jmesh.faces)
    kw = dict(n=500, color=(0.8, 0.3, 0.25), seed=5)
    got = mesh_to_splat(mesh, device="cpu", **kw)
    want = jmesh_to_splat(jmesh, **kw)
    _same_scene(got._replace(quats=None), want._replace(quats=None))
    np.testing.assert_allclose(np_of(got.quats), np.asarray(want.quats),
                               atol=1e-6, rtol=0)
    rich = loaders.synthetic_scene(7, seed=1, sh_degree=1, device="cpu")
    jrich = jloaders.synthetic_scene(7, seed=1, sh_degree=1)
    both = concat_scenes(got, rich)
    jboth = jconcat(want, jrich)
    assert both.sh_rest.shape == (507, 3, 3)
    _same_scene(both._replace(quats=None), jboth._replace(quats=None))


def test_demo_asset_trees_match(tmp_path):
    kw = dict(joint_config=JOINT_CONFIG, n_per_link=60, n_ground=300)
    got = demo_assets.build_demo_assets(tmp_path / "port", URDF, **kw)
    want = jdemo.build_demo_assets(tmp_path / "ref", URDF, **kw)
    for k in ("splat_config_name", "match_object_name", "task_assets_name"):
        assert got[k] == want[k]
    run = Path("splatfacto") / got["splat_config_name"]
    zg = np.load(tmp_path / "port" / run)
    zw = np.load(tmp_path / "ref" / run)
    assert sorted(zg.files) == sorted(zw.files)
    for k in zw.files:
        np.testing.assert_allclose(zg[k], zw[k], rtol=0,
                                   atol=1e-5 if k == "means" else 0.0,
                                   err_msg=k)
    mg = np.load(got["masks_dir"] / "link_masks_global_dict.npy",
                 allow_pickle=True).item()
    mw = np.load(want["masks_dir"] / "link_masks_global_dict.npy",
                 allow_pickle=True).item()
    assert sorted(mg) == sorted(mw) == [f"link{i}" for i in range(8)]
    for k in mw:
        np.testing.assert_array_equal(mg[k], mw[k])
    np.testing.assert_array_equal(
        np.load(got["masks_dir"] / "joint_config.npy"),
        np.load(want["masks_dir"] / "joint_config.npy"))
    np.testing.assert_allclose(
        np.load(got["masks_dir"] / "icp_transformation.npy"),
        np.load(want["masks_dir"] / "icp_transformation.npy"), atol=1e-5)
    assert (got["task_assets_path"] / "tblock_paper.obj").read_text() == \
        (want["task_assets_path"] / "tblock_paper.obj").read_text()


def test_visual_mesh_matches_reference(tmp_path):
    c, jc = kin.load_chain(SCARA), jkin.load_chain(SCARA)
    for vis, jvis in zip(c.visuals, jc.visuals):     # box, cylinder, sphere
        if vis is None:
            continue
        m, jm = mo.visual_mesh(vis), jmo.visual_mesh(jvis)
        np.testing.assert_allclose(m.vertices, jm.vertices, atol=1e-7)
        np.testing.assert_array_equal(m.faces, jm.faces)
    meshio.save_obj(tmp_path / "part.obj", demo_assets.tblock_mesh())
    kw = dict(mesh_path="package://part.obj", origin_xyz=(0.1, 0.0, 0.2),
              origin_rpy=(0.3, -0.2, 0.5), scale=(2.0, 1.0, 0.5))
    m = mo.visual_mesh(kin.VisualInfo(**kw),
                       lambda uri: tmp_path / uri.removeprefix("package://"))
    jm = jmo.visual_mesh(jkin.VisualInfo(**kw),
                         lambda uri: tmp_path / uri.removeprefix("package://"))
    np.testing.assert_allclose(m.vertices, jm.vertices, atol=1e-7)


def test_overlay_graph_and_frame_poses_match_reference():
    c, jc = kin.load_chain(SCARA), jkin.load_chain(SCARA)
    q0 = np.asarray([0.2, -0.4, 0.05], np.float32)
    g = mo.urdf_overlay_graph(c, q0, n_per_link=50, device="cpu")
    jg = jmo.urdf_overlay_graph(jc, jnp.asarray(q0), n_per_link=50)
    _same_scene(g.scene._replace(quats=None, means=None),
                jg.scene._replace(quats=None, means=None))
    np.testing.assert_allclose(np_of(g.scene.means),
                               np.asarray(jg.scene.means), atol=1e-5)
    np.testing.assert_allclose(np_of(g.scene.quats),
                               np.asarray(jg.scene.quats), atol=1e-5)
    np.testing.assert_array_equal(np_of(g.link_ids), np.asarray(jg.link_ids))
    for a, b in ((g.rest_inv.q, jg.rest_inv.q), (g.rest_inv.t, jg.rest_inv.t)):
        np.testing.assert_allclose(np_of(a), np.asarray(b), atol=1e-5)
    q1 = np.asarray([[0.9, 0.3, 0.1], [-0.5, 0.2, 0.0]], np.float32)
    fp = mo.overlay_frame_poses(c, torch.as_tensor(q1))
    for b in range(2):
        jfp = jmo.overlay_frame_poses(jc, jnp.asarray(q1[b]))
        np.testing.assert_allclose(np_of(fp.q[b]), np.asarray(jfp.q),
                                   atol=1e-5)
        np.testing.assert_allclose(np_of(fp.t[b]), np.asarray(jfp.t),
                                   atol=1e-5)
        posed = g.posed(SE3(fp.q[b], fp.t[b]))
        jposed = jg.posed(jfp)
        np.testing.assert_allclose(np_of(posed.means),
                                   np.asarray(jposed.means), atol=1e-5)


# --- the splat env from asset files ----------------------------------------

@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return jdemo.build_demo_assets(tmp_path_factory.mktemp("demo_assets"),
                                   URDF, joint_config=JOINT_CONFIG,
                                   n_per_link=80, n_ground=500)


def _cameras(assets):
    icp = load_icp_sim3(assets["masks_dir"] / "icp_transformation.npy")
    view = world_to_splat_pose(
        JSE3(jnp.asarray([0.2706, -0.6533, 0.6533, 0.2706]),
             jnp.asarray([1.0, 0.0, 0.8])), icp)
    return {
        0: {"link_name": "world",
            "local_frame": (np.asarray(view.q), np.asarray(view.t)),
            "type": "viewport", "render_size": [48, 64]},
        1: {"link_name": "push_tool",
            "local_frame": ((1.0, 0, 0, 0), (-0.1, 0.0, 0.033)),
            "type": "moving", "render_size": [48, 64]},
    }


def _pair(assets, **kw):
    """The reference's and the port's splat env on the same asset tree."""
    out = []
    for gym_mod, splat_mod, raster, dev in (
            (jmgym, jsplat_gym, JRaster(tile_capacity=512, chunk=64), {}),
            (manipulator_gym, splat_gym, RasterConfig(tile_capacity=512),
             {"device": "cpu"})):
        env = gym_mod.ManipulatorSimEnv(
            env_objects=True, eef_link_name="push_tool",
            package_path=str(DESC), package_name="pusharm6",
            urdf_name="pusharm6.urdf", num_dof=6, **dev)
        w = splat_mod.SplatEnvWrapper(
            env, splat_assets_path=assets["assets"],
            match_object_name=assets["match_object_name"],
            splat_config_name=assets["splat_config_name"],
            task_assets_path=assets["task_assets_path"],
            task_assets_name=assets["task_assets_name"], raster=raster,
            task_splat_count=300, **kw)
        w._configure_cameras(_cameras(assets))
        out.append(w)
    return out


RESET = {"robot_pos": [0.0] * 6, "block_pos": [0.45, 0.0, 0.0, 0.0],
         "goal_pos": [0.0, 0.0, 0.0, 0.0]}


@pytest.mark.parametrize("overlay", [False, True])
def test_splat_env_matches_reference(assets, overlay):
    ref, env = _pair(assets, robot_mesh_overlay=overlay,
                     robot_mesh_splat_count=200)
    _same_scene(env.scene_splat_frame, ref.scene_splat_frame, atol=1e-5)
    assert env.render_cam_keys == ref.render_cam_keys == [1, 0]
    obs, robs = env.reset(reset_to_state=RESET), ref.reset(
        reset_to_state=RESET)
    assert set(obs) == set(robs) == {"robot_joint_pos", "robot_joint_vel"}
    for img, rimg in zip(env.render(), ref.render()):
        assert img.shape == (48, 64, 3)
        np.testing.assert_allclose(img, np.asarray(rimg), atol=1e-4, rtol=0)
    act = np.asarray([0.2, 0.5, 0.6, 0.0, 0.8, 0.0])
    for i in range(3):
        got, want = env.step(act), ref.step(act)
        assert set(got[0]) == set(want[0])
        for k in ("camera_0", "camera_1"):
            assert got[0][k].shape == (3, 48, 64)
            np.testing.assert_allclose(got[0][k], want[0][k], atol=1e-4,
                                       rtol=0, err_msg=f"{k}, step {i}")
        np.testing.assert_allclose(got[0]["robot_joint_pos"],
                                   want[0]["robot_joint_pos"], atol=1e-5)
        assert abs(got[1] - want[1]) <= 2e-4
    assert got[0]["camera_0"].max() > 0.05


def test_splat_env_noobs_free_camera_and_errors(assets):
    ref, env = _pair(assets)
    env.reset(reset_to_state=RESET)
    ref.reset(reset_to_state=RESET)
    assert env.step(np.zeros(6), noobs=True)[0] is None
    ref.step(np.zeros(6), noobs=True)
    q = [0.2706, -0.6533, 0.6533, 0.2706]
    t = [1.0, 0.0, 0.8]
    cam = Camera.from_fov(SE3(torch.tensor(q), torch.tensor(t)), 0.9, 40, 32)
    jcam = JCamera.from_fov(JSE3(jnp.asarray(q), jnp.asarray(t)), 0.9, 40, 32)
    img = env.render_free_camera(cam)
    assert img.shape == (32, 40, 3)
    np.testing.assert_allclose(img, np.asarray(ref.render_free_camera(jcam)),
                               atol=1e-4, rtol=0)
    bare = splat_gym.SplatEnvWrapper(
        env.env, assets["assets"], assets["match_object_name"],
        assets["splat_config_name"])
    with pytest.raises(RuntimeError, match="configure"):
        bare.render()
    env.close()


def test_mask_chain_mismatch_raises(assets, tmp_path):
    """The robot masks pair positionally with the chain's non-world links:
    a count mismatch raises ``ValueError`` in both packages."""
    import shutil
    shutil.copytree(assets["assets"], tmp_path / "a")
    mdir = tmp_path / "a" / "masks" / assets["match_object_name"]
    d = np.load(mdir / "link_masks_global_dict.npy", allow_pickle=True).item()
    del d["link7"]
    np.save(mdir / "link_masks_global_dict.npy", np.asarray(d, dtype=object))
    for gym_mod, splat_mod, dev in ((jmgym, jsplat_gym, {}),
                                    (manipulator_gym, splat_gym,
                                     {"device": "cpu"})):
        env = gym_mod.ManipulatorSimEnv(
            eef_link_name="push_tool", package_path=str(DESC),
            package_name="pusharm6", urdf_name="pusharm6.urdf", **dev)
        w = splat_mod.SplatEnvWrapper(env, tmp_path / "a",
                                      assets["match_object_name"],
                                      assets["splat_config_name"])
        with pytest.raises(ValueError, match="positional"):
            w._configure_cameras(_cameras(assets))


def test_as_pose_tuple_matches_reference():
    class Viser:
        wxyz_xyz = (0.5, 0.5, -0.5, 0.5, 1.0, 2.0, 3.0)

    m = np.eye(4)
    m[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    m[:3, 3] = [0.3, -0.2, 0.1]
    for frame in (Viser(), m, ((1.0, 0, 0, 0), (0.1, 0.2, 0.3))):
        got = splat_assets.as_pose_tuple(frame)
        want = jsplat_gym._as_pose_tuple(frame)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64), atol=1e-6)


def test_card_path_imports_without_gymnasium():
    """The package, ``envs``, the splat env's gym-free core, ``entry`` and
    every example driver import with ``gymnasium``, ``click`` and
    ``pygame`` unavailable; a Gym class then fails to import (checked in a
    fresh interpreter)."""
    code = textwrap.dedent("""
        import sys
        for name in ("gymnasium", "click", "pygame"):
            sys.modules[name] = None
        import sim_a_splat_torch, sim_a_splat_torch.envs
        import sim_a_splat_torch.envs.splat_assets
        import sim_a_splat_torch.envs.pusht_envs
        import sim_a_splat_torch.envs.single_env
        import sim_a_splat_torch.tools.demo_assets
        import sim_a_splat_torch.entry
        import sim_a_splat_torch.examples.common
        import sim_a_splat_torch.examples.demo_pusht_splat
        import sim_a_splat_torch.examples.demo_joint_sliders_splat
        import sim_a_splat_torch.examples.demo_hw_splat
        import sim_a_splat_torch.examples.demo_viewer
        try:
            sim_a_splat_torch.envs.PushTEnv
        except ImportError:
            print("gym classes need gymnasium")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "gym classes need gymnasium"
