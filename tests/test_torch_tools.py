"""The port's offline matching tools (``tools/registration.py``,
``tools/masks.py``, ``tools/match.py``) and its native binding
(``sim_a_splat_torch/native.py``) against the reference's, on
``tests/test_tools.py``'s and ``tests/test_native_geometry.py``'s inputs.

The port's binding compiles the reference's own C++ sources, so the native
queries and the npz writer must agree with the reference's binding exactly
(bit for bit); the numpy geometry is the same arithmetic, also exact; ICP
runs the same iterations on the same correspondences, so its similarity is
held to 1e-10.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sim_a_splat_tpu import native as jnative
from sim_a_splat_tpu.tools import masks as jmasks
from sim_a_splat_tpu.tools import registration as jreg
from sim_a_splat_tpu.tools.match import (
    initial_guess as jinitial_guess, load_link_meshes as jload_link_meshes,
    match as jmatch,
)

from sim_a_splat_torch import native
from sim_a_splat_torch.physics import kinematics as kin
from sim_a_splat_torch.splat.scene import GaussianScene
from sim_a_splat_torch.tools import masks, meshio, registration
from sim_a_splat_torch.tools.match import (
    initial_guess, load_link_meshes, match,
)

ARTIFACTS = ("joint_config.npy", "polygon_bounds.npy", "trans_init.npy",
             "icp_transformation.npy", "link_masks_global_dict.npy",
             "point_cloud.npy")


def unit_cube():
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                  [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)
    f = np.array([
        [0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
        [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
        [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]])
    return meshio.TriMesh(v, f)


@pytest.fixture(scope="module")
def natives():
    if not (native.available() and jnative.available()):
        pytest.skip("no C++ toolchain on this host")


def test_native_builds_here():
    """g++ is on this host: the port's binding must build (a failed build
    would quietly move the tools to their numpy paths)."""
    assert native.available(), native.build_error


def test_umeyama_matches_reference():
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(0)
    src = rng.normal(size=(100, 3))
    R = Rotation.random(random_state=1).as_matrix()
    dst = 0.37 * src @ R.T + np.array([0.5, -1.0, 2.0])
    for scaling in (True, False):
        np.testing.assert_array_equal(
            registration.umeyama(src, dst, scaling),
            jreg.umeyama(src, dst, scaling))


def test_icp_matches_reference(natives):
    """Scaled ICP on test_tools.py's cube from the pipeline's initial guess,
    both through the native KD-tree."""
    from scipy.spatial.transform import Rotation
    cube = unit_cube()
    src = meshio.sample_surface(cube, 2000, seed=3)
    R = Rotation.from_euler("xyz", [0.1, -0.15, 0.2]).as_matrix()
    dst = 0.21 * src @ R.T + np.array([0.3, 0.1, -0.2])
    init = initial_guess(src, dst)
    np.testing.assert_array_equal(init, jinitial_guess(src, dst))
    res = registration.icp(src, dst, 0.5, init=init, with_scaling=True)
    ref = jreg.icp(src, dst, 0.5, init=init, with_scaling=True)
    np.testing.assert_allclose(res.transformation, ref.transformation,
                               atol=1e-10, rtol=0)
    assert res.iterations == ref.iterations
    np.testing.assert_allclose(res.rmse, ref.rmse, rtol=1e-10)
    assert res.rmse < 2e-3


def test_crop_polygon_matches_reference():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 2, (400, 3))
    poly = np.array([[0, 0], [1, 0], [1.4, 0.8], [0.2, 1.1]])
    for axis, rng_ in ((2, (-0.5, 1.0)), (0, None)):
        np.testing.assert_array_equal(
            registration.crop_polygon(pts, poly, axis=axis,
                                      axis_range=rng_),
            jreg.crop_polygon(pts, poly, axis=axis, axis_range=rng_))


def test_mask_geometry_matches_reference():
    """The numpy point-triangle distance, mesh distance, occupancy and the
    KD-tree signed distance, on the cube and an icosphere."""
    rng = np.random.default_rng(2)
    for mesh in (unit_cube(), meshio.icosphere(2)):
        pts = rng.uniform(-1.5, 1.5, (300, 3))
        tri = mesh.vertices[mesh.faces]
        np.testing.assert_array_equal(
            masks.point_triangle_distance(pts, tri),
            jmasks.point_triangle_distance(pts, tri))
        np.testing.assert_array_equal(masks.distance_to_mesh(pts, mesh),
                                      jmasks.distance_to_mesh(pts, mesh))
        np.testing.assert_array_equal(masks.occupancy(pts, mesh),
                                      jmasks.occupancy(pts, mesh))
        np.testing.assert_array_equal(masks.signed_distance_fast(pts, mesh),
                                      jmasks.signed_distance_fast(pts, mesh))


def test_link_mask_and_global_indices_match_reference(natives):
    cube = unit_cube()
    rng = np.random.default_rng(5)
    all_pts = rng.uniform(-1, 2, (500, 3))
    crop = all_pts[:300]
    m = masks.link_mask(crop, cube, distance_threshold=0.01)
    np.testing.assert_array_equal(
        m, jmasks.link_mask(crop, cube, distance_threshold=0.01))
    inside = np.all((crop >= -0.01) & (crop <= 1.01), axis=1)
    np.testing.assert_array_equal(m, inside)
    g = masks.global_indices(crop, all_pts, m)
    np.testing.assert_array_equal(g, jmasks.global_indices(crop, all_pts, m))
    assert g[:300].sum() == m.sum() and not g[300:].any()


def test_kdtree_against_scipy_and_reference(natives):
    from scipy.spatial import cKDTree
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(4096, 3))
    q = np.concatenate([rng.normal(size=(1500, 3)), pts[:64]])
    d, i = native.KDTree(pts).query(q)
    d_ref, i_ref = cKDTree(pts).query(q, k=1)
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(d, d_ref, atol=1e-12)
    d_j, i_j = jnative.KDTree(pts).query(q)
    np.testing.assert_array_equal(i, i_j)
    np.testing.assert_array_equal(d, d_j)
    with pytest.raises(ValueError):
        native.KDTree(np.zeros((10, 2)))


def test_bvh_against_numpy_and_reference(natives):
    mesh = meshio.icosphere(2)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.5, 1.5, (800, 3))
    bvh = native.TriBVH(mesh.vertices, mesh.faces)
    d, tri = bvh.distance(pts)
    np.testing.assert_allclose(d, masks.distance_to_mesh(pts, mesh),
                               atol=1e-12)
    occ = bvh.occupancy(pts)
    np.testing.assert_array_equal(occ, masks.occupancy(pts, mesh))
    jbvh = jnative.TriBVH(mesh.vertices, mesh.faces)
    d_j, tri_j = jbvh.distance(pts)
    np.testing.assert_array_equal(d, d_j)
    np.testing.assert_array_equal(tri, tri_j)
    np.testing.assert_array_equal(occ, jbvh.occupancy(pts))
    with pytest.raises(ValueError):
        native.TriBVH(mesh.vertices, mesh.faces + len(mesh.vertices))


def test_npz_write_byte_for_byte(natives, tmp_path):
    rng = np.random.default_rng(5)
    arrays = {
        "obs.image": (rng.uniform(0, 1, (40, 24, 24, 3)) * 255).astype(
            np.uint8),
        "action": rng.normal(size=(40, 2)).astype(np.float32),
        "ints": np.arange(17, dtype=np.int64),
        "empty": np.zeros((0, 3), np.float32),
        "scalar": np.float64(3.5),
        "noncontig": np.arange(24).reshape(4, 6).T,
        "bools": np.asarray([True, False, True]),
    }
    for level in (6, 0):
        native.npz_write(tmp_path / "port.npz", arrays, level=level)
        jnative.npz_write(tmp_path / "ref.npz", arrays, level=level)
        assert (tmp_path / "port.npz").read_bytes() == \
            (tmp_path / "ref.npz").read_bytes()
        z = np.load(tmp_path / "port.npz")
        for k, v in arrays.items():
            v = np.asarray(v)
            assert z[k].dtype == v.dtype and z[k].shape == v.shape, k
            np.testing.assert_array_equal(z[k], v)


def _bot(tmp_path):
    """test_tools.py's two-link robot with cube meshes on disk."""
    cube = unit_cube()
    meshio.save_obj(tmp_path / "l1.obj", cube)
    meshio.save_obj(tmp_path / "l2.obj",
                    meshio.TriMesh(cube.vertices * 0.5, cube.faces))
    urdf = tmp_path / "bot.urdf"
    urdf.write_text("""<robot name="bot">
  <link name="base"/>
  <link name="l1"><visual><geometry><mesh filename="l1.obj"/></geometry>
    <origin xyz="0 0 0" rpy="0 0 0"/></visual></link>
  <link name="l2"><visual><geometry><mesh filename="l2.obj"/></geometry>
    <origin xyz="0 0 0" rpy="0.1 0 0.2"/></visual></link>
  <joint name="j1" type="revolute"><parent link="base"/><child link="l1"/>
    <origin xyz="0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-3" upper="3" velocity="1" effort="1"/></joint>
  <joint name="j2" type="revolute"><parent link="l1"/><child link="l2"/>
    <origin xyz="2.0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-3" upper="3" velocity="1" effort="1"/></joint>
</robot>""")
    return urdf


def test_load_link_meshes_matches_reference(tmp_path):
    from sim_a_splat_tpu.physics import kinematics as jkin
    urdf = _bot(tmp_path)
    q = np.array([0.4, -0.7])
    mine = load_link_meshes(kin.load_chain(urdf), tmp_path, q)
    ref = jload_link_meshes(jkin.load_chain(urdf), tmp_path, q)
    assert set(mine) == set(ref) == {"l1", "l2"}
    for k in mine:
        np.testing.assert_allclose(mine[k].vertices, ref[k].vertices,
                                   atol=1e-6)
        np.testing.assert_array_equal(mine[k].faces, ref[k].faces)


def test_match_pipeline_artifacts_match_reference(tmp_path, natives):
    """test_tools.py's end-to-end match (splat = s·R(robot) + t + noise,
    with a background cloud), with a crop polygon so that all six
    artifacts are written: each against the reference's run on the same
    inputs."""
    from scipy.spatial.transform import Rotation
    from sim_a_splat_tpu.splat.scene import GaussianScene as JScene
    urdf = _bot(tmp_path)
    joint_config = np.array([0.4, -0.7])
    meshes = load_link_meshes(kin.load_chain(urdf), tmp_path, joint_config)
    rng = np.random.default_rng(0)
    pts1 = meshio.sample_surface(meshes["l1"], 800, seed=1)
    pts2 = meshio.sample_surface(meshes["l2"], 800, seed=2)
    bg = rng.uniform(-6, 6, (400, 3)) + np.array([0, 0, 8.0])
    R = Rotation.from_euler("xyz", [0.2, 0.1, -0.3]).as_matrix()
    s, t = 0.21, np.array([1.0, -2.0, 0.5])
    world = np.concatenate([pts1, pts2, bg])
    means = (s * world @ R.T + t + rng.normal(0, 1e-4, world.shape)).astype(
        np.float32)
    n = len(means)
    fields = (means, np.tile([1.0, 0, 0, 0], (n, 1)), np.full((n, 3), -4.0),
              np.full(n, 2.0), np.zeros((n, 3)))
    scene = GaussianScene(*(torch.tensor(np.asarray(f, np.float32))
                            for f in fields))
    jscene = JScene(*(jnp.asarray(f, jnp.float32) for f in fields))
    Tinit = np.eye(4)
    Tinit[:3, :3] = 0.2 * R
    Tinit[:3, 3] = t
    poly = np.array([[-5.0, -5.0], [5.0, -5.0], [5.0, 5.0], [-5.0, 5.0]])
    kw = dict(crop_polygon=poly, crop_axis_range=(-5.0, 4.0),
              trans_init=Tinit, max_correspondence_distance=0.5,
              distance_threshold=0.02, n_sample_points=2000)
    res = match(urdf, scene, joint_config, tmp_path / "port", **kw)
    ref = jmatch(urdf, jscene, joint_config, tmp_path / "ref", **kw)
    expect = np.eye(4)
    expect[:3, :3] = s * R
    expect[:3, 3] = t
    np.testing.assert_allclose(res.icp_transformation, expect, atol=5e-3)
    assert abs(res.scale - ref.scale) < 1e-9
    for name in ARTIFACTS:
        a = np.load(tmp_path / "port" / name, allow_pickle=True)
        b = np.load(tmp_path / "ref" / name, allow_pickle=True)
        if name == "link_masks_global_dict.npy":
            a, b = a.item(), b.item()
            assert set(a) == set(b) == {"link0", "link1"}
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
            assert a["link0"][:800].mean() > 0.95
            assert not (a["link0"][1600:] | a["link1"][1600:]).any()
        elif name == "point_cloud.npy":
            np.testing.assert_allclose(a, b, atol=1e-6)
        else:
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=0)
    from sim_a_splat_torch.scenegraph.registration import (
        load_icp_sim3, load_link_masks,
    )
    sim3 = load_icp_sim3(tmp_path / "port" / "icp_transformation.npy")
    np.testing.assert_allclose(float(sim3.s), s, atol=1e-3)
    assert set(load_link_masks(tmp_path / "port" /
                               "link_masks_global_dict.npy")) == {"link0",
                                                                  "link1"}
