"""The port's splat env wrapper against the JAX reference, on the CPU:
``build`` and the registration transforms, the three render routes, the
batched step and the R-frame rollout with the end-effector camera over
candidate caches, forward and its gradient to every scene field.

Two scenes: the planar 2-link arm of ``tests/test_splat_wrapper.py``
(``tests/assets/planar2.urdf``, a DC-colour cluster per link, a T-block
cluster and a background, a 32×32 moving camera on the tool and a 48×64
viewport) and the product scene of ``benchmarks/bench_product.py``
(``pusharm6``, SH degree 3) at N = 3,000 and 64×96.  The reference runs
its single-env functions under ``jax.vmap`` with Pallas in interpret mode;
the port runs batched with ``device="cpu"``.  States are the reference's,
carried over by ``entry.product_state_from_numpy``.

Tolerances, and why:
- integers (``schema_to_body``, link ids, the severe and bounded
  counters, ``terminated``) exact: the same binning, sorts stable on both
  sides;
- the scene, masks and rest poses built from one seed: exact, rest poses
  atol 1e-6 (each package's float32 FK);
- the env's states and rewards as ``test_torch_arm.py`` holds them;
- on the planar scene: images atol 5e-5 (the fixed-camera steps' bound in
  ``test_torch_slice.py``: the kernels' plain versions accumulate in
  another order than the Pallas kernels), the loss rtol 1e-5, every scene
  field's gradient within 2e-4 × its largest reference gradient (as
  earlier slices hold their train steps);
- on the product scene, whose two cameras sit inside its background
  cloud: images atol 6e-4 (``NEAR_ATOL``), up to 0.5 % of the values
  within 0.012 (``FLIP_SHARE``, ``FLIP_ATOL``), the loss rtol 1e-4 and
  the gradients within 2e-3 × each field's largest (``NEAR_GRAD_REL``).
  Its gaussians nearer than 0.35 m to a lens project with conics that
  differ by up to 9.4e-4 relative between the packages (the 2-D
  covariance inverse is ill-conditioned that close, in float32 on both
  sides; 2.6e-6 past 1 m): one frame's images differed by up to 5.4e-4
  (99.9th percentile 4.0e-4), and its largest gradient differences
  (9.5e-4 of the field's largest, ``log_scales``) sit on a gaussian
  0.0100 m in front of the viewport's lens.  Its 0.15-0.4 px gaussians
  also put list entries on the cut-offs: entry 4 of the viewport's tile
  11 has power −4.5, the 3σ cut, at pixel (86, 23) within float32
  rounding, and the packages' conics (7e-7 apart) fall on either side of
  it, 0.0031 at that pixel; one entry switched there is at most
  op·e^−4.5 < 0.0098 (or ≈ 1/255) times a colour ≤ 1.2, and such
  switches touched 0.13 % of the rollout's values.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import (
    assert_fields_close, graph_leaves, jax_raster, manipulator_leaves, np_of,
    torch_raster,
)

from sim_a_splat_tpu.envs.manipulator_envs import ManipulatorEnvF as JEnv
from sim_a_splat_tpu.ops import quaternion as jq
from sim_a_splat_tpu.envs.splat_wrapper import (
    CameraSpec as JCam, SplatEnvWrapperF as JWrapper,
)
from sim_a_splat_tpu.ops.transforms import SE3 as JSE3, Sim3 as JSim3
from sim_a_splat_tpu.physics import kinematics as jk
from sim_a_splat_tpu.scenegraph import registration as jreg
from sim_a_splat_tpu.splat.scene import GaussianScene as JScene

from sim_a_splat_torch import entry
from sim_a_splat_torch.envs.manipulator_envs import ManipulatorEnvF
from sim_a_splat_torch.envs.splat_wrapper import CameraSpec, SplatEnvWrapperF
from sim_a_splat_torch.ops.sh import C0
from sim_a_splat_torch.ops.transforms import SE3, Sim3
from sim_a_splat_torch.physics import kinematics as tk
from sim_a_splat_torch.scenegraph import registration as treg
from sim_a_splat_torch.splat.scene import GaussianScene

PLANAR = Path(__file__).parent / "assets" / "planar2.urdf"
B = 2
IMG_ATOL = 5e-5
GRAD_REL = 2e-4
# the small product configuration: bench_product.py's buckets and moving
# camera (margin, the near/far split), capacities cut to the small scene
PRODUCT_RASTER = dict(tile_capacity=128, max_tiles_per_gaussian=16,
                      buckets=((2, 0.70), (6, 0.20), (16, 0.10)))
PRODUCT_RENDER = dict(sel_tiles=24, dyn_capacity=128, margin=16.0, kc=128,
                      z_split=0.35, near_cap=256)
PRODUCT_SIZE = (64, 96)
FLIP_ATOL = 0.012
FLIP_SHARE = 5e-3
NEAR_ATOL = 6e-4
NEAR_GRAD_REL = 2e-3


def t32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def jse3(q, t):
    return JSE3(jnp.asarray(q, jnp.float32), jnp.asarray(t, jnp.float32))


def planar_parts(sh_degree=0, seed=0):
    """The planar scene as numpy: a cluster per link at its rest FK, a
    block cluster, a background; masks, rest poses."""
    rng = np.random.default_rng(seed)
    rest_fk = jk.fk(jk.load_chain(PLANAR), jnp.zeros(2))
    colors = [[0.8, 0.2, 0.2], [0.2, 0.8, 0.2], [0.2, 0.2, 0.8],
              [0.8, 0.8, 0.2]]
    centers = [np_of(rest_fk.t[i]) for i in range(4)]
    specs = ([(c, 50, col, 0.04) for c, col in zip(centers, colors)]
             + [([0.45, 0.0, 0.0], 60, [0.6, 0.6, 0.6], 0.04),
                ([0.0, 0.0, -0.3], 100, [0.9, 0.9, 0.9], 0.5)])
    parts = []
    for center, n, color, spread in specs:
        parts.append(dict(
            means=rng.normal(size=(n, 3)) * spread + np.asarray(center),
            quats=rng.normal(size=(n, 4)),
            log_scales=rng.uniform(np.log(0.01), np.log(0.03), (n, 3)),
            logit_opacities=np.full(n, 2.0),
            sh_dc=(np.clip(np.asarray(color) + rng.normal(0, 0.05, (n, 3)),
                           0, 1) - 0.5) / C0))
    leaves = {k: np.concatenate([p[k] for p in parts]).astype(np.float32)
              for k in parts[0]}
    n = len(leaves["means"])
    leaves["sh_rest"] = (None if sh_degree == 0 else rng.normal(
        0, 0.05, (n, (sh_degree + 1) ** 2 - 1, 3)).astype(np.float32))
    off = np.cumsum([0] + [s[1] for s in specs])
    masks = {}
    for i in range(4):
        m = np.zeros(n, bool)
        m[off[i]:off[i + 1]] = True
        masks[f"link{i}"] = m
    mt = np.zeros(n, bool)
    mt[off[4]:off[5]] = True
    masks["task"] = mt
    rest_q = np.concatenate([[[1.0, 0, 0, 0]], np_of(rest_fk.q),
                             [[1.0, 0, 0, 0]]]).astype(np.float32)
    rest_t = np.concatenate([np.zeros((1, 3)), np_of(rest_fk.t),
                             [[0.45, 0.0, 0.0]]]).astype(np.float32)
    return leaves, masks, rest_q, rest_t


PLANAR_CAMS = {
    0: dict(type="viewport", render_size=(48, 64),
            local_frame=((1.0, 0, 0, 0), (0.3, 0.0, -2.0)), fov=0.9),
    1: dict(type="moving", render_size=(32, 32), link_name="tool",
            local_frame=((1.0, 0, 0, 0), (0.0, 0.0, -1.0)), fov=0.9),
}


def planar_wrappers(sh_degree=0, scene_frame="world", icp=None,
                    extra_mask=False, **raster):
    """The planar scene's wrapper in both packages, built by each
    package's ``build`` from the same arrays (``extra_mask``: one robot
    mask more than the arm has links)."""
    leaves, masks, rest_q, rest_t = planar_parts(sh_degree)
    if extra_mask:
        masks = {**masks, "link4": np.zeros_like(masks["task"])}
    fields = ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
              "sh_rest")
    jscene = JScene(*(None if leaves[f] is None else jnp.asarray(leaves[f])
                      for f in fields))
    tscene = GaussianScene(*(None if leaves[f] is None else t32(leaves[f])
                             for f in fields))
    jw = JWrapper.build(
        env=JEnv(chain=jk.load_chain(PLANAR), eef_link="tool"),
        scene=jscene, link_masks=masks,
        camera_setup_info={k: JCam(**v) for k, v in PLANAR_CAMS.items()},
        task_mask_key="task", rest_poses_world=jse3(rest_q, rest_t),
        scene_frame=scene_frame, icp=icp and JSim3(*icp),
        raster=jax_raster(**raster))
    tw = SplatEnvWrapperF.build(
        env=ManipulatorEnvF(chain=tk.load_chain(PLANAR), eef_link="tool",
                            device="cpu"),
        scene=tscene, link_masks=masks,
        camera_setup_info={k: CameraSpec(**v)
                           for k, v in PLANAR_CAMS.items()},
        task_mask_key="task", rest_poses_world=SE3(t32(rest_q), t32(rest_t)),
        scene_frame=scene_frame,
        icp=icp and Sim3(*(t32(a) for a in icp)),
        raster=torch_raster(**raster))
    return jw, tw


def states_of(jw, resets):
    """The reference's batched states from one reset dict per env, and the
    same states carried over to the port."""
    env = jw.env
    js = [env.reset(jax.random.key(0), r)[0] for r in resets]
    js = jax.tree.map(lambda *x: jnp.stack(x), *js)
    return js, entry.product_state_from_numpy(manipulator_leaves(js),
                                              device="cpu")


PLANAR_RESETS = [
    {"robot_pos": np.asarray([0.1, -0.05]),
     "block_pos": np.array([0.45, 0.0, 0.2, 0.0])},
    {"robot_pos": np.asarray([-0.2, 0.3]),
     "block_pos": np.array([0.45, 0.1, 0.2, 0.3])},
]


def with_scene(w, leaves):
    """A port wrapper whose graph is the reference graph's arrays."""
    return dataclasses.replace(w, graph=entry.graph_from_numpy(
        leaves, device="cpu"))


@pytest.fixture(scope="module")
def planar():
    jw, tw = planar_wrappers()
    js, ts = states_of(jw, PLANAR_RESETS)
    return jw, tw, js, ts


def test_build_matches_reference(planar):
    jw, tw, _, _ = planar
    np.testing.assert_array_equal(tw.schema_to_body, jw.schema_to_body)
    assert [k for k, _ in tw.cameras] == [k for k, _ in jw.cameras] == [1, 0]
    assert [dataclasses.astuple(c) for _, c in tw.cameras] == \
        [dataclasses.astuple(c) for _, c in jw.cameras]
    want = graph_leaves(jw.graph)
    got = graph_leaves(tw.graph)
    for k in want:
        if k.startswith("rest_inv"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-6,
                                       err_msg=k)
        elif want[k] is not None:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the positional mask pairing refuses a count that does not match
    for build in (lambda: planar_wrappers(extra_mask=True)[0],
                  lambda: planar_wrappers(extra_mask=True)[1]):
        with pytest.raises(ValueError, match="link-mask/schema mismatch"):
            build()


def test_build_splat_frame_matches_reference():
    """``scene_frame="splat"``: the scene and the fixed cameras mapped to
    the world frame through a similarity."""
    ang = 0.3
    icp = (np.asarray([np.cos(ang / 2), 0.0, 0.0, np.sin(ang / 2)],
                      np.float32),
           np.asarray([0.2, -0.1, 0.05], np.float32), np.float32(1.7))
    jw, tw = planar_wrappers(scene_frame="splat", icp=icp)
    for name in ("means", "quats", "log_scales"):
        np.testing.assert_allclose(np_of(getattr(tw.graph.scene, name)),
                                   np_of(getattr(jw.graph.scene, name)),
                                   atol=1e-6, err_msg=name)
    for (_, tc), (_, jc) in zip(tw.cameras, jw.cameras):
        for a, b in zip(tc.local_frame, jc.local_frame):
            np.testing.assert_allclose(np.asarray(a, np.float32),
                                       np.asarray(b, np.float32), atol=1e-6)


@pytest.mark.parametrize("rotate_offset", [False, True])
def test_registration_matches_reference(tmp_path, rotate_offset):
    """``scenegraph/registration.py``: the artifacts' loaders, the scene
    and poses mapped between the splat and world frames, the conjugated
    link transform and the attached-camera frames (atol 1e-5: float32
    quaternion products in the same order)."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=4)
    R = np.asarray(jq.to_rotation_matrix(jnp.asarray(q, jnp.float32)),
                   np.float64)
    m = np.eye(4)
    m[:3, :3], m[:3, 3] = 1.7 * R, [0.2, -0.1, 0.05]
    np.save(tmp_path / "icp.npy", m)
    masks = {"link0": rng.random(20) > 0.5, "task": rng.random(20) > 0.5}
    np.save(tmp_path / "masks.npy", masks, allow_pickle=True)
    jicp = jreg.load_icp_sim3(tmp_path / "icp.npy")
    ticp = treg.load_icp_sim3(tmp_path / "icp.npy")
    for name in ("q", "t", "s"):
        np.testing.assert_allclose(np_of(getattr(ticp, name)),
                                   np_of(getattr(jicp, name)), atol=1e-6)
    tm = treg.load_link_masks(tmp_path / "masks.npy")
    assert set(tm) == set(masks) and all(
        np.array_equal(tm[k], masks[k]) for k in masks)

    qs = rng.normal(size=(3, 4)).astype(np.float32)
    ts = rng.normal(size=(3, 3)).astype(np.float32)
    jpose, tpose = jse3(qs, ts), SE3(t32(qs), t32(ts))
    jrest, trest = jse3(qs[::-1].copy(), ts[::-1].copy()), SE3(
        t32(qs[::-1].copy()), t32(ts[::-1].copy()))
    off = np.asarray([0.0, -0.15, -1.2], np.float32)
    pairs = [
        (jreg.splat_to_world_pose(jpose, jicp),
         treg.splat_to_world_pose(tpose, ticp)),
        (jreg.world_to_splat_pose(jpose, jicp),
         treg.world_to_splat_pose(tpose, ticp)),
        (jreg.conjugated_link_transform(jicp, jpose, jrest),
         treg.conjugated_link_transform(ticp, tpose, trest)),
        (jreg.attached_frame(jicp, jpose, jnp.asarray(off), rotate_offset),
         treg.attached_frame(ticp, tpose, t32(off), rotate_offset)),
        (jreg.attached_frame_world(jpose, jnp.asarray(off), rotate_offset),
         treg.attached_frame_world(tpose, t32(off), rotate_offset)),
    ]
    for i, (j, t) in enumerate(pairs):
        np.testing.assert_allclose(np_of(t.q), np_of(j.q), atol=1e-5,
                                   err_msg=str(i))
        np.testing.assert_allclose(np_of(t.t), np_of(j.t), atol=1e-5,
                                   err_msg=str(i))
    leaves, _, _, _ = planar_parts(sh_degree=1)
    fields = ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
              "sh_rest")
    js = jreg.canonicalize(JScene(*(jnp.asarray(leaves[f]) for f in fields)),
                           jicp)
    tsc = treg.canonicalize(GaussianScene(*(t32(leaves[f]) for f in fields)),
                            ticp)
    for f in fields:
        np.testing.assert_allclose(np_of(getattr(tsc, f)),
                                   np_of(getattr(js, f)), atol=1e-5,
                                   err_msg=f)


def test_render_matches_reference(planar):
    jw, tw, js, ts = planar
    jimgs = jax.jit(jax.vmap(jw.render))(js)
    timgs = tw.render(ts)
    assert [tuple(i.shape) for i in timgs] == [(B, 32, 32, 3), (B, 48, 64, 3)]
    for t, j in zip(timgs, jimgs):
        np.testing.assert_allclose(np_of(t), np_of(j), atol=IMG_ATOL)
        assert np_of(t).std() > 0.01
    # an arbitrary camera, one per env
    draws = tw._base_env().draw_state(ts)
    cams = tw._camera(tw._moving_pose(tw.cameras[0][1], draws),
                      tw.cameras[0][1])
    img = tw.render_camera(draws, cams)
    np.testing.assert_allclose(np_of(img), np_of(jimgs[0]), atol=IMG_ATOL)


def test_render_with_cache_matches_reference(planar):
    jw, tw, js, ts = planar
    jimgs = jax.jit(jax.vmap(lambda s: jw.render_with_cache(
        s, jw.build_render_cache())))(js)
    timgs = tw.render_with_cache(ts, tw.build_render_cache())
    for t, j in zip(timgs, jimgs):
        np.testing.assert_allclose(np_of(t), np_of(j), atol=IMG_ATOL)


@pytest.mark.parametrize("route,moving_cache", [("K2", False), ("K2", True),
                                                ("per-env", False)])
def test_render_with_cache_batch_matches_reference(planar, route,
                                                   moving_cache):
    """Both routes of the fixed camera (K2 at capacities that are
    multiples of 128; the per-env cached render, lists merged, at a
    dynamic capacity of 96, where the reference's merged lists of 224
    entries take its scan in 32-entry chunks), the moving camera rebinned
    or over candidate caches, and a ``sel_tiles`` too small for the
    dynamics (the severe class)."""
    jw, tw, js, ts = planar
    if route == "per-env":
        jw = dataclasses.replace(jw, raster=jw.raster._replace(chunk=32))
    kw = dict(dyn_capacity=128 if route == "K2" else 96, sel_tiles=3)
    mkw = dict(margin=80.0, kc=128, z_split=0.35, near_cap=64)

    def jrender(s):
        draws = jax.vmap(jw._base_env().draw_state)(s)
        mc = jw.build_moving_caches(draws, **mkw) if moving_cache else None
        return jw.render_with_cache_batch(s, jw.build_render_cache(),
                                          moving_caches=mc, **kw)

    jimgs, jaux = jax.jit(jrender)(js)
    draws = tw._base_env().draw_state(ts)
    mc = tw.build_moving_caches(draws, **mkw) if moving_cache else None
    timgs, taux = tw.render_with_cache_batch(ts, tw.build_render_cache(),
                                             moving_caches=mc, **kw)
    assert [tuple(i.shape) for i in timgs] == [(B, 3, 32, 32), (B, 3, 48, 64)]
    for k in ("dropped_tiles", "truncated"):
        assert int(taux[k]) == int(jaux[k]), k
    if route == "K2":
        assert int(taux["dropped_tiles"]) > 0
    for t, j in zip(timgs, jimgs):
        np.testing.assert_allclose(np_of(t), np_of(j), atol=IMG_ATOL)


def test_step_with_cache_batch_matches_reference(planar):
    jw, tw, js, ts = planar
    actions = np.asarray([[0.1, -0.1], [0.4, 0.2]], np.float32)
    jtr = jax.jit(lambda s, a: jw.step_with_cache_batch(
        s, a, jw.build_render_cache(), sel_tiles=12))(js, jnp.asarray(actions))
    ttr = tw.step_with_cache_batch(ts, t32(actions), tw.build_render_cache(),
                                   sel_tiles=12)
    assert set(ttr.obs) == set(jtr.obs) and set(ttr.info) == set(jtr.info)
    for k in ("camera_0", "camera_1"):
        np.testing.assert_allclose(np_of(ttr.obs[k]), np_of(jtr.obs[k]),
                                   atol=IMG_ATOL)
    for k in ("render_overflow", "render_truncated"):
        np.testing.assert_array_equal(np_of(ttr.info[k]), np_of(jtr.info[k]))
        assert ttr.info[k].dtype == torch.int32
    np.testing.assert_allclose(np_of(ttr.reward), np_of(jtr.reward),
                               atol=2e-4)
    np.testing.assert_allclose(np_of(ttr.state.arm.q), np_of(jtr.state.arm.q),
                               atol=1e-5)
    # noobs skips the render
    assert "camera_0" not in tw.step_with_cache_batch(
        ts, t32(actions), {}, noobs=True).obs


def test_step_and_reset_match_reference(planar):
    """The uncached env API: ``reset`` (reset_to_state) and ``step``, the
    images by the full rebin."""
    jw, tw, js, ts = planar
    jstate, jobs = jw.reset(jax.random.key(0), PLANAR_RESETS[1])
    tstate, tobs = tw.reset(reset_to_state=PLANAR_RESETS[1], batch=1)
    for k in ("camera_0", "camera_1", "robot_joint_pos"):
        np.testing.assert_allclose(np_of(tobs[k][0]), np_of(jobs[k]),
                                   atol=IMG_ATOL, err_msg=k)
    jtr = jw.step(jstate, jnp.asarray([0.3, -0.2]))
    ttr = tw.step(tstate, t32([[0.3, -0.2]]))
    for k in ("camera_0", "camera_1"):
        np.testing.assert_allclose(np_of(ttr.obs[k][0]), np_of(jtr.obs[k]),
                                   atol=IMG_ATOL, err_msg=k)
    jtr = jw.step_with_cache(jstate, jnp.asarray([0.3, -0.2]),
                             jw.build_render_cache())
    ttr = tw.step_with_cache(tstate, t32([[0.3, -0.2]]),
                             tw.build_render_cache())
    for k in ("camera_0", "camera_1"):
        np.testing.assert_allclose(np_of(ttr.obs[k][0]), np_of(jtr.obs[k]),
                                   atol=IMG_ATOL, err_msg=k)


def _jax_rollout(jw, js, actions_seq, r):
    """The reference's rollout, loss and scene gradient, as
    ``bench_product.py::measure_product`` takes them."""
    def loss_of(scene):
        w = dataclasses.replace(jw, graph=jw.graph._replace(scene=scene))
        trs = w.rollout_with_cache_batch(
            js, actions_seq, w.build_render_cache(scene),
            sel_tiles=r["sel_tiles"], dyn_capacity=r["dyn_capacity"],
            moving_margin=r["margin"], moving_kc=r["kc"],
            moving_z_split=r["z_split"], moving_near_cap=r["near_cap"])
        return (jnp.mean(trs.obs["camera_0"] ** 2)
                + jnp.mean(trs.obs["camera_1"] ** 2)), trs

    return jax.jit(jax.value_and_grad(loss_of, has_aux=True))(jw.graph.scene)


def assert_images_close(got, want, what, atol=IMG_ATOL, flips=False):
    """Images within ``atol``; with ``flips``, up to FLIP_SHARE of the
    pixels may instead be within FLIP_ATOL (an entry at a cut-off)."""
    d = np.abs(np_of(got) - np_of(want))
    assert got.shape == want.shape, what
    off = int((d > atol).sum())
    allowed = FLIP_SHARE * d.size if flips else 0
    assert d.max() <= (FLIP_ATOL if flips else atol) and off <= allowed, \
        f"{what}: max|Δ| {d.max():.3e}, {off} of {d.size} past {atol}"


def _check_rollout(tw, ts, jw, js, actions_seq, r, atols=(IMG_ATOL,) * 2,
                   flips=False, loss_rtol=1e-5, grad_rel=GRAD_REL):
    (jl, jtrs), jgrads = _jax_rollout(jw, js, jnp.asarray(actions_seq), r)
    rollout, _, _ = entry.make_product_rollout(
        tw, sel_tiles=r["sel_tiles"], dyn_capacity=r["dyn_capacity"],
        margin=r["margin"], kc=r["kc"], z_split=r["z_split"],
        near_cap=r["near_cap"])
    trs, loss, grads = entry.product_loss_and_grads(rollout, tw.graph.scene,
                                                    ts, t32(actions_seq))
    R = actions_seq.shape[0]
    for k, atol in zip(("camera_0", "camera_1"), atols):
        assert trs.obs[k].shape[0] == R
        assert_images_close(trs.obs[k], jtrs.obs[k], k, atol, flips)
    for k in ("render_overflow", "render_truncated"):
        np.testing.assert_array_equal(np_of(trs.info[k]), np_of(jtrs.info[k]),
                                      err_msg=k)
    np.testing.assert_allclose(np_of(trs.reward), np_of(jtrs.reward),
                               atol=2e-4)
    np.testing.assert_array_equal(np_of(trs.terminated),
                                  np_of(jtrs.terminated))
    for a, b in zip(trs.state.arm, jtrs.state.arm):
        np.testing.assert_allclose(np_of(a), np_of(b), atol=1e-5)
    np.testing.assert_allclose(np_of(trs.state.block_pos),
                               np_of(jtrs.state.block_pos), atol=1e-4)
    np.testing.assert_allclose(float(loss), float(jl), rtol=loss_rtol)
    assert_fields_close(grads, jgrads, grad_rel)
    # the forward alone (no graph) gives the same images and counters
    with torch.no_grad():
        trs_f, loss_f = rollout(tw.graph.scene, ts, t32(actions_seq))
    assert float(loss_f) == float(loss)
    np.testing.assert_array_equal(np_of(trs_f.info["render_truncated"]),
                                  np_of(trs.info["render_truncated"]))
    return trs


def test_rollout_planar_matches_reference(planar):
    """R = 3 frames of both cameras over candidate caches with the near
    set on (``z_split`` 0.35 with the camera 1 m over the scene) and
    overflowing its 8 slots: the severe counter carries the build-time
    overflow again in every frame, as the reference adds it
    (``splat_wrapper.py:559``), so the rollout's total is R times it."""
    jw, tw, js, ts = planar
    r = dict(sel_tiles=12, dyn_capacity=128, margin=32.0, kc=128,
             z_split=0.35, near_cap=8)
    actions_seq = np.asarray([[[0.11, -0.06], [-0.19, 0.31]],
                              [[0.12, -0.07], [-0.18, 0.32]],
                              [[0.13, -0.07], [-0.18, 0.33]]], np.float32)
    trs = _check_rollout(tw, ts, jw, js, actions_seq, r)
    mc = tw.build_moving_caches(
        tw._base_env().draw_state(ts), margin=r["margin"], kc=r["kc"],
        z_split=r["z_split"], near_cap=r["near_cap"])[1]
    near_over = int(mc.n_near_over.sum())
    assert near_over > 0 and int(np_of(mc.near_op > 0).sum()) > 0
    over = np_of(trs.info["render_overflow"])[:, 0]
    assert (over >= near_over).all() and over.sum() >= 3 * near_over


def jax_settled(jw, reset, steps):
    """``B`` reference envs reset to ``reset`` and stepped ``steps`` times
    at the bench's base action; the states and their port copies."""
    js, _ = jax.vmap(lambda k: jw.env.reset(k, reset))(
        jax.random.split(jax.random.key(0), B))
    act = jnp.tile(jnp.asarray(entry.PRODUCT_ACTION, jnp.float32), (B, 1))
    js = jax.jit(lambda s: jax.lax.scan(
        lambda s, _: (jax.vmap(jw.env.step)(s, act).state, None), s, None,
        length=steps)[0])(js)
    return js, entry.product_state_from_numpy(manipulator_leaves(js),
                                              device="cpu")


@pytest.fixture(scope="module")
def product():
    """The product scene at N = 3,000 in both packages: the reference's
    ``build_product_wrapper`` and the port's."""
    from benchmarks.bench_product import build_product_wrapper
    jw = build_product_wrapper(n_total=3000, sh_degree=3,
                               render_size=PRODUCT_SIZE,
                               raster=jax_raster(**PRODUCT_RASTER))
    tw = entry.build_product_wrapper(n_total=3000, sh_degree=3,
                                     render_size=PRODUCT_SIZE,
                                     raster=torch_raster(**PRODUCT_RASTER),
                                     device="cpu")
    return jw, tw


def test_build_product_wrapper_matches_reference(product):
    jw, tw = product
    want, got = graph_leaves(jw.graph), graph_leaves(tw.graph)
    for k in want:
        tol = 1e-6 if k in ("means", "rest_inv_q", "rest_inv_t") else 0
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0,
                                   err_msg=k)
    np.testing.assert_array_equal(tw.schema_to_body, jw.schema_to_body)
    assert [dataclasses.astuple(c) for _, c in tw.cameras] == \
        [dataclasses.astuple(c) for _, c in jw.cameras]
    assert tw.raster == torch_raster(**PRODUCT_RASTER)
    # the port's reset and settle reach the reference's states
    ts, actions = entry.product_inputs(tw, B, R=4, settle=5)
    js, _ = jax_settled(jw, entry.PRODUCT_RESET, 5)
    np.testing.assert_allclose(np_of(ts.arm.q), np_of(js.arm.q), atol=1e-5)
    np.testing.assert_allclose(np_of(ts.block_pos), np_of(js.block_pos),
                               atol=1e-4)
    assert tuple(actions.shape) == (4, B, 6)


def test_rollout_product_matches_reference(product):
    """The product path at a small N: R = 2 frames of the viewport (K2) and
    the end-effector camera with the near/far split (K3), the bench's
    dither actions, forward and the gradient to all six scene fields."""
    jw, tw = product
    tw = with_scene(tw, graph_leaves(jw.graph))
    # the block away from the end effector's path: with the end effector
    # pushing it, float32 PGS differences (1e-4 m, test_torch_arm.py) would
    # move its sub-pixel gaussians between the packages' images
    js, ts = jax_settled(jw, {**entry.PRODUCT_RESET,
                              "block_pos": np.array([0.45, 0.35, 0.2, 0.0])},
                         5)
    R = 2
    phase = np.sin(2 * np.pi * np.arange(R) / R)[:, None, None]
    pattern = np.asarray([0.0, 1.0, -1.0, 0.0, 1.0, 0.0])
    actions_seq = np.broadcast_to(
        np.asarray(entry.PRODUCT_ACTION) + 0.004 * phase * pattern,
        (R, B, 6)).astype(np.float32)
    trs = _check_rollout(tw, ts, jw, js, actions_seq, PRODUCT_RENDER,
                         atols=(NEAR_ATOL, NEAR_ATOL), flips=True,
                         loss_rtol=1e-4, grad_rel=NEAR_GRAD_REL)
    for k in ("camera_0", "camera_1"):
        assert np_of(trs.obs[k]).std() > 0.01, k
