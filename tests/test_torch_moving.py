"""The port's moving-camera path against the JAX reference, on the CPU.

Each test runs the same numpy inputs through the reference (Pallas kernels
in interpret mode) and through the port with ``device="cpu"`` (the plain
versions of its kernels).  Two configurations: the reference's dry run
(``__graft_entry__.dryrun_multichip``: scene (256, 64, 32), 32×32, tile
capacity 128, 9 slots, R=2, margin 8, kc 128) and a 64×64 SH-degree-3 case
with the bench's moving-camera buckets.

Tolerances, and why:
- integers (candidate and merged-list counts, truncation and overflow
  counters, flags) exact: every sort is stable on both sides;
- cache fields gathered from the scene exact (the same indices), the
  margin statistics and ``camera_budget_used`` rtol 1e-5 (float32
  reductions in another order);
- the reprojected, sorted payload atol 1e-5: the same scalar expressions
  in the same order;
- K3's plain forward rows 0-4 atol 2e-5 (K1's plain version, per-pixel
  cumulative products against the reference's log-space sums), its
  applied-chunk row exact; its backward 1e-4 × each payload row's largest
  gradient, as ``test_torch_grad.py`` holds K1;
- images atol 2e-5 / rtol 1e-4, the reference's own bound for this path
  (``tests/test_rasterize_moving.py``); the rebin step's images atol 5e-5
  as the fixed-camera step's (``test_torch_slice.py``);
- the rollout: loss rtol 1e-5, states as ``test_torch_slice.py`` holds
  them (positions 1e-3, angle 1e-4: ten float32 PGS substeps a frame),
  flags exact, every scene field's gradient within 1e-4 × its largest.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import (
    K_TS, K_TX, K_T, assert_fields_close, assert_rows_close, graph_leaves,
    jax_pusht_states, jax_raster, k3_inputs, np_of, random_state_vectors,
    torch_raster,
)

import __graft_entry__ as graft
from sim_a_splat_tpu.ops import pallas_composite_sel as jk3
from sim_a_splat_tpu.ops import rasterize_moving as jrm
from sim_a_splat_tpu.ops.projection import Camera as JCamera
from sim_a_splat_tpu.ops.transforms import SE3 as JSE3

from sim_a_splat_torch import entry
from sim_a_splat_torch.ops import composite, composite_single
from sim_a_splat_torch.ops import rasterize_moving as trm
from sim_a_splat_torch.ops.projection import Camera
from sim_a_splat_torch.ops.transforms import SE3
from sim_a_splat_torch.physics import pusht
from sim_a_splat_torch.utils import profiling

B = 2
CAM_OFFSET = np.asarray([0.0, -40.0, -420.0], np.float32)
ROLL = dict(R=2, margin=8.0, kc=128, dyn_capacity=128, dyn_max_tiles=9)
CASES = {
    "dryrun": dict(W=32, sh_degree=0,
                   raster=dict(max_tiles_per_gaussian=9, buckets=None)),
    "sh3_64": dict(W=64, sh_degree=3,
                   raster=dict(buckets=((4, 0.80), (9, 0.12), (16, 0.08)))),
}


def jax_cams(t, W):
    return jax.vmap(lambda ti: JCamera.from_fov(
        JSE3(jnp.asarray([1.0, 0, 0, 0]), ti), 1.05, W, W))(jnp.asarray(t))


def torch_cams(t, W):
    t = torch.as_tensor(np.asarray(t, np.float32))
    q = torch.tensor([1.0, 0.0, 0.0, 0.0]).expand(t.shape[0], 4)
    return Camera.from_fov(SE3(q, t), 1.05, W, W)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """Scene, states and the candidate caches of both packages."""
    c = CASES[request.param]
    W, deg = c["W"], c["sh_degree"]
    graph = graft._build_scene(n_bg=256, n_block=64, n_agent=32, seed=0,
                               sh_degree=deg)
    rng = np.random.default_rng(0)
    vectors = random_state_vectors(rng, B)
    actions = (vectors[:, 2:4] + rng.normal(0, 10, (B, 2))).astype(np.float32)
    jstates, snp = jax_pusht_states(vectors)
    jcfg, tcfg = jax_raster(**c["raster"]), torch_raster(**c["raster"])
    cam_t = np.concatenate([snp["agent_pos"], np.zeros((B, 1), np.float32)],
                           1) + CAM_OFFSET

    ids = np.asarray(graph.link_ids)
    jst = graph.scene.select(jnp.asarray(np.where(ids == 0)[0], jnp.int32))
    n = jst.means.shape[0]
    jbuild = jax.jit(jax.vmap(lambda cam: jrm.build_moving_cache(
        jst.means, jst.quats, jst.log_scales,
        jst.sh_coeffs().reshape(n, -1), jst.opacities(), cam,
        jrm.dilated_build_config(jcfg, ROLL["margin"]), kc=ROLL["kc"],
        margin=ROLL["margin"])))
    jcaches = jbuild(jax_cams(cam_t, W))

    g = entry.graph_from_numpy(graph_leaves(graph), device="cpu")
    tst = g.scene.select(np.where(ids == 0)[0])
    tcaches = trm.build_moving_cache(
        tst.means, tst.quats, tst.log_scales,
        tst.sh_coeffs().reshape(n, -1), tst.opacities(),
        torch_cams(cam_t, W), trm.dilated_build_config(tcfg, ROLL["margin"]),
        kc=ROLL["kc"], margin=ROLL["margin"])
    return dict(c, graph=graph, g=g, jcfg=jcfg, tcfg=tcfg, cam_t=cam_t,
                jstates=jstates, snp=snp, actions=actions, jcaches=jcaches,
                tcaches=tcaches, ids=ids)


def test_build_moving_cache_matches_reference(case):
    jc, tc = case["jcaches"], case["tcaches"]
    assert set(trm.MovingCache._fields) == set(jrm.MovingCache._fields)
    for name in ("counts", "n_build_truncated", "n_near_over"):
        np.testing.assert_array_equal(np_of(getattr(tc, name)),
                                      np_of(getattr(jc, name)), err_msg=name)
    # the tiles hold candidates (dilated footprints reach several tiles)
    assert int(np_of(tc.counts).min()) > 0
    for name in ("mean", "quat", "log_scales", "sh", "base_q", "base_t",
                 "near_mean", "near_quat", "near_ls", "near_sh"):
        np.testing.assert_array_equal(np_of(getattr(tc, name)),
                                      np_of(getattr(jc, name)), err_msg=name)
    for name in ("opacity", "near_op", "margin", "z_split", "t_max"):
        np.testing.assert_allclose(np_of(getattr(tc, name)),
                                   np_of(getattr(jc, name)), atol=1e-6,
                                   err_msg=name)
    assert not np_of(tc.near_op).any()       # z_split = 0: 8 pad slots
    assert tc.near_op.shape == (B, 8)
    for name in ("s_trans", "s_rot", "z_min", "near_gap", "g_gap"):
        np.testing.assert_allclose(np_of(getattr(tc, name)),
                                   np_of(getattr(jc, name)), rtol=1e-5,
                                   err_msg=name)


def test_camera_budget_used_matches_reference(case):
    """An in-budget camera (a few world units away), an out-of-budget one
    (a large jump) and a rotated one, per env."""
    W = case["W"]
    cam_t = case["cam_t"]
    q_rot = np.asarray([np.cos(0.05), 0.0, np.sin(0.05), 0.0], np.float32)
    used = {}
    for label, dt, q in (("in", [3.0, -2.0, 1.0], None),
                         ("out", [150.0, 80.0, 0.0], None),
                         ("rot", [0.0, 0.0, 0.0], q_rot)):
        t = cam_t + np.asarray(dt, np.float32)
        qs = np.tile(q if q is not None else [1.0, 0, 0, 0], (B, 1)).astype(
            np.float32)
        jcams = jax.vmap(lambda ti, qi: JCamera.from_fov(
            JSE3(qi, ti), 1.05, W, W))(jnp.asarray(t), jnp.asarray(qs))
        want = np_of(jax.vmap(jrm.camera_budget_used)(case["jcaches"], jcams))
        tcams = Camera.from_fov(SE3(torch.as_tensor(qs), torch.as_tensor(t)),
                                1.05, W, W)
        got = np_of(trm.camera_budget_used(case["tcaches"], tcams))
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=label)
        used[label] = got
    assert (used["in"] <= 1.0).all() and (used["out"] > 1.0).all()
    assert (used["rot"] > used["in"]).all()


def test_reproject_candidates_matches_reference(case):
    W, deg = case["W"], case["sh_degree"]
    t = case["cam_t"] + np.asarray([2.5, -1.5, 0.5], np.float32)
    jspay, jcounts = jax.jit(jax.vmap(lambda c, cam: jrm.reproject_candidates(
        c, cam, deg, case["jcfg"])))(case["jcaches"], jax_cams(t, W))
    tspay, tcounts = trm.reproject_candidates(case["tcaches"],
                                              torch_cams(t, W), deg,
                                              case["tcfg"])
    np.testing.assert_array_equal(np_of(tcounts), np_of(jcounts))
    assert np_of(tcounts).sum() > 0
    np.testing.assert_allclose(np_of(tspay), np_of(jspay), atol=1e-5, rtol=0)


def test_reproject_candidates_at_the_arm_shapes():
    """The plain reprojection (kernel R1's twin, the CPU path) against the
    reference at the arm's end-effector camera's shapes: a 240×320 camera
    (a 15 × 20 grid, T = 300, tx ≠ ty) and 512 candidates a tile, SH
    degree 3, two envs: counts exact, the sorted payload atol 1e-5 and rtol
    1e-6 (the same expressions; pixel coordinates reach 320 here, where a
    float32 ulp is 3e-5, and XLA and PyTorch round some of them apart)."""
    H, W, kc = 240, 320, 512
    graph = graft._build_scene(n_bg=256, n_block=64, n_agent=32, seed=3,
                               sh_degree=3)
    ids = np.asarray(graph.link_ids)
    cam_t = np.asarray([[150.0, 210.0, -420.0], [260.0, 300.0, -380.0]],
                       np.float32)
    q = np.asarray([[1.0, 0.0, 0.0, 0.0], [0.995, 0.05, -0.08, 0.02]],
                   np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    jcfg, tcfg = jax_raster(), torch_raster()
    jst = graph.scene.select(jnp.asarray(np.where(ids == 0)[0], jnp.int32))
    n = jst.means.shape[0]

    def jcams(t):
        return jax.vmap(lambda ti, qi: JCamera.from_fov(
            JSE3(qi, ti), 1.05, W, H))(jnp.asarray(t), jnp.asarray(q))

    def tcams(t):
        return Camera.from_fov(SE3(torch.as_tensor(q), torch.as_tensor(t)),
                               1.05, W, H)

    jcaches = jax.jit(jax.vmap(lambda cam: jrm.build_moving_cache(
        jst.means, jst.quats, jst.log_scales, jst.sh_coeffs().reshape(n, -1),
        jst.opacities(), cam, jrm.dilated_build_config(jcfg, 8.0), kc=kc,
        margin=8.0)))(jcams(cam_t))
    g = entry.graph_from_numpy(graph_leaves(graph), device="cpu")
    tst = g.scene.select(np.where(ids == 0)[0])
    tcaches = trm.build_moving_cache(
        tst.means, tst.quats, tst.log_scales, tst.sh_coeffs().reshape(n, -1),
        tst.opacities(), tcams(cam_t), trm.dilated_build_config(tcfg, 8.0),
        kc=kc, margin=8.0)
    assert tuple(tcaches.mean.shape) == (B, 300, 3, kc)

    t = cam_t + np.asarray([2.5, -1.5, 0.5], np.float32)
    jspay, jcounts = jax.jit(jax.vmap(lambda c, cam: jrm.reproject_candidates(
        c, cam, 3, jcfg)))(jcaches, jcams(t))
    tspay, tcounts = trm.reproject_candidates(tcaches, tcams(t), 3, tcfg)
    np.testing.assert_array_equal(np_of(tcounts), np_of(jcounts))
    assert np_of(tcounts).sum() > 0
    np.testing.assert_allclose(np_of(tspay), np_of(jspay), atol=1e-5,
                               rtol=1e-6)


def _dyn_inputs(case, shift):
    """Posed-looking dynamics from numpy: the scene's block and agent
    gaussians moved by each env's block position, numpy colors."""
    leaves = graph_leaves(case["graph"])
    dyn = case["ids"] > 0
    rng = np.random.default_rng(5)
    pos = np.concatenate([case["snp"]["block_pos"], np.zeros((B, 1))], 1)
    means = (leaves["means"][dyn][None] + pos[:, None] + shift).astype(
        np.float32)
    nd = means.shape[1]
    return dict(
        dyn_means=means,
        dyn_quats=np.broadcast_to(leaves["quats"][dyn], (B, nd, 4)).copy(),
        dyn_log_scales=np.broadcast_to(leaves["log_scales"][dyn],
                                       (B, nd, 3)).copy(),
        dyn_colors=rng.uniform(0, 1, (B, nd, 3)).astype(np.float32),
        dyn_opacities=np.full((B, nd), 1 / (1 + np.exp(-2.0)), np.float32))


def test_render_moving_batch_matches_reference(case):
    W, deg = case["W"], case["sh_degree"]
    t = case["cam_t"] + np.asarray([1.0, 2.0, -0.5], np.float32)
    dyn = _dyn_inputs(case, np.asarray([3.0, -4.0, 0.0]))
    kw = dict(dyn_capacity=ROLL["dyn_capacity"],
              dyn_max_tiles=ROLL["dyn_max_tiles"])
    jimgs, jaux = jax.jit(lambda c, cams, d: jrm.render_moving_batch(
        c, cams, d["dyn_means"], d["dyn_quats"], d["dyn_log_scales"],
        d["dyn_colors"], d["dyn_opacities"], case["jcfg"], deg,
        background=jnp.ones(3), **kw))(
            case["jcaches"], jax_cams(t, W),
            {k: jnp.asarray(v) for k, v in dyn.items()})
    timgs, taux = trm.render_moving_batch(
        case["tcaches"], torch_cams(t, W),
        *(torch.as_tensor(dyn[k]) for k in (
            "dyn_means", "dyn_quats", "dyn_log_scales", "dyn_colors",
            "dyn_opacities")), case["tcfg"], deg, background=torch.ones(3),
        **kw)
    assert timgs.shape == (B, 3, W, W)
    np.testing.assert_array_equal(np_of(taux.tile_counts),
                                  np_of(jaux.tile_counts))
    for name in ("n_overflowed_tiles", "n_slot_truncated"):
        assert int(getattr(taux, name)) == int(getattr(jaux, name)), name
    np.testing.assert_allclose(np_of(timgs), np_of(jimgs), atol=2e-5,
                               rtol=1e-4)
    assert np_of(timgs).std() > 0.01          # the render is not blank


def test_near_split_matches_reference():
    """The near/far split (``z_split`` > 0): a camera 60 units over the
    floor, every static nearer than the split, so the candidate lists stay
    empty and all statics are re-binned each frame with the dynamics, with
    pad slots left in the near set."""
    W, near_cap = 32, 300
    graph = graft._build_scene(n_bg=256, n_block=64, n_agent=32, seed=2,
                               sh_degree=1)
    ids = np.asarray(graph.link_ids)
    cam_t = np.asarray([[150.0, 250.0, -60.0], [140.0, 270.0, -60.0]],
                       np.float32)
    kw = dict(kc=128, margin=8.0, z_split=100.0, t_max=0.05,
              near_cap=near_cap)
    jcfg, tcfg = jax_raster(), torch_raster()
    jst = graph.scene.select(jnp.asarray(np.where(ids == 0)[0], jnp.int32))
    n = jst.means.shape[0]
    jcaches = jax.jit(jax.vmap(lambda cam: jrm.build_moving_cache(
        jst.means, jst.quats, jst.log_scales, jst.sh_coeffs().reshape(n, -1),
        jst.opacities(), cam, jrm.dilated_build_config(jcfg, 8.0), **kw)))(
            jax_cams(cam_t, W))
    g = entry.graph_from_numpy(graph_leaves(graph), device="cpu")
    tst = g.scene.select(np.where(ids == 0)[0])
    tcaches = trm.build_moving_cache(
        tst.means, tst.quats, tst.log_scales, tst.sh_coeffs().reshape(n, -1),
        tst.opacities(), torch_cams(cam_t, W),
        trm.dilated_build_config(tcfg, 8.0), **kw)
    assert int(np_of(tcaches.counts).sum()) == 0
    assert 0 < int((np_of(tcaches.near_op) > 0).sum(1).min()) < near_cap
    for name in ("n_near_over", "n_build_truncated", "near_op"):
        np.testing.assert_array_equal(np_of(getattr(tcaches, name)),
                                      np_of(getattr(jcaches, name)))
    for name in ("near_gap", "g_gap", "z_min"):
        np.testing.assert_allclose(np_of(getattr(tcaches, name)),
                                   np_of(getattr(jcaches, name)), rtol=1e-5,
                                   err_msg=name)

    t = cam_t + np.asarray([0.5, -0.5, 0.0], np.float32)
    case = dict(graph=graph, ids=ids, snp=dict(
        block_pos=np.asarray([[150.0, 250.0], [140.0, 270.0]], np.float32)))
    dyn = _dyn_inputs(case, np.zeros(3))
    rk = dict(dyn_capacity=128, dyn_max_tiles=9)
    jimgs, jaux = jax.jit(lambda c, cams, d: jrm.render_moving_batch(
        c, cams, d["dyn_means"], d["dyn_quats"], d["dyn_log_scales"],
        d["dyn_colors"], d["dyn_opacities"], jcfg, 1,
        background=jnp.ones(3), **rk))(
            jcaches, jax_cams(t, W),
            {k: jnp.asarray(v) for k, v in dyn.items()})
    timgs, taux = trm.render_moving_batch(
        tcaches, torch_cams(t, W),
        *(torch.as_tensor(dyn[k]) for k in (
            "dyn_means", "dyn_quats", "dyn_log_scales", "dyn_colors",
            "dyn_opacities")), tcfg, 1, background=torch.ones(3), **rk)
    np.testing.assert_array_equal(np_of(taux.tile_counts),
                                  np_of(jaux.tile_counts))
    for name in ("n_overflowed_tiles", "n_slot_truncated"):
        assert int(getattr(taux, name)) == int(getattr(jaux, name)), name
    np.testing.assert_allclose(np_of(timgs), np_of(jimgs), atol=2e-5,
                               rtol=1e-4)


def test_rollout_matches_reference(case):
    W = case["W"]
    jroll, _ = graft._make_step_moving_cached(case["graph"], W, W,
                                              case["jcfg"], **ROLL)

    def jloss(scene):
        ns, loss, flags = jroll(scene, case["jstates"],
                                jnp.asarray(case["actions"]))
        return loss, (ns, flags)

    (jl, (jns, jflags)), jgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(case["graph"].scene)

    g = case["g"]
    roll, _ = entry.make_step_moving_cached(g, W, W, case["tcfg"],
                                            device="cpu", **ROLL)
    ns, loss, flags, grads = entry.rollout_loss_and_grads(
        roll, g.scene, pusht.state_from_numpy(case["snp"], device="cpu"),
        torch.as_tensor(case["actions"]))

    np.testing.assert_array_equal(np_of(flags), np_of(jflags))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for name in ("agent_pos", "block_pos", "agent_vel", "block_vel"):
        np.testing.assert_allclose(np_of(getattr(ns, name)),
                                   np_of(getattr(jns, name)), atol=1e-3,
                                   err_msg=name)
    np.testing.assert_allclose(np_of(ns.block_angle), np_of(jns.block_angle),
                               atol=1e-4)
    assert_fields_close(grads, jgrads, 1e-4)
    # the forward alone (no graph) gives the same loss and flags
    with torch.no_grad():
        _, loss_f, flags_f = roll(g.scene, pusht.state_from_numpy(
            case["snp"], device="cpu"), torch.as_tensor(case["actions"]))
    assert float(loss_f) == float(loss)
    np.testing.assert_array_equal(np_of(flags_f), np_of(flags))


def test_make_step_moving_matches_reference():
    """The full per-frame rebin (the cached rollout's exactness oracle)."""
    graph = graft._build_scene(n_bg=256, n_block=64, n_agent=32, seed=1,
                               sh_degree=3)
    rng = np.random.default_rng(1)
    vectors = random_state_vectors(rng, B)
    actions = (vectors[:, 2:4] + rng.normal(0, 10, (B, 2))).astype(np.float32)
    jstates, snp = jax_pusht_states(vectors)
    raster = dict(buckets=((4, 0.80), (9, 0.12), (16, 0.08)))
    jstep, _ = graft._make_step_moving(graph, 48, 48, jax_raster(**raster))
    jns, jimgs = jax.jit(jax.vmap(lambda s, a: jstep(graph.scene, s, a)))(
        jstates, jnp.asarray(actions))

    g = entry.graph_from_numpy(graph_leaves(graph), device="cpu")
    step, _ = entry.make_step_moving(g, 48, 48, torch_raster(**raster),
                                     device="cpu")
    ns, imgs, n_trunc = step(g.scene, pusht.state_from_numpy(snp, "cpu"),
                             torch.as_tensor(actions))
    assert imgs.shape == (B, 48, 48, 3) and n_trunc.shape == (B,)
    np.testing.assert_allclose(np_of(ns.agent_pos), np_of(jns.agent_pos),
                               atol=1e-3)
    np.testing.assert_allclose(np_of(imgs), np_of(jimgs), atol=5e-5)


SETTINGS = [(3.0, 1e-4), (None, None)]


@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k3_plain_matches_pallas(sigma_cutoff, term_eps):
    spay, ids, counts = k3_inputs()
    pmin = None if sigma_cutoff is None else -0.5 * sigma_cutoff ** 2
    ref = np_of(jk3._call_single_fwd(
        jnp.asarray(spay), jnp.asarray(ids), jnp.asarray(counts), K_TS, K_TX,
        pmin, True, term_eps, save_state=True))
    targs = [torch.as_tensor(a) for a in (spay, ids, counts)]
    out, applied, _ = composite_single.composite_sel_single_plain(
        *targs, K_TS, K_TX, sigma_cutoff, term_eps, save_state=True,
        return_work=True)
    got = np_of(out)
    np.testing.assert_allclose(got[:, :K_T, :5], ref[:, :K_T, :5], atol=2e-5)
    np.testing.assert_array_equal(got[:, :K_T, 5], ref[:, :K_T, 5])
    if term_eps is not None:          # the opaque tile stopped early
        assert int(applied[0, 4]) < spay.shape[-1] // composite.CHUNK

    ct = np.random.default_rng(13).normal(size=ref.shape).astype(np.float32)
    ct[:, K_T] = 0.0
    _, vjp = jax.vjp(lambda s: jk3.composite_sel_single(
        s, jnp.asarray(ids), jnp.asarray(counts), K_TS, K_TX, sigma_cutoff,
        True, term_eps), jnp.asarray(spay))
    want = np_of(vjp(jnp.asarray(ct))[0])
    grad = np_of(composite_single.composite_sel_single_bwd_plain(
        *targs, torch.as_tensor(ct), K_TS, K_TX, sigma_cutoff, term_eps))
    assert_rows_close(grad[:, :K_T], want[:, :K_T], 1e-4, "K3 payload grad")
    exact = np_of(composite_single.composite_sel_single_bwd_plain(
        targs[0].double(), *targs[1:], torch.as_tensor(ct).double(), K_TS,
        K_TX, sigma_cutoff, term_eps))
    assert_rows_close(grad[:, :K_T], exact[:, :K_T], 1e-4,
                      "K3 payload grad vs float64")
    assert not grad[:, K_T].any() and not grad[0, 2].any()
    assert not grad[0, 1, :, 100:].any() and grad[0, 1, :, :100].any()


def test_k3_function_on_cpu():
    """On CPU tensors the Function is the plain versions: its backward is
    autograd through the plain forward, no kernel launches, and row 5
    carries the applied-chunk count only when the gradient is taken."""
    spay, ids, counts = (torch.as_tensor(a) for a in k3_inputs(seed=3))
    launched = profiling.launches.copy()
    leaf = spay.clone().requires_grad_()
    out = composite_single.composite_sel_single(leaf, ids, counts, K_TS, K_TX,
                                                3.0, 1e-4)
    assert type(out.grad_fn).__name__ == "CompositeSelSingleBackward"
    assert out[:, :K_T, 5].any()
    ct = torch.as_tensor(np.random.default_rng(14).normal(
        size=tuple(out.shape)).astype(np.float32))
    (out[:, :K_T] * ct[:, :K_T]).sum().backward()
    plain = spay.clone().requires_grad_()
    out_p = composite_single.composite_sel_single_plain(plain, ids, counts,
                                                        K_TS, K_TX, 3.0, 1e-4)
    (want,) = torch.autograd.grad(out_p[:, :K_T], plain, ct[:, :K_T])
    torch.testing.assert_close(leaf.grad, want, atol=0, rtol=0)
    with torch.no_grad():
        out_ng = composite_single.composite_sel_single(leaf, ids, counts,
                                                       K_TS, K_TX, 3.0, 1e-4)
    assert out_ng.grad_fn is None and not out_ng[:, :, 5].any()
    torch.testing.assert_close(out_ng[:, :K_T, :5], out[:, :K_T, :5].detach())
    assert profiling.launches == launched


def test_k3_wrappers_check_inputs():
    spay, ids, counts = (torch.as_tensor(a) for a in k3_inputs())
    # the shared (T+1, 10, Km) mode takes counts (T+1,), not per-env ones
    with pytest.raises(ValueError, match="counts_pad"):
        composite_single.composite_sel_single(spay[0], ids, counts, K_TS,
                                              K_TX)
    with pytest.raises(ValueError, match="spay_pad"):
        composite_single.composite_sel_single(spay[None], ids, counts, K_TS,
                                              K_TX)
    with pytest.raises(ValueError, match="tile size"):
        composite_single.composite_sel_single(spay, ids, counts, 33, K_TX)
    with pytest.raises(ValueError, match="multiple"):
        composite_single.composite_sel_single(spay[..., :200], ids, counts,
                                              K_TS, K_TX)
    with pytest.raises(ValueError, match="counts_pad"):
        composite_single.composite_sel_single(spay, ids, counts[:, :-1],
                                              K_TS, K_TX)
    out = composite_single.composite_sel_single(spay, ids, counts, K_TS, K_TX)
    with pytest.raises(ValueError, match="ct"):
        composite_single.composite_sel_single_bwd(spay, ids, counts,
                                                  out[..., :5, :], out, K_TS,
                                                  K_TX)


@pytest.mark.parametrize("buckets,margin", [(((4, 0.9), (9, 0.1)), 16.0),
                                            (None, 8.0),
                                            (((4, 0.8), (9, 0.12), (16, 0.08)),
                                             16.0)])
def test_dilated_build_config_matches_reference(buckets, margin):
    got = trm.dilated_build_config(torch_raster(buckets=buckets), margin)
    want = jrm.dilated_build_config(jax_raster(buckets=buckets), margin)
    assert got.buckets == want.buckets
    assert got.max_tiles_per_gaussian == want.max_tiles_per_gaussian


def test_margin_must_exceed_one():
    g = entry.build_scene(64, 32, 16, device="cpu")
    s = g.scene
    with pytest.raises(ValueError, match="margin"):
        trm.build_moving_cache(s.means, s.quats, s.log_scales,
                               s.sh_coeffs().reshape(s.means.shape[0], -1),
                               s.opacities(), torch_cams(np.zeros((1, 3)), 32),
                               torch_raster(), kc=128, margin=0.5)
