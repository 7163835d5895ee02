"""The port's pushT env layer against the JAX reference, on the CPU: the
convex clip area, coverage, reward, done and the state observation, the
keypoints, the 2-D renderer, and 20 steps of ``PushTEnvF`` in each
observation mode; and the reward's autograd gradient through one control
step.

The reference's single-env functions run under ``jax.vmap``; the port's
batched functions with ``device="cpu"``.  The reference's coverage is
taken unjitted: under ``jax.jit`` XLA folds its goal area (each goal box
clipped by itself, a degenerate clip) into a constant with half the stem's
area, 4,950 in place of 6,300 (``ROADMAP.md`` §3), so the jitted
reference's coverage is 1.27× too large.  The rollouts run the reference's
step jitted and hold the port's reward and done to the reference's
unjitted ``reward_done`` on the reference's states.

Tolerances, and why:
- the clip area, coverage, reward and the state observation on the same
  states: atol 1e-5 (the same float32 operations in the same order; the
  clip areas agree bit for bit on these inputs);
- ``default_keypoint_map``: exact (numpy on both sides);
  ``keypoints_global``: atol 1e-4 (float32 rotations of values ≤ 600);
- ``render_frame`` and ``keypoint_overlay``: equal but for at most
  ``EDGE_PIXELS`` pixels (a pixel centre on a shape's edge may flip between
  two float32 implementations of its cross products);
- the rollouts: states atol 1e-3 (``test_torch_physics.py``'s bound for a
  control step: the clamps of the float32 PGS switch on last-bit
  differences), the block's velocities also rtol 1e-4 (up to ~250 px/s,
  4.8e-3 apart after a wall contact), the keypoint observation atol 1e-3 (it follows the block's
  position), rewards atol 1e-5 on the same states, done exact, images as
  above;
- the reward's gradient: finite (the reference holds its own the same way,
  ``tests/test_physics_pusht.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import np_of

from sim_a_splat_tpu.envs import keypoints as jkp
from sim_a_splat_tpu.envs import render2d as jr2d
from sim_a_splat_tpu.envs.pusht_envs import PushTEnvF as JEnv
from sim_a_splat_tpu.physics import planar as jplanar
from sim_a_splat_tpu.physics import pusht as jpusht

from sim_a_splat_torch.envs import keypoints as kp
from sim_a_splat_torch.envs import render2d
from sim_a_splat_torch.envs.pusht_envs import PushTEnvF
from sim_a_splat_torch.physics import planar
from sim_a_splat_torch.physics import pusht

EDGE_PIXELS = 4
JP, P = jpusht.PushTParams(), pusht.PushTParams()
GOAL = np.asarray([P.goal_x, P.goal_y, P.goal_theta], np.float32)
# reset vectors: a push of the stem, the block at the goal, a push of the
# crossbar, the block against a wall
RESETS = np.asarray([[100, 120, 160, 300, 0.7], [149, 256, 149, 256, np.pi / 4],
                     [60, 60, 200, 300, 0.5], [230, 80, 150, 200, -1.0]],
                    np.float32)


def _quad(c, a, w, h):
    v = np.asarray([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
    R = np.asarray([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    return (v @ R.T + c).astype(np.float32)


def _clip_cases(kind, rng):
    """(poly, clip) pairs (K, 4, 2) of one kind."""
    if kind == "random":
        def q():
            return _quad(rng.uniform(-5, 5, 2), rng.uniform(0, 6),
                         rng.uniform(1, 8), rng.uniform(1, 8))
        pairs = [(q(), q()) for _ in range(64)]
    else:
        base = _quad([0.0, 0.0], 0.3, 4.0, 2.0)
        R = np.asarray([[np.cos(0.3), -np.sin(0.3)],
                        [np.sin(0.3), np.cos(0.3)]])
        shift = {"shared_edge": R @ [4.0, 0.0], "disjoint": [100.0, 0.0],
                 "identical": [0.0, 0.0]}
        if kind == "vertex_on_plane":
            pairs = [(base, _quad([2.0, 1.0], np.pi / 4, 2.0, 2.0)),
                     (base, _quad(R @ [2.0, 0.0], 0.3 + np.pi / 4, 2.0, 2.0))]
        elif kind == "contained":
            pairs = [(base, _quad([0.0, 0.0], 0.3, 8.0, 8.0))]
        else:
            pairs = [(base, (base + shift[kind]).astype(np.float32))]
    return (np.stack([p for p, _ in pairs]),
            np.stack([c for _, c in pairs]))


@pytest.mark.parametrize("kind", ["random", "shared_edge", "vertex_on_plane",
                                  "disjoint", "identical", "contained"])
def test_convex_clip_area_matches_reference(kind):
    poly, clip = _clip_cases(kind, np.random.default_rng(0))
    want = np.asarray(jax.jit(jax.vmap(jplanar.convex_clip_area))(
        jnp.asarray(poly), jnp.asarray(clip)))
    got = planar.convex_clip_area(torch.as_tensor(poly),
                                  torch.as_tensor(clip))
    np.testing.assert_allclose(np_of(got), want, atol=1e-5, rtol=0)


def _states(kind, rng):
    """(B, 7 fields) numpy pushT states of one kind (not settled, so the
    block sits exactly where it is put)."""
    c, s = np.cos(GOAL[2]), np.sin(GOAL[2])
    along = {"full": [0.0, 0.0], "shared_edge": [120.0, 0.0],
             "disjoint": [0.0, 200.0]}
    if kind == "random":
        B = 16
        blocks = np.stack([rng.uniform(100, 200, B), rng.uniform(150, 350, B),
                           rng.uniform(-np.pi, np.pi, B)], 1)
    elif kind == "vertex_on_plane":
        blocks = np.asarray([[GOAL[0], GOAL[1], GOAL[2] + np.pi / 2],
                             [GOAL[0] + 60 * c, GOAL[1] + 60 * s,
                              GOAL[2] + np.pi]])
    else:
        dx, dy = along[kind]
        blocks = np.asarray([[GOAL[0] + c * dx - s * dy,
                              GOAL[1] + s * dx + c * dy, GOAL[2]]])
    B = len(blocks)
    z2 = np.zeros((B, 2), np.float32)
    return dict(agent_pos=np.tile([[20.0, 20.0]], (B, 1)), agent_vel=z2,
                block_pos=blocks[:, :2], block_angle=blocks[:, 2],
                block_vel=z2, block_omega=np.zeros(B),
                n_contacts=np.zeros(B))


def _jstate(d):
    return jpusht.PushTState(*(jnp.asarray(np.asarray(d[k], np.float32))
                               for k in jpusht.PushTState._fields))


@pytest.mark.parametrize("kind", ["random", "full", "shared_edge",
                                  "vertex_on_plane", "disjoint"])
def test_coverage_reward_obs_match_reference(kind):
    d = _states(kind, np.random.default_rng(1))
    js = _jstate(d)
    st = pusht.state_from_numpy(d, device="cpu")
    cov = np.asarray(jax.vmap(lambda s: jpusht.coverage(JP, s))(js))
    rew, done = jax.vmap(lambda s: jpusht.reward_done(JP, s))(js)
    np.testing.assert_allclose(np_of(pusht.coverage(P, st)), cov, atol=1e-5,
                               rtol=0)
    r, dn = pusht.reward_done(P, st)
    np.testing.assert_allclose(np_of(r), np.asarray(rew), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(np_of(dn), np.asarray(done))
    np.testing.assert_allclose(np_of(pusht.get_obs(st)),
                               np.asarray(jax.vmap(jpusht.get_obs)(js)),
                               atol=1e-5, rtol=0)
    if kind == "full":
        assert np_of(dn).all() and np_of(r).min() == 1.0
    if kind == "disjoint":
        assert np_of(r).max() == 0.0


def test_goal_area_is_the_goal_ts_area():
    """The port's goal area is the T's, 3,600 + 2,700, as the reference's
    unjitted self-clip of the goal boxes gives it."""
    _, area = pusht._goal(P, torch.device("cpu"))
    goal = jpusht.block_polys_world(JP, jnp.asarray(GOAL[:2]),
                                    jnp.asarray(GOAL[2]))
    want = sum(float(jplanar.convex_clip_area(goal[j], goal[j]))
               for j in range(2))
    assert abs(float(area) - 6300.0) < 1e-2 and abs(want - 6300.0) < 1e-2
    np.testing.assert_array_equal(pusht.tee_cog_local(),
                                  jpusht.tee_cog_local())


def test_keypoint_map_and_global_keypoints():
    for args in [dict(), dict(n_block_kps=5, n_agent_kps=2, seed=3),
                 dict(jitter=0.0)]:
        want = jkp.default_keypoint_map(JP, **args)
        got = kp.default_keypoint_map(P, **args)
        for k in ("block", "agent"):
            np.testing.assert_array_equal(got[k], want[k])
    rng = np.random.default_rng(2)
    local = kp.default_keypoint_map(P)["block"]
    pos = rng.uniform(50, 450, (8, 2)).astype(np.float32)
    ang = rng.uniform(-7, 7, 8).astype(np.float32)
    want = jax.vmap(lambda p, a: jkp.keypoints_global(jnp.asarray(local), p,
                                                      a))(
        jnp.asarray(pos), jnp.asarray(ang))
    got = kp.keypoints_global(torch.as_tensor(local), torch.as_tensor(pos),
                              torch.as_tensor(ang))
    np.testing.assert_allclose(np_of(got), np.asarray(want), atol=1e-4,
                               rtol=0)


def _pixels_differing(got, want):
    return int(np.any(np.abs(np_of(got) - np.asarray(want)) > 1e-6,
                      axis=-1).sum())


@pytest.mark.parametrize("rs,with_action", [(96, False), (96, True),
                                            (64, True)])
def test_render_frame_matches_reference(rs, with_action):
    d = _states("random", np.random.default_rng(3))
    d["agent_pos"] = np.random.default_rng(4).uniform(30, 270, (16, 2))
    js = _jstate(d)
    st = pusht.state_from_numpy(d, device="cpu")
    act = np.random.default_rng(5).uniform(0, 512, (16, 2)).astype(np.float32)
    if with_action:
        want = jax.vmap(lambda s, a: jr2d.render_frame(JP, s, rs, action=a))(
            js, jnp.asarray(act))
    else:
        want = jax.vmap(lambda s: jr2d.render_frame(JP, s, rs))(js)
    got = render2d.render_frame(P, st, rs, action=torch.as_tensor(act)
                                if with_action else None)
    assert got.shape == (16, rs, rs, 3)
    assert _pixels_differing(got, want) <= EDGE_PIXELS
    if with_action:     # the marker is drawn
        red = (np_of(got)[..., 0] > 0.9) & (np_of(got)[..., 1] < 0.2)
        assert red.sum() > 0


def test_keypoint_overlay_matches_reference():
    d = _states("random", np.random.default_rng(6))
    js = _jstate(d)
    st = pusht.state_from_numpy(d, device="cpu")
    rng = np.random.default_rng(7)
    kps = rng.uniform(0, 500, (16, 9, 2)).astype(np.float32)
    vis = rng.uniform(size=(16, 9)) < 0.6
    img = jax.vmap(lambda s: jr2d.render_frame(JP, s, 96))(js)
    want = jax.vmap(lambda i, k, v: jr2d.keypoint_overlay(i, k, v, JP))(
        img, jnp.asarray(kps), jnp.asarray(vis))
    got = render2d.keypoint_overlay(render2d.render_frame(P, st, 96),
                                    torch.as_tensor(kps),
                                    torch.as_tensor(vis), P)
    assert _pixels_differing(got, want) <= 2 * EDGE_PIXELS


@pytest.mark.parametrize("mode,agent_kps,legacy", [
    ("state", False, False), ("keypoints", False, True),
    ("keypoints", True, False), ("image", False, False)])
def test_rollout_matches_reference(mode, agent_kps, legacy):
    """20 steps from one ``reset_to_state`` per env: states, observations,
    reward, done and info against the jitted ``jax.vmap`` of the
    reference's step (its reward and done unjitted, on its states)."""
    R = 20
    rng = np.random.default_rng(8)
    acts = (RESETS[None, :, 2:4]
            + rng.normal(0, 30, (R, len(RESETS), 2))).astype(np.float32)
    kw = dict(obs_mode=mode, agent_keypoints=agent_kps, legacy=legacy)
    jenv, env = JEnv(**kw), PushTEnvF(device="cpu", **kw)
    js, jobs = jax.vmap(lambda v: jenv.reset(jax.random.key(0), v))(
        jnp.asarray(RESETS))
    st, obs = env.reset(reset_to_state=RESETS)
    jstep = jax.jit(jax.vmap(jenv.step))
    jstates, rewards, dones = [], [], []
    for r in range(R + 1):
        if mode == "image":
            assert _pixels_differing(obs["image"].permute(0, 2, 3, 1),
                                     jnp.moveaxis(jobs["image"], 1, -1)) \
                <= EDGE_PIXELS
            np.testing.assert_allclose(np_of(obs["agent_pos"]),
                                       np.asarray(jobs["agent_pos"]),
                                       atol=1e-3, rtol=0)
        else:
            np.testing.assert_allclose(np_of(obs), np.asarray(jobs),
                                       atol=1e-3, rtol=0)
        for k in pusht.PushTState._fields:
            np.testing.assert_allclose(
                np_of(getattr(st, k)), np.asarray(getattr(js, k)), atol=1e-3,
                rtol=1e-4 if k in ("block_vel", "block_omega") else 0,
                err_msg=f"{k}, step {r}")
        if r == R:
            break
        jt = jstep(js, jnp.asarray(acts[r]))
        tr = env.step(st, torch.as_tensor(acts[r]))
        for k, v in tr.info.items():
            np.testing.assert_allclose(np_of(v), np.asarray(jt.info[k]),
                                       atol=1e-3, rtol=0, err_msg=k)
        js, jobs, st, obs = jt.state, jt.obs, tr.state, tr.obs
        jstates.append(js)
        rewards.append(np_of(tr.reward))
        dones.append(np_of(tr.done))
    allj = jax.tree.map(lambda *a: jnp.concatenate(a), *jstates)
    rew, done = jax.vmap(lambda s: jpusht.reward_done(JP, s))(allj)
    np.testing.assert_allclose(np.concatenate(rewards), np.asarray(rew),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(np.concatenate(dones), np.asarray(done))
    assert np.concatenate(rewards).max() > 0.5     # the goal env is covered


def test_keypoint_visibility():
    """Rate 1: every slot visible; rate 0.5: some slot hidden, the agent's
    position always visible (the reference's contract)."""
    env = PushTEnvF(obs_mode="keypoints", device="cpu")
    _, obs = env.reset(torch.Generator().manual_seed(0), batch=8)
    assert obs.shape == (8, 40) and bool((obs[:, 20:] == 1.0).all())
    drop = PushTEnvF(obs_mode="keypoints", keypoint_visible_rate=0.5,
                     device="cpu")
    _, obs = drop.reset(torch.Generator().manual_seed(3), batch=8)
    assert float(obs[:, 20:].min()) == 0.0
    assert bool((obs[:, 38:40] == 1.0).all())
    assert env.obs_dim == 40 and PushTEnvF(obs_mode="state").obs_dim == 5


def test_reset_draws_the_reference_distribution():
    env = PushTEnvF(device="cpu")
    st, obs = env.reset(torch.Generator().manual_seed(1), batch=64)
    assert obs.shape == (64, 5)
    a, b = np_of(st.agent_pos), np_of(st.block_pos)
    assert (a >= 49).all() and (a[:, 0] <= 249).all() and (a[:, 1] <= 463).all()
    assert (b >= 99).all() and (b[:, 0] <= 199).all() and (b[:, 1] <= 413).all()
    with pytest.raises(ValueError):
        env.reset()
    with pytest.raises(RuntimeError, match="cuda"):
        PushTEnvF().reset(reset_to_state=RESETS[0])


def test_reward_gradient_through_a_control_step_is_finite():
    st = pusht.set_state(P, torch.tensor([[80.0, 310.0, 149.0, 256.0, 0.0]]))
    action = torch.tensor([[140.0, 310.0]], requires_grad=True)
    r, _ = pusht.reward_done(P, pusht.control_step(P, st, action))
    (g,) = torch.autograd.grad(r.sum(), action)
    assert bool(torch.isfinite(g).all())
    assert float(r.detach()) > 0.0
