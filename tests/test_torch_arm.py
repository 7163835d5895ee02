"""The port's arm against the JAX reference, on the CPU: the URDF parse,
FK, the orientation error, IK, the PD loop, the manipulator env and its
task-space wrapper.

Each test runs numpy inputs made from a seed through the reference (its
single-env functions under ``jax.vmap``) and through the port's batched
functions with ``device="cpu"``.

Tolerances, and why:
- ``load_chain``: every field exact (the same parse of the same file);
- ``fk``, ``link_pose``, ``orientation_error`` and its gradient: atol 1e-5
  (float32 quaternion products in the same order);
- ``ik``: the same ``converged`` flags, q within 1e-3 and the final errors
  within 1e-4 (60 damped Gauss-Newton steps, each a 6×6 solve whose
  rounding differs between the two linear-algebra libraries); a
  reachable target's errors within the reference's own tolerances;
- ``arm_step``: atol 1e-5 (the same elementwise operations);
- the env over 10 steps with the end effector in the block: joints atol
  1e-5, the block's position and yaw atol 1e-4, its velocities atol 1e-3
  (0.2 % of their 0.3-5 m/s: the clamps of ten float32 PGS iterations per
  substep switch on last-bit differences of the impulses), the Jacobian
  velocities atol 1e-5 (J·q̇ by a forward-mode derivative against the
  reference's Jacobian times q̇), the block's pose in ``info`` atol 1e-4,
  rewards atol 2e-4 (the sum of the block's distance and yaw errors),
  ``terminated`` exact; ``draw_state`` atol 1e-4 (its last row is the
  block's pose).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import manipulator_leaves, np_of

from sim_a_splat_tpu.envs.eef_wrapper import ManipulatorEEFWrapperF as JEEF
from sim_a_splat_tpu.envs.manipulator_envs import ManipulatorEnvF as JEnv
from sim_a_splat_tpu.ops import quaternion as jq
from sim_a_splat_tpu.ops.transforms import SE3 as JSE3
from sim_a_splat_tpu.physics import kinematics as jk

from sim_a_splat_torch.envs.eef_wrapper import ManipulatorEEFWrapperF
from sim_a_splat_torch.envs.manipulator_envs import (
    ManipulatorEnvF, state_from_numpy,
)
from sim_a_splat_torch.ops import quaternion as tq
from sim_a_splat_torch.ops.transforms import SE3
from sim_a_splat_torch.physics import kinematics as tk

REPO = Path(__file__).resolve().parent.parent
URDFS = {
    "planar2": Path(__file__).parent / "assets" / "planar2.urdf",
    **{n: REPO / "robot_description" / n / "urdf" / f"{n}.urdf"
       for n in ("pusharm5", "pusharm6", "pushscara3")},
}
EEF = {"planar2": "tool", "pusharm5": "push_tool", "pusharm6": "push_tool",
       "pushscara3": "push_tool"}
INFO_ATOL = {"block_vel": 1e-3, "block_pose": 1e-4}
WELD = ((0.9659258, 0.0, 0.0, 0.2588190), (0.1, -0.2, 0.05))
B = 3


def t32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def chains(name):
    return jk.load_chain(URDFS[name]), tk.load_chain(URDFS[name])


def assert_states_close(ts, js, block_atol=1e-4, vel_atol=1e-3):
    for name, a, b in zip(("q", "qd", "target_prev"), ts.arm, js.arm):
        np.testing.assert_allclose(np_of(a), np_of(b), atol=1e-5,
                                   err_msg=name)
    for name, atol in (("block_pos", block_atol), ("block_yaw", block_atol),
                       ("block_vel", vel_atol), ("block_omega", vel_atol)):
        np.testing.assert_allclose(np_of(getattr(ts, name)),
                                   np_of(getattr(js, name)), atol=atol,
                                   err_msg=name)
    for name in ("goal", "prev_eef_xy", "t"):
        np.testing.assert_allclose(np_of(getattr(ts, name)),
                                   np_of(getattr(js, name)), atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("name", sorted(URDFS))
def test_load_chain_matches_reference(name):
    jc, tc = chains(name)
    for f in ("link_names", "joint_names"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert [v and dataclass_tuple(v) for v in tc.visuals] == \
        [v and dataclass_tuple(v) for v in jc.visuals]
    for f in ("parent", "jtype", "qidx", "origin_q", "origin_t", "axis",
              "lower", "upper", "velocity_limit", "effort_limit"):
        a, b = getattr(tc, f), getattr(jc, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert tc.actuated_joint_names() == jc.actuated_joint_names()


@pytest.mark.parametrize("name", sorted(URDFS))
@pytest.mark.parametrize("weld", [False, True])
def test_fk_and_link_pose_match_reference(name, weld):
    jc, tc = chains(name)
    rng = np.random.default_rng(1)
    q = rng.uniform(-1.5, 1.5, (4, tc.ndof)).astype(np.float32)
    jbase = JSE3(jnp.asarray(WELD[0]), jnp.asarray(WELD[1])) if weld else None
    tbase = SE3(t32(WELD[0]), t32(WELD[1])) if weld else None
    jp = jax.vmap(lambda x: jk.fk(jc, x, jbase))(jnp.asarray(q))
    tp = tk.fk(tc, t32(q), tbase)
    assert tuple(tp.q.shape) == (4, tc.num_links, 4)
    np.testing.assert_allclose(np_of(tp.q), np_of(jp.q), atol=1e-5)
    np.testing.assert_allclose(np_of(tp.t), np_of(jp.t), atol=1e-5)
    link = EEF[name]
    jl = jax.vmap(lambda x: jk.link_pose(jc, x, link, jbase))(jnp.asarray(q))
    tl = tk.link_pose(tc, t32(q), link, tbase)
    np.testing.assert_allclose(np_of(tl.t), np_of(jl.t), atol=1e-5)
    # one unbatched configuration gives the batch's first row
    t0 = tk.fk(tc, t32(q[0]), tbase)
    np.testing.assert_allclose(np_of(t0.t), np_of(tp.t[0]), atol=0)


def test_orientation_error_matches_reference():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(6, 4)).astype(np.float32)
    b = rng.normal(size=(6, 4)).astype(np.float32)
    b[0] = a[0] / np.linalg.norm(a[0])       # zero error
    b[1] = -b[0]                             # zero error, other sign
    a[1] = b[0]
    want = jax.vmap(jk.orientation_error)(jnp.asarray(a), jnp.asarray(b))
    got = tk.orientation_error(t32(a), t32(b))
    np.testing.assert_allclose(np_of(got), np_of(want), atol=1e-5)
    assert float(np.abs(np_of(got[:2])).max()) < 1e-6

    # the gradient, including at zero error, is finite and the reference's
    ct = rng.normal(size=(6, 3)).astype(np.float32)
    jg = jax.grad(lambda x: jnp.sum(jax.vmap(jk.orientation_error)(
        x, jnp.asarray(b)) * ct))(jnp.asarray(a))
    ta = t32(a).requires_grad_()
    (tg,) = torch.autograd.grad(
        (tk.orientation_error(ta, t32(b)) * t32(ct)).sum(), ta)
    assert np.isfinite(np_of(tg)).all()
    np.testing.assert_allclose(np_of(tg), np_of(jg), atol=1e-5)


def test_quaternion_arm_functions_match_reference():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(8, 4)).astype(np.float32)
    q[0] = [1.0, 0, 0, 0]
    q[1] = [-0.5, 0.5, 0.5, 0.5]
    aa = rng.normal(size=(8, 3)).astype(np.float32)
    aa[0] = 0.0
    aa[1] = [1e-8, 0.0, 0.0]
    rpy = rng.uniform(-3, 3, (8, 3)).astype(np.float32)
    for jf, tf, x in ((jq.to_angle_axis, tq.to_angle_axis, q),
                      (jq.from_angle_axis, tq.from_angle_axis, aa),
                      (jq.angle_axis_to_rotation_matrix,
                       tq.angle_axis_to_rotation_matrix, aa),
                      (jq.from_rpy, tq.from_rpy, rpy),
                      (jq.to_rpy, tq.to_rpy, q)):
        np.testing.assert_allclose(np_of(tf(t32(x))),
                                   np_of(jf(jnp.asarray(x))), atol=2e-6,
                                   err_msg=tf.__name__)


@pytest.mark.parametrize("case", ["planar2", "pusharm6", "unreachable"])
def test_ik_matches_reference(case):
    name = "planar2" if case != "pusharm6" else "pusharm6"
    jc, tc = chains(name)
    link = EEF[name]
    rng = np.random.default_rng(4)
    q_true = rng.uniform(-0.8, 0.8, (B, tc.ndof)).astype(np.float32)
    q0 = (q_true + 0.2 * rng.normal(size=q_true.shape)).astype(np.float32)
    kw = dict(ori_weight=0.2) if name == "planar2" else {}
    target = jax.vmap(lambda x: jk.link_pose(jc, x, link))(jnp.asarray(q_true))
    if case == "unreachable":
        target = target._replace(t=jnp.asarray([[5.0, 0.0, 0.1]] * B))
    jres = jax.jit(jax.vmap(lambda t, q: jk.ik(jc, link, t, q, **kw)))(
        target, jnp.asarray(q0))
    tres = tk.ik(tc, link, SE3(t32(np_of(target.q)), t32(np_of(target.t))),
                 t32(q0), **kw)
    np.testing.assert_array_equal(np_of(tres.converged),
                                  np_of(jres.converged))
    assert np_of(jres.converged).all() == (case != "unreachable")
    np.testing.assert_allclose(np_of(tres.q), np_of(jres.q), atol=1e-3)
    for f in ("pos_err", "ori_err"):
        np.testing.assert_allclose(np_of(getattr(tres, f)),
                                   np_of(getattr(jres, f)), atol=1e-4,
                                   err_msg=f)


def test_arm_step_matches_reference():
    jc, tc = chains("pusharm6")
    rng = np.random.default_rng(5)
    q = rng.uniform(-1, 1, (B, 6)).astype(np.float32)
    # joint 1's target past its velocity limit and joint 2's past its stop
    targets = (q + rng.normal(0, 0.3, (5, B, 6))).astype(np.float32)
    targets[:, :, 1] = 4.0
    js = jax.vmap(lambda x: jk.arm_init(jc, x))(jnp.asarray(q))
    ts = tk.arm_init(tc, t32(q))
    for tgt in targets:
        js = jax.vmap(lambda s, t: jk.arm_step(jc, s, t))(js, jnp.asarray(tgt))
        ts = tk.arm_step(tc, ts, t32(tgt))
        for a, b in zip(ts, js):
            np.testing.assert_allclose(np_of(a), np_of(b), atol=1e-5)
    assert float(np.abs(np_of(ts.qd[:, 1])).max()) == pytest.approx(3.14)


def _block_on_eef(jenv, q):
    """A reset whose block crossbar the end effector already penetrates
    (the block 0.03 m beyond the EEF in y), so the contact solve acts from
    the first step."""
    eef = jk.link_pose(jenv.chain, jnp.asarray(q), jenv.eef_link,
                       jenv._base())
    x, y = np_of(eef.t)[:2]
    return {"robot_pos": q, "block_pos": np.array([x, y + 0.03, 0.2, 0.1]),
            "goal_pos": np.array([0.5, 0.05, 0.2, 0.5])}


@pytest.mark.parametrize("env_objects", [True, False])
@pytest.mark.parametrize("name", ["pusharm6", "planar2"])
def test_env_matches_reference(name, env_objects):
    jc, tc = chains(name)
    jenv = JEnv(chain=jc, eef_link=EEF[name], env_objects=env_objects)
    tenv = ManipulatorEnvF(chain=tc, eef_link=EEF[name],
                           env_objects=env_objects, device="cpu")
    rng = np.random.default_rng(6)
    q0 = rng.uniform(-0.5, 0.5, tc.ndof).astype(np.float32)
    reset = _block_on_eef(jenv, q0)
    js, jobs = jax.vmap(lambda k: jenv.reset(k, reset))(
        jax.random.split(jax.random.key(0), B))
    ts, tobs = tenv.reset(reset_to_state=reset, batch=B)
    assert_states_close(ts, js)
    for k in jobs:
        np.testing.assert_allclose(np_of(tobs[k]), np_of(jobs[k]), atol=1e-6)

    # joint targets sweeping the end effector through the block
    actions = (q0 + np.cumsum(rng.normal(0, 0.05, (10, B, tc.ndof)), 0)
               ).astype(np.float32)
    jstep = jax.jit(jax.vmap(jenv.step))
    moved = 0.0
    for a in actions:
        jtr = jstep(js, jnp.asarray(a))
        ttr = tenv.step(ts, t32(a))
        js, ts = jtr.state, ttr.state
        assert_states_close(ts, js)
        np.testing.assert_allclose(np_of(ttr.reward), np_of(jtr.reward),
                                   atol=2e-4)
        np.testing.assert_array_equal(np_of(ttr.terminated),
                                      np_of(jtr.terminated))
        assert not np_of(ttr.truncated).any()
        assert set(ttr.info) == set(jtr.info)
        for k in jtr.info:
            np.testing.assert_allclose(np_of(ttr.info[k]), np_of(jtr.info[k]),
                                       atol=INFO_ATOL.get(k, 1e-5),
                                       err_msg=k)
        moved = max(moved, float(np.abs(np_of(ttr.state.block_vel)).max()))
    assert (moved > 0) == env_objects          # the block was pushed
    jd = jax.vmap(jenv.draw_state)(js)
    td = tenv.draw_state(ts)
    np.testing.assert_allclose(np_of(td.poses.q), np_of(jd.poses.q),
                               atol=1e-4)
    np.testing.assert_allclose(np_of(td.poses.t), np_of(jd.poses.t),
                               atol=1e-4)
    _same_schema(tenv.schema(), jenv.schema())


def _same_schema(a, b):
    assert len(a.links) == len(b.links)
    for la, lb in zip(a.links, b.links):
        assert (la.name, la.robot_num) == (lb.name, lb.robot_num)
        assert len(la.geoms) == len(lb.geoms)
        for ga, gb in zip(la.geoms, lb.geoms):
            assert dataclass_tuple(ga) == dataclass_tuple(gb)


def dataclass_tuple(g):
    import dataclasses
    return tuple(getattr(g, f.name) for f in dataclasses.fields(g))


def test_env_state_round_trip_and_random_reset():
    jc, tc = chains("pusharm6")
    jenv = JEnv(chain=jc, eef_link="push_tool")
    js, _ = jax.vmap(lambda k: jenv.reset(k))(
        jax.random.split(jax.random.key(1), B))
    ts = state_from_numpy(manipulator_leaves(js), device="cpu")
    assert_states_close(ts, js, block_atol=0, vel_atol=0)
    tenv = ManipulatorEnvF(chain=tc, eef_link="push_tool", device="cpu")
    gen = torch.Generator().manual_seed(0)
    rs, _ = tenv.reset(gen, batch=64)
    q = np_of(rs.arm.q)
    assert q.shape == (64, 6) and (np.abs(q) <= np.pi).all()
    bp = np_of(rs.block_pos)
    assert ((bp[:, 0] >= 0.4) & (bp[:, 0] <= 0.55)).all()
    assert (np.abs(bp[:, 1]) <= 0.183).all()
    assert (np.abs(np_of(rs.block_yaw)) <= np.pi).all()
    np.testing.assert_allclose(np_of(rs.goal[0]),
                               [0.475, 0.0, 0.0, -0.78539816], atol=1e-7)
    with pytest.raises(ValueError, match="generator"):
        tenv.reset(batch=2)


@pytest.mark.parametrize("case", ["reachable", "unreachable"])
def test_eef_wrapper_step_matches_reference(case):
    jc, tc = chains("pusharm6")
    jw = JEEF(env=JEnv(chain=jc, eef_link="push_tool", env_objects=False))
    tw = ManipulatorEEFWrapperF(env=ManipulatorEnvF(
        chain=tc, eef_link="push_tool", env_objects=False, device="cpu"))
    reset = {"robot_pos": np.array([0.0, -0.3, -0.5, 0.0, 0.6, 0.0])}
    js, jobs = jax.vmap(lambda k: jw.reset(k, reset))(
        jax.random.split(jax.random.key(0), 2))
    ts, tobs = tw.reset(reset_to_state=reset, batch=2)
    for k in jobs:
        np.testing.assert_allclose(np_of(tobs[k]), np_of(jobs[k]), atol=1e-5)
    rpy = np_of(jq.to_rpy(jobs["eef_quat"]))
    pos = np_of(jobs["eef_pos"]) + np.array([[0.0, 0.0, -0.01],
                                             [0.01, 0.005, 0.0]])
    if case == "unreachable":
        pos[1] = [3.0, 3.0, 3.0]
    act = {"eef_pos": pos.astype(np.float32),
           "eef_ori": rpy.astype(np.float32)}
    jtr = jax.jit(jax.vmap(jw.step))(js, {k: jnp.asarray(v)
                                          for k, v in act.items()})
    ttr = tw.step(ts, act)
    np.testing.assert_array_equal(np_of(ttr.info["ik_converged"]),
                                  np_of(jtr.info["ik_converged"]))
    assert bool(np_of(ttr.info["ik_converged"])[0])
    assert bool(np_of(ttr.info["ik_converged"])[1]) == (case == "reachable")
    np.testing.assert_allclose(np_of(ttr.state.arm.q), np_of(jtr.state.arm.q),
                               atol=1e-3)
    np.testing.assert_allclose(np_of(ttr.info["ik_pos_err"]),
                               np_of(jtr.info["ik_pos_err"]), atol=1e-4)
    for k in jtr.obs:
        np.testing.assert_allclose(np_of(ttr.obs[k]), np_of(jtr.obs[k]),
                                   atol=1e-3, err_msg=k)
