"""The port's Gymnasium adapters against the JAX reference's, on the CPU:
the three pushT envs (spaces, observations, reward, done, info and the
uint8 frame), the port's registration, the goal-relative set-state, the
manipulator env and its task-space wrapper over 20 steps, the IK failure,
``resolve_urdf``, and the other robot families.

Each adapter is one env (B = 1), the port's on ``device="cpu"``.  Both run
from ``reset_to_state``: a seed draws other numbers from a
``torch.Generator`` than from ``jax.random``.

Tolerances, and why:
- pushT: observations, info and states atol 1e-3, the block's velocity
  also rtol 1e-4 (``test_torch_pusht_envs.py``'s rollout bounds); the
  reward atol 1e-5 against the reference's unjitted ``reward_done`` on the
  reference adapter's own state (its jitted step folds the goal's area to
  4,950, not 6,300: ``ROADMAP.md`` §3), done exact; frames equal but for
  at most 4 pixels on shape edges;
- the manipulator env and its wrapper: as ``test_torch_arm.py`` holds the
  functional env (joints and Jacobian velocities atol 1e-5, the block's
  pose atol 1e-4, its velocity atol 1e-3, rewards atol 2e-4; IK's joints
  atol 1e-3, its end-effector pose atol 1e-4).
"""

from pathlib import Path

import numpy as np
import pytest

import gymnasium
import jax.numpy as jnp

from sim_a_splat_tpu.envs import gym_adapter as jgym
from sim_a_splat_tpu.envs import manipulator_gym as jmgym
from sim_a_splat_tpu.physics import pusht as jpusht

from sim_a_splat_torch.envs import (
    gym_adapter, manipulator_gym, single_env, splat_gym,
)

REPO = Path(__file__).resolve().parent.parent
DESC = REPO / "robot_description"
VEC = [100.0, 120.0, 160.0, 300.0, 0.7]
NEAR_GOAL = [80.0, 300.0, 140.0, 250.0, 0.6]


def _close(got, want, atol, rtol=0.0, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], atol, rtol, f"{what}/{k}")
        return
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


def _reference_reward(ref):
    r, d = jpusht.reward_done(ref.env_f._params(), ref._state)
    return float(r), bool(d)


@pytest.mark.parametrize("cls", ["PushTEnv", "PushTKeypointsEnv",
                                 "PushTImageEnv"])
def test_pusht_adapter_matches_reference(cls):
    kw = {} if cls == "PushTImageEnv" else {"reset_to_state": NEAR_GOAL}
    ref = getattr(jgym, cls)(seed=0, **kw)
    env = getattr(gym_adapter, cls)(seed=0, device="cpu", **kw)
    assert env.observation_space == ref.observation_space
    assert env.action_space == ref.action_space
    if cls == "PushTImageEnv":         # no reset_to_state argument
        ref.reset_to_state = env.reset_to_state = NEAR_GOAL
    _close(env.reset(), ref.reset(), 1e-3, what="reset")
    rng = np.random.default_rng(0)
    for i in range(5):
        act = np.asarray(NEAR_GOAL[2:4]) + rng.normal(0, 20, 2)
        obs, rew, done, info = env.step(act)
        robs, _, _, rinfo = ref.step(act)
        assert env.observation_space.contains(obs)
        _close(obs, robs, 1e-3, what=f"obs {i}")
        _close(info, rinfo, 1e-3, 1e-4, what=f"info {i}")
        want_r, want_d = _reference_reward(ref)
        assert isinstance(rew, float) and isinstance(done, bool)
        assert abs(rew - want_r) <= 1e-5 and done == want_d
    assert rew > 0.1                   # the block overlaps the goal
    img, rimg = env.render("rgb_array"), ref.render("rgb_array")
    assert img.dtype == np.uint8 and img.shape == rimg.shape == (96, 96, 3)
    assert int(np.any(img != rimg, axis=-1).sum()) <= 4
    _close(env._get_info(), ref._get_info(), 1e-3, 1e-4, what="_get_info")


def test_set_state_local_matches_reference():
    ref = jgym.PushTEnv(seed=0, reset_to_state=VEC)
    env = gym_adapter.PushTEnv(seed=0, reset_to_state=VEC, device="cpu")
    ref.reset()
    env.reset()
    for local in ([0.0] * 5, [10.0, 0.0, 5.0, 0.0, 0.1]):
        np.testing.assert_allclose(env._set_state_local(local),
                                   ref._set_state_local(local), atol=1e-9)
        _close(env._get_obs(), ref._get_obs(), 1e-3)
    np.testing.assert_array_equal(env.goal_pose, ref.goal_pose)
    env._set_state_local([0.0] * 5)
    _, reward, done, _ = env.step(env.goal_pose[:2] - [0.0, 60.0])
    assert reward > 0.9


def test_keypoints_adapter_dropout_and_params():
    env = gym_adapter.PushTKeypointsEnv(keypoint_visible_rate=0.5, seed=3,
                                        device="cpu")
    masks = [env.reset()[20:] for _ in range(8)]
    assert any(m.min() == 0.0 for m in masks)
    assert all(m[18:20].min() == 1.0 for m in masks)
    p = gym_adapter.PushTKeypointsEnv.genenerate_keypoint_manager_params()
    rp = jgym.PushTKeypointsEnv.genenerate_keypoint_manager_params()
    for k in ("block", "agent"):
        np.testing.assert_array_equal(p["local_keypoint_map"][k],
                                      rp["local_keypoint_map"][k])


def test_register_envs_and_make():
    gym_adapter.register_envs()
    gym_adapter.register_envs()                      # idempotent
    spec = gymnasium.spec(gym_adapter.ENV_ID)
    assert spec.entry_point.startswith("sim_a_splat_torch.")
    env = gymnasium.make(gym_adapter.ENV_ID, device="cpu")
    assert env.spec.max_episode_steps == 200
    env.unwrapped.seed(0)
    assert env.unwrapped.reset().shape == (40,)
    if "pusht-keypoints-v0" in gymnasium.registry:    # the reference's stays
        assert gymnasium.spec("pusht-keypoints-v0").entry_point.startswith(
            "sim_a_splat_tpu.")
    with pytest.raises(RuntimeError, match="cuda"):
        gym_adapter.PushTEnv()                        # device="cuda" default


def test_gym_classes_are_the_single_env_shells():
    """Each Gym class is the gym-free shell the example drivers use plus
    its spaces: it defines no method but ``__init__``, so the two cannot
    drift apart."""
    for gym_cls, shell, base in (
            (gym_adapter.PushTEnv, single_env.PushTSingleEnv, gymnasium.Env),
            (gym_adapter.PushTKeypointsEnv, single_env.PushTSingleEnv,
             gymnasium.Env),
            (manipulator_gym.ManipulatorSimEnv,
             single_env.ManipulatorSingleEnv, gymnasium.Env),
            (manipulator_gym.ManipulatorEEFWrapper,
             single_env.ManipulatorEEFSingleEnv, gymnasium.Wrapper),
            (splat_gym.SplatEnvWrapper, single_env.SplatSingleEnv,
             gymnasium.Wrapper)):
        assert issubclass(gym_cls, shell) and issubclass(gym_cls, base)
        for cls in gym_cls.__mro__[:gym_cls.__mro__.index(shell)]:
            own = {n for n, v in vars(cls).items()
                   if callable(v) and not n.startswith("__")}
            assert own <= {"genenerate_keypoint_manager_params"}, (cls, own)
    env = gym_adapter.PushTKeypointsEnv(seed=0, device="cpu")
    assert isinstance(env.unwrapped, gym_adapter.PushTKeypointsEnv)


def _arm(mod, **kw):
    return mod.ManipulatorSimEnv(
        env_objects=True, eef_link_name="push_tool", package_path=str(DESC),
        package_name="pusharm6", urdf_name="pusharm6.urdf", num_dof=6,
        seed=0, **kw)


ARM_ATOL = {"robot_joint_pos": 1e-5, "robot_joint_vel": 1e-4,
            "block_pose": 1e-4, "block_vel": 1e-3}
ARM_RESET = {"robot_pos": np.asarray([0.0, 0.5, 0.6, 0.0, 0.8, 0.0]),
             "block_pos": np.asarray([0.45, 0.02, 0.2, 0.3]),
             "goal_pos": np.asarray([0.475, 0.0, 0.2, 0.78539816])}


def _dict_close(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        _close(got[k], want[k], ARM_ATOL.get(k, 1e-5), what=f"{what}/{k}")


def test_manipulator_sim_env_matches_reference():
    ref, env = _arm(jmgym), _arm(manipulator_gym, device="cpu")
    assert env.observation_space == ref.observation_space
    assert env.action_space == ref.action_space
    _dict_close(env.reset(reset_to_state=ARM_RESET),
                ref.reset(reset_to_state=ARM_RESET), "reset")
    rng = np.random.default_rng(1)
    q = ARM_RESET["robot_pos"].astype(np.float32)
    for i in range(20):
        q = q + rng.normal(0, 0.03, 6).astype(np.float32)
        got, want = env.step(q), ref.step(q)
        _dict_close(got[0], want[0], f"obs {i}")
        assert abs(got[1] - want[1]) <= 2e-4
        assert got[2:4] == want[2:4]
        _dict_close(got[4], want[4], f"info {i}")
    draw, rdraw = env._generate_draw_msg(), ref._generate_draw_msg()
    np.testing.assert_allclose(draw.poses.t.numpy(), np.asarray(rdraw.poses.t),
                               atol=1e-4)
    assert env._generate_loader_msg().names == ref._generate_loader_msg().names
    assert abs(env.get_simulation_time() - ref.get_simulation_time()) < 1e-6
    _dict_close(env._get_info(), ref._get_info(), "_get_info")


def test_eef_wrapper_matches_reference():
    ref = jmgym.ManipulatorEEFWrapper(_arm(jmgym))
    env = manipulator_gym.ManipulatorEEFWrapper(_arm(manipulator_gym,
                                                     device="cpu"))
    assert env.observation_space == ref.observation_space
    assert env.action_space == ref.action_space
    reset = dict(ARM_RESET, robot_pos=np.asarray([0.0, -0.3, -0.5, 0.0, 0.6,
                                                  0.0]))
    obs, robs = env.reset(reset_to_state=reset), ref.reset(
        reset_to_state=reset)
    _dict_close(obs, robs, "reset")
    from sim_a_splat_tpu.ops import quaternion as jq
    rpy = np.asarray(jq.to_rpy(jnp.asarray(robs["eef_quat"])))
    start = np.asarray(robs["eef_pos"])
    for i in range(20):
        act = {"eef_pos": start + [0.0, 0.0, -0.0005 * (i + 1)],
               "eef_ori": rpy}
        got, want = env.step(act), ref.step(act)
        for k in want[0]:
            _close(got[0][k], want[0][k], 1e-4, what=f"obs {i}/{k}")
        assert abs(got[1] - want[1]) <= 2e-4 and got[2:4] == want[2:4]
        _close(got[4]["robot_joint_pos"], want[4]["robot_joint_pos"], 1e-3,
               what=f"q {i}")
        assert bool(got[4]["ik_converged"]) and bool(want[4]["ik_converged"])
    q = env.eefpose2config(np.concatenate([start, rpy]))
    assert q.shape == (6,) and np.isfinite(q).all()


def test_ik_failure_raises():
    env = manipulator_gym.ManipulatorEEFWrapper(_arm(manipulator_gym,
                                                     device="cpu"))
    env.reset(reset_to_state=ARM_RESET)
    far = {"eef_pos": np.asarray([3.0, 3.0, 3.0]), "eef_ori": np.zeros(3)}
    with pytest.raises(RuntimeError, match="Inverse kinematics failed"):
        env.step(far)
    with pytest.raises(RuntimeError, match="Inverse kinematics failed"):
        env.eefpose2config(np.asarray([3.0, 3.0, 3.0, 0.0, 0.0, 0.0]))


def test_resolve_urdf_and_weld():
    for pkg in ("pusharm6", "pusharm5", "pushscara3"):
        assert manipulator_gym.resolve_urdf(DESC, pkg, f"{pkg}.urdf") == \
            jmgym.resolve_urdf(DESC, pkg, f"{pkg}.urdf")
    with pytest.raises(FileNotFoundError):
        manipulator_gym.resolve_urdf(DESC, "pusharm6", "missing.urdf")
    with pytest.raises(ValueError, match="dof"):
        manipulator_gym.ManipulatorSimEnv(
            eef_link_name="push_tool", package_path=str(DESC),
            package_name="pusharm6", urdf_name="pusharm6.urdf", num_dof=5,
            device="cpu")
    m = np.eye(4)
    m[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    m[:3, 3] = [0.65, -1.23, 0.42]
    for w in (m, ((0.0, 0.0, 0.0, 1.0), (0.1, 0.2, 0.3))):
        got = _arm(manipulator_gym, weld_frame_transform=w,
                   device="cpu").env_f.weld
        want = _arm(jmgym, weld_frame_transform=w).env_f.weld
        np.testing.assert_allclose(np.concatenate(got),
                                   np.concatenate(want), atol=1e-6)


@pytest.mark.parametrize("pkg,urdf,ndof,target", [
    ("pushscara3", "pushscara3.urdf", 3, [0.2, 0.2, 0.08]),
    ("pusharm5", "pusharm5.urdf", 5, [0.2] * 5),
])
def test_robot_families_run(pkg, urdf, ndof, target):
    env = manipulator_gym.ManipulatorSimEnv(
        env_objects=True, eef_link_name="push_tool", package_path=str(DESC),
        package_name=pkg, urdf_name=urdf, num_dof=ndof, device="cpu")
    obs = env.reset(reset_to_state={"robot_pos": [0.0] * ndof,
                                    "block_pos": [0.3, 0.0, 0.0, 0.0],
                                    "goal_pos": [0.4, 0.1, 0.0, 0.0]})
    assert obs["robot_joint_pos"].shape == (ndof,)
    target = np.asarray(target, np.float32)
    for _ in range(30):
        obs, reward, terminated, truncated, info = env.step(target)
    np.testing.assert_allclose(obs["robot_joint_pos"], target, atol=0.05)
    assert np.isfinite(reward)
    draw = env._generate_draw_msg()
    assert draw.poses.q.shape[0] == len(env.env_f.schema().links)
    env.close()
