"""The example drivers on the port (``sim_a_splat_torch/examples``) against
the JAX package's (``examples/``), on the CPU.

Both read the tracked demo asset tree ``examples/assets`` (nothing writes
there).  The reference's demo stack (``examples/common.py::
make_manipulator_splat_env``: the Gym env, its IK wrapper and
``SplatEnvWrapper``) runs in this process on JAX's CPU backend, the port's
(the same stack of the gym-free shells of ``envs/single_env.py``, which the
port's Gym classes are too) with ``device="cpu"``, both with
the demos' two cameras cut to 48 × 64 (IK is ~10 s a task-space step on one
core in either package, so the frame tests take 2-3 steps).

Tolerances, and why:
- ``look_at`` / ``camera_setup``: atol 1e-6 (float32 quaternions from two
  libraries' ``from_rotation_matrix``); the moving camera, sizes and links
  exact;
- the pushT policy's actions and arm targets: exact (the same float64
  numpy on the same inputs); pushT's states and keypoints atol 1e-5 plus
  rtol 1e-6 against the reference env driven with the same actions (they
  are pixel coordinates up to 512, where a float32 ulp is 3e-5 to 6e-5;
  measured 2e-5, one ulp), its reward atol 1e-5 against
  the reference's unjitted ``reward_done`` (its jitted Gym step folds the
  goal's area, ``ROADMAP.md`` §3);
- the slider sweep and the hardware stream's compensation: exact (the
  reference's own loops, driven with a recording env);
- frames: atol 1e-4, the rule of ``test_torch_assets.py::
  test_splat_env_matches_reference`` (float32 projection and compositing
  in two libraries; measured ≤ 5e-6); joints atol 1e-5 and rewards 2e-4 as
  ``test_torch_gym.py`` holds the arm; draw poses atol 1e-5 (float32
  forward kinematics of two libraries).
"""

import importlib
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_helpers import np_of

from sim_a_splat_tpu.envs import gym_adapter as jgym
from sim_a_splat_tpu.ops import quaternion as jquat
from sim_a_splat_tpu.ops.projection import Camera as JCamera
from sim_a_splat_tpu.ops.transforms import SE3 as JSE3
from sim_a_splat_tpu.physics import pusht as jpusht

from sim_a_splat_torch.examples import (
    common, demo_hw_splat, demo_joint_sliders_splat, demo_pusht_splat,
    demo_viewer,
)
from sim_a_splat_torch.viewer import orbit_pose

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "examples"))
rcommon = importlib.import_module("common")
rpusht = importlib.import_module("demo_pusht_splat")
rsliders = importlib.import_module("demo_joint_sliders_splat")
rhw = importlib.import_module("demo_hw_splat")

SIZE = (48, 64)
VEC = [200.0, 300.0, 150.0, 250.0, 0.4]      # pushT [agent, block, angle]
ARM_RESET = {"block_pos": [0.0, 0.0, 0.0, 0.0],
             "goal_pos": [0.0, 0.0, 0.0, 0.0]}


class Recorder:
    """An env that records the actions a demo's loop steps it with."""

    num_dof = 6
    render_cam_keys = []

    def __init__(self):
        self.unwrapped = self
        self.actions = []

    def reset(self, **kw):
        return {}

    def step(self, action, noobs=False):
        self.actions.append(np.array(action, np.float64))
        return None, 0.0, False, False, {}


@pytest.fixture(scope="module")
def ref_joint_env():
    """The reference's joint-space demo stack (shared by the tests that
    reset it themselves)."""
    return rcommon.make_manipulator_splat_env(eef=False, render_size=SIZE)


def _close_frames(got, want, what):
    for k in ("camera_0", "camera_1"):
        assert got[k].shape == (3, *SIZE), (what, k)
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-4,
                                   rtol=0, err_msg=f"{what} {k}")
    np.testing.assert_allclose(got["robot_joint_pos"],
                               want["robot_joint_pos"], atol=1e-5,
                               err_msg=what)
    assert got["camera_0"].max() > 0.05


def test_look_at_and_camera_setup_match_reference():
    for eye, target in (([1.1, -0.9, 0.9], [0.35, 0.0, 0.25]),
                        ([0.9, 0.9, 0.7], [0.35, 0.0, 0.2]),
                        ([-0.4, 0.3, 1.5], [0.0, 0.1, 0.0])):
        for g, w in zip(common.look_at(eye, target),
                        rcommon.look_at(eye, target)):
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64), atol=1e-6)
    got, want = common.camera_setup(SIZE), rcommon.camera_setup(SIZE)
    assert got.keys() == want.keys() == {0, 1}
    for k in got:
        assert {n: v for n, v in got[k].items() if n != "local_frame"} == \
            {n: v for n, v in want[k].items() if n != "local_frame"}
        for g, w in zip(got[k]["local_frame"], want[k]["local_frame"]):
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64), atol=1e-6)
    assert got[1]["local_frame"] == want[1]["local_frame"]
    assert common.ensure_demo_assets()["assets"] == rcommon.ASSETS
    for name in ("EEF_LINK", "NUM_DOF"):
        assert getattr(common, name) == getattr(rcommon, name)
    for name in ("JOINT_CONFIG", "HOME_Q"):
        np.testing.assert_array_equal(getattr(common, name),
                                      getattr(rcommon, name))


def test_pusht_policy_and_targets_match_reference():
    """Three scripted steps of the headless pushT env: the port's actions
    and end-effector targets are the reference's functions' on the same
    inputs, exactly; pushT's states and rewards are the reference's."""
    kp = jgym.PushTKeypointsEnv.genenerate_keypoint_manager_params()
    ref = jgym.PushTKeypointsEnv(render_size=96, render_action=False, seed=0,
                                 **kp)
    env = demo_pusht_splat.pusht_keypoints_env(96, seed=0, device="cpu")
    ref.reset()
    env.reset()
    obs, robs = env._set_state(VEC), ref._set_state(VEC)
    np.testing.assert_allclose(obs, robs, atol=1e-5, rtol=1e-6)
    goal = env.goal_pose
    np.testing.assert_array_equal(goal, ref.goal_pose)
    for t in range(3):
        info = env._get_info()
        act = demo_pusht_splat.scripted_policy(obs, info, goal)
        np.testing.assert_array_equal(
            act, rpusht.scripted_policy(obs, info, goal))
        np.testing.assert_array_equal(demo_pusht_splat.map_actions(act),
                                      rpusht.map_actions(act))
        obs, reward, done, info = env.step(act)
        robs, _, _, rinfo = ref.step(act)
        np.testing.assert_allclose(obs, robs, atol=1e-5, rtol=1e-6,
                                   err_msg=f"obs {t}")
        for k in ("pos_agent", "block_pose"):
            np.testing.assert_allclose(info[k], rinfo[k], atol=1e-5,
                                       rtol=1e-6, err_msg=f"{k} {t}")
        r, d = jpusht.reward_done(ref.env_f._params(), ref._state)
        assert abs(reward - float(r)) <= 1e-5 and done == bool(d)
    assert demo_pusht_splat.map_actions(None) is None


def test_slider_sweep_and_hw_compensation_exact(monkeypatch):
    """The port's slider sweep (85 steps: joints 0-2 in turn) and hardware
    replay (20 messages) step an env with exactly the joint values of the
    reference's own loops."""
    ref_env, env = Recorder(), Recorder()
    monkeypatch.setattr(rsliders, "make_manipulator_splat_env",
                        lambda **kw: ref_env)
    rsliders.main.callback(steps=85, out="", interactive=False,
                           control_hz=10, meshes=False)
    assert demo_joint_sliders_splat.run(env, 85) == 85
    assert len(env.actions) == len(ref_env.actions) == 85
    for t, (g, w) in enumerate(zip(env.actions, ref_env.actions)):
        np.testing.assert_array_equal(g, w, err_msg=f"step {t}")
    assert np.abs(env.actions[-1][2]) > 0.1     # the sweep reached joint 2

    ref_env, env = Recorder(), Recorder()
    monkeypatch.setattr(rhw, "create_splat_env", lambda: ref_env)
    monkeypatch.setattr(demo_hw_splat, "create_splat_env",
                        lambda device: env)
    rhw.main.callback(ros=False, port=0, replay=20)
    demo_hw_splat.main(["--replay", "20", "--device", "cpu"])
    assert len(env.actions) == len(ref_env.actions) == 20
    for g, w in zip(env.actions, ref_env.actions):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(demo_hw_splat.JOINT_SIGNS, rhw.JOINT_SIGNS)


def test_pusht_demo_frames_match_reference():
    """Two task-space steps of the pushT demo (``demo_step``): the arm's
    targets through IK, both cameras, against the reference's stack on the
    same actions."""
    ref = rcommon.make_manipulator_splat_env(eef=True, render_size=SIZE)
    env = common.make_manipulator_splat_env(eef=True, render_size=SIZE,
                                            device="cpu")
    pt = demo_pusht_splat.pusht_keypoints_env(96, seed=0, device="cpu")
    _, eef_ori = demo_pusht_splat.start_episode(pt, env)
    obs = pt._set_state(VEC)
    ref.reset(reset_to_state={"robot_pos": rcommon.HOME_Q, **ARM_RESET})
    ref_ori = np.asarray(jquat.to_rpy(jnp.asarray(
        ref.unwrapped._get_info()["eef_quat"])))
    np.testing.assert_allclose(eef_ori, ref_ori, atol=1e-6)
    for t in range(2):
        act = demo_pusht_splat.scripted_policy(obs, pt._get_info(),
                                               pt.goal_pose)
        obs, _, _, _, sobs, srew = demo_pusht_splat.demo_step(
            pt, env, act, eef_ori)
        want = ref.step({"eef_pos": rpusht.map_actions(act),
                         "eef_ori": eef_ori}, noobs=False)
        _close_frames(sobs, want[0], f"step {t}")
        assert abs(srew - want[1]) <= 2e-4


def test_slider_demo_frames_match_reference(ref_joint_env):
    env = demo_joint_sliders_splat.make_env(device="cpu", render_size=SIZE)
    ref = ref_joint_env
    ref.reset(reset_to_state={"robot_pos": [0.0] * 6, **ARM_RESET})
    values = np.zeros(6)
    for t in range(3):
        values = demo_joint_sliders_splat.sweep(values, t)
        got = env.step(values)
        want = ref.step(values, noobs=False)
        _close_frames(got[0], want[0], f"step {t}")
        assert abs(got[1] - want[1]) <= 2e-4


def test_hw_demo_weld_draw_poses_match_reference(monkeypatch):
    """Two replayed joint states on the non-identity base weld: the body
    poses drawn and both cameras against the reference's."""
    monkeypatch.setattr(rhw, "make_manipulator_splat_env", partial(
        rcommon.make_manipulator_splat_env, render_size=SIZE))
    ref = rhw.create_splat_env()
    env = demo_hw_splat.create_splat_env("cpu", SIZE)
    assert env.unwrapped.env_f.weld == demo_hw_splat.BASE_WELD
    for t in range(2):
        msg = demo_hw_splat.replay_message(t, 20)
        demo_hw_splat.joint_state_callback(msg, env)
        rhw.joint_state_callback(msg, env=ref)
        got, want = env.draw_msg.poses, ref.draw_msg.poses
        assert got.t.shape == want.t.shape
        np.testing.assert_allclose(np_of(got.t), np_of(want.t), atol=1e-5)
        np.testing.assert_allclose(np_of(got.q), np_of(want.q), atol=1e-5)
    assert np.abs(np_of(got.t)[1] - [0.65, -1.23, 0.42]).max() < 0.2
    for img, rimg in zip(env.render(), ref.render()):
        np.testing.assert_allclose(img, np.asarray(rimg), atol=1e-4, rtol=0)


def test_viewer_selftest_matches_reference(ref_joint_env):
    """``--selftest`` in-process: one JPEG through the viewer; the frame of
    its render callback at the viewer's orbit pose against the reference's
    ``render_free_camera`` for the same pose."""
    size = 64
    env = demo_viewer.create_splat_env(size, "cpu")
    viewer = demo_viewer.make_viewer(env, size)
    try:
        assert demo_viewer.selftest(viewer)[:2] == b"\xff\xd8"
        cam = viewer.camera
        q, t = orbit_pose(cam["azim"], cam["elev"], cam["dist"],
                          cam["target"])
        got = demo_viewer.render_fn(env, size)(q, t, {})
    finally:
        viewer.close()
    ref = ref_joint_env
    ref.reset(reset_to_state={"robot_pos": [0.0] * 6,
                              "block_pos": [0.35, 0.1, 0.0, 0.0],
                              "goal_pos": [0.45, -0.1, 0.0, 0.0]})
    ref.step(np.zeros(6, np.float32), noobs=True)
    want = ref.render_free_camera(JCamera.from_fov(
        JSE3(jnp.asarray(q), jnp.asarray(t)), 1.05, size, size))
    assert got.shape == (size, size, 3) and got.max() > 0.05
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)


CLI = {
    "demo_pusht_splat": ["--steps", "1"],
    "demo_joint_sliders_splat": ["--steps", "1", "--meshes"],
    "demo_hw_splat": ["--replay", "2"],
    "demo_viewer": ["--selftest", "--size", "48"],
}


@pytest.mark.parametrize("demo", sorted(CLI))
def test_demo_cli_runs_on_cpu(demo, tmp_path):
    """Each demo's command line once with ``--device cpu`` (the headless
    modes at the demos' own camera size, 240 × 320; frames written where
    ``--out`` asks)."""
    module = importlib.import_module(f"sim_a_splat_torch.examples.{demo}")
    args = CLI[demo] + ["--device", "cpu"]
    if demo in ("demo_pusht_splat", "demo_joint_sliders_splat"):
        args += ["--out", str(tmp_path)]
    module.main(args)
    frames = sorted(p.name for p in tmp_path.glob("*.ppm"))
    if demo == "demo_pusht_splat":
        assert frames == ["ep0_t0000_cam0.ppm", "ep0_t0000_cam1.ppm"]
    elif demo == "demo_joint_sliders_splat":
        assert frames == ["t0000_cam0.ppm", "t0000_cam1.ppm"]
        head = (tmp_path / frames[0]).read_bytes()[:15]
        assert head == b"P6\n320 240\n255\n"


@pytest.mark.parametrize("demo", sorted(CLI))
def test_demo_without_card_raises(demo):
    """Without a card a demo refuses to run rather than fall back to the
    CPU (the default is ``--device cuda``)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the no-card refusal")
    module = importlib.import_module(f"sim_a_splat_torch.examples.{demo}")
    with pytest.raises(RuntimeError, match="cuda"):
        module.main(CLI[demo])
