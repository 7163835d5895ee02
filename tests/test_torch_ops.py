"""Port's quaternion / SE3 / SH / projection against the JAX reference.

Same numpy inputs through both packages, float32 on both sides.  Tolerance
rtol 1e-5, atol 1e-5 (pixel coordinates atol 1e-4): the expressions keep
the reference's operation order, so what is left is the last-bit difference
of the two libraries' transcendental functions and reductions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_helpers import np_of

from sim_a_splat_tpu.ops import quaternion as jquat
from sim_a_splat_tpu.ops import sh as jsh
from sim_a_splat_tpu.ops.projection import Camera as JCamera
from sim_a_splat_tpu.ops.projection import project_raw as jproject_raw
from sim_a_splat_tpu.ops.projection import view_directions as jview_dirs
from sim_a_splat_tpu.ops.transforms import SE3 as JSE3

from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.ops import sh
from sim_a_splat_torch.ops.projection import Camera, project_raw, view_directions
from sim_a_splat_torch.ops.transforms import SE3

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(mine, ref, **kw):
    np.testing.assert_allclose(np_of(mine), np_of(ref), **{**TOL, **kw})


def _inputs(n=200, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(q1=rng.normal(size=(n, 4)).astype(f),
                q2=rng.normal(size=(n, 4)).astype(f),
                v=(rng.normal(size=(n, 3)) * 50).astype(f),
                t=(rng.normal(size=(n, 3)) * 10).astype(f),
                angle=rng.uniform(-7, 7, n).astype(f))


def test_quaternion_ops_match():
    d = _inputs()
    T = {k: torch.as_tensor(v) for k, v in d.items()}
    J = {k: jnp.asarray(v) for k, v in d.items()}
    _close(quat.normalize(T["q1"]), jquat.normalize(J["q1"]))
    _close(quat.multiply(T["q1"], T["q2"]), jquat.multiply(J["q1"], J["q2"]))
    _close(quat.rotate(T["q1"], T["v"]), jquat.rotate(J["q1"], J["v"]),
           atol=1e-4)
    _close(quat.to_rotation_matrix(T["q1"]), jquat.to_rotation_matrix(J["q1"]))
    axis = np.asarray([0.0, 0.0, 1.0], np.float32)
    _close(quat.from_axis_angle(torch.as_tensor(axis), T["angle"]),
           jquat.from_axis_angle(jnp.asarray(axis), J["angle"]))


def test_se3_compose_inverse_match():
    d = _inputs(seed=1)
    a, b = SE3(torch.as_tensor(d["q1"]), torch.as_tensor(d["t"])), \
        SE3(torch.as_tensor(d["q2"]), torch.as_tensor(d["v"]))
    ja, jb = JSE3(jnp.asarray(d["q1"]), jnp.asarray(d["t"])), \
        JSE3(jnp.asarray(d["q2"]), jnp.asarray(d["v"]))
    c, jc = a.compose(b), ja.compose(jb)
    _close(c.q, jc.q)
    _close(c.t, jc.t, atol=1e-4)
    inv, jinv = a.inverse(), ja.inverse()
    _close(inv.q, jinv.q)
    _close(inv.t, jinv.t)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_split_and_full_match(degree):
    rng = np.random.default_rng(degree)
    n, k = 300, (degree + 1) ** 2
    coeffs = rng.normal(0, 0.5, (n, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dc, rest = coeffs[:, 0], coeffs[:, 1:k] if degree else None
    mine = sh.eval_sh_color_split(
        torch.as_tensor(dc), None if rest is None else torch.as_tensor(rest),
        torch.as_tensor(dirs), degree)
    ref = jsh.eval_sh_color_split(
        jnp.asarray(dc), None if rest is None else jnp.asarray(rest),
        jnp.asarray(dirs), degree)
    _close(mine, ref)
    _close(sh.eval_sh(torch.as_tensor(coeffs), torch.as_tensor(dirs), degree),
           jsh.eval_sh(jnp.asarray(coeffs), jnp.asarray(dirs), degree))
    assert sh.C0 == jsh.C0


@pytest.mark.parametrize("cam_q", [[1.0, 0.0, 0.0, 0.0],
                                   [0.98, 0.1, -0.15, 0.05]])
def test_project_raw_and_view_directions_match(cam_q):
    rng = np.random.default_rng(7)
    n = 400
    means = np.concatenate([rng.uniform([-20, -20], [320, 530], (n, 2)),
                            rng.uniform(-5, 10, (n, 1))], 1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    log_scales = rng.uniform(np.log(1.0), np.log(8.0), (n, 3)).astype(np.float32)
    q = np.asarray(cam_q, np.float32)
    t = np.asarray([149.0, 256.0, -450.0], np.float32)
    jcam = JCamera.from_fov(JSE3(jnp.asarray(q), jnp.asarray(t)), 1.05, 64, 48)
    cam = Camera.from_fov(SE3(torch.as_tensor(q), torch.as_tensor(t)), 1.05,
                          64, 48)
    _close(cam.fx, jcam.fx)
    ref = jproject_raw(jnp.asarray(means), jnp.asarray(quats),
                       jnp.asarray(log_scales), jcam)
    mine = project_raw(torch.as_tensor(means), torch.as_tensor(quats),
                       torch.as_tensor(log_scales), cam)
    _close(mine.xy, ref.xy, atol=1e-4)
    _close(mine.depth, ref.depth, atol=1e-4)
    _close(mine.conic, ref.conic)
    np.testing.assert_array_equal(np_of(mine.valid), np_of(ref.valid))
    np.testing.assert_array_equal(np_of(mine.radius), np_of(ref.radius))
    _close(view_directions(torch.as_tensor(means), cam),
           jview_dirs(jnp.asarray(means), jcam))


def test_scene_graph_posed_matches():
    """``SceneGraph.posed`` on batched body poses against the reference's
    ``posed`` per env."""
    import jax
    import __graft_entry__ as graft
    from test_torch_helpers import graph_leaves
    from sim_a_splat_torch import entry

    jg = graft._build_scene(n_bg=64, n_block=32, n_agent=16, sh_degree=1)
    g = entry.graph_from_numpy(graph_leaves(jg), device="cpu")
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 3, 4)).astype(np.float32)
    t = (rng.normal(size=(2, 3, 3)) * 20).astype(np.float32)
    mine = g.posed(SE3(torch.as_tensor(q), torch.as_tensor(t)))
    for b in range(2):
        ref = jg.posed(JSE3(jnp.asarray(q[b]), jnp.asarray(t[b])))
        _close(mine.means[b], ref.means, atol=1e-4)
        _close(mine.quats[b], ref.quats)
    assert g.scene.sh_degree == 1
    _close(g.scene.opacities(), jax.nn.sigmoid(jg.scene.logit_opacities))
    _close(g.scene.colors_dc(), jg.scene.colors_dc())
    _close(g.scene.sh_coeffs(), jg.scene.sh_coeffs())
