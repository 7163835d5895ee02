"""The port's core ops against the JAX reference, on the CPU.

Covariances, SE3's and Sim3's transforms, the scene's activations, SH
conversion, ``project``, ``synthetic_scene``, the scene graph's builders
and the dense golden renderer, on the same numpy inputs through both
packages, float32 on both sides.

Tolerances: the closed-form ops (covariances, transforms, activations, SH)
atol 1e-6 with rtol 2e-6 on values of order 1 (the port keeps the
reference's operation order; what is left is the last bits of a 3×3
product summed in another order, or of a library's sqrt);
``project`` rtol 1e-5 with atol 1e-4 for pixel coordinates of order 100
and atol 1e-6 for the conic (as ``test_torch_ops.py`` holds
``project_raw``); the scene from a seed and the scene graph's integers
exactly; the golden renderer's image, depth and alpha atol 1e-5 (sums of
a few hundred float32 products, a cumulative product over N entries).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_helpers import np_of

from sim_a_splat_tpu.ops import covariance as jcov
from sim_a_splat_tpu.ops import quaternion as jquat
from sim_a_splat_tpu.ops import sh as jsh
from sim_a_splat_tpu.ops.projection import Camera as JCamera
from sim_a_splat_tpu.ops.projection import project as jproject
from sim_a_splat_tpu.ops.rasterize_reference import (
    render_reference as jrender_reference,
    render_reference_sh as jrender_reference_sh,
)
from sim_a_splat_tpu.ops.transforms import SE3 as JSE3
from sim_a_splat_tpu.ops.transforms import Sim3 as JSim3
from sim_a_splat_tpu.scenegraph import graph as jgraph
from sim_a_splat_tpu.splat import loaders as jloaders
from sim_a_splat_tpu.splat.scene import GaussianScene as JScene

from sim_a_splat_torch.ops import covariance, sh
from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.ops.projection import Camera, project
from sim_a_splat_torch.ops.rasterize_reference import (
    render_reference, render_reference_sh,
)
from sim_a_splat_torch.ops.transforms import SE3, Sim3
from sim_a_splat_torch.scenegraph import graph
from sim_a_splat_torch.splat import loaders
from sim_a_splat_torch.splat.scene import GaussianScene

CLOSED = dict(rtol=2e-6, atol=1e-6)


def _close(mine, ref, **kw):
    np.testing.assert_allclose(np_of(mine), np_of(ref), **{**CLOSED, **kw})


def _rng_inputs(n=64, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(q=rng.normal(size=(n, 4)).astype(f),
                s=rng.uniform(0.05, 2.0, (n, 3)).astype(f),
                t=rng.normal(size=(n, 3)).astype(f),
                x=rng.normal(size=(n, 3)).astype(f),
                scale=rng.uniform(0.2, 3.0, n).astype(f))


def test_covariance_matches():
    d = _rng_inputs()
    q, s = torch.as_tensor(d["q"]), torch.as_tensor(d["s"])
    jq, js = jnp.asarray(d["q"]), jnp.asarray(d["s"])
    _close(covariance.compute_cov(q, s), jcov.compute_cov(jq, js))
    _close(covariance.compute_cov_inv(q, s), jcov.compute_cov_inv(jq, js),
           rtol=1e-6, atol=1e-5)      # 1/s² reaches 400
    R = quat.to_rotation_matrix(torch.as_tensor(d["x"][:1, [0, 1, 2, 0]]))
    cov = covariance.compute_cov(q, s)
    _close(covariance.transform_cov(R, cov),
           jcov.transform_cov(jnp.asarray(np_of(R)), jnp.asarray(np_of(cov))))


def test_quaternion_from_rotation_matrix_matches():
    d = _rng_inputs(256, seed=1)
    R = jquat.to_rotation_matrix(jnp.asarray(d["q"]))
    # rotations near each of the four Shepperd branches, and the identity
    special = np.stack([np.eye(3), np.diag([1.0, -1, -1]),
                        np.diag([-1.0, 1, -1]), np.diag([-1.0, -1, 1])])
    Rs = np.concatenate([np_of(R), special.astype(np.float32)])
    _close(quat.from_rotation_matrix(torch.as_tensor(Rs)),
           jquat.from_rotation_matrix(jnp.asarray(Rs)))


def test_se3_matches():
    d = _rng_inputs(seed=2)
    T = SE3(torch.as_tensor(d["q"]), torch.as_tensor(d["t"]))
    J = JSE3(jnp.asarray(d["q"]), jnp.asarray(d["t"]))
    _close(T.apply(torch.as_tensor(d["x"])), J.apply(jnp.asarray(d["x"])),
           atol=4e-6)
    m = T.as_matrix()
    _close(m, J.as_matrix())
    back = SE3.from_matrix(m)
    jback = JSE3.from_matrix(J.as_matrix())
    _close(back.q, jback.q)
    _close(back.t, jback.t)
    for shape in [(), (3,), (2, 5)]:
        I, JI = SE3.identity(shape), JSE3.identity(shape)
        assert tuple(I.q.shape) == JI.q.shape and I.q.dtype == torch.float32
        _close(I.q, JI.q, atol=0)
        _close(I.t, JI.t, atol=0)


def test_sim3_matches():
    d = _rng_inputs(seed=3)
    parts = (torch.as_tensor(d["q"]), torch.as_tensor(d["t"]),
             torch.as_tensor(d["scale"]))
    jparts = (jnp.asarray(d["q"]), jnp.asarray(d["t"]),
              jnp.asarray(d["scale"]))
    S, J = Sim3(*parts), JSim3(*jparts)
    x, jx = torch.as_tensor(d["x"]), jnp.asarray(d["x"])
    _close(S.apply(x), J.apply(jx), atol=1e-5)         # |s·R x + t| ≤ ~10
    se3, jse3 = S.se3(), J.se3()
    _close(se3.q, jse3.q, atol=0)
    # inverse, compose and as_matrix: the reference broadcasts a scalar
    # scale only, so one pair of rows at a time
    n = len(d["scale"])
    for i in range(4):
        one = Sim3(*(a[i] for a in parts))
        two = Sim3(*(a[n - 1 - i] for a in parts))
        jone = JSim3(*(a[i] for a in jparts))
        jtwo = JSim3(*(a[n - 1 - i] for a in jparts))
        pairs = [(one.inverse(), jone.inverse()),
                 (one.compose(two), jone.compose(jtwo)),
                 (one.compose_se3(two.se3()), jone.compose_se3(jtwo.se3()))]
        for mine, ref in pairs:
            _close(mine.q, ref.q)
            _close(mine.t, ref.t, atol=1e-5)
            _close(mine.s, ref.s, rtol=1e-6)
        _close(one.as_matrix(), jone.as_matrix())
    I, JI = Sim3.identity((4,)), JSim3.identity((4,))
    for a, b in zip(I, JI):
        _close(a, b, atol=0)


def test_sim3_from_matrix_matches_and_rejects():
    rng = np.random.default_rng(7)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    R = np_of(jquat.to_rotation_matrix(jnp.asarray(q, jnp.float32)))
    M = np.eye(4)
    M[:3, :3] = 0.2112 * R
    M[:3, 3] = [0.3, -0.1, 0.7]
    mine, ref = Sim3.from_matrix(M), JSim3.from_matrix(M)
    for a, b in zip(mine, ref):
        _close(a, b)
    # what the reference rejects, the port rejects: an anisotropic scale,
    # a sheared block, and a scale just past the isotropy tolerance
    bad = [np.diag([2.0, 1.0, 1.0, 1.0]), np.eye(4), np.eye(4)]
    bad[1][0, 1] = 0.01
    bad[2][2, 2] = 1.0 + 3e-5
    for m in bad:
        with pytest.raises(ValueError):
            JSim3.from_matrix(m)
        with pytest.raises(ValueError):
            Sim3.from_matrix(m)
    # and a torch matrix is taken too
    got = Sim3.from_matrix(torch.as_tensor(M))
    _close(got.s, ref.s)


def _scene_pair(n=48, seed=0, sh_degree=2):
    mine = loaders.synthetic_scene(n, seed=seed, sh_degree=sh_degree,
                                   device="cpu")
    ref = jloaders.synthetic_scene(n, seed=seed, sh_degree=sh_degree)
    return mine, ref


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_synthetic_scene_matches(sh_degree):
    mine, ref = _scene_pair(sh_degree=sh_degree, seed=5)
    for name in JScene._fields:
        a, b = getattr(mine, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(np_of(a), np_of(b), err_msg=name)
    with pytest.raises(RuntimeError, match="cuda"):
        if torch.cuda.is_available():
            pytest.skip("a card is present: this checks the no-card refusal")
        loaders.synthetic_scene(8)      # device="cuda" by default


def test_scene_methods_match():
    mine, ref = _scene_pair(seed=6)
    assert mine.num_gaussians == ref.num_gaussians == 48
    _close(mine.scales(), ref.scales())
    _close(mine.covs(), ref.covs())
    _close(mine.covs_inv(), ref.covs_inv(), rtol=1e-6, atol=2e-3)
    half = mine.astype(torch.float64)
    assert all(f.dtype == torch.float64 for f in half)
    _close(half.means, mine.means, atol=0)
    assert GaussianScene(*mine[:5]).astype(torch.float64).sh_rest is None


def test_rgb_to_sh_matches():
    rgb = np.random.default_rng(8).uniform(0, 1, (100, 3)).astype(np.float32)
    mine = sh.rgb_to_sh(torch.as_tensor(rgb))
    _close(mine, jsh.rgb_to_sh(jnp.asarray(rgb)))
    _close(sh.sh_to_rgb(mine), rgb)


def _cameras(q, t, width=40, height=28, fov=0.8):
    return (Camera.from_fov(SE3(torch.as_tensor(q), torch.as_tensor(t)), fov,
                            width, height),
            JCamera.from_fov(JSE3(jnp.asarray(q), jnp.asarray(t)), fov,
                             width, height))


CAMERA_POSES = [  # looking down +z from z = -3, and a tilted one
    (np.asarray([1.0, 0, 0, 0], np.float32),
     np.asarray([0.0, 0.0, -3.0], np.float32)),
    (np.asarray([0.98, 0.1, -0.15, 0.05], np.float32),
     np.asarray([0.4, -0.3, -2.5], np.float32)),
]


@pytest.mark.parametrize("pose", range(len(CAMERA_POSES)))
def test_project_matches(pose):
    mine, ref = _scene_pair(n=300, seed=9, sh_degree=0)
    cam, jcam = _cameras(*CAMERA_POSES[pose])
    p = project(mine.means, mine.covs(), cam)
    jp = jproject(ref.means, ref.covs(), jcam)
    np.testing.assert_array_equal(np_of(p.valid), np_of(jp.valid))
    assert int(p.valid.sum()) > 0
    v = np_of(p.valid)
    _close(np_of(p.xy)[v], np_of(jp.xy)[v], rtol=1e-5, atol=1e-4)
    _close(p.depth, jp.depth, rtol=1e-6)
    _close(np_of(p.conic)[v], np_of(jp.conic)[v], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np_of(p.radius), np_of(jp.radius))
    # a batch of scenes under one camera: each row as projected alone
    pb = project(mine.means.expand(2, -1, -1), mine.covs().expand(2, -1, -1,
                                                                  -1), cam)
    for a, b in zip(pb, p):
        assert torch.equal(a[1], b)


def test_scenegraph_builders_match():
    mine, ref = _scene_pair(n=10, seed=7, sh_degree=0)
    a = np.zeros(10, bool)
    a[:6] = True
    b = np.zeros(10, bool)
    b[4:8] = True
    g = graph.SceneGraph.from_masks(mine, [a, b])
    jg = jgraph.SceneGraph.from_masks(ref, [a, b])
    np.testing.assert_array_equal(np_of(g.link_ids), np_of(jg.link_ids))
    np.testing.assert_array_equal(np_of(g.link_ids),
                                  [1, 1, 1, 1, 2, 2, 2, 2, 0, 0])
    assert g.num_bodies == jg.num_bodies == 3
    _close(g.rest_inv.q, jg.rest_inv.q, atol=0)
    _close(g.rest_inv.t, jg.rest_inv.t, atol=0)
    # with capture poses: slot 0 stays the identity, the others inverted
    d = _rng_inputs(3, seed=11)
    poses = graph.body_poses_from_parts(d["q"], d["t"])
    jposes = jgraph.body_poses_from_parts(d["q"], d["t"])
    _close(poses.q, jposes.q, atol=0)
    g = graph.SceneGraph.from_masks(mine, [a, b], rest_poses=poses)
    jg = jgraph.SceneGraph.from_masks(ref, [a, b], rest_poses=jposes)
    _close(g.rest_inv.q, jg.rest_inv.q)
    _close(g.rest_inv.t, jg.rest_inv.t)
    _close(g.rest_inv.q[0], [1.0, 0, 0, 0], atol=0)
    # and posing through them
    bp = graph.body_poses_from_parts(d["q"][::-1].copy(), d["t"] * 2)
    jbp = jgraph.body_poses_from_parts(d["q"][::-1].copy(), d["t"] * 2)
    _close(g.posed(bp).means, jg.posed(jbp).means, atol=4e-6)


@pytest.mark.parametrize("sh_degree,sigma_cutoff,bg", [
    (0, 3.0, None), (0, None, (0.3, 0.1, 0.6)), (2, 3.0, (1.0, 1.0, 1.0))])
def test_render_reference_matches(sh_degree, sigma_cutoff, bg):
    mine, ref = _scene_pair(n=150, seed=4, sh_degree=sh_degree)
    cam, jcam = _cameras(*CAMERA_POSES[1], width=24, height=20)
    kw = dict(return_depth=True, sigma_cutoff=sigma_cutoff)
    bgs = (None, None) if bg is None else (torch.tensor(bg), jnp.asarray(bg))
    if sh_degree == 0:
        got = render_reference(mine.means, mine.covs(), mine.colors_dc(),
                               mine.opacities(), cam, bgs[0], **kw)
        want = jrender_reference(ref.means, ref.covs(), ref.colors_dc(),
                                 ref.opacities(), jcam, bgs[1], **kw)
    else:
        got = render_reference_sh(mine.means, mine.covs(), mine.sh_coeffs(),
                                  mine.opacities(), cam, sh_degree, bgs[0],
                                  **kw)
        want = jrender_reference_sh(ref.means, ref.covs(), ref.sh_coeffs(),
                                    ref.opacities(), jcam, sh_degree, bgs[1],
                                    **kw)
    img, depth, alpha = got
    assert img.shape == (20, 24, 3) and float(alpha.max()) > 0.5
    for name, a, b in zip(("image", "depth", "alpha"), got, want):
        np.testing.assert_allclose(np_of(a), np_of(b), rtol=0, atol=1e-5,
                                   err_msg=name)
    only = render_reference(mine.means, mine.covs(), mine.colors_dc(),
                            mine.opacities(), cam)
    assert only.shape == (20, 24, 3)
