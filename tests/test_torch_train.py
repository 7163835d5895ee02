"""The port's splat trainer against the JAX reference, on the CPU.

Each test builds its inputs with numpy from a seed (the reference's
``synthetic_scene``, a camera pair, and as the target another scene's
render, well away from the trained scene's render, so that the L1 term's
gradient, a sign per pixel, is the same on both sides) and runs them
through ``sim_a_splat_tpu`` and ``sim_a_splat_torch`` (``device="cpu"``).

Tolerances, and why:
- SSIM: value atol 2e-6 against the reference and 1e-5 against
  ``tests/test_ssim.py``'s float64 loop (the reference's own bound); the
  gradient within 1e-5 of its largest element (float32 convolutions
  summed in another order).
- the means schedule rtol 1e-6 (optax evaluates it in float32, the port in
  float64); the learning rates of the other groups exactly.
- one train step: the loss rtol 1e-5, each field's gradient and ‖∇means‖
  within 1e-4 of its largest (float32 projection and compositing of two
  libraries, as ``test_torch_uncached.py`` holds them).  Parameters after
  an Adam update within 1e-2 × their group's learning rate: the update is
  lr·m̂/(√v̂ + 1e-8), which divides two float32 moments and so turns a
  relative gradient difference of 1e-4 into one of the update near where
  the gradient is small; lr·1e-2 bounds what one step can carry
  (measured: 6.2e-4 × lr).
- a step after five reference steps carried across (``scene_from_numpy``,
  ``adam_state_from_numpy``): the same bounds (measured 1.9e-4 × lr), and
  the moments after it rtol 1e-4.
- ``refine_scene``: N and the row order exact, every field exact but the
  split means (the reference's normal draws, rotated in float32 by either
  library) at atol 1e-6.
- ``train()`` over 30 iterations with a round that duplicates and culls:
  ``n_gaussians`` exactly; each loss rtol 1e-4 and the final scene within
  0.1 × its group's learning rate of the reference's (measured: 9.5e-6 and
  0.014; one step's 6.2e-4 × lr grows over 30 Adam steps, each of which
  moves a parameter by up to about its learning rate).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_helpers import SCENE_FIELDS, assert_fields_close, np_of
from test_ssim import ssim_numpy

from sim_a_splat_tpu.ops import quaternion as jquat
from sim_a_splat_tpu.ops import rasterize_tiles as jtiles
from sim_a_splat_tpu.ops import ssim as jssim
from sim_a_splat_tpu.ops.projection import Camera as JCamera
from sim_a_splat_tpu.ops.transforms import SE3 as JSE3
from sim_a_splat_tpu.splat import loaders as jloaders
from sim_a_splat_tpu.splat import train as jtrain
from sim_a_splat_tpu.splat.scene import GaussianScene as JScene

from sim_a_splat_torch import entry
from sim_a_splat_torch.ops import ssim as tssim
from sim_a_splat_torch.ops import rasterize_tiles as tiles
from sim_a_splat_torch.ops.projection import Camera
from sim_a_splat_torch.ops.transforms import SE3
from sim_a_splat_torch.splat import refine, train
from sim_a_splat_torch.splat.scene import scene_from_numpy

ROOT = Path(__file__).resolve().parent.parent
RES = 32
LR_FIELDS = {"means": "lr_means", "quats": "lr_quats",
             "log_scales": "lr_scales", "logit_opacities": "lr_opacities",
             "sh_dc": "lr_sh_dc", "sh_rest": "lr_sh_rest"}
# the tests' raster (tile 16, K = 128); the JAX side composites with its
# XLA scan, which ignores term_eps, or with the Pallas kernel in interpret
# mode, which applies it as the port's K1 does
RASTER = dict(tile_capacity=128, max_tiles_per_gaussian=9, sigma_cutoff=3.0)
PALLAS = dict(RASTER, term_eps=1e-4)


def rasters(term_eps=False):
    kw = PALLAS if term_eps else RASTER
    backend = "pallas_interpret" if term_eps else "xla"
    return (tiles.RasterConfig(**kw),
            jtiles.RasterConfig(backend=backend, chunk=128 if term_eps else 64,
                                **kw))


def scene_pair(n=48, seed=0, sh_degree=1, **kw):
    """The reference's ``synthetic_scene`` and its copy in the port."""
    js = jloaders.synthetic_scene(n, seed=seed, sh_degree=sh_degree,
                                  **{"extent": 0.5, **kw})
    fields = {k: None if v is None else np.asarray(v)
              for k, v in js._asdict().items()}
    return js, scene_from_numpy(fields, device="cpu")


def camera_pair(position, res=RES, fov=0.8):
    """An OpenCV camera at ``position`` looking at the origin, both ways."""
    p = np.asarray(position, np.float64)
    z = -p / np.linalg.norm(p)
    up = np.array([0.0, -1.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z], axis=1)
    q = np.asarray(jquat.from_rotation_matrix(jnp.asarray(R, jnp.float32)))
    t = p.astype(np.float32)
    return (Camera.from_fov(SE3(torch.as_tensor(q), torch.as_tensor(t)), fov,
                            res, res),
            JCamera.from_fov(JSE3(jnp.asarray(q), jnp.asarray(t)), fov, res,
                             res))


def target_image(cam_j, seed=7):
    """Another scene's render from ``cam_j``: the tests' target."""
    other = jloaders.synthetic_scene(60, seed=seed, extent=0.6, sh_degree=0,
                                     scale_range=(0.05, 0.12))
    return np.asarray(jtrain.render_view(other, cam_j), np.float32)


def jax_loss_fn(cfg, raster_j, cam_j, image):
    """The reference's train loss (``make_train_step``'s closure), built
    from its parts."""
    bg = jnp.asarray(cfg.background, jnp.float32)

    def loss_fn(s):
        img, _ = jtiles.rasterize_raw_sh(
            s.means, s.quats, s.log_scales, s.sh_coeffs(), s.opacities(),
            cam_j, s.sh_degree, raster_j, background=bg)
        err = img - image
        phot = (cfg.l1_weight * jnp.mean(jnp.abs(err))
                + (1.0 - cfg.l1_weight) * jnp.mean(err ** 2))
        if cfg.ssim_lambda <= 0.0:
            return phot
        return ((1.0 - cfg.ssim_lambda) * phot
                + cfg.ssim_lambda * jssim.ssim_loss(img, image))
    return loss_fn


def assert_params_close(got, want, cfg, frac, what):
    """Each field of the scene ``got`` within ``frac`` × its group's
    learning rate of ``want``."""
    for name in SCENE_FIELDS:
        w = getattr(want, name)
        if w is None:
            assert getattr(got, name) is None, name
            continue
        lr = getattr(cfg, LR_FIELDS[name])
        err = float(np.abs(np_of(getattr(got, name)) - np_of(w)).max())
        assert err <= frac * lr, \
            f"{what} {name}: max|Δ| {err:.3e} > {frac} × lr {lr}"


# --- SSIM -------------------------------------------------------------------

def test_ssim_matches_reference_and_numpy():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (16, 18, 3)).astype(np.float32)
    ref = np.clip(img + rng.normal(0, 0.1, img.shape), 0, 1).astype(
        np.float32)
    np.testing.assert_array_equal(tssim._gaussian_kernel(11, 1.5),
                                  jssim._gaussian_kernel(11, 1.5))
    got = float(tssim.ssim(torch.as_tensor(img), torch.as_tensor(ref)))
    np.testing.assert_allclose(got, float(jssim.ssim(jnp.asarray(img),
                                                     jnp.asarray(ref))),
                               atol=2e-6)
    np.testing.assert_allclose(got, ssim_numpy(img, ref), atol=1e-5)
    # the gradient of 1 − SSIM, away from the optimum
    x0 = img * 0.5 + 0.25
    leaf = torch.as_tensor(x0).requires_grad_()
    tssim.ssim_loss(leaf, torch.as_tensor(ref)).backward()
    want = np.asarray(jax.grad(lambda x: jssim.ssim_loss(
        x, jnp.asarray(ref)))(jnp.asarray(x0)))
    err = float(np.abs(np_of(leaf.grad) - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), err
    np.testing.assert_allclose(float(tssim.ssim(leaf, leaf)), 1.0, atol=1e-6)


# --- the optimizer ------------------------------------------------------------

@pytest.mark.parametrize("sh_degree", [0, 1])
def test_optimizer_matches_optax_step_by_step(sh_degree):
    """Per-group learning rates and the means schedule against optax's,
    then six Adam updates from the same random gradients."""
    cfg = jtrain.TrainConfig(iters=6, lr_means=1e-2, lr_means_final=1e-4)
    tcfg = train.TrainConfig(**vars(cfg))
    sched = optax.exponential_decay(cfg.lr_means, cfg.iters,
                                    cfg.lr_means_final / cfg.lr_means)
    for t in range(0, 2 * cfg.iters):
        np.testing.assert_allclose(train.means_lr(tcfg, t),
                                   float(sched(t)), rtol=1e-6)

    js, ts = scene_pair(12, seed=1, sh_degree=sh_degree)
    opt_j = jtrain.make_optimizer(cfg, js)
    st = opt_j.init(js)
    params = train.parameters(ts)
    opt_t = train.make_optimizer(tcfg, params)
    names = [g["name"] for g in opt_t.param_groups]
    assert names == [k for k in LR_FIELDS if getattr(ts, k) is not None]
    for g in opt_t.param_groups:
        assert g["lr"] == getattr(cfg, LR_FIELDS[g["name"]])
    rng = np.random.default_rng(2)
    for t in range(cfg.iters):
        grads = {k: None if v is None else
                 rng.normal(size=v.shape).astype(np.float32)
                 for k, v in js._asdict().items()}
        upd, st = opt_j.update(JScene(**{k: None if v is None else
                                         jnp.asarray(v)
                                         for k, v in grads.items()}), st, js)
        js = optax.apply_updates(js, upd)
        for name, p in params._asdict().items():
            if p is not None:
                p.grad = torch.as_tensor(grads[name])
        train._apply_schedules(opt_t)
        np.testing.assert_allclose(opt_t.param_groups[0]["lr"],
                                   float(sched(t)), rtol=1e-6)
        opt_t.step()
        assert_params_close(params, js, cfg, 1e-3, f"update {t}")


# --- one train step -------------------------------------------------------

STEP_CASES = {
    "l1": dict(ssim_lambda=0.0),
    "l2": dict(ssim_lambda=0.0, l1_weight=0.0),
    "ssim": dict(ssim_lambda=1.0),
    "l1+ssim": dict(ssim_lambda=0.2),
    "mix+ssim, term_eps": dict(ssim_lambda=0.2, l1_weight=0.5),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_reference(case):
    """``make_train_step``: the loss, each field's gradient, ‖∇means‖ and
    the updated scene against the reference's jitted step; the L1 term,
    the L2 term and the SSIM term each on its own and mixed, with
    ``term_eps`` through the Pallas kernel in interpret mode."""
    term_eps = "term_eps" in case
    cfg = jtrain.TrainConfig(iters=10, **STEP_CASES[case])
    tcfg = train.TrainConfig(**vars(cfg))
    raster_t, raster_j = rasters(term_eps)
    js, ts = scene_pair()
    cam_t, cam_j = camera_pair([0.4, -0.3, -2.2])
    image = target_image(cam_j)

    opt_j = jtrain.make_optimizer(cfg, js)
    new_j, _, loss_j, gnorm_j = jtrain.make_train_step(
        cfg, raster_j, opt_j)(js, opt_j.init(js), cam_j, jnp.asarray(image))
    loss_fn = jax_loss_fn(cfg, raster_j, cam_j, jnp.asarray(image))
    loss_v, grads_j = jax.value_and_grad(loss_fn)(js)
    np.testing.assert_allclose(float(loss_v), float(loss_j), rtol=1e-6)

    params = train.parameters(ts)
    opt_t = train.make_optimizer(tcfg, params)
    step = train.make_train_step(tcfg, raster_t, opt_t)
    before = train.parameters(params)
    _, loss_t, gnorm_t = step(params, cam_t, torch.as_tensor(image))
    grads_t = type(ts)(*(None if p is None else p.grad for p in params))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert_fields_close(grads_t, grads_j, 1e-4)
    err = float(np.abs(np_of(gnorm_t) - np.asarray(gnorm_j)).max())
    assert err <= 1e-4 * float(np.abs(np.asarray(gnorm_j)).max())
    assert_params_close(params, new_j, cfg, 1e-2, "updated scene")
    moved = float((params.means - before.means).abs().max())
    assert moved > 0.5 * cfg.lr_means                # the step did update


def test_step_after_carried_state_matches_reference():
    """Five reference steps over two views, carried across with
    ``scene_from_numpy`` and ``adam_state_from_numpy``; then one more step
    on each side: loss, ‖∇means‖, the scene and the moments agree."""
    cfg = jtrain.TrainConfig(iters=20, ssim_lambda=0.2)
    tcfg = train.TrainConfig(**vars(cfg))
    raster_t, raster_j = rasters()
    js, _ = scene_pair(seed=3)
    cams = [camera_pair([0.4, -0.3, -2.2]), camera_pair([-1.6, 0.2, -1.5])]
    images = [target_image(c[1], seed=8 + i) for i, c in enumerate(cams)]

    opt_j = jtrain.make_optimizer(cfg, js)
    st = opt_j.init(js)
    step_j = jtrain.make_train_step(cfg, raster_j, opt_j)
    for it in range(5):
        js, st, _, _ = step_j(js, st, cams[it % 2][1],
                              jnp.asarray(images[it % 2]))
    adam = {k: s.inner_state[0] for k, s in st.inner_states.items()}
    counts = {k: int(a.count) for k, a in adam.items()}
    assert set(counts.values()) == {5}
    mu = {k: np.asarray(getattr(a.mu, k)) for k, a in adam.items()}
    nu = {k: np.asarray(getattr(a.nu, k)) for k, a in adam.items()}

    params = train.parameters(scene_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in js._asdict().items()}, device="cpu"))
    opt_t = train.adam_state_from_numpy(
        mu, nu, counts, train.make_optimizer(tcfg, params))
    _, loss_t, gnorm_t = train.make_train_step(tcfg, raster_t, opt_t)(
        params, cams[1][0], torch.as_tensor(images[1]))
    new_j, st, loss_j, gnorm_j = step_j(js, st, cams[1][1],
                                        jnp.asarray(images[1]))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    err = float(np.abs(np_of(gnorm_t) - np.asarray(gnorm_j)).max())
    assert err <= 1e-4 * float(np.abs(np.asarray(gnorm_j)).max())
    assert_params_close(params, new_j, cfg, 1e-2, "carried step")
    np.testing.assert_allclose(opt_t.param_groups[0]["lr"],
                               train.means_lr(tcfg, 5))
    for g in opt_t.param_groups:
        p, name = g["params"][0], g["name"]
        a = st.inner_states[name].inner_state[0]
        assert float(opt_t.state[p]["step"]) == int(a.count) == 6
        for key, m in (("exp_avg", a.mu), ("exp_avg_sq", a.nu)):
            want = np.asarray(getattr(m, name))
            np.testing.assert_allclose(np_of(opt_t.state[p][key]), want,
                                       rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max())


# --- refinement -----------------------------------------------------------

def test_refine_scene_matches_reference(monkeypatch):
    """``refine_scene`` from the same ``grad_acc``: the same N and row order
    (duplicate, extend the split mask, split, cull), the split fed the
    reference's own normal draws (``jax.random.normal(key(0))``)."""
    js, ts = scene_pair(40, seed=4, scale_range=(0.01, 0.12))
    js = js._replace(logit_opacities=js.logit_opacities.at[::7].set(-4.0))
    ts = ts._replace(logit_opacities=torch.as_tensor(
        np.asarray(js.logit_opacities)))
    cfg = jtrain.TrainConfig(densify_grad_thresh=0.5,
                             densify_size_thresh=0.08, n_split_samples=3,
                             cull_scale_thresh=0.1)
    grad_acc = np.random.default_rng(5).uniform(0, 1, 40).astype(np.float32)
    big = np.exp(np.asarray(js.log_scales)).max(-1) > 0.08
    high = grad_acc > 0.5
    assert (high & big).any() and (high & ~big).any()   # splits and copies
    draws = []

    def reference_draws(seed, shape, device):
        draws.append(shape)
        return torch.as_tensor(np.asarray(jax.random.normal(
            jax.random.key(seed), shape)), device=device)

    monkeypatch.setattr(refine, "standard_normal", reference_draws)
    want = jtrain.refine_scene(js, grad_acc, cfg)
    got, keep = train.refine_scene(ts, grad_acc,
                                   train.TrainConfig(**vars(cfg)))
    assert int(keep.sum()) == got.num_gaussians
    assert len(draws) == 1 and draws[0][0] == 3
    assert got.num_gaussians == want.num_gaussians
    n_kept = 40 + int((high & ~big).sum()) + 2 * int((high & big).sum())
    assert got.num_gaussians < n_kept                   # and culls
    for name in SCENE_FIELDS:
        g, w = np_of(getattr(got, name)), np.asarray(getattr(want, name))
        if name == "means":
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_split_keeps_distribution():
    """``tests/test_pipeline_refine_export.py::test_split_keeps_distribution``
    with the port's own generator."""
    _, scene = scene_pair(30, seed=2, sh_degree=0, extent=1.0,
                          scale_range=(0.01, 0.02))
    out = refine.split_gaussians(scene, None, n_split_samples=4, seed=0)
    assert out.num_gaussians == 120
    parents = np.tile(np_of(scene.means), (4, 1))
    d = np.linalg.norm(np_of(out.means) - parents, axis=-1)
    assert d.max() < 0.2
    np.testing.assert_allclose(np_of(out.scales()),
                               np.tile(np_of(scene.scales()), (4, 1)) / 1.6,
                               rtol=1e-5)
    # the offsets are standard normal in each gaussian's frame
    eps = refine.standard_normal(0, (4, 30, 3), "cpu")
    assert abs(float(eps.mean())) < 0.15 and abs(float(eps.std()) - 1) < 0.15
    again = refine.split_gaussians(scene, None, n_split_samples=4, seed=0)
    np.testing.assert_array_equal(np_of(again.means), np_of(out.means))


# --- the whole loop -------------------------------------------------------

def test_train_loop_with_a_refinement_round_matches_reference():
    """``train()``: 30 iterations over two views, a refinement round at
    iteration 20 whose split set is empty (``densify_size_thresh`` above
    every scale: it duplicates and culls), against the reference's."""
    cfg = jtrain.TrainConfig(iters=30, refine_every=20, refine_start=20,
                             densify_grad_thresh=2e-3,
                             densify_size_thresh=1.0, cull_alpha_thresh=0.3,
                             lr_means=2e-3, lr_means_final=2e-4,
                             lr_sh_dc=2.5e-2, lr_opacities=1e-1,
                             lr_scales=2e-2, lr_quats=1e-2)
    raster_t, raster_j = rasters()
    js, ts = scene_pair(32, seed=6)
    cams = [camera_pair([0.4, -0.3, -2.2]), camera_pair([-1.6, 0.2, -1.5])]
    images = [target_image(c[1], seed=9 + i) for i, c in enumerate(cams)]

    out_j, hist_j = jtrain.train(js, [c[1] for c in cams], images, cfg,
                                 raster_j)
    out_t, hist_t = train.train(ts, [c[0] for c in cams], images,
                                train.TrainConfig(**vars(cfg)), raster_t,
                                device="cpu")
    assert isinstance(hist_t["loss"], list)
    assert hist_t["n_gaussians"] == hist_j["n_gaussians"]
    n = hist_t["n_gaussians"]
    assert n[19] == 32 and n[20] != 32          # the round changed N
    np.testing.assert_allclose(hist_t["loss"], hist_j["loss"], rtol=1e-4)
    assert_params_close(out_t, out_j, cfg, 0.1, "trained scene")


def test_train_scene_inputs_match_the_script():
    """``entry.train_scene_inputs``: ``benchmarks/train_scene.py``'s ring
    cameras, ground truth, degraded init and configs (small N)."""
    spec = importlib.util.spec_from_file_location(
        "train_scene", ROOT / "benchmarks" / "train_scene.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    gt, init, cams, cfg, raster = entry.train_scene_inputs(
        n=200, views=8, res=128, device="cpu")
    for cam, jcam in zip(cams, script.ring_cameras(8, 3.2, -1.2, 128)):
        for a, b in ((cam.pose.q, jcam.pose.q), (cam.pose.t, jcam.pose.t),
                     (cam.fx, jcam.fx), (cam.cy, jcam.cy)):
            np.testing.assert_array_equal(np_of(a), np.asarray(b))
        assert (cam.width, cam.height) == (128, 128)
    jgt = jloaders.synthetic_scene(200, seed=0, extent=0.9,
                                   scale_range=(0.02, 0.06), sh_degree=1)
    for a, b in zip(gt, jgt):
        np.testing.assert_array_equal(np_of(a), np.asarray(b))
    rng = np.random.default_rng(1)                # the script's draws
    keep = rng.choice(200, size=100, replace=False)
    np.testing.assert_array_equal(np_of(init.means), np.asarray(
        np.asarray(jgt.means)[keep] + rng.normal(0, 0.03, (100, 3)),
        np.float32))
    assert init.sh_rest.shape == (100, 3, 3) and not init.sh_dc.any()
    assert (cfg.iters, cfg.refine_every, cfg.ssim_lambda) == (2000, 400, 0.2)
    assert cfg.lr_means == 1.6e-4 * 6.0 and cfg.lr_opacities == 5e-2
    assert (raster.tile_capacity, raster.term_eps, raster.chunk) == \
        (512, 1e-4, 128)


@pytest.mark.parametrize("call", ["train", "render_view",
                                  "train_scene_inputs"])
def test_entry_points_default_to_cuda(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, ts = scene_pair(8)
    cam, _ = camera_pair([0.0, 0.0, -3.0])
    calls = {
        "train": lambda: train.train(ts, [cam], [np.zeros((RES, RES, 3))]),
        "render_view": lambda: train.render_view(ts, cam),
        "train_scene_inputs": lambda: entry.train_scene_inputs(n=20),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[call]()
