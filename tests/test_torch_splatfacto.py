"""The trainer's step API (``splat.train.Trainer``) against the benchmark's
plain splatfacto reference (``perfbench/reference/splatfacto.py``), on the
CPU at a small size, and binning past the old (T+1)·N < 2^31 guard.

The scene is the benchmark's splatfacto capture law
(``perfbench/reference/splatfacto_scene.py``) at 3,000 SH-3 gaussians and
4 views of 64×48, seeded, with list capacity enough that nothing is cut.

Tolerances: the program and the reference compute the same float32
projection, SH and composite in other orders, so a pixel whose α sits at
the 1/255 floor or the 3σ cutoff can switch on one side alone, moving the
pixel by up to e^-4.5 ≈ 0.0111 of a colour: the images within 0.012, the
loss rtol 1e-5, each field's gradient within 1e-2 of its largest (a
switched pixel moves a small gaussian's gradient by its own share; the
largest gap seen is 2.5e-3).  Adam is held on the program's own
gradients: the updated fields within 1e-2 of their group's learning rate
(a float32 rounding of p − lr·m̂/(√v̂ + ε)).  The cull is exact but within
1e-4 of a threshold.
"""

import json

import numpy as np
import pytest
import torch

from perfbench.reference import splat_render as sr
from perfbench.reference import splatfacto as ref
from perfbench.reference.splatfacto_scene import orbit, scenes
from perfbench.systems.splatfacto import FIELDS, LR_KEYS, train_config
from sim_a_splat_torch.ops import rasterize_tiles as tiles
from sim_a_splat_torch.ops.projection import Camera, Projected
from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
from sim_a_splat_torch.ops.transforms import SE3
from sim_a_splat_torch.splat import refine, train
from sim_a_splat_torch.splat.scene import GaussianScene

CONFIG = "perfbench/configs/splatfacto_1m_sh3_1600.json"
START = 15000
GRAD_REL = 1e-2


def small_config(**kw) -> dict:
    from perfbench.reference.pusharm import ROOT
    cfg = json.loads((ROOT / CONFIG).read_text())
    cfg.update(n_gaussians=3000, views=4, resolution=[48, 64],
               tile_capacity=2048, **kw)
    cfg["orbit"] = dict(cfg["orbit"], focal_px=80.0)
    return cfg


def raster_of(cfg) -> RasterConfig:
    return RasterConfig(
        tile_size=cfg["tile_size"], tile_capacity=cfg["tile_capacity"],
        max_tiles_per_gaussian=cfg["max_tiles_per_gaussian"],
        sigma_cutoff=cfg["sigma_cutoff"], term_eps=cfg["term_eps"],
        buckets=tuple(tuple(b) for b in cfg["buckets"]))


@pytest.fixture(scope="module")
def capture():
    """(cfg, ground truth, scene under training, program cameras, views,
    targets): the small capture, the targets the program's render of the
    ground truth."""
    cfg = small_config()
    gt, init = scenes(cfg, 23, torch.Generator().manual_seed(23))
    v = orbit(cfg, "cpu")
    cams = [Camera(SE3(v.q[i], v.center[i]), torch.tensor(v.fx),
                   torch.tensor(v.fy), torch.tensor(v.cx), torch.tensor(v.cy),
                   v.width, v.height) for i in range(cfg["views"])]
    g = GaussianScene(**gt)
    with torch.no_grad():
        targets = [train.render_view(g, c, raster_of(cfg), device="cpu")
                   for c in cams]
    return cfg, gt, init, cams, v, [torch.as_tensor(t) for t in targets]


def ref_camera(v, i):
    return ref.camera(v.q[i], v.center[i], v.fx, v.fy, v.cx, v.cy, v.width,
                      v.height)


def lr_of(cfg, k, t_means):
    return (ref.means_lr(cfg, t_means) if k == "means"
            else cfg["lr"][LR_KEYS[k]])


@pytest.mark.parametrize("view", [0, 1, 2, 3])
def test_trainer_step_matches_reference(capture, view):
    """One trainer step at the window's start (iteration 15,000, a fresh
    optimizer): the render, the loss and every field's gradient against
    the reference's blocked step; the updated fields against the
    reference's Adam of the program's gradients at the means schedule's
    position 15,000; nothing cut."""
    cfg, _, init, cams, v, targets = capture
    tr = train.Trainer(GaussianScene(**init), train_config(cfg),
                       raster_of(cfg), start_step=START, device="cpu")
    live = tr.scene
    before = {k: p.detach().clone() for k, p in zip(FIELDS, live)}
    loss = tr.step(cams[view], targets[view])
    assert int(tr.aux.n_overflowed_tiles) == 0
    assert int(tr.aux.n_slot_truncated) == 0
    want = ref.step(init, ref_camera(v, view), targets[view],
                    ref.raster_of(cfg), 3, cfg["ssim_lambda"],
                    cfg["background"])
    assert want.overflowed == 0 and want.slot_truncated == 0
    torch.testing.assert_close(tr.image, want.image, atol=0.012, rtol=0)
    np.testing.assert_allclose(float(loss), float(want.loss), rtol=1e-5)
    for k, p in zip(FIELDS, live):
        g = want.grads[k]
        gap = float((p.grad - g).abs().max()) / float(g.abs().max())
        assert gap <= GRAD_REL, f"{k}: gradient gap {gap}"
        lr = lr_of(cfg, k, START)
        upd, _, _ = ref.adam(before[k], p.grad, torch.zeros_like(p),
                             torch.zeros_like(p), 1, lr)
        err = float((p.detach() - upd).abs().max())
        assert err <= 1e-2 * lr, f"{k}: update {err} > 1e-2 × {lr}"


def test_cull_round_keeps_the_reference_set(capture):
    """A step that reaches a round past ``stop_split_at`` culls by the
    thresholds alone: its kept set is the reference's cull of the
    reference's Adam update of the program's gradients, and the new scene
    is the updated fields' kept rows."""
    cfg, _, init, cams, v, targets = capture
    tcfg = train_config(cfg)
    start = 2 * tcfg.refine_every * (START // (2 * tcfg.refine_every) + 1) - 1
    tr = train.Trainer(GaussianScene(**init), tcfg, raster_of(cfg),
                       start_step=start, device="cpu")
    live = tr.scene
    before = {k: p.detach().clone() for k, p in zip(FIELDS, live)}
    tr.step(cams[0], targets[0])
    assert tr.keep is not None and tr.n_refines == 1
    post = {k: ref.adam(before[k], p.grad, torch.zeros_like(p),
                        torch.zeros_like(p), 1, lr_of(cfg, k, start))[0]
            for k, p in zip(FIELDS, live)}
    r = cfg["refine"]
    want = ref.cull_keep(post, r["cull_alpha_thresh"], r["cull_scale_thresh"])
    band = ref.cull_band(post, r["cull_alpha_thresh"],
                         r["cull_scale_thresh"], cfg["cull_band"])
    assert int(((tr.keep != want) & ~band).sum()) == 0
    assert int((~tr.keep).sum()) > 0          # the perturbation culls some
    for k, p in zip(FIELDS, live):
        torch.testing.assert_close(getattr(tr.scene, k).detach(),
                                   p.detach()[tr.keep], atol=0, rtol=0)


def _old_train(scene, cams, images, config, raster):
    """``train()``'s loop as it was before the step API: the same ops."""
    scene = train.parameters(scene, torch.device("cpu"))
    optimizer = train.make_optimizer(config, scene)
    step = train.make_train_step(config, raster, optimizer)
    losses, n_gaussians = [], []
    grad_acc = torch.zeros(scene.num_gaussians)
    n_acc = n_refines = 0
    for it in range(config.iters):
        v = it % len(cams)
        scene, loss, gnorm = step(scene, cams[v], images[v])
        grad_acc += gnorm
        n_acc += 1
        losses.append(loss)
        n_gaussians.append(scene.num_gaussians)
        if (config.refine_every and it + 1 >= config.refine_start
                and (it + 1) % config.refine_every == 0
                and it + 1 < config.iters):
            new, _ = train.refine_scene(scene, grad_acc / max(n_acc, 1),
                                        config)
            n_refines += 1
            if (config.reset_alpha_every
                    and n_refines % config.reset_alpha_every == 0):
                cap = float(np.log(2 * config.cull_alpha_thresh
                                   / (1 - 2 * config.cull_alpha_thresh)))
                new = new._replace(logit_opacities=torch.clamp(
                    new.logit_opacities, max=cap))
            scene = train.parameters(new)
            optimizer = train.make_optimizer(config, scene)
            step = train.make_train_step(config, raster, optimizer)
            grad_acc = torch.zeros(scene.num_gaussians)
            n_acc = 0
    return scene, {"loss": torch.stack(losses).tolist(),
                   "n_gaussians": n_gaussians}


def _refining_config(**kw):
    return train.TrainConfig(iters=24, refine_every=6, refine_start=6,
                             densify_grad_thresh=2e-4,
                             densify_size_thresh=1e-3, reset_alpha_every=2,
                             **kw)


def test_train_on_the_step_api_matches_the_loop_it_replaced(capture):
    """``train()`` over ``Trainer``: the same scene, bit for bit, and the
    same history as the loop it replaced, through rounds that duplicate,
    split, cull and reset opacities.  One intra-op thread: the CPU's
    threaded reductions need not repeat their last bit from run to run."""
    cfg, _, init, cams, _, targets = capture
    small = GaussianScene(**init).select(np.arange(0, 3000, 4))
    config = _refining_config()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want, hist_w = _old_train(small, cams, targets, config,
                                  raster_of(cfg))
        got, hist_g = train.train(small, cams, targets, config,
                                  raster_of(cfg), device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert hist_g == hist_w
    assert len(set(hist_g["n_gaussians"])) > 2     # the rounds changed N
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b.detach(), atol=0, rtol=0)


def test_stop_split_at_rounds_only_cull(capture, monkeypatch):
    """Rounds from ``stop_split_at`` on duplicate, split and reset
    nothing: each keeps the updated fields' rows its cull mask names; the
    round before it densifies."""
    cfg, _, init, cams, _, targets = capture
    small = GaussianScene(**init).select(np.arange(0, 3000, 4))
    config = _refining_config(stop_split_at=12)
    tr = train.Trainer(small, config, raster_of(cfg), device="cpu")
    for it in range(6):
        tr.step(cams[it % 4], targets[it % 4])
    assert tr.num_gaussians > small.num_gaussians      # round 6 densified

    def refused(*a, **kw):
        raise AssertionError("a round past stop_split_at densified")

    monkeypatch.setattr(refine, "duplicate_gaussians", refused)
    monkeypatch.setattr(refine, "split_gaussians", refused)
    for it in range(6, 18):
        live, n = tr.scene, tr.num_gaussians
        tr.step(cams[it % 4], targets[it % 4])
        if tr.step_count % 6 == 0:
            assert tr.num_gaussians == int(tr.keep.sum()) <= n
            assert tr.keep.shape == (n,)
            torch.testing.assert_close(
                tr.scene.logit_opacities.detach(),
                live.logit_opacities.detach()[tr.keep], atol=0, rtol=0)


def test_bin_gaussians_past_2_31():
    """~1,000 projected gaussians on a 1,500 × 1,500-tile grid, (T+1)·N
    past 2^31: the lists and counts are the lexicographic (tile, depth
    rank) sort of every covered tile's key, and the reference's
    ``bin_tiles``."""
    tx = ty = 1500
    T, ts, n, M = tx * ty, 16, 1000, 9
    assert (T + 1) * n > 2**31
    rng = np.random.default_rng(7)
    f = np.float32
    xy = rng.uniform(-20, tx * ts + 20, (n, 2)).astype(f)
    xy[:200] = rng.uniform(100, 160, (200, 2))       # a crowded corner
    depth = rng.uniform(1, 50, n).astype(f)
    depth[:300] = 5.0                                # ties: index order
    radius = np.ceil(rng.uniform(1, 20, n)).astype(f)
    valid = rng.uniform(size=n) > 0.05
    radius[~valid] = 0
    d = dict(xy=xy, depth=depth, conic=np.ones((n, 3), f), radius=radius,
             valid=valid)
    proj = Projected(**{k: torch.as_tensor(a) for k, a in d.items()})
    cfg = RasterConfig(tile_size=ts, tile_capacity=64,
                       max_tiles_per_gaussian=M, buckets=((4, 0.8), (9, 0.2)))
    stile, sgid, starts, counts, trunc = tiles._bin_gaussians(proj, cfg, tx,
                                                              ty)
    # the lexicographic sort, gaussian by gaussian
    rank = np.empty(n, np.int64)
    rank[np.argsort(depth, kind="stable")] = np.arange(n)
    lists = sr.bin_tiles(sr.Projected(*(torch.as_tensor(d[k]) for k in (
        "xy", "depth", "conic", "radius", "valid"))), ts, tx, ty, 64, M,
        cfg.buckets)
    keys = []
    ids = lists.ids.numpy()
    for t in np.flatnonzero(lists.counts.numpy()):
        keys += [(t, rank[g], g) for g in ids[t][ids[t] >= 0]]
    keys.sort()
    E = len(keys)
    assert E and int(trunc) == lists.slot_truncated
    np.testing.assert_array_equal(stile[:E].numpy(), [k[0] for k in keys])
    np.testing.assert_array_equal(sgid[:E].numpy(), [k[2] for k in keys])
    assert bool((stile[E:] == T).all())
    np.testing.assert_array_equal(counts.numpy(), lists.counts.numpy())
    np.testing.assert_array_equal(
        starts.numpy(), np.cumsum(counts.numpy()) - counts.numpy())


@pytest.mark.parametrize("rows", [1, 2])
def test_reference_blocked_vjp_matches_unblocked(capture, rows):
    """The reference's gradient in bands of tile rows against autograd
    through the whole image at once: image and loss equal, each field's
    gradient within 1e-5 of its largest (the sums' order)."""
    cfg, _, init, _, v, targets = capture
    args = (init, ref_camera(v, 1), targets[1], ref.raster_of(cfg), 3,
            cfg["ssim_lambda"], cfg["background"])
    blocked = ref.step(*args, rows_per_block=rows)
    whole = ref.step(*args, rows_per_block=None)
    torch.testing.assert_close(blocked.image, whole.image, atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(float(blocked.loss), float(whole.loss),
                               rtol=1e-6)
    for k, g in whole.grads.items():
        gap = float((blocked.grads[k] - g).abs().max())
        assert gap <= 1e-5 * float(g.abs().max()), k


@pytest.mark.parametrize("view", [0, 2])
def test_reference_render_of_the_targets(capture, view):
    """The reference's render alone (the check's render of the targets)
    is its step's image, exactly, and reads as the program's render of
    the ground truth, which both sides train against (the step's image
    tolerance)."""
    cfg, gt, _, _, v, targets = capture
    img = ref.render(gt, ref_camera(v, view), ref.raster_of(cfg), 3,
                     cfg["background"])
    want = ref.step(gt, ref_camera(v, view), targets[view],
                    ref.raster_of(cfg), 3, cfg["ssim_lambda"],
                    cfg["background"])
    torch.testing.assert_close(img, want.image, atol=0, rtol=0)
    torch.testing.assert_close(img, targets[view], atol=0.012, rtol=0)


def test_trainer_spans_and_counters(capture):
    """A trainer step is one ``step.splat`` root over ``train.loss``
    (``train.render`` in it), ``train.backward`` and ``train.optimizer``,
    and ``train.refine`` where it reaches a round; ``train.gaussians``
    reads N after each step, ``train.culled`` moves by a round's culls."""
    from sim_a_splat_torch.utils import profiling
    cfg, _, init, cams, _, targets = capture
    tcfg = train_config(cfg)
    start = tcfg.refine_every * (START // tcfg.refine_every + 1) - 2
    was = profiling.enabled()
    profiling.clear()
    profiling.enable(True)
    try:
        tr = train.Trainer(GaussianScene(**init), tcfg, raster_of(cfg),
                           start_step=start, device="cpu")
        tr.step(cams[0], targets[0])
        tr.step(cams[1], targets[1])
        roots = profiling.roots("step.splat")
        counts = profiling.counter_events()
    finally:
        profiling.enable(was)
        profiling.clear()
    assert len(roots) == 2
    for r in roots:
        for name in ("train.loss", "train.render", "train.backward",
                     "train.optimizer", "render.bin", "render.k1f",
                     "render.k1b"):
            assert r.calls.get(name) == 1, (name, r.calls)
    assert "train.refine" not in roots[0].calls
    assert roots[1].calls["train.refine"] == 1
    n = [c.value for c in counts if c.name == "train.gaussians"]
    culled = [c for c in counts if c.name == "train.culled"]
    assert n == [3000, tr.num_gaussians]
    assert [(c.step, c.value) for c in culled] == [
        (roots[1].step, 3000 - tr.num_gaussians)]
