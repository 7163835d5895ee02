"""In-framework gaussian-splat training loop.

Port of ``sim_a_splat_tpu/splat/train.py``: photometric training of a
:class:`GaussianScene` against posed RGB views through the port's tile
rasterizer (kernel K1: K1f in the forward, K1b in the backward on the
card), splatfacto's per-parameter-group learning rates, and periodic
densify/cull rounds built from ``splat/refine.py``.

- The optimizer is ``torch.optim.Adam`` with one parameter group per scene
  field, named after it; its update is the reference's ``optax.adam``
  (lr·m̂ / (√v̂ + 1e-8)).  ``means`` follows
  ``optax.exponential_decay(lr_means, iters, lr_means_final / lr_means)``:
  update t, counted from 0, takes lr_means · rate^(t / iters)
  (:func:`means_lr`), set from the group's update count before each step.
- The train step is forward → loss → backward → per-gaussian ‖∇means‖ (the
  densify statistic, taken before the update) → ``optimizer.step()``.  The
  scene's tensors are the optimizer's parameters, updated in place, and
  the optimizer holds the moments (the reference threads ``opt_state``
  through its step).
- ``train`` sums ‖∇means‖ on the device and reads the losses once, at the
  end: the loop itself makes the host wait for the device only in a
  refinement round (and where ``log_every`` or ``eval_fn`` asks).  After
  every round the optimizer is built anew, as the reference rebuilds it:
  fresh moments, and the means schedule starts again from ``lr_means``.
- :class:`Trainer` holds a run one iteration at a time (the scene, the
  optimizer, the densify accumulators and the count of iterations done):
  ``Trainer.step(camera, image)`` is one iteration, with the refinement
  round run inside the step that reaches it; ``start_step`` starts the
  count part-way through a run (the means schedule of its first optimizer
  and ``stop_split_at`` read it).  ``train`` is a loop over it.  From
  ``stop_split_at`` on a round only culls (splatfacto's
  ``continue_cull_post_densification``).
- Tracing (``utils/profiling.py``): a step is the root span ``step.splat``
  over ``train.loss`` (the render, ``train.render``, and the loss),
  ``train.backward``, ``train.optimizer`` (‖∇means‖ and Adam) and, in a
  round, ``train.refine``; the counter ``train.gaussians`` moves by each
  step's change of N (one trainer in a process: it reads N) and
  ``train.culled`` by the gaussians a round drops, counted where the round
  reads the device anyway.  Outside a round nothing here waits for the
  device.

Departures from splatfacto (``nerfstudio/models/splatfacto.py``), kept
because the JAX package has them:

- the densify statistic is the world-space ‖∇means‖ averaged over the
  steps since the last round, not the screen-space ‖∇xy‖;
- the optimizer is built anew after every round: its moments and the means
  schedule restart (splatfacto removes the culled rows from its moments);
- Adam's ε is 1e-8, not 1e-15;
- the background is fixed (``TrainConfig.background``), not random.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from sim_a_splat_torch import resolve_device
from sim_a_splat_torch.ops.projection import Camera
from sim_a_splat_torch.ops.rasterize_tiles import (
    RasterConfig, rasterize_raw_sh,
)
from sim_a_splat_torch.ops.ssim import ssim_loss
from sim_a_splat_torch.splat import refine
from sim_a_splat_torch.splat.scene import GaussianScene
from sim_a_splat_torch.utils.profiling import count, span


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Splatfacto-default hyperparameters (the reference's ``TrainConfig``,
    the same fields and defaults)."""

    iters: int = 300
    # per-group LRs: splatfacto defaults (means decay exponentially)
    lr_means: float = 1.6e-4
    lr_means_final: float = 1.6e-6
    lr_sh_dc: float = 2.5e-3
    lr_sh_rest: float = 1.25e-4
    lr_opacities: float = 5e-2
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    # refinement (densify/cull) — splatfacto semantics, simplified schedule
    refine_every: int = 0               # 0 ⇒ no refinement rounds
    refine_start: int = 50
    densify_grad_thresh: float = 4e-4   # on accumulated ‖∇means‖
    densify_size_thresh: float = 0.01   # world units: split above, dup below
    cull_alpha_thresh: float = 0.1
    cull_scale_thresh: float = 0.5
    n_split_samples: int = 2
    l1_weight: float = 1.0              # L1 + (1-w)·L2 photometric mix
    # splatfacto loss: (1−λ)·photometric + λ·(1−SSIM), λ = ssim_lambda
    ssim_lambda: float = 0.2
    # every `reset_alpha_every` refinement rounds, cap opacities at
    # 2·cull_alpha_thresh (splatfacto's opacity reset); 0 ⇒ off
    reset_alpha_every: int = 0
    background: tuple = (0.0, 0.0, 0.0)
    # a round at iteration count ≥ stop_split_at only culls: no duplication,
    # split or opacity reset (splatfacto's stop_split_at); None ⇒ never
    stop_split_at: Optional[int] = None


def _default_raster() -> RasterConfig:
    return RasterConfig(tile_capacity=256, max_tiles_per_gaussian=16,
                        chunk=64, sigma_cutoff=3.0)


def means_lr(config: TrainConfig, t: int) -> float:
    """The learning rate of the means at update ``t`` (counted from 0):
    ``optax.exponential_decay(lr_means, iters, lr_means_final / lr_means)``,
    continuous, without an end clip."""
    if config.iters <= 0:
        return config.lr_means
    rate = config.lr_means_final / config.lr_means
    return config.lr_means * rate ** (t / config.iters)


def parameters(scene: GaussianScene, device=None) -> GaussianScene:
    """A copy of ``scene`` (on ``device``) whose fields are leaf tensors that
    require grad: the parameters of :func:`make_optimizer`."""
    return GaussianScene(*(
        None if f is None else
        f.detach().to(device or f.device, torch.float32).clone()
        .requires_grad_() for f in scene))


def _detached(scene: GaussianScene) -> GaussianScene:
    return GaussianScene(*(None if f is None else f.detach() for f in scene))


def make_optimizer(config: TrainConfig, scene: GaussianScene,
                   start: int = 0):
    """Per-field ``torch.optim.Adam`` over the parameters ``scene`` (see
    :func:`parameters`), splatfacto's LR table; no group for a missing
    ``sh_rest``.  The means group carries its schedule (``means_lr``), its
    update t taking ``means_lr(config, start + t)``."""
    lrs = {"means": config.lr_means, "quats": config.lr_quats,
           "log_scales": config.lr_scales,
           "logit_opacities": config.lr_opacities,
           "sh_dc": config.lr_sh_dc, "sh_rest": config.lr_sh_rest}
    groups = [{"params": [getattr(scene, name)], "lr": lr, "name": name}
              for name, lr in lrs.items() if getattr(scene, name) is not None]
    for group in groups:
        if group["name"] == "means":
            group["schedule"] = lambda t: means_lr(config, start + t)
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)


def _apply_schedules(optimizer) -> None:
    """Set each scheduled group's lr for its next update (its count of
    updates so far, held on the host by ``torch.optim.Adam``)."""
    for group in optimizer.param_groups:
        if "schedule" in group:
            state = optimizer.state.get(group["params"][0], {})
            group["lr"] = group["schedule"](int(state.get("step", 0)))


def adam_state_from_numpy(mu, nu, count, optimizer):
    """Carry an ``optax.adam`` state across into ``optimizer`` (built by
    :func:`make_optimizer`): ``mu`` and ``nu`` map a field name to its first
    and second moments (numpy), ``count`` is the number of updates done (an
    int, or a mapping by field name).  Returns ``optimizer``."""
    for group in optimizer.param_groups:
        name = group["name"]
        p = group["params"][0]
        n = count[name] if isinstance(count, dict) else count

        def on(a):       # a copy: the optimizer updates it in place
            return torch.tensor(np.asarray(a, np.float32), device=p.device)

        optimizer.state[p] = {"step": torch.tensor(float(n)),
                              "exp_avg": on(mu[name]),
                              "exp_avg_sq": on(nu[name])}
    return optimizer


def _render_loss(scene: GaussianScene, camera: Camera, image: torch.Tensor,
                 config: TrainConfig, raster: RasterConfig):
    """(loss, render (H, W, 3), RasterAux): see :func:`train_loss`."""
    bg = torch.as_tensor(config.background, dtype=torch.float32,
                         device=image.device)
    with span("train.render"):
        img, aux = rasterize_raw_sh(
            scene.means, scene.quats, scene.log_scales, scene.sh_coeffs(),
            scene.opacities(), camera, scene.sh_degree, raster,
            background=bg)
    err = img - image
    photometric = (config.l1_weight * torch.mean(torch.abs(err))
                   + (1.0 - config.l1_weight) * torch.mean(err ** 2))
    if config.ssim_lambda <= 0.0:
        return photometric, img, aux
    return ((1.0 - config.ssim_lambda) * photometric
            + config.ssim_lambda * ssim_loss(img, image)), img, aux


def train_loss(scene: GaussianScene, camera: Camera, image: torch.Tensor,
               config: TrainConfig, raster: RasterConfig) -> torch.Tensor:
    """(1 − λ)·(w·mean|err| + (1 − w)·mean(err²)) + λ·(1 − SSIM) of the
    render of ``scene`` from ``camera`` against ``image`` (H, W, 3)."""
    return _render_loss(scene, camera, image, config, raster)[0]


def _train_step(scene, camera, image, config, raster, optimizer):
    """One update of the parameters ``scene`` in place → (loss, ‖∇means‖
    (N,), the render, its RasterAux), all without waiting for the
    device."""
    with span("train.loss"):
        optimizer.zero_grad(set_to_none=True)
        loss, img, aux = _render_loss(scene, camera, image, config, raster)
    with span("train.backward"):
        loss.backward()
    with span("train.optimizer"):
        gnorm = torch.linalg.vector_norm(scene.means.grad, dim=-1)
        _apply_schedules(optimizer)
        optimizer.step()
    return loss.detach(), gnorm, img.detach(), aux


def make_train_step(config: TrainConfig, raster: RasterConfig,
                    optimizer) -> Callable:
    """``(scene, camera, image) → (scene, loss, mean_grad_norm)``: one
    update of the parameters ``scene`` (in place) by ``optimizer``;
    ``mean_grad_norm`` is per-gaussian ‖∇means‖ (the densify statistic).
    The fields' gradients stay in their ``.grad``."""

    def step(scene, camera, image):
        loss, gnorm, _, _ = _train_step(scene, camera, image, config, raster,
                                        optimizer)
        return scene, loss, gnorm

    return step


def refine_scene(scene: GaussianScene, grad_acc, config: TrainConfig,
                 densify: bool = True):
    """One splatfacto refinement round → (the new scene, the cull's (N',)
    keep mask over the scene it culled).  Where ``densify``, duplicate the
    small high-grad gaussians, then split the large ones (the copies never
    split); then cull the transparent and oversized ones.  ``grad_acc``
    (N,) is the mean ‖∇means‖ since the last round."""
    scene = _detached(scene)
    if densify:
        grad_acc = torch.as_tensor(grad_acc, device=scene.means.device)
        scales = scene.scales().amax(-1)
        high = grad_acc > config.densify_grad_thresh
        split_mask = high & (scales > config.densify_size_thresh)
        dup_mask = high & ~split_mask
        if bool(dup_mask.any()):
            scene = refine.duplicate_gaussians(scene, dup_mask)
            split_mask = torch.cat([split_mask, split_mask.new_zeros(
                int(dup_mask.sum()))])
        if bool(split_mask.any()):
            scene = refine.split_gaussians(
                scene, split_mask, n_split_samples=config.n_split_samples)
    keep = refine.cull_mask(scene, config.cull_alpha_thresh,
                            config.cull_scale_thresh)
    return refine.rows(scene, keep), keep


class Trainer:
    """A training run held one iteration at a time: ``scene`` (the
    optimizer's parameters, leaf tensors on ``device``), ``optimizer``, the
    densify accumulators and ``step_count``, the iterations done (from
    ``start_step``).  After a step, ``image`` and ``aux`` are its render
    and RasterAux, and ``keep`` is the last round's (N,) mask of the
    gaussians its cull kept."""

    def __init__(self, scene: GaussianScene,
                 config: TrainConfig = TrainConfig(),
                 raster: Optional[RasterConfig] = None, start_step: int = 0,
                 device="cuda"):
        self.config = config
        self.raster = _default_raster() if raster is None else raster
        self.step_count = int(start_step)
        self.n_refines = 0
        self.image = self.aux = self.keep = None
        self._counted = 0
        self._reset(parameters(scene, resolve_device(device)),
                    start=self.step_count)

    def _reset(self, scene: GaussianScene, start: int = 0) -> None:
        self.scene = scene
        self.optimizer = make_optimizer(self.config, scene, start)
        self.grad_acc = torch.zeros(scene.num_gaussians,
                                    device=scene.means.device)
        self.n_acc = 0

    @property
    def num_gaussians(self) -> int:
        return self.scene.num_gaussians

    def _densifies(self, r: int) -> bool:
        """Whether a round after ``r`` iterations densifies."""
        stop = self.config.stop_split_at
        return stop is None or r < stop

    def _round_due(self) -> bool:
        c, r = self.config, self.step_count
        return bool(c.refine_every and r >= c.refine_start
                    and r % c.refine_every == 0 and r < c.iters)

    def step(self, camera: Camera, image: torch.Tensor) -> torch.Tensor:
        """One iteration against ``image`` (H, W, 3) seen from ``camera``,
        and the refinement round where it reaches one; returns the loss (a
        device scalar)."""
        with span("step.splat"):
            loss, gnorm, self.image, self.aux = _train_step(
                self.scene, camera, image, self.config, self.raster,
                self.optimizer)
            self.step_count += 1
            if self._densifies(self.step_count):
                self.grad_acc += gnorm
                self.n_acc += 1
            if self._round_due():
                self._refine()
            n = self.num_gaussians
            count("train.gaussians", n - self._counted)
            self._counted = n
        return loss

    def _refine(self) -> None:
        c = self.config
        with span("train.refine"):
            densify = self._densifies(self.step_count)
            new, self.keep = refine_scene(
                self.scene, self.grad_acc / max(self.n_acc, 1), c, densify)
            count("train.culled", self.keep.numel() - new.num_gaussians)
            self.n_refines += 1
            if (densify and c.reset_alpha_every
                    and self.n_refines % c.reset_alpha_every == 0):
                # splatfacto opacity reset: cap at 2·cull_alpha_thresh
                # (logit space) so every gaussian re-earns its opacity
                cap = float(np.log(2 * c.cull_alpha_thresh
                                   / (1 - 2 * c.cull_alpha_thresh)))
                new = new._replace(logit_opacities=torch.clamp(
                    new.logit_opacities, max=cap))
            self._reset(parameters(new))


def _on(image, dev) -> torch.Tensor:
    if torch.is_tensor(image):
        return image.to(dev, torch.float32)
    return torch.as_tensor(np.asarray(image, np.float32), device=dev)


def train(
    scene: GaussianScene,
    cameras: Sequence[Camera],
    images: Sequence,
    config: TrainConfig = TrainConfig(),
    raster: Optional[RasterConfig] = None,
    log_every: int = 0,
    log_fn: Callable = print,
    eval_every: int = 0,
    eval_fn: Optional[Callable] = None,
    device="cuda",
):
    """Train ``scene`` against posed views on ``device``.  Returns (scene,
    history): the trained scene (detached) and a dict of Python lists,
    ``loss`` and ``n_gaussians`` per iteration.

    Views are visited round-robin (splatfacto samples one camera per step).
    ``eval_fn(scene, it)`` is called every ``eval_every`` iterations, after
    the iteration and its refinement round (e.g. a PSNR probe for a
    training curve).  ``n_gaussians`` is each iteration's N, before its
    round.
    """
    dev = resolve_device(device)
    if len(cameras) != len(images) or not cameras:
        raise ValueError("need equally many cameras and images (≥1)")
    cams = [c.to(dev) for c in cameras]
    imgs = [_on(im, dev) for im in images]
    trainer = Trainer(scene, config, raster, device=dev)
    losses, n_gaussians = [], []
    for it in range(config.iters):
        v = it % len(cams)
        n_gaussians.append(trainer.num_gaussians)
        losses.append(trainer.step(cams[v], imgs[v]))
        if log_every and (it + 1) % log_every == 0:
            log_fn(f"iter {it + 1}: loss {float(losses[-1]):.5f} "
                   f"N={n_gaussians[-1]}")
        if eval_every and eval_fn is not None and (it + 1) % eval_every == 0:
            eval_fn(_detached(trainer.scene), it + 1)
    history = {"loss": torch.stack(losses).tolist() if losses else [],
               "n_gaussians": n_gaussians}
    return _detached(trainer.scene), history


def psnr(img, ref) -> float:
    """Peak signal-to-noise ratio in dB over [0, 1] images."""
    def np_of(a):
        return a.detach().cpu().numpy() if torch.is_tensor(a) else \
            np.asarray(a)

    mse = float(np.mean((np_of(img) - np_of(ref)) ** 2))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def render_view(scene: GaussianScene, camera: Camera,
                raster: Optional[RasterConfig] = None,
                background=(0.0, 0.0, 0.0), device="cuda") -> np.ndarray:
    """(H, W, 3) numpy render of ``scene`` from ``camera`` on ``device``."""
    dev = resolve_device(device)
    if raster is None:
        raster = _default_raster()
    scene = _detached(scene).to(dev)
    img, _ = rasterize_raw_sh(
        scene.means, scene.quats, scene.log_scales, scene.sh_coeffs(),
        scene.opacities(), camera.to(dev), scene.sh_degree, raster,
        background=torch.as_tensor(background, dtype=torch.float32,
                                   device=dev))
    return img.cpu().numpy()
