"""splatfacto's post-densification training, driven through the program's
trainer (``splat.train.Trainer``): one iteration a step, closed loop.

The run stands at ``window.start_step`` (15,000) of a ``max_num_iterations``
(30,000) run: full resolution, SH degree 3, no split or duplication any
more (``stop_split_at``), a cull round every ``refine_every`` steps, the
scene at its final size.  Inputs from the seed
(``perfbench/reference/splatfacto_scene.py``): the ground-truth scene and
the scene under training, the 300 cameras, and the views' order (the
traffic's ``walk``: ``epoch_shuffle``, nerfstudio's per-epoch shuffle).
The set-up renders the ground truth from every camera with the program's
forward render and keeps the views on the device as uint8 (the targets
both the program and the reference train against); a step converts its
view to float32.  The ground truth itself stays on the host, so that the
check renders the sampled views again with the reference.

Each step of the window is one trainer step: the render (projection, SH,
binning, the gather, K1f), the L1 + SSIM loss, the backward (K1b, the
gather's scatter, SSIM's), Adam over the six fields and, every
``refine_every`` steps, the cull round.  ``restart`` starts the run again
from the scene under training, so the window's first step is iteration
``start_step``.

The check follows the program from its own input states.  The window's
first step, two drawn steps, its first cull round and, after the window,
one more step from the state the run ended in are recorded: the scene and
Adam's moments before the step, and after it the render, the loss, the
gradients, the updated fields, the round's kept set and the binning's
counters.  A record is copied to host buffers pinned at set-up, so that
the device's peak is the trainer's own.  The reference
(``perfbench/reference/splatfacto.py``) renders the recorded scene and
takes the loss and the gradients itself; applies Adam to the program's
own gradients (so that the update is judged by itself); culls the fields
it updated; and renders the sampled views' ground truth, against which
the program's targets are held (``target_gap``, both as kept, in uint8).
``truncated`` counts the cuts of the targets' renders and of the sampled
steps.
"""

from __future__ import annotations

import torch

from perfbench.harness import traffic as traffic_gen
from perfbench.reference import splatfacto as ref
from perfbench.reference.splatfacto_scene import orbit, scenes, view_order

# the program's tracer's root span of a trainer step
ROOT_SPAN = "step.splat"
SPANS = {}
# the program's spans whose kernels the device metrics read: the render
# (and in it the binning), the loss, the backward, Adam and the round
SPAN_NAMES = ("train.render", "render.bin", "train.loss", "train.backward",
              "train.optimizer", "train.refine")
READINGS = ("image_gap", "loss_gap", "grad_gap", "update_gap", "cull_gap",
            "target_gap", "truncated", "severe")
FIELDS = ref.FIELDS
LR_KEYS = {"means": "means", "quats": "quats", "log_scales": "scales",
           "logit_opacities": "opacities", "sh_dc": "features_dc",
           "sh_rest": "features_rest"}


def _quantised(img):
    """(H, W, 3) uint8 of an image in [0, 1], as the views are kept."""
    return (img.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8)


def _gap(got, want) -> float:
    """Largest absolute difference; infinite where the shapes differ."""
    if got is None or tuple(got.shape) != tuple(want.shape):
        return float("inf")
    return float((got.float() - want.float()).abs().max())


def train_config(cfg: dict):
    """The program's ``TrainConfig`` of the configuration."""
    from sim_a_splat_torch.splat.train import TrainConfig
    lr, r = cfg["lr"], cfg["refine"]
    return TrainConfig(
        iters=int(cfg["max_num_iterations"]), lr_means=lr["means"],
        lr_means_final=cfg["lr_means_final"], lr_sh_dc=lr["features_dc"],
        lr_sh_rest=lr["features_rest"], lr_opacities=lr["opacities"],
        lr_scales=lr["scales"], lr_quats=lr["quats"],
        refine_every=int(r["refine_every"]),
        refine_start=int(r["warmup_length"]),
        densify_grad_thresh=r["densify_grad_thresh"],
        densify_size_thresh=r["densify_size_thresh"],
        cull_alpha_thresh=r["cull_alpha_thresh"],
        cull_scale_thresh=r["cull_scale_thresh"],
        n_split_samples=int(r["n_split_samples"]),
        reset_alpha_every=int(r["reset_alpha_every"]),
        stop_split_at=int(r["stop_split_at"]), l1_weight=1.0,
        ssim_lambda=cfg["ssim_lambda"], background=tuple(cfg["background"]))


class HostSlots:
    """Host buffers for the samples, one flat float32 buffer a sample,
    pinned where the device is a card and made at set-up: a sample copies
    its scene, moments, gradients and render into one without waiting,
    and the device holds none of them."""

    def __init__(self, n: int, floats: int, device):
        pin = torch.device(device).type == "cuda"
        self.bufs = [torch.empty(floats, dtype=torch.float32, pin_memory=pin)
                     for _ in range(n)]
        self.next = 0

    def take(self):
        buf, self.next = self.bufs[self.next], self.next + 1
        return _Cursor(buf)


class _Cursor:
    def __init__(self, buf):
        self.buf, self.at = buf, 0

    def copy(self, x):
        """A host copy of the float32 tensor ``x``, enqueued on the
        current stream."""
        out = self.buf[self.at:self.at + x.numel()].view(x.shape)
        self.at += x.numel()
        return out.copy_(x.detach(), non_blocking=True)


class Sample:
    """One recorded step: the view, the scene and Adam's state before it,
    and what the program made of it, copied to host memory."""

    def __init__(self, trainer, view: int, start: int, host: _Cursor):
        opt = trainer.optimizer
        self.view = view
        self.host = host
        self.live = trainer.scene
        self.before, self.m, self.v, self.n = {}, {}, {}, {}
        for k, p in zip(FIELDS, trainer.scene):
            if p is None:
                continue
            st = opt.state.get(p, {})
            self.before[k] = host.copy(p)
            self.m[k] = host.copy(st["exp_avg"]) if st else \
                torch.zeros_like(self.before[k])
            self.v[k] = host.copy(st["exp_avg_sq"]) if st else \
                torch.zeros_like(self.before[k])
            self.n[k] = int(st["step"]) if st else 0
        # the means schedule's position: the first optimizer counts from
        # the run's start step, one rebuilt after a round from 0
        self.t_means = self.n["means"] + (start if trainer.n_refines == 0
                                          else 0)
        self.rounds = trainer.n_refines

    def finish(self, trainer, loss):
        self.loss = loss
        self.image = self.host.copy(trainer.image)
        self.truncated = (trainer.aux.n_overflowed_tiles
                          + trainer.aux.n_slot_truncated)
        self.after = {k: self.host.copy(p) for k, p in
                      zip(FIELDS, self.live) if p is not None}
        self.grads = {k: self.host.copy(p.grad) for k, p in
                      zip(FIELDS, self.live) if p is not None}
        self.keep = trainer.keep if trainer.n_refines > self.rounds else None
        self.live = self.host = None

    def to(self, device):
        """The device copies of the recorded fields, moments and
        gradients, for the check."""
        for d in (self.before, self.m, self.v, self.after, self.grads):
            for k in d:
                d[k] = d[k].to(device)
        self.image = self.image.to(device)
        return self


class System:
    """One cell's program objects, its inputs from the seed, and the
    samples its correctness check reads."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, spans=None):
        from sim_a_splat_torch.ops.projection import Camera
        from sim_a_splat_torch.ops.rasterize_tiles import (
            RasterConfig, rasterize_raw_sh,
        )
        from sim_a_splat_torch.ops.transforms import SE3
        from sim_a_splat_torch.splat.scene import GaussianScene
        from sim_a_splat_torch.splat.train import Trainer

        self.cfg = cfg
        self.device = torch.device(device)
        if mix["loop"] != "train" or mix["walk"]["kind"] != "epoch_shuffle":
            raise ValueError(f"splatfacto has no loop {mix['loop']!r} with "
                             f"views drawn by {mix['walk']['kind']!r}")
        self.readings = READINGS
        self.B = int(mix["batch"])
        self.Trainer, self.Scene = Trainer, GaussianScene
        self.tcfg = train_config(cfg)
        self.raster = RasterConfig(
            tile_size=int(cfg["tile_size"]),
            tile_capacity=int(cfg["tile_capacity"]),
            max_tiles_per_gaussian=int(cfg["max_tiles_per_gaussian"]),
            sigma_cutoff=cfg["sigma_cutoff"], term_eps=cfg["term_eps"],
            buckets=tuple(tuple(b) for b in cfg["buckets"]))
        self.start = int(cfg["window"]["start_step"])
        gt, self.init = scenes(cfg, seed, traffic_gen.generator(
            seed, self.device, salt=1))
        self.views = v = orbit(cfg, self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.cams = [Camera(SE3(v.q[i], v.center[i]),
                            torch.tensor(v.fx, **f32),
                            torch.tensor(v.fy, **f32),
                            torch.tensor(v.cx, **f32),
                            torch.tensor(v.cy, **f32), v.width, v.height)
                     for i in range(v.q.shape[0])]
        g = GaussianScene(**gt)
        bg = torch.tensor(self.tcfg.background, **f32)
        targets, cut = [], torch.zeros((), dtype=torch.long,
                                       device=self.device)
        with torch.no_grad():
            for c in self.cams:
                img, aux = rasterize_raw_sh(
                    g.means, g.quats, g.log_scales, g.sh_coeffs(),
                    g.opacities(), c, g.sh_degree, self.raster,
                    background=bg)
                targets.append(_quantised(img))
                cut += aux.n_overflowed_tiles + aux.n_slot_truncated
        self.targets = torch.stack(targets)
        self.target_truncated = int(cut)
        # the ground truth stays on the host, for the check's own render
        self.gt = {k: v.cpu() for k, v in gt.items()}
        del g, gt, targets
        steps, _ = traffic_gen.check_sample(mix, seed)
        every = self.tcfg.refine_every
        first_round = (-(self.start + 1)) % every   # window step of a round
        self.sample_steps = sorted({0, first_round, *steps})
        self.order = view_order(seed, len(self.cams), 100_000)
        floats = (5 * sum(x.numel() for x in self.init.values()
                          if x is not None)
                  + 3 * v.width * v.height)
        self.slots = HostSlots(len(self.sample_steps) + 1, floats,
                               self.device)
        self.restart()

    def restart(self):
        """Back to the run's start step, with no samples kept."""
        self.trainer = None
        self.trainer = self.Trainer(self.Scene(**self.init), self.tcfg,
                                    self.raster, start_step=self.start,
                                    device=self.device)
        self.i = 0
        self.kept = {}
        self.slots.next = 0
        self.losses = []

    def _step(self, record: bool):
        view = self.order[self.i]
        target = self.targets[view].float() / 255.0
        rec = (Sample(self.trainer, view, self.start, self.slots.take())
               if record else None)
        loss = self.trainer.step(self.cams[view], target)
        if rec is not None:
            rec.finish(self.trainer, loss)
            self.kept[self.i] = rec
        self.losses.append(loss)
        self.i += 1

    def step(self) -> int:
        """One trainer step; returns the frames done (one view)."""
        self._step(self.i in self.sample_steps)
        return self.B

    def counters(self):
        """(steps whose loss is not finite, their count) of the window."""
        bad = int((~torch.isfinite(torch.stack(self.losses))).sum())
        return bad, bad

    def release(self):
        """One more recorded step from the state the run ended in (the
        window's end), then drop the program's objects."""
        self._step(True)
        self.trainer = self.Trainer = self.losses = None

    # --- the check ------------------------------------------------------
    def _camera(self, view: int, dtype=torch.float32):
        v = self.views
        return ref.camera(v.q[view], v.center[view], v.fx, v.fy, v.cx, v.cy,
                          v.width, v.height, dtype)

    def _lr(self, k: str, rec: Sample) -> float:
        if k == "means":
            return ref.means_lr(self.cfg, rec.t_means)
        return self.cfg["lr"][LR_KEYS[k]]

    def _reference(self, rec: Sample, dtype):
        """The reference's step of ``rec``'s scene in ``dtype``."""
        leaves = {k: rec.before.get(k) for k in FIELDS}
        leaves = {k: None if x is None else x.to(dtype)
                  for k, x in leaves.items()}
        target = self.targets[rec.view].float() / 255.0
        return ref.step(leaves, self._camera(rec.view, dtype), target,
                        ref.raster_of(self.cfg), int(self.cfg["sh_degree"]),
                        self.cfg["ssim_lambda"], self.cfg["background"],
                        int(self.cfg["check_rows"]))

    def _update(self, rec: Sample, grads: dict, dtype) -> dict:
        """Adam's update of ``rec``'s scene by ``grads`` in ``dtype``."""
        return {k: ref.adam(rec.before[k].to(dtype), grads[k].to(dtype),
                            rec.m[k].to(dtype), rec.v[k].to(dtype),
                            rec.n[k] + 1, self._lr(k, rec))[0]
                for k in rec.before}

    def _cull_gap(self, keep, post: dict) -> int:
        r = self.cfg["refine"]
        want = ref.cull_keep(post, r["cull_alpha_thresh"],
                             r["cull_scale_thresh"])
        band = ref.cull_band(post, r["cull_alpha_thresh"],
                             r["cull_scale_thresh"], self.cfg["cull_band"])
        return int(((keep != want) & ~band).sum())

    def _readings(self, rec, image, loss, grads, post, keep, want) -> dict:
        """One sample's readings: ``image``, ``loss``, ``grads`` against the
        reference's ``want``; ``post`` (the fields after Adam) against
        Adam's update of ``grads``; ``keep`` against the cull of the
        update."""
        upd = self._update(rec, grads, torch.float32)
        out = {"image_gap": _gap(image, want.image),
               "loss_gap": abs(float(loss) - float(want.loss))
               / abs(float(want.loss)),
               "grad_gap": max(_gap(grads[k], g)
                               / float(g.float().abs().max())
                               for k, g in want.grads.items()),
               "update_gap": 0.0, "cull_gap": 0}
        for k, p in upd.items():
            out["update_gap"] = max(out["update_gap"],
                                    _gap(post[k], p) / self._lr(k, rec))
        if keep is not None:
            out["cull_gap"] = self._cull_gap(keep, upd)
        return out

    def _target(self, view: int, dtype):
        """The reference's render of the ground truth from ``view`` in
        ``dtype``, kept as the views are (uint8)."""
        gt = {k: None if x is None else x.to(self.device, dtype)
              for k, x in self.gt.items()}
        return _quantised(ref.render(
            gt, self._camera(view, dtype), ref.raster_of(self.cfg),
            int(self.cfg["sh_degree"]), self.cfg["background"],
            int(self.cfg["check_rows"])).float())

    def _target_gap(self, targets) -> float:
        """``targets`` {view: uint8 image} against the reference's float32
        renders of the ground truth, in units of a colour: the program's
        own targets, which both sides train against, are held so."""
        return max((_gap(t.float() / 255.0,
                         self._target(view, torch.float32).float() / 255.0)
                    for view, t in targets.items()), default=0.0)

    def check(self) -> dict:
        """Readings of the program against the reference: {name: value}."""
        out = {"truncated": self.target_truncated}
        for i in sorted(self.kept):
            rec = self.kept[i].to(self.device)
            want = self._reference(rec, torch.float32)
            got = self._readings(rec, rec.image, rec.loss, rec.grads,
                                 rec.after, rec.keep, want)
            for k, v in got.items():
                out[k] = max(out.get(k, 0), v)
            out["truncated"] += int(rec.truncated)
            del want
        out["target_gap"] = self._target_gap(
            {v: self.targets[v] for v in self._views()})
        return out

    def _views(self):
        return sorted({rec.view for rec in self.kept.values()})

    def control(self, low_dtype) -> dict:
        """The control's readings: the reference in ``low_dtype`` in the
        program's place (its render, loss, gradients, its Adam in
        ``low_dtype`` and its cull of that, and its render of the targets),
        against the reference, on the same samples."""
        out = {}
        for i in sorted(self.kept):
            rec = self.kept[i].to(self.device)
            want = self._reference(rec, torch.float32)
            low = self._reference(rec, low_dtype)
            post = self._update(rec, low.grads, low_dtype)
            keep = None
            if rec.keep is not None:
                r = self.cfg["refine"]
                keep = ref.cull_keep(post, r["cull_alpha_thresh"],
                                     r["cull_scale_thresh"])
            got = self._readings(rec, low.image, low.loss, low.grads, post,
                                 keep, want)
            got["truncated"] = low.overflowed + low.slot_truncated
            for k, v in got.items():
                out[k] = max(out.get(k, 0), v)
        out["target_gap"] = self._target_gap(
            {v: self._target(v, low_dtype) for v in self._views()})
        return out

    def witness(self) -> dict:
        """No second implementation of the trainer: nothing to read."""
        return {}
