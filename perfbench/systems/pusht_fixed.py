"""The pushT envs under the fixed top-down camera, driven through the
program's batched step (``entry.make_step_cached_batch``).

Loops (the traffic's ``loop``):

- ``datagen``: ``prepare`` (the static gaussians' SH, tile cache and
  composite, kernel K1) and ``step_batch`` (control step, posing, the
  dynamic gaussians' binning and the selected-tile composite, kernel K2)
  every step, forward only: what collecting observations costs;
- ``train``: ``entry.loss_and_grads`` of mean(images²) over the batch to
  every scene field every step (forward, then K2b, K1b and autograd).

The correctness check follows the program step by step: for each sampled
step the reference takes the program's own input state and action and
computes the next state, and renders the program's next state, so a
physics step and a render are each judged by themselves; the start is
checked apart, the reference resetting from the same reset rows.
"""

from __future__ import annotations

import torch

from perfbench.harness import scene as scene_gen
from perfbench.harness import traffic as traffic_gen
from perfbench.reference.pusht_fixed import Reference

# spans around the program's module attributes at its layer calls; the
# harness wraps these, the system wraps ``prepare`` (a closure) itself
SPANS = {
    "physics": "sim_a_splat_torch.physics.pusht:control_step",
    "render.select": "sim_a_splat_torch.entry:rasterize_cache_sel_batch",
}
PREPARE_SPAN = "render.prepare"
SPAN_NAMES = (*SPANS, PREPARE_SPAN)
# the numbers each loop's check compares, each against its limit in the
# configuration
READINGS = {
    "datagen": ("state_gap", "image_gap", "bounded_gap", "severe",
                "severe_ref"),
    "train": ("state_gap", "loss_gap", "grad_gap", "bounded_gap", "severe",
              "severe_ref"),
}


def state_gap(a, b) -> float:
    """Largest distance between two batches of states, in world units: the
    agent's and the block's positions, the block's angle at the T's arm
    length (60 units), and the velocities over one control step (0.1 s)."""
    def d(x, y):
        return float((x.detach().float().cpu() - y.detach().float().cpu())
                     .abs().max())
    return max(d(a.agent_pos, b.agent_pos), d(a.block_pos, b.block_pos),
               60.0 * d(a.block_angle, b.block_angle),
               0.1 * d(a.agent_vel, b.agent_vel),
               0.1 * d(a.block_vel, b.block_vel),
               6.0 * d(a.block_omega, b.block_omega))


class System:
    """One cell's program objects, its inputs from the seed, and the
    samples its correctness check reads."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 spans=None):
        from sim_a_splat_torch import entry
        from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
        from sim_a_splat_torch.ops.transforms import SE3
        from sim_a_splat_torch.physics import pusht
        from sim_a_splat_torch.scenegraph.graph import SceneGraph
        from sim_a_splat_torch.splat.scene import GaussianScene

        self.cfg = cfg
        self.device = torch.device(device)
        self.loop = mix["loop"]
        if self.loop not in READINGS:
            raise ValueError(f"pusht_fixed has no loop {self.loop!r}")
        self.readings = READINGS[self.loop]
        self.B = int(mix["batch"])
        self.leaves, self.link_ids = scene_gen.pusht_scene(
            cfg, traffic_gen.generator(seed, self.device, salt=1))
        self.scene = GaussianScene(**self.leaves)
        graph = SceneGraph(self.scene, self.link_ids,
                           SE3.identity((3,), device=self.device))
        raster = RasterConfig(
            tile_size=int(cfg["tile_size"]),
            tile_capacity=int(cfg["tile_capacity"]),
            max_tiles_per_gaussian=int(cfg["max_tiles_per_gaussian"]),
            sigma_cutoff=cfg["sigma_cutoff"], term_eps=cfg["term_eps"],
            buckets=tuple(tuple(b) for b in cfg["buckets"]))
        res = int(cfg["resolution"])
        prepare, self.step_batch, self.params = entry.make_step_cached_batch(
            graph, res, res, raster, dyn_capacity=int(cfg["dyn_capacity"]),
            sel_tiles=int(cfg["sel_tiles"]),
            dyn_max_tiles=int(cfg["dyn_max_tiles"]), device=self.device)
        self.prepare = spans.wrap(PREPARE_SPAN, prepare) if spans else prepare
        self.entry = entry
        gen = traffic_gen.generator(seed, self.device, salt=2)
        self.reset_vec = traffic_gen.reset_vectors(mix, gen)
        self.states0 = pusht.reset(self.params, None, self.B,
                                   reset_to_state=self.reset_vec)
        self.actions = traffic_gen.action_walk(mix, self.reset_vec[:, :2], gen)
        self.sample_steps, self.sample_envs = traffic_gen.check_sample(
            mix, seed)
        self.restart()

    def restart(self):
        """Back to the reset states, with no samples kept."""
        self.states = self.states0
        self.i = 0
        self.kept = {}
        self.drops = []

    def step(self) -> int:
        """One closed-loop step of every env; returns the frames done."""
        a = self.actions[self.i % self.actions.shape[0]]
        s0 = self.states
        if self.loop == "datagen":
            new, imgs, n_drop = self.step_batch(self.prepare(self.scene),
                                                self.scene, s0, a)
            out = imgs
        else:
            new, loss, n_drop, grads = self.entry.loss_and_grads(
                self.prepare, self.step_batch, self.scene, s0, a)
            out = (loss, grads)
        self.drops.append(n_drop)
        rec = (s0, a, new, out, n_drop)
        if self.i in self.sample_steps or self.i == 0:
            self.kept[self.i] = rec
        self.last = (self.i, rec)
        self.states = new
        self.i += 1
        return self.B

    def counters(self):
        """(steps with a severe count, the severe count) of the window."""
        d = torch.stack(self.drops).cpu()
        return int((d[:, 0] > 0).sum()), int(d[:, 0].sum())

    def release(self):
        """Drop the program's objects, keeping the samples and inputs."""
        i, rec = self.last
        self.kept[i] = rec
        self.step_batch = self.prepare = self.entry = self.drops = None
        self.states = None

    # --- the check ------------------------------------------------------
    def _grads_at(self) -> int:
        """The step whose loss and gradients are compared: the first step
        drawn for the sample (the window's first where none was reached)."""
        drawn = [i for i in self.sample_steps if i in self.kept]
        return drawn[0] if drawn else min(self.kept)

    def check(self) -> dict:
        """Readings of the program against the reference: {name: value}."""
        ref = Reference(self.cfg, self.leaves, self.link_ids)
        out = {"state_gap": state_gap(self.states0,
                                      ref.reset(self.reset_vec)),
               "bounded_gap": 0}
        grads_at = self._grads_at()
        for i in sorted(self.kept):
            s0, a, new, res, n_drop = self.kept[i]
            out["state_gap"] = max(out["state_gap"],
                                   state_gap(new, ref.control_step(s0, a)))
            severe, bounded = ref.counters(new)
            if self.loop == "datagen":
                imgs = ref.render(new, self.sample_envs)
                got = res[self.sample_envs] if res.shape[0] == self.B else None
                out["image_gap"] = max(out.get("image_gap", 0.0),
                                       _gap(got, imgs))
            elif i == grads_at:
                loss, grads = ref.loss_and_grads(new)
                out["loss_gap"] = abs(float(res[0]) - float(loss)) \
                    / abs(float(loss))
                out["grad_gap"] = max(
                    _gap(getattr(res[1], k), g) / float(g.float().abs().max())
                    for k, g in grads.items())
            out["bounded_gap"] += abs(int(n_drop[1]) - bounded)
            out["severe_ref"] = out.get("severe_ref", 0) + severe
        return out

    def control(self, low_dtype) -> dict:
        """The control's readings: the reference in ``low_dtype`` in the
        program's place, against the reference, on the same samples."""
        ref = Reference(self.cfg, self.leaves, self.link_ids)
        low = Reference(self.cfg, self.leaves, self.link_ids, low_dtype)
        out = {"state_gap": state_gap(ref.reset(self.reset_vec),
                                      low.reset(self.reset_vec))}
        grads_at = self._grads_at()
        for i in sorted(self.kept):
            s0, a, new, res, n_drop = self.kept[i]
            out["state_gap"] = max(out["state_gap"], state_gap(
                ref.control_step(s0, a), low.control_step(s0, a)))
            if self.loop == "datagen":
                hi = ref.render(new, self.sample_envs)
                lo = low.render(new, self.sample_envs)
                out["image_gap"] = max(out.get("image_gap", 0.0),
                                       _gap(lo, hi))
            elif i == grads_at:
                loss, grads = ref.loss_and_grads(new)
                loss_l, grads_l = low.loss_and_grads(new)
                out["loss_gap"] = abs(float(loss_l) - float(loss)) \
                    / abs(float(loss))
                out["grad_gap"] = max(
                    _gap(grads_l[k], g) / float(g.float().abs().max())
                    for k, g in grads.items())
        return out


def _gap(got, want) -> float:
    """Largest absolute difference; infinite where the shapes differ."""
    if got is None or tuple(got.shape) != tuple(want.shape):
        return float("inf")
    return float((got.float() - want.float()).abs().max())
