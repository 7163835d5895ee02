"""The arm deployment: ``pusharm6`` pushing a T-block in the product splat
scene, seen by a fixed viewport (K1 once, K2 every frame) and by a camera
on its end effector (K3 over per-env candidate caches), driven through the
program's collect step (``entry.make_product_collect``), forward only.

Loops (the traffic's ``loop``):

- ``teleop``: one operator's arm (``batch`` 1), the fixed-camera caches
  built once at set-up and the end-effector caches built once from the
  settled state; each step is one call of the collect step, closed loop,
  which rebuilds the end-effector caches where the camera has left their
  margin budget;
- ``datagen``: ``batch`` envs collected in episodes of ``walk.steps``
  control steps; at an episode's start the fixed-camera caches are built
  from the scene and the end-effector caches from the episode's first
  states (inside the collect step), and the states carry over from one
  episode to the next.  The set-up runs the first ``warm_episodes``
  episodes after the settle and ``window_phase`` steps of the next: in the
  first episode the arm is still settling, and the rebuilds that the
  seed's scene puts there (one or two of every env) would move the
  window's device time by ~1 %; and a window that starts
  ``window_phase`` (16) steps into an episode holds one episode's start
  (its caches' build, ~8 ms of device time) at any length from 17 to 48
  steps, where one that started at an episode's start would hold one or
  two as the host's speed gives it 24-37 steps.

Inputs: the scene from the seed, drawn here as the source draws it
(``perfbench/reference/pusharm_scene.py``) and handed to the program
(``entry.build_product_wrapper(scene=..., link_masks=...)``) and to the
reference alike; every env reset to the configuration's ``reset`` and
settled ``settle`` steps at its ``action``; each step's action that base
plus the source's mm-scale dither, ``walk.amplitude`` ·
sin(2π t / ``walk.steps``) · ``walk.pattern``, t the step in the episode
(teleop: in the run).

The correctness check follows the program step by step: for each sampled
step the reference takes the program's input state and action and
computes the next state; it renders the program's next state, the
end-effector camera over a cache the reference builds itself at the state
the program's cache was built at; it decides from the state of the last
rebuild whether the step had to rebuild, and counts the frame's severe and
bounded truncations.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from perfbench.harness import traffic as traffic_gen
from perfbench.reference.pusharm import Reference
from perfbench.reference.pusharm_scene import arm_scene

# the program's tracer's root span of a collect step (the per-layer readers
# of this system read the window's roots by this name)
ROOT_SPAN = "step.arm"
# spans the system puts around the env's step and the cameras' render (both
# methods: the harness wraps module attributes alone)
PHYSICS_SPAN, CAMERAS_SPAN = "physics", "render.cameras"
SPANS = {}
SPAN_NAMES = (PHYSICS_SPAN, CAMERAS_SPAN)
READINGS = ("state_gap", "image_gap", "bounded_gap", "rebuild_gap", "severe",
            "severe_ref")


def state_gap(a, b) -> float:
    """Largest distance between two batches of states: joint angles and
    targets in radians, the block's and the end effector's positions in
    metres, the block's yaw at the T's crossbar half-length (0.1 m),
    velocities over one control step (0.01 s), and the clock."""
    def d(x, y):
        return float((x.detach().float().cpu() - y.detach().float().cpu())
                     .abs().max())
    dt = 0.01
    return max(d(a.arm.q, b.arm.q), dt * d(a.arm.qd, b.arm.qd),
               d(a.arm.target_prev, b.arm.target_prev),
               d(a.block_pos, b.block_pos), 0.1 * d(a.block_yaw, b.block_yaw),
               dt * d(a.block_vel, b.block_vel),
               0.1 * dt * d(a.block_omega, b.block_omega),
               d(a.prev_eef_xy, b.prev_eef_xy), d(a.t, b.t))


def _gap(got, want) -> float:
    """Largest absolute difference; infinite where the shapes differ."""
    if got is None or tuple(got.shape) != tuple(want.shape):
        return float("inf")
    return float((got.float() - want.float()).abs().max())


def _on(tree, device):
    """A state tree's tensors, detached, on ``device``."""
    if torch.is_tensor(tree):
        return tree.detach().to(device)
    return type(tree)(*(_on(f, device) for f in tree))


class System:
    """One cell's program objects, its inputs from the seed, and the
    samples its correctness check reads."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, spans=None):
        from sim_a_splat_torch import entry
        from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
        from sim_a_splat_torch.splat.scene import GaussianScene

        self.cfg = cfg
        self.device = torch.device(device)
        self.loop = mix["loop"]
        if self.loop not in ("teleop", "datagen"):
            raise ValueError(f"pusharm has no loop {self.loop!r}")
        self.readings = READINGS
        self.B = int(mix["batch"])
        raster = RasterConfig(
            tile_size=int(cfg["tile_size"]),
            tile_capacity=int(cfg["tile_capacity"]),
            max_tiles_per_gaussian=int(cfg["max_tiles_per_gaussian"]),
            sigma_cutoff=cfg["sigma_cutoff"], term_eps=cfg["term_eps"],
            buckets=tuple(tuple(b) for b in cfg["buckets"]),
            chunk=int(cfg["chunk"]))
        self.leaves, self.link_ids, masks = arm_scene(
            cfg, int(seed) % (1 << 63), self.device)
        self.wrapper = w = entry.build_product_wrapper(
            render_size=tuple(cfg["render_size"]), raster=raster,
            device=self.device, link_masks=masks, scene=GaussianScene(
                **{k: v.clone() for k, v in self.leaves.items()}))
        self._check_settings(entry)
        self.build_kw = dict(margin=float(cfg["margin"]), kc=int(cfg["kc"]),
                             z_split=float(cfg["z_split"]),
                             t_max=float(cfg["t_max"]),
                             near_cap=int(cfg["near_cap"]))
        self.collect = entry.make_product_collect(w)
        self.env = env = w.env
        if spans is not None:
            # instance attributes over the methods, for this run's objects
            object.__setattr__(env, "step", spans.wrap(PHYSICS_SPAN, env.step))
            object.__setattr__(w, "render_with_cache_batch", spans.wrap(
                CAMERAS_SPAN, w.render_with_cache_batch))

        reset = {k: np.asarray(v, np.float32)
                 for k, v in cfg["reset"].items()}
        base = torch.tensor(cfg["action"], dtype=torch.float32,
                            device=self.device)
        with torch.no_grad():
            states, _ = env.reset(reset_to_state=reset, batch=self.B)
            for _ in range(int(mix["settle"])):
                states = env.step(states, base.expand(self.B, -1)).state
        self.states0 = states
        wk = mix["walk"]
        self.period = int(wk["steps"])
        t = torch.arange(self.period, dtype=torch.float32, device=self.device)
        phase = torch.sin(2.0 * math.pi * t / self.period)
        pattern = torch.tensor(wk["pattern"], dtype=torch.float32,
                               device=self.device)
        self.actions = (base + float(wk["amplitude"]) * phase[:, None]
                        * pattern).expand(self.B, -1, -1).transpose(0, 1) \
            .contiguous()                                  # (period, B, 6)
        if self.loop == "teleop":
            with torch.no_grad():
                self.caches0 = w.build_render_cache()
                self.moving0 = w.build_moving_caches(
                    env.draw_state(states), **self.build_kw)
        self.sample_steps, self.sample_envs = traffic_gen.check_sample(
            mix, seed)
        if self.sample_envs != list(range(self.B)):
            raise ValueError("the arm's check samples every env: "
                             f"check.envs {mix['check']['envs']} of {self.B}")
        self.start = None
        self.restart()
        if self.loop == "datagen":
            for _ in range(int(mix.get("warm_episodes", 0)) * self.period
                           + int(mix.get("window_phase", 0))):
                self.step()
            self.start = (self.states, self.caches, self.moving,
                          self.build_q, self.i % self.period)
            self.restart()

    def _check_settings(self, entry):
        """The program's product settings are the configuration's (the
        reference renders the configuration)."""
        c, w = self.cfg, self.wrapper
        render = entry.PRODUCT_RENDER
        want = {k: c[k] for k in ("sel_tiles", "dyn_capacity",
                                  "dyn_max_tiles", "margin", "kc", "z_split",
                                  "near_cap")}
        cams = {spec.type: spec for _, spec in w.cameras}
        got_cams = {"viewport": list(cams["viewport"].local_frame[1]),
                    "eef_camera": list(cams["moving"].local_frame[1])}
        if (render != want
                or got_cams["viewport"] != c["viewport"]["t"]
                or got_cams["eef_camera"] != c["eef_camera"]["t"]
                or cams["moving"].link_name != c["eef_link"]
                or any(s.fov != c["fov"] for s in cams.values())):
            raise ValueError(f"the program's product settings {render}, "
                             f"{w.cameras} are not the configuration's")

    def restart(self):
        """Back to the states and caches where the set-up left them, with
        no samples kept."""
        self.i = 0
        self.kept = {}
        self.severe, self.bounded, self.rebuilt = [], [], []
        if self.loop == "teleop":
            self.states, self.caches, self.moving = (self.states0,
                                                     self.caches0,
                                                     self.moving0)
            self.build_q, self.phase = self.states0.arm.q, 0
        elif self.start is None:
            self.states, self.phase = self.states0, 0
            self.caches = self.moving = self.build_q = None
        else:
            (self.states, self.caches, self.moving, self.build_q,
             self.phase) = self.start

    def step(self) -> int:
        """One control step of every env; returns the frames done."""
        t = (self.i + self.phase) % self.period
        start = self.loop == "datagen" and t == 0
        s0 = self.states
        with torch.no_grad():
            if start:
                self.caches = self.wrapper.build_render_cache()
                self.moving, self.build_q = None, s0.arm.q
            prev_q = None if start else self.build_q
            a = self.actions[t]
            tr, self.moving = self.collect(s0, a, self.caches, self.moving)
        new = tr.state
        rebuilt = tr.info["render_rebuilt"] > 0
        self.build_q = torch.where(rebuilt[:, None], new.arm.q, self.build_q)
        severe = tr.info["render_overflow"][0]
        bounded = tr.info["render_truncated"][0]
        self.severe.append(severe)
        self.bounded.append(bounded)
        self.rebuilt.append(rebuilt.sum())
        rec = dict(s0=s0, a=a, new=new, eef=tr.obs["camera_0"],
                   view=tr.obs["camera_1"], bounded=bounded, rebuilt=rebuilt,
                   prev_q=prev_q, build_q=self.build_q, start=start)
        if self.i in self.sample_steps or self.i == 0:
            self.kept[self.i] = rec
        self.last = (self.i, rec)
        self.states = new
        self.i += 1
        return self.B

    def counters(self):
        """(steps with a severe count, the severe count) of the window."""
        sv = torch.stack(self.severe).cpu()
        n = int(torch.stack(self.rebuilt).sum())
        episodes = -(-len(self.severe) // self.period) \
            if self.loop == "datagen" else 0
        print(f"pusharm: {n} env caches rebuilt in {len(self.severe)} steps "
              f"of {self.B} envs; {episodes} episode builds; bounded "
              f"truncations a step {torch.stack(self.bounded).float().mean():.1f}",
              file=sys.stderr, flush=True)
        return int((sv > 0).sum()), int(sv.sum())

    def release(self):
        """Drop the program's objects, keeping the samples and inputs."""
        i, rec = self.last
        self.kept[i] = rec
        self.collect = self.caches = self.moving = self.wrapper = None
        self.caches0 = self.moving0 = self.env = self.states = None
        self.start = None

    # --- the check ------------------------------------------------------
    def _reference(self, dtype=torch.float32):
        return Reference(self.cfg, self.leaves, self.link_ids, dtype)

    def check(self) -> dict:
        """Readings of the program against the reference: {name: value}."""
        ref = self._reference()
        c = self.cfg
        limit, band = float(c["rebuild_budget"]), float(c["rebuild_band"])
        out = {"state_gap": 0.0, "image_gap": 0.0, "bounded_gap": 0,
               "rebuild_gap": 0, "severe_ref": 0}
        envs = self.sample_envs
        for i in sorted(self.kept):
            r = self.kept[i]
            out["state_gap"] = max(out["state_gap"],
                                   state_gap(r["new"],
                                             ref.step(r["s0"], r["a"])))
            if r["prev_q"] is not None:
                for b in envs:
                    with torch.no_grad():
                        used = ref.budget_used(
                            ref.build(r["prev_q"][b], lists=False),
                            r["new"].arm.q[b])
                    if abs(used - limit) > band * limit and \
                            (used > limit) != bool(r["rebuilt"][b]):
                        out["rebuild_gap"] += 1
            eef, view, severe, bounded = ref.frames(r["new"], r["build_q"],
                                                    envs)
            out["image_gap"] = max(out["image_gap"], _gap(r["eef"], eef),
                                   _gap(r["view"], view))
            out["bounded_gap"] += abs(int(r["bounded"]) - bounded)
            out["severe_ref"] += severe
        return out

    def control(self, low_dtype) -> dict:
        """The control's readings: the reference in ``low_dtype`` in the
        program's place, against the reference, on the same samples."""
        ref, low = self._reference(), self._reference(low_dtype)
        limit, band = (float(self.cfg["rebuild_budget"]),
                       float(self.cfg["rebuild_band"]))
        out = {"state_gap": 0.0, "image_gap": 0.0, "bounded_gap": 0,
               "rebuild_gap": 0}
        envs = self.sample_envs
        for i in sorted(self.kept):
            r = self.kept[i]
            out["state_gap"] = max(out["state_gap"], state_gap(
                ref.step(r["s0"], r["a"]), low.step(r["s0"], r["a"])))
            for b in envs if r["prev_q"] is not None else ():
                with torch.no_grad():
                    hi, lo = (x.budget_used(x.build(r["prev_q"][b],
                                                    lists=False),
                                            r["new"].arm.q[b])
                              for x in (ref, low))
                if abs(hi - limit) > band * limit and \
                        (hi > limit) != (lo > limit):
                    out["rebuild_gap"] += 1
            e_hi, v_hi, _, b_hi = ref.frames(r["new"], r["build_q"], envs)
            e_lo, v_lo, _, b_lo = low.frames(r["new"], r["build_q"], envs)
            out["image_gap"] = max(out["image_gap"], _gap(e_lo, e_hi),
                                   _gap(v_lo, v_hi))
            out["bounded_gap"] += abs(b_lo - b_hi)
        return out

    def witness(self) -> dict:
        """The reference's physics on the host CPU from the program's own
        input states, against the program's next states."""
        cpu = Reference(self.cfg, {k: v.cpu() for k, v in self.leaves.items()},
                        self.link_ids.cpu())
        gap = 0.0
        for r in self.kept.values():
            gap = max(gap, state_gap(r["new"], cpu.step(_on(r["s0"], "cpu"),
                                                         r["a"].cpu())))
        return {"state_gap": gap}
