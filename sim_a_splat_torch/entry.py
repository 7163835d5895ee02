"""Entry points of the port: the pushT splat scene, the batched env step
and its train step, the per-env fixed-camera step, the uncached step, the
moving-camera rollout, and the arm product path.

Port of ``_build_scene``, ``_make_step_cached_batch``, ``_make_step_cached``,
``_make_step``, ``entry``, ``_make_step_moving`` and
``_make_step_moving_cached`` of the reference's entry module
(``__graft_entry__.py``):

- a batch of pushT envs under one fixed camera, the static background
  binned and composited once per step (kernel K1) and each env's touched
  tiles composited against it (kernel K2); ``loss_and_grads`` is the train
  step of the reference's bench (``bench.py``): the mean-square image loss
  and its gradient to every gaussian parameter, through the backward
  kernels K1b and K2b;
- the same envs through the reference's per-env step (its vmapped
  ``_make_step_cached``, batched here): every tile of every env composited
  against the static lists without a merge (kernel K4, K4b in training);
- the uncached step (the reference's vmapped ``_make_step``, batched here,
  which its ``entry()`` returns): every env poses all N gaussians and
  renders them through the full-grid rasterizer, kernel K1 over the B·T
  tiles (K1b in training);
- a camera attached to each env's agent: the R-frame rollout over per-env
  candidate caches (kernel K3, ``rollout_loss_and_grads`` its train step
  through K3b), and the full per-frame rebin (kernel K1) that is its
  exactness oracle;
- the arm product path (``benchmarks/bench_product.py``'s
  ``build_product_wrapper``, ``measure_product`` and ``measure_latency``):
  an articulated arm in a splat scene (``envs/splat_wrapper.py`` over
  ``envs/manipulator_envs.py``) seen by a fixed viewport (K1 once per
  rollout, K2 every frame) and an end-effector camera (K3 every frame),
  forward and in training (``product_loss_and_grads``), the one-env
  teleop step, and the data-collection step (``make_product_collect``),
  which rebuilds an env's end-effector caches where its camera has left
  their margin budget;
- the splat trainer's protocol (``benchmarks/train_scene.py``): the
  ground-truth scene, the ring cameras, the degraded init and the
  script's configs (``train_scene_inputs``), for ``splat/train.py``'s
  ``train`` (kernel K1, K1b in every train step);
- the multi-rank dry run (the reference's ``dryrun_multichip``: its six
  branches and the prim-sharded render over an env × prim mesh of
  processes, ``parallel/``) and ``benchmarks/scaling.py``'s protocol
  (``scaling_inputs``, ``scaling_step``, ``bench_mesh``).

Everything runs on ``device`` ("cuda" by default); ``device="cpu"`` runs
the plain PyTorch path (what the tests compare against the reference).
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import torch

from sim_a_splat_torch import resolve_device
from sim_a_splat_torch.envs.manipulator_envs import (
    ManipulatorEnvF, state_from_numpy,
)
from sim_a_splat_torch.envs.splat_wrapper import CameraSpec, SplatEnvWrapperF
from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.ops import rasterize_moving
from sim_a_splat_torch.ops import sh as sh_ops
from sim_a_splat_torch.ops.projection import (
    Camera, Projected, project_raw, view_directions,
)
from sim_a_splat_torch.ops.rasterize_cached import (
    build_static_composite, build_tile_cache_raw, build_tile_cache_raw_sh,
    rasterize_cache_sel_batch, rasterize_with_cache, rasterize_with_cache_sh,
)
from sim_a_splat_torch.ops.rasterize_tiles import (
    RasterConfig, rasterize_raw, render_binned,
)
from sim_a_splat_torch.ops.transforms import SE3
from sim_a_splat_torch.physics import kinematics as kin
from sim_a_splat_torch.physics import pusht
from sim_a_splat_torch.physics.pusht import PushTParams
from sim_a_splat_torch.scenegraph.graph import SceneGraph
from sim_a_splat_torch.splat.loaders import synthetic_scene
from sim_a_splat_torch.splat.scene import GaussianScene
from sim_a_splat_torch.utils import profiling
from sim_a_splat_torch.utils.profiling import span
from sim_a_splat_torch.splat.train import TrainConfig

GRAPH_LEAVES = ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
                "sh_rest", "link_ids", "rest_inv_q", "rest_inv_t")


def build_scene_numpy(n_bg=2000, n_block=400, n_agent=150, seed=0,
                      sh_degree=0) -> dict:
    """Synthetic pushT splat scene as numpy leaves (``GRAPH_LEAVES``): floor
    + T-block + agent clusters with per-body ids.  The same generator calls
    in the same order as the reference's ``_build_scene``, so the arrays are identical
    for the same arguments."""
    rng = np.random.default_rng(seed)
    polys = pusht.tee_polys_local()

    def part(xy, z, color, scale):
        n = len(xy)
        means = np.concatenate([xy, np.full((n, 1), z)], 1)
        q = rng.normal(size=(n, 4))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        return dict(
            means=means, quats=q,
            log_scales=rng.uniform(np.log(scale * 0.5), np.log(scale), (n, 3)),
            logit_opacities=np.full(n, 2.0),
            sh_dc=(color + rng.normal(0, 0.05, (n, 3)) - 0.5) / sh_ops.C0,
        )

    bg = part(rng.uniform([0, 0], [298, 512], (n_bg, 2)), 4.0,
              [0.85, 0.85, 0.8], 6.0)
    tpts = []
    for p in polys:
        lo, hi = p.min(0), p.max(0)
        tpts.append(rng.uniform(lo, hi, (n_block // 2, 2)))
    block = part(np.concatenate(tpts), 0.0, [0.5, 0.55, 0.6], 4.0)
    agent = part(rng.normal(size=(n_agent, 2)) * 6.0, 0.0, [0.2, 0.4, 0.9], 4.0)

    def cat(k):
        return np.concatenate([bg[k], block[k], agent[k]]).astype(np.float32)

    n = sum(len(p["means"]) for p in (bg, block, agent))
    sh_rest = None
    if sh_degree > 0:
        k_rest = (sh_degree + 1) ** 2 - 1
        sh_rest = rng.normal(0, 0.02, (n, k_rest, 3)).astype(np.float32)
    link_ids = np.zeros(n, np.int32)
    link_ids[n_bg:n_bg + n_block] = 1
    link_ids[n_bg + n_block:] = 2
    leaves = {k: cat(k) for k in ("means", "quats", "log_scales",
                                  "logit_opacities", "sh_dc")}
    leaves.update(sh_rest=sh_rest, link_ids=link_ids,
                  rest_inv_q=np.tile(np.asarray([1.0, 0, 0, 0], np.float32),
                                     (3, 1)),
                  rest_inv_t=np.zeros((3, 3), np.float32))
    return leaves


def graph_from_numpy(leaves: dict, device="cuda") -> SceneGraph:
    """The port's SceneGraph from numpy leaves keyed by ``GRAPH_LEAVES``
    (a reference graph's ``means, quats, log_scales, logit_opacities, sh_dc,
    sh_rest, link_ids, rest_inv.q, rest_inv.t``) on ``device``."""
    dev = resolve_device(device)

    def f32(k):
        return torch.as_tensor(np.array(leaves[k], np.float32), device=dev)

    scene = GaussianScene(f32("means"), f32("quats"), f32("log_scales"),
                          f32("logit_opacities"), f32("sh_dc"),
                          None if leaves["sh_rest"] is None else f32("sh_rest"))
    ids = torch.as_tensor(np.asarray(leaves["link_ids"], np.int64), device=dev)
    return SceneGraph(scene, ids, SE3(f32("rest_inv_q"), f32("rest_inv_t")))


def build_scene(n_bg=2000, n_block=400, n_agent=150, seed=0, sh_degree=0,
                device="cuda") -> SceneGraph:
    """:func:`build_scene_numpy` as a SceneGraph on ``device``."""
    return graph_from_numpy(
        build_scene_numpy(n_bg, n_block, n_agent, seed, sh_degree), device)


class _Bodies:
    """The scene's static/dynamic split and the posing of the two dynamic
    bodies (T-block, agent) for a batch of pushT states."""

    def __init__(self, graph: SceneGraph, dev):
        ids = graph.link_ids.cpu().numpy()
        self.graph = graph
        self.stat_idx = np.where(ids == 0)[0]
        self.dyn_idx = np.where(ids > 0)[0]
        self.dyn_ids = torch.as_tensor(ids[ids > 0], dtype=torch.long,
                                       device=dev)
        self.z_axis = torch.tensor([0.0, 0.0, 1.0], device=dev)
        self.q_identity = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)

    def body_poses(self, states) -> SE3:
        """(B, 3) world poses of the bodies: static (identity), T-block,
        agent."""
        B = states.block_angle.shape[0]
        zeros1 = states.block_angle.new_zeros((B, 1))
        qb = quat.from_axis_angle(self.z_axis, states.block_angle)
        qa = quat.from_axis_angle(self.z_axis,
                                  torch.zeros_like(states.block_angle))
        return SE3(
            torch.stack([self.q_identity.expand(B, 4), qb, qa], dim=1),
            torch.stack([zeros1.new_zeros((B, 3)),
                         torch.cat([states.block_pos, zeros1], -1),
                         torch.cat([states.agent_pos, zeros1], -1)],
                        dim=1))

    @span("render.pose")
    def pose(self, dyn: GaussianScene, states):
        """World means and quats (B, Nd, ·) of the dynamic gaussians."""
        rel = self.body_poses(states).compose(self.graph.rest_inv)
        q_g = rel.q[:, self.dyn_ids]                         # (B, Nd, 4)
        t_g = rel.t[:, self.dyn_ids]
        return quat.rotate(q_g, dyn.means) + t_g, quat.multiply(q_g,
                                                                 dyn.quats)


def _on(graph: SceneGraph, dev) -> SceneGraph:
    return SceneGraph(graph.scene.to(dev), graph.link_ids.to(dev),
                      graph.rest_inv.to(dev))


def _fixed_camera(width: int, height: int, dev) -> Camera:
    """The reference's fixed top-down camera over the pushT table."""
    return Camera.from_fov(SE3(torch.tensor([1.0, 0, 0, 0], device=dev),
                               torch.tensor([149.0, 256.0, -450.0],
                                            device=dev)),
                           1.05, width, height)


def make_step_cached_batch(graph: SceneGraph, width: int, height: int,
                           raster: RasterConfig, dyn_capacity: int = 128,
                           sel_tiles: int = 128, dyn_max_tiles: int = 9,
                           device="cuda"):
    """The batched pushT splat env step, differentiable in the scene
    (:func:`loss_and_grads` takes its gradient).

    Returns ``(prepare, step_batch, params)``:

    - ``prepare(scene) → (cache, static_composite)``: split SH on the static
      gaussians, the static tile cache, and kernel K1 once per step;
    - ``step_batch(cache, scene, states (B, …), actions (B, 2)) →
      (new_states, imgs (B, 3, H, W), n_drop (2,) int32
      [sel_dropped_tiles, bounded_truncations])``: control step, posing of
      the two dynamic bodies, split SH, per-env projection + binning + tile
      selection, kernel K2, the select against the static composite,
      untile and a white background.  ``n_drop[0]`` must be 0 for an exact
      render.
    """
    dev = resolve_device(device)
    graph = _on(graph, dev)
    params = PushTParams()
    cam = _fixed_camera(width, height, dev)
    bodies = _Bodies(graph, dev)
    white = torch.ones(3, device=dev)

    @span("render.sh")
    def colors_of(s, means):
        if s.sh_rest is None:
            return s.colors_dc()
        return sh_ops.eval_sh_color_split(s.sh_dc, s.sh_rest,
                                          view_directions(means, cam),
                                          s.sh_degree)

    @span("render.prepare")
    def prepare(scene):
        st = scene.select(bodies.stat_idx)
        cache = build_tile_cache_raw(st.means, st.quats, st.log_scales,
                                     colors_of(st, st.means), st.opacities(),
                                     cam, raster)
        return cache, build_static_composite(cache, cam, raster)

    @span("step.batch")
    def step_batch(cache, scene, states, actions):
        cache, scomp = cache
        new_states = pusht.control_step(params, states, actions)
        dyn = scene.select(bodies.dyn_idx)
        B = actions.shape[0]
        means, quats = bodies.pose(dyn, new_states)
        cols = colors_of(dyn, means)
        Nd = dyn.means.shape[0]
        cols = cols.expand(B, Nd, 3)
        d_ls = dyn.log_scales.expand(B, Nd, 3)
        d_op = dyn.opacities().expand(B, Nd)
        imgs, aux = rasterize_cache_sel_batch(
            cache, scomp, means, quats, d_ls, cols, d_op, cam, raster,
            dyn_capacity=dyn_capacity, sel_tiles=sel_tiles,
            dyn_max_tiles=dyn_max_tiles, background=white)
        n_drop = torch.stack([
            aux.n_sel_dropped_tiles,
            aux.n_overflowed_tiles + aux.n_slot_truncated]).to(torch.int32)
        return new_states, imgs, n_drop

    return prepare, step_batch, params


def make_step_cached(graph: SceneGraph, width: int, height: int,
                     raster: RasterConfig, dyn_capacity: int = 128,
                     static_skip: bool = True, dyn_max_tiles: int = 9,
                     device="cuda"):
    """The reference's per-env pushT step under the fixed camera
    (``_make_step_cached``, which the reference vmaps over envs), batched,
    differentiable in the scene (:func:`loss_and_grads` takes its
    gradient).

    Returns ``(prepare, step, params)``:

    - ``prepare(scene) → (cache, static_composite or None)``: SH of the
      full stack on the static gaussians, the static tile cache, and with
      ``static_skip`` kernel K1 once per step;
    - ``step(cache, scene, states (B, …), actions (B, 2)) → (new_states,
      imgs (B, H, W, 3), n_trunc (B,) int32)``: control step, posing of the
      two dynamic bodies, SH of the full stack on the dynamics, per-env
      projection + binning + gather of every tile's dynamic list, kernel K4
      over every (env, tile) pair (only the touched tiles with
      ``static_skip``, the rest take the static composite), untile and a
      white background.  ``n_trunc`` counts each env's bounded truncations
      (overflowed tiles + slot-truncated gaussians), which the reference
      computes and drops.  ``raster.fused_pair=False`` merges the lists and
      composites them with K1 instead."""
    dev = resolve_device(device)
    graph = _on(graph, dev)
    params = PushTParams()
    cam = _fixed_camera(width, height, dev)
    bodies = _Bodies(graph, dev)
    white = torch.ones(3, device=dev)
    kw = dict(dyn_capacity=dyn_capacity, dyn_max_tiles=dyn_max_tiles,
              background=white)

    def prepare(scene):
        st = scene.select(bodies.stat_idx)
        if scene.sh_rest is None:
            cache = build_tile_cache_raw(st.means, st.quats, st.log_scales,
                                         st.colors_dc(), st.opacities(), cam,
                                         raster)
        else:
            cache = build_tile_cache_raw_sh(st.means, st.quats,
                                            st.log_scales, st.sh_coeffs(),
                                            st.opacities(), cam, raster,
                                            scene.sh_degree)
        return cache, (build_static_composite(cache, cam, raster)
                       if static_skip else None)

    def step(cache, scene, states, actions):
        cache, scomp = cache
        new_states = pusht.control_step(params, states, actions)
        dyn = scene.select(bodies.dyn_idx)
        means, quats = bodies.pose(dyn, new_states)
        B, Nd = actions.shape[0], dyn.means.shape[0]
        d_ls = dyn.log_scales.expand(B, Nd, 3)
        d_op = dyn.opacities().expand(B, Nd)
        if scene.sh_rest is None:
            imgs, aux = rasterize_with_cache(
                cache, scomp, means, quats, d_ls,
                dyn.colors_dc().expand(B, Nd, 3), d_op, cam, raster, **kw)
        else:
            imgs, aux = rasterize_with_cache_sh(
                cache, scomp, means, quats, d_ls, dyn.sh_coeffs(), d_op, cam,
                scene.sh_degree, raster, **kw)
        n_trunc = aux.n_overflowed_tiles + aux.n_slot_truncated
        return new_states, imgs, n_trunc.to(torch.int32)

    return prepare, step, params


def make_step(graph: SceneGraph, width: int, height: int,
              raster: RasterConfig, device="cuda"):
    """The reference's uncached per-env pushT step under the fixed camera
    (``_make_step``, which its ``entry()`` returns and its bench vmaps over
    envs with ``BENCH_CACHE=0``), batched, differentiable in the scene
    (``loss_and_grads(None, step, ...)`` takes its gradient).

    Returns ``(step, params)``, ``step(scene, states (B, …), actions
    (B, 2)) → (new_states, imgs (B, 3, H, W))``: control step, posing of
    all N gaussians per env (the static body by the identity, as the
    reference poses it), ``rasterize_raw`` of the (B, N) posed gaussians
    with their DC colours (binning per env, kernel K1 over the B·T tiles,
    untile) on a white background."""
    dev = resolve_device(device)
    graph = _on(graph, dev)
    params = PushTParams()
    cam = _fixed_camera(width, height, dev)
    bodies = _Bodies(graph, dev)
    white = torch.ones(3, device=dev)

    def step(scene, states, actions):
        new_states = pusht.control_step(params, states, actions)
        posed = graph._replace(scene=scene).posed(
            bodies.body_poses(new_states))               # means (B, N, 3)
        imgs, _ = rasterize_raw(posed.means, posed.quats, posed.log_scales,
                                posed.colors_dc(), posed.opacities(), cam,
                                raster, background=white)
        return new_states, imgs.permute(0, 3, 1, 2)

    return step, params


def entry(device="cuda"):
    """``(step, (scene, states, actions))``: the reference's ``entry()``
    example on the port, one env through :func:`make_step` (the default
    scene, 128², ``RasterConfig(tile_capacity=512, chunk=64,
    sigma_cutoff=3.0)``, state [80, 310, 149, 256, 0], action
    [150, 300])."""
    graph = build_scene(device=device)
    dev = graph.scene.means.device
    raster = RasterConfig(tile_capacity=512, chunk=64, sigma_cutoff=3.0)
    step, params = make_step(graph, 128, 128, raster, device=dev)
    states = pusht.set_state(params, torch.tensor(
        [[80.0, 310.0, 149.0, 256.0, 0.0]], device=dev))
    actions = torch.tensor([[150.0, 300.0]], device=dev)
    return step, (graph.scene, states, actions)


def _value_and_grads(scene: GaussianScene, fn, unread=()):
    """``fn(leaves) → (loss, *aux)`` on the scene's tensors made leaves that
    require grad → ``(loss, aux, grads)``, ``grads`` a GaussianScene of the
    loss's gradients (None where the scene has no ``sh_rest``; zeros for
    the fields named in ``unread``, which ``fn`` does not read, as
    ``jax.grad`` gives).  Every other field must reach the loss."""
    leaves = GaussianScene(*(None if f is None else
                             f.detach().requires_grad_() for f in scene))
    loss, *aux = fn(leaves)
    read = [f for name, f in zip(leaves._fields, leaves)
            if f is not None and name not in unread]
    with span("step.backward"):
        got = iter(torch.autograd.grad(loss, read))
    grads = GaussianScene(*(
        None if f is None else torch.zeros_like(f) if name in unread
        else next(got) for name, f in zip(leaves._fields, leaves)))
    return loss.detach(), aux, grads


@span("step.train")
def loss_and_grads(prepare, step_batch, scene: GaussianScene, states,
                   actions):
    """One train step of the batched env, as the reference's bench takes it
    (``jax.value_and_grad`` of ``mean(imgs ** 2)`` over the scene):
    ``prepare`` and ``step_batch`` from :func:`make_step_cached_batch` or
    :func:`make_step_cached`, or ``prepare=None`` and the uncached step of
    :func:`make_step` as ``step_batch``.

    The forward is ``prepare`` + ``step_batch`` (``step_batch`` alone
    without ``prepare``), and the backward runs through the step's
    backward kernels on the card (K2b or K4b, and K1b; their plain versions
    on the CPU).  Returns ``(new_states, loss, n_drop, grads)``: ``n_drop``
    is the step's third output (its truncation counters; None for the
    uncached step, which has none) and ``grads`` a GaussianScene of the
    loss's gradients to every scene field."""
    def fn(leaves):
        if prepare is None:
            new_states, imgs, *rest = step_batch(leaves, states, actions)
        else:
            new_states, imgs, *rest = step_batch(prepare(leaves), leaves,
                                                 states, actions)
        return torch.mean(imgs ** 2), new_states, (rest[0] if rest else None)

    # the uncached step colours by the DC term alone, as the reference does
    unread = ("sh_rest",) if prepare is None else ()
    loss, (new_states, n_drop), grads = _value_and_grads(scene, fn, unread)
    return new_states, loss, n_drop, grads


def _attached_cameras(states, cam_height: float, width: int, height: int):
    """Each env's agent-attached camera (the reference's get_attached_frame
    convention): identity orientation at agent_pos + (0, −40, cam_height),
    fov 1.05; one Camera with (B, ·) pose leaves."""
    pos = states.agent_pos
    B = pos.shape[0]
    t = torch.cat([pos, pos.new_zeros((B, 1))], -1) + pos.new_tensor(
        [0.0, -40.0, cam_height])
    q = pos.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(B, 4)
    return Camera.from_fov(SE3(q, t), 1.05, width, height)


def make_step_moving(graph: SceneGraph, width: int, height: int,
                     raster: RasterConfig, cam_height: float = -420.0,
                     device="cuda"):
    """The moving-camera step by full per-frame rebin: every env projects
    all N gaussians under its agent-attached camera, bins them and renders
    every tile through kernel K1.  The exactness oracle of
    :func:`make_step_moving_cached`.

    Returns ``(step, params)``, ``step(scene, states (B, …), actions
    (B, 2)) → (new_states, imgs (B, H, W, 3), n_trunc (B,) int32)``:
    control step, posing, SH, then per env ``project_raw`` and
    ``render_binned`` on a white background; ``n_trunc`` counts each env's
    bounded truncations (overflowed tiles + slot-truncated gaussians),
    which the reference computes and drops."""
    dev = resolve_device(device)
    graph = _on(graph, dev)
    params = PushTParams()
    bodies = _Bodies(graph, dev)
    white = torch.ones(3, device=dev)

    def step(scene, states, actions):
        new_states = pusht.control_step(params, states, actions)
        st = scene.select(bodies.stat_idx)
        dyn = scene.select(bodies.dyn_idx)
        d_means, d_quats = bodies.pose(dyn, new_states)
        cams = _attached_cameras(new_states, cam_height, width, height)
        if scene.sh_rest is not None:
            sh_all = torch.cat([st.sh_coeffs(), dyn.sh_coeffs()])
        opac = torch.cat([st.opacities(), dyn.opacities()])
        imgs, n_trunc = [], []
        for b in range(d_means.shape[0]):
            cam = Camera.from_fov(SE3(cams.pose.q[b], cams.pose.t[b]), 1.05,
                                  width, height)
            ps = project_raw(st.means, st.quats, st.log_scales, cam)
            pd = project_raw(d_means[b], d_quats[b], dyn.log_scales, cam)
            proj = Projected(*[torch.cat([a, c]) for a, c in zip(ps, pd)])
            if scene.sh_rest is None:
                colors = torch.cat([st.colors_dc(), dyn.colors_dc()])
            else:
                dirs = view_directions(torch.cat([st.means, d_means[b]]), cam)
                colors = sh_ops.eval_sh_color(sh_all, dirs, scene.sh_degree)
            img, aux = render_binned(proj, colors, opac, cam, raster,
                                     background=white)
            imgs.append(img)
            n_trunc.append(aux.n_overflowed_tiles + aux.n_slot_truncated)
        return (new_states, torch.stack(imgs),
                torch.stack(n_trunc).to(torch.int32))

    return step, params


def make_step_moving_cached(graph: SceneGraph, width: int, height: int,
                            raster: RasterConfig, R: int = 32,
                            margin: float = 16.0, kc: int = 512,
                            dyn_capacity: int = 128, dyn_max_tiles: int = 9,
                            cam_height: float = -420.0, z_split: float = 0.0,
                            device="cuda"):
    """The moving-camera rollout over per-env candidate caches: R frames of
    a camera attached to each env's agent, differentiable in the scene
    (:func:`rollout_loss_and_grads` takes its gradient).

    Returns ``(rollout, params)``, ``rollout(scene, states (B, …), actions
    (B, 2)) → (new_states, loss, flags (2,) int32)``: one candidate cache
    per env from the initial states (``build_moving_cache``), then R times
    the same ``actions``: control step, posing, split SH of the dynamics,
    ``render_moving_batch`` (kernel K3) and ``mean(imgs²)``.  ``loss`` is
    the frames' mean.  ``flags[0]`` counts the severe env-frames (camera
    past its margin budget, plus near-set overflow): the render is then no
    longer provably exact and must be 0; ``flags[1]`` the bounded
    truncations (dynamic-list overflow and slot cuts per frame, build-time
    cuts once)."""
    dev = resolve_device(device)
    graph = _on(graph, dev)
    params = PushTParams()
    bodies = _Bodies(graph, dev)
    bcfg = rasterize_moving.dilated_build_config(raster, margin)
    white = torch.ones(3, device=dev)

    def rollout(scene, states, actions):
        st = scene.select(bodies.stat_idx)
        dyn = scene.select(bodies.dyn_idx)
        caches = rasterize_moving.build_moving_cache(
            st.means, st.quats, st.log_scales,
            st.sh_coeffs().reshape(st.means.shape[0], -1), st.opacities(),
            _attached_cameras(states, cam_height, width, height), bcfg,
            kc=kc, margin=margin, z_split=z_split)
        B, Nd = actions.shape[0], dyn.means.shape[0]
        d_ls = dyn.log_scales.expand(B, Nd, 3)
        d_op = dyn.opacities().expand(B, Nd)
        loss = 0.0
        viol = trunc = torch.zeros((), dtype=torch.long, device=dev)
        for _ in range(R):
            states = pusht.control_step(params, states, actions)
            means, quats = bodies.pose(dyn, states)
            cams = _attached_cameras(states, cam_height, width, height)
            if scene.sh_rest is None:
                cols = dyn.colors_dc().expand(B, Nd, 3)
            else:
                cols = sh_ops.eval_sh_color_split(
                    dyn.sh_dc, dyn.sh_rest, view_directions(means, cams),
                    scene.sh_degree)
            imgs, aux = rasterize_moving.render_moving_batch(
                caches, cams, means, quats, d_ls, cols, d_op, raster,
                scene.sh_degree, dyn_capacity=dyn_capacity,
                dyn_max_tiles=dyn_max_tiles, background=white)
            viol = viol + torch.sum(
                rasterize_moving.camera_budget_used(caches, cams) > 1.0)
            trunc = trunc + aux.n_overflowed_tiles + aux.n_slot_truncated
            loss = loss + torch.mean(imgs ** 2)
        # build-time counters, once per rollout
        viol = viol + torch.sum(caches.n_near_over)
        trunc = trunc + torch.sum(caches.n_build_truncated)
        return states, loss / R, torch.stack([viol, trunc]).to(torch.int32)

    return rollout, params


def rollout_loss_and_grads(rollout, scene: GaussianScene, states, actions):
    """The train step of the moving-camera rollout, as the reference's bench
    takes it (``jax.value_and_grad`` of the rollout's loss over the scene):
    ``rollout`` from :func:`make_step_moving_cached`.  The backward runs
    through every frame's K3b and the cache build on the card (the plain
    versions on the CPU).  Returns ``(new_states, loss, flags, grads)``,
    ``grads`` a GaussianScene of the gradients to every scene field."""
    def fn(leaves):
        new_states, loss, flags = rollout(leaves, states, actions)
        return loss, new_states, flags

    loss, (new_states, flags), grads = _value_and_grads(scene, fn)
    return new_states, loss, flags, grads


# --- the arm product path ----------------------------------------------------

PRODUCT_URDF = (Path(__file__).resolve().parent.parent / "robot_description"
                / "pusharm6" / "urdf" / "pusharm6.urdf")
# the product path's raster and render settings (bench_product.py)
PRODUCT_RASTER = dict(tile_size=16, tile_capacity=1024, chunk=128,
                      sigma_cutoff=3.0, term_eps=1e-4,
                      buckets=((2, 0.70), (6, 0.20), (16, 0.10)))
PRODUCT_RENDER = dict(sel_tiles=256, dyn_capacity=256, dyn_max_tiles=9,
                      margin=16.0, kc=512, z_split=0.35, near_cap=16384)
PRODUCT_RESET = {"robot_pos": np.zeros(6),
                 "block_pos": np.array([0.45, 0.0, 0.2, 0.0])}
PRODUCT_ACTION = (0.0, 0.3, 0.4, 0.0, 0.4, 0.0)
PRODUCT_BLOCK_REST = (0.45, 0.0, 0.0)
# the reference's ManipulatorState leaves (numpy, by field name; ``arm`` as
# (q, qd, target_prev)) as the port's batched state
product_state_from_numpy = state_from_numpy


def product_scene(n_total=100_000, sh_degree=3, seed=0, chain=None,
                  device="cuda"):
    """The arm product scene (``bench_product.py``'s draws): a background
    cloud, one cluster per link of ``chain`` (default ``pusharm6``) at its
    rest pose (the port's ``fk`` at q = 0) and a T-block cluster, drawn with
    the reference's ``numpy.random.default_rng(seed)`` calls in its order.
    Returns ``(scene, link_masks)``: masks ``link{i}`` for link i of the
    chain and ``task`` for the block, as :func:`build_product_wrapper`
    takes them."""
    dev = resolve_device(device)
    chain = kin.load_chain(PRODUCT_URDF) if chain is None else chain
    rng = np.random.default_rng(seed)
    rest_fk = kin.fk(chain, torch.zeros(6))
    n_links = rest_fk.q.shape[0]
    n_link = max(n_total // 50, 50)
    n_block = max(n_total // 25, 50)
    n_bg = n_total - n_links * n_link - n_block

    def cluster(center, n, color, spread):
        c = np.asarray(center, np.float32)
        q = rng.normal(size=(n, 4))
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        rgb = np.clip(color + rng.normal(0, 0.05, (n, 3)), 0, 1)
        return dict(
            means=rng.normal(size=(n, 3)) * spread + c, quats=q,
            log_scales=rng.uniform(np.log(0.004), np.log(0.012), (n, 3)),
            logit_opacities=np.full(n, 2.0, np.float32),
            sh_dc=(rgb - 0.5) / sh_ops.C0)

    parts = [cluster([0.2, 0.0, -0.6], n_bg, [0.8, 0.8, 0.75], 0.8)]
    sizes = [n_bg]
    rest_t_np = rest_fk.t.numpy()
    for i in range(n_links):
        parts.append(cluster(rest_t_np[i], n_link, [0.3, 0.4, 0.8], 0.05))
        sizes.append(n_link)
    parts.append(cluster(PRODUCT_BLOCK_REST, n_block, [0.6, 0.55, 0.5],
                         0.06))
    sizes.append(n_block)

    def cat(k):
        return torch.as_tensor(np.concatenate([p[k] for p in parts]).astype(
            np.float32), device=dev)

    n = sum(sizes)
    k_rest = (sh_degree + 1) ** 2 - 1
    sh_rest = None if sh_degree == 0 else torch.as_tensor(
        rng.normal(0, 0.02, (n, k_rest, 3)).astype(np.float32), device=dev)
    scene = GaussianScene(cat("means"), cat("quats"), cat("log_scales"),
                          cat("logit_opacities"), cat("sh_dc"), sh_rest)

    off = np.cumsum([0] + sizes)
    masks = {}
    for i in range(n_links):
        m = np.zeros(n, bool)
        m[off[i + 1]:off[i + 2]] = True
        masks[f"link{i}"] = m
    mt = np.zeros(n, bool)
    mt[off[-2]:off[-1]] = True
    masks["task"] = mt
    return scene, masks


def build_product_wrapper(n_total=100_000, sh_degree=3, seed=0,
                          render_size=(240, 320), raster=None,
                          device="cuda", scene=None, link_masks=None):
    """The arm product scene and its wrapper (``bench_product.py``'s
    ``build_product_wrapper``): ``pusharm6`` with the end effector
    ``push_tool`` in the scene of :func:`product_scene` (``n_total``,
    ``sh_degree``, ``seed``), or in ``scene`` with ``link_masks`` where
    both are given (masks ``link{i}`` for link i of the chain, ``task`` for
    the block, whose rest pose is (0.45, 0, 0)); camera key 0 a fixed
    viewport and key 1 on the end effector (offset (0, −0.15, −1.2) in
    world axes), both ``render_size`` (h, w), fov 1.05 (moving cameras
    render first: ``camera_0`` of the observation is the end effector's);
    ``raster`` default :data:`PRODUCT_RASTER`."""
    dev = resolve_device(device)
    chain = kin.load_chain(PRODUCT_URDF)
    env = ManipulatorEnvF(chain=chain, eef_link="push_tool",
                          env_objects=True, device=str(dev))
    if (scene is None) != (link_masks is None):
        raise ValueError("give both scene and link_masks, or neither")
    if scene is None:
        scene, link_masks = product_scene(n_total, sh_degree, seed, chain,
                                          dev)
    rest_fk = kin.fk(chain, torch.zeros(6))
    ident = SE3.identity((1,))
    block_t = torch.as_tensor(PRODUCT_BLOCK_REST, dtype=torch.float32)[None]
    rest = SE3(torch.cat([ident.q, rest_fk.q,
                          torch.tensor([[1.0, 0.0, 0.0, 0.0]])]),
               torch.cat([ident.t, rest_fk.t, block_t]))
    h, w = render_size
    cameras = {
        0: CameraSpec(type="viewport", render_size=(h, w),
                      local_frame=((1.0, 0, 0, 0), (0.4, -0.2, -1.6)),
                      fov=1.05),
        1: CameraSpec(type="moving", render_size=(h, w),
                      link_name="push_tool",
                      local_frame=((1.0, 0, 0, 0), (0.0, -0.15, -1.2)),
                      fov=1.05),
    }
    return SplatEnvWrapperF.build(
        env=env, scene=scene, link_masks=link_masks,
        camera_setup_info=cameras, task_mask_key="task",
        rest_poses_world=rest.to(dev), scene_frame="world",
        raster=RasterConfig(**PRODUCT_RASTER) if raster is None else raster)


def product_inputs(wrapper, B: int, R: int, settle: int = 40,
                   dither: float = 0.004):
    """The bench's rollout inputs: ``B`` envs reset to the arm at rest and
    the block at (0.45, 0), settled for ``settle`` steps at the base action
    (the reset transient has no frame coherence), and (R, B, 6) actions of
    a mm-scale joint dither about it (``bench_product.py:181-195``)."""
    env = wrapper._base_env()
    states, _ = env.reset(reset_to_state=PRODUCT_RESET, batch=B)
    dev = states.arm.q.device
    base = torch.tensor(PRODUCT_ACTION, device=dev)
    with torch.no_grad():
        for _ in range(settle):
            states = env.step(states, base.expand(B, 6)).state
    phase = torch.sin(2 * math.pi * torch.arange(R, device=dev) / R)
    pattern = torch.tensor([0.0, 1.0, -1.0, 0.0, 1.0, 0.0], device=dev)
    actions = base + dither * phase[:, None, None] * pattern
    return states, actions.expand(R, B, 6).contiguous()


def make_product_rollout(wrapper, sel_tiles=256, dyn_capacity=256,
                         dyn_max_tiles=9, margin=16.0, kc=512, z_split=0.35,
                         near_cap=16384):
    """The arm product path's rollout and teleop step (``bench_product.py``
    ``measure_product`` and ``measure_latency``), defaults
    :data:`PRODUCT_RENDER`.  Returns ``(rollout, step, build_moving)``:

    - ``rollout(scene, states (B, …), actions_seq (R, B, 6)) →
      (transitions, loss)``: the fixed cameras' static caches built from
      ``scene`` (K1), then ``rollout_with_cache_batch`` (K2 and K3 every
      frame); ``loss`` = mean(camera_0²) + mean(camera_1²), differentiable
      in ``scene`` (:func:`product_loss_and_grads`);
    - ``step(states, actions, caches, moving_caches)``: one
      ``step_with_cache_batch`` over prebuilt caches (the teleop step);
    - ``build_moving(states)``: the moving cameras' candidate caches at
      ``states`` (the teleop loop's rebuild)."""
    kw = dict(sel_tiles=sel_tiles, dyn_capacity=dyn_capacity,
              dyn_max_tiles=dyn_max_tiles)

    def rollout(scene, states, actions_seq):
        w = dataclasses.replace(wrapper,
                                graph=wrapper.graph._replace(scene=scene))
        trs = w.rollout_with_cache_batch(
            states, actions_seq, w.build_render_cache(scene),
            moving_margin=margin, moving_kc=kc, moving_z_split=z_split,
            moving_near_cap=near_cap, **kw)
        loss = (torch.mean(trs.obs["camera_0"] ** 2)
                + torch.mean(trs.obs["camera_1"] ** 2))
        return trs, loss

    def step(states, actions, caches, moving_caches):
        return wrapper.step_with_cache_batch(states, actions, caches,
                                             moving_caches=moving_caches,
                                             **kw)

    def build_moving(states):
        draws = wrapper._base_env().draw_state(states)
        return wrapper.build_moving_caches(draws, margin=margin, kc=kc,
                                           z_split=z_split, near_cap=near_cap)

    return rollout, step, build_moving


def make_product_collect(wrapper):
    """The arm product path's data-collection step at
    :data:`PRODUCT_RENDER`: ``collect(states, actions, caches,
    moving_caches=None) → (transition, moving_caches)`` drives every env
    of the batch through one control step and renders both cameras.

    ``caches`` are the fixed cameras' (``wrapper.build_render_cache``);
    ``moving_caches`` the end-effector camera's from the last call, or
    None at an episode's start, when they are built from ``states``.
    After ``env.step`` the camera is posed at the new state, and each env
    whose camera would use more than its cache's margin budget there
    (``camera_budget_used`` > 1) has its moving caches rebuilt from the
    new state (``wrapper.rebuild_moving_caches``: those envs alone, the
    rest keep theirs); then ``render_with_cache_batch`` renders both
    cameras, as ``step_with_cache_batch`` does, without computing the
    budget again.  So no frame it returns is severe for the budget:
    ``info['render_overflow']`` counts only near-set overflow and dynamics
    dropped from unselected tiles.  ``info['render_rebuilt']`` (B,) int32
    marks the envs rebuilt in this step.  Returns the transition and the
    moving caches it rendered with, for the next call.  The root span of a
    call is ``step.arm``."""
    kw = {k: PRODUCT_RENDER[k] for k in ("sel_tiles", "dyn_capacity",
                                         "dyn_max_tiles")}
    build = {k: PRODUCT_RENDER[k] for k in ("margin", "kc", "z_split",
                                            "near_cap")}
    env = wrapper._base_env()

    @span("step.arm")
    def collect(states, actions, caches, moving_caches=None):
        if moving_caches is None:
            moving_caches = wrapper.build_moving_caches(
                env.draw_state(states), **build)
        tr = wrapper.env.step(states, actions)
        draws = env.draw_state(tr.state)
        moving_caches, rebuilt = wrapper.rebuild_moving_caches(
            moving_caches, draws, **build)
        imgs, aux = wrapper.render_with_cache_batch(
            tr.state, caches, draws=draws, moving_caches=moving_caches,
            within_budget=True, **kw)
        out = wrapper._with_images(tr, imgs, aux)
        out.info["render_rebuilt"] = rebuilt.to(torch.int32)
        return out, moving_caches

    return collect


def product_loss_and_grads(rollout, scene: GaussianScene, states,
                           actions_seq):
    """The product path's train step, as the bench takes it
    (``jax.value_and_grad`` of the rollout's loss over the scene):
    ``rollout`` from :func:`make_product_rollout`.  Returns
    ``(transitions, loss, grads)``, the transitions' tensors detached and
    ``grads`` a GaussianScene of the gradients to every scene field."""
    def fn(leaves):
        trs, loss = rollout(leaves, states, actions_seq)
        return loss, trs

    loss, (trs,), grads = _value_and_grads(scene, fn)
    return _detached(trs), loss, grads


def _detached(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_detached(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree



# --- the splat trainer's protocol (benchmarks/train_scene.py) ---------------

def ring_cameras(n_views: int, radius: float, height: float, res: int,
                 fov: float = 0.9, device="cuda") -> list:
    """Cameras on a circle, all looking at the origin (OpenCV +z forward),
    with the script's numpy arithmetic."""
    dev = resolve_device(device)
    cams = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        pos = np.asarray([radius * np.cos(ang), radius * np.sin(ang), height],
                         np.float32)
        # look-at: +z toward origin, up = world -y-ish
        z = -pos / np.linalg.norm(pos)
        up = np.asarray([0.0, 0.0, -1.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x) + 1e-12
        y = np.cross(z, x)
        R = np.stack([x, y, z], axis=1)          # columns = camera axes
        # rotation matrix → wxyz quaternion (Shepperd)
        w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
        qx = (R[2, 1] - R[1, 2]) / (4 * w + 1e-12)
        qy = (R[0, 2] - R[2, 0]) / (4 * w + 1e-12)
        qz = (R[1, 0] - R[0, 1]) / (4 * w + 1e-12)
        q = np.asarray([w, qx, qy, qz], np.float32)
        q /= np.linalg.norm(q)
        cams.append(Camera.from_fov(
            SE3(torch.as_tensor(q, device=dev),
                torch.as_tensor(pos, device=dev)), fov, res, res))
    return cams


def train_scene_inputs(n: int = 12000, views: int = 8, res: int = 128,
                       seed: int = 0, iters: int = 2000, device="cuda"):
    """``benchmarks/train_scene.py``'s protocol: (gt, init, cameras,
    TrainConfig, RasterConfig).  The ground truth is ``synthetic_scene(n,
    seed, extent 0.9, scales 0.02-0.06, sh_degree 1)``; the degraded init
    keeps n // 2 of its means (numpy's ``default_rng(seed + 1)``, the
    script's draws in its order) jittered by N(0, 0.03²), unit quats,
    scales 0.05, opacity 0.5 and zero colours; ``views`` ring cameras at
    ``res``²; the script's config at ``iters`` iterations (refinement
    every iters // 5) and its raster (K = 512, ``term_eps`` 1e-4)."""
    dev = resolve_device(device)
    gt = synthetic_scene(n, seed=seed, extent=0.9, scale_range=(0.02, 0.06),
                         sh_degree=1, device=dev)
    cams = ring_cameras(views, radius=3.2, height=-1.2, res=res, device=dev)
    rng = np.random.default_rng(seed + 1)
    keep = rng.choice(n, size=n // 2, replace=False)
    m = n // 2
    init = GaussianScene(*(torch.as_tensor(np.asarray(a, np.float32),
                                           device=dev) for a in (
        gt.means.cpu().numpy()[keep] + rng.normal(0, 0.03, (m, 3)),
        np.tile([1.0, 0, 0, 0], (m, 1)),
        np.full((m, 3), np.log(0.05)),
        np.full(m, 0.0),
        np.zeros((m, 3)),
        np.zeros((m, 3, 3)))))
    lr_scale = 6.0      # splatfacto's LRs are tuned for 30k iterations
    cfg = TrainConfig(
        iters=iters,
        lr_means=1.6e-4 * lr_scale, lr_means_final=1.6e-6 * lr_scale,
        lr_sh_dc=2.5e-3 * lr_scale, lr_sh_rest=1.25e-4 * lr_scale,
        lr_opacities=5e-2, lr_scales=5e-3 * lr_scale,
        lr_quats=1e-3 * lr_scale,
        refine_every=iters // 5, refine_start=iters // 5,
        densify_grad_thresh=2e-4, densify_size_thresh=0.04,
        cull_alpha_thresh=0.08, cull_scale_thresh=1.0,
        ssim_lambda=0.2, reset_alpha_every=0)
    raster = RasterConfig(tile_capacity=512, max_tiles_per_gaussian=16,
                          chunk=128, sigma_cutoff=3.0, term_eps=1e-4)
    return gt, init, cams, cfg, raster


# --- the multi-rank dry run (the reference's dryrun_multichip) ----------------

DRYRUN_PATHS = ("plain", "cached+fused-pair (K4)", "sel-batch (K1, K2)",
                "moving (bucketed)", "moving-cached (K3)", "prim-sharded (K1)")


def _dryrun_inputs(B: int, device, vecs=None):
    """The dry run's scene (``build_scene(256, 64, 32)``), its steps at
    32×32 with the reference's configs, and B envs' states and actions:
    the states ``set_state`` of ``vecs`` (B, 5) where given (e.g. the
    reference's reset draws), else a reset from seed 0."""
    dev = resolve_device(device)
    graph = build_scene(n_bg=256, n_block=64, n_agent=32, device=dev)
    raster = RasterConfig(tile_size=16, tile_capacity=64,
                          max_tiles_per_gaussian=9, chunk=32,
                          sigma_cutoff=3.0)
    raster_prod = RasterConfig(tile_size=16, tile_capacity=128,
                               max_tiles_per_gaussian=9, chunk=32,
                               sigma_cutoff=3.0, term_eps=1e-4)
    step, params = make_step(graph, 32, 32, raster, device=dev)
    parts = dict(
        raster=raster, step=step, camera=_fixed_camera(32, 32, dev),
        cached=make_step_cached(graph, 32, 32, raster_prod, dyn_capacity=128,
                                static_skip=True, dyn_max_tiles=9,
                                device=dev)[:2],
        sel=make_step_cached_batch(graph, 32, 32, raster_prod,
                                   dyn_capacity=128, sel_tiles=4,
                                   dyn_max_tiles=9, device=dev)[:2],
        moving=make_step_moving(graph, 32, 32, raster._replace(
            buckets=((2, 0.5), (4, 0.3), (9, 0.2))), device=dev)[0],
        moving_cached=make_step_moving_cached(
            graph, 32, 32, raster_prod, R=2, margin=8.0, kc=128,
            dyn_capacity=128, dyn_max_tiles=9, device=dev)[0])
    if vecs is None:
        states = pusht.reset(params, torch.Generator().manual_seed(0), B)
        states = pusht.PushTState(*(f.to(dev) for f in states))
    else:
        states = pusht.set_state(params, torch.tensor(
            np.asarray(vecs), dtype=torch.float32, device=dev))
    actions = torch.tensor([[150.0, 250.0]], device=dev).repeat(B, 1)
    return graph, parts, states, actions


def _dryrun_loss(parts, scene: GaussianScene, states, actions, render):
    """The dry run's loss over these envs: the five env branches' means
    (each a mean over the envs given) and the whole-scene render's
    mean(img²), ``render(means, covs, colors, opacities, camera, raster)``
    → (H, W, 3)."""
    _, imgs = parts["step"](scene, states, actions)
    loss = torch.mean(imgs ** 2)
    prepare_c, step_c = parts["cached"]
    _, imgs_c, _ = step_c(prepare_c(scene), scene, states, actions)
    loss = loss + torch.mean(imgs_c ** 2)
    prepare_s, step_s = parts["sel"]
    _, imgs_s, _ = step_s(prepare_s(scene), scene, states, actions)
    loss = loss + torch.mean(imgs_s ** 2)
    _, imgs_m, _ = parts["moving"](scene, states, actions)
    loss = loss + torch.mean(imgs_m ** 2)
    _, l_mc, _ = parts["moving_cached"](scene, states, actions)
    img1 = render(scene.means, scene.covs(), scene.colors_dc(),
                  scene.opacities(), parts["camera"], parts["raster"])
    return loss + l_mc + torch.mean(img1 ** 2)


def dryrun_single(n_ranks: int = 4, device="cuda", vecs=None):
    """The dry run's loss over ``n_ranks`` ranks' envs and its gradient to
    the scene, computed in one process (every env here; the whole-scene
    render by ``rasterize_prim_shards``, the prim group's render without
    its collectives): what every rank of :func:`dryrun_multichip` must
    report before its SGD step.  Returns (loss, grads: a GaussianScene)."""
    from sim_a_splat_torch.parallel.render_sharding import (
        rasterize_prim_shards,
    )
    prim = 2 if n_ranks % 2 == 0 else 1
    graph, parts, states, actions = _dryrun_inputs(n_ranks // prim * 2,
                                                   device, vecs)

    def fn(scene):
        return (_dryrun_loss(parts, scene, states, actions,
                             lambda *a: rasterize_prim_shards(
                                 prim, *a, send_capacity=32)),)

    loss, _, grads = _value_and_grads(graph.scene, fn)
    return float(loss), grads


def _dryrun_rank(device, vecs=None):
    """One rank of :func:`dryrun_multichip`: mesh env = n/2 × prim = 2, the
    global batch of 2 envs per env shard, one train step (this rank's envs
    and its prim shard of the render; the gradient through the exchange,
    a mean over env; SGD lr 1e-6)."""
    import torch.distributed as dist
    from sim_a_splat_torch.parallel import (
        make_mesh, make_train_step, rasterize_sharded,
    )
    n = dist.get_world_size()
    prim = 2 if n % 2 == 0 else 1
    mesh = make_mesh(env=n // prim, prim=prim, device=device)
    graph, parts, states, actions = _dryrun_inputs(n // prim * 2, device,
                                                   vecs)
    leaves = GaussianScene(*(None if f is None else
                             f.detach().clone().requires_grad_()
                             for f in graph.scene))
    opt = torch.optim.SGD([f for f in leaves if f is not None], lr=1e-6)

    def render(*args):
        return rasterize_sharded(mesh, *args, send_capacity=32)

    def loss_fn(scene, batch):
        return _dryrun_loss(parts, scene, *batch, render)

    before = profiling.launches.copy()
    loss = make_train_step(loss_fn, opt, mesh)(leaves, (states, actions))
    launches = {op + sfx: profiling.launches[op + sfx] - before[op + sfx]
                for op in ("composite_static", "composite_pair_sel",
                           "composite_sel_single", "composite_pair")
                for sfx in ("", "_bwd")}
    return {"loss": float(loss), "mesh": dict(zip(mesh.mesh_dim_names,
                                                  mesh.shape)),
            "launches": launches,
            "grads": {k: f.grad for k, f in leaves._asdict().items()
                      if f is not None}}


def dryrun_ranks(n_ranks: int, backend: str = "nccl", device="cuda",
                 vecs=None) -> list:
    """:func:`dryrun_multichip`'s ranks' results, by rank: {"loss", "mesh",
    "launches" (K1-K4's forward and backward launches on the rank, by
    operator name),
    "grads" (the gradient the SGD step took, by scene field)}; ``vecs``
    as :func:`_dryrun_inputs` takes them."""
    from sim_a_splat_torch.parallel import launch
    return launch(_dryrun_rank, n_ranks, backend, device, device, vecs)


def dryrun_report(n_ranks: int, results: list) -> float:
    """The ranks' results of :func:`dryrun_ranks` → the loss, after the
    reference's report line; raises where a loss is not finite or the
    ranks disagree."""
    losses = [r["loss"] for r in results]
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite loss {losses}")
    if max(losses) - min(losses) > 1e-6 * abs(losses[0]):
        raise RuntimeError(f"the ranks' losses disagree: {losses}")
    print(f"dryrun_multichip({n_ranks}): mesh={results[0]['mesh']} "
          f"loss={losses[0]:.4f} ok [paths: {', '.join(DRYRUN_PATHS)}]")
    return losses[0]


def dryrun_multichip(n_ranks: int = 4, backend: str = "nccl",
                     device="cuda", vecs=None) -> float:
    """The reference's ``dryrun_multichip`` on ``n_ranks`` processes of one
    ``backend`` (the caller's: NCCL needs one card per rank; gloo runs
    several ranks on one card or on the CPU): the full train step over an
    env = n/2 × prim = 2 mesh at the reference's tiny shapes (its scene,
    32×32, its six configs), the six branches' loss summed (the plain
    uncached step, the cached fused-pair step on K4, the selected-tile
    batch on K1 and K2, the bucketed moving camera, the candidate-cache
    rollout on K3, and the prim-sharded whole-scene render on K1 through
    the exchange), its gradient all-reduced over env, one SGD step
    (lr 1e-6).  The envs start from ``vecs`` (B, 5) where given (the
    reference draws them from its keys), else from a reset of seed 0.
    Prints the reference's line and returns the loss; raises where it is
    not finite or the ranks disagree."""
    return dryrun_report(n_ranks, dryrun_ranks(n_ranks, backend, device,
                                               vecs))


# --- the scaling protocol (benchmarks/scaling.py's bench_mesh) ---------------

SCALING_RASTER = dict(tile_size=16, tile_capacity=1024,
                      max_tiles_per_gaussian=16, chunk=128, sigma_cutoff=3.0)


def scaling_inputs(B: int = 32, N: int = 20_000, res: int = 128,
                   device="cuda"):
    """``benchmarks/scaling.py``'s inputs: the pushT scene at N gaussians
    (``build_scene`` with N/20 block and N/50 agent gaussians), the
    uncached step (:func:`make_step`, kernel K1 over every env's tiles) at
    ``res``² with its raster, and B envs' states and actions [150, 250].
    Returns (scene, step, states, actions)."""
    dev = resolve_device(device)
    nb, na = max(N // 20, 100), max(N // 50, 50)
    graph = build_scene(n_bg=N - nb - na, n_block=nb, n_agent=na, seed=0,
                        device=dev)
    step, params = make_step(graph, res, res, RasterConfig(**SCALING_RASTER),
                             device=dev)
    states = pusht.reset(params, torch.Generator().manual_seed(0), B)
    states = pusht.PushTState(*(f.to(dev) for f in states))
    actions = torch.tensor([[150.0, 250.0]], device=dev).repeat(B, 1)
    return graph.scene, step, states, actions


def scaling_step(step, mesh=None):
    """The protocol's step: ``fwd_bwd(scene, states, actions)`` over the
    global batch → (new_states, loss, grads): mean(imgs²) of the uncached
    step and its gradient to the scene (a GaussianScene).  With an
    env-only ``mesh`` each rank steps its own rows, and the loss and the
    gradient are all-reduced as means over env (every rank returns the
    global batch's); new_states are this rank's."""
    from sim_a_splat_torch.parallel import mean_over_env, shard_batch

    def fwd_bwd(scene, states, actions):
        if mesh is not None:
            states, actions = shard_batch(mesh, (states, actions))
        new_states, loss, _, grads = loss_and_grads(None, step, scene,
                                                    states, actions)
        if mesh is not None:
            loss, grads = mean_over_env(mesh, (loss, grads))
        return new_states, loss, grads

    return fwd_bwd


def _bench_mesh_rank(B, N, res, iters, device):
    import time

    import torch.distributed as dist
    from sim_a_splat_torch.parallel import make_mesh
    mesh = make_mesh(device=device)
    scene, step, states, actions = scaling_inputs(B, N, res, device)
    fwd_bwd = scaling_step(step, mesh)
    sync = torch.cuda.synchronize if scene.means.is_cuda else (lambda: None)
    _, loss, grads = fwd_bwd(scene, states, actions)      # warm-up
    sync()
    dist.barrier()
    before = profiling.launches.copy()
    t0 = time.perf_counter()
    for _ in range(iters):
        _, loss, grads = fwd_bwd(scene, states, actions)
    sync()
    seconds = time.perf_counter() - t0
    return {"seconds": seconds, "loss": float(loss),
            "grads": {k: v for k, v in grads._asdict().items()
                      if v is not None},
            "launches": profiling.launches["composite_static"]
            - before["composite_static"],
            "launches_bwd": profiling.launches["composite_static_bwd"]
            - before["composite_static_bwd"]}


def bench_mesh(n_ranks: int, backend: str = "nccl", B: int = 32,
               N: int = 20_000, res: int = 128, iters: int = 10,
               device="cuda"):
    """``benchmarks/scaling.py``'s ``bench_mesh`` on ``n_ranks`` processes
    (an env-only mesh; ``backend`` the caller's): ``iters`` timed train
    steps of :func:`scaling_step` after one warm-up, each rank on the host
    clock ending in a device synchronise.  Returns (frames/s = B·iters /
    the slowest rank's seconds, the ranks' results: seconds, loss, the
    gradient's fields, K1f / K1b launches in the timed steps)."""
    from sim_a_splat_torch.parallel import launch
    res_ = launch(_bench_mesh_rank, n_ranks, backend, device, B, N, res,
                  iters, device)
    return B * iters / max(r["seconds"] for r in res_), res_
