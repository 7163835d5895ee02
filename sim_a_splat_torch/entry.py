"""Entry points of the port: the pushT splat scene, the batched env step
and its train step, the per-env fixed-camera step, and the moving-camera
rollout.

Port of ``_build_scene``, ``_make_step_cached_batch``, ``_make_step_cached``,
``_make_step_moving`` and ``_make_step_moving_cached`` of the reference's
entry module (``__graft_entry__.py``):

- a batch of pushT envs under one fixed camera, the static background
  binned and composited once per step (kernel K1) and each env's touched
  tiles composited against it (kernel K2); ``loss_and_grads`` is the train
  step of the reference's bench (``bench.py``): the mean-square image loss
  and its gradient to every gaussian parameter, through the backward
  kernels K1b and K2b;
- the same envs through the reference's per-env step (its vmapped
  ``_make_step_cached``, batched here): every tile of every env composited
  against the static lists without a merge (kernel K4, K4b in training);
- a camera attached to each env's agent: the R-frame rollout over per-env
  candidate caches (kernel K3, ``rollout_loss_and_grads`` its train step
  through K3b), and the full per-frame rebin (kernel K1) that is its
  exactness oracle.

Everything runs on ``device`` ("cuda" by default); ``device="cpu"`` runs
the plain PyTorch path (what the tests compare against the reference).
"""

from __future__ import annotations

import numpy as np
import torch

from sim_a_splat_torch import resolve_device
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
from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig, render_binned
from sim_a_splat_torch.ops.transforms import SE3
from sim_a_splat_torch.physics import pusht
from sim_a_splat_torch.physics.pusht import PushTParams
from sim_a_splat_torch.scenegraph.graph import SceneGraph
from sim_a_splat_torch.splat.scene import GaussianScene

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

    def pose(self, dyn: GaussianScene, states):
        """World means and quats (B, Nd, ·) of the dynamic gaussians."""
        B = states.block_angle.shape[0]
        zeros1 = states.block_angle.new_zeros((B, 1))
        qb = quat.from_axis_angle(self.z_axis, states.block_angle)
        qa = quat.from_axis_angle(self.z_axis,
                                  torch.zeros_like(states.block_angle))
        body_poses = SE3(
            torch.stack([self.q_identity.expand(B, 4), qb, qa], dim=1),
            torch.stack([zeros1.new_zeros((B, 3)),
                         torch.cat([states.block_pos, zeros1], -1),
                         torch.cat([states.agent_pos, zeros1], -1)],
                        dim=1))                              # (B, 3)
        rel = body_poses.compose(self.graph.rest_inv)
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

    def colors_of(s, means):
        if s.sh_rest is None:
            return s.colors_dc()
        return sh_ops.eval_sh_color_split(s.sh_dc, s.sh_rest,
                                          view_directions(means, cam),
                                          s.sh_degree)

    def prepare(scene):
        st = scene.select(bodies.stat_idx)
        cache = build_tile_cache_raw(st.means, st.quats, st.log_scales,
                                     colors_of(st, st.means), st.opacities(),
                                     cam, raster)
        return cache, build_static_composite(cache, cam, raster)

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


def _value_and_grads(scene: GaussianScene, fn):
    """``fn(leaves) → (loss, *aux)`` on the scene's tensors made leaves that
    require grad → ``(loss, aux, grads)``, ``grads`` a GaussianScene of the
    loss's gradients (None where the scene has no ``sh_rest``)."""
    leaves = GaussianScene(*(None if f is None else
                             f.detach().requires_grad_() for f in scene))
    loss, *aux = fn(leaves)
    fields = [f for f in leaves if f is not None]
    got = iter(torch.autograd.grad(loss, fields))
    grads = GaussianScene(*(None if f is None else next(got) for f in leaves))
    return loss.detach(), aux, grads


def loss_and_grads(prepare, step_batch, scene: GaussianScene, states,
                   actions):
    """One train step of the batched env, as the reference's bench takes it
    (``jax.value_and_grad`` of ``mean(imgs ** 2)`` over the scene):
    ``prepare`` and ``step_batch`` from :func:`make_step_cached_batch` or
    :func:`make_step_cached`.

    The forward is ``prepare`` + ``step_batch``, and the backward runs
    through the step's backward kernels on the card (K2b or K4b, and K1b;
    their plain versions on the CPU).  Returns ``(new_states, loss, n_drop,
    grads)``: ``n_drop`` is the step's third output (its truncation
    counters) and ``grads`` a GaussianScene of the loss's gradients to
    every scene field."""
    def fn(leaves):
        new_states, imgs, n_drop = step_batch(prepare(leaves), leaves,
                                              states, actions)
        return torch.mean(imgs ** 2), new_states, n_drop

    loss, (new_states, n_drop), grads = _value_and_grads(scene, fn)
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
