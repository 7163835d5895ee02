"""Entry points of the port: the pushT splat scene, the batched env step
and its train step.

Port of ``_build_scene`` and ``_make_step_cached_batch`` of the reference's
entry module (``__graft_entry__.py``): a batch of pushT envs under one fixed
camera, the static background binned and composited once per step (kernel
K1) and each env's touched tiles composited against it (kernel K2).
``loss_and_grads`` is the train step of the reference's bench
(``bench.py``): the mean-square image loss and its gradient to every
gaussian parameter, through the backward kernels K1b and K2b.

Everything runs on ``device`` ("cuda" by default); ``device="cpu"`` runs
the plain PyTorch path (what the tests compare against the reference).
"""

from __future__ import annotations

import numpy as np
import torch

from sim_a_splat_torch import resolve_device
from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.ops import sh as sh_ops
from sim_a_splat_torch.ops.projection import Camera, view_directions
from sim_a_splat_torch.ops.rasterize_cached import (
    build_static_composite, build_tile_cache_raw, rasterize_cache_sel_batch,
)
from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
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
    graph = SceneGraph(graph.scene.to(dev), graph.link_ids.to(dev),
                       graph.rest_inv.to(dev))
    params = PushTParams()
    cam = Camera.from_fov(SE3(torch.tensor([1.0, 0, 0, 0], device=dev),
                              torch.tensor([149.0, 256.0, -450.0], device=dev)),
                          1.05, width, height)           # fixed, top-down

    ids = graph.link_ids.cpu().numpy()
    stat_idx = np.where(ids == 0)[0]
    dyn_idx = np.where(ids > 0)[0]
    dyn_ids = torch.as_tensor(ids[ids > 0], dtype=torch.long, device=dev)
    z_axis = torch.tensor([0.0, 0.0, 1.0], device=dev)
    q_identity = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    white = torch.ones(3, device=dev)

    def colors_of(s, means):
        if s.sh_rest is None:
            return s.colors_dc()
        return sh_ops.eval_sh_color_split(s.sh_dc, s.sh_rest,
                                          view_directions(means, cam),
                                          s.sh_degree)

    def prepare(scene):
        st = scene.select(stat_idx)
        cache = build_tile_cache_raw(st.means, st.quats, st.log_scales,
                                     colors_of(st, st.means), st.opacities(),
                                     cam, raster)
        return cache, build_static_composite(cache, cam, raster)

    def step_batch(cache, scene, states, actions):
        cache, scomp = cache
        new_states = pusht.control_step(params, states, actions)
        dyn = scene.select(dyn_idx)
        B = actions.shape[0]
        zeros1 = new_states.block_angle.new_zeros((B, 1))
        qb = quat.from_axis_angle(z_axis, new_states.block_angle)
        qa = quat.from_axis_angle(z_axis, torch.zeros_like(
            new_states.block_angle))
        body_poses = SE3(
            torch.stack([q_identity.expand(B, 4), qb, qa], dim=1),
            torch.stack([zeros1.new_zeros((B, 3)),
                         torch.cat([new_states.block_pos, zeros1], -1),
                         torch.cat([new_states.agent_pos, zeros1], -1)],
                        dim=1))                              # (B, 3)
        rel = body_poses.compose(graph.rest_inv)
        q_g = rel.q[:, dyn_ids]                              # (B, Nd, 4)
        t_g = rel.t[:, dyn_ids]
        means = quat.rotate(q_g, dyn.means) + t_g
        quats = quat.multiply(q_g, dyn.quats)
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


def loss_and_grads(prepare, step_batch, scene: GaussianScene, states,
                   actions):
    """One train step of the batched env, as the reference's bench takes it
    (``jax.value_and_grad`` of ``mean(imgs ** 2)`` over the scene):
    ``prepare`` and ``step_batch`` from :func:`make_step_cached_batch`.

    The scene's tensors become leaves that require grad; the forward is
    ``prepare`` + ``step_batch``, and the backward runs through K2b and K1b
    on the card (their plain versions on the CPU).  Returns
    ``(new_states, loss, n_drop, grads)``, with ``grads`` a GaussianScene
    of the loss's gradients (None where the scene has no ``sh_rest``)."""
    leaves = GaussianScene(*(None if f is None else
                             f.detach().requires_grad_() for f in scene))
    new_states, imgs, n_drop = step_batch(prepare(leaves), leaves, states,
                                          actions)
    loss = torch.mean(imgs ** 2)
    fields = [f for f in leaves if f is not None]
    got = iter(torch.autograd.grad(loss, fields))
    grads = GaussianScene(*(None if f is None else next(got) for f in leaves))
    return new_states, loss.detach(), n_drop, grads
