"""Splat observation wrapper: a manipulator env seen by splat cameras.

Port of ``sim_a_splat_tpu/envs/splat_wrapper.py``.  After every env step
the wrapper poses the scene graph from the env's draw state and renders
``camera_{i}`` CHW images into the observation, for every env of the batch
at once (the reference's ``vmap`` is the leading env axis).  Cameras keep
the reference's dict schema and order: moving (link-attached) cameras
first, then fixed ones (viewport / static).

Three render routes, as in the reference:
- ``render`` / ``render_camera``: all N gaussians posed and rebinned
  (``rasterize_raw_sh``, kernel K1);
- ``render_with_cache``: fixed cameras over a static tile cache built once
  (``build_render_cache``, K1) with each env's dynamics merged in
  (``rasterize_with_cache``), moving cameras by a full rebin;
- ``render_with_cache_batch`` (the product path): fixed cameras through
  the selected-tile kernel K2 when both list capacities are multiples of
  128, else the per-env cached render; moving cameras over per-env
  candidate caches (``build_moving_caches``, kernel K3), or a full rebin
  without them.

``rollout_with_cache_batch`` steps R frames, each frame's render
recomputed in the backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``), over moving caches built once from the first states.
``rebuild_moving_caches`` rebuilds an env's moving caches where its camera
has left their margin budget (the data-collection step
``entry.make_product_collect``, which never returns a frame severe for
the budget).  The counters keep the reference's classes:
``info['render_overflow']`` severe (dynamics dropped from unselected
tiles, a moving camera past its margin budget, near-set overflow),
``info['render_truncated']`` bounded.  As in the reference, a moving
camera's build-time counters (``n_near_over``, ``n_build_truncated``) are
added again in every frame of a rollout.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from sim_a_splat_torch.envs.manipulator_envs import ManipulatorEnvF
from sim_a_splat_torch.messaging.draw import (
    DrawState, ROBOT_NUM_ROBOT, ROBOT_NUM_TASK,
)
from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.ops import rasterize_moving
from sim_a_splat_torch.ops import sh as sh_ops
from sim_a_splat_torch.ops.composite import CHUNK
from sim_a_splat_torch.ops.projection import (
    Camera, Projected, project_raw, view_directions,
)
from sim_a_splat_torch.ops.rasterize_cached import (
    build_static_composite, build_tile_cache_raw, build_tile_cache_raw_sh,
    rasterize_cache_sel_batch, rasterize_with_cache, rasterize_with_cache_sh,
)
from sim_a_splat_torch.ops.rasterize_tiles import (
    RasterConfig, rasterize_raw_sh, render_binned,
)
from sim_a_splat_torch.ops.transforms import SE3, Sim3
from sim_a_splat_torch.scenegraph.graph import SceneGraph
from sim_a_splat_torch.scenegraph.registration import (
    canonicalize, splat_to_world_pose,
)
from sim_a_splat_torch.splat.scene import GaussianScene
from sim_a_splat_torch.utils.profiling import count, span


@dataclasses.dataclass(frozen=True)
class CameraSpec:
    """One camera.  ``local_frame`` (q wxyz, t) is a world pose (viewport /
    static) or a link-local offset (moving, the offset's translation in
    world axes unless ``rotate_offset``); ``fov`` is vertical, radians."""

    type: str                         # "viewport" | "static" | "moving"
    render_size: tuple                # (height, width)
    local_frame: tuple                # (q wxyz, t)
    link_name: Optional[str] = None   # for "moving"
    fov: float = 1.3089
    rotate_offset: bool = False

    def pose(self, device="cuda") -> SE3:
        return _pose_on(self.local_frame, torch.device(device))


@functools.lru_cache(maxsize=64)
def _pose_on(local_frame: tuple, device: torch.device) -> SE3:
    """A (q, t) pair as an SE3 on ``device``, made once: a host→device copy
    in every frame would wait for the stream on a GPU."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return SE3(f32(local_frame[0]), f32(local_frame[1]))


class SplatTransition(NamedTuple):
    state: Any
    obs: dict
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    info: dict


@dataclasses.dataclass(frozen=True, eq=False)
class SplatEnvWrapperF:
    """Functional splat wrapper over a manipulator (or task-space) env; the
    device is the scene's."""

    env: Any                          # top-level env (step / reset)
    graph: SceneGraph
    cameras: tuple                    # ((key, CameraSpec), ...) render order
    schema_to_body: np.ndarray        # (n_schema,) graph body id or 0
    raster: RasterConfig = RasterConfig(tile_capacity=1024, chunk=128)
    background: tuple = (0.0, 0.0, 0.0)

    # --- construction -------------------------------------------------------

    @staticmethod
    def build(env: Any, scene: GaussianScene, link_masks: dict,
              camera_setup_info: dict, icp: Sim3 | None = None,
              rest_poses_world: SE3 | None = None,
              task_mask_key: str | None = None, scene_frame: str = "splat",
              raster: RasterConfig = RasterConfig(tile_capacity=1024,
                                                  chunk=128),
              ) -> "SplatEnvWrapperF":
        """Assemble the wrapper from segmentation artifacts.

        Link masks keyed ``link0..linkN`` (sorted by length, then name) bind
        in order to the schema's robot links other than ``world``, and
        ``task_mask_key`` to the task body.  The pairing is positional, so
        the counts must match, or ``ValueError``.  ``scene_frame="splat"``
        canonicalizes the scene and the fixed cameras through ``icp``."""
        base_env = env.env if hasattr(env, "env") else env
        schema = base_env.schema()
        dev = scene.means.device

        if scene_frame == "splat":
            if icp is None:
                raise ValueError("icp required for scene_frame='splat'")
            scene = canonicalize(scene, icp)

        robot_keys = sorted([k for k in link_masks if k != task_mask_key],
                            key=lambda s: (len(s), s))
        mask_list = [np.asarray(link_masks[k], bool) for k in robot_keys]
        if task_mask_key is not None:
            mask_list.append(np.asarray(link_masks[task_mask_key], bool))

        schema_to_body = np.zeros(len(schema.links), np.int32)
        local_idx = 0
        for i, l in enumerate(schema.links):
            if l.robot_num == ROBOT_NUM_ROBOT and local_idx < len(robot_keys):
                if l.name.removeprefix("plant::") == "world":
                    continue
                schema_to_body[i] = local_idx + 1
                local_idx += 1
            elif l.robot_num == ROBOT_NUM_TASK and task_mask_key is not None:
                schema_to_body[i] = len(robot_keys) + 1
        robot_link_names = [
            l.name.removeprefix("plant::") for l in schema.links
            if l.robot_num == ROBOT_NUM_ROBOT
            and l.name.removeprefix("plant::") != "world"]
        if local_idx != len(robot_keys):
            raise ValueError(
                f"link-mask/schema mismatch: {len(robot_keys)} robot mask "
                f"keys {robot_keys} vs {len(robot_link_names)} robot links "
                f"{robot_link_names}; the pairing is positional, so counts "
                "must match exactly")

        if rest_poses_world is None:
            rest_poses_world = SE3.identity((len(mask_list) + 1,),
                                            device=dev)
        graph = SceneGraph.from_masks(scene, mask_list,
                                      rest_poses=rest_poses_world)

        cams = []
        moving = [(k, v) for k, v in camera_setup_info.items()
                  if v.type == "moving"]
        fixed = [(k, v) for k, v in camera_setup_info.items()
                 if v.type in ("viewport", "static")]
        for k, v in moving + fixed:
            if scene_frame == "splat" and v.type != "moving":
                p = splat_to_world_pose(v.pose(dev), icp)
                v = dataclasses.replace(
                    v, local_frame=(tuple(p.q.cpu().numpy()),
                                    tuple(p.t.cpu().numpy())))
            cams.append((k, v))
        return SplatEnvWrapperF(env=env, graph=graph, cameras=tuple(cams),
                                schema_to_body=schema_to_body, raster=raster)

    # --- host-side indices, made once per wrapper ----------------------------

    @property
    def device(self) -> torch.device:
        return self.graph.scene.means.device

    @functools.cached_property
    def _schema_names(self) -> list:
        return [l.name for l in self._base_env().schema().links]

    @functools.cached_property
    def _body_gather(self):
        """(src (nb,) schema index of each body's pose, has (nb,) bool, the
        identity quaternion): each body slot takes its schema link's pose,
        the others (slot 0 among them) the identity.  A gather, where the
        reference scatters with slot 0 repeated."""
        nb = self.graph.num_bodies
        src = np.zeros(nb, np.int64)
        has = np.zeros(nb, bool)
        for i, b in enumerate(self.schema_to_body):
            if b > 0:
                src[b], has[b] = i, True
        return (torch.as_tensor(src, device=self.device),
                torch.as_tensor(has, device=self.device),
                torch.tensor([1.0, 0.0, 0.0, 0.0], device=self.device))

    @functools.cached_property
    def _split(self):
        """(static_idx, dyn_idx) numpy indices and the dynamic gaussians'
        body ids on the device: the scene graph's static/dynamic split."""
        ids = self.graph.link_ids.cpu().numpy()
        return (np.where(ids == 0)[0], np.where(ids > 0)[0],
                self.graph.link_ids[torch.as_tensor(np.where(ids > 0)[0],
                                                    device=self.device)])

    @functools.cached_property
    def _background(self) -> torch.Tensor:
        return torch.as_tensor(np.asarray(self.background, np.float32),
                               device=self.device)

    # --- core ---------------------------------------------------------------

    def _base_env(self) -> ManipulatorEnvF:
        return self.env.env if hasattr(self.env, "env") else self.env

    def _body_poses(self, draw: DrawState) -> SE3:
        """Schema-ordered draw poses (B, L, ·) → graph body poses
        (B, nb, ·)."""
        src, has, ident = self._body_gather
        q = draw.poses.q[..., src, :]
        t = draw.poses.t[..., src, :]
        return SE3(torch.where(has[:, None], q, ident),
                   torch.where(has[:, None], t, torch.zeros_like(t)))

    def _moving_pose(self, spec: CameraSpec, draw: DrawState) -> SE3:
        """Each env's link-attached camera pose (B, ·)."""
        idx = self._schema_names.index(f"plant::{spec.link_name}")
        lq, lt = draw.poses.q[..., idx, :], draw.poses.t[..., idx, :]
        off = spec.pose(lq.device)
        t = lt + quat.rotate(lq, off.t) if spec.rotate_offset else lt + off.t
        return SE3(quat.multiply(lq, off.q), t)

    def camera_poses(self, env_state, draw: DrawState) -> list:
        """Camera poses in render order: moving ones (B, ·) from their
        links, fixed ones as configured."""
        return [self._moving_pose(spec, draw) if spec.type == "moving"
                else spec.pose(self.device) for _, spec in self.cameras]

    def _camera(self, pose: SE3, spec: CameraSpec) -> Camera:
        h, w = spec.render_size
        return Camera.from_fov(pose, spec.fov, int(w), int(h))

    def render(self, env_state, draw: DrawState | None = None) -> list:
        """One (B, H, W, 3) image batch per camera, in render order: all N
        gaussians posed and rebinned (kernel K1)."""
        if draw is None:
            draw = self._base_env().draw_state(env_state)
        posed = self.graph.posed(self._body_poses(draw))
        sh, opac = posed.sh_coeffs(), posed.opacities()
        bg = self._background
        imgs = []
        for pose, (_, spec) in zip(self.camera_poses(env_state, draw),
                                   self.cameras):
            img, _ = rasterize_raw_sh(posed.means, posed.quats,
                                      posed.log_scales, sh, opac,
                                      self._camera(pose, spec),
                                      posed.sh_degree, self.raster,
                                      background=bg)
            imgs.append(img)
        return imgs

    def render_camera(self, draw: DrawState, camera: Camera) -> torch.Tensor:
        """The posed scene from an arbitrary camera (one pose, or one per
        env) → (B, H, W, 3)."""
        posed = self.graph.posed(self._body_poses(draw))
        img, _ = rasterize_raw_sh(posed.means, posed.quats, posed.log_scales,
                                  posed.sh_coeffs(), posed.opacities(),
                                  camera, posed.sh_degree, self.raster,
                                  background=self._background)
        return img

    # --- cached render path --------------------------------------------------

    def _fixed_camera(self, spec: CameraSpec) -> Camera:
        return self._camera(spec.pose(self.device), spec)

    def _pose_dynamics(self, draw: DrawState, dyn: GaussianScene):
        """World means and quats (B, Nd, ·) of the dynamic gaussians."""
        rel = self._body_poses(draw).compose(self.graph.rest_inv)
        dyn_ids = self._split[2]
        q_g, t_g = rel.q[:, dyn_ids], rel.t[:, dyn_ids]
        return (quat.rotate(q_g, dyn.means) + t_g,
                quat.multiply(q_g, dyn.quats))

    def _rebin(self, st: GaussianScene, dyn: GaussianScene, d_means,
               d_quats, cam: Camera, sh_degree: int) -> torch.Tensor:
        """Statics and each env's posed dynamics projected, binned and
        composited together (kernel K1) → (B, H, W, 3)."""
        B = d_means.shape[0]
        ps = project_raw(st.means, st.quats, st.log_scales, cam)
        if ps.depth.dim() == 1:                      # one camera for all
            ps = Projected(*(f.expand(B, *f.shape) for f in ps))
        pd = project_raw(d_means, d_quats, dyn.log_scales, cam)
        proj = Projected(*(torch.cat([a, b], 1) for a, b in zip(ps, pd)))
        opac = torch.cat([st.opacities(), dyn.opacities()])
        if st.sh_rest is None:
            colors = torch.cat([st.colors_dc(), dyn.colors_dc()])
        else:
            means_all = torch.cat([st.means.expand(B, *st.means.shape),
                                   d_means], 1)
            sh_all = torch.cat([st.sh_coeffs(), dyn.sh_coeffs()])
            colors = sh_ops.eval_sh_color(
                sh_all, view_directions(means_all, cam), sh_degree)
        img, _ = render_binned(proj, colors, opac, cam, self.raster,
                               background=self._background)
        return img

    def build_render_cache(self, scene: GaussianScene | None = None) -> dict:
        """{key: (TileCache, static composite)} for every fixed camera: the
        static gaussians binned once and composited alone (kernel K1).
        Differentiable into ``scene``; rebuild when the scene changes."""
        scene = self.graph.scene if scene is None else scene
        st = scene.select(self._split[0])
        caches = {}
        for key, spec in self.cameras:
            if spec.type == "moving":
                continue
            cam = self._fixed_camera(spec)
            if st.sh_rest is None:
                cache = build_tile_cache_raw(
                    st.means, st.quats, st.log_scales, st.colors_dc(),
                    st.opacities(), cam, self.raster)
            else:
                cache = build_tile_cache_raw_sh(
                    st.means, st.quats, st.log_scales, st.sh_coeffs(),
                    st.opacities(), cam, self.raster, st.sh_degree)
            caches[key] = (cache, build_static_composite(cache, cam,
                                                         self.raster))
        return caches

    def render_with_cache(self, env_state, caches: dict,
                          draw: DrawState | None = None,
                          dyn_capacity: int = 128,
                          dyn_max_tiles: int = 9) -> list:
        """:meth:`render` through the static tile caches: fixed cameras
        merge each env's dynamics against their cache
        (``rasterize_with_cache``), moving cameras rebin statics and
        dynamics.  One (B, H, W, 3) batch per camera."""
        if draw is None:
            draw = self._base_env().draw_state(env_state)
        scene = self.graph.scene
        st, dyn = scene.select(self._split[0]), scene.select(self._split[1])
        d_means, d_quats = self._pose_dynamics(draw, dyn)
        B, Nd = d_means.shape[:2]
        d_ls = dyn.log_scales.expand(B, Nd, 3)
        d_op = dyn.opacities().expand(B, Nd)
        kw = dict(dyn_capacity=dyn_capacity, dyn_max_tiles=dyn_max_tiles,
                  background=self._background)
        imgs = []
        for pose, (key, spec) in zip(self.camera_poses(env_state, draw),
                                     self.cameras):
            cam = self._camera(pose, spec)
            if key in caches:
                cache, scomp = caches[key]
                if scene.sh_rest is None:
                    img, _ = rasterize_with_cache(
                        cache, scomp, d_means, d_quats, d_ls,
                        dyn.colors_dc().expand(B, Nd, 3), d_op, cam,
                        self.raster, **kw)
                else:
                    img, _ = rasterize_with_cache_sh(
                        cache, scomp, d_means, d_quats, d_ls,
                        dyn.sh_coeffs(), d_op, cam, scene.sh_degree,
                        self.raster, **kw)
            else:
                img = self._rebin(st, dyn, d_means, d_quats, cam,
                                  scene.sh_degree)
            imgs.append(img)
        return imgs

    @span("render.moving_build")
    def build_moving_caches(self, draws: DrawState,
                            scene: GaussianScene | None = None,
                            margin: float = 16.0, kc: int = 1024,
                            z_split: float = 0.0, t_max: float = 0.05,
                            near_cap: int = 2048) -> dict:
        """{key: MovingCache} per-env candidate caches of every moving
        camera from the draw states (B, ·): the static gaussians binned
        with a ``margin``-dilated footprint, the nearest ``kc`` per tile
        kept (``ops/rasterize_moving.py``).  Valid while each camera stays
        within its margin budget (checked per frame).  Differentiable into
        ``scene``."""
        scene = self.graph.scene if scene is None else scene
        st = scene.select(self._split[0])
        sh_flat = st.sh_coeffs().reshape(st.means.shape[0], -1)
        bcfg = rasterize_moving.dilated_build_config(self.raster, margin)
        out = {}
        for key, spec in self.cameras:
            if spec.type != "moving":
                continue
            cams = self._camera(self._moving_pose(spec, draws), spec)
            out[key] = rasterize_moving.build_moving_cache(
                st.means, st.quats, st.log_scales, sh_flat, st.opacities(),
                cams, bcfg, kc=kc, margin=margin, z_split=z_split,
                t_max=t_max, near_cap=near_cap)
        return out

    def rebuild_moving_caches(self, moving_caches: dict, draws: DrawState,
                              **build) -> tuple:
        """The moving caches made valid for ``draws`` (B, ·): an env whose
        camera, posed by ``draws``, would use more than its cache's margin
        budget (``rasterize_moving.camera_budget_used`` > 1, past which the
        cache may miss gaussians) has the caches of every moving camera
        rebuilt from its own draw state (:meth:`build_moving_caches` on
        those envs alone, with ``build``'s settings); the other envs keep
        theirs.  Returns ``(caches, rebuilt)``, ``rebuilt`` (B,) bool; the
        number rebuilt goes to the counter ``render.moving_rebuilds``.  The
        decision is read on the host: one synchronisation."""
        over = None
        for key, spec in self.cameras:
            if spec.type != "moving" or key not in moving_caches:
                continue
            cams = self._camera(self._moving_pose(spec, draws), spec)
            o = rasterize_moving.camera_budget_used(moving_caches[key],
                                                    cams) > 1.0
            over = o if over is None else over | o
        if over is None:
            return moving_caches, torch.zeros(
                draws.poses.t.shape[0], dtype=torch.bool, device=self.device)
        idx = torch.nonzero(over)[:, 0]
        count("render.moving_rebuilds", int(idx.numel()))
        if idx.numel() == 0:
            return moving_caches, over
        fresh = self.build_moving_caches(
            DrawState(poses=SE3(draws.poses.q[idx], draws.poses.t[idx])),
            **build)
        out = dict(moving_caches)
        for key, mc in fresh.items():
            # the scalar leaves (margin, z_split, t_max) are the build's
            out[key] = rasterize_moving.MovingCache(*(
                old.index_copy(0, idx, new) if old.dim() else old
                for old, new in zip(moving_caches[key], mc)))
        return out, over

    @span("render.cameras")
    def render_with_cache_batch(self, env_states, caches: dict,
                                draws: DrawState | None = None,
                                dyn_capacity: int = 128,
                                sel_tiles: int = 96,
                                dyn_max_tiles: int = 9,
                                moving_caches: dict | None = None,
                                within_budget: bool = False):
        """One batched render of every camera for all envs (the product
        path).

        Fixed cameras with a cache: kernel K2 over each env's ≤
        ``sel_tiles`` touched tiles against the shared static lists when
        the static capacity and ``dyn_capacity`` are multiples of 128
        (the reference's route choice, here on the alignment alone), else
        the per-env cached render (``rasterize_with_cache``).  Moving
        cameras with ``moving_caches``: each env's candidate cache
        reprojected, merged with its dynamics and the near set, kernel K3;
        ``within_budget`` says the caller has made every env's moving caches
        valid for ``draws`` (``rebuild_moving_caches``), so the margin
        budget is not computed again.  Any other camera: a full rebin per
        env.

        Returns ``(imgs, aux)``: one (B, 3, H, W) batch per camera in
        render order, and totals ``dropped_tiles`` (severe: dynamics
        dropped from unselected tiles, cameras past their margin budget,
        near-set overflow; keep 0) and ``truncated`` (bounded: capacity
        cuts, bbox slot clipping)."""
        if draws is None:
            draws = self._base_env().draw_state(env_states)
        scene = self.graph.scene
        st, dyn = scene.select(self._split[0]), scene.select(self._split[1])
        d_means, d_quats = self._pose_dynamics(draws, dyn)
        B, Nd = d_means.shape[:2]
        d_ls = dyn.log_scales.expand(B, Nd, 3)
        d_op = dyn.opacities().expand(B, Nd)
        bg = self._background

        def colors(cam):
            if scene.sh_rest is None:
                return dyn.colors_dc().expand(B, Nd, 3)
            return sh_ops.eval_sh_color_split(
                dyn.sh_dc, dyn.sh_rest, view_directions(d_means, cam),
                scene.sh_degree)

        imgs = []
        overflow = torch.zeros((), dtype=torch.long, device=self.device)
        truncated = torch.zeros((), dtype=torch.long, device=self.device)
        for key, spec in self.cameras:
            if spec.type != "moving" and key in caches:
                cache, scomp = caches[key]
                cam = self._fixed_camera(spec)
                d_cols = colors(cam)
                if (cache.payload.shape[-1] % CHUNK == 0
                        and dyn_capacity % CHUNK == 0):
                    img_b, aux = rasterize_cache_sel_batch(
                        cache, scomp, d_means, d_quats, d_ls, d_cols, d_op,
                        cam, self.raster, dyn_capacity=dyn_capacity,
                        sel_tiles=sel_tiles, dyn_max_tiles=dyn_max_tiles,
                        background=bg)
                    overflow = overflow + aux.n_sel_dropped_tiles
                    truncated = (truncated + aux.n_overflowed_tiles
                                 + aux.n_slot_truncated)
                else:
                    img, aux = rasterize_with_cache(
                        cache, scomp, d_means, d_quats, d_ls, d_cols, d_op,
                        cam, self.raster, dyn_capacity=dyn_capacity,
                        dyn_max_tiles=dyn_max_tiles, background=bg)
                    img_b = img.permute(0, 3, 1, 2)
                    # nothing is dropped outright: both counts are bounded
                    truncated = (truncated + torch.sum(aux.n_overflowed_tiles)
                                 + torch.sum(aux.n_slot_truncated))
            elif (spec.type == "moving" and moving_caches is not None
                  and key in moving_caches):
                mc = moving_caches[key]
                cams = self._camera(self._moving_pose(spec, draws), spec)
                img_b, aux = rasterize_moving.render_moving_batch(
                    mc, cams, d_means, d_quats, d_ls, colors(cams), d_op,
                    self.raster, scene.sh_degree, dyn_capacity=dyn_capacity,
                    dyn_max_tiles=dyn_max_tiles, background=bg)
                # severe: a camera past its margin budget; the build-time
                # counters are added in every frame, as the reference does
                if not within_budget:
                    overflow = overflow + torch.sum(
                        rasterize_moving.camera_budget_used(mc, cams) > 1.0)
                overflow = overflow + torch.sum(mc.n_near_over)
                truncated = (truncated + aux.n_overflowed_tiles
                             + aux.n_slot_truncated
                             + torch.sum(mc.n_build_truncated))
            else:
                pose = (self._moving_pose(spec, draws)
                        if spec.type == "moving" else spec.pose(self.device))
                img_b = self._rebin(st, dyn, d_means, d_quats,
                                    self._camera(pose, spec),
                                    scene.sh_degree).permute(0, 3, 1, 2)
            imgs.append(img_b)
        return imgs, {"dropped_tiles": overflow, "truncated": truncated}

    def _with_images(self, tr, imgs, aux) -> SplatTransition:
        obs = dict(tr.obs)
        for i, img in enumerate(imgs):
            obs[f"camera_{i}"] = img
        B = tr.reward.shape[0]
        info = dict(tr.info)
        info["render_overflow"] = aux["dropped_tiles"].to(
            torch.int32).expand(B)
        info["render_truncated"] = aux["truncated"].to(torch.int32).expand(B)
        return SplatTransition(state=tr.state, obs=obs, reward=tr.reward,
                               terminated=tr.terminated,
                               truncated=tr.truncated, info=info)

    def step_with_cache_batch(self, states, actions, caches: dict,
                              noobs: bool = False, dyn_capacity: int = 128,
                              sel_tiles: int = 96, dyn_max_tiles: int = 9,
                              moving_caches: dict | None = None
                              ) -> SplatTransition:
        """The env step for all envs, then :meth:`render_with_cache_batch`:
        ``camera_{i}`` (B, 3, H, W) in the observation,
        ``info['render_overflow']`` (severe, must stay 0) and
        ``info['render_truncated']`` (bounded), each (B,) int32."""
        tr = self.env.step(states, actions)
        if noobs:
            return SplatTransition(state=tr.state, obs=tr.obs,
                                   reward=tr.reward, terminated=tr.terminated,
                                   truncated=tr.truncated, info=tr.info)
        imgs, aux = self.render_with_cache_batch(
            tr.state, caches, dyn_capacity=dyn_capacity,
            sel_tiles=sel_tiles, dyn_max_tiles=dyn_max_tiles,
            moving_caches=moving_caches)
        return self._with_images(tr, imgs, aux)

    def rollout_with_cache_batch(self, states, actions_seq, caches: dict,
                                 dyn_capacity: int = 128, sel_tiles: int = 96,
                                 dyn_max_tiles: int = 9,
                                 moving_margin: float = 16.0,
                                 moving_kc: int = 1024,
                                 moving_z_split: float = 0.0,
                                 moving_t_max: float = 0.05,
                                 moving_near_cap: int = 2048
                                 ) -> SplatTransition:
        """R batched steps (``actions_seq`` (R, B, act_dim)) with the moving
        cameras over candidate caches built once from the initial states.

        Returns a SplatTransition whose obs, reward, flags and info carry a
        leading (R, B) axis and whose ``state`` is the final one.  In
        training each frame's render is recomputed in the backward, and
        the scene's gradient reaches it through every frame and the cache
        builds."""
        draws0 = self._base_env().draw_state(states)
        mcaches = self.build_moving_caches(
            draws0, margin=moving_margin, kc=moving_kc,
            z_split=moving_z_split, t_max=moving_t_max,
            near_cap=moving_near_cap) or None
        n_cam = len(self.cameras)
        kw = dict(dyn_capacity=dyn_capacity, sel_tiles=sel_tiles,
                  dyn_max_tiles=dyn_max_tiles, moving_caches=mcaches)

        def render(env_state):
            imgs, aux = self.render_with_cache_batch(env_state, caches, **kw)
            return (*imgs, aux["dropped_tiles"], aux["truncated"])

        frames = []
        for actions in actions_seq:
            tr = self.env.step(states, actions)
            states = tr.state
            if torch.is_grad_enabled():
                out = checkpoint(render, states, use_reentrant=False)
            else:
                out = render(states)
            frames.append(self._with_images(
                tr, out[:n_cam], dict(dropped_tiles=out[n_cam],
                                      truncated=out[n_cam + 1])))

        def stack(xs):
            if isinstance(xs[0], dict):
                return {k: stack([x[k] for x in xs]) for k in xs[0]}
            return torch.stack(xs)

        return SplatTransition(
            state=states, obs=stack([f.obs for f in frames]),
            reward=stack([f.reward for f in frames]),
            terminated=stack([f.terminated for f in frames]),
            truncated=stack([f.truncated for f in frames]),
            info=stack([f.info for f in frames]))

    def observe_with_cache(self, env_state, inner_obs: dict,
                           caches: dict) -> dict:
        imgs = self.render_with_cache(env_state, caches)
        obs = dict(inner_obs)
        for i, img in enumerate(imgs):
            obs[f"camera_{i}"] = img.permute(0, 3, 1, 2)
        return obs

    def step_with_cache(self, state, action, caches: dict,
                        noobs: bool = False) -> SplatTransition:
        """The env step, observed through the static-cache render path."""
        tr = self.env.step(state, action)
        obs = (tr.obs if noobs
               else self.observe_with_cache(tr.state, tr.obs, caches))
        return SplatTransition(state=tr.state, obs=obs, reward=tr.reward,
                               terminated=tr.terminated,
                               truncated=tr.truncated, info=tr.info)

    def observe(self, env_state, inner_obs: dict) -> dict:
        """Inner obs + ``camera_{i}`` (B, 3, H, W) images."""
        imgs = self.render(env_state)
        obs = dict(inner_obs)
        for i, img in enumerate(imgs):
            obs[f"camera_{i}"] = img.permute(0, 3, 1, 2)
        return obs

    # --- env API ------------------------------------------------------------

    def reset(self, generator: Optional[torch.Generator] = None,
              reset_to_state=None, batch: int = 1):
        state, obs = self.env.reset(generator, reset_to_state, batch)
        return state, self.observe(state, obs)

    def step(self, state, action, noobs: bool = False) -> SplatTransition:
        tr = self.env.step(state, action)
        obs = tr.obs if noobs else self.observe(tr.state, tr.obs)
        return SplatTransition(state=tr.state, obs=obs, reward=tr.reward,
                               terminated=tr.terminated,
                               truncated=tr.truncated, info=tr.info)
