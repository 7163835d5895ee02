"""Frame-coherent moving-camera rasterization: the candidate tile cache.

Port of ``sim_a_splat_tpu/ops/rasterize_moving.py``.  A camera that moves
with the agent invalidates the fixed camera's static tile cache, and a
full rebin projects, bins and gathers all N gaussians per env per frame.
The candidate cache bins once with a ``margin``-dilated footprint
(``build_moving_cache``), keeps each tile's nearest ``kc`` candidates' raw
parameters, and per frame reprojects only those (``reproject_candidates``),
merges each env's freshly binned dynamics into the lists by one depth sort
and composites every tile with kernel K3 (``render_moving_batch``,
``ops/composite_single.py``).  While ``camera_budget_used`` ≤ 1 and
nothing is truncated, the image equals the full rebin's
(``entry.make_step_moving``) up to float rounding.

Everything is batched over envs: cache leaves carry a leading env axis B,
and the cameras are one ``Camera`` with (B, 4) / (B, 3) pose leaves, where
the reference vmaps over per-env caches and cameras.

Parity with the reference, named where each is handled:
- the reprojection follows the reference's scalar expressions in their
  order (``reproject_candidates``): the ceil'd radius and the tile test
  decide which candidates survive, and their count sets where the 128-entry
  chunks start, so the per-chunk early stop and the image depend on it;
- every sort is stable (``_sort_by_key``, the near-set selection, the
  binning): this scene's depths tie in whole groups, and ties keep index
  order (statics before dynamics, as they are concatenated);
- sort keys are detached (the reference's ``stop_gradient``): depth
  gradients flow through payload row 8 alone;
- the near set keeps 8 pad slots even with ``z_split`` = 0; their geometry
  is real and their opacity 0, and they are culled before binning;
- the reprojection is recomputed in the backward
  (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``.

On the card the reprojection is one launch of kernel R1
(``csrc/reproject.cu``, the operator ``sim_a_splat::reproject_candidates``)
where its inputs need no gradient and the SH degree is at most 3
(``_on_kernel``); it computes the plain version's (``_reproject_plain``)
expressions op for op, so every payload row but the colours, and the key,
are the plain version's bit for bit.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from sim_a_splat_torch.ops import _kernels, composite_single
from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.ops import sh as sh_ops
from sim_a_splat_torch.ops.composite import CHUNK
from sim_a_splat_torch.ops.projection import (
    BLUR_2D, Camera, _apply_rotation, _dot3, _rotation_rows, project_raw,
    view_directions,
)
from sim_a_splat_torch.ops.rasterize_cached import (
    _dyn_config, _gather_tile_lists_sel, _grid,
)
from sim_a_splat_torch.ops.rasterize_tiles import (
    RasterAux, RasterConfig, _bin_gaussians, untile_image,
)
from sim_a_splat_torch.utils.profiling import span


class MovingCache(NamedTuple):
    """Per-env candidate lists of raw gaussian parameters (leading env axis
    B, channel-major: the field axis before the Kc entry axis), the build
    cameras, and the margin-budget statistics (see the reference's
    ``MovingCache`` for their derivation)."""

    mean: torch.Tensor        # (B, T, 3, Kc) world means
    quat: torch.Tensor        # (B, T, 4, Kc) wxyz
    log_scales: torch.Tensor  # (B, T, 3, Kc)
    opacity: torch.Tensor     # (B, T, Kc) in [0, 1], 0 ⇒ inactive
    sh: torch.Tensor          # (B, T, K, 3, Kc) SH coefficients
    counts: torch.Tensor      # (B, T) int32 candidates per tile
    base_q: torch.Tensor      # (B, 4) build camera pose
    base_t: torch.Tensor      # (B, 3)
    s_trans: torch.Tensor     # (B,) max_i P_i / a_i over counted gaussians
    s_rot: torch.Tensor       # (B,) max_i P_i·‖c_i‖ / a_i
    z_min: torch.Tensor       # (B,) min counted depth
    near_gap: torch.Tensor    # (B,) min(near − z) over unhandled-behind
    g_gap: torch.Tensor       # (B,) max ‖c‖ / (near − z) over them
    margin: torch.Tensor      # () px the binning was dilated by
    n_build_truncated: torch.Tensor  # (B,) int32 tiles cut at kc + slot cuts
    near_mean: torch.Tensor   # (B, Nn, 3) near-set raw params (pads: op 0)
    near_quat: torch.Tensor   # (B, Nn, 4)
    near_ls: torch.Tensor     # (B, Nn, 3)
    near_op: torch.Tensor     # (B, Nn)
    near_sh: torch.Tensor     # (B, Nn, K, 3)
    z_split: torch.Tensor     # () split depth (0 ⇒ split disabled)
    t_max: torch.Tensor       # () translation budget guarding the split
    n_near_over: torch.Tensor  # (B,) int32 near-set overflow (severe)


def build_moving_cache(means, quats, log_scales, sh_flat, opacities,
                       camera: Camera, build_config: RasterConfig,
                       kc: int = 1024, margin: float = 16.0,
                       z_split: float = 0.0, t_max: float = 0.05,
                       near_cap: int = 8) -> MovingCache:
    """Dilated-footprint binning and raw-parameter gather of the gaussians
    (N, ·) (``sh_flat`` (N, 3K) k-major) for B build cameras (pose leaves
    (B, 4) / (B, 3)), one batched sort for all envs.

    ``build_config`` sizes the dilated binning (``dilated_build_config``).
    Each tile keeps its nearest ``kc`` candidates by build depth; overflow
    is the bounded class, counted in ``n_build_truncated``.  ``z_split``
    > 0 moves statics with build depth in (−t_max, z_split) into a flat
    ``near_cap``-slot set that the renderer re-bins exactly every frame."""
    if margin <= 1.0:
        raise ValueError(
            f"build_moving_cache: margin {margin} must exceed 1 px — the "
            "binning radius is ceil'd, so 1 px of the budget is consumed "
            "by quantization jitter (see _margin_stats)")
    ts = build_config.tile_size
    tx, ty = _grid(camera, build_config)
    T = tx * ty
    proj = project_raw(means, quats, log_scales, camera, dilate=margin)
    if z_split > 0:
        near_mask = (proj.depth < z_split) & (proj.depth > -t_max)
        # near-set gaussians never enter the candidate lists
        proj = proj._replace(valid=proj.valid & ~near_mask,
                             radius=torch.where(near_mask,
                                                torch.zeros_like(proj.radius),
                                                proj.radius))
    else:
        near_mask = torch.zeros_like(proj.valid)
    _, sorted_gidx, starts, counts, n_slot_trunc = _bin_gaussians(
        proj, build_config, tx, ty)
    B = starts.shape[0]

    n = means.shape[0]
    K = sh_flat.reshape(n, -1).shape[1] // 3
    k = torch.arange(kc, device=means.device)
    sel = torch.clamp(starts[..., None] + k, 0, sorted_gidx.shape[1] - 1)
    g = sorted_gidx.gather(1, sel.reshape(B, -1)).reshape(B, T, kc)
    payload = torch.cat([
        means,                                               # 0:3
        quats,                                               # 3:7
        log_scales,                                          # 7:10
        torch.clamp(opacities, 0.0, 1.0)[:, None],           # 10
        sh_flat.reshape(n, -1),                              # 11:
    ], dim=1)
    raw = payload.t()[:, g].movedim(0, 2)                    # (B, T, R, Kc)
    entry_valid = k < torch.clamp(counts, max=kc)[..., None]

    # near set: the near_cap first near gaussians by index (a stable sort);
    # with the split disabled it still holds 8 pad slots
    if z_split <= 0:
        near_cap = 8
    near_cap = min(near_cap, n)
    near_order = torch.sort((~near_mask).to(torch.int32), dim=-1,
                            stable=True).indices
    n_near = near_mask.sum(dim=-1)
    near_valid = (torch.arange(near_cap, device=means.device)
                  < n_near[:, None])
    near_lists = payload[near_order[:, :near_cap]]           # (B, Nn, R)

    with torch.no_grad():       # compared against 1 only: no gradient
        s_trans, s_rot, z_min, near_gap, g_gap = _margin_stats(
            means, quats, log_scales, camera, margin, ts, tx, ty,
            z_split=z_split, t_max=t_max)
    f32 = dict(dtype=torch.float32, device=means.device)
    return MovingCache(
        mean=raw[:, :, 0:3], quat=raw[:, :, 3:7], log_scales=raw[:, :, 7:10],
        opacity=torch.where(entry_valid, raw[:, :, 10],
                            torch.zeros_like(raw[:, :, 10])),
        sh=raw[:, :, 11:].reshape(B, T, K, 3, kc),
        counts=torch.clamp(counts, max=kc).to(torch.int32),
        base_q=camera.pose.q, base_t=camera.pose.t,
        s_trans=s_trans, s_rot=s_rot, z_min=z_min, near_gap=near_gap,
        g_gap=g_gap, margin=torch.tensor(margin, **f32),
        n_build_truncated=(torch.sum(counts > kc, dim=-1)
                           + n_slot_trunc).to(torch.int32),
        near_mean=near_lists[..., 0:3], near_quat=near_lists[..., 3:7],
        near_ls=near_lists[..., 7:10],
        near_op=torch.where(near_valid, near_lists[..., 10],
                            torch.zeros_like(near_lists[..., 10])),
        near_sh=near_lists[..., 11:].reshape(B, near_cap, K, 3),
        z_split=torch.tensor(z_split, **f32),
        t_max=torch.tensor(t_max, **f32),
        n_near_over=torch.clamp(n_near - near_cap, min=0).to(torch.int32))


def _depth_radius(means, quats, log_scales, camera: Camera, near=0.01,
                  eps2d=BLUR_2D):
    """(z, r, det, u, v, ‖c‖) for all gaussians: ``project_raw``'s depth and
    radius without its culling (out-of-view gaussians can enter the
    view)."""
    w2c = camera.pose.inverse()
    R = w2c.rotation_matrix()
    p_cam = _apply_rotation(R, means) + w2c.t.unsqueeze(-2)
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    zc = torch.clamp(z, min=near)
    r0, r1, r2 = _rotation_rows(quat.multiply(w2c.q.unsqueeze(-2), quats))
    s = torch.exp(log_scales)
    m0, m1, m2 = r0 * s, r1 * s, r2 * s
    inv_z = 1.0 / zc
    inv_z2 = inv_z * inv_z
    j00 = camera.fx * inv_z
    j02 = -camera.fx * x * inv_z2
    j11 = camera.fy * inv_z
    j12 = -camera.fy * y * inv_z2
    a0 = j00[..., None] * m0 + j02[..., None] * m2
    a1 = j11[..., None] * m1 + j12[..., None] * m2
    a = _dot3(a0, a0) + eps2d
    b = _dot3(a0, a1)
    c = _dot3(a1, a1) + eps2d
    det = a * c - b * b
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(
        mid * mid - torch.clamp(det, min=1e-12), min=0.01))
    u = camera.fx * x / zc + camera.cx
    v = camera.fy * y / zc + camera.cy
    c_norm = torch.sqrt(x * x + y * y + z * z)
    return z, torch.ceil(3.0 * torch.sqrt(lam)), det, u, v, c_norm


def _margin_stats(means, quats, log_scales, camera: Camera, margin, ts, tx,
                  ty, near=0.01, z_split=0.0, t_max=0.05):
    """(s_trans, s_rot, z_min, near_gap, g_gap), each (B,), over the counted
    gaussians: a gaussian's footprint edge moves at most
    P_i = (f + g_i + 2 r_i) / z_i px per world unit of camera motion, and
    may move a_i = margin − 1 (+ its entry gap if out of view)."""
    z, r, det, u, v, c_norm = _depth_radius(means, quats, log_scales, camera,
                                            near)
    rd = r + margin
    full_cover = ((u - rd <= ts) & (u + rd >= (tx - 1) * ts)
                  & (v - rd <= ts) & (v + rd >= (ty - 1) * ts))
    counted = (z > max(near, z_split)) & (det > 0.0) & ~full_cover
    f = torch.maximum(camera.fx, camera.fy)
    g = torch.maximum(torch.abs(u - camera.cx), torch.abs(v - camera.cy))
    gap_x = torch.clamp(torch.maximum(-(u + rd), (u - rd) - camera.width),
                        min=0.0)
    gap_y = torch.clamp(torch.maximum(-(v + rd), (v - rd) - camera.height),
                        min=0.0)
    # −1: the binning radius is ceil'd, so footprint edges carry up to 1 px
    # of quantization jitter on top of the smooth bound
    a = (margin - 1.0) + torch.maximum(gap_x, gap_y)
    zc = torch.clamp(z, min=near)
    P = torch.where(counted, (f + g + 2.0 * r) / zc, torch.zeros_like(z))
    inf = torch.full_like(z, math.inf)
    s_trans = (P / a).amax(dim=-1)
    s_rot = (P * c_norm / a).amax(dim=-1)
    z_min = torch.where(counted, z, inf).amin(dim=-1)
    # with the near/far split only z ≤ −t_max can surface unseen
    behind = z <= (near if z_split <= 0 else -t_max)
    gap = near - z
    near_gap = torch.where(behind, gap, inf).amin(dim=-1)
    g_gap = torch.where(behind, c_norm / gap, torch.zeros_like(z)).amax(dim=-1)
    return s_trans, s_rot, z_min, near_gap, g_gap


def dilated_build_config(config: RasterConfig, margin: float) -> RasterConfig:
    """A binning config whose slot budget covers ``margin``-dilated
    footprints: every bucket's M grows by the dilation's worst-case extra
    tile span (2·margin px → ⌈2·margin/ts⌉ + 1 tiles per axis), sized as
    the reference sizes it, (round(√M) + extra)²."""
    ts = config.tile_size
    extra = -(-int(2 * margin) // ts) + 1
    if config.buckets:
        buckets = tuple(((int(round(m ** 0.5)) + extra) ** 2, f)
                        for m, f in config.buckets)
        m_max = max(m for m, _ in buckets)
    else:
        side = int(round(config.max_tiles_per_gaussian ** 0.5))
        m_max = (side + extra) ** 2
        buckets = None
    return config._replace(max_tiles_per_gaussian=m_max, buckets=buckets)


def camera_budget_used(cache: MovingCache, camera: Camera) -> torch.Tensor:
    """(B,) fraction of each env's candidate-cache margin budget that its
    camera consumes; the candidate lists stay supersets while it is ≤ 1.
    Behind-near-plane entry and a translation past the nearest counted
    depth return +inf (the reference's derivation, term by term)."""
    dq = torch.abs(torch.sum(cache.base_q * camera.pose.q, dim=-1))
    theta = 2.0 * torch.arccos(torch.clamp(dq, 0.0, 1.0))
    d = camera.pose.t - cache.base_t
    dt = torch.sqrt(torch.sum(d * d, dim=-1))
    sin_h = torch.sin(torch.clamp(theta / 2.0, max=math.pi / 2.0))
    inf = torch.full_like(dt, math.inf)
    # a cache with no counted gaussians (z_min = inf) has nothing to protect
    corr = torch.where(dt < cache.z_min,
                       cache.z_min / torch.clamp(cache.z_min - dt, min=1e-12),
                       inf)
    used_far = torch.where(
        torch.isfinite(cache.z_min),
        corr * (dt * cache.s_trans
                + 2.0 * sin_h * (cache.s_rot + dt * cache.s_trans)),
        torch.zeros_like(dt))
    used_gap = dt / cache.near_gap + 2.0 * sin_h * cache.g_gap
    return torch.maximum(used_far, used_gap)


def _sh_basis(dx, dy, dz, sh_degree: int) -> torch.Tensor:
    """(…, K, Kc) stacked real-SH basis from (…, Kc) direction components,
    the polynomials of ``ops/sh.py``."""
    C1, C2, C3 = sh_ops.C1, sh_ops.C2, sh_ops.C3
    b = [torch.full_like(dx, sh_ops.C0)]
    if sh_degree >= 1:
        b += [-C1 * dy, C1 * dz, -C1 * dx]
    if sh_degree >= 2:
        xx, yy, zz = dx * dx, dy * dy, dz * dz
        xy, yz, xz = dx * dy, dy * dz, dx * dz
        b += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
              C2[3] * xz, C2[4] * (xx - yy)]
    if sh_degree >= 3:
        b += [C3[0] * dy * (3.0 * xx - yy), C3[1] * xy * dz,
              C3[2] * dy * (4.0 * zz - xx - yy),
              C3[3] * dz * (2.0 * zz - 3.0 * xx - 3.0 * yy),
              C3[4] * dx * (4.0 * zz - xx - yy),
              C3[5] * dz * (xx - yy),
              C3[6] * dx * (xx - 3.0 * yy)]
    return torch.stack(b, dim=-2)


def reproject_candidates(cache: MovingCache, camera: Camera, sh_degree: int,
                         config: RasterConfig, near: float = 0.01,
                         eps2d: float = BLUR_2D, sort: bool = True):
    """Project every env's cached candidates under its current camera.

    The math runs on (B, T, Kc) slices of the cache and follows the
    reference's expressions one by one, in their order (not
    ``project_raw``'s): the ceil'd radius and the tile test below decide
    which candidates survive, and their count sets where the 128-entry
    chunks start, so the early stop, and with it the image, depends on
    them.  Colors are the exact SH for the current view directions.  On
    the card one launch of kernel R1 (``_reproject_kernel``) where
    ``_on_kernel`` says so, else ``_reproject_plain``.

    With ``sort`` returns (spay (B, T, 10, Kc) depth-sorted kernel payload,
    counts (B, T) int32); without, the unsorted payload (B, T, 10, Kc) and
    its sort key (B, T, Kc) for the caller to merge with the dynamics."""
    if _on_kernel(cache, camera, sh_degree):
        payload, key = _reproject_kernel(cache, camera, sh_degree, config,
                                         near, eps2d)
    else:
        payload, key = _reproject_plain(cache, camera, sh_degree, config,
                                        near, eps2d)
    if not sort:
        return payload, key
    counts = torch.sum(payload[:, :, 9] > 0.0, dim=-1).to(torch.int32)
    return _sort_by_key(payload, key), counts


# kernel R1's largest SH degree (16 coefficients a channel)
R1_MAX_DEGREE = 3


def _on_kernel(cache: MovingCache, camera: Camera, sh_degree: int) -> bool:
    """Whether kernel R1 reprojects these inputs: CUDA tensors, none of
    which needs a gradient while grad mode is on, of SH degree at most
    ``R1_MAX_DEGREE``.  Otherwise the plain version runs (the CPU path, and
    the gradient's, recomputed in the backward)."""
    if cache.mean.device.type != "cuda" or sh_degree > R1_MAX_DEGREE:
        return False
    tensors = (*cache, *camera.pose, camera.fx, camera.fy, camera.cx,
               camera.cy)
    return not (torch.is_grad_enabled()
                and any(t.requires_grad for t in tensors))


class ReprojectInputs(ctypes.Structure):
    """The cache's fields as ``csrc/reproject.cu`` takes them (its
    ``ReprojectInputs``, by value): pointers, then each field's strides in
    elements over its leading axes (the Kc axis is contiguous)."""

    _fields_ = [*((f, ctypes.c_void_p) for f in (
                    "mean", "quat", "log_scales", "opacity", "sh")),
                ("mean_s", ctypes.c_longlong * 3),
                ("quat_s", ctypes.c_longlong * 3),
                ("ls_s", ctypes.c_longlong * 3),
                ("op_s", ctypes.c_longlong * 2),
                ("sh_s", ctypes.c_longlong * 4)]


# the launch's arguments after the inputs: the camera constants, payload,
# keys, B, T, Kc, tx, ts, degree, near, eps2d, then the stream
_R1_ARGS = [ReprojectInputs] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
# an env's camera constants: w2c R row-major, w2c t, w2c q, the pose's t,
# fx, fy, cx, cy
R1_CAMERA = 23
# the grid's tile and env axes (CUDA's limit on gridDim.y and .z)
R1_MAX_GRID = 65535


@_kernels.operator("reproject_candidates(Tensor mean, Tensor quat, "
                   "Tensor log_scales, Tensor opacity, Tensor sh, "
                   "Tensor cams, int tx, int ts, int degree, float near, "
                   "float eps2d) -> (Tensor, Tensor)")
def _launch(mean, quat, log_scales, opacity, sh, cams, tx: int, ts: int,
            degree: int, near: float, eps2d: float):
    """One launch of ``csrc/reproject.cu`` over the cache's fields (each
    read through its strides) and the (B, 23) camera constants ``cams``;
    returns the unsorted payload (B, T, 10, Kc) and the key (B, T, Kc)."""
    B, T, _, Kc = mean.shape
    dev = mean.device
    payload = torch.empty((B, T, 10, Kc), dtype=torch.float32, device=dev)
    key = torch.empty((B, T, Kc), dtype=torch.float32, device=dev)
    fields = (mean, quat, log_scales, opacity, sh)
    inputs = ReprojectInputs(*(f.data_ptr() for f in fields),
                             *(f.stride()[:-1] for f in fields))
    _kernels.launch("reproject", "reproject_candidates", _R1_ARGS, dev,
                    inputs, cams.data_ptr(), payload.data_ptr(),
                    key.data_ptr(), B, T, Kc, tx, ts, degree, near, eps2d)
    return payload, key


def _reproject_kernel(cache: MovingCache, camera: Camera, sh_degree: int,
                      config: RasterConfig, near: float = 0.01,
                      eps2d: float = BLUR_2D):
    """:func:`_reproject_plain`'s (payload, key) in one launch of kernel R1
    (``csrc/reproject.cu``) on :func:`r1_arguments`."""
    return torch.ops.sim_a_splat.reproject_candidates(*r1_arguments(
        cache, camera, sh_degree, config, near, eps2d))


def r1_arguments(cache: MovingCache, camera: Camera, sh_degree: int,
                 config: RasterConfig, near: float = 0.01,
                 eps2d: float = BLUR_2D) -> tuple:
    """The arguments of the operator ``sim_a_splat::reproject_candidates``
    for this cache and camera: the cache's five fields (SH cut to the
    degree's coefficients), the (B, 23) camera constants, tx, ts, the
    degree, ``near`` and ``eps2d``.  The camera constants are the plain
    version's own torch calls (``pose.inverse()``, ``rotation_matrix()``),
    stacked per env.  Raises on inputs the kernel does not take: fields not
    float32 on one device, shapes that disagree, a Kc axis that is not
    contiguous, an SH degree past ``R1_MAX_DEGREE`` or a grid past CUDA's
    limits."""
    mean = cache.mean
    if mean.dim() != 4:
        raise ValueError(f"reproject_candidates: the cache's mean is "
                         f"{tuple(mean.shape)}, not (B, T, 3, Kc)")
    B, T, _, Kc = mean.shape
    K = sh_ops.num_coeffs(sh_degree)
    if not 0 <= sh_degree <= R1_MAX_DEGREE or B > R1_MAX_GRID \
            or T > R1_MAX_GRID:
        raise ValueError(
            f"reproject_candidates: kernel R1 takes SH degrees 0 to "
            f"{R1_MAX_DEGREE} and at most {R1_MAX_GRID} envs and tiles; "
            f"got degree {sh_degree}, B {B}, T {T}")
    want = {"mean": (B, T, 3, Kc), "quat": (B, T, 4, Kc),
            "log_scales": (B, T, 3, Kc), "opacity": (B, T, Kc),
            "sh": (B, T, K, 3, Kc)}
    fields = {name: getattr(cache, name) for name in want}
    fields["sh"] = fields["sh"][:, :, :K]
    for name, t in fields.items():
        dense = t.stride(-1) == 1 or t.shape[-1] == 1
        if t.dtype != torch.float32 or tuple(t.shape) != want[name] \
                or t.device != mean.device or not dense:
            raise ValueError(
                f"reproject_candidates takes float32 {want[name]} on "
                f"{mean.device}, the Kc axis contiguous; {name} is "
                f"{'' if dense else 'non-contiguous '}{t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    w2c = camera.pose.inverse()
    parts = [w2c.rotation_matrix().reshape(-1, 9), w2c.t.reshape(-1, 3),
             w2c.q.reshape(-1, 4), camera.pose.t.reshape(-1, 3)]
    intr = torch.stack([camera.fx, camera.fy, camera.cx, camera.cy])
    parts.append(intr.reshape(1, 4).expand(parts[0].shape[0], 4))
    if parts[0].shape[0] not in (1, B) or any(
            p.dtype != torch.float32 or p.device != mean.device
            for p in parts):
        raise ValueError(
            f"reproject_candidates takes float32 cameras on {mean.device}, "
            f"one or {B}; the pose is {camera.pose.q.dtype} "
            f"{tuple(camera.pose.q.shape)} on {camera.pose.q.device}")
    cams = torch.cat(parts, dim=1).expand(B, R1_CAMERA).contiguous()
    tx, _ = _grid(camera, config)
    return (*fields.values(), cams, tx, config.tile_size, sh_degree, near,
            eps2d)


def _reproject_plain(cache: MovingCache, camera: Camera, sh_degree: int,
                     config: RasterConfig, near: float = 0.01,
                     eps2d: float = BLUR_2D):
    """The plain version of the reprojection in eager PyTorch, on any
    device: (payload (B, T, 10, Kc) unsorted, key (B, T, Kc))."""
    T, Kc = cache.mean.shape[1], cache.mean.shape[-1]
    ts = config.tile_size
    tx, _ = _grid(camera, config)

    def env(a):                 # a per-env (or single) scalar → (B, 1, 1)
        return a[..., None, None]

    mx = cache.mean[:, :, 0]
    my = cache.mean[:, :, 1]
    mz = cache.mean[:, :, 2]
    w2c = camera.pose.inverse()
    R = w2c.rotation_matrix()
    x = (env(R[..., 0, 0]) * mx + env(R[..., 0, 1]) * my
         + env(R[..., 0, 2]) * mz + env(w2c.t[..., 0]))
    y = (env(R[..., 1, 0]) * mx + env(R[..., 1, 1]) * my
         + env(R[..., 1, 2]) * mz + env(w2c.t[..., 1]))
    z = (env(R[..., 2, 0]) * mx + env(R[..., 2, 1]) * my
         + env(R[..., 2, 2]) * mz + env(w2c.t[..., 2]))
    zc = torch.clamp(z, min=near)
    u = camera.fx * x / zc + camera.cx
    v = camera.fy * y / zc + camera.cy

    # q_cam = w2c.q ⊗ q (Hamilton), normalized; M = R(q_cam)·S row by row
    pw, px_, py_, pz_ = (env(w2c.q[..., i]) for i in range(4))
    rw = cache.quat[:, :, 0]
    rx = cache.quat[:, :, 1]
    ry = cache.quat[:, :, 2]
    rz = cache.quat[:, :, 3]
    qw = pw * rw - px_ * rx - py_ * ry - pz_ * rz
    qx = pw * rx + px_ * rw + py_ * rz - pz_ * ry
    qy = pw * ry - px_ * rz + py_ * rw + pz_ * rx
    qz = pw * rz + px_ * ry - py_ * rx + pz_ * rw
    qn = torch.clamp(torch.sqrt(qw * qw + qx * qx + qy * qy + qz * qz),
                     min=1e-12)
    qw, qx, qy, qz = qw / qn, qx / qn, qy / qn, qz / qn
    s0 = torch.exp(cache.log_scales[:, :, 0])
    s1 = torch.exp(cache.log_scales[:, :, 1])
    s2 = torch.exp(cache.log_scales[:, :, 2])
    m00 = (1 - 2 * (qy * qy + qz * qz)) * s0
    m01 = (2 * (qx * qy - qw * qz)) * s1
    m02 = (2 * (qx * qz + qw * qy)) * s2
    m10 = (2 * (qx * qy + qw * qz)) * s0
    m11 = (1 - 2 * (qx * qx + qz * qz)) * s1
    m12 = (2 * (qy * qz - qw * qx)) * s2
    m20 = (2 * (qx * qz - qw * qy)) * s0
    m21 = (2 * (qy * qz + qw * qx)) * s1
    m22 = (1 - 2 * (qx * qx + qy * qy)) * s2

    inv_z = 1.0 / zc
    inv_z2 = inv_z * inv_z
    j00 = camera.fx * inv_z
    j02 = -camera.fx * x * inv_z2
    j11 = camera.fy * inv_z
    j12 = -camera.fy * y * inv_z2
    a00 = j00 * m00 + j02 * m20
    a01 = j00 * m01 + j02 * m21
    a02 = j00 * m02 + j02 * m22
    a10 = j11 * m10 + j12 * m20
    a11 = j11 * m11 + j12 * m21
    a12 = j11 * m12 + j12 * m22
    a = a00 * a00 + a01 * a01 + a02 * a02 + eps2d
    b = a00 * a10 + a01 * a11 + a02 * a12
    c = a10 * a10 + a11 * a11 + a12 * a12 + eps2d
    det = a * c - b * b
    det_safe = torch.clamp(det, min=1e-12)
    inv_det = 1.0 / det_safe
    ca, cb, cc = c * inv_det, -b * inv_det, a * inv_det
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det_safe, min=0.01))
    radius = torch.ceil(3.0 * torch.sqrt(lam))

    # exact SH for the current view directions: one stacked basis and one
    # contraction over the coefficient axis, in full float32 (the package
    # turns TF32 off)
    dxw = mx - env(camera.pose.t[..., 0])
    dyw = my - env(camera.pose.t[..., 1])
    dzw = mz - env(camera.pose.t[..., 2])
    dn = torch.clamp(torch.sqrt(dxw * dxw + dyw * dyw + dzw * dzw), min=1e-12)
    K = sh_ops.num_coeffs(sh_degree)
    basis = _sh_basis(dxw / dn, dyw / dn, dzw / dn, sh_degree)
    cols = torch.clamp(torch.einsum("btkx,btkcx->btcx", basis,
                                    cache.sh[:, :, :K]) + 0.5, min=0.0)

    # current-footprint tile test: a candidate whose 3σ box misses its tile
    # adds exactly 0 under sigma_cutoff ≤ 3, so it is compacted away
    tix = torch.arange(T, dtype=torch.float32, device=z.device)
    ox = (tix % tx)[:, None] * ts
    oy = torch.div(tix, tx, rounding_mode="floor")[:, None] * ts
    touches = ((u + radius > ox) & (u - radius < ox + ts)
               & (v + radius > oy) & (v - radius < oy + ts))
    op_eff = torch.where((z > near) & (det > 0.0) & touches, cache.opacity,
                         torch.zeros_like(z))

    # the key only orders entries (the reference's stop_gradient): depth
    # gradients reach z through payload row 8
    key = torch.where(op_eff > 0.0, z, torch.full_like(z, math.inf)).detach()
    payload = torch.stack([u, v, ca, cb, cc, cols[:, :, 0], cols[:, :, 1],
                           cols[:, :, 2], z, op_eff], dim=2)
    return payload, key


def _sort_by_key(payload: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Entries of (…, 10, K) ``payload`` in ascending (…, K) ``key`` order,
    ties in position order (a stable sort and one gather: the reference
    applies the permutation by sorting only because gathers were slow on
    its chip)."""
    order = torch.sort(key, dim=-1, stable=True).indices
    return payload.gather(-1, order.unsqueeze(-2).expand_as(payload))


@span("render.moving")
def render_moving_batch(caches: MovingCache, cameras: Camera, dyn_means,
                        dyn_quats, dyn_log_scales, dyn_colors, dyn_opacities,
                        config: RasterConfig, sh_degree: int,
                        dyn_capacity: int = 128, dyn_max_tiles=None,
                        background=None):
    """One batched moving-camera render against per-env candidate caches.

    Per env: the cached candidates are reprojected under its camera; the
    dynamics (B, Nd, ·) (colors already evaluated) and the near set are
    binned afresh; both are merged into one depth-sorted list per tile and
    every tile is composited by kernel K3 in one launch.  Returns
    ((B, 3, H, W) images, RasterAux of counters summed over the envs, with
    the merged lists' lengths (B, T) as ``tile_counts``)."""
    ts = config.tile_size
    B, T, _, Kc = caches.mean.shape
    H, W = cameras.height, cameras.width
    tx, ty = _grid(cameras, config)
    if Kc % CHUNK or dyn_capacity % CHUNK:
        raise ValueError(
            f"render_moving_batch: kc {Kc} and dyn_capacity {dyn_capacity} "
            f"must be multiples of the kernel chunk {CHUNK}")
    if config.sigma_cutoff is None or config.sigma_cutoff > 3.0:
        raise ValueError(
            "render_moving_batch requires sigma_cutoff ≤ 3: candidate "
            "compaction drops entries whose 3σ box misses the tile, which "
            "is exact only when the kernel cuts at ≤ 3σ")
    def reproject(cache, cams):
        return reproject_candidates(cache, cams, sh_degree, config,
                                    sort=False)

    # recompute the wide elementwise reprojection in the backward instead
    # of keeping its ~20 (B, T, Kc) intermediates for every frame
    if torch.is_grad_enabled() and any(
            f.requires_grad for f in caches if torch.is_tensor(f)):
        pay_s, key_s = checkpoint(reproject, caches, cameras,
                                  use_reentrant=False)
    else:
        pay_s, key_s = reproject(caches, cameras)

    # the near set is re-binned exactly with the dynamics; its pad slots
    # (opacity 0) are culled so they never take a tile's capacity
    ncols = sh_ops.eval_sh_color(
        caches.near_sh, view_directions(caches.near_mean, cameras), sh_degree)
    nd = dyn_means.shape[1]
    dm = torch.cat([dyn_means, caches.near_mean], dim=1)
    dq = torch.cat([dyn_quats, caches.near_quat], dim=1)
    dls = torch.cat([dyn_log_scales, caches.near_ls], dim=1)
    dc = torch.cat([dyn_colors, ncols], dim=1)
    dop = torch.cat([dyn_opacities, caches.near_op], dim=1)
    proj = project_raw(dm, dq, dls, cameras)
    live = torch.cat([torch.ones_like(dyn_opacities, dtype=torch.bool),
                      caches.near_op > 0.0], dim=1)
    proj = proj._replace(valid=proj.valid & live,
                         radius=torch.where(live, proj.radius,
                                            torch.zeros_like(proj.radius)))
    _, sorted_gidx, starts, dcounts, dtrunc = _bin_gaussians(
        proj, _dyn_config(config, dyn_capacity, dyn_max_tiles), tx, ty)
    ids = torch.arange(T, dtype=torch.int32,
                       device=dm.device).expand(B, T).contiguous()
    pay_d, _ = _gather_tile_lists_sel(proj, dc, dop, sorted_gidx, starts,
                                      dcounts, ids, dyn_capacity)
    key_d = torch.where(pay_d[:, :, 9] > 0.0, pay_d[:, :, 8],
                        torch.full_like(pay_d[:, :, 8], math.inf)).detach()

    # one stable depth sort per tile merges dynamics into the candidates
    # (statics first on ties: they are concatenated first)
    key = torch.cat([key_s, key_d], dim=-1)
    spay = _sort_by_key(torch.cat([pay_s, pay_d], dim=-1), key)
    counts = torch.sum(key < math.inf, dim=-1).to(torch.int32)
    spay_pad = torch.cat([spay, spay.new_zeros((B, 1) + spay.shape[2:])],
                         dim=1)
    counts_pad = torch.cat([counts, counts.new_zeros((B, 1))], dim=1)
    out = composite_single.composite_sel_single(
        spay_pad, ids, counts_pad, ts, tx, config.sigma_cutoff,
        config.term_eps)                                     # (B, T+1, 8, P)
    sel8 = out[:, :T]

    if background is None:
        background = sel8.new_zeros(3)
    trans = sel8[:, :, 4]
    imgs = torch.stack([untile_image(sel8[:, :, ch] + trans * background[ch],
                                     tx, ty, ts, H, W)
                        for ch in range(3)], dim=1)          # (B, 3, H, W)
    aux = RasterAux(n_overflowed_tiles=torch.sum(dcounts > dyn_capacity),
                    n_slot_truncated=torch.sum(dtrunc),
                    n_sel_dropped_tiles=torch.zeros_like(torch.sum(dtrunc)),
                    tile_counts=counts)
    return imgs, aux
