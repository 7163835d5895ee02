"""The tile rasterizer: binning, the per-tile gather and compositing.

Port of ``sim_a_splat_tpu/ops/rasterize_tiles.py``: ``RasterConfig``,
``RasterAux``, ``_emit_tiles``, ``_bin_gaussians`` (footprint buckets, fused
exact key tile·N + depth rank), ``gather_tile_lists``, ``untile_image``,
``composite_tiles`` (the reference's chunked cumulative-product scan, plain
torch), ``composite_dispatch`` with the Pallas backend's semantics
(per-tile counts, chunk-granular early stop), which here is kernel K1
(``ops/composite.py``), ``render_binned`` and the entry points
``rasterize``, ``rasterize_sh``, ``rasterize_raw`` and ``rasterize_raw_sh``.

Binning, the gather, ``render_binned`` and the ``rasterize*`` functions
take an optional leading env axis: (B, N, ...) gaussians under one camera
give (B, ...) images, binned by one sort over (B, E) keys with each env's
list starts offset into its own row, and composited by one K1 launch over
the B·T tiles.  Each env gets the lists and the image of rendering it
alone.  Every sort is ``stable=True``: this scene has whole groups of
gaussians at one depth, so their order comes from the tie-break alone, and
the reference's sorts keep index order on ties.

Where the list capacity K is not a multiple of K1's 128-entry chunk, the
reference composites with ``composite_tiles``, which ignores ``term_eps``;
the port pads the lists with zero-opacity entries to the next multiple of
128 and runs K1 without the early stop, which computes the same.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sim_a_splat_torch.ops import composite
from sim_a_splat_torch.ops import sh as sh_ops
from sim_a_splat_torch.ops.projection import (
    Projected, project, project_raw, view_directions,
)
from sim_a_splat_torch.utils.profiling import span


class RasterConfig(NamedTuple):
    """Static rasterizer configuration: the reference's fields that the
    port reads.  Its backend choice and MXU precision have no counterpart:
    the port always composites with the kernels, whose chunk is fixed at
    128 entries as in the reference's Pallas kernels; ``chunk`` is the step
    of ``composite_tiles`` alone."""

    tile_size: int = 16            # pixels per tile side
    tile_capacity: int = 256       # K: max gaussians composited per tile
    max_tiles_per_gaussian: int = 16  # M: bbox slots per gaussian
    sigma_cutoff: Optional[float] = None  # drop contributions beyond nσ
    term_eps: Optional[float] = None  # early-stop transmittance (gsplat: 1e-4)
    # footprint buckets ((M_b, frac_b), ...): the frac_b·N gaussians with the
    # largest tile footprints get M_b slots (smallest bucket: remainder)
    buckets: Optional[tuple] = None
    # the per-env cached render: the merge-free pair kernel K4 (else merge
    # the lists with ``merge_sorted_lists`` and composite them with K1)
    fused_pair: bool = True
    chunk: int = 64                # composite_tiles' scan step


class RasterAux(NamedTuple):
    """Truncation accounting (see the reference's ``RasterAux``): bounded
    classes ``n_overflowed_tiles`` / ``n_slot_truncated``, severe class
    ``n_sel_dropped_tiles``, the per-tile list lengths ``tile_counts``, and
    the final opacity ``alpha`` and alpha-weighted mean depth ``depth``
    (H, W) where the render has them (the full-grid ``render_binned``)."""

    n_overflowed_tiles: torch.Tensor
    n_slot_truncated: torch.Tensor
    n_sel_dropped_tiles: torch.Tensor
    tile_counts: Optional[torch.Tensor] = None
    alpha: Optional[torch.Tensor] = None
    depth: Optional[torch.Tensor] = None


def _emit_tiles(tx0, ty0, bw, nt, rank, gid, M, tx, T, N):
    """Up to ``M`` fused (tile·N + rank) keys per gaussian, row-major over
    the bbox; slots past the footprint get the sentinel tile T.  Inputs are
    (B, n); returns (B, n·M) keys and gaussian ids."""
    m = torch.arange(M, device=tx0.device)
    dx = m % bw[..., None]
    dy = torch.div(m, bw[..., None], rounding_mode="floor")
    slot_valid = m < nt[..., None]
    tile = (ty0[..., None] + dy) * tx + (tx0[..., None] + dx)
    tile = torch.where(slot_valid, tile, torch.full_like(tile, T))
    key = tile * N + rank[..., None]
    gidx = gid[..., None].expand(key.shape)
    B = key.shape[0]
    return key.reshape(B, -1), gidx.reshape(B, -1)


@span("render.bin")
def _bin_gaussians(proj: Projected, config: RasterConfig, tx: int, ty: int):
    """(tile, depth)-sorted gaussian ids + per-tile segment starts/counts.

    ``proj`` fields are (N, ...) or batched (B, N, ...); outputs follow.
    Returns (sorted_tile, sorted_gidx (·, E), starts, counts (·, T),
    n_slot_truncated (·))."""
    batched = proj.depth.dim() == 2
    if not batched:
        proj = Projected(*(f[None] for f in proj))
    ts = config.tile_size
    M = config.max_tiles_per_gaussian
    T = tx * ty
    B, N = proj.depth.shape
    # keys, bounds and list starts are int64; a tile's count goes to the
    # kernels as int32, and a count is at most N
    if N >= 2**31:
        raise ValueError(f"per-tile count overflow: N = {N} ≥ 2^31, and the "
                         "kernels take each tile's count as int32")
    dev = proj.depth.device

    x, y = proj.xy[..., 0], proj.xy[..., 1]
    r = proj.radius

    def tile_of(v, hi):
        return torch.clamp(torch.floor(v / ts), 0, hi - 1).long()

    tx0, tx1 = tile_of(x - r, tx), tile_of(x + r, tx)
    ty0, ty1 = tile_of(y - r, ty), tile_of(y + r, ty)
    bw = tx1 - tx0 + 1
    bh = ty1 - ty0 + 1
    nt = torch.where(proj.valid, bw * bh, torch.zeros_like(bw))

    iota = torch.arange(N, device=dev).expand(B, N)
    depth_order = torch.sort(proj.depth, dim=-1, stable=True).indices
    rank = torch.empty_like(depth_order).scatter_(1, depth_order, iota)

    if not config.buckets:
        keys, gids = _emit_tiles(tx0, ty0, bw, nt, rank, iota, M, tx, T, N)
        n_slot_truncated = torch.sum(nt > M, dim=-1)
    else:
        buckets = sorted(config.buckets)                    # ascending M_b
        # descending footprint; ties keep index order
        perm = torch.sort(-nt, dim=-1, stable=True).indices
        stx0, sty0, sbw, snt, srank = (a.gather(1, perm)
                                       for a in (tx0, ty0, bw, nt, rank))
        sizes = [max(int(round(f * N)), 0) for _, f in buckets]
        sizes[0] = max(N - sum(sizes[1:]), 0)               # remainder
        keys_l, gids_l = [], []
        n_slot_truncated = torch.zeros(B, dtype=torch.long, device=dev)
        lo = 0                  # the largest-M bucket takes the front
        for (M_b, _), n_b in zip(reversed(buckets), reversed(sizes)):
            if n_b == 0:
                continue
            sl = slice(lo, lo + n_b)
            Mb = min(M_b, M)
            k, g = _emit_tiles(stx0[:, sl], sty0[:, sl], sbw[:, sl],
                               snt[:, sl], srank[:, sl], perm[:, sl], Mb, tx,
                               T, N)
            keys_l.append(k)
            gids_l.append(g)
            n_slot_truncated += torch.sum(snt[:, sl] > Mb, dim=-1)
            lo += n_b
        keys = torch.cat(keys_l, dim=1)
        gids = torch.cat(gids_l, dim=1)

    sorted_key, order = torch.sort(keys, dim=-1, stable=True)
    sorted_gidx = gids.gather(1, order)
    sorted_tile = torch.div(sorted_key, N, rounding_mode="floor")
    bnd = (torch.arange(T + 1, device=dev) * N).expand(B, T + 1).contiguous()
    cnt = torch.searchsorted(sorted_key, bnd, side="left")
    starts = cnt[:, :T]
    counts = cnt[:, 1:] - starts
    out = (sorted_tile, sorted_gidx, starts, counts, n_slot_truncated)
    return out if batched else tuple(a[0] for a in out)


def untile_image(a: torch.Tensor, tx: int, ty: int, ts: int, H: int, W: int):
    """(..., T, P) tile-major pixels → (..., H, W)."""
    lead = tuple(a.shape[:-2])
    a = a.reshape(lead + (ty, tx, ts, ts)).transpose(-3, -2)
    return a.reshape(lead + (ty * ts, tx * ts))[..., :H, :W]


def composite_tiles(gxy: torch.Tensor, gconic: torch.Tensor,
                    gcol: torch.Tensor, gop: torch.Tensor,
                    gdepth: torch.Tensor, tile_ids: torch.Tensor,
                    config: RasterConfig, tx: int):
    """Chunked front-to-back compositing of per-tile gathered gaussians, the
    reference's XLA path: (T', K, ·) depth-sorted lists with inactive
    entries at opacity 0, ``tile_ids`` (T',) their global tile indices (a
    device owning a tile subset composites its rows alone).  Every chunk
    of ``config.chunk`` entries is composited by the closed form
    w = α·cumprod(1−α)·T_carry; counts and ``term_eps`` play no part.

    Returns (rgb (T', P, 3), depth_acc (T', P), trans (T', P))."""
    ts = config.tile_size
    Tloc, K = gop.shape
    chunk = min(config.chunk, K)
    if K % chunk:
        raise ValueError(f"tile capacity {K} must be a multiple of chunk "
                         f"{chunk}")
    px, py = composite.pixel_centers(tile_ids, ts, tx)      # (T', P)
    pmin = composite.power_min_of(config.sigma_cutoff)
    payload = pack_payload(gxy, gconic, gcol, gop, gdepth)  # (T', 10, K)
    P = ts * ts
    rgb = gxy.new_zeros((Tloc, P, 3))
    depth_acc = gxy.new_zeros((Tloc, P))
    trans = gxy.new_ones((Tloc, P))
    for c0 in range(0, K, chunk):
        sl = slice(c0, c0 + chunk)
        alpha = composite.entry_alpha(payload[:, :, sl], px, py, pmin)
        cp = torch.cumprod(1.0 - alpha, dim=-1)
        excl = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)
        w = alpha * excl * trans[..., None]
        rgb = rgb + torch.einsum("tpk,tkc->tpc", w, gcol[:, sl])
        depth_acc = depth_acc + torch.einsum("tpk,tk->tp", w, gdepth[:, sl])
        trans = trans * cp[..., -1]
    return rgb, depth_acc, trans


def gather_tile_lists(proj: Projected, colors: torch.Tensor,
                      opacities: torch.Tensor, config: RasterConfig, tx: int,
                      ty: int):
    """Bin + fixed-capacity per-tile gather.  Returns ((T, K, ·) lists with
    inactive entries zero-opacity, counts (T,), n_slot_truncated); with
    batched ``proj`` (B, N, ...) the lists are (B, T, K, ·), each env's
    gathered from its own row of the sorted keys, and ``colors`` /
    ``opacities`` may be (N, ·) shared by the envs or (B, N, ·)."""
    K = config.tile_capacity
    (_, sorted_gidx, starts, counts,
     n_slot_trunc) = _bin_gaussians(proj, config, tx, ty)
    k = torch.arange(K, device=starts.device)
    sel = torch.clamp(starts[..., None] + k, 0, sorted_gidx.shape[-1] - 1)
    entry_valid = k < torch.clamp(counts, max=K)[..., None]  # (·, T, K)
    lead = tuple(proj.depth.shape[:-1])
    N = proj.depth.shape[-1]
    payload = torch.cat([
        proj.xy,                                           # 0:2
        proj.conic,                                        # 2:5
        colors.expand(lead + (N, 3)),                      # 5:8
        torch.clamp(opacities, 0.0, 1.0).expand(lead + (N,))[..., None],  # 8
        proj.depth[..., None],                             # 9
    ], dim=-1)
    if lead:            # env b's starts index row b of the sorted ids
        B = lead[0]
        g = torch.gather(sorted_gidx, 1, sel.reshape(B, -1)).view(sel.shape)
        lists = payload[torch.arange(B, device=g.device)[:, None, None], g]
    else:
        lists = payload[sorted_gidx[sel]]                  # (T, K, 10)
    gop = torch.where(entry_valid, lists[..., 8],
                      torch.zeros_like(lists[..., 8]))
    return ((lists[..., 0:2], lists[..., 2:5], lists[..., 5:8], gop,
             lists[..., 9]), counts, n_slot_trunc)


def pack_payload(gxy, gconic, gcol, gop, gdepth, pad_rows: int = 0):
    """(…, K, ·) tile-list fields → (…+pad_rows, 10, K) field-major payload
    of the kernels, rows [x, y, conic a b c, r, g, b, depth, opacity];
    ``pad_rows`` zero rows are appended along the leading (tile) axis."""
    fields = torch.cat([gxy, gconic, gcol, gdepth[..., None],
                        gop[..., None]], dim=-1).transpose(-1, -2)
    if not pad_rows:
        return fields.contiguous()
    out = fields.new_zeros((fields.shape[0] + pad_rows, *fields.shape[1:]))
    out[:fields.shape[0]] = fields
    return out


def composite_dispatch(payload: torch.Tensor, counts: torch.Tensor,
                       config: RasterConfig, tx: int,
                       skip: Optional[torch.Tensor] = None):
    """Composite full-grid tile lists, packed (T, 10, K) or per env
    (B, T, 10, K) by :func:`pack_payload`, with kernel K1
    (``composite.composite_static``); ``counts`` (T,) or (B, T) int32 active
    entries per tile, chunks past it are skipped (and so are tiles without
    entries).  Tiles with ``skip`` int32 == 0 emit rgb 0 / trans 1 and do
    no work (default: ``counts``).  A capacity K that is not a multiple of
    128 is padded with zero-opacity entries and composited without the
    early stop (the reference's ``composite_tiles`` fallback).
    Returns (rgb (·, T, P, 3), depth_acc (·, T, P), trans (·, T, P))."""
    term_eps = config.term_eps
    pad = -payload.shape[-1] % composite.CHUNK
    if pad:
        payload = torch.nn.functional.pad(payload, (0, pad))
        term_eps = None
    out, _ = composite.composite_static(
        payload, counts, counts if skip is None else skip, config.tile_size,
        tx, config.sigma_cutoff, term_eps)
    return out[..., 0:3], out[..., 3], out[..., 4]


def render_binned(proj: Projected, colors: torch.Tensor,
                  opacities: torch.Tensor, camera, config: RasterConfig,
                  background: Optional[torch.Tensor] = None):
    """Tile-render already-projected gaussians (one camera) through kernel
    K1 → ((H, W, 3) image, RasterAux with the (H, W) alpha and depth); with
    batched ``proj`` (B, N, ...), B images (B, H, W, 3) in one K1 launch
    and the aux's fields per env."""
    ts = config.tile_size
    H, W = camera.height, camera.width
    tx, ty = -(-W // ts), -(-H // ts)
    lists, counts, n_slot_trunc = gather_tile_lists(proj, colors, opacities,
                                                    config, tx, ty)
    rgb, depth_acc, trans = composite_dispatch(
        pack_payload(*lists), counts.to(torch.int32), config, tx)
    if background is None:
        background = rgb.new_zeros(3)
    rgb = rgb + trans[..., None] * background

    def untile(a):
        return untile_image(a, tx, ty, ts, H, W)

    img = untile(rgb.movedim(-1, -3)).movedim(-3, -1)
    alpha = untile(1.0 - trans)
    aux = RasterAux(
        n_overflowed_tiles=torch.sum(counts > config.tile_capacity, dim=-1),
        n_slot_truncated=n_slot_trunc,
        n_sel_dropped_tiles=torch.zeros_like(n_slot_trunc),
        tile_counts=counts,
        alpha=alpha,
        depth=untile(depth_acc) / torch.clamp(alpha, min=1e-10))
    return img, aux


def rasterize(means: torch.Tensor, covs: torch.Tensor, colors: torch.Tensor,
              opacities: torch.Tensor, camera,
              config: RasterConfig = RasterConfig(),
              background: Optional[torch.Tensor] = None):
    """Project + tile-render world-space gaussians → ((H, W, 3) image,
    RasterAux): the tiled equivalent of ``render_reference``."""
    return render_binned(project(means, covs, camera), colors, opacities,
                         camera, config, background)


def rasterize_sh(means: torch.Tensor, covs: torch.Tensor,
                 sh_coeffs: torch.Tensor, opacities: torch.Tensor, camera,
                 sh_degree: int, config: RasterConfig = RasterConfig(),
                 background: Optional[torch.Tensor] = None):
    """:func:`rasterize` with view-dependent SH colours (degree 0..3)."""
    colors = sh_ops.eval_sh_color(sh_coeffs, view_directions(means, camera),
                                  sh_degree)
    return rasterize(means, covs, colors, opacities, camera, config,
                     background)


def rasterize_raw(means: torch.Tensor, quats: torch.Tensor,
                  log_scales: torch.Tensor, colors: torch.Tensor,
                  opacities: torch.Tensor, camera,
                  config: RasterConfig = RasterConfig(),
                  background: Optional[torch.Tensor] = None):
    """Rasterize straight from raw gaussian parameters through
    ``project_raw`` (no (N, 3, 3) covariances): the same output as
    ``rasterize(means, compute_cov(quats, exp(log_scales)), ...)``.  With
    (B, N, ·) gaussians, B images in one K1 launch."""
    return render_binned(project_raw(means, quats, log_scales, camera),
                         colors, opacities, camera, config, background)


def rasterize_raw_sh(means, quats, log_scales, sh_coeffs, opacities, camera,
                     sh_degree: int, config: RasterConfig = RasterConfig(),
                     background: Optional[torch.Tensor] = None):
    """Raw-parameter rasterization with view-dependent SH colours."""
    colors = sh_ops.eval_sh_color(sh_coeffs, view_directions(means, camera),
                                  sh_degree)
    return rasterize_raw(means, quats, log_scales, colors, opacities, camera,
                         config, background)
