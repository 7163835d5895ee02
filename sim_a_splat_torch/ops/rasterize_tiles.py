"""Tile binning and the per-tile compositing dispatch.

Port of ``sim_a_splat_tpu/ops/rasterize_tiles.py``: ``RasterConfig``,
``RasterAux``, ``_emit_tiles``, ``_bin_gaussians`` (footprint buckets, fused
exact key tile·N + depth rank), ``gather_tile_lists``, ``untile_image``,
``composite_dispatch`` with the Pallas backend's semantics (per-tile counts,
chunk-granular early stop), which here is kernel K1 (``ops/composite.py``),
and ``render_binned``.

Binning takes an explicit leading batch axis: the per-env binning of the
batched step is one sort over (B, E) keys instead of a loop over envs, and
gives each env the same lists as binning it alone.  Every sort is
``stable=True``: this scene has whole groups of gaussians at one depth, so
their order comes from the tie-break alone, and the reference's sorts keep
index order on ties.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sim_a_splat_torch.ops import composite
from sim_a_splat_torch.ops.projection import Projected


class RasterConfig(NamedTuple):
    """Static rasterizer configuration: the reference's fields that the
    port's path reads.  Its ``chunk`` (the XLA scan's step), backend choice
    and MXU precision have no counterpart: the kernels' chunk is fixed at
    128 entries, as in the reference's Pallas kernels."""

    tile_size: int = 16            # pixels per tile side
    tile_capacity: int = 256       # K: max gaussians composited per tile
    max_tiles_per_gaussian: int = 16  # M: bbox slots per gaussian
    sigma_cutoff: Optional[float] = None  # drop contributions beyond nσ
    term_eps: Optional[float] = None  # early-stop transmittance (gsplat: 1e-4)
    # footprint buckets ((M_b, frac_b), ...): the frac_b·N gaussians with the
    # largest tile footprints get M_b slots (smallest bucket: remainder)
    buckets: Optional[tuple] = None


class RasterAux(NamedTuple):
    """Truncation accounting (see the reference's ``RasterAux``): bounded
    classes ``n_overflowed_tiles`` / ``n_slot_truncated``, severe class
    ``n_sel_dropped_tiles``, and the per-tile list lengths ``tile_counts``
    where the render has them.  The reference's ``alpha`` and ``depth``
    fields are left out: nothing on the port's path reads them."""

    n_overflowed_tiles: torch.Tensor
    n_slot_truncated: torch.Tensor
    n_sel_dropped_tiles: torch.Tensor
    tile_counts: Optional[torch.Tensor] = None


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
    if (T + 1) * N >= 2**31:
        raise ValueError(
            f"binning key overflow: (T+1)·N = {(T + 1) * N} ≥ 2^31 — "
            "shard the gaussians or reduce N")
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


def gather_tile_lists(proj: Projected, colors: torch.Tensor,
                      opacities: torch.Tensor, config: RasterConfig, tx: int,
                      ty: int):
    """Bin + fixed-capacity per-tile gather.  Returns ((T, K, ·) lists with
    inactive entries zero-opacity, counts, n_slot_truncated)."""
    K = config.tile_capacity
    (_, sorted_gidx, starts, counts,
     n_slot_trunc) = _bin_gaussians(proj, config, tx, ty)
    k = torch.arange(K, device=starts.device)
    sel = torch.clamp(starts[:, None] + k, 0, sorted_gidx.shape[0] - 1)
    entry_valid = k[None, :] < torch.clamp(counts, max=K)[:, None]
    g = sorted_gidx[sel]                                   # (T, K)

    payload = torch.cat([
        proj.xy,                                           # 0:2
        proj.conic,                                        # 2:5
        colors,                                            # 5:8
        torch.clamp(opacities, 0.0, 1.0)[:, None],         # 8
        proj.depth[:, None],                               # 9
    ], dim=1)
    lists = payload[g]
    gop = torch.where(entry_valid, lists[..., 8], torch.zeros_like(lists[..., 8]))
    return ((lists[..., 0:2], lists[..., 2:5], lists[..., 5:8], gop,
             lists[..., 9]), counts, n_slot_trunc)


def pack_payload(gxy, gconic, gcol, gop, gdepth, pad_rows: int = 0):
    """(…, K, ·) tile-list fields → (…+pad_rows, 10, K) field-major payload
    of the kernels, rows [x, y, conic a b c, r, g, b, depth, opacity];
    ``pad_rows`` zero rows are appended along the leading (tile) axis."""
    fields = torch.cat([gxy, gconic, gcol, gdepth[..., None],
                        gop[..., None]], dim=-1).transpose(-1, -2)
    out = fields.new_zeros((fields.shape[0] + pad_rows, *fields.shape[1:]))
    out[:fields.shape[0]] = fields
    return out


def composite_dispatch(payload: torch.Tensor, counts: torch.Tensor,
                       config: RasterConfig, tx: int):
    """Composite full-grid tile lists, packed (T, 10, K) by
    :func:`pack_payload`, with kernel K1 (``composite.composite_static``);
    ``counts`` (T,) int32 active entries per tile, chunks past it are
    skipped (and so are tiles without entries).
    Returns (rgb (T, P, 3), depth_acc (T, P), trans (T, P))."""
    out, _ = composite.composite_static(
        payload, counts, counts, config.tile_size, tx, config.sigma_cutoff,
        config.term_eps)
    return out[..., 0:3], out[..., 3], out[..., 4]


def render_binned(proj: Projected, colors: torch.Tensor,
                  opacities: torch.Tensor, camera, config: RasterConfig,
                  background: Optional[torch.Tensor] = None):
    """Tile-render already-projected gaussians (one camera) through kernel
    K1 → ((H, W, 3) image, RasterAux)."""
    ts = config.tile_size
    H, W = camera.height, camera.width
    tx, ty = -(-W // ts), -(-H // ts)
    lists, counts, n_slot_trunc = gather_tile_lists(proj, colors, opacities,
                                                    config, tx, ty)
    rgb, _, trans = composite_dispatch(pack_payload(*lists),
                                       counts.to(torch.int32), config, tx)
    if background is None:
        background = rgb.new_zeros(3)
    rgb = rgb + trans[..., None] * background
    img = untile_image(rgb.permute(2, 0, 1), tx, ty, ts, H, W)
    aux = RasterAux(n_overflowed_tiles=torch.sum(counts > config.tile_capacity),
                    n_slot_truncated=n_slot_trunc,
                    n_sel_dropped_tiles=torch.zeros_like(n_slot_trunc),
                    tile_counts=counts)
    return img.permute(1, 2, 0), aux
