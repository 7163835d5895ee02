"""Static-scene tile cache and the two batched cached renders.

Port of the fixed-camera paths of ``sim_a_splat_tpu/ops/rasterize_cached.py``:
the static background is binned once per step (``build_tile_cache_raw``,
``build_tile_cache_raw_sh``) and composited alone (kernel K1,
``build_static_composite``); per env only the dynamic gaussians are
projected and binned.  Then either

- ``rasterize_cache_sel_batch``: the tiles they touch are selected and
  composited against the shared static lists (kernel K2), or
- ``rasterize_with_cache`` (the reference's per-env step, batched): every
  tile of every env is composited against the shared static lists (kernel
  K4, merge-free), or, unfused, the two lists are merged
  (``merge_sorted_lists``) and composited (kernel K1).

Untouched tiles reuse the static composite.  The reference applies
permutations by sorting (``_sort_apply``, ``_permute_rows``) because gathers
were slow on its chip; plain indexing and scatters give the same result
here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from sim_a_splat_torch.ops import composite, composite_pair, composite_sel
from sim_a_splat_torch.ops import sh as sh_ops
from sim_a_splat_torch.ops.projection import (
    Camera, Projected, project_raw, view_directions,
)
from sim_a_splat_torch.ops.rasterize_tiles import (
    RasterAux, RasterConfig, _bin_gaussians, composite_dispatch,
    gather_tile_lists, pack_payload, untile_image,
)
from sim_a_splat_torch.utils.profiling import span


class TileCache(NamedTuple):
    """Depth-sorted per-tile gaussian lists for a fixed (scene, camera),
    packed once for both kernels.  Row T is a zero trash tile: the pad
    slots of the selected-tile render name it."""

    payload: torch.Tensor  # (T+1, 10, K) field-major (``pack_payload``);
                           # opacity 0 for inactive entries
    counts: torch.Tensor   # (T+1,) int32 active entries per tile; 0 at T


def _grid(camera: Camera, config: RasterConfig):
    ts = config.tile_size
    return -(-camera.width // ts), -(-camera.height // ts)


def _dyn_config(config: RasterConfig, dyn_capacity: int,
                dyn_max_tiles: int | None) -> RasterConfig:
    """The binning of the dynamic gaussians: their own list capacity, and
    ``dyn_max_tiles`` bbox slots if given."""
    cfg = config._replace(tile_capacity=dyn_capacity)
    if dyn_max_tiles is not None:
        cfg = cfg._replace(max_tiles_per_gaussian=dyn_max_tiles)
    return cfg


@span("render.tile_cache")
def build_tile_cache_raw(means, quats, log_scales, colors, opacities,
                         camera: Camera, config: RasterConfig) -> TileCache:
    """Bin a static gaussian set against a fixed camera once."""
    tx, ty = _grid(camera, config)
    proj = project_raw(means, quats, log_scales, camera)
    (gxy, gconic, gcol, gop, gdepth), counts, _ = gather_tile_lists(
        proj, colors, opacities, config, tx, ty)
    counts_pad = torch.cat([counts.to(torch.int32),
                            counts.new_zeros(1, dtype=torch.int32)])
    return TileCache(pack_payload(gxy, gconic, gcol, gop, gdepth, pad_rows=1),
                     counts_pad)


def build_tile_cache_raw_sh(means, quats, log_scales, sh_coeffs, opacities,
                            camera: Camera, config: RasterConfig,
                            sh_degree: int) -> TileCache:
    """:func:`build_tile_cache_raw` with SH colours: ``eval_sh_color`` of
    the full (N, K, 3) stack in the camera's view directions, the route of
    the reference's per-env step (the batched step evaluates split
    storage, which rounds differently)."""
    colors = sh_ops.eval_sh_color(sh_coeffs, view_directions(means, camera),
                                  sh_degree)
    return build_tile_cache_raw(means, quats, log_scales, colors, opacities,
                                camera, config)


def build_static_composite(cache: TileCache, camera: Camera,
                           config: RasterConfig):
    """Composite the static cache alone (kernel K1) → (rgb (T, P, 3),
    depth_acc (T, P), trans (T, P))."""
    tx, ty = _grid(camera, config)
    T = tx * ty
    return composite_dispatch(cache.payload[:T], cache.counts[:T], config, tx)


@span("render.tiles")
def select_touched_tiles(dcounts: torch.Tensor, sel_tiles: int, T: int):
    """Per env, the ``sel_tiles`` tiles with the most dynamic entries
    (ties: lower tile id first).  ``dcounts`` (B, T) → (ids (B, TT) int32,
    pad = T after all real slots; counts_sel (B, TT) int32, 0 at pads;
    n_overflow (B,) touched tiles that did not fit)."""
    neg, order = torch.sort(-dcounts.long(), dim=-1, stable=True)
    neg, order = neg[:, :sel_tiles], order[:, :sel_tiles]
    ids = torch.where(neg < 0, order, torch.full_like(order, T))
    counts_sel = torch.clamp(-neg, min=0)
    n_overflow = torch.sum(dcounts > 0, dim=-1) - torch.sum(neg < 0, dim=-1)
    return ids.to(torch.int32), counts_sel.to(torch.int32), n_overflow


@span("render.gather")
def _gather_tile_lists_sel(proj: Projected, colors, opacities, sorted_gidx,
                           starts, counts, ids, Kd: int):
    """Per-env list gather restricted to the selected tiles.

    All inputs batched: proj fields (B, N, ...), colors (B, N, 3),
    opacities (B, N), sorted_gidx (B, E), starts/counts (B, T), ids (B, TT).
    Returns ((B, TT, 10, Kd) payload, rows [x, y, conic a b c, r, g, b,
    depth, opacity], inactive entries at opacity 0; c_sel (B, TT))."""
    B = ids.shape[0]
    dev = ids.device
    k = torch.arange(Kd, device=dev)
    starts_pad = torch.cat([starts, starts[:, -1:]], dim=1)    # id T ⇒ pad
    counts_pad = torch.cat([counts, torch.zeros_like(counts[:, :1])], dim=1)
    idl = ids.long()
    s_sel = starts_pad.gather(1, idl)                          # (B, TT)
    c_sel = torch.clamp(counts_pad.gather(1, idl), max=Kd)
    sel = torch.clamp(s_sel[..., None] + k, 0, sorted_gidx.shape[1] - 1)
    g = sorted_gidx.gather(1, sel.reshape(B, -1)).reshape(sel.shape)
    payload = torch.cat([
        proj.xy,                                               # 0:2
        proj.conic,                                            # 2:5
        colors,                                                # 5:8
        proj.depth[..., None],                                 # 8
        torch.clamp(opacities, 0.0, 1.0)[..., None],           # 9
    ], dim=-1)                                                 # (B, N, 10)
    bidx = torch.arange(B, device=dev)[:, None, None]
    lists = payload[bidx, g]                                   # (B, TT, Kd, 10)
    entry_valid = k < c_sel[..., None]
    lists[..., 9] = torch.where(entry_valid, lists[..., 9],
                                torch.zeros_like(lists[..., 9]))
    return lists.transpose(-1, -2).contiguous(), c_sel.to(torch.int32)


@span("render.select")
def rasterize_cache_sel_batch(cache: TileCache, static_composite,
                              dyn_means, dyn_quats, dyn_log_scales,
                              dyn_colors, dyn_opacities, camera: Camera,
                              config: RasterConfig, dyn_capacity: int = 128,
                              sel_tiles: int = 128,
                              dyn_max_tiles: int | None = None,
                              background: torch.Tensor | None = None):
    """Batched cached render through kernel K2.

    Per env (one batched sort for all envs) it projects and bins the
    dynamic gaussians (B, Nd, ·), selects the ≤ ``sel_tiles`` tiles they
    touch and composites only those against the shared static lists;
    untouched tiles reuse ``static_composite``.  Returns ((B, 3, H, W)
    images and a RasterAux of counters summed over the envs;
    ``n_sel_dropped_tiles`` must be 0 for an exact render)."""
    if static_composite is None:
        raise ValueError("rasterize_cache_sel_batch requires the static "
                         "composite (unselected tiles fall back to it)")
    ts = config.tile_size
    H, W = camera.height, camera.width
    tx, ty = _grid(camera, config)
    T = tx * ty
    P = ts * ts
    Kd = dyn_capacity
    Ks = cache.payload.shape[-1]
    if Ks % composite.CHUNK or Kd % composite.CHUNK:
        raise ValueError(f"static capacity {Ks} and dyn_capacity {Kd} must "
                         f"be multiples of the kernel chunk {composite.CHUNK}")
    proj = project_raw(dyn_means, dyn_quats, dyn_log_scales, camera)
    _, sorted_gidx, starts, dcounts, dtrunc = _bin_gaussians(
        proj, _dyn_config(config, Kd, dyn_max_tiles), tx, ty)
    ids, _, n_over = select_touched_tiles(dcounts, sel_tiles, T)
    dpay, counts_d = _gather_tile_lists_sel(
        proj, dyn_colors, dyn_opacities, sorted_gidx, starts, dcounts, ids, Kd)
    B = ids.shape[0]
    out = composite_sel.composite_pair_sel(
        cache.payload, dpay, ids, cache.counts, counts_d, ts, tx,
        config.sigma_cutoff, config.term_eps)                  # (B, T+1, 8, P)

    # rows of `out` no slot selected are uninitialised: select against the
    # static composite (channel-major, (…, 8, P))
    sel_mask = torch.zeros((B, T + 1), dtype=torch.bool, device=ids.device)
    sel_mask.scatter_(1, ids.long(), True)
    sel_mask = sel_mask[:, :T]
    s_rgb, s_depth, s_trans = static_composite
    s_all = torch.cat([s_rgb.transpose(1, 2), s_depth[:, None, :],
                       s_trans[:, None, :],
                       s_rgb.new_zeros((T, 3, P))], dim=1)     # (T, 8, P)
    sel8 = torch.where(sel_mask[..., None, None], out[:, :T], s_all[None])

    if background is None:
        background = sel8.new_zeros(3)
    trans = sel8[:, :, 4, :]

    def untile(a):
        return untile_image(a, tx, ty, ts, H, W)

    imgs = torch.stack([untile(sel8[:, :, c, :] + trans * background[c])
                        for c in range(3)], dim=1)             # (B, 3, H, W)
    aux = RasterAux(
        n_overflowed_tiles=torch.sum(dcounts > Kd),
        n_slot_truncated=torch.sum(dtrunc),
        n_sel_dropped_tiles=torch.sum(n_over),
    )
    return imgs, aux


def merge_sorted_lists(spay, counts_s, dpay, counts_d):
    """Merge the shared static lists spay (T, 10, Ks) into each env's
    dynamic lists dpay (B, T, 10, Kd) → (merged (B, T, 10, Ks + Kd),
    counts (B, T) = counts_s + counts_d), payloads in the kernels' row
    layout.

    Both obey the gather_tile_lists contract (actives first, depth
    ascending, inactive entries at opacity 0), so with keys = depth (+inf
    for inactive entries) each list is sorted and every entry's merged
    position has the reference's closed merge-path form

        pos_s[i] = i + #{j : dkey[j] <  skey[i]}
        pos_d[j] = j + #{i : skey[i] <= dkey[j]}

    (static first on equal keys), counted here by binary search and applied
    with one scatter."""
    B = dpay.shape[0]
    Ks, Kd = spay.shape[-1], dpay.shape[-1]
    inf = torch.tensor(float("inf"), device=dpay.device)
    skey = torch.where(spay[:, 9] > 0, spay[:, 8], inf)       # (T, Ks)
    skey = skey.expand(B, *skey.shape).contiguous()            # (B, T, Ks)
    dkey = torch.where(dpay[:, :, 9] > 0, dpay[:, :, 8], inf).contiguous()
    pos_s = torch.arange(Ks, device=dpay.device) + torch.searchsorted(
        dkey, skey, side="left")
    pos_d = torch.arange(Kd, device=dpay.device) + torch.searchsorted(
        skey, dkey, side="right")
    src = torch.cat([spay.expand(B, *spay.shape), dpay], dim=-1)
    dest = torch.cat([pos_s, pos_d], dim=-1)[:, :, None, :].expand(src.shape)
    merged = torch.zeros_like(src).scatter(-1, dest, src)
    return merged, counts_s + counts_d


def rasterize_with_cache(cache: TileCache, static_composite, dyn_means,
                         dyn_quats, dyn_log_scales, dyn_colors,
                         dyn_opacities, camera: Camera, config: RasterConfig,
                         dyn_capacity: int = 128,
                         dyn_max_tiles: int | None = None,
                         background: torch.Tensor | None = None):
    """The reference's per-env cached render, batched over envs: static
    cache + each env's dynamic gaussians (B, Nd, ·) → ((B, H, W, 3) images,
    RasterAux of per-env counters (B,)).

    Per env (one batched sort for all envs) the dynamic gaussians are
    projected and binned with their own capacity ``dyn_capacity`` and
    ``dyn_max_tiles`` bbox slots, and gathered into lists for every tile.
    With ``config.fused_pair`` and both capacities multiples of 128, kernel
    K4 composites them against the shared static lists without merging;
    otherwise the lists are merged (:func:`merge_sorted_lists`), padded to a
    whole chunk, and composited with kernel K1, env by env (K1 takes its
    pixel coordinates from the tile index).  With ``static_composite`` (from
    :func:`build_static_composite`), only tiles with dynamic entries are
    composited and the others take the static composite; without it every
    tile is."""
    ts = config.tile_size
    H, W = camera.height, camera.width
    tx, ty = _grid(camera, config)
    T = tx * ty
    Kd = dyn_capacity
    spay, counts_s = cache.payload[:T], cache.counts[:T]
    Ks = spay.shape[-1]

    proj = project_raw(dyn_means, dyn_quats, dyn_log_scales, camera)
    _, sorted_gidx, starts, dcounts, dtrunc = _bin_gaussians(
        proj, _dyn_config(config, Kd, dyn_max_tiles), tx, ty)
    B = dcounts.shape[0]
    every_tile = torch.arange(T, dtype=torch.int32,
                              device=dcounts.device).expand(B, T)
    dpay, counts_d = _gather_tile_lists_sel(
        proj, dyn_colors, dyn_opacities, sorted_gidx, starts, dcounts,
        every_tile, Kd)                                        # (B, T, 10, Kd)
    touched = dcounts > 0
    skip = (touched if static_composite is not None
            else torch.ones_like(touched)).to(torch.int32)

    if config.fused_pair and Ks % composite.CHUNK == 0 \
            and Kd % composite.CHUNK == 0:
        out = composite_pair.composite_pair(
            spay, dpay, counts_s, counts_d, skip, ts, tx,
            config.sigma_cutoff, config.term_eps)              # (B, T, P, 8)
        rgb, trans = out[..., 0:3], out[..., 4]
    else:
        merged, mcounts = merge_sorted_lists(spay, counts_s, dpay, dcounts)
        merged = F.pad(merged, (0, -merged.shape[-1] % composite.CHUNK))
        per_env = [composite_dispatch(merged[b], mcounts[b].to(torch.int32),
                                      config, tx, skip=skip[b])
                   for b in range(B)]
        rgb = torch.stack([r for r, _, _ in per_env])
        trans = torch.stack([t for _, _, t in per_env])
    if static_composite is not None:
        s_rgb, _, s_trans = static_composite
        rgb = torch.where(touched[..., None, None], rgb, s_rgb)
        trans = torch.where(touched[..., None], trans, s_trans)

    if background is None:
        background = rgb.new_zeros(3)
    rgb = rgb + trans[..., None] * background
    imgs = untile_image(rgb.permute(0, 3, 1, 2), tx, ty, ts, H, W)
    aux = RasterAux(
        n_overflowed_tiles=torch.sum((counts_s > Ks) | (dcounts > Kd),
                                     dim=-1),
        n_slot_truncated=dtrunc,
        n_sel_dropped_tiles=torch.zeros_like(dtrunc),
        tile_counts=counts_s + dcounts,
    )
    return imgs.permute(0, 2, 3, 1), aux


def rasterize_with_cache_sh(cache: TileCache, static_composite, dyn_means,
                            dyn_quats, dyn_log_scales, dyn_sh,
                            dyn_opacities, camera: Camera, sh_degree: int,
                            config: RasterConfig, **kw):
    """:func:`rasterize_with_cache` with SH colours: ``eval_sh_color`` of
    ``dyn_sh`` ((Nd, K, 3), shared, or (B, Nd, K, 3)) in each env's view
    directions, the reference's route."""
    colors = sh_ops.eval_sh_color(
        dyn_sh, view_directions(dyn_means, camera), sh_degree)
    return rasterize_with_cache(cache, static_composite, dyn_means,
                                dyn_quats, dyn_log_scales, colors,
                                dyn_opacities, camera, config, **kw)
