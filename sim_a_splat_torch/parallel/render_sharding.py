"""Primitive/tile-sharded rendering across the ranks of a ``prim`` group.

Port of ``sim_a_splat_tpu/parallel/render_sharding.py``.  For a scene too
large for one device the renderer itself is split: the gaussians are
sharded over the ``prim`` axis, each rank projects and bins its shard
against **all** tiles (at most ``send_capacity`` candidates per tile), and
one ``all_to_all_single`` routes each tile's candidate lists to the tile's
owner rank.  The owner merges the D depth-sorted sublists by depth and
composites its tile rows with kernel K1 (``ops/composite.py``), and an
all-gather gives every rank the whole image.

The collective payload is fixed: T_pad × ``send_capacity`` × 11 float32
per rank whatever the scene holds; overflow truncates the farthest
gaussians per (rank, tile).

Where the port differs from the reference's inner function:

- The owned rows are composited by K1 (K1f, and K1b in the backward), not
  by the reference's XLA scan ``composite_tiles``; like that scan, with no
  early stop (``term_eps`` plays no part), the lists padded to a multiple
  of K1's 128-entry chunk with zero-opacity entries, and the active count
  of a tile the number of finite depth keys it kept.  K1 takes each list's
  pixels from the list's position in its payload, so the owned rows sit in
  a full-grid (T_pad, 10, K) payload whose other rows are skipped (K1 does
  no work on them).
- Ties in depth: the reference's pushT scene has whole groups at one depth.
  A rank's shard is a contiguous block of gaussian indices, ranks in index
  order, and each sublist is ordered by (depth, index); the D sublists are
  concatenated in rank order and sorted by depth with ``stable=True``, so a
  tile's merged list is in (depth, global index) order, the order of the
  single-device render.  (The reference's ``lax.sort`` asks for no
  stability.)
- The gradient: every collective is a ``torch.autograd.Function`` of this
  module.  The exchange's backward is the same ``all_to_all_single`` on
  the cotangent; the all-gather's backward keeps this rank's rows of the
  cotangent and sums nothing, so the replicated loss is counted once; the
  shard-in of the replicated inputs all-reduces the shards' zero-padded
  gradients over ``prim``, so every rank holds the full gradient of
  ``means`` and the other inputs.

:func:`rasterize_prim_shards` computes the same render in one process, with
no collective (the result the ranks are held to).

gloo's collectives take CUDA tensors (two ranks on one card, where NCCL
refuses to run), so no copy to the host is made for them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from sim_a_splat_torch.ops import composite
from sim_a_splat_torch.ops import sh as sh_ops
from sim_a_splat_torch.ops.projection import Camera, project, view_directions
from sim_a_splat_torch.ops.rasterize_tiles import (
    RasterConfig, gather_tile_lists, untile_image,
)
from sim_a_splat_torch.parallel.mesh import PRIM_AXIS, axis_size

N_FIELDS = 11   # x, y, conic a b c, r, g, b, opacity, depth, depth key
# the kernel payload's rows [x, y, conic a b c, r, g, b, depth, opacity]
# taken from the exchanged fields
_PAYLOAD_ROWS = (0, 1, 2, 3, 4, 5, 6, 7, 9, 8)


def pad_gaussians(arrs: dict, n_pad: int) -> dict:
    """Pad gaussian arrays to a shard-divisible count with gaussians that
    project invalid (z far behind the near plane)."""
    out = {}
    for k, a in arrs.items():
        pad = a.new_zeros((n_pad,) + tuple(a.shape[1:]))
        if k == "means":
            pad[:, 2] = -1e6
        out[k] = torch.cat([a, pad])
    return out


class _ShardIn(torch.autograd.Function):
    """Rows [d·n, (d+1)·n) of each replicated input; the backward places
    each shard's gradient in a zero (N, ·) buffer and all-reduces the
    buffers over the group (one collective for all inputs), so every rank
    holds the gradient of the whole input."""

    @staticmethod
    def forward(ctx, group, d, n, *tensors):
        ctx.group, ctx.d, ctx.n = group, d, n
        ctx.shapes = [t.shape for t in tensors]
        return tuple(t[d * n:(d + 1) * n].clone() for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        d, n = ctx.d, ctx.n
        full = [g.new_zeros(shape) for g, shape in zip(grads, ctx.shapes)]
        for f, g in zip(full, grads):
            f[d * n:(d + 1) * n] = g
        flat = torch.cat([f.reshape(-1) for f in full])
        dist.all_reduce(flat, group=ctx.group)
        out = list(torch.split(flat, [f.numel() for f in full]))
        return (None, None, None) + tuple(
            o.view(shape) if need else None
            for o, shape, need in zip(out, ctx.shapes,
                                      ctx.needs_input_grad[3:]))


class _Exchange(torch.autograd.Function):
    """``all_to_all_single`` with equal splits of dim 0: block j goes to
    rank j, block j of the output came from rank j.  It is a permutation
    whose inverse is itself, so the backward is the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllGather(torch.autograd.Function):
    """The group's blocks concatenated along dim 0, in rank order.  The
    loss that reads them is replicated (every rank computes it from the
    same image), so the backward keeps this rank's block of the cotangent
    and sums nothing: the loss is counted once."""

    @staticmethod
    def forward(ctx, x, group, d):
        ctx.d, ctx.n = d, x.shape[0]
        x = x.contiguous()
        out = x.new_empty((dist.get_world_size(group) * x.shape[0],)
                          + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g[ctx.d * ctx.n:(ctx.d + 1) * ctx.n], None, None


def exchange_bytes(camera: Camera, config: RasterConfig, send_capacity: int,
                   D: int) -> int:
    """Bytes one rank sends through the exchange (and receives): T_pad ×
    ``send_capacity`` × 11 float32."""
    return _grid(camera, config, D)[3] * send_capacity * N_FIELDS * 4


def _grid(camera: Camera, config: RasterConfig, D: int):
    ts = config.tile_size
    tx, ty = -(-camera.width // ts), -(-camera.height // ts)
    T = tx * ty
    return tx, ty, T, -(-T // D) * D


def _pad_to_shards(means, covs, colors, opacities, D):
    n_pad = (-means.shape[0]) % D
    if not n_pad:
        return means, covs, colors, opacities
    p = pad_gaussians({"means": means, "covs": covs, "colors": colors,
                       "opacities": opacities}, n_pad)
    return p["means"], p["covs"], p["colors"], p["opacities"]


def _send_lists(means, covs, colors, opacities, camera, config,
                send_capacity, T_pad):
    """A shard's candidate lists for every tile, (T_pad, 11, Ks): fields
    [x, y, conic a b c, r, g, b, opacity, depth, depth key], the key +inf
    where the entry is inactive."""
    tx, ty, T, _ = _grid(camera, config, 1)
    send_cfg = config._replace(tile_capacity=send_capacity)
    (gxy, gconic, gcol, gop, gdepth), _, _ = gather_tile_lists(
        project(means, covs, camera), colors, opacities, send_cfg, tx, ty)
    key = torch.where(gop > 0.0, gdepth, torch.full_like(gdepth, torch.inf))
    send = torch.cat([gxy, gconic, gcol, gop[..., None], gdepth[..., None],
                      key[..., None]], dim=-1).transpose(1, 2)
    return F.pad(send, (0, 0, 0, 0, 0, T_pad - T))


def _merge(lists, K: int):
    """Tiles' D sublists concatenated in rank order, (T', 11, D·Ks) → the
    first K entries by depth (stable: rank order, then each sublist's own
    order on ties) as K1 payload rows (T', 10, Kp), Kp the next multiple
    of 128, and the active counts (T',) int32 (the finite keys kept)."""
    Tn = lists.shape[0]
    key = lists[:, N_FIELDS - 1].detach()
    order = torch.sort(key, dim=-1, stable=True).indices[:, :K]
    rows = torch.gather(lists[:, list(_PAYLOAD_ROWS)], 2,
                        order[:, None, :].expand(Tn, 10, K))
    counts = torch.isfinite(torch.gather(key, 1, order)).sum(-1)
    Kp = -(-K // composite.CHUNK) * composite.CHUNK
    return F.pad(rows, (0, Kp - K)), counts.to(torch.int32)


def _image(packed, camera, config, tx, ty, background):
    """(T, P, 5) [rgb, depth_acc, trans] rows → (H, W, 3) on the
    background."""
    rgb, trans = packed[..., 0:3], packed[..., 4]
    if background is None:
        background = rgb.new_zeros(3)
    rgb = rgb + trans[..., None] * background
    return untile_image(rgb.movedim(-1, -3), tx, ty, config.tile_size,
                        camera.height, camera.width).movedim(-3, -1)


def rasterize_sharded(
    mesh: DeviceMesh,
    means: torch.Tensor,
    covs: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    camera: Camera,
    config: RasterConfig = RasterConfig(),
    send_capacity: int = 64,
    background: Optional[torch.Tensor] = None,
):
    """Render one scene over the ``prim`` group of ``mesh`` → (H, W, 3), the
    same image on every rank, differentiable in every input.

    ``means/covs/colors/opacities`` are the whole scene, the same on every
    rank of the group; each rank takes its own contiguous shard.
    ``send_capacity`` bounds each rank's per-tile candidates before the
    exchange (the merged list is bounded by ``config.tile_capacity``)."""
    group = mesh.get_group(PRIM_AXIS)
    D = axis_size(mesh, PRIM_AXIS)
    d = mesh.get_local_rank(PRIM_AXIS)
    tx, ty, T, T_pad = _grid(camera, config, D)
    Tl = T_pad // D
    means, covs, colors, opacities = _pad_to_shards(means, covs, colors,
                                                    opacities, D)
    shard = _ShardIn.apply(group, d, means.shape[0] // D, means, covs,
                           colors, opacities)

    # 1. project + bin the shard against all tiles
    send = _send_lists(*shard, camera, config, send_capacity, T_pad)

    # 2. route the candidates to the tile owners: row j·Tl + i of the
    # result is rank j's list for owned tile d·Tl + i
    recv = _Exchange.apply(send, group)

    # 3. merge the D sorted sublists of each owned tile by depth
    Ks = send_capacity
    rows, counts = _merge(
        recv.reshape(D, Tl, N_FIELDS, Ks).permute(1, 2, 0, 3).reshape(
            Tl, N_FIELDS, D * Ks), min(config.tile_capacity, D * Ks))

    # 4. composite the owned rows with K1 (placed in a full-grid payload,
    # the other tiles skipped), no early stop
    before, after = d * Tl, T_pad - (d + 1) * Tl
    payload = torch.cat([rows.new_zeros((before,) + rows.shape[1:]), rows,
                         rows.new_zeros((after,) + rows.shape[1:])])
    counts_full = torch.cat([counts.new_zeros(before), counts,
                             counts.new_zeros(after)])
    out, _ = composite.composite_static(payload, counts_full, counts_full,
                                        config.tile_size, tx,
                                        config.sigma_cutoff, None)
    own = out[before:before + Tl, :, 0:5]          # rgb, depth_acc, trans

    # 5. every rank gets every row
    packed = _AllGather.apply(own, group, d)[:T]
    return _image(packed, camera, config, tx, ty, background)


def rasterize_prim_shards(D: int, means, covs, colors, opacities,
                          camera: Camera,
                          config: RasterConfig = RasterConfig(),
                          send_capacity: int = 64, background=None):
    """What :func:`rasterize_sharded` renders over a ``prim`` group of D
    ranks, computed in one process with no collective: the D shards'
    candidate lists, each tile's sublists merged as the owner merges them,
    and every tile composited by K1 in one launch.  Where a shard holds
    more than ``send_capacity`` candidates for a tile, the render differs
    from the single-device ``rasterize``; this function is the one-process
    result to hold the ranks to."""
    tx, ty, T, T_pad = _grid(camera, config, D)
    means, covs, colors, opacities = _pad_to_shards(means, covs, colors,
                                                    opacities, D)
    n = means.shape[0] // D
    sends = torch.stack([
        _send_lists(means[j * n:(j + 1) * n], covs[j * n:(j + 1) * n],
                    colors[j * n:(j + 1) * n], opacities[j * n:(j + 1) * n],
                    camera, config, send_capacity, T_pad)
        for j in range(D)])                          # (D, T_pad, 11, Ks)
    Ks = send_capacity
    rows, counts = _merge(sends.permute(1, 2, 0, 3).reshape(
        T_pad, N_FIELDS, D * Ks), min(config.tile_capacity, D * Ks))
    out, _ = composite.composite_static(rows, counts, counts,
                                        config.tile_size, tx,
                                        config.sigma_cutoff, None)
    return _image(out[:T, :, 0:5], camera, config, tx, ty, background)


def rasterize_sharded_sh(mesh: DeviceMesh, means, covs, sh_coeffs, opacities,
                         camera: Camera, sh_degree: int,
                         config: RasterConfig = RasterConfig(),
                         send_capacity: int = 64, background=None):
    """:func:`rasterize_sharded` with view-dependent SH colours, evaluated
    on the whole (replicated) scene."""
    colors = sh_ops.eval_sh_color(sh_coeffs, view_directions(means, camera),
                                  sh_degree)
    return rasterize_sharded(mesh, means, covs, colors, opacities, camera,
                             config, send_capacity, background)
