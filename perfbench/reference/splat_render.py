"""Plain reference of the gaussian-splat render under one pinhole camera.

The semantics the benchmark holds the program to, written out plainly:

- EWA projection from raw parameters (gsplat's classic mode: OpenCV pose,
  2-D covariance J·M·Mᵀ·Jᵀ + 0.3·I with M = R_cam·R(q)·S, radius
  ceil(3·sqrt(λmax)), culled behind the near plane or off the image);
- spherical-harmonic colours to degree 3, + 0.5 and clamped at 0;
- tile binning with footprint buckets: a gaussian covers the first M_b
  tiles of its bounding box row by row, M_b by its bucket (the share of
  the set with the largest footprints gets the most slots); each tile's
  list is its gaussians in depth order (ties by index), cut at the list
  capacity;
- front-to-back compositing of each pixel over its tile's list:
  α = min(0.99, o·exp(power)), dropped below 1/255 or beyond the σ cutoff,
  colour Σ αᵢ·Tᵢ·cᵢ plus the final transmittance times the background.

No early stop: a list is composited to its end (the program may stop a
tile once every pixel's transmittance is under its ``term_eps``).  Every
function works in the dtype of its inputs.  It imports torch only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
BLUR_2D = 0.3
NEAR = 0.01


class Cam(NamedTuple):
    """Pinhole camera: world→camera rotation ``R`` (3, 3) and translation
    ``t`` (3,), focal lengths and principal point in pixels, image size,
    and the camera's centre in the world (for SH view directions)."""

    R: torch.Tensor
    t: torch.Tensor
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    center: torch.Tensor


def qmul(a, b):
    """Hamilton product of wxyz quaternions (broadcasting)."""
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], dim=-1)


def qrotate(q, v):
    """Rotate vectors ``v`` (..., 3) by quaternions ``q`` (..., 4)."""
    q = q / torch.clamp(q.norm(dim=-1, keepdim=True), min=1e-12)
    w, u = q[..., :1], q[..., 1:]
    t = 2.0 * torch.cross(u.expand_as(v), v, dim=-1)
    return v + w * t + torch.cross(u.expand_as(t), t, dim=-1)


def qmatrix(q):
    """Rotation matrices (..., 3, 3) of quaternions (normalised first)."""
    q = q / torch.clamp(q.norm(dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


class Projected(NamedTuple):
    xy: torch.Tensor       # (N, 2)
    depth: torch.Tensor    # (N,)
    conic: torch.Tensor    # (N, 3)
    radius: torch.Tensor   # (N,)
    valid: torch.Tensor    # (N,)


def project(means, quats, log_scales, cam: Cam) -> Projected:
    """EWA projection of N gaussians (means (N, 3), quats (N, 4) wxyz,
    log-scales (N, 3)) under ``cam``."""
    p = means @ cam.R.T + cam.t
    x, y, z = p.unbind(-1)
    zc = torch.clamp(z, min=NEAR)
    u, v = cam.fx * x / zc + cam.cx, cam.fy * y / zc + cam.cy
    J = torch.zeros(means.shape[:-1] + (2, 3), dtype=means.dtype,
                    device=means.device)
    J[..., 0, 0] = cam.fx / zc
    J[..., 0, 2] = -cam.fx * x / (zc * zc)
    J[..., 1, 1] = cam.fy / zc
    J[..., 1, 2] = -cam.fy * y / (zc * zc)
    M = cam.R @ qmatrix(quats) * torch.exp(log_scales)[..., None, :]
    JM = J @ M
    cov = JM @ JM.transpose(-1, -2)
    a = cov[..., 0, 0] + BLUR_2D
    b = cov[..., 0, 1]
    c = cov[..., 1, 1] + BLUR_2D
    det = a * c - b * b
    det_safe = torch.clamp(det, min=1e-12)
    conic = torch.stack([c, -b, a], dim=-1) / det_safe[..., None]
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det_safe, min=0.01))
    radius = torch.ceil(3.0 * torch.sqrt(lam))
    valid = ((z > NEAR) & (det > 0) & (u + radius > 0) & (u - radius < cam.width)
             & (v + radius > 0) & (v - radius < cam.height))
    return Projected(torch.stack([u, v], -1), z, conic,
                     torch.where(valid, radius, torch.zeros_like(radius)),
                     valid)


def sh_colors(sh_dc, sh_rest, means, cam: Cam, degree: int):
    """RGB (N, 3) of SH coefficients (DC (N, 3), rest (N, K-1, 3)) seen
    from the camera's centre."""
    d = means - cam.center
    d = d / torch.clamp(d.norm(dim=-1, keepdim=True), min=1e-12)
    x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    r = sh_rest
    out = SH_C0 * sh_dc
    if degree >= 1:
        out = out - SH_C1 * y * r[..., 0, :] + SH_C1 * z * r[..., 1, :] \
            - SH_C1 * x * r[..., 2, :]
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out = (out + SH_C2[0] * xy * r[..., 3, :] + SH_C2[1] * yz * r[..., 4, :]
               + SH_C2[2] * (2 * zz - xx - yy) * r[..., 5, :]
               + SH_C2[3] * xz * r[..., 6, :]
               + SH_C2[4] * (xx - yy) * r[..., 7, :])
    if degree >= 3:
        out = (out + SH_C3[0] * y * (3 * xx - yy) * r[..., 8, :]
               + SH_C3[1] * xy * z * r[..., 9, :]
               + SH_C3[2] * y * (4 * zz - xx - yy) * r[..., 10, :]
               + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * r[..., 11, :]
               + SH_C3[4] * x * (4 * zz - xx - yy) * r[..., 12, :]
               + SH_C3[5] * z * (xx - yy) * r[..., 13, :]
               + SH_C3[6] * x * (xx - 3 * yy) * r[..., 14, :])
    return torch.clamp(out + 0.5, min=0.0)


class Lists(NamedTuple):
    """Per-tile lists: gaussian ids (T, K) in depth order, -1 past the
    tile's entries; the untruncated count of each tile (T,); and how many
    gaussians had more bbox tiles than slots."""

    ids: torch.Tensor
    counts: torch.Tensor
    slot_truncated: int


def bin_tiles(proj: Projected, ts: int, tx: int, ty: int, capacity: int,
              max_tiles: int, buckets) -> Lists:
    """Tile lists of one gaussian set (see the module's notes)."""
    N = proj.depth.shape[0]
    dev = proj.depth.device
    T = tx * ty
    x, y, r = proj.xy[:, 0], proj.xy[:, 1], proj.radius

    def tile(v, hi):
        return torch.clamp(torch.floor(v / ts), 0, hi - 1).long()

    tx0, tx1 = tile(x - r, tx), tile(x + r, tx)
    ty0, ty1 = tile(y - r, ty), tile(y + r, ty)
    bw = tx1 - tx0 + 1
    nt = torch.where(proj.valid, bw * (ty1 - ty0 + 1), torch.zeros_like(bw))
    # slots per gaussian: the largest footprints get the largest bucket
    slots = torch.full((N,), max_tiles, dtype=torch.long, device=dev)
    if buckets:
        bks = sorted(buckets)
        sizes = [max(int(round(f * N)), 0) for _, f in bks]
        sizes[0] = max(N - sum(sizes[1:]), 0)
        by_size = torch.sort(-nt, stable=True).indices
        lo = 0
        for (m_b, _), n_b in zip(reversed(bks), reversed(sizes)):
            slots[by_size[lo:lo + n_b]] = min(m_b, max_tiles)
            lo += n_b
    slot_truncated = int((nt > slots).sum())
    # depth rank of every gaussian, ties by index
    rank = torch.empty(N, dtype=torch.long, device=dev)
    rank[torch.sort(proj.depth, stable=True).indices] = torch.arange(
        N, device=dev)
    m = torch.arange(int(slots.max()) if N else 0, device=dev)
    covered = m[None, :] < torch.minimum(nt, slots)[:, None]        # (N, M)
    t_of = ((ty0[:, None] + m // bw[:, None]) * tx
            + tx0[:, None] + m % bw[:, None])
    gid = torch.arange(N, device=dev)[:, None].expand_as(t_of)
    t_of, gid = t_of[covered], gid[covered]
    order = torch.argsort(t_of * N + rank[gid])
    t_sorted, g_sorted = t_of[order], gid[order]
    counts = torch.bincount(t_sorted, minlength=T)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t_sorted.shape[0], device=dev) - starts[t_sorted]
    keep = pos < capacity
    ids = torch.full((T, capacity), -1, dtype=torch.long, device=dev)
    ids[t_sorted[keep], pos[keep]] = g_sorted[keep]
    return Lists(ids, counts, slot_truncated)


def fields(proj: Projected, colors, opac, ids):
    """(T, K, 10) [x, y, conic a b c, r g b, depth, opacity] of ``ids``,
    opacity 0 where an id is -1."""
    table = torch.cat([proj.xy, proj.conic, colors, proj.depth[:, None],
                       torch.clamp(opac, 0.0, 1.0)[:, None]], dim=-1)
    f = table[ids.clamp(min=0)]
    on = (ids >= 0)[..., None]
    return torch.cat([f[..., :9], torch.where(on[..., 0], f[..., 9],
                                              torch.zeros_like(f[..., 9]))
                      [..., None]], dim=-1)


def composite(lists, ts: int, tx: int, ty: int, H: int, W: int,
              sigma_cutoff, background):
    """Front-to-back composite of (T, L, 10) depth-ordered tile lists →
    (3, H, W) image."""
    T = lists.shape[0]
    dev = lists.device
    p = torch.arange(ts * ts, device=dev)
    t = torch.arange(T, device=dev)[:, None]
    px = ((p % ts) + 0.5 + (t % tx) * ts).to(lists.dtype)            # (T, P)
    py = ((p // ts) + 0.5 + (t // tx) * ts).to(lists.dtype)
    g = lists[:, None, :, :]                                         # (T,1,L,10)
    dx = px[..., None] - g[..., 0]
    dy = py[..., None] - g[..., 1]
    power = -0.5 * (g[..., 2] * dx * dx + g[..., 4] * dy * dy) \
        - g[..., 3] * dx * dy                                        # (T,P,L)
    alpha = torch.clamp(g[..., 9] * torch.exp(torch.clamp(power, max=0.0)),
                        max=ALPHA_MAX)
    keep = alpha >= ALPHA_MIN
    if sigma_cutoff is not None:
        keep = keep & (power >= -0.5 * sigma_cutoff ** 2)
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    trans = torch.cumprod(1.0 - alpha, dim=-1)
    before = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    rgb = torch.einsum("tpl,tlc->tpc", alpha * before, lists[..., 5:8])
    rgb = rgb + trans[..., -1:] * background                          # (T,P,3)
    img = rgb.reshape(ty, tx, ts, ts, 3).permute(4, 0, 2, 1, 3)
    return img.reshape(3, ty * ts, tx * ts)[:, :H, :W]
