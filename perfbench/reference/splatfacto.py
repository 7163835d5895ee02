"""Plain reference of one splatfacto training iteration: the render, the
loss, the gradient to every field, Adam's update and the cull round; and
the render alone, of the views the program trains against.

nerfstudio's ``splatfacto`` (``models/splatfacto.py``), written out
plainly on the benchmark's renderer (``splat_render.py``):

- projection, SH colours and tile binning are ``splat_render``'s
  (``project``, ``sh_colors``, ``bin_tiles``), with no guard on the size
  of the binning keys;
- each pixel composites its tile's whole list, with no early stop
  (``splat_render.composite``), over the background;
- the loss is (1 − λ)·mean|img − target| + λ·(1 − SSIM), SSIM with an
  11 × 11 Gaussian window, σ 1.5, K = (0.01, 0.03) over [0, 1], averaged
  over the valid region and the channels (its own 2-D convolution here);
- the gradient is taken in blocks of tile rows, so that a full image at
  1600 × 900 fits: first ∂loss/∂image, then each block's composite's
  vector-Jacobian product summed into the per-gaussian table of screen
  quantities, then through the projection and the SH colours to the
  scene's fields (the sum of the blocks is the whole image's gradient:
  each pixel reads its own tile's list alone);
- Adam per field, β (0.9, 0.999), with splatfacto's learning rates and the
  means' exponential decay;
- the cull round past ``stop_split_at``: a gaussian stays where its
  opacity is at least ``cull_alpha_thresh`` and its largest scale at most
  ``cull_scale_thresh``.

Departures from splatfacto, each the program's (``splat/train.py``):

- the optimizer is built anew after every round, so its moments start
  from zero and the means' schedule from its first rate (the schedule's
  position is an input here: ``t``);
- Adam's ε is 1e-8, not 1e-15;
- the background is fixed, not random;
- the densify statistic (world-space ‖∇means‖) plays no part: past
  ``stop_split_at`` no round densifies.

Every function works in the dtype of its inputs (float32, or bfloat16 for
the control), with TF32 off.  It imports torch and the benchmark's
renderer only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from perfbench.reference import splat_render as sr

FIELDS = ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
          "sh_rest")
BETAS = (0.9, 0.999)
EPS = 1e-8


def camera(q, center, fx, fy, cx, cy, width, height, dtype=torch.float32):
    """``splat_render.Cam`` of a camera-to-world quaternion ``q`` (4,) wxyz
    and centre ``center`` (3,)."""
    q, c = q.to(dtype), center.to(dtype)
    R = sr.qmatrix(q).T
    return sr.Cam(R, -(R @ c), fx, fy, cx, cy, width, height, c)


def ssim(img, ref, size: int = 11, sigma: float = 1.5):
    """Mean SSIM of two (H, W, 3) images in [0, 1] over the valid
    region."""
    x = torch.arange(size, dtype=torch.float64) - (size - 1) / 2
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = g / g.sum()
    w = (g[:, None] * g[None, :]).to(img.dtype).to(img.device)
    w = w.expand(3, 1, size, size)

    def blur(a):
        return F.conv2d(a.permute(2, 0, 1)[None], w, groups=3)[0]

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mx, my = blur(img), blur(ref)
    sxx = blur(img * img) - mx * mx
    syy = blur(ref * ref) - my * my
    sxy = blur(img * ref) - mx * my
    m = ((2 * mx * my + c1) * (2 * sxy + c2)
         / ((mx * mx + my * my + c1) * (sxx + syy + c2)))
    return m.mean()


def loss_of(img, target, ssim_lambda: float):
    """(1 − λ)·L1 + λ·(1 − SSIM)."""
    l1 = torch.mean(torch.abs(img - target))
    return (1.0 - ssim_lambda) * l1 + ssim_lambda * (1.0 - ssim(img, target))


class Raster(NamedTuple):
    """The configuration's tile settings."""
    ts: int
    capacity: int
    max_tiles: int
    buckets: tuple
    sigma_cutoff: float


def raster_of(cfg: dict) -> Raster:
    return Raster(int(cfg["tile_size"]), int(cfg["tile_capacity"]),
                  int(cfg["max_tiles_per_gaussian"]),
                  tuple(tuple(b) for b in cfg["buckets"] or ()),
                  cfg["sigma_cutoff"])


class Step(NamedTuple):
    """One iteration's forward and gradient: the render (H, W, 3), the
    loss, each field's gradient, and the binning's counters (tiles past
    the capacity, gaussians with more tiles than slots)."""
    image: torch.Tensor
    loss: torch.Tensor
    grads: dict
    overflowed: int
    slot_truncated: int


def _band_image(proj, colors, opac, ids, r0, r1, rs: Raster, tx, H, W,
                background):
    """(3, h, W) image of tile rows [r0, r1): their lists composited with
    the y coordinates shifted to the band's own frame (each list as long
    as the band's longest: the entries past a list's end are -1, of
    opacity 0)."""
    ids = ids[r0 * tx:r1 * tx]
    ids = ids[:, :max(int((ids >= 0).sum(-1).max()), 1)]
    lists = sr.fields(proj, colors, opac, ids)
    shift = torch.zeros(10, dtype=lists.dtype, device=lists.device)
    shift[1] = r0 * rs.ts
    h = min((r1 - r0) * rs.ts, H - r0 * rs.ts)
    return sr.composite(lists - shift, rs.ts, tx, r1 - r0, h, W,
                        rs.sigma_cutoff, background)


def _blocked(proj, colors, opac, ids, target, rs: Raster, tx, ty, H, W,
             bg, ssim_lambda, rows):
    """The image and loss, and the gradient to the graph of ``proj``,
    ``colors`` and ``opac``, in bands of ``rows`` tile rows."""
    screen = (proj.xy, proj.conic, colors, proj.depth, opac)
    leaf = [s.detach().requires_grad_() for s in screen]
    lp = sr.Projected(leaf[0], leaf[3], leaf[1], proj.radius.detach(),
                      proj.valid)
    bands = [(r, min(r + rows, ty)) for r in range(0, ty, rows)]
    with torch.no_grad():
        img = torch.cat([_band_image(lp, leaf[2], leaf[4], ids, r0, r1, rs,
                                     tx, H, W, bg) for r0, r1 in bands], 1)
    img = img.permute(1, 2, 0).contiguous().requires_grad_()
    loss = loss_of(img, target, ssim_lambda)
    (d_img,) = torch.autograd.grad(loss, img)
    d_img = d_img.permute(2, 0, 1)
    for r0, r1 in bands:
        band = _band_image(lp, leaf[2], leaf[4], ids, r0, r1, rs, tx, H, W,
                           bg)
        band.backward(d_img[:, r0 * rs.ts:r0 * rs.ts + band.shape[1]])
    outs = [(s, g.grad) for s, g in zip(screen, leaf) if g.grad is not None]
    torch.autograd.backward([s for s, _ in outs], [g for _, g in outs])
    return img, loss


def _screen(p: dict, cam: sr.Cam, rs: Raster, degree: int):
    """The scene ``p``'s projection, colours and opacities from ``cam``,
    and its tile lists: (proj, colors, opac, ids, overflowed tiles,
    slot-truncated gaussians, tx, ty)."""
    tx, ty = -(-cam.width // rs.ts), -(-cam.height // rs.ts)
    proj = sr.project(p["means"], p["quats"], p["log_scales"], cam)
    colors = sr.sh_colors(p["sh_dc"], p.get("sh_rest"), p["means"], cam,
                          degree)
    opac = torch.sigmoid(p["logit_opacities"])
    bins = sr.bin_tiles(sr.Projected(*(f.detach() for f in proj)), rs.ts,
                        tx, ty, rs.capacity, rs.max_tiles, rs.buckets)
    return (proj, colors, opac, bins.ids,
            int((bins.counts > rs.capacity).sum()), bins.slot_truncated,
            tx, ty)


def render(leaves: dict, cam: sr.Cam, rs: Raster, degree: int, background,
           rows_per_block: int = 1):
    """The image (H, W, 3) of the scene ``leaves`` from ``cam``, in bands
    of ``rows_per_block`` tile rows, and no gradient."""
    with torch.no_grad():
        proj, colors, opac, ids, _, _, tx, ty = _screen(leaves, cam, rs,
                                                        degree)
        bg = torch.as_tensor(background, dtype=leaves["means"].dtype,
                             device=leaves["means"].device)
        return torch.cat([
            _band_image(proj, colors, opac, ids, r, min(r + rows_per_block,
                                                        ty),
                        rs, tx, cam.height, cam.width, bg)
            for r in range(0, ty, rows_per_block)], 1).permute(1, 2, 0)


def step(leaves: dict, cam: sr.Cam, target, rs: Raster, degree: int,
         ssim_lambda: float, background, rows_per_block: int = 1) -> Step:
    """The render, loss and gradients of the scene ``leaves`` (the six
    fields, any float dtype) from ``cam`` against ``target`` (H, W, 3),
    in blocks of ``rows_per_block`` tile rows (``None``: the whole image
    in one autograd graph)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = {k: v.detach().clone().requires_grad_() for k, v in leaves.items()
         if v is not None}
    H, W = cam.height, cam.width
    proj, colors, opac, ids, overflowed, slot_truncated, tx, ty = _screen(
        p, cam, rs, degree)
    bg = torch.as_tensor(background, dtype=p["means"].dtype,
                         device=target.device)
    target = target.to(p["means"].dtype)
    if rows_per_block is None:           # one graph over the whole image
        img = _band_image(proj, colors, opac, ids, 0, ty, rs, tx, H, W,
                          bg).permute(1, 2, 0)
        loss = loss_of(img, target, ssim_lambda)
        loss.backward()
    else:
        img, loss = _blocked(proj, colors, opac, ids, target, rs, tx, ty, H,
                             W, bg, ssim_lambda, rows_per_block)
    grads = {k: v.grad for k, v in p.items()}
    return Step(img.detach(), loss.detach(), grads, overflowed,
                slot_truncated)


def means_lr(cfg: dict, t: int) -> float:
    """The means' learning rate at schedule position ``t``: splatfacto's
    exponential decay from ``lr_means`` to ``lr_means_final`` over
    ``max_num_iterations``."""
    lr0, lr1 = cfg["lr"]["means"], cfg["lr_means_final"]
    return lr0 * math.exp(math.log(lr1 / lr0) * t / cfg["max_num_iterations"])


def adam(param, grad, m, v, t: int, lr: float):
    """One Adam update of ``param`` from moments ``m``, ``v`` after ``t``
    − 1 earlier updates → (param, m, v)."""
    b1, b2 = BETAS
    m = b1 * m + (1.0 - b1) * grad
    v = b2 * v + (1.0 - b2) * grad * grad
    m_hat = m / (1.0 - b1 ** t)
    v_hat = v / (1.0 - b2 ** t)
    return param - lr * m_hat / (torch.sqrt(v_hat) + EPS), m, v


def cull_keep(leaves: dict, alpha_thresh: float, scale_thresh: float):
    """(N,) bool: the gaussians a cull round keeps."""
    return ((torch.sigmoid(leaves["logit_opacities"]) >= alpha_thresh)
            & (torch.exp(leaves["log_scales"]).amax(-1) <= scale_thresh))


def cull_band(leaves: dict, alpha_thresh: float, scale_thresh: float,
              band: float):
    """(N,) bool: the gaussians within ``band`` of a cull threshold (the
    opacity absolutely, the largest scale relative to its threshold),
    whose decision float rounding may turn either way."""
    o = torch.sigmoid(leaves["logit_opacities"].float())
    s = torch.exp(leaves["log_scales"].float()).amax(-1)
    return (((o - alpha_thresh).abs() <= band)
            | ((s - scale_thresh).abs() <= band * scale_thresh))
