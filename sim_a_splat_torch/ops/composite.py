"""Kernel K1: per-tile front-to-back compositing of depth-sorted tile lists,
and its gradient.

Replaces the TPU kernels ``_fwd_kernel`` (``_call_fwd``) and ``_bwd_kernel``
(``_call_bwd``) under the custom VJP ``composite_pallas`` of
``sim_a_splat_tpu/ops/pallas_composite.py``.  The CUDA sources are
``csrc/composite.cu`` (K1f) and ``csrc/composite_bwd.cu`` (K1b), with their
chunk walk in ``csrc/composite_static_walk.cuh``; their notes say what
bounds each on an H100 and what the design does about it: one block per
(tile, chunk) composites its chunk from transmittance 1, an in-order
combine per tile applies the chunks with the reference's early stop, and
K1b restarts every applied chunk in parallel from the state the forward
saved (``chunk_acc``), with K2's warp-level footprint cull in both.

``composite_static`` is the public entry: it goes through the autograd
Function ``CompositeStatic``, whose forward is K1f and whose backward is
K1b.  On a CPU tensor each direction runs its plain version
(``composite_static_plain``, ``composite_static_bwd_plain``); on a CUDA
tensor it launches the kernel, through the operator
``sim_a_splat::composite_static`` or ``composite_static_bwd``
(``ops/_kernels.py``), or raises.  ``composite_static_fwd`` returns K1f's
saved state beside its outputs, for ``composite_static_bwd``.

Semantics (the reference's): payload (T, 10, K) rows [x, y, conic a b c,
r, g, b, depth, opacity], depth-sorted per tile, active entries first;
chunks of 128 entries at or past ``counts`` are skipped, tiles with
``skip`` == 0 emit rgb 0 / trans 1, and a tile stops once every pixel's
transmittance is below ``term_eps``, checked after each applied chunk.
Entries the forward never applied get a zero gradient.  Every function
also takes a leading env axis, payload (B, T, 10, K) with (B, T) counts
and skip, as ``jax.vmap`` of the reference's kernel over envs: the
kernels run over the B·T lists and each list covers tile ``t % T`` of its
image.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from sim_a_splat_torch.ops import _kernels
from sim_a_splat_torch.ops.rasterize_reference import ALPHA_CLAMP, ALPHA_MIN
from sim_a_splat_torch.utils.profiling import span

CHUNK = 128   # list entries per chunk

_ROW_RGBD = slice(5, 9)    # r, g, b, depth
_ROW_DEPTH = 8


def power_min_of(sigma_cutoff: Optional[float]) -> Optional[float]:
    return None if sigma_cutoff is None else -0.5 * sigma_cutoff**2


def pixel_centers(tile_ids: torch.Tensor, ts: int, tx: int):
    """(S,) tile ids → pixel-centre coordinates px, py (S, P), row-major."""
    p = torch.arange(ts * ts, device=tile_ids.device)
    t = tile_ids.long()[:, None]
    px = ((p % ts).float() + 0.5) + ((t % tx) * ts).float()
    py = ((p // ts).float() + 0.5) + ((t // tx) * ts).float()
    return px, py


def entry_alpha(rows: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                power_min: Optional[float]) -> torch.Tensor:
    """Alphas of list entries at pixels: ``rows`` (S, 10, C) payload block,
    ``px``/``py`` (S, P) → (S, P, C), term by term as ``_chunk_geometry``."""
    gx, gy = rows[:, None, 0, :], rows[:, None, 1, :]
    ca, cb, cc = rows[:, None, 2, :], rows[:, None, 3, :], rows[:, None, 4, :]
    op = rows[:, None, 9, :]
    dx = px[..., None] - gx
    dy = py[..., None] - gy
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp(op * torch.exp(torch.clamp(power, max=0.0)),
                        max=ALPHA_CLAMP)
    keep = alpha >= ALPHA_MIN
    if power_min is not None:
        keep &= power >= power_min
    return torch.where(keep, alpha, torch.zeros_like(alpha))


def composite_static_plain(payload: torch.Tensor, counts: torch.Tensor,
                           skip: torch.Tensor, ts: int, tx: int,
                           sigma_cutoff: Optional[float] = None,
                           term_eps: Optional[float] = None,
                           return_work: bool = False,
                           tile_ids: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K1, vectorised over tiles and pixels with a
    loop over chunks (the chunk-granular early stop of the kernel).  List i
    covers tile ``tile_ids[i]`` (default: tile i); with a leading env axis
    (payload (B, T, 10, K)) every env's list i does.

    Returns (out (T, P, 8), carries (T, P, nc)) and, with ``return_work``,
    the work these inputs need per tile: chunks applied (T,) and
    (pixel, entry) pairs with alpha > 0, the ones composited (T,); each
    with the env axis in front where the payload has one."""
    if payload.dim() == 4:
        B, T = payload.shape[:2]
        if tile_ids is None:
            tile_ids = torch.arange(T, device=payload.device)
        res = composite_static_plain(
            payload.flatten(0, 1), counts.flatten(), skip.flatten(), ts, tx,
            sigma_cutoff, term_eps, return_work, tile_ids.repeat(B))
        return tuple(a.reshape(B, T, *a.shape[1:]) for a in res)
    T, _, K = payload.shape
    P = ts * ts
    nc = K // CHUNK
    pmin = power_min_of(sigma_cutoff)
    dev = payload.device
    if tile_ids is None:
        tile_ids = torch.arange(T, device=dev)
    px, py = pixel_centers(tile_ids, ts, tx)
    count = torch.where(skip > 0, counts, torch.zeros_like(counts)).long()
    acc = payload.new_zeros((T, P, 4))
    tc = payload.new_ones((T, P))
    alive = torch.ones(T, dtype=torch.bool, device=dev)
    applied = torch.zeros(T, dtype=torch.long, device=dev)
    hits = torch.zeros(T, dtype=torch.long, device=dev)
    carries = payload.new_empty((T, P, nc))
    lane = torch.arange(CHUNK, device=dev)
    for c in range(nc):
        carries[:, :, c] = tc
        c0 = c * CHUNK
        act = alive & (c0 < count)
        if not bool(act.any()):
            continue
        rows = payload[:, :, c0:c0 + CHUNK]
        alpha = entry_alpha(rows, px, py, pmin)
        in_list = (c0 + lane)[None, :] < count[:, None]       # (T, C)
        alpha = torch.where(in_list[:, None, :], alpha, torch.zeros_like(alpha))
        om = 1.0 - alpha
        cp = torch.cumprod(om, dim=-1)
        w = alpha * (cp / om) * tc[..., None]
        acc_new = acc + torch.einsum("tpc,tkc->tpk", w, rows[:, _ROW_RGBD, :])
        tc_new = tc * cp[..., -1]
        acc = torch.where(act[:, None, None], acc_new, acc)
        tc = torch.where(act[:, None], tc_new, tc)
        applied += act.long()
        hits += (alpha > 0).sum(dim=(1, 2)) * act
        if term_eps is not None:
            alive = torch.where(act, tc_new.amax(dim=-1) >= term_eps, alive)
    out = torch.cat([acc, tc[..., None], payload.new_zeros((T, P, 3))], dim=-1)
    if return_work:
        return out, carries, applied, hits
    return out, carries


def composite_static_bwd_plain(payload: torch.Tensor, counts: torch.Tensor,
                               skip: torch.Tensor, ct: torch.Tensor, ts: int,
                               tx: int, sigma_cutoff: Optional[float] = None,
                               term_eps: Optional[float] = None):
    """Plain PyTorch version of K1b: the gradient of the payload (T, 10, K)
    (or (B, T, 10, K)) for the cotangent ``ct`` of ``out`` (T, P, 8) (or
    (B, T, P, 8)), by autograd through
    :func:`composite_static_plain` recomputed here.  It shares no algebra
    with the kernel's suffix sums, so it is an independent check."""
    with torch.enable_grad():
        leaf = payload.detach().requires_grad_()
        out, _ = composite_static_plain(leaf, counts, skip, ts, tx,
                                        sigma_cutoff, term_eps)
        (grad,) = torch.autograd.grad(out, leaf, ct, allow_unused=True)
    return torch.zeros_like(payload) if grad is None else grad


def _check_inputs(payload, counts, skip, ts):
    if payload.dtype != torch.float32 or payload.dim() not in (3, 4) \
            or payload.shape[-2] != 10:
        raise ValueError("payload must be float32 (T, 10, K) or "
                         f"(B, T, 10, K), got {payload.dtype} "
                         f"{tuple(payload.shape)}")
    lead, K = tuple(payload.shape[:-2]), payload.shape[-1]
    if K % CHUNK:
        raise ValueError(f"list capacity K={K} must be a multiple of {CHUNK}")
    for name, a in (("counts", counts), ("skip", skip)):
        if a.dtype != torch.int32 or tuple(a.shape) != lead:
            raise ValueError(f"{name} must be int32 {lead}, got "
                             f"{a.dtype} {tuple(a.shape)}")
        if a.device != payload.device:
            raise ValueError(f"{name} is on {a.device}, payload on "
                             f"{payload.device}")
    if not (ts * ts <= 1024):
        raise ValueError(f"tile size {ts}: the kernels' pixel layout needs "
                         "ts² ≤ 1024")
    if payload.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {payload.device}")


# ---- the kernels' block layout (csrc/composite_static_walk.cuh) -------------

RECT_X, RECT_Y = 8, 4   # a warp's pixel rectangle in the K1 blocks
                        # (stat::RECT_X, RECT_Y), one pixel a thread


def kernel_threads(ts: int) -> int:
    """Threads of a K1f chunk block or a K1b block at tile size ``ts``: each
    warp owns an 8 × 4 rectangle of pixel centres, and the rectangles cover
    the tile rounded up to whole rectangles."""
    return -(-ts // RECT_X) * -(-ts // RECT_Y) * 32


def warp_rects(tile_ids: torch.Tensor, ts: int, tx: int) -> torch.Tensor:
    """(S,) tile ids → (S, W, 4) float32 [rx0, rx1, ry0, ry1], the pixel
    centres spanned by each of the W warps of a K1 chunk block
    (``stat::Pixel``), row-major; past the tile's edge where ts is not a
    multiple of the rectangle (those pixels are never composited)."""
    wgx = -(-ts // RECT_X)
    w = torch.arange(kernel_threads(ts) // 32, device=tile_ids.device)
    wx = (w % wgx) * RECT_X
    wy = (w // wgx) * RECT_Y
    t = tile_ids.long()[:, None]
    ox, oy = ((t % tx) * ts).float(), ((t // tx) * ts).float()
    return torch.stack([(wx.float() + 0.5) + ox,
                        ((wx + RECT_X - 1).float() + 0.5) + ox,
                        (wy.float() + 0.5) + oy,
                        ((wy + RECT_Y - 1).float() + 0.5) + oy], dim=-1)


@span("render.k1f")
def composite_static_fwd(payload: torch.Tensor, counts: torch.Tensor,
                         skip: torch.Tensor, ts: int, tx: int,
                         sigma_cutoff: Optional[float] = None,
                         term_eps: Optional[float] = None):
    """K1f with the state K1b restarts from: (out (T, P, 8), carries
    (T, P, nc), chunk_acc (T, nc, 4, P), the r, g, b, depth_acc
    accumulators at the start of every chunk), each with the payload's env
    axis in front where it has one.  CUDA tensors launch K1f (one
    chunk-block launch and its combine over all B·T lists, one operator
    call); CPU tensors run the plain version, whose backward needs no saved
    state (chunk_acc None)."""
    _check_inputs(payload, counts, skip, ts)
    if payload.device.type == "cpu":
        out, carries = composite_static_plain(payload, counts, skip, ts, tx,
                                              sigma_cutoff, term_eps)
        return out, carries, None
    return torch.ops.sim_a_splat.composite_static(
        *(a.contiguous() for a in (payload, counts, skip)), ts, tx,
        sigma_cutoff, term_eps)


def _scalars(payload, ts, tx, sigma_cutoff, term_eps):
    pmin = power_min_of(sigma_cutoff)
    return (payload.shape[:-2].numel(), payload.shape[-3],
            payload.shape[-1], ts, tx, 0.0 if pmin is None else pmin,
            int(pmin is not None), 0.0 if term_eps is None else term_eps,
            int(term_eps is not None))


@_kernels.operator(
    "composite_static(Tensor payload, Tensor counts, Tensor skip, int ts, "
    "int tx, float? sigma_cutoff, float? term_eps) -> (Tensor, Tensor, "
    "Tensor)")
def _launch_fwd(payload, counts, skip, ts, tx, sigma_cutoff, term_eps):
    lead, K = tuple(payload.shape[:-2]), payload.shape[-1]
    P = ts * ts
    nc = K // CHUNK
    out = payload.new_empty(lead + (P, 8))
    carries = payload.new_empty(lead + (P, nc))
    chunk_acc = payload.new_empty(lead + (nc, 4, P))
    _kernels.launch(
        "composite", "composite_static", _FWD_ARGS, payload.device,
        payload.data_ptr(), counts.data_ptr(), skip.data_ptr(),
        out.data_ptr(), carries.data_ptr(), chunk_acc.data_ptr(),
        *_scalars(payload, ts, tx, sigma_cutoff, term_eps))
    return out, carries, chunk_acc


@span("render.k1b")
def composite_static_bwd(payload: torch.Tensor, counts: torch.Tensor,
                         skip: torch.Tensor, ct: torch.Tensor,
                         out: torch.Tensor, carries: torch.Tensor, ts: int,
                         tx: int, sigma_cutoff: Optional[float] = None,
                         term_eps: Optional[float] = None,
                         chunk_acc: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """K1 backward: the gradient of the payload (T, 10, K) for the
    cotangent ``ct`` (T, P, 8) of the forward's ``out``, given that
    forward's ``out``, ``carries`` and ``chunk_acc``
    (:func:`composite_static_fwd`), each with the payload's env axis in
    front where it has one.  CPU tensors run the plain version; CUDA
    tensors launch K1b, which restarts every applied chunk from its saved
    chunk-start transmittance and accumulators."""
    _check_inputs(payload, counts, skip, ts)
    lead, K = tuple(payload.shape[:-2]), payload.shape[-1]
    P = ts * ts
    nc = K // CHUNK
    for name, a, shape in (("ct", ct, lead + (P, 8)),
                           ("out", out, lead + (P, 8)),
                           ("carries", carries, lead + (P, nc))):
        if a.dtype != torch.float32 or tuple(a.shape) != shape \
                or a.device != payload.device:
            raise ValueError(f"{name} must be float32 {shape} on "
                             f"{payload.device}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    if payload.device.type == "cpu":
        return composite_static_bwd_plain(payload, counts, skip, ct, ts, tx,
                                          sigma_cutoff, term_eps)
    shape = lead + (nc, 4, P)
    if chunk_acc is None or chunk_acc.dtype != torch.float32 \
            or tuple(chunk_acc.shape) != shape \
            or chunk_acc.device != payload.device:
        raise ValueError(f"K1b restarts from the forward's chunk_acc, float32 "
                         f"{shape} on {payload.device} "
                         "(composite_static_fwd); got "
                         + ("None" if chunk_acc is None else
                            f"{chunk_acc.dtype} {tuple(chunk_acc.shape)} on "
                            f"{chunk_acc.device}"))
    return torch.ops.sim_a_splat.composite_static_bwd(
        *(a.contiguous() for a in (payload, counts, skip, ct, out, carries,
                                   chunk_acc)), ts, tx, sigma_cutoff,
        term_eps)


@_kernels.operator(
    "composite_static_bwd(Tensor payload, Tensor counts, Tensor skip, "
    "Tensor ct, Tensor out, Tensor carries, Tensor chunk_acc, int ts, "
    "int tx, float? sigma_cutoff, float? term_eps) -> Tensor")
def _launch_bwd(payload, counts, skip, ct, out, carries, chunk_acc, ts, tx,
                sigma_cutoff, term_eps):
    grad = torch.empty_like(payload)
    _kernels.launch(
        "composite_bwd", "composite_static_bwd", _BWD_ARGS, payload.device,
        *(a.data_ptr() for a in (payload, counts, skip, ct, out, carries,
                                 chunk_acc, grad)),
        *_scalars(payload, ts, tx, sigma_cutoff, term_eps))
    return grad


class CompositeStatic(torch.autograd.Function):
    """K1 with its gradient: forward K1f → (out, carries), backward K1b →
    the payload's gradient.  ``carries`` is saved state, not an output to
    differentiate; so is K1f's ``chunk_acc``, which only K1b reads."""

    @staticmethod
    def forward(ctx, payload, counts, skip, ts, tx, sigma_cutoff, term_eps):
        out, carries, chunk_acc = composite_static_fwd(
            payload, counts, skip, ts, tx, sigma_cutoff, term_eps)
        ctx.save_for_backward(payload, counts, skip, out, carries, chunk_acc)
        ctx.mark_non_differentiable(carries)
        ctx.args = (ts, tx, sigma_cutoff, term_eps)
        return out, carries

    @staticmethod
    def backward(ctx, ct_out, _ct_carries):
        payload, counts, skip, out, carries, chunk_acc = ctx.saved_tensors
        grad = composite_static_bwd(payload, counts, skip, ct_out, out,
                                    carries, *ctx.args, chunk_acc=chunk_acc)
        return grad, None, None, None, None, None, None


def composite_static(payload: torch.Tensor, counts: torch.Tensor,
                     skip: torch.Tensor, ts: int, tx: int,
                     sigma_cutoff: Optional[float] = None,
                     term_eps: Optional[float] = None):
    """K1: payload (T, 10, K) float32, counts/skip (T,) int32 →
    (out (T, P, 8) [r, g, b, depth_acc, trans, 0, 0, 0], carries (T, P, nc)),
    differentiable in the payload; or B envs' (B, T, 10, K) and (B, T) →
    (B, T, P, 8), (B, T, P, nc) in one launch.  CPU tensors run the plain
    versions; CUDA tensors launch K1f, and K1b when the gradient is
    taken."""
    _check_inputs(payload, counts, skip, ts)
    return CompositeStatic.apply(payload, counts, skip, ts, tx, sigma_cutoff,
                                 term_eps)


# ctypes signatures of the launch functions: pointers, then the lists
# T (B·T_img), the tiles of an image T_img, K, ts, tx, power_min, has_pmin,
# term_eps, has_term, stream
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = [_I, _I, _I, _I, _I, _F, _I, _F, _I, _VP]
_FWD_ARGS = [_VP] * 6 + _TAIL
_BWD_ARGS = [_VP] * 8 + _TAIL
