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
tensor it launches the kernel (adding one to ``launches`` or
``launches_bwd``) or raises.  ``composite_static_fwd`` returns K1f's saved
state beside its outputs, for ``composite_static_bwd``.

Semantics (the reference's): payload (T, 10, K) rows [x, y, conic a b c,
r, g, b, depth, opacity], depth-sorted per tile, active entries first;
chunks of 128 entries at or past ``counts`` are skipped, tiles with
``skip`` == 0 emit rgb 0 / trans 1, and a tile stops once every pixel's
transmittance is below ``term_eps``, checked after each applied chunk.
Entries the forward never applied get a zero gradient.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from sim_a_splat_torch.ops import _kernels
from sim_a_splat_torch.ops.rasterize_reference import ALPHA_CLAMP, ALPHA_MIN

CHUNK = 128   # list entries per chunk

launches = 0      # K1f launches since the last reset (set to 0 to reset)
launches_bwd = 0  # K1b launches since the last reset

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
    covers tile ``tile_ids[i]`` (default: tile i).

    Returns (out (T, P, 8), carries (T, P, nc)) and, with ``return_work``,
    the work these inputs need per tile: chunks applied (T,) and
    (pixel, entry) pairs with alpha > 0, the ones composited (T,)."""
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
    for the cotangent ``ct`` of ``out`` (T, P, 8), by autograd through
    :func:`composite_static_plain` recomputed here.  It shares no algebra
    with the kernel's suffix sums, so it is an independent check."""
    with torch.enable_grad():
        leaf = payload.detach().requires_grad_()
        out, _ = composite_static_plain(leaf, counts, skip, ts, tx,
                                        sigma_cutoff, term_eps)
        (grad,) = torch.autograd.grad(out, leaf, ct, allow_unused=True)
    return torch.zeros_like(payload) if grad is None else grad


def _check_inputs(payload, counts, skip, ts):
    if payload.dtype != torch.float32 or payload.dim() != 3 \
            or payload.shape[1] != 10:
        raise ValueError("payload must be float32 (T, 10, K), got "
                         f"{payload.dtype} {tuple(payload.shape)}")
    T, _, K = payload.shape
    if K % CHUNK:
        raise ValueError(f"list capacity K={K} must be a multiple of {CHUNK}")
    for name, a in (("counts", counts), ("skip", skip)):
        if a.dtype != torch.int32 or tuple(a.shape) != (T,):
            raise ValueError(f"{name} must be int32 ({T},), got "
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


def composite_static_fwd(payload: torch.Tensor, counts: torch.Tensor,
                         skip: torch.Tensor, ts: int, tx: int,
                         sigma_cutoff: Optional[float] = None,
                         term_eps: Optional[float] = None):
    """K1f with the state K1b restarts from: (out (T, P, 8), carries
    (T, P, nc), chunk_acc (T, nc, 4, P), the r, g, b, depth_acc
    accumulators at the start of every chunk).  CUDA tensors launch K1f
    (one chunk-block launch and its combine, counted once in ``launches``);
    CPU tensors run the plain version, whose backward needs no saved state
    (chunk_acc None)."""
    global launches
    _check_inputs(payload, counts, skip, ts)
    if payload.device.type == "cpu":
        out, carries = composite_static_plain(payload, counts, skip, ts, tx,
                                              sigma_cutoff, term_eps)
        return out, carries, None
    payload, counts, skip = (a.contiguous() for a in (payload, counts, skip))
    T, _, K = payload.shape
    P = ts * ts
    nc = K // CHUNK
    out = payload.new_empty((T, P, 8))
    carries = payload.new_empty((T, P, nc))
    chunk_acc = payload.new_empty((T, nc, 4, P))
    pmin = power_min_of(sigma_cutoff)
    launch = _kernels.function("composite", "composite_static_launch",
                               _FWD_ARGS)
    with torch.cuda.device(payload.device):
        stream = torch.cuda.current_stream(payload.device).cuda_stream
        rc = launch(
            payload.data_ptr(), counts.data_ptr(), skip.data_ptr(),
            out.data_ptr(), carries.data_ptr(), chunk_acc.data_ptr(), T, K,
            ts, tx, 0.0 if pmin is None else pmin, int(pmin is not None),
            0.0 if term_eps is None else term_eps, int(term_eps is not None),
            stream)
    _kernels.check(rc, "composite_static")
    launches += 1
    return out, carries, chunk_acc


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
    (:func:`composite_static_fwd`).  CPU tensors run the plain version;
    CUDA tensors launch K1b, which restarts every applied chunk from its
    saved chunk-start transmittance and accumulators."""
    global launches_bwd
    _check_inputs(payload, counts, skip, ts)
    T, _, K = payload.shape
    P = ts * ts
    nc = K // CHUNK
    for name, a, shape in (("ct", ct, (T, P, 8)), ("out", out, (T, P, 8)),
                           ("carries", carries, (T, P, nc))):
        if a.dtype != torch.float32 or tuple(a.shape) != shape \
                or a.device != payload.device:
            raise ValueError(f"{name} must be float32 {shape} on "
                             f"{payload.device}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    if payload.device.type == "cpu":
        return composite_static_bwd_plain(payload, counts, skip, ct, ts, tx,
                                          sigma_cutoff, term_eps)
    shape = (T, nc, 4, P)
    if chunk_acc is None or chunk_acc.dtype != torch.float32 \
            or tuple(chunk_acc.shape) != shape \
            or chunk_acc.device != payload.device:
        raise ValueError(f"K1b restarts from the forward's chunk_acc, float32 "
                         f"{shape} on {payload.device} "
                         "(composite_static_fwd); got "
                         + ("None" if chunk_acc is None else
                            f"{chunk_acc.dtype} {tuple(chunk_acc.shape)} on "
                            f"{chunk_acc.device}"))
    payload, counts, skip, ct, out, carries, chunk_acc = (
        a.contiguous() for a in (payload, counts, skip, ct, out, carries,
                                 chunk_acc))
    grad = torch.empty_like(payload)
    pmin = power_min_of(sigma_cutoff)
    launch = _kernels.function("composite_bwd", "composite_static_bwd_launch",
                               _BWD_ARGS)
    with torch.cuda.device(payload.device):
        stream = torch.cuda.current_stream(payload.device).cuda_stream
        rc = launch(
            payload.data_ptr(), counts.data_ptr(), skip.data_ptr(),
            ct.data_ptr(), out.data_ptr(), carries.data_ptr(),
            chunk_acc.data_ptr(), grad.data_ptr(), T, K, ts, tx,
            0.0 if pmin is None else pmin, int(pmin is not None),
            0.0 if term_eps is None else term_eps, int(term_eps is not None),
            stream)
    _kernels.check(rc, "composite_static_bwd")
    launches_bwd += 1
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
    differentiable in the payload.  CPU tensors run the plain versions;
    CUDA tensors launch K1f, and K1b when the gradient is taken."""
    _check_inputs(payload, counts, skip, ts)
    return CompositeStatic.apply(payload, counts, skip, ts, tx, sigma_cutoff,
                                 term_eps)


# ctypes signatures of the launch functions: pointers, then
# T, K, ts, tx, power_min, has_pmin, term_eps, has_term, stream
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = [_I, _I, _I, _I, _F, _I, _F, _I, _VP]
_FWD_ARGS = [_VP] * 6 + _TAIL
_BWD_ARGS = [_VP] * 8 + _TAIL
