"""Kernel K1: per-tile front-to-back compositing of depth-sorted tile lists.

Replaces the TPU kernel ``_fwd_kernel`` (``_call_fwd``, under
``composite_pallas``) of ``sim_a_splat_tpu/ops/pallas_composite.py``.  The
CUDA source is ``csrc/composite.cu``; its note says what bounds it on an
H100 (latency of the per-pixel sequential walk at 256 blocks, not bytes or
FLOPs) and how the design keeps every operand on chip.

``composite_static`` is the wrapper: on a CPU tensor it runs
``composite_static_plain``, on a CUDA tensor it launches the kernel (and
adds one to ``launches``) or raises.  There is no backward kernel yet, so
the CUDA path refuses inputs that require grad.

Semantics (the reference's): payload (T, 10, K) rows [x, y, conic a b c,
r, g, b, depth, opacity], depth-sorted per tile, active entries first;
chunks of 128 entries at or past ``counts`` are skipped, tiles with
``skip`` == 0 emit rgb 0 / trans 1, and a tile stops once every pixel's
transmittance is below ``term_eps``, checked after each applied chunk.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from sim_a_splat_torch.ops import _kernels
from sim_a_splat_torch.ops.rasterize_reference import ALPHA_CLAMP, ALPHA_MIN

CHUNK = 128   # list entries per chunk

launches = 0  # kernel launches since the last reset (set to 0 to reset)

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
                           return_work: bool = False):
    """Plain PyTorch version of K1, vectorised over tiles and pixels with a
    loop over chunks (the chunk-granular early stop of the kernel).

    Returns (out (T, P, 8), carries (T, P, nc)) and, with ``return_work``,
    the work these inputs need per tile: chunks applied (T,) and
    (pixel, entry) pairs with alpha > 0, the ones composited (T,)."""
    T, _, K = payload.shape
    P = ts * ts
    nc = K // CHUNK
    pmin = power_min_of(sigma_cutoff)
    dev = payload.device
    px, py = pixel_centers(torch.arange(T, device=dev), ts, tx)
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
        raise ValueError(f"tile size {ts}: one thread per pixel needs "
                         "ts² ≤ 1024")


def composite_static(payload: torch.Tensor, counts: torch.Tensor,
                     skip: torch.Tensor, ts: int, tx: int,
                     sigma_cutoff: Optional[float] = None,
                     term_eps: Optional[float] = None):
    """K1 forward: payload (T, 10, K) float32, counts/skip (T,) int32 →
    (out (T, P, 8) [r, g, b, depth_acc, trans, 0, 0, 0], carries (T, P, nc)).
    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    global launches
    _check_inputs(payload, counts, skip, ts)
    if payload.device.type == "cpu":
        return composite_static_plain(payload, counts, skip, ts, tx,
                                      sigma_cutoff, term_eps)
    if payload.device.type != "cuda":
        raise ValueError(f"unsupported device {payload.device}")
    if payload.requires_grad:
        raise RuntimeError("composite_static has no backward kernel yet; "
                           "the CUDA path takes no input that requires grad")
    payload, counts, skip = (a.contiguous() for a in (payload, counts, skip))
    T, _, K = payload.shape
    P = ts * ts
    out = payload.new_empty((T, P, 8))
    carries = payload.new_empty((T, P, K // CHUNK))
    pmin = power_min_of(sigma_cutoff)
    lib = _lib()
    with torch.cuda.device(payload.device):
        stream = torch.cuda.current_stream(payload.device).cuda_stream
        rc = lib.composite_static_launch(
            payload.data_ptr(), counts.data_ptr(), skip.data_ptr(),
            out.data_ptr(), carries.data_ptr(), T, K, ts, tx,
            0.0 if pmin is None else pmin, int(pmin is not None),
            0.0 if term_eps is None else term_eps, int(term_eps is not None),
            stream)
    _kernels.check(rc, "composite_static")
    launches += 1
    return out, carries


def _lib() -> ctypes.CDLL:
    lib = _kernels.load("composite")
    f = lib.composite_static_launch
    if f.argtypes is None:
        vp, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        f.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, fl, i, fl, i, vp]
        f.restype = ctypes.c_int
    return lib
