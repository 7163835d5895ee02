"""Kernel K3: single-list selected-tile composite (the moving camera's
compositor), and its gradient.

Replaces the TPU kernels ``_fwd_kernel_single`` (``_call_single_fwd``) and
``_bwd_kernel_single`` (``_call_single_bwd``) under the custom VJP
``composite_sel_single`` of ``sim_a_splat_tpu/ops/pallas_composite_sel.py``,
in both of its modes: per-env payloads (B, T+1, 10, Km), the moving
camera's, and one payload (T+1, 10, Km) shared by every env.  The CUDA
sources are ``csrc/composite_single.cu`` (K3f) and
``csrc/composite_single_bwd.cu`` (K3b), both on K1's culled chunk walk
(``csrc/composite_static_walk.cuh``); their notes say what bounds each on
an H100 and what the design does about it.

``composite_sel_single`` is the public entry: it goes through the autograd
Function ``CompositeSelSingle``, whose forward is K3f and whose backward is
K3b.  CPU tensors run the plain versions (``composite_sel_single_plain``,
``composite_sel_single_bwd_plain``); CUDA tensors launch the kernels,
through the operators ``sim_a_splat::composite_sel_single`` and
``composite_sel_single_bwd`` (``ops/_kernels.py``), or raise.

Semantics (the reference's): slot (b, i) composites the depth-sorted list
``ids[b, i]`` (``spay_pad[b, ids[b, i]]`` per env, ``spay_pad[ids[b, i]]``
shared) front to back over the pixels of that tile, skipping chunks at or
past its count and stopping once every pixel's transmittance is below
``term_eps``, checked after each applied chunk.  The pad id T names a
zero-count row.  The output (B, T+1, 8, P) is channel-major and written
only at the rows (b, ids[b, i]): rows 0-2 rgb, 3 accumulated depth, 4 final
transmittance, 5 the number of applied chunks when the gradient will be
taken (0 otherwise), 6-7 zero.  The backward differentiates exactly that
many chunks.  Its gradient has the payload's shape: per env it lands at
the rows ``ids`` name (scattered by id, so each tile may be named once per
env apart from the pad id); shared, each slot's gradient is summed into its
tile's row over envs and slots.  Rows no slot names, and entries the
forward never applied, get zeros.  (The reference's per-env backward
places slot i's gradient at row i instead, ``pallas_composite_sel.py:
525-526``; its only caller names every tile in order, where the two agree.)

K3b restarts each applied chunk from the chunk-start transmittance and
accumulators, which each of its blocks recomputes (compositing the chunks
in front of its own), so the forward keeps no more than the reference does
(payload and ``out``).  Keeping them instead (chip_levers.py's lever
``k3_kept_state``) made K3b between 4 % slower and 19 % faster (about
11 % faster in the median of six runs) on the moving camera's frames and
cost 2.94 GiB more peak memory in a B=16, R=32 train rollout, on an H100
80GB HBM3 at 700 W (PERF.md §6).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from sim_a_splat_torch.ops import _kernels
from sim_a_splat_torch.ops.composite import (
    CHUNK, composite_static_plain, power_min_of,
)
from sim_a_splat_torch.utils.profiling import span

ROW_APPLIED = 5   # output row of the applied-chunk count (training forward)


def _slot_lists(spay_pad, counts_pad, ids):
    """(B·TT, 10, Km) lists and (B·TT,) counts of the slots ``ids`` name."""
    rows = ids.long()
    if spay_pad.dim() == 3:
        return spay_pad[rows].flatten(0, 1), counts_pad[rows].reshape(-1)
    bidx = torch.arange(ids.shape[0], device=ids.device)[:, None]
    return (spay_pad[bidx, rows].flatten(0, 1),
            counts_pad[bidx, rows].reshape(-1))


def composite_sel_single_plain(spay_pad, ids, counts_pad, ts: int, tx: int,
                               sigma_cutoff: Optional[float] = None,
                               term_eps: Optional[float] = None,
                               save_state: bool = False,
                               return_work: bool = False):
    """Plain PyTorch version of K3f: every slot's list through K1's plain
    version (vectorised over slots and pixels, a loop over chunks), per-env
    or shared payload.

    Returns out (B, T+1, 8, P), zero at rows no slot names, and with
    ``return_work`` the work per slot: applied chunks (B, TT) and
    (pixel, entry) pairs with alpha > 0, the ones composited (B, TT)."""
    B, TT = ids.shape
    T1 = spay_pad.shape[-3]
    P = ts * ts
    bidx = torch.arange(B, device=ids.device)[:, None]
    rows = ids.long()
    pay, cnt = _slot_lists(spay_pad, counts_pad, ids)
    res, _, applied, hits = composite_static_plain(
        pay, cnt, cnt, ts, tx, sigma_cutoff, term_eps, return_work=True,
        tile_ids=rows.reshape(-1))
    if save_state:
        res = torch.cat([res[..., :ROW_APPLIED],
                         applied.to(res.dtype)[:, None, None].expand(-1, P, 1),
                         res[..., ROW_APPLIED + 1:]], dim=-1)
    out = spay_pad.new_zeros((B, T1, 8, P))
    out[bidx, rows] = res.reshape(B, TT, P, 8).transpose(-1, -2)
    if return_work:
        return out, applied.reshape(B, TT), hits.reshape(B, TT)
    return out


def composite_sel_single_bwd_plain(spay_pad, ids, counts_pad, ct, ts: int,
                                   tx: int,
                                   sigma_cutoff: Optional[float] = None,
                                   term_eps: Optional[float] = None):
    """Plain PyTorch version of K3b: the gradient of ``spay_pad`` for the
    cotangent ``ct`` (B, T+1, 8, P) of ``out``, by autograd through
    :func:`composite_sel_single_plain` recomputed here (in shared mode the
    gathers sum each slot's gradient into its tile's row).  Only the rows
    ``ids`` name are read from ``ct``."""
    with torch.enable_grad():
        leaf = spay_pad.detach().requires_grad_()
        out = composite_sel_single_plain(leaf, ids, counts_pad, ts, tx,
                                         sigma_cutoff, term_eps)
        bidx = torch.arange(ids.shape[0], device=ids.device)[:, None]
        rows = ids.long()
        (grad,) = torch.autograd.grad(out[bidx, rows], leaf, ct[bidx, rows],
                                      allow_unused=True)
    return torch.zeros_like(spay_pad) if grad is None else grad


def _check_inputs(spay_pad, ids, counts_pad, ts):
    if spay_pad.dtype != torch.float32 or spay_pad.dim() not in (3, 4) \
            or spay_pad.shape[-2] != 10:
        raise ValueError("spay_pad must be float32 (B, T+1, 10, Km) per env "
                         "or (T+1, 10, Km) shared, got "
                         f"{spay_pad.dtype} {tuple(spay_pad.shape)}")
    shared = spay_pad.dim() == 3
    T1, _, Km = spay_pad.shape[-3:]
    if Km % CHUNK:
        raise ValueError(f"list capacity Km={Km} must be a multiple of "
                         f"{CHUNK}")
    if ids.dtype != torch.int32 or ids.dim() != 2 \
            or (not shared and ids.shape[0] != spay_pad.shape[0]):
        want = "(B, TT)" if shared else f"({spay_pad.shape[0]}, TT)"
        raise ValueError(f"ids must be int32 {want}, got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    shape = (T1,) if shared else (spay_pad.shape[0], T1)
    if counts_pad.dtype != torch.int32 or tuple(counts_pad.shape) != shape:
        raise ValueError(f"counts_pad must be int32 {shape}, got "
                         f"{counts_pad.dtype} {tuple(counts_pad.shape)}")
    for a in (ids, counts_pad):
        if a.device != spay_pad.device:
            raise ValueError("all inputs must be on one device")
    if not 1 <= ts <= 32:
        raise ValueError(f"tile size {ts}: the kernels' pixel layout takes "
                         "1 ≤ ts ≤ 32")
    if spay_pad.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {spay_pad.device}")


# ctypes signatures of the launch functions: pointers, then B, TT, T+1, Km,
# ts, tx, power_min, has_pmin, [term_eps, has_term, save_state,] shared,
# stream
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_VP] * 4 + [_I] * 6 + [_F, _I, _F, _I, _I, _I, _VP]
_BWD_ARGS = [_VP] * 7 + [_I] * 6 + [_F, _I, _I, _VP]


@span("render.k3f")
def composite_sel_single_fwd(spay_pad, ids, counts_pad, ts: int, tx: int,
                             sigma_cutoff: Optional[float] = None,
                             term_eps: Optional[float] = None,
                             save_state: bool = False):
    """K3f → out (B, T+1, 8, P).  ``save_state`` records the applied-chunk
    count in row 5 (the training forward).  CPU tensors run the plain
    version."""
    _check_inputs(spay_pad, ids, counts_pad, ts)
    if spay_pad.device.type == "cpu":
        return composite_sel_single_plain(spay_pad, ids, counts_pad, ts, tx,
                                          sigma_cutoff, term_eps,
                                          save_state)
    return torch.ops.sim_a_splat.composite_sel_single(
        *(a.contiguous() for a in (spay_pad, ids, counts_pad)), ts, tx,
        sigma_cutoff, term_eps, save_state)


@_kernels.operator(
    "composite_sel_single(Tensor spay_pad, Tensor ids, Tensor counts_pad, "
    "int ts, int tx, float? sigma_cutoff, float? term_eps, bool save_state) "
    "-> Tensor")
def _launch_fwd(spay_pad, ids, counts_pad, ts, tx, sigma_cutoff, term_eps,
                save_state):
    B, TT = ids.shape
    T1, _, Km = spay_pad.shape[-3:]
    out = spay_pad.new_empty((B, T1, 8, ts * ts))
    pmin = power_min_of(sigma_cutoff)
    _kernels.launch(
        "composite_single", "composite_sel_single", _FWD_ARGS,
        spay_pad.device, spay_pad.data_ptr(), ids.data_ptr(),
        counts_pad.data_ptr(), out.data_ptr(), B, TT, T1, Km, ts, tx,
        0.0 if pmin is None else pmin, int(pmin is not None),
        0.0 if term_eps is None else term_eps, int(term_eps is not None),
        int(save_state), int(spay_pad.dim() == 3))
    return out


@span("render.k3b")
def composite_sel_single_bwd(spay_pad, ids, counts_pad, ct, out, ts: int,
                             tx: int, sigma_cutoff: Optional[float] = None,
                             term_eps: Optional[float] = None):
    """K3 backward: the gradient of ``spay_pad`` for the cotangent ``ct``
    (B, T+1, 8, P), given the forward's ``out``, which must carry the
    applied-chunk count in row 5 (a forward run with ``save_state``).  CPU
    tensors run the plain version.  CUDA tensors launch K3b, whose blocks
    each restart an applied chunk from the chunk-start state they
    recompute."""
    _check_inputs(spay_pad, ids, counts_pad, ts)
    B, T1 = ids.shape[0], spay_pad.shape[-3]
    P = ts * ts
    for name, a, shape in (("ct", ct, (B, T1, 8, P)),
                           ("out", out, (B, T1, 8, P))):
        if a.dtype != torch.float32 or tuple(a.shape) != shape \
                or a.device != spay_pad.device:
            raise ValueError(f"{name} must be float32 {shape} on "
                             f"{spay_pad.device}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    if spay_pad.device.type == "cpu":
        return composite_sel_single_bwd_plain(spay_pad, ids, counts_pad, ct,
                                              ts, tx, sigma_cutoff, term_eps)
    return torch.ops.sim_a_splat.composite_sel_single_bwd(
        *(a.contiguous() for a in (spay_pad, ids, counts_pad, ct, out)), ts,
        tx, sigma_cutoff)


@_kernels.operator(
    "composite_sel_single_bwd(Tensor spay_pad, Tensor ids, Tensor "
    "counts_pad, Tensor ct, Tensor out, int ts, int tx, float? sigma_cutoff) "
    "-> Tensor")
def _launch_bwd(spay_pad, ids, counts_pad, ct, out, ts, tx, sigma_cutoff):
    B, T1 = ids.shape[0], spay_pad.shape[-3]
    shared = spay_pad.dim() == 3
    if shared:
        grad, named = torch.zeros_like(spay_pad), None
    else:
        # every column of every row is written once by the kernel
        grad = torch.empty_like(spay_pad)
        named = torch.zeros((B, T1), dtype=torch.int32,
                            device=spay_pad.device)
        named[torch.arange(B, device=ids.device)[:, None], ids.long()] = 1
    pmin = power_min_of(sigma_cutoff)
    _kernels.launch(
        "composite_single_bwd", "composite_sel_single_bwd", _BWD_ARGS,
        spay_pad.device, spay_pad.data_ptr(), ids.data_ptr(),
        counts_pad.data_ptr(), None if named is None else named.data_ptr(),
        ct.data_ptr(), out.data_ptr(), grad.data_ptr(),
        B, ids.shape[1], T1, spay_pad.shape[-1], ts, tx,
        0.0 if pmin is None else pmin, int(pmin is not None), int(shared))
    return grad


class CompositeSelSingle(torch.autograd.Function):
    """K3 with its gradient: forward K3f → out (B, T+1, 8, P), with the
    applied-chunk count in row 5 when the gradient will be taken; backward
    K3b → the gradient of the payload."""

    @staticmethod
    def forward(ctx, spay_pad, ids, counts_pad, ts, tx, sigma_cutoff,
                term_eps, save_state):
        out = composite_sel_single_fwd(spay_pad, ids, counts_pad, ts, tx,
                                       sigma_cutoff, term_eps, save_state)
        ctx.save_for_backward(spay_pad, ids, counts_pad, out)
        ctx.args = (ts, tx, sigma_cutoff, term_eps)
        return out

    @staticmethod
    def backward(ctx, ct):
        spay_pad, ids, counts_pad, out = ctx.saved_tensors
        grad = composite_sel_single_bwd(spay_pad, ids, counts_pad, ct, out,
                                        *ctx.args)
        return grad, None, None, None, None, None, None, None


def composite_sel_single(spay_pad: torch.Tensor, ids: torch.Tensor,
                         counts_pad: torch.Tensor, ts: int, tx: int,
                         sigma_cutoff: Optional[float] = None,
                         term_eps: Optional[float] = None) -> torch.Tensor:
    """K3: payload (B, T+1, 10, Km) per env or (T+1, 10, Km) shared,
    float32, ids (B, TT) and counts_pad ((B, T+1) or (T+1,)) int32 → out
    (B, T+1, 8, P) channel-major [r, g, b, depth_acc, trans, applied chunks,
    0, 0], written only at the rows ``ids`` name, differentiable in the
    payload.  CPU tensors run the plain versions; CUDA tensors launch K3f,
    and K3b when the gradient is taken."""
    _check_inputs(spay_pad, ids, counts_pad, ts)
    save_state = torch.is_grad_enabled() and spay_pad.requires_grad
    return CompositeSelSingle.apply(spay_pad, ids, counts_pad, ts, tx,
                                    sigma_cutoff, term_eps, save_state)
