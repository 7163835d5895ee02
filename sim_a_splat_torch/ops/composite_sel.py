"""Kernel K2: selected-tile composite of the shared static tile lists
interleaved by depth with each env's dynamic lists, and its gradient.

Replaces the TPU kernels ``_fwd_kernel`` (``_call_fwd``) and ``_bwd_kernel``
(``_call_bwd``) under the custom VJP ``composite_pair_sel`` (shared 3-D
static payload) of ``sim_a_splat_tpu/ops/pallas_composite_sel.py``.  The
CUDA sources are ``csrc/composite_sel.cu`` (K2f) and
``csrc/composite_sel_bwd.cu`` (K2b); their notes say what bounds each on
an H100 (the per-pixel sequential walk, not bytes) and what the designs do
about it (both lists in shared memory, the merged order walked directly
instead of the TPU's depth-indicator contractions, and in K2b the forward
walk replayed, so no state is saved).

``composite_pair_sel`` is the public entry: it goes through the autograd
Function ``CompositePairSel``, whose forward is K2f and whose backward is
K2b followed by the per-tile sum of the static gradients (``index_add_``,
as the reference sums outside its kernel in ``_scatter_rows``).  CPU
tensors run the plain versions (``composite_pair_sel_plain``,
``composite_pair_sel_bwd_plain``); CUDA tensors launch the kernels (adding
one to ``launches`` or ``launches_bwd``) or raise.  Only the shared-payload
mode is ported; the per-env 4-D payload belongs to the moving camera and
raises.

The plain forward follows the reference's algebra (log-space
transmittances and depth-indicator contractions, chunk-granular early stop
on ts·Td(< dbound)); the kernels walk the merged sequence.  The two agree
to float32 rounding on lists that obey the contract (depth-sorted, active
entries first, inactive entries at opacity 0).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from sim_a_splat_torch.ops import _kernels
from sim_a_splat_torch.ops.composite import (
    CHUNK, _ROW_DEPTH, _ROW_RGBD, entry_alpha, pixel_centers, power_min_of,
)

launches = 0      # K2f launches since the last reset (set to 0 to reset)
launches_bwd = 0  # K2b launches since the last reset

# shared memory a block may opt into on Hopper (H100/H200: 227 KB)
SMEM_OPTIN_BYTES = 232_448

SLOT_BLOCK = 512  # slots per vectorised step of the plain version


def _plain_slots(spay_pad, dp, tid, counts_s_pad, cd, ts, tx, pmin,
                 term_eps):
    """Plain K2 on S slots: dp (S, 10, Kd), tid/cd (S,) → ((S, 8, P) rows,
    applied static chunks (S,), composited (pixel, entry) pairs (S,))."""
    S, _, Kd = dp.shape
    Ks = spay_pad.shape[-1]
    P = ts * ts
    dev = dp.device
    count_s = torch.clamp(counts_s_pad[tid].long(), max=Ks)
    count_d = torch.clamp(cd.long(), max=Kd)
    px, py = pixel_centers(tid, ts, tx)

    ad = entry_alpha(dp, px, py, pmin)                         # (S, P, Kd)
    d_in = torch.arange(Kd, device=dev)[None, :] < count_d[:, None]
    ad = torch.where(d_in[:, None, :], ad, torch.zeros_like(ad))
    ld = torch.log1p(-ad)
    dd = dp[:, _ROW_DEPTH, :]                                  # (S, Kd)
    sum_ld = ld.sum(dim=-1, keepdim=True)                      # (S, P, 1)

    sp = spay_pad[tid]                                         # (S, 10, Ks)
    acc = dp.new_zeros((S, P, 4))
    tsv = dp.new_ones((S, P))
    ltsd = torch.zeros_like(ld)
    alive = torch.ones(S, dtype=torch.bool, device=dev)
    applied = torch.zeros(S, dtype=torch.long, device=dev)
    hits = (ad > 0).sum(dim=(1, 2))              # every active dynamic entry
    lane = torch.arange(CHUNK, device=dev)
    for c0 in range(0, Ks, CHUNK):
        act = alive & (c0 < count_s)
        if not bool(act.any()):
            break
        rows = sp[:, :, c0:c0 + CHUNK]
        in_list = (c0 + lane)[None, :] < count_s[:, None]     # (S, C)
        alpha = entry_alpha(rows, px, py, pmin)
        alpha = torch.where(in_list[:, None, :], alpha, torch.zeros_like(alpha))
        ls = torch.log1p(-alpha)
        cs = torch.cumsum(ls, dim=-1)
        ds = rows[:, _ROW_DEPTH, :]                            # (S, C)
        # static entry i in front of dynamic entry j iff ds_i <= dd_j
        ind = (ds[:, :, None] <= dd[:, None, :]).to(dp.dtype)  # (S, C, Kd)
        # log Td(< ds_i) = Σ_j [dd_j < ds_i] ld_j
        logtd = sum_ld - torch.bmm(ld, ind.transpose(1, 2))    # (S, P, C)
        w = alpha * torch.exp(cs - ls + logtd) * tsv[..., None]
        acc_new = acc + torch.bmm(w, rows[:, _ROW_RGBD, :].transpose(1, 2))
        ltsd_new = ltsd + torch.bmm(ls, ind)                   # (S, P, Kd)
        ts_new = tsv * torch.exp(cs[..., -1])
        acc = torch.where(act[:, None, None], acc_new, acc)
        ltsd = torch.where(act[:, None, None], ltsd_new, ltsd)
        tsv = torch.where(act[:, None], ts_new, tsv)
        applied += act.long()
        hits += (alpha > 0).sum(dim=(1, 2)) * act
        if term_eps is not None:
            neg_inf = torch.full_like(ds, float("-inf"))
            dbound = torch.where(in_list, ds, neg_inf).amax(dim=-1)  # (S,)
            in_front = dd[:, None, :] < dbound[:, None, None]
            td_b = torch.exp(torch.where(in_front, ld,
                                         torch.zeros_like(ld)).sum(dim=-1))
            alive = torch.where(act, (ts_new * td_b).amax(dim=-1) >= term_eps,
                                alive)
    csd = torch.cumsum(ld, dim=-1)
    wd = ad * torch.exp(csd - ld + ltsd)
    acc = acc + torch.bmm(wd, dp[:, _ROW_RGBD, :].transpose(1, 2))
    trans = tsv * torch.exp(sum_ld[..., 0])
    res = torch.cat([acc, trans[..., None], dp.new_zeros((S, P, 3))], dim=-1)
    return res.transpose(1, 2), applied, hits


def composite_pair_sel_plain(spay_pad, dpay, ids, counts_s_pad, counts_d,
                             ts: int, tx: int,
                             sigma_cutoff: Optional[float] = None,
                             term_eps: Optional[float] = None,
                             return_work: bool = False):
    """Plain PyTorch version of K2, vectorised over slots and pixels (in
    blocks of ``SLOT_BLOCK`` slots) with a loop over static chunks.

    Returns out (B, T+1, 8, P), written only at the rows ``ids`` name (the
    others are uninitialised), and with ``return_work`` the work these
    inputs need per slot: applied static chunks (B, TT) and (pixel, entry)
    pairs with alpha > 0, the ones composited (B, TT)."""
    B, TT = ids.shape
    T1, _, Ks = spay_pad.shape
    Kd = dpay.shape[-1]
    P = ts * ts
    pmin = power_min_of(sigma_cutoff)
    flat_ids = ids.reshape(-1).long()
    flat_cd = counts_d.reshape(-1)
    dflat = dpay.reshape(B * TT, 10, Kd)
    res = dpay.new_empty((B * TT, 8, P))
    applied = torch.zeros(B * TT, dtype=torch.long, device=dpay.device)
    hits = torch.zeros_like(applied)
    for s0 in range(0, B * TT, SLOT_BLOCK):
        sl = slice(s0, min(s0 + SLOT_BLOCK, B * TT))
        res[sl], applied[sl], hits[sl] = _plain_slots(
            spay_pad, dflat[sl], flat_ids[sl], counts_s_pad, flat_cd[sl], ts,
            tx, pmin, term_eps)
    out = dpay.new_empty((B, T1, 8, P))
    bidx = torch.arange(B, device=dpay.device).repeat_interleave(TT)
    out[bidx, flat_ids] = res        # pad slots all write the same trash row
    if return_work:
        return out, applied.reshape(B, TT), hits.reshape(B, TT)
    return out


def _check_inputs(spay_pad, dpay, ids, counts_s_pad, counts_d, ts):
    if spay_pad.dim() == 4:
        raise NotImplementedError(
            "per-env (B, T+1, 10, Ks) static payloads (the moving-camera "
            "mode) are not ported; pass the shared (T+1, 10, Ks) payload")
    if spay_pad.dtype != torch.float32 or spay_pad.dim() != 3 \
            or spay_pad.shape[1] != 10:
        raise ValueError("spay_pad must be float32 (T+1, 10, Ks), got "
                         f"{spay_pad.dtype} {tuple(spay_pad.shape)}")
    T1, _, Ks = spay_pad.shape
    if ids.dtype != torch.int32 or ids.dim() != 2:
        raise ValueError(f"ids must be int32 (B, TT), got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    B, TT = ids.shape
    if dpay.dtype != torch.float32 or tuple(dpay.shape[:3]) != (B, TT, 10) \
            or dpay.dim() != 4:
        raise ValueError(f"dpay must be float32 ({B}, {TT}, 10, Kd), got "
                         f"{dpay.dtype} {tuple(dpay.shape)}")
    Kd = dpay.shape[-1]
    if Ks % CHUNK or Kd % CHUNK:
        raise ValueError(f"capacities Ks={Ks}, Kd={Kd} must be multiples "
                         f"of {CHUNK}")
    if Kd > 1024:
        raise ValueError(f"dyn capacity Kd={Kd} > 1024 does not fit the "
                         "kernel's shared memory")
    if counts_s_pad.dtype != torch.int32 or tuple(counts_s_pad.shape) != (T1,):
        raise ValueError(f"counts_s_pad must be int32 ({T1},)")
    if counts_d.dtype != torch.int32 or tuple(counts_d.shape) != (B, TT):
        raise ValueError(f"counts_d must be int32 ({B}, {TT})")
    for a in (dpay, ids, counts_s_pad, counts_d):
        if a.device != spay_pad.device:
            raise ValueError("all inputs must be on one device")
    if not (ts * ts <= 1024):
        raise ValueError(f"tile size {ts}: one thread per pixel needs "
                         "ts² ≤ 1024")


    if spay_pad.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {spay_pad.device}")


def composite_pair_sel_bwd_plain(spay_pad, dpay, ids, counts_s_pad, counts_d,
                                 ct, ts: int, tx: int,
                                 sigma_cutoff: Optional[float] = None,
                                 term_eps: Optional[float] = None):
    """Plain PyTorch version of K2's gradient: (grad of ``spay_pad``
    (T+1, 10, Ks) summed per tile, grad of ``dpay`` (B, TT, 10, Kd)) for the
    cotangent ``ct`` (B, T+1, 8, P) of ``out``, by autograd through
    :func:`composite_pair_sel_plain` recomputed here.  Only the selected
    rows of ``ct`` are read; pads read the trash row.  It shares no algebra
    with the kernel's merged walk, so it is an independent check."""
    with torch.enable_grad():
        leaves = (spay_pad.detach().requires_grad_(),
                  dpay.detach().requires_grad_())
        out = composite_pair_sel_plain(*leaves, ids, counts_s_pad, counts_d,
                                       ts, tx, sigma_cutoff, term_eps)
        bidx = torch.arange(ids.shape[0], device=ids.device)[:, None]
        rows = ids.long()
        # the unselected rows of `out` are unwritten: read the selected ones
        grads = torch.autograd.grad(out[bidx, rows], leaves, ct[bidx, rows],
                                    allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, (spay_pad, dpay)))


# ctypes signatures of the launch functions: pointers, then
# B, TT, T+1, Ks, Kd, ts, tx, power_min, has_pmin, term_eps, has_term, stream
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = [_I] * 7 + [_F, _I, _F, _I, _VP]
_FWD_ARGS = [_VP] * 6 + _TAIL
_BWD_ARGS = [_VP] * 9 + _TAIL


def _forward(spay_pad, dpay, ids, counts_s_pad, counts_d, ts, tx,
             sigma_cutoff, term_eps):
    """K2f on CUDA tensors, the plain version on CPU tensors."""
    global launches
    if spay_pad.device.type == "cpu":
        return composite_pair_sel_plain(spay_pad, dpay, ids, counts_s_pad,
                                        counts_d, ts, tx, sigma_cutoff,
                                        term_eps)
    spay_pad, dpay, ids, counts_s_pad, counts_d = (
        a.contiguous() for a in (spay_pad, dpay, ids, counts_s_pad, counts_d))
    T1, _, Ks = spay_pad.shape
    B, TT = ids.shape
    Kd = dpay.shape[-1]
    out = dpay.new_empty((B, T1, 8, ts * ts))
    pmin = power_min_of(sigma_cutoff)
    launch = _kernels.function("composite_sel", "composite_pair_sel_launch",
                               _FWD_ARGS)
    with torch.cuda.device(spay_pad.device):
        stream = torch.cuda.current_stream(spay_pad.device).cuda_stream
        rc = launch(
            spay_pad.data_ptr(), dpay.data_ptr(), ids.data_ptr(),
            counts_s_pad.data_ptr(), counts_d.data_ptr(), out.data_ptr(),
            B, TT, T1, Ks, Kd, ts, tx,
            0.0 if pmin is None else pmin, int(pmin is not None),
            0.0 if term_eps is None else term_eps, int(term_eps is not None),
            stream)
    _kernels.check(rc, "composite_pair_sel")
    launches += 1
    return out


def bwd_smem_bytes(Kd: int, ts: int) -> int:
    """Shared memory of one K2b block: the dynamic list (10, Kd), one static
    chunk (10, 128) and every warp's per-entry partial sums for both."""
    warps = ts * ts // 32
    return 4 * 10 * (Kd + CHUNK) * (1 + warps)


def composite_pair_sel_bwd_slots(spay_pad, dpay, ids, counts_s_pad,
                                 counts_d, ct, out, ts: int, tx: int,
                                 sigma_cutoff: Optional[float] = None,
                                 term_eps: Optional[float] = None):
    """K2b on CUDA tensors: per-slot gradients (gs (B, TT, 10, Ks) of the
    static list each slot composited, gd (B, TT, 10, Kd) of its dynamic
    list) for the cotangent ``ct`` (B, T+1, 8, P), given the forward's
    ``out``.  The kernel replays the forward's merged walk, so it needs no
    other saved state.  Pad slots get zeros."""
    global launches_bwd
    _check_inputs(spay_pad, dpay, ids, counts_s_pad, counts_d, ts)
    T1, _, Ks = spay_pad.shape
    B, TT = ids.shape
    Kd = dpay.shape[-1]
    P = ts * ts
    for name, a in (("ct", ct), ("out", out)):
        if a.dtype != torch.float32 or tuple(a.shape) != (B, T1, 8, P) \
                or a.device != spay_pad.device:
            raise ValueError(f"{name} must be float32 ({B}, {T1}, 8, {P}) on "
                             f"{spay_pad.device}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    if spay_pad.device.type != "cuda":
        raise ValueError("the K2b kernel takes CUDA tensors; on the CPU use "
                         "composite_pair_sel_bwd_plain")
    if P % 32:
        raise ValueError(f"tile size {ts}: the backward kernel reduces over "
                         "whole warps and needs ts² % 32 == 0")
    if bwd_smem_bytes(Kd, ts) > SMEM_OPTIN_BYTES:
        raise ValueError(f"dyn capacity Kd={Kd} at tile size {ts} needs "
                         f"{bwd_smem_bytes(Kd, ts)} B of shared memory per "
                         f"block, more than {SMEM_OPTIN_BYTES}")
    spay_pad, dpay, ids, counts_s_pad, counts_d, ct, out = (
        a.contiguous() for a in (spay_pad, dpay, ids, counts_s_pad, counts_d,
                                 ct, out))
    gs = dpay.new_empty((B, TT, 10, Ks))
    gd = torch.empty_like(dpay)
    pmin = power_min_of(sigma_cutoff)
    launch = _kernels.function("composite_sel_bwd",
                               "composite_pair_sel_bwd_launch", _BWD_ARGS)
    with torch.cuda.device(spay_pad.device):
        stream = torch.cuda.current_stream(spay_pad.device).cuda_stream
        rc = launch(
            spay_pad.data_ptr(), dpay.data_ptr(), ids.data_ptr(),
            counts_s_pad.data_ptr(), counts_d.data_ptr(), ct.data_ptr(),
            out.data_ptr(), gs.data_ptr(), gd.data_ptr(),
            B, TT, T1, Ks, Kd, ts, tx,
            0.0 if pmin is None else pmin, int(pmin is not None),
            0.0 if term_eps is None else term_eps, int(term_eps is not None),
            stream)
    _kernels.check(rc, "composite_pair_sel_bwd")
    launches_bwd += 1
    return gs, gd


def composite_pair_sel_bwd(spay_pad, dpay, ids, counts_s_pad, counts_d, ct,
                           out, ts: int, tx: int,
                           sigma_cutoff: Optional[float] = None,
                           term_eps: Optional[float] = None):
    """K2 backward → (grad of ``spay_pad`` (T+1, 10, Ks), summed per tile
    with the pads' zeros in the trash row, grad of ``dpay``).  CPU tensors
    run the plain version; CUDA tensors launch K2b and sum its per-slot
    static gradients into their tiles with ``index_add_``."""
    if spay_pad.device.type == "cpu":
        _check_inputs(spay_pad, dpay, ids, counts_s_pad, counts_d, ts)
        return composite_pair_sel_bwd_plain(spay_pad, dpay, ids, counts_s_pad,
                                            counts_d, ct, ts, tx,
                                            sigma_cutoff, term_eps)
    gs, gd = composite_pair_sel_bwd_slots(spay_pad, dpay, ids, counts_s_pad,
                                          counts_d, ct, out, ts, tx,
                                          sigma_cutoff, term_eps)
    T1, R, Ks = spay_pad.shape
    g_spay = spay_pad.new_zeros((T1, R * Ks)).index_add_(
        0, ids.reshape(-1).long(), gs.reshape(-1, R * Ks))
    return g_spay.reshape(T1, R, Ks), gd


class CompositePairSel(torch.autograd.Function):
    """K2 with its gradient: forward K2f → out (B, T+1, 8, P), backward K2b
    → the gradients of the shared static payload and the dynamic lists."""

    @staticmethod
    def forward(ctx, spay_pad, dpay, ids, counts_s_pad, counts_d, ts, tx,
                sigma_cutoff, term_eps):
        out = _forward(spay_pad, dpay, ids, counts_s_pad, counts_d, ts, tx,
                       sigma_cutoff, term_eps)
        ctx.save_for_backward(spay_pad, dpay, ids, counts_s_pad, counts_d,
                              out)
        ctx.args = (ts, tx, sigma_cutoff, term_eps)
        return out

    @staticmethod
    def backward(ctx, ct):
        spay_pad, dpay, ids, counts_s_pad, counts_d, out = ctx.saved_tensors
        g_spay, g_dpay = composite_pair_sel_bwd(
            spay_pad, dpay, ids, counts_s_pad, counts_d, ct, out, *ctx.args)
        return g_spay, g_dpay, None, None, None, None, None, None, None


def composite_pair_sel(spay_pad: torch.Tensor, dpay: torch.Tensor,
                       ids: torch.Tensor, counts_s_pad: torch.Tensor,
                       counts_d: torch.Tensor, ts: int, tx: int,
                       sigma_cutoff: Optional[float] = None,
                       term_eps: Optional[float] = None) -> torch.Tensor:
    """K2 → out (B, T+1, 8, P) channel-major [r, g, b, depth_acc, trans,
    0, 0, 0], written only at selected rows (pads: the trash row T),
    differentiable in ``spay_pad`` and ``dpay``.  Rows no slot selects are
    left unwritten: the caller must where-select against the static
    composite before reading (their cotangent is then zero)."""
    _check_inputs(spay_pad, dpay, ids, counts_s_pad, counts_d, ts)
    return CompositePairSel.apply(spay_pad, dpay, ids, counts_s_pad, counts_d,
                                  ts, tx, sigma_cutoff, term_eps)
