"""Kernel K4: merge-free composite of the shared static tile lists
interleaved by depth with each env's dynamic lists, over every tile, and
its gradient.

Replaces the TPU kernels ``_fwd_kernel`` (``_call_fwd``) and ``_bwd_kernel``
(``_call_bwd``) under the custom VJP ``composite_pallas_pair`` of
``sim_a_splat_tpu/ops/pallas_composite_pair.py``.  The reference runs that
kernel once per env under the per-env step's ``vmap``; here the env axis is
explicit and one launch covers every env.  The CUDA sources are
``csrc/composite_pair.cu`` (K4f) and ``csrc/composite_pair_bwd.cu`` (K4b).
A touched (env, tile) pair is the problem K2 solves on a selected slot, so
they run K2's block bodies (``csrc/composite_sel_walk.cuh``: the warp-level
cull, two pixels a thread, the dynamic list staged in windows, the merged
walk), and take what K2 takes on the card: every ``Kd % 128 == 0`` and
tile sizes 1 to 32 (``composite_sel.kernel_threads``, ``window``).  Their
notes say what bounds each on an H100.

``composite_pair`` is the public entry: it goes through the autograd
Function ``CompositePair``, whose forward is K4f and whose backward is K4b.
The static lists are shared by every env, so their gradient is summed over
the envs (in the kernel, per tile).  CPU tensors run the plain versions
(``composite_pair_plain``, ``composite_pair_bwd_plain``); CUDA tensors
launch the kernels, through the operators ``sim_a_splat::composite_pair``
and ``composite_pair_bwd`` (``ops/_kernels.py``), or raise.

The plain forward follows the reference's algebra: log-space
transmittances, the depth-indicator contractions ``logtd`` and ``ltsd``,
and the chunk-granular stop on ts·Td(< dbound).  Per (env, tile) pair that
is K2's arithmetic (``composite_sel.plain_slots``), evaluated only at the
pairs with ``skip`` > 0.  It shares no walk with the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from sim_a_splat_torch.ops import _kernels, composite_sel
from sim_a_splat_torch.ops.composite import CHUNK, power_min_of
from sim_a_splat_torch.utils.profiling import span

# the output row of a pair with skip == 0: rgb 0, depth_acc 0, trans 1
_EMPTY = (0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0)


def composite_pair_plain(spay, dpay, counts_s, counts_d, skip, ts: int,
                         tx: int, sigma_cutoff: Optional[float] = None,
                         term_eps: Optional[float] = None,
                         return_work: bool = False):
    """Plain PyTorch version of K4, vectorised over the (env, tile) pairs
    with ``skip`` > 0 (in blocks of ``composite_sel.SLOT_BLOCK``) and their
    pixels, with a loop over static chunks.

    Returns out (B, T, P, 8) and, with ``return_work``, the work these
    inputs need per pair: applied static chunks (B, T) and (pixel, entry)
    pairs with alpha > 0, the ones composited (B, T)."""
    B, T = skip.shape
    Kd = dpay.shape[-1]
    P = ts * ts
    pmin = power_min_of(sigma_cutoff)
    touched = torch.nonzero(skip.reshape(-1) > 0).squeeze(1)
    dflat = dpay.reshape(B * T, 10, Kd)
    cd = counts_d.reshape(-1)
    out = dpay.new_tensor(_EMPTY).expand(B * T, P, 8).clone()
    applied = torch.zeros(B * T, dtype=torch.long, device=dpay.device)
    hits = torch.zeros_like(applied)
    for s0 in range(0, touched.numel(), composite_sel.SLOT_BLOCK):
        idx = touched[s0:s0 + composite_sel.SLOT_BLOCK]
        res, applied[idx], hits[idx] = composite_sel.plain_slots(
            spay[idx % T], counts_s[idx % T], dflat[idx], idx % T, cd[idx],
            ts, tx, pmin, term_eps)
        out[idx] = res.transpose(1, 2)
    out = out.reshape(B, T, P, 8)
    if return_work:
        return out, applied.reshape(B, T), hits.reshape(B, T)
    return out


def composite_pair_bwd_plain(spay, dpay, counts_s, counts_d, skip, ct,
                             ts: int, tx: int,
                             sigma_cutoff: Optional[float] = None,
                             term_eps: Optional[float] = None):
    """Plain PyTorch version of K4's gradient: (grad of ``spay`` (T, 10, Ks)
    summed over the envs, grad of ``dpay`` (B, T, 10, Kd)) for the cotangent
    ``ct`` (B, T, P, 8) of ``out``, by autograd through
    :func:`composite_pair_plain` recomputed here.  It shares no algebra with
    the kernel's merged walk, so it is an independent check."""
    with torch.enable_grad():
        leaves = (spay.detach().requires_grad_(),
                  dpay.detach().requires_grad_())
        out = composite_pair_plain(*leaves, counts_s, counts_d, skip, ts, tx,
                                   sigma_cutoff, term_eps)
        grads = ((None, None) if not out.requires_grad else
                 torch.autograd.grad(out, leaves, ct, allow_unused=True))
    return tuple(torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, (spay, dpay)))


def _check_inputs(spay, dpay, counts_s, counts_d, skip):
    if spay.dtype != torch.float32 or spay.dim() != 3 or spay.shape[1] != 10:
        raise ValueError("spay must be float32 (T, 10, Ks), got "
                         f"{spay.dtype} {tuple(spay.shape)}")
    T, _, Ks = spay.shape
    if dpay.dtype != torch.float32 or dpay.dim() != 4 \
            or tuple(dpay.shape[1:3]) != (T, 10):
        raise ValueError(f"dpay must be float32 (B, {T}, 10, Kd), got "
                         f"{dpay.dtype} {tuple(dpay.shape)}")
    B, Kd = dpay.shape[0], dpay.shape[-1]
    if Ks % CHUNK or Kd % CHUNK:
        raise ValueError(f"capacities Ks={Ks}, Kd={Kd} must be multiples "
                         f"of {CHUNK}")
    for name, a, shape in (("counts_s", counts_s, (T,)),
                           ("counts_d", counts_d, (B, T)),
                           ("skip", skip, (B, T))):
        if a.dtype != torch.int32 or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got {a.dtype} "
                             f"{tuple(a.shape)}")
        if a.device != spay.device:
            raise ValueError(f"{name} is on {a.device}, spay on "
                             f"{spay.device}")
    if dpay.device != spay.device:
        raise ValueError(f"dpay is on {dpay.device}, spay on {spay.device}")
    if spay.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {spay.device}")


# ctypes signatures of the launch functions: pointers, then
# B, T, Ks, Kd, ts, tx, power_min, has_pmin, term_eps, has_term, stream
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = [_I] * 6 + [_F, _I, _F, _I, _VP]
_FWD_ARGS = [_VP] * 6 + _TAIL
_BWD_ARGS = [_VP] * 9 + _TAIL


def _scalars(spay, dpay, ts, tx, sigma_cutoff, term_eps):
    T, _, Ks = spay.shape
    pmin = power_min_of(sigma_cutoff)
    return (dpay.shape[0], T, Ks, dpay.shape[-1], ts, tx,
            0.0 if pmin is None else pmin, int(pmin is not None),
            0.0 if term_eps is None else term_eps, int(term_eps is not None))


@span("render.k4f")
def _forward(spay, dpay, counts_s, counts_d, skip, ts, tx, sigma_cutoff,
             term_eps):
    """K4f on CUDA tensors, the plain version on CPU tensors."""
    if spay.device.type == "cpu":
        return composite_pair_plain(spay, dpay, counts_s, counts_d, skip, ts,
                                    tx, sigma_cutoff, term_eps)
    composite_sel.kernel_threads(ts)
    return torch.ops.sim_a_splat.composite_pair(
        *(a.contiguous() for a in (spay, dpay, counts_s, counts_d, skip)), ts,
        tx, sigma_cutoff, term_eps)


@_kernels.operator(
    "composite_pair(Tensor spay, Tensor dpay, Tensor counts_s, Tensor "
    "counts_d, Tensor skip, int ts, int tx, float? sigma_cutoff, "
    "float? term_eps) -> Tensor")
def _launch_fwd(spay, dpay, counts_s, counts_d, skip, ts, tx, sigma_cutoff,
                term_eps):
    B, T = skip.shape
    out = dpay.new_empty((B, T, ts * ts, 8))
    _kernels.launch(
        "composite_pair", "composite_pair", _FWD_ARGS, spay.device,
        *(a.data_ptr() for a in (spay, dpay, counts_s, counts_d, skip, out)),
        *_scalars(spay, dpay, ts, tx, sigma_cutoff, term_eps))
    return out


@span("render.k4b")
def composite_pair_bwd(spay, dpay, counts_s, counts_d, skip, ct, out,
                       ts: int, tx: int, sigma_cutoff: Optional[float] = None,
                       term_eps: Optional[float] = None):
    """K4 backward → (grad of ``spay`` (T, 10, Ks) summed over the envs,
    grad of ``dpay`` (B, T, 10, Kd)) for the cotangent ``ct`` (B, T, P, 8)
    of the forward's ``out``.  CPU tensors run the plain version; CUDA
    tensors launch K4b, which replays the forward's walk (so it needs no
    state beyond ``out``) and sums the static gradient per tile."""
    _check_inputs(spay, dpay, counts_s, counts_d, skip)
    B, T = skip.shape
    P = ts * ts
    for name, a in (("ct", ct), ("out", out)):
        if a.dtype != torch.float32 or tuple(a.shape) != (B, T, P, 8) \
                or a.device != spay.device:
            raise ValueError(f"{name} must be float32 ({B}, {T}, {P}, 8) on "
                             f"{spay.device}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    if spay.device.type == "cpu":
        return composite_pair_bwd_plain(spay, dpay, counts_s, counts_d, skip,
                                        ct, ts, tx, sigma_cutoff, term_eps)
    composite_sel.kernel_threads(ts)
    return torch.ops.sim_a_splat.composite_pair_bwd(
        *(a.contiguous() for a in (spay, dpay, counts_s, counts_d, skip, ct,
                                   out)), ts, tx, sigma_cutoff, term_eps)


@_kernels.operator(
    "composite_pair_bwd(Tensor spay, Tensor dpay, Tensor counts_s, Tensor "
    "counts_d, Tensor skip, Tensor ct, Tensor out, int ts, int tx, "
    "float? sigma_cutoff, float? term_eps) -> (Tensor, Tensor)")
def _launch_bwd(spay, dpay, counts_s, counts_d, skip, ct, out, ts, tx,
                sigma_cutoff, term_eps):
    gs = torch.zeros_like(spay)           # K4b adds every env's sums into it
    gd = torch.empty_like(dpay)
    _kernels.launch(
        "composite_pair_bwd", "composite_pair_bwd", _BWD_ARGS, spay.device,
        *(a.data_ptr() for a in (spay, dpay, counts_s, counts_d, skip, ct,
                                 out, gs, gd)),
        *_scalars(spay, dpay, ts, tx, sigma_cutoff, term_eps))
    return gs, gd


class CompositePair(torch.autograd.Function):
    """K4 with its gradient: forward K4f → out (B, T, P, 8), backward K4b →
    the gradients of the shared static payload and the dynamic lists."""

    @staticmethod
    def forward(ctx, spay, dpay, counts_s, counts_d, skip, ts, tx,
                sigma_cutoff, term_eps):
        out = _forward(spay, dpay, counts_s, counts_d, skip, ts, tx,
                       sigma_cutoff, term_eps)
        ctx.save_for_backward(spay, dpay, counts_s, counts_d, skip, out)
        ctx.args = (ts, tx, sigma_cutoff, term_eps)
        return out

    @staticmethod
    def backward(ctx, ct):
        spay, dpay, counts_s, counts_d, skip, out = ctx.saved_tensors
        g_spay, g_dpay = composite_pair_bwd(spay, dpay, counts_s, counts_d,
                                            skip, ct, out, *ctx.args)
        return g_spay, g_dpay, None, None, None, None, None, None, None


def composite_pair(spay: torch.Tensor, dpay: torch.Tensor,
                   counts_s: torch.Tensor, counts_d: torch.Tensor,
                   skip: torch.Tensor, ts: int, tx: int,
                   sigma_cutoff: Optional[float] = None,
                   term_eps: Optional[float] = None) -> torch.Tensor:
    """K4: the shared static lists spay (T, 10, Ks) with counts_s (T,), each
    env's dynamic lists dpay (B, T, 10, Kd) with counts_d (B, T), and
    skip (B, T) int32 → out (B, T, P, 8) [r, g, b, depth_acc, trans, 0, 0,
    0], the two lists of every pair composited in one depth order (static
    first on equal depth).  Pairs with skip == 0 emit rgb 0 / trans 1 and do
    no work: only valid where the caller takes the static composite there.
    Both lists are depth-sorted, active entries first, inactive entries at
    opacity 0; counts past a capacity are clamped to it.  Differentiable in
    ``spay`` (summed over the envs) and ``dpay``."""
    _check_inputs(spay, dpay, counts_s, counts_d, skip)
    return CompositePair.apply(spay, dpay, counts_s, counts_d, skip, ts, tx,
                               sigma_cutoff, term_eps)
