"""Kernel K2: selected-tile composite of the static tile lists interleaved
by depth with each env's dynamic lists, and its gradient.

Replaces the TPU kernels ``_fwd_kernel`` (``_call_fwd``) and ``_bwd_kernel``
(``_call_bwd``) under the custom VJP ``composite_pair_sel`` of
``sim_a_splat_tpu/ops/pallas_composite_sel.py``, in both its modes: one
static payload (T+1, 10, Ks) shared by the envs, or one per env
(B, T+1, 10, Ks) with counts (B, T+1).  The CUDA sources are
``csrc/composite_sel.cu`` (K2f) and
``csrc/composite_sel_bwd.cu`` (K2b), with their walk and block bodies in
``csrc/composite_sel_walk.cuh`` (shared with K4, ``composite_pair``); their
notes say what bounds each on an H100 (instruction issue, not bytes) and
what the design does about it: a warp-level footprint cull, two pixels per
thread in a compact 8 × 8 rectangle per warp, entry-major staging with the
dynamic list in windows and the merge positions found once per chunk, and
in K2b the forward walk replayed (no saved state), a transposed warp
reduction and the per-tile sum of the static gradient done in the kernel
with atomic adds.  The kernels take every dynamic capacity the reference
takes (``Kd % 128 == 0``: the window, ``window``, is the largest that fits
in a block's shared memory) and tile sizes 1 to 32 (``kernel_threads``).

``composite_pair_sel`` is the public entry: it goes through the autograd
Function ``CompositePairSel``, whose forward is K2f and whose backward is
K2b.  CPU tensors run the plain versions (``composite_pair_sel_plain``,
``composite_pair_sel_bwd_plain``); CUDA tensors launch the kernels,
through the operators ``sim_a_splat::composite_pair_sel`` and
``composite_pair_sel_bwd`` (``ops/_kernels.py``), or raise.  In the per-env
mode a block reads its env's static list (one stride an env in the
kernels), and slot i's static gradient lands at row ``ids[b, i]`` of env b:
with the dense ids ``ids[b] = arange(T)`` that the reference requires there
this is the reference's gradient; with other ids it is the true gradient,
where the reference places it by slot position.  ``cull_boxes``,
``warp_rects`` and ``culled`` are the plain twin of the kernels' cull test,
and ``walk_schedule`` of their window schedule, for the tests and the chip
run's counts.

The plain forward follows the reference's algebra (log-space
transmittances and depth-indicator contractions, chunk-granular early stop
on ts·Td(< dbound)); the kernels walk the merged sequence.  The two agree
to float32 rounding on lists that obey the contract (depth-sorted, active
entries first, inactive entries at opacity 0).
"""

from __future__ import annotations

import bisect
import ctypes
from typing import Optional

import torch

from sim_a_splat_torch.ops import _kernels
from sim_a_splat_torch.ops.composite import (
    CHUNK, _ROW_DEPTH, _ROW_RGBD, entry_alpha, pixel_centers, power_min_of,
)
from sim_a_splat_torch.ops.rasterize_reference import ALPHA_MIN
from sim_a_splat_torch.utils.profiling import span

# shared memory a block may opt into on Hopper (H100/H200: 227 KB)
SMEM_OPTIN_BYTES = 232_448

SLOT_BLOCK = 512  # slots per vectorised step of the plain version


def plain_slots(sp, cs, dp, tid, cd, ts, tx, pmin, term_eps):
    """Plain interleaved composite of S (static list, dynamic list) slots
    of tiles ``tid`` (S,), K2's and K4's arithmetic per slot: static list
    sp (S, 10, Ks) of cs (S,) entries, dynamic list dp (S, 10, Kd) of cd
    (S,) entries → ((S, 8, P) rows, applied static chunks (S,), composited
    (pixel, entry) pairs (S,))."""
    S, _, Kd = dp.shape
    Ks = sp.shape[-1]
    P = ts * ts
    dev = dp.device
    count_s = torch.clamp(cs.long(), max=Ks)
    count_d = torch.clamp(cd.long(), max=Kd)
    px, py = pixel_centers(tid, ts, tx)

    ad = entry_alpha(dp, px, py, pmin)                         # (S, P, Kd)
    d_in = torch.arange(Kd, device=dev)[None, :] < count_d[:, None]
    ad = torch.where(d_in[:, None, :], ad, torch.zeros_like(ad))
    ld = torch.log1p(-ad)
    dd = dp[:, _ROW_DEPTH, :]                                  # (S, Kd)
    sum_ld = ld.sum(dim=-1, keepdim=True)                      # (S, P, 1)

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
    blocks of ``SLOT_BLOCK`` slots) with a loop over static chunks.  The
    static payload is shared (T+1, 10, Ks) with counts (T+1,), or per env
    (B, T+1, 10, Ks) with counts (B, T+1).

    Returns out (B, T+1, 8, P), written only at the rows ``ids`` name (the
    others are uninitialised), and with ``return_work`` the work these
    inputs need per slot: applied static chunks (B, TT) and (pixel, entry)
    pairs with alpha > 0, the ones composited (B, TT)."""
    B, TT = ids.shape
    T1 = spay_pad.shape[-3]
    Kd = dpay.shape[-1]
    P = ts * ts
    pmin = power_min_of(sigma_cutoff)
    flat_ids = ids.reshape(-1).long()
    bidx = torch.arange(B, device=dpay.device).repeat_interleave(TT)
    # each slot's row of the static lists, in a (·, 10, Ks) view of them
    srow = flat_ids + bidx * T1 if spay_pad.dim() == 4 else flat_ids
    sflat = spay_pad.reshape(-1, 10, spay_pad.shape[-1])
    cflat = counts_s_pad.reshape(-1)
    flat_cd = counts_d.reshape(-1)
    dflat = dpay.reshape(B * TT, 10, Kd)
    res = dpay.new_empty((B * TT, 8, P))
    applied = torch.zeros(B * TT, dtype=torch.long, device=dpay.device)
    hits = torch.zeros_like(applied)
    for s0 in range(0, B * TT, SLOT_BLOCK):
        sl = slice(s0, min(s0 + SLOT_BLOCK, B * TT))
        res[sl], applied[sl], hits[sl] = plain_slots(
            sflat[srow[sl]], cflat[srow[sl]], dflat[sl], flat_ids[sl],
            flat_cd[sl], ts, tx, pmin, term_eps)
    out = dpay.new_empty((B, T1, 8, P))
    out[bidx, flat_ids] = res        # pad slots all write the same trash row
    if return_work:
        return out, applied.reshape(B, TT), hits.reshape(B, TT)
    return out


def _check_inputs(spay_pad, dpay, ids, counts_s_pad, counts_d):
    if spay_pad.dtype != torch.float32 or spay_pad.dim() not in (3, 4) \
            or spay_pad.shape[-2] != 10:
        raise ValueError("spay_pad must be float32 (T+1, 10, Ks) shared or "
                         "(B, T+1, 10, Ks) per env, got "
                         f"{spay_pad.dtype} {tuple(spay_pad.shape)}")
    if spay_pad.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {spay_pad.device}")
    shared = spay_pad.dim() == 3
    T1, _, Ks = spay_pad.shape[-3:]
    if ids.dtype != torch.int32 or ids.dim() != 2 \
            or (not shared and ids.shape[0] != spay_pad.shape[0]):
        want = "(B, TT)" if shared else f"({spay_pad.shape[0]}, TT)"
        raise ValueError(f"ids must be int32 {want}, got {ids.dtype} "
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
    shape = (T1,) if shared else (B, T1)
    if counts_s_pad.dtype != torch.int32 \
            or tuple(counts_s_pad.shape) != shape:
        raise ValueError(f"counts_s_pad must be int32 {shape}, got "
                         f"{counts_s_pad.dtype} "
                         f"{tuple(counts_s_pad.shape)}")
    if counts_d.dtype != torch.int32 or tuple(counts_d.shape) != (B, TT):
        raise ValueError(f"counts_d must be int32 ({B}, {TT})")
    for a in (dpay, ids, counts_s_pad, counts_d):
        if a.device != spay_pad.device:
            raise ValueError("all inputs must be on one device")


# ---- the kernels' block layout (csrc/composite_sel_walk.cuh) ----------------

RECT_X = RECT_Y = 8   # a warp's pixel rectangle in the K2 and K4 blocks
                      # (sel::RECT_X, RECT_Y), two pixels a thread


def kernel_threads(ts: int) -> int:
    """Threads per block of K2f, K2b, K4f and K4b for tile size ``ts``
    (``sel::block_threads``): ceil(ts / 8)² warps, each owning an 8 × 8
    rectangle of the tile, two pixels a thread; the pixels past a tile that
    is not a multiple of 8 are masked.  A block holds one tile of at most
    1,024 pixels (512 threads, the launch bounds that leave each thread 128
    registers), so the kernels take 1 ≤ ts ≤ 32, a limit of the card port:
    the reference takes any tile size."""
    if not 1 <= ts <= 32:
        raise ValueError(f"tile size {ts}: the K2 and K4 kernels hold one "
                         "tile per block and take 1 ≤ ts ≤ 32")
    return (-(-ts // RECT_X)) * (-(-ts // RECT_Y)) * 32


def _block_bytes(W: int, warps: int, bwd: bool) -> int:
    """``sel::smem_bytes``: W + 128 staged entries of 56 B (the dynamic
    window and one static chunk), the chunk's merge positions, each warp's
    hit words and, for a backward block, each warp's per-entry partial sums
    (10 rows) of every staged column."""
    L = W + CHUNK
    return (56 * L + 4 * CHUNK + 4 * warps * (W // 32 + CHUNK // 32)
            + (4 * warps * 10 * L if bwd else 0))


def window(Kd: int, ts: int, bwd: bool) -> int:
    """The dynamic window of a K2f / K4f (``bwd`` False) or K2b / K4b block
    at capacity Kd (``sel::window``): the largest multiple of 128, at most
    Kd, whose block fits in a block's shared memory.  The walk stages the
    dynamic list that many entries at a time, so every capacity runs; the
    main path's Kd = 128 is one window."""
    warps = kernel_threads(ts) // 32
    W = Kd
    while W > CHUNK and _block_bytes(W, warps, bwd) > SMEM_OPTIN_BYTES:
        W -= CHUNK
    return W


def smem_bytes(Kd: int, ts: int, bwd: bool) -> int:
    """Shared memory of one K2f / K4f (``bwd`` False) or K2b / K4b block at
    capacity Kd, with its window (``sel::Layout``)."""
    return _block_bytes(window(Kd, ts, bwd), kernel_threads(ts) // 32, bwd)


def blocks_per_sm(bwd: bool, Kd: int, ts: int) -> int:
    """Blocks of K2f (``bwd`` False) or K2b that fit on one SM of the
    current card at (Kd, ts) (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    in the launch library)."""
    kernel_threads(ts)
    name = "composite_sel_bwd" if bwd else "composite_sel"
    fn = _kernels.function(
        name, f"composite_pair_sel{'_bwd' if bwd else ''}_blocks_per_sm",
        [_I, _I, ctypes.POINTER(ctypes.c_int)])
    n = ctypes.c_int(0)
    _kernels.check(fn(Kd, ts, ctypes.byref(n)), f"{name} occupancy")
    return n.value


def walk_schedule(ds, dd, W: int, chunks: Optional[int] = None):
    """Plain twin of the kernels' walk order (``sel::merged_walk``) for one
    block: the sorted static depths ``ds`` and dynamic depths ``dd`` of its
    active entries, the window ``W`` (a multiple of 32) and the static chunks
    the walk applies (default all; the early stop cuts them) → (visits,
    windows): each entry a warp that culls nothing visits, in order, as
    ("s" or "d", index, start of the window staged then), and the window
    starts in the order they are staged.  The kernel's sub-runs, slides and
    stop points, step by step."""
    ds, dd = [float(v) for v in ds], [float(v) for v in dd]
    count_s, count_d = len(ds), len(dd)
    n_chunks = -(-count_s // CHUNK) if chunks is None else chunks
    visits, windows = [], [0]
    w0 = jd = 0

    def until(lim):                        # dynamic_until
        nonlocal jd
        if lim > w0 + W:
            raise AssertionError(f"dynamic entry {lim - 1} past the window "
                                 f"[{w0}, {w0 + W})")
        visits.extend(("d", j, w0) for j in range(jd, min(lim, count_d)))
        jd = max(jd, lim)

    def slide():                           # retire the window, stage the next
        nonlocal w0
        until(w0 + W)
        w0 += W
        windows.append(w0)

    for c0 in range(0, n_chunks * CHUNK, CHUNK):
        n = min(CHUNK, count_s - c0)
        merge = [bisect.bisect_left(dd, ds[c0 + e]) for e in range(n)]
        e0 = 0
        while True:
            e1 = next((e for e in range(e0, n) if merge[e] > w0 + W), n)
            for e in range(e0, e1):
                until(merge[e])
                visits.append(("s", c0 + e, w0))
            if e1 == n:
                break
            slide()
            e0 = e1
        until(merge[n - 1])
    while count_d > w0 + W:
        slide()
    until(count_d)
    return visits, windows


# ---- plain twin of the kernels' warp-level cull (used by tests) -------------

_ALPHA_MIN32 = float(torch.tensor(ALPHA_MIN, dtype=torch.float32))


def _round_to_float(v: torch.Tensor, down: bool) -> torch.Tensor:
    """float64 → float32 rounded towards -inf (``down``) or +inf."""
    f = v.float()
    off = f.double() > v if down else f.double() < v
    return torch.where(off, torch.nextafter(
        f, torch.full_like(f, float("-inf") if down else float("inf"))), f)


def cull_boxes(rows: torch.Tensor, sigma_cutoff: Optional[float] = None):
    """The kernels' cull box of each entry (``sel::cull_box``): payload
    (..., 10, K) float32 → (..., 4, K) float32 [xlo, xhi, ylo, yhi], outside
    which no pixel centre gets alpha > 0 (``entry_alpha``); (-inf, inf, ...)
    where the entry is never culled, an empty box where it always is.  The
    kernel's order: non-finite values, a conic that is not positive definite
    or too ill-conditioned for the margin → never culled; else op <
    ALPHA_MIN → always culled; else the box."""
    x, y, a, b, c, op = (rows[..., r, :] for r in (0, 1, 2, 3, 4, 9))
    A, B, C = a.double(), b.double(), c.double()
    det = A * C - B * B
    lmax = 0.5 * (A + C) + torch.sqrt(0.25 * (A - C) ** 2 + B * B)
    eps = 32.0 * 2.0 ** -24 * (lmax * lmax / det + 1.0)
    q = 2.0 * (torch.log(op.double() / _ALPHA_MIN32) + 1e-4)
    pmin = power_min_of(sigma_cutoff)
    if pmin is not None:
        pmin32 = float(torch.tensor(pmin, dtype=torch.float32))
        q = torch.clamp(q, max=-2.0 * pmin32)
    q = torch.clamp(q, min=0.0) / (1.0 - eps)
    hx = torch.sqrt(q * C / det) * (1.0 + 1e-6) + 2.0 ** -10
    hy = torch.sqrt(q * A / det) * (1.0 + 1e-6) + 2.0 ** -10
    box = torch.stack([_round_to_float(x.double() - hx, True),
                       _round_to_float(x.double() + hx, False),
                       _round_to_float(y.double() - hy, True),
                       _round_to_float(y.double() + hy, False)], dim=-2)
    inf = float("inf")
    finite = torch.stack([torch.isfinite(v) for v in (x, y, a, b, c, op)]
                         ).all(dim=0)
    keep_all = ~finite | ~(A > 0) | ~(det > 0) | ~(eps < 0.5)
    never = finite & (op < _ALPHA_MIN32)
    box = torch.where(never[..., None, :],
                      box.new_tensor([inf, -inf, inf, -inf])[:, None], box)
    return torch.where(keep_all[..., None, :],
                       box.new_tensor([-inf, inf, -inf, inf])[:, None], box)


def warp_rects(tile_ids: torch.Tensor, ts: int, tx: int) -> torch.Tensor:
    """(S,) tile ids → (S, W, 4) float32 [rx0, rx1, ry0, ry1], the pixel
    centres spanned by each of the W warps of a K2 or K4 block
    (``sel::Pixels``): 8 × 8 rectangles in row-major order, cut to the
    tile."""
    w = torch.arange(kernel_threads(ts) // 32, device=tile_ids.device)
    wgx = -(-ts // RECT_X)
    wx = (w % wgx) * RECT_X
    wy = (w // wgx) * RECT_Y
    x1 = torch.clamp(wx + RECT_X, max=ts) - 1
    y1 = torch.clamp(wy + RECT_Y, max=ts) - 1
    t = tile_ids.long()[:, None]
    ox, oy = ((t % tx) * ts).float(), ((t // tx) * ts).float()
    return torch.stack([(wx.float() + 0.5) + ox, (x1.float() + 0.5) + ox,
                        (wy.float() + 0.5) + oy,
                        (y1.float() + 0.5) + oy], dim=-1)


def culled(boxes: torch.Tensor, rects: torch.Tensor) -> torch.Tensor:
    """(S, 4, K) boxes and (S, W, 4) rectangles → (S, W, K) bool: the warp's
    rectangle of pixel centres misses the entry's box (``sel::culled``)."""
    bx = boxes[:, None]                          # (S, 1, 4, K)
    r = rects[..., None]                         # (S, W, 4, 1)
    return (bx[:, :, 1] < r[:, :, 0]) | (bx[:, :, 0] > r[:, :, 1]) \
        | (bx[:, :, 3] < r[:, :, 2]) | (bx[:, :, 2] > r[:, :, 3])


def composite_pair_sel_bwd_plain(spay_pad, dpay, ids, counts_s_pad, counts_d,
                                 ct, ts: int, tx: int,
                                 sigma_cutoff: Optional[float] = None,
                                 term_eps: Optional[float] = None):
    """Plain PyTorch version of K2's gradient: (grad of ``spay_pad`` in its
    shape, summed per tile when shared and per (env, tile) when per env,
    grad of ``dpay`` (B, TT, 10, Kd)) for the cotangent ``ct``
    (B, T+1, 8, P) of ``out``, by autograd through
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


# ctypes signatures of the launch functions: pointers, then B, TT, T+1, Ks,
# Kd, ts, tx, power_min, has_pmin, term_eps, has_term, per_env, stream
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = [_I] * 7 + [_F, _I, _F, _I, _I, _VP]
_FWD_ARGS = [_VP] * 6 + _TAIL
_BWD_ARGS = [_VP] * 9 + _TAIL


def _scalars(spay_pad, dpay, ids, ts, tx, sigma_cutoff, term_eps):
    pmin = power_min_of(sigma_cutoff)
    return (ids.shape[0], ids.shape[1], spay_pad.shape[-3],
            spay_pad.shape[-1], dpay.shape[-1], ts, tx,
            0.0 if pmin is None else pmin, int(pmin is not None),
            0.0 if term_eps is None else term_eps, int(term_eps is not None),
            int(spay_pad.dim() == 4))


@span("render.k2f")
def _forward(spay_pad, dpay, ids, counts_s_pad, counts_d, ts, tx,
             sigma_cutoff, term_eps):
    """K2f on CUDA tensors, the plain version on CPU tensors."""
    if spay_pad.device.type == "cpu":
        return composite_pair_sel_plain(spay_pad, dpay, ids, counts_s_pad,
                                        counts_d, ts, tx, sigma_cutoff,
                                        term_eps)
    kernel_threads(ts)
    return torch.ops.sim_a_splat.composite_pair_sel(
        *(a.contiguous() for a in (spay_pad, dpay, ids, counts_s_pad,
                                   counts_d)), ts, tx, sigma_cutoff, term_eps)


@_kernels.operator(
    "composite_pair_sel(Tensor spay_pad, Tensor dpay, Tensor ids, "
    "Tensor counts_s_pad, Tensor counts_d, int ts, int tx, "
    "float? sigma_cutoff, float? term_eps) -> Tensor")
def _launch_fwd(spay_pad, dpay, ids, counts_s_pad, counts_d, ts, tx,
                sigma_cutoff, term_eps):
    out = dpay.new_empty((ids.shape[0], spay_pad.shape[-3], 8, ts * ts))
    _kernels.launch(
        "composite_sel", "composite_pair_sel", _FWD_ARGS, spay_pad.device,
        *(a.data_ptr() for a in (spay_pad, dpay, ids, counts_s_pad, counts_d,
                                 out)),
        *_scalars(spay_pad, dpay, ids, ts, tx, sigma_cutoff, term_eps))
    return out


def composite_pair_sel_bwd_tiles(spay_pad, dpay, ids, counts_s_pad,
                                 counts_d, ct, out, ts: int, tx: int,
                                 sigma_cutoff: Optional[float] = None,
                                 term_eps: Optional[float] = None):
    """K2b on CUDA tensors → (gs, ``spay_pad``'s shape, the static gradient
    summed in the kernel (atomic adds) per tile, or per env and tile row in
    the per-env mode; the trash row T stays zero,
    gd (B, TT, 10, Kd), each slot's dynamic gradient, zero past its count)
    for the cotangent ``ct`` (B, T+1, 8, P), given the forward's ``out``.
    The kernel replays the forward's merged walk, so it needs no other
    saved state."""
    _check_inputs(spay_pad, dpay, ids, counts_s_pad, counts_d)
    B, TT = ids.shape
    shape = (B, spay_pad.shape[-3], 8, ts * ts)
    for name, a in (("ct", ct), ("out", out)):
        if a.dtype != torch.float32 or tuple(a.shape) != shape \
                or a.device != spay_pad.device:
            raise ValueError(f"{name} must be float32 {shape} on "
                             f"{spay_pad.device}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    if spay_pad.device.type != "cuda":
        raise ValueError("the K2b kernel takes CUDA tensors; on the CPU use "
                         "composite_pair_sel_bwd_plain")
    kernel_threads(ts)
    return torch.ops.sim_a_splat.composite_pair_sel_bwd(
        *(a.contiguous() for a in (spay_pad, dpay, ids, counts_s_pad,
                                   counts_d, ct, out)), ts, tx, sigma_cutoff,
        term_eps)


@_kernels.operator(
    "composite_pair_sel_bwd(Tensor spay_pad, Tensor dpay, Tensor ids, "
    "Tensor counts_s_pad, Tensor counts_d, Tensor ct, Tensor out, int ts, "
    "int tx, float? sigma_cutoff, float? term_eps) -> (Tensor, Tensor)")
def _launch_bwd(spay_pad, dpay, ids, counts_s_pad, counts_d, ct, out, ts,
                tx, sigma_cutoff, term_eps):
    gs = torch.zeros_like(spay_pad)        # K2b adds every slot's sums to it
    gd = torch.empty_like(dpay)
    _kernels.launch(
        "composite_sel_bwd", "composite_pair_sel_bwd", _BWD_ARGS,
        spay_pad.device,
        *(a.data_ptr() for a in (spay_pad, dpay, ids, counts_s_pad, counts_d,
                                 ct, out, gs, gd)),
        *_scalars(spay_pad, dpay, ids, ts, tx, sigma_cutoff, term_eps))
    return gs, gd


@span("render.k2b")
def composite_pair_sel_bwd(spay_pad, dpay, ids, counts_s_pad, counts_d, ct,
                           out, ts: int, tx: int,
                           sigma_cutoff: Optional[float] = None,
                           term_eps: Optional[float] = None):
    """K2 backward → (grad of ``spay_pad``, its shape: summed per tile, or
    per env and tile row, the trash row zero; grad of ``dpay``).  CPU
    tensors run the plain version; CUDA tensors launch K2b, which sums per
    tile itself."""
    if spay_pad.device.type == "cpu":
        _check_inputs(spay_pad, dpay, ids, counts_s_pad, counts_d)
        return composite_pair_sel_bwd_plain(spay_pad, dpay, ids, counts_s_pad,
                                            counts_d, ct, ts, tx,
                                            sigma_cutoff, term_eps)
    return composite_pair_sel_bwd_tiles(spay_pad, dpay, ids, counts_s_pad,
                                        counts_d, ct, out, ts, tx,
                                        sigma_cutoff, term_eps)


class CompositePairSel(torch.autograd.Function):
    """K2 with its gradient: forward K2f → out (B, T+1, 8, P), backward K2b
    → the gradients of the static payload (shared or per env) and the
    dynamic lists."""

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
    differentiable in ``spay_pad`` and ``dpay``.  ``spay_pad`` is shared
    (T+1, 10, Ks) with ``counts_s_pad`` (T+1,), or per env (B, T+1, 10, Ks)
    with (B, T+1); ``ids`` obey one contract in both modes: pad slots after
    the real ones, carrying T.  Rows no slot selects are
    left unwritten: the caller must where-select against the static
    composite before reading (their cotangent is then zero)."""
    _check_inputs(spay_pad, dpay, ids, counts_s_pad, counts_d)
    return CompositePairSel.apply(spay_pad, dpay, ids, counts_s_pad, counts_d,
                                  ts, tx, sigma_cutoff, term_eps)
