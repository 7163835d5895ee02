"""The work a composite's inputs need, counted from the inputs alone.

A frozen copy of the counting arithmetic of the port's plain composites
(K1's and K2's, with the chunk-granular early stop), so that the count is
the same whatever implements the kernel and whatever a later change does to
the program.  It returns, per list, the 128-entry chunks of the static list
that are applied before every pixel's transmittance falls under
``term_eps``, and the (pixel, entry) pairs with α > 0 among the entries
composited: the static entries of the applied chunks and, for K2, every
entry of the dynamic list.

Payload rows: [x, y, conic a b c, r, g, b, depth, opacity].
"""

from __future__ import annotations

import torch

CHUNK = 128
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
BLOCK = 512          # lists counted at a time


def pixel_centers(tile_ids, ts: int, tx: int):
    p = torch.arange(ts * ts, device=tile_ids.device)
    t = tile_ids.long()[:, None]
    px = ((p % ts).float() + 0.5) + ((t % tx) * ts).float()
    py = ((p // ts).float() + 0.5) + ((t // tx) * ts).float()
    return px, py


def alpha(rows, px, py, sigma_cutoff):
    """α of payload columns ``rows`` (S, 10, C) at pixels (S, P) →
    (S, P, C)."""
    gx, gy = rows[:, None, 0, :], rows[:, None, 1, :]
    ca, cb, cc = rows[:, None, 2, :], rows[:, None, 3, :], rows[:, None, 4, :]
    dx, dy = px[..., None] - gx, py[..., None] - gy
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    a = torch.clamp(rows[:, None, 9, :] * torch.exp(torch.clamp(power, max=0.0)),
                    max=ALPHA_MAX)
    keep = a >= ALPHA_MIN
    if sigma_cutoff is not None:
        keep &= power >= -0.5 * sigma_cutoff ** 2
    return torch.where(keep, a, torch.zeros_like(a))


def _static_block(pay, count, tid, ts, tx, sigma_cutoff, term_eps):
    S, _, K = pay.shape
    px, py = pixel_centers(tid, ts, tx)
    tc = pay.new_ones((S, ts * ts))
    alive = torch.ones(S, dtype=torch.bool, device=pay.device)
    applied = torch.zeros(S, dtype=torch.long, device=pay.device)
    hits = torch.zeros_like(applied)
    lane = torch.arange(CHUNK, device=pay.device)
    for c0 in range(0, K, CHUNK):
        act = alive & (c0 < count)
        if not bool(act.any()):
            break
        a = alpha(pay[:, :, c0:c0 + CHUNK], px, py, sigma_cutoff)
        in_list = (c0 + lane)[None, :] < count[:, None]
        a = torch.where(in_list[:, None, :], a, torch.zeros_like(a))
        tc_new = tc * torch.prod(1.0 - a, dim=-1)
        tc = torch.where(act[:, None], tc_new, tc)
        applied += act.long()
        hits += (a > 0).sum(dim=(1, 2)) * act
        if term_eps is not None:
            alive = torch.where(act, tc_new.amax(dim=-1) >= term_eps, alive)
    return applied, hits


def static_work(payload, counts, skip, ts: int, tx: int, sigma_cutoff,
                term_eps):
    """K1's work: payload (T, 10, K) or (B, T, 10, K), counts and skip
    (T,) or (B, T) → (applied chunks, α > 0 pairs), each (·, T)."""
    lead = payload.shape[:-2]
    T, K = payload.shape[-3], payload.shape[-1]
    pay = payload.reshape(-1, 10, K)
    count = torch.where(skip > 0, counts, torch.zeros_like(counts)).reshape(-1)
    tid = torch.arange(T, device=pay.device).repeat(pay.shape[0] // T)
    applied = torch.zeros(pay.shape[0], dtype=torch.long, device=pay.device)
    hits = torch.zeros_like(applied)
    for s0 in range(0, pay.shape[0], BLOCK):
        sl = slice(s0, s0 + BLOCK)
        applied[sl], hits[sl] = _static_block(
            pay[sl], count[sl].long(), tid[sl], ts, tx, sigma_cutoff, term_eps)
    return applied.reshape(lead), hits.reshape(lead)


def _sel_block(sp, cs, dp, tid, cd, ts, tx, sigma_cutoff, term_eps):
    S, _, Kd = dp.shape
    Ks = sp.shape[-1]
    dev = dp.device
    count_s = torch.clamp(cs.long(), max=Ks)
    count_d = torch.clamp(cd.long(), max=Kd)
    px, py = pixel_centers(tid, ts, tx)
    ad = alpha(dp, px, py, sigma_cutoff)
    d_in = torch.arange(Kd, device=dev)[None, :] < count_d[:, None]
    ad = torch.where(d_in[:, None, :], ad, torch.zeros_like(ad))
    ld = torch.log1p(-ad)
    dd = dp[:, 8, :]
    tsv = dp.new_ones((S, ts * ts))
    alive = torch.ones(S, dtype=torch.bool, device=dev)
    applied = torch.zeros(S, dtype=torch.long, device=dev)
    hits = (ad > 0).sum(dim=(1, 2))
    lane = torch.arange(CHUNK, device=dev)
    for c0 in range(0, Ks, CHUNK):
        act = alive & (c0 < count_s)
        if not bool(act.any()):
            break
        rows = sp[:, :, c0:c0 + CHUNK]
        in_list = (c0 + lane)[None, :] < count_s[:, None]
        a = alpha(rows, px, py, sigma_cutoff)
        a = torch.where(in_list[:, None, :], a, torch.zeros_like(a))
        ts_new = tsv * torch.exp(torch.log1p(-a).sum(dim=-1))
        tsv = torch.where(act[:, None], ts_new, tsv)
        applied += act.long()
        hits += (a > 0).sum(dim=(1, 2)) * act
        if term_eps is not None:
            ds = rows[:, 8, :]
            dbound = torch.where(in_list, ds, torch.full_like(
                ds, float("-inf"))).amax(dim=-1)
            in_front = dd[:, None, :] < dbound[:, None, None]
            td_b = torch.exp(torch.where(in_front, ld,
                                         torch.zeros_like(ld)).sum(dim=-1))
            alive = torch.where(act, (ts_new * td_b).amax(dim=-1) >= term_eps,
                                alive)
    return applied, hits


def sel_work(spay, dpay, ids, counts_s, counts_d, ts: int, tx: int,
             sigma_cutoff, term_eps):
    """K2's work: the static lists spay (T+1, 10, Ks) with counts (T+1,),
    each slot's dynamic list dpay (B, TT, 10, Kd) with counts (B, TT), the
    slots' tiles ids (B, TT) → (applied static chunks, α > 0 pairs), each
    (B, TT)."""
    B, TT = ids.shape
    Kd = dpay.shape[-1]
    flat_ids = ids.reshape(-1).long()
    dflat = dpay.reshape(B * TT, 10, Kd)
    cdf = counts_d.reshape(-1)
    applied = torch.zeros(B * TT, dtype=torch.long, device=dpay.device)
    hits = torch.zeros_like(applied)
    for s0 in range(0, B * TT, BLOCK):
        sl = slice(s0, min(s0 + BLOCK, B * TT))
        applied[sl], hits[sl] = _sel_block(
            spay[flat_ids[sl]], counts_s[flat_ids[sl]], dflat[sl],
            flat_ids[sl], cdf[sl], ts, tx, sigma_cutoff, term_eps)
    return applied.reshape(B, TT), hits.reshape(B, TT)


def static_entries(counts, applied, K: int):
    """Static entries in the applied chunks of each list."""
    c0 = torch.arange(K // CHUNK, device=counts.device) * CHUNK
    per_chunk = torch.clamp(counts.long()[..., None] - c0, 0, CHUNK)
    used = torch.arange(len(c0), device=counts.device) < applied[..., None]
    return (per_chunk * used).sum(-1)
