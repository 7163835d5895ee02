"""K3f, the moving camera's composite (``composite_sel_single``): its work.

Each slot composites the list its id names, K1's walk over 128-entry
chunks with the early stop (``walk``): reads each applied entry's 10
payload rows once and each slot's id and count, and writes the 8 output
channels of its row."""

import torch

from perfbench.roofline import walk
from perfbench.roofline.peaks import ALPHA_FLOPS, BLEND_FLOPS

CAPTURE = "sim_a_splat_torch.ops.composite_single:composite_sel_single"
KERNELS = ("composite_single_fwd",)


def work(args):
    """(FLOP, bytes) of one call with arguments ``args`` (payload (B, T+1,
    10, K) per env or (T+1, 10, K) shared, ids (B, TT), counts, ts, tx,
    sigma_cutoff, term_eps)."""
    spay, ids, counts, ts, tx, sigma, term_eps = args[:7]
    rows = ids.long()
    if spay.dim() == 3:
        pay, cnt = spay[rows], counts[rows]
    else:
        b = torch.arange(ids.shape[0], device=ids.device)[:, None]
        pay, cnt = spay[b, rows], counts[b, rows]
    K = spay.shape[-1]
    pay = pay.reshape(-1, 10, K)
    cnt = cnt.reshape(-1).long()
    tid = rows.reshape(-1)
    applied = torch.zeros_like(cnt)
    hits = torch.zeros_like(cnt)
    for s0 in range(0, cnt.numel(), walk.BLOCK):
        sl = slice(s0, s0 + walk.BLOCK)
        applied[sl], hits[sl] = walk._static_block(
            pay[sl], cnt[sl], tid[sl], ts, tx, sigma, term_eps)
    P = ts * ts
    entries = int(walk.static_entries(cnt, applied, K).sum())
    nbytes = entries * 40 + ids.numel() * 8 + ids.numel() * 8 * P * 4
    return ALPHA_FLOPS * P * entries + BLEND_FLOPS * int(hits.sum()), nbytes
