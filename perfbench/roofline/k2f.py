"""K2f, the selected-tile composite of the static lists and each env's
dynamic lists (``composite_pair_sel``): its work.

Reads each tile's static entries once (as many as its most-applied slot
needs), every slot's dynamic entries, the ids and counts, and writes the 8
output channels of every written row (the selected tiles and each env's
trash row)."""

import torch

from perfbench.roofline import walk
from perfbench.roofline.peaks import ALPHA_FLOPS, BLEND_FLOPS

CAPTURE = "sim_a_splat_torch.ops.composite_sel:composite_pair_sel"
KERNELS = ("composite_pair_sel_fwd",)


def counts_of(args):
    """(entries composited, α > 0 pairs, bytes read of the lists, rows
    written, P) of one call's arguments (spay, dpay, ids, counts_s,
    counts_d, ts, tx, sigma_cutoff, term_eps), the static payload shared."""
    spay, dpay, ids, cs, cd, ts, tx, sigma, term_eps = args[:9]
    applied, hits = walk.sel_work(spay, dpay, ids, cs, cd, ts, tx, sigma,
                                  term_eps)
    Ks, Kd = spay.shape[-1], dpay.shape[-1]
    T1 = spay.shape[0]
    s_entries = walk.static_entries(torch.clamp(cs[ids.long()].long(),
                                                max=Ks), applied, Ks)
    d_entries = torch.clamp(cd.long(), max=Kd)
    tile_need = torch.zeros(T1, dtype=torch.long, device=ids.device)
    tile_need = tile_need.scatter_reduce(0, ids.long().reshape(-1),
                                         s_entries.reshape(-1), "amax")
    real = ids.long() < T1 - 1
    rows = int(real.sum()) + int((~real).any(dim=1).sum())
    entries = int(s_entries.sum() + d_entries.sum())
    list_bytes = (int(tile_need.sum()) * 40 + int(d_entries.sum()) * 40
                  + ids.numel() * 8 + T1 * 4)
    return entries, int(hits.sum()), list_bytes, rows, ts * ts


def work(args):
    entries, hits, list_bytes, rows, P = counts_of(args)
    return (ALPHA_FLOPS * P * entries + BLEND_FLOPS * hits,
            list_bytes + rows * 8 * P * 4)
