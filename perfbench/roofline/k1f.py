"""K1f, the static lists' composite (``composite_static``): its work.

Reads each applied entry's 10 payload rows once, the counts and the skip
mask, and writes each pixel's 8 output channels and one carry a chunk."""

from perfbench.roofline import walk
from perfbench.roofline.peaks import ALPHA_FLOPS, BLEND_FLOPS

CAPTURE = "sim_a_splat_torch.ops.composite:composite_static"
KERNELS = ("composite_static_chunks", "composite_static_combine")


def work(args):
    """(FLOP, bytes) of one call with arguments ``args`` (payload, counts,
    skip, ts, tx, sigma_cutoff, term_eps)."""
    pay, counts, skip, ts, tx, sigma, term_eps = args[:7]
    applied, hits = walk.static_work(pay, counts, skip, ts, tx, sigma,
                                     term_eps)
    K = pay.shape[-1]
    nc = K // walk.CHUNK
    T = counts.numel()
    P = ts * ts
    cnt = (skip > 0) * counts
    entries = int(walk.static_entries(cnt, applied, K).sum())
    nbytes = entries * 40 + T * 8 + T * P * (8 + nc) * 4
    return ALPHA_FLOPS * P * entries + BLEND_FLOPS * int(hits.sum()), nbytes
