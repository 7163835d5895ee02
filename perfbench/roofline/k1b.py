"""K1b, the gradient of the static lists' composite: its work, counted
from the forward call's arguments.

Reads the applied entries, the counts and skip mask, five channels each of
the cotangent and the output and the carries, and writes every gradient
column once."""

from perfbench.roofline import walk
from perfbench.roofline.peaks import ALPHA_FLOPS, GRAD_FLOPS

CAPTURE = "sim_a_splat_torch.ops.composite:composite_static"
KERNELS = ("composite_static_bwd",)


def work(args):
    pay, counts, skip, ts, tx, sigma, term_eps = args[:7]
    applied, hits = walk.static_work(pay, counts, skip, ts, tx, sigma,
                                     term_eps)
    K = pay.shape[-1]
    nc = K // walk.CHUNK
    T = counts.numel()
    P = ts * ts
    cnt = (skip > 0) * counts
    entries = int(walk.static_entries(cnt, applied, K).sum())
    nbytes = entries * 40 + T * 8 + T * P * (2 * 5 + nc) * 4 + T * 10 * K * 4
    return ALPHA_FLOPS * P * entries + GRAD_FLOPS * int(hits.sum()), nbytes
