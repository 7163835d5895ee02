"""K2b, the gradient of the selected-tile composite: its work, counted from
the forward call's arguments.

Reads what K2f reads plus five channels each of the cotangent and the
output at every written row, and writes the per-tile static gradient and
each slot's dynamic gradient once."""

from perfbench.roofline import k2f
from perfbench.roofline.peaks import ALPHA_FLOPS, GRAD_FLOPS

CAPTURE = k2f.CAPTURE
KERNELS = ("composite_pair_sel_bwd",)


def work(args):
    spay, dpay, ids = args[:3]
    entries, hits, list_bytes, rows, P = k2f.counts_of(args)
    T1, Ks, Kd = spay.shape[0], spay.shape[-1], dpay.shape[-1]
    nbytes = (list_bytes + rows * 2 * 5 * P * 4 + T1 * 10 * Ks * 4
              + ids.numel() * 10 * Kd * 4)
    return ALPHA_FLOPS * P * entries + GRAD_FLOPS * hits, nbytes
