"""The dynamic-list window schedule of the K2 and K4 kernels, through its
plain twin (``composite_sel.walk_schedule``), and the windows themselves
(``composite_sel.window``), on the CPU.

The kernels stage a dynamic list of any capacity W entries at a time and
cut a static chunk into sub-runs at window edges.  That may change no
output bit: each warp must still visit every entry once, in the merged
depth order of ``merge_sorted_lists`` (static first on equal depth), and
no dynamic entry may be visited outside the window staged at the time.
These tests hold the twin to that on random sorted lists with ties
(hypothesis), on lists where one static chunk needs several windows, with
early stops after a chunk, and at dynamic capacities up to 16,384.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sim_a_splat_torch.ops import composite_sel as cs
from sim_a_splat_torch.ops.composite import CHUNK
from sim_a_splat_torch.ops.rasterize_cached import merge_sorted_lists


def merged_ids(ds, dd):
    """The merged order of merge_sorted_lists as ("s" | "d", index) pairs:
    row 5 of each payload carries its entries' ids."""
    def payload(depths, sign):
        K = max(CHUNK, -(-len(depths) // CHUNK) * CHUNK)
        pay = np.zeros((10, K), np.float32)
        pay[8, :len(depths)] = depths
        pay[8, len(depths):] = 1e9
        pay[9, :len(depths)] = 0.5
        pay[5, :len(depths)] = sign * (np.arange(len(depths)) + 1)
        return torch.as_tensor(pay)
    merged, counts = merge_sorted_lists(
        payload(ds, 1.0)[None], torch.tensor([len(ds)], dtype=torch.int32),
        payload(dd, -1.0)[None, None],
        torch.tensor([[len(dd)]], dtype=torch.int32))
    ids = merged[0, 0, 5, :int(counts[0, 0])].long().tolist()
    return [("s", i - 1) if i > 0 else ("d", -i - 1) for i in ids]


def check_schedule(ds, dd, W, chunks=None):
    """walk_schedule visits every entry of the applied chunks and every
    dynamic entry once, in the merged order, each dynamic entry inside the
    window staged then, and stages each window once, in order."""
    visits, windows = cs.walk_schedule(ds, dd, W, chunks)
    n_s = len(ds) if chunks is None else min(len(ds), chunks * CHUNK)
    assert [(k, i) for k, i, _ in visits] == merged_ids(ds[:n_s], dd)
    for kind, i, w0 in visits:
        if kind == "d":
            assert w0 <= i < w0 + W
    assert windows == list(range(0, windows[-1] + 1, W))
    assert windows[-1] <= max(len(dd) - 1, 0)
    return visits, windows


def sorted_depths(rng, n, lo, hi, step):
    """n sorted depths in [lo, hi] on a grid of ``step`` (ties)."""
    return np.sort(np.round(rng.uniform(lo, hi, n) / step) * step).astype(
        np.float32)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       n_s=st.integers(0, 700),
       n_d=st.integers(0, 3000),
       W=st.sampled_from([128, 256, 1024]),
       step=st.sampled_from([0.25, 0.01, 1e-4]))
def test_schedule_visits_the_merged_order(seed, n_s, n_d, W, step):
    rng = np.random.default_rng(seed)
    ds = sorted_depths(rng, n_s, 1.0, 5.0, step)
    dd = sorted_depths(rng, n_d, 1.0, 5.0, step)
    check_schedule(ds, dd, W)


@pytest.mark.parametrize("W", [128, 256, 1024])
@pytest.mark.parametrize("Kd", [1152, 4096, 16384])
def test_schedule_chunk_spanning_several_windows(W, Kd):
    """Dynamic lists of up to 16,384 entries that fall between two static
    entries of one chunk: that chunk's sub-runs cross every window of the
    list; with stops after chunk 0 and 1 the rest of the dynamic list is
    still walked, window by window."""
    rng = np.random.default_rng(Kd + W)
    ds = np.concatenate([sorted_depths(rng, 40, 1.0, 2.0, 0.25),
                         sorted_depths(rng, 300, 3.0, 5.0, 0.25)])
    dd = np.concatenate([sorted_depths(rng, Kd - 200, 2.1, 2.9, 1e-3),
                         sorted_depths(rng, 200, 3.0, 5.0, 0.25)])
    visits, windows = check_schedule(ds, dd, W)
    assert len(windows) == -(-Kd // W)
    # the dynamic entries between static entries 39 and 40 are visited in
    # one gap of chunk 0, across windows
    pos = [v[:2] for v in visits].index(("s", 40))
    assert all(k == "d" for k, _, _ in visits[pos - (Kd - 200):pos])
    for chunks in (1, 2):
        _, win = check_schedule(ds, dd, W, chunks)
        assert win == windows


def test_schedule_edge_cases():
    rng = np.random.default_rng(0)
    dd = sorted_depths(rng, 1000, 1.0, 5.0, 0.25)
    ds = sorted_depths(rng, 256, 1.0, 5.0, 0.25)
    assert check_schedule(ds, [], 128)[1] == [0]             # no dynamic
    assert check_schedule([], dd, 128)[1] == list(range(0, 1000, 128))
    assert check_schedule(ds, dd[:128], 128)[1] == [0]       # one window
    # every dynamic entry in front of every static one, and behind
    check_schedule(ds + 10.0, dd, 256)
    check_schedule(ds - 10.0, dd, 256)
    # a stop after chunk 0: chunk 1's static entries are never visited
    visits, _ = check_schedule(ds, dd, 128, chunks=1)
    assert max(i for k, i, _ in visits if k == "s") == CHUNK - 1


@pytest.mark.parametrize("ts", [1, 8, 12, 16, 20, 24, 28, 32])
@pytest.mark.parametrize("bwd", [False, True])
def test_window_fits_every_capacity(ts, bwd):
    """Every dynamic capacity has a window: a multiple of 128, at most Kd,
    the largest whose block fits in a block's shared memory."""
    for Kd in [0, 128, 256, 896, 1024, 2048, 3968, 4096, 8192, 16384]:
        W = cs.window(Kd, ts, bwd)
        assert W % CHUNK == 0 and W <= Kd and (W > 0 or Kd == 0)
        assert cs.smem_bytes(Kd, ts, bwd) <= cs.SMEM_OPTIN_BYTES
        if W < Kd:
            warps = cs.kernel_threads(ts) // 32
            assert cs._block_bytes(W + CHUNK, warps, bwd) \
                > cs.SMEM_OPTIN_BYTES
