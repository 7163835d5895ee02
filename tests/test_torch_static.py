"""The design of kernels K1f and K1b, through plain PyTorch twins, on the
CPU.

K1f composites every chunk of a tile list from transmittance 1 in a block of
its own and then combines the chunks in order (acc ← acc + tc · acc_l,
tc ← tc · T_l, the early stop after each applied chunk); K1b restarts every
applied chunk from the transmittance and accumulators the forward saved at
the chunk's start.  ``chunked_fwd`` and ``chunked_bwd`` below do the same
steps, vectorised over tiles and pixels, and are held to the port's plain
versions and to the reference's Pallas kernels (interpret mode):

- forward: out and carries atol 2e-5 against ``composite_static_plain`` and
  ``pallas_composite._call_fwd`` (float32 products and sums formed in
  another order: each chunk from 1, then scaled);
- backward: each payload row within 1e-4 × its largest gradient against
  the plain backward run in float64 (``test_torch_grad.py``'s bound for
  K1; measured ≤ 4.3e-5), and within 2e-4 against ``jax.vjp`` of
  ``composite_pallas``: on the nearly opaque tiles of these inputs the
  reference's own float32 suffix sums (s_tot − prefix) are off by up to
  1.4e-4 of a row's scale against float64 at ts 8 (the cancellation
  ``test_torch_grad.py`` describes);
  and the cancellation rule the kernel relies on: the restarted prefix
  equals the saved accumulator of the next chunk and, at the last applied
  chunk, ``out``, bit for bit.

The inputs (``k1_case_inputs``) hold one edge case a tile: every chunk
applied, a count cut mid-chunk, count 0, a count past the capacity, a stop
after chunk 0, skip 0 and a stop after chunk 1, at tile sizes 8, 16 and 32.
The K1 blocks' pixel layout and their warp-level cull (K2's cull boxes
against K1's warp rectangles) are checked here too, and the dynamic
capacities the card path now takes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import (
    K_TX, as_float64, assert_rows_close, k1_case_inputs, k4_inputs, np_of,
    tile_lists,
)

from sim_a_splat_tpu.ops import pallas_composite as jk1

from sim_a_splat_torch.ops import composite, composite_pair
from sim_a_splat_torch.ops import composite_sel as cs
from sim_a_splat_torch.ops.composite import (
    CHUNK, entry_alpha, pixel_centers, power_min_of,
)
from sim_a_splat_torch.ops.rasterize_reference import ALPHA_CLAMP, ALPHA_MIN

SETTINGS = [(3.0, 1e-4), (None, None)]
TILE_SIZES = [8, 16, 32]


def geometry(rows, px, py, power_min):
    """alpha, active (kept and unclamped), exp(min(power, 0)), dx, dy of the
    entries ``rows`` (T, 10, C) at the pixels (T, P), each (T, P, C), term
    by term as ``entry_alpha``."""
    x, y, ca, cb, cc, op = (rows[:, None, r, :] for r in (0, 1, 2, 3, 4, 9))
    dx = px[..., None] - x
    dy = py[..., None] - y
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    expp = torch.exp(torch.clamp(power, max=0.0))
    raw = op * expp
    alpha = torch.clamp(raw, max=ALPHA_CLAMP)
    keep = alpha >= ALPHA_MIN
    if power_min is not None:
        keep &= power >= power_min
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    return alpha, keep & (raw < ALPHA_CLAMP), expp, dx, dy


def chunk_alphas(pay, count, c, px, py, pmin):
    c0 = c * CHUNK
    rows = pay[:, :, c0:c0 + CHUNK]
    geo = geometry(rows, px, py, pmin)
    in_list = (c0 + torch.arange(CHUNK))[None, :] < count[:, None]
    alpha = torch.where(in_list[:, None, :], geo[0], torch.zeros_like(geo[0]))
    return rows, (alpha, *geo[1:])


def chunked_fwd(pay, counts, skip, ts, tx, sigma_cutoff, term_eps):
    """Twin of K1f: every chunk before the count composited from T = 1,
    entry by entry (a chunk block's walk), then the in-order combine →
    (out (T, P, 8), carries (T, P, nc), chunk_acc (T, nc, 4, P)) and the
    chunks applied (T,)."""
    T, _, K = pay.shape
    P, nc = ts * ts, K // CHUNK
    pmin = power_min_of(sigma_cutoff)
    px, py = pixel_centers(torch.arange(T), ts, tx)
    count = torch.where(skip > 0, counts, torch.zeros_like(counts)).long()
    local_acc = pay.new_zeros((T, nc, P, 4))
    local_t = pay.new_ones((T, nc, P))
    for c in range(nc):
        rows, (alpha, *_) = chunk_alphas(pay, count, c, px, py, pmin)
        acc = pay.new_zeros((T, P, 4))
        tl = pay.new_ones((T, P))
        for e in range(CHUNK):
            a = alpha[..., e]
            w = a * tl
            acc = acc + w[..., None] * rows[:, None, 5:9, e]
            tl = torch.where(a > 0, tl * (1 - a), tl)
        local_acc[:, c], local_t[:, c] = acc, tl
    acc = pay.new_zeros((T, P, 4))
    tc = pay.new_ones((T, P))
    alive = torch.ones(T, dtype=torch.bool)
    applied = torch.zeros(T, dtype=torch.long)
    carries = pay.new_empty((T, P, nc))
    chunk_acc = pay.new_empty((T, nc, 4, P))
    for c in range(nc):
        carries[:, :, c] = tc
        chunk_acc[:, c] = acc.transpose(1, 2)
        act = alive & (c * CHUNK < count)
        acc_new = acc + tc[..., None] * local_acc[:, c]
        tc_new = tc * local_t[:, c]
        acc = torch.where(act[:, None, None], acc_new, acc)
        tc = torch.where(act[:, None], tc_new, tc)
        applied += act.long()
        if term_eps is not None:
            alive = torch.where(act, tc_new.amax(dim=-1) >= term_eps, alive)
    out = torch.cat([acc, tc[..., None], pay.new_zeros((T, P, 3))], dim=-1)
    return out, carries, chunk_acc, applied


def chunked_bwd(pay, counts, skip, ct, out, carries, chunk_acc, ts, tx,
                sigma_cutoff, term_eps):
    """Twin of K1b: each chunk the forward applied (decided from carries)
    restarted from its saved carries and chunk_acc, the chunk's local sums
    kept with the forward's own steps and the prefix formed with the
    combine's → (grad (T, 10, K), prefix after each entry (T, K, P, 4))."""
    T, _, K = pay.shape
    nc = K // CHUNK
    pmin = power_min_of(sigma_cutoff)
    px, py = pixel_centers(torch.arange(T), ts, tx)
    count = torch.where(skip > 0, counts, torch.zeros_like(counts)).long()
    ct_c, out_c = ct[..., :4], out[..., :4]
    trans_term = ct[..., 4] * out[..., 4]
    grad = torch.zeros_like(pay)
    prefixes = pay.new_zeros((T, K, ts * ts, 4))
    for c in range(nc):
        c0 = c * CHUNK
        applied = c0 < count
        if term_eps is not None and c > 0:
            applied &= carries[:, :, c].amax(dim=-1) >= term_eps
        rows, (alpha, active, expp, dx, dy) = chunk_alphas(pay, count, c, px,
                                                           py, pmin)
        tc = carries[:, :, c]
        acc0 = chunk_acc[:, c].transpose(1, 2)
        tl = torch.ones_like(tc)
        loc = torch.zeros_like(acc0)
        for e in range(CHUNK):
            a = alpha[..., e]
            col = rows[:, None, 5:9, e]
            wl = a * tl
            loc = loc + wl[..., None] * col
            prefix = acc0 + tc[..., None] * loc
            b = (ct_c * col).sum(-1)
            suffix = (ct_c * (out_c - prefix)).sum(-1)
            one_m = torch.clamp(1 - a, min=1 - ALPHA_CLAMP)
            dalpha = b * (tc * tl) - (suffix + trans_term) / one_m
            on = (a > 0) & applied[:, None]
            act = on & active[..., e]
            dpower = torch.where(act, dalpha * a, torch.zeros_like(a))
            x_, y_ = dx[..., e], dy[..., e]
            ca, cb, cc = (rows[:, None, r, e] for r in (2, 3, 4))
            g = torch.stack([
                dpower * (ca * x_ + cb * y_), dpower * (cc * y_ + cb * x_),
                dpower * (-0.5 * x_ * x_), dpower * (-x_ * y_),
                dpower * (-0.5 * y_ * y_),
                *(torch.where(on, ct_c[..., k] * tc * wl, torch.zeros_like(a))
                  for k in range(4)),
                torch.where(act, dalpha * expp[..., e], torch.zeros_like(a))],
                dim=1)                                     # (T, 10, P)
            grad[:, :, c0 + e] = g.sum(-1)
            prefixes[:, c0 + e] = prefix
            tl = torch.where(a > 0, tl * (1 - a), tl)
    return grad, prefixes


@pytest.mark.parametrize("ts", TILE_SIZES)
@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k1_forward_design_matches_plain_and_pallas(ts, sigma_cutoff,
                                                    term_eps):
    pay, counts, skip = k1_case_inputs(ts)
    args = [torch.as_tensor(a) for a in (pay, counts, skip)]
    out, car, chunk_acc, applied = chunked_fwd(*args, ts, K_TX, sigma_cutoff,
                                               term_eps)
    want, want_car, want_applied, _ = composite.composite_static_plain(
        *args, ts, K_TX, sigma_cutoff, term_eps, return_work=True)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=0)
    torch.testing.assert_close(car, want_car, atol=2e-5, rtol=0)
    assert applied.tolist() == want_applied.tolist()
    nc = pay.shape[-1] // CHUNK
    if term_eps is not None:
        assert applied.tolist() == [nc, 2, 0, nc, 1, 0, 2]
    else:
        assert applied.tolist() == [nc, 2, 0, nc, nc, 0, nc]
    ref_out, ref_car = jk1._call_fwd(jnp.asarray(pay), jnp.asarray(counts),
                                     jnp.asarray(skip), ts, K_TX, nc,
                                     power_min_of(sigma_cutoff), True,
                                     term_eps)
    np.testing.assert_allclose(np_of(out), np_of(ref_out), atol=2e-5)
    np.testing.assert_allclose(np_of(car), np_of(ref_car), atol=2e-5)
    # the saved state: each chunk's start is the combine's running sum
    torch.testing.assert_close(chunk_acc[:, 0], torch.zeros_like(
        chunk_acc[:, 0]), atol=0, rtol=0)
    last = (applied - 1).clamp(min=0)
    for t in range(pay.shape[0]):
        if applied[t] > 0 and int(last[t]) + 1 < nc:
            torch.testing.assert_close(chunk_acc[t, int(last[t]) + 1],
                                       out[t, :, :4].T, atol=0, rtol=0)
    # skipped and empty tiles: rgb 0, trans 1
    for t in (2, 5):
        assert not out[t, :, :4].any() and bool((out[t, :, 4] == 1).all())


@pytest.mark.parametrize("ts", TILE_SIZES)
@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k1_backward_design_matches_pallas(ts, sigma_cutoff, term_eps):
    pay, counts, skip = k1_case_inputs(ts)
    P = ts * ts
    ct = np.random.default_rng(20).normal(size=(7, P, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jk1.composite_pallas(
        p, jnp.asarray(counts), jnp.asarray(skip), ts, K_TX, sigma_cutoff,
        True, term_eps), jnp.asarray(pay))
    ref = np_of(vjp(jnp.asarray(ct))[0])
    args = [torch.as_tensor(a) for a in (pay, counts, skip)]
    out, car, chunk_acc, applied = chunked_fwd(*args, ts, K_TX, sigma_cutoff,
                                               term_eps)
    got, prefixes = chunked_bwd(*args, torch.as_tensor(ct), out, car,
                                chunk_acc, ts, K_TX, sigma_cutoff, term_eps)
    exact = composite.composite_static_bwd_plain(
        *as_float64([*args, torch.as_tensor(ct)]), ts, K_TX, sigma_cutoff,
        term_eps)
    assert_rows_close(got, exact, 1e-4, "K1b twin vs float64")
    assert_rows_close(got, ref, 2e-4, "K1b twin vs the reference")
    # entries never applied: past a count, skipped and empty tiles, chunks
    # after a stop
    count = np.where(skip > 0, counts, 0)
    for t in range(7):
        n = min(int(applied[t]) * CHUNK, int(count[t]))
        assert not got[t, :, n:].any()
    # the cancellation rule: the restarted prefix meets the next chunk's
    # saved accumulator, and out after the last applied chunk, bit for bit
    nc = pay.shape[-1] // CHUNK
    for t in range(7):
        for c in range(int(applied[t])):
            end = min((c + 1) * CHUNK, int(count[t])) - 1
            want = (chunk_acc[t, c + 1].T if c + 1 < int(applied[t])
                    else out[t, :, :4])
            assert torch.equal(prefixes[t, end], want), (t, c, nc)


@pytest.mark.parametrize("ts", [8, 12, 16, 24, 32])
def test_k1_block_layout_covers_the_tile(ts):
    """The chunk blocks' warps own 8 × 4 rectangles (one pixel a thread)
    that cover the tile rounded up to whole rectangles, each pixel once."""
    threads = composite.kernel_threads(ts)
    assert threads % 32 == 0 and threads <= 32 * 32
    rects = composite.warp_rects(torch.tensor([0], dtype=torch.int32), ts,
                                 1)[0]
    assert rects.shape[0] == threads // 32
    span = -(-ts // 8) * 8, -(-ts // 4) * 4
    cover = torch.zeros(span[1], span[0], dtype=torch.long)
    for rx0, rx1, ry0, ry1 in rects.long().tolist():
        assert (rx1 - rx0 + 1, ry1 - ry0 + 1) == (8, 4)
        cover[ry0:ry1 + 1, rx0:rx1 + 1] += 1
    assert bool((cover == 1).all())


@pytest.mark.parametrize("ts", [8, 12, 16, 32])
@pytest.mark.parametrize("sigma_cutoff", [3.0, None])
def test_k1_cull_never_drops_a_blending_pair(ts, sigma_cutoff):
    """No warp of a K1 block culls an entry that gives one of its pixels
    alpha > 0 (so the cull changes no output bit), on K1's tile lists, and
    the cull does skip (entry, warp) pairs of narrow footprints: a third at
    ts 8 (one warp, entries within 4 px of the tile), more on larger
    tiles."""
    rng = np.random.default_rng(ts)
    K = 256
    tiles = np.arange(6)
    for scale, least in (((1.0, 6.0), 0.0), ((0.3, 1.5), 0.3)):
        pay = torch.as_tensor(tile_lists(rng, tiles, [K] * 6, K, ts, K_TX,
                                         opaque=(4,), scale=scale))
        ids = torch.as_tensor(tiles, dtype=torch.int32)
        culled = cs.culled(cs.cull_boxes(pay, sigma_cutoff),
                           composite.warp_rects(ids, ts, K_TX))  # (T, W, K)
        px, py = pixel_centers(ids, ts, K_TX)
        alpha = entry_alpha(pay, px, py, power_min_of(sigma_cutoff))
        p = torch.arange(ts * ts)
        warp = p % ts // 8 + (p // ts) // 4 * -(-ts // 8)
        hit = torch.stack([(alpha[:, warp == w] > 0).any(dim=1)
                           for w in range(culled.shape[1])], dim=1)
        assert not bool((hit & culled).any())
        assert float(culled.float().mean()) >= least


def test_k1_wrappers_on_the_cpu():
    """On CPU tensors K1f's wrapper runs the plain version (no saved state
    needed: the plain backward recomputes) and launches nothing."""
    pay, counts, skip = (torch.as_tensor(a) for a in k1_case_inputs())
    before = (composite.launches, composite.launches_bwd)
    out, car, chunk_acc = composite.composite_static_fwd(
        pay, counts, skip, 16, K_TX, 3.0, 1e-4)
    assert chunk_acc is None
    want, want_car = composite.composite_static_plain(pay, counts, skip, 16,
                                                      K_TX, 3.0, 1e-4)
    assert torch.equal(out, want) and torch.equal(car, want_car)
    ct = torch.ones_like(out)
    g = composite.composite_static_bwd(pay, counts, skip, ct, out, car, 16,
                                       K_TX, 3.0, 1e-4)
    assert torch.equal(g, composite.composite_static_bwd_plain(
        pay, counts, skip, ct, 16, K_TX, 3.0, 1e-4))
    assert (composite.launches, composite.launches_bwd) == before


def test_dynamic_capacities_the_card_takes():
    """K4's wrappers take any dynamic capacity on the CPU (the reference
    does), and so do the card's kernels, which run K2's walk: the dynamic
    list is staged in windows of the largest multiple of 128 that fits in a
    block's shared memory, and every tile size up to 32 has a block."""
    for ts in (12, 16, 32):
        cs.kernel_threads(ts)
        for Kd in (5632, 5760, 16384):
            for bwd in (False, True):
                assert cs.window(Kd, ts, bwd) % 128 == 0
                assert cs.smem_bytes(Kd, ts, bwd) <= cs.SMEM_OPTIN_BYTES
    assert cs.window(640, 16, True) == 640 and cs.window(1024, 32, True) == 128
    with pytest.raises(ValueError, match="tile size"):
        cs.kernel_threads(33)
    args = [torch.as_tensor(a) for a in k4_inputs(Kd=1152)]
    out = composite_pair.composite_pair(*args, 16, K_TX, 3.0, 1e-4)
    assert out.shape == (2, 6, 256, 8) and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, composite_pair.composite_pair_plain(
        *args, 16, K_TX, 3.0, 1e-4), atol=0, rtol=0)
