"""The K2 kernels' warp-level footprint cull, through its plain twin
(``composite_sel.cull_boxes`` / ``warp_rects`` / ``culled``), on the CPU.

The cull may skip an entry for a warp only if no pixel centre of the warp's
rectangle gets alpha > 0 from it under ``entry_alpha`` (the kernels' own
float32 steps): otherwise the kernels' outputs would change.  These tests
hold the twin to that on random entries (hypothesis) and on adversarial
ones (cut boundaries through pixel centres, opacities at the edges of the
alpha range, near-degenerate and non-positive-definite conics, the sigma
cut-off on and off), and check that it does cull far entries, so that the
property is not met by culling nothing.  The kernels' block layout and
shared-memory limits are checked here too.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sim_a_splat_torch.ops import composite_sel as cs
from sim_a_splat_torch.ops.composite import (
    entry_alpha, pixel_centers, power_min_of,
)
from sim_a_splat_torch.ops.rasterize_reference import ALPHA_CLAMP

TX = 4
ALPHA_MIN32 = float(np.float32(1.0 / 255.0))
CLAMP32 = float(np.float32(ALPHA_CLAMP))


def warp_of_pixel(ts):
    """(P,) warp index of each pixel under the kernels' layout: 8 × 8
    rectangles in row-major order, ceil(ts / 8) to a row."""
    p = torch.arange(ts * ts)
    x, y = p % ts, p // ts
    return x // 8 + (y // 8) * -(-ts // 8)


def origin(tile, ts):
    return (tile % TX) * ts, (tile // TX) * ts


def violations(rows, tiles, sigma_cutoff, ts):
    """(hit, culled) per (slot, warp, entry) and the count of pairs culled
    although a pixel of the warp gets alpha > 0."""
    rows = torch.as_tensor(rows, dtype=torch.float32)
    tiles = torch.as_tensor(tiles, dtype=torch.int32)
    c = cs.culled(cs.cull_boxes(rows, sigma_cutoff),
                  cs.warp_rects(tiles, ts, TX))
    px, py = pixel_centers(tiles, ts, TX)
    alpha = entry_alpha(rows, px, py, power_min_of(sigma_cutoff))
    wop = warp_of_pixel(ts)
    hit = torch.stack([(alpha[:, wop == w] > 0).any(dim=1)
                       for w in range(c.shape[1])], dim=1)
    return hit, c, int((hit & c).sum())


def conic_rows(x, y, sx, sy, rho, op):
    """(1, 10, K) payload of entries with the given centres, scales,
    correlations and opacities (colour and depth unused)."""
    x, y, sx, sy, rho, op = (np.asarray(v, np.float64).reshape(-1)
                             for v in (x, y, sx, sy, rho, op))
    det = 1.0 - rho ** 2
    rows = np.zeros((1, 10, x.size), np.float32)
    rows[0, 0], rows[0, 1] = x, y
    rows[0, 2] = 1.0 / (sx ** 2 * det)
    rows[0, 3] = -rho / (sx * sy * det)
    rows[0, 4] = 1.0 / (sy ** 2 * det)
    rows[0, 9] = op
    return rows


# (sigma cut-off, tile size)
SETTINGS = [(3.0, 8), (3.0, 16), (3.0, 32), (None, 16)]


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       sigma=st.sampled_from([3.0, 2.0, None]),
       ts=st.sampled_from([8, 16, 24, 32]),
       scale=st.floats(0.05, 40.0),
       aniso=st.floats(1.0, 200.0),
       rho=st.floats(-0.999, 0.999))
def test_cull_never_drops_a_blending_pair(seed, sigma, ts, scale, aniso,
                                          rho):
    rng = np.random.default_rng(seed)
    K = 64
    tile = int(rng.integers(0, TX * 3))
    ox, oy = origin(tile, ts)
    rows = conic_rows(ox + rng.uniform(-3 * scale, ts + 3 * scale, K),
                      oy + rng.uniform(-3 * scale, ts + 3 * scale, K),
                      np.full(K, scale), np.full(K, scale * aniso),
                      np.full(K, rho),
                      rng.choice([ALPHA_MIN32, 0.01, 0.5, CLAMP32, 1.0], K))
    _, _, bad = violations(rows, [tile], sigma, ts)
    assert bad == 0


@pytest.mark.parametrize("sigma,ts", SETTINGS)
def test_cut_boundaries_through_pixel_centres(sigma, ts):
    """Entries placed so that a pixel centre of a warp's edge lies on the
    sigma cut or the alpha cut, or one float32 step either side of it."""
    tile = 5
    ox, oy = origin(tile, ts)
    pcx, pcy = ox + 7.5, oy + 7.5        # warp 0's corner pixel
    xs, ys, sxs, ops = [], [], [], []
    for s in (0.5, 1.0, 1.7, 3.3):
        # sigma boundary: q = 9 at distance 3 s
        for d in (3 * s, np.nextafter(np.float32(3 * s), 0),
                  np.nextafter(np.float32(3 * s), 10)):
            xs.append(pcx + d), ys.append(pcy), sxs.append(s)
            ops.append(0.9)
        # alpha boundary: op exp(-d² / (2 s²)) = ALPHA_MIN at distance d
        for op in (ALPHA_MIN32, np.nextafter(np.float32(ALPHA_MIN32), 1),
                   0.02, 0.3, CLAMP32, 1.0):
            d = s * np.sqrt(2 * np.log(op / ALPHA_MIN32))
            for dd in (d, d * (1 - 1e-7), d * (1 + 1e-7)):
                xs.append(pcx + dd), ys.append(pcy), sxs.append(s)
                ops.append(op)
    n = len(xs)
    rows = conic_rows(xs, ys, sxs, sxs, np.zeros(n), ops)
    # also the same entries off the diagonal, and the mirror images
    rows = np.concatenate([rows,
                           conic_rows(np.array(xs) - 2 * (np.array(xs) - pcx)
                                      - 7, ys, sxs, sxs, np.zeros(n), ops)],
                          axis=-1)
    hit, c, bad = violations(rows, [tile], sigma, ts)
    assert bad == 0
    assert bool(hit.any())           # the boundary pixels do blend


@pytest.mark.parametrize("sigma,ts", SETTINGS)
def test_near_degenerate_and_non_positive_definite_conics(sigma, ts):
    rng = np.random.default_rng(7)
    K = 256
    tile = 2
    ox, oy = origin(tile, ts)
    x = ox + rng.uniform(-30, ts + 30, K)
    y = oy + rng.uniform(-30, ts + 30, K)
    # correlations within 1e-6 of ±1: condition numbers up to ~1e6
    rho = np.sign(rng.uniform(-1, 1, K)) * (1 - 10 ** rng.uniform(-6, -1, K))
    rows = conic_rows(x, y, rng.uniform(0.5, 8, K), rng.uniform(0.5, 8, K),
                      rho, rng.uniform(0.01, 1, K))
    _, _, bad = violations(rows, [tile], sigma, ts)
    assert bad == 0
    # a <= 0, det <= 0 (hyperbolic or flat): never culled, wherever it is,
    # even the faint ones (op < ALPHA_MIN, the last two of each kind)
    bad_conic = np.zeros((1, 10, 8), np.float32)
    bad_conic[0, 0], bad_conic[0, 1] = 1000.0, -1000.0
    conics = np.array([[-1.0, 0.5, 1.0, 0.0],     # a
                       [0.0, 2.0, 1.0, 0.0],      # b
                       [1.0, 1.0, 1.0, 0.0]])     # c
    bad_conic[0, 2:5] = np.concatenate([conics, conics], axis=1)
    bad_conic[0, 9] = [0.9] * 4 + [0.002, 0.003, 0.001, ALPHA_MIN32 / 2]
    boxes = cs.cull_boxes(torch.as_tensor(bad_conic), sigma)
    inf = float("inf")
    assert bool((boxes[0, 0] == -inf).all() and (boxes[0, 1] == inf).all())
    assert not bool(cs.culled(boxes, cs.warp_rects(
        torch.tensor([tile], dtype=torch.int32), ts, TX)).any())
    _, _, bad = violations(bad_conic, [tile], sigma, ts)
    assert bad == 0


@pytest.mark.parametrize("sigma,ts", SETTINGS)
def test_cull_skips_far_and_faint_entries(sigma, ts):
    """Not vacuous: an entry far from a warp, or fainter than ALPHA_MIN, is
    culled; on a random tile most (entry, warp) pairs are."""
    tile = 6
    ox, oy = origin(tile, ts)
    rows = conic_rows([ox + 8, ox + 100, ox + 8, ox - 20],
                      [oy + 8, oy + 8, oy - 50, oy + 8],
                      [2.0, 2.0, 2.0, 2.0], [2.0, 2.0, 2.0, 2.0],
                      [0.0] * 4, [0.9, 0.9, 0.9, 0.003])
    hit, c, bad = violations(rows, [tile], sigma, ts)
    assert bad == 0
    assert bool(hit[0, :, 0].any()) and not bool(c[0, :, 0].all())
    assert bool(c[0, :, 1:].all())
    rng = np.random.default_rng(3)
    K = 512
    rows = conic_rows(ox + rng.uniform(-40, ts + 40, K),
                      oy + rng.uniform(-40, ts + 40, K),
                      rng.uniform(0.5, 3, K), rng.uniform(0.5, 3, K),
                      rng.uniform(-0.6, 0.6, K), rng.uniform(0.05, 0.95, K))
    hit, c, bad = violations(rows, [tile], sigma, ts)
    assert bad == 0 and float(c.float().mean()) > 0.8


def test_non_finite_entries_are_never_culled():
    rows = conic_rows([5.0] * 3, [5.0] * 3, [1.0] * 3, [1.0] * 3, [0.0] * 3,
                      [0.5, 0.5, 0.5])
    rows[0, 0, 0] = np.inf
    rows[0, 2, 1] = np.nan
    rows[0, 9, 2] = np.inf
    boxes = cs.cull_boxes(torch.as_tensor(rows), 3.0)
    rects = cs.warp_rects(torch.tensor([40], dtype=torch.int32), 16, TX)
    assert not bool(cs.culled(boxes, rects).any())


@pytest.mark.parametrize("ts", [8, 16, 24, 32, 1, 5, 12, 20, 28])
def test_kernel_layout_covers_the_tile(ts):
    """Every tile size the kernels take: the warps' rectangles, cut to the
    tile, cover each pixel once, the block fits the launch bounds and the
    main path's shared memory."""
    threads = cs.kernel_threads(ts)
    assert threads == 32 * (-(-ts // 8)) ** 2 and threads <= 512
    if ts % 8 == 0:
        assert 2 * threads == ts * ts
    rects = cs.warp_rects(torch.tensor([0], dtype=torch.int32), ts, 1)[0]
    assert rects.shape[0] == threads // 32
    cover = torch.zeros(ts, ts, dtype=torch.long)
    for rx0, rx1, ry0, ry1 in rects.long().tolist():
        assert 0 <= rx1 - rx0 <= 7 and 0 <= ry1 - ry0 <= 7
        assert rx1 < ts and ry1 < ts
        cover[ry0:ry1 + 1, rx0:rx1 + 1] += 1
    assert bool((cover == 1).all())
    # each warp's rectangle is the one warp_of_pixel assigns
    wop = warp_of_pixel(ts).reshape(ts, ts)
    for w, (rx0, rx1, ry0, ry1) in enumerate(rects.long().tolist()):
        assert bool((wop[ry0:ry1 + 1, rx0:rx1 + 1] == w).all())
    assert cs.smem_bytes(128, ts, True) <= cs.SMEM_OPTIN_BYTES


def test_kernel_limits_raise_clearly():
    """The card's kernels take every tile size up to 32 and every dynamic
    capacity: the list is staged in windows that fit in shared memory."""
    for ts in (0, 33, 40):
        with pytest.raises(ValueError, match="tile size"):
            cs.kernel_threads(ts)
    # K2b at the main path's Kd = 128, ts = 16: 4 warps, 56 KB, one window
    assert cs.smem_bytes(128, 16, True) == 55_936
    assert cs.window(128, 16, True) == 128
    # past the room of the backward's partial sums the list takes windows
    # (896 entries at ts 16, 128 at ts 32); the forward's are larger
    assert cs.window(1024, 16, True) == 896
    assert cs.window(256, 32, True) == 128
    assert cs.window(3968, 16, False) == 3968
    assert cs.window(4096, 16, False) == 3968
    assert cs.window(4096, 32, False) == 3840
    for ts in (1, 8, 12, 16, 24, 32):
        for Kd in (128, 2048, 4096, 8192, 16384):
            for bwd in (False, True):
                assert cs.smem_bytes(Kd, ts, bwd) <= cs.SMEM_OPTIN_BYTES


@pytest.mark.parametrize("ts", [12, 20, 28])
@pytest.mark.parametrize("sigma", [3.0, None])
def test_cull_with_masked_pixels(sigma, ts):
    """Tile sizes that are not a multiple of 8: the warps on the tile's
    right and bottom edges hold masked pixels, and their cull rectangles
    are cut to the tile.  No pair whose pixels blend is culled (random
    entries and entries whose footprints end just past the tile's last
    pixel centres), and the cut culls entries that reach only the masked
    pixels, so that the property is not met by culling nothing."""
    tile = 5
    ox, oy = origin(tile, ts)
    rng = np.random.default_rng(ts)
    K = 256
    rows = conic_rows(ox + rng.uniform(-20, ts + 20, K),
                      oy + rng.uniform(-20, ts + 20, K),
                      rng.uniform(0.3, 4, K), rng.uniform(0.3, 4, K),
                      rng.uniform(-0.6, 0.6, K),
                      rng.choice([ALPHA_MIN32, 0.05, 0.5, CLAMP32], K))
    hit, c, bad = violations(rows, [tile], sigma, ts)
    assert bad == 0 and bool(hit.any()) and bool(c.any())
    # footprints of sigma 0.5 whose alpha cut (inside the sigma cut) lies
    # 0.05 px either side of the last pixel centres' row and column
    s, op = 0.5, 0.03
    d = s * np.sqrt(2 * np.log(op / ALPHA_MIN32))
    edge = []
    for gap in (-0.05, 0.05):
        for k in range(4):
            along = (k + 0.5) * ts / 4
            edge.append((ox + ts - 0.5 + d + gap, oy + along))
            edge.append((ox + along, oy + ts - 0.5 + d + gap))
    ex, ey = (np.array(v) for v in zip(*edge))
    rows = conic_rows(ex, ey, np.full(ex.size, s), np.full(ex.size, s),
                      np.zeros(ex.size), np.full(ex.size, op))
    hit, c, bad = violations(rows, [tile], sigma, ts)
    assert bad == 0
    inside = hit.any(dim=1)[0]             # the entries a pixel blends
    assert bool(inside[:8].all()) and not bool(inside[8:].any())
    # a rectangle not cut to the tile would keep the far entries
    full = cs.warp_rects(torch.tensor([tile], dtype=torch.int32), ts, TX)
    wgx = -(-ts // 8)
    w = torch.arange(full.shape[1])
    full[0, :, 1] = ((w % wgx) * 8 + 7).float() + 0.5 + ox
    full[0, :, 3] = ((w // wgx) * 8 + 7).float() + 0.5 + oy
    boxes = cs.cull_boxes(torch.as_tensor(rows), sigma)
    assert int(cs.culled(boxes, full).sum()) < int(c.sum())
