"""Kernels K1f, K1b, K2f, K2b, K3f, K3b, K4f and K4b on the card against
their plain versions, and the port's step, train step, per-env step and
moving-camera rollout on the card against its CPU path.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
False (decided inside the fixture, never at import).  This file imports no
JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda.py -p no:cacheprovider -n 0

Tolerances: the kernel and the plain version compute every alpha with the
same float32 operations (no contraction into FMAs, the same ``expf``), so
they differ only in how transmittance products and colour sums are
accumulated — sequentially per pixel in the kernel, by ``cumprod`` or in
log space in the plain versions: atol 2e-5 for K1f, atol 5e-5 / rtol 1e-4
for K2f and K4f (the CPU tests' bounds against the reference), atol 2e-5
for K3f (K1's walk on per-env lists).  K2's tests also cover narrow
footprints (the warp-level cull active) and many envs adding into one
tile's static gradient; K2's and K4's cover every tile size from 8 to 32
in steps of 4 (masked pixels where ts % 8 != 0), dynamic capacities that
take several windows (up to 8,192), and K4 against K2 on the same (env,
tile) pairs, bit for bit; K1's cover its edge cases (counts, skips, stops
after chunk 0 and 1) at tile sizes 8, 12, 16 and 32.  Gradients: each
payload row within 2e-4 × that row's largest plain gradient.  The plain
backward is autograd through the plain forward, held to the same bound
against a float64 run on these near-opaque tiles with random cotangents
(``test_torch_grad.py``); the kernels' suffix sums are taken against the
forward's own accumulators, so they do not cancel.  The train step's
gradients on the card are held to the CPU path's at 2e-4 × each field's
largest gradient.
"""

import numpy as np
import pytest
import torch

from test_torch_helpers import (
    K_T, K_TS, K_TX, as_float64, assert_fields_close, assert_rows_close,
    k1_case_inputs, k1_inputs, k2_full_dyn_inputs, k2_inputs,
    k2_shared_tile_inputs, k3_inputs, k4_inputs, rows_rel_err,
    selected_cotangent, torch_raster,
)

from chip_smoke import k2_slots_of_k4
from sim_a_splat_torch import entry
from sim_a_splat_torch.ops import (
    composite, composite_pair, composite_sel, composite_single,
)
from sim_a_splat_torch.physics import pusht

pytestmark = pytest.mark.cuda

TS, TX = K_TS, K_TX
GRAD_REL = 2e-4
SETTINGS = [(3.0, 1e-4), (None, None)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def test_k1_kernel_matches_plain(dev):
    args = [torch.as_tensor(a, device=dev) for a in k1_inputs()]
    before = composite.launches
    out, car = composite.composite_static(*args, TS, TX, 3.0, 1e-4)
    torch.cuda.synchronize()
    assert composite.launches == before + 1
    ref_out, ref_car = composite.composite_static_plain(*args, TS, TX, 3.0,
                                                        1e-4)
    torch.testing.assert_close(out, ref_out, atol=2e-5, rtol=0)
    torch.testing.assert_close(car, ref_car, atol=2e-5, rtol=0)
    # an input that requires grad goes through K1f, then K1b on backward
    leaf = args[0].clone().requires_grad_()
    before_bwd = composite.launches_bwd
    out_g, _ = composite.composite_static(leaf, *args[1:], TS, TX, 3.0, 1e-4)
    assert composite.launches == before + 2
    ct = torch.randn(out_g.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    (out_g * ct).sum().backward()
    torch.cuda.synchronize()
    assert composite.launches_bwd == before_bwd + 1
    want = composite.composite_static_bwd_plain(*args, ct, TS, TX, 3.0, 1e-4)
    assert_rows_close(leaf.grad, want, GRAD_REL,
                      "K1 grad through the Function")


@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k1b_kernel_matches_plain(dev, sigma_cutoff, term_eps):
    args = [torch.as_tensor(a, device=dev) for a in k1_inputs()]
    out, car, chunk_acc = composite.composite_static_fwd(
        *args, TS, TX, sigma_cutoff, term_eps)
    ct = torch.as_tensor(np.random.default_rng(10).normal(
        size=tuple(out.shape)).astype(np.float32), device=dev)
    before = composite.launches_bwd
    got = composite.composite_static_bwd(*args, ct, out, car, TS, TX,
                                         sigma_cutoff, term_eps,
                                         chunk_acc=chunk_acc)
    torch.cuda.synchronize()
    assert composite.launches_bwd == before + 1
    want = composite.composite_static_bwd_plain(*args, ct, TS, TX,
                                                sigma_cutoff, term_eps)
    assert_rows_close(got, want, GRAD_REL, "K1b")
    assert not got[5].any() and not got[2].any()    # skipped, empty tiles
    assert not got[3, :, 130:].any()                # past the count


@pytest.mark.parametrize("ts", [8, 12, 16, 32])
@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k1_edge_cases(dev, ts, sigma_cutoff, term_eps):
    """K1f and K1b on one edge case a tile (every chunk applied, a count cut
    mid-chunk, count 0, a count past the capacity, stops after chunk 0 and
    after chunk 1, skip 0), at tile sizes that fill the warps' 8 × 8
    rectangles and one (12) that does not."""
    args = [torch.as_tensor(a, device=dev) for a in k1_case_inputs(ts)]
    before = (composite.launches, composite.launches_bwd)
    out, car, chunk_acc = composite.composite_static_fwd(
        *args, ts, TX, sigma_cutoff, term_eps)
    torch.cuda.synchronize()
    want, want_car, applied, _ = composite.composite_static_plain(
        *args, ts, TX, sigma_cutoff, term_eps, return_work=True)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=0)
    torch.testing.assert_close(car, want_car, atol=2e-5, rtol=0)
    ct = torch.as_tensor(np.random.default_rng(ts).normal(
        size=tuple(out.shape)).astype(np.float32), device=dev)
    got = composite.composite_static_bwd(*args, ct, out, car, ts, TX,
                                         sigma_cutoff, term_eps,
                                         chunk_acc=chunk_acc)
    torch.cuda.synchronize()
    assert (composite.launches, composite.launches_bwd) == \
        (before[0] + 1, before[1] + 1)
    assert_rows_close(got, composite.composite_static_bwd_plain(
        *args, ct, ts, TX, sigma_cutoff, term_eps), GRAD_REL, "K1b")
    counts = torch.where(args[2] > 0, args[1], 0).tolist()
    for t, n in enumerate(applied.tolist()):    # never applied: zero
        assert not got[t, :, min(n * 128, counts[t]):].any()


def test_k2_kernel_matches_plain(dev):
    args = [torch.as_tensor(a, device=dev) for a in k2_inputs()]
    before = composite_sel.launches
    out = composite_sel.composite_pair_sel(*args, TS, TX, 3.0, 1e-4)
    torch.cuda.synchronize()
    assert composite_sel.launches == before + 1
    ref = composite_sel.composite_pair_sel_plain(*args, TS, TX, 3.0, 1e-4)
    for b in range(2):
        rows = args[2][b].long()
        torch.testing.assert_close(out[b, rows], ref[b, rows], atol=5e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k2b_kernel_matches_plain(dev, sigma_cutoff, term_eps):
    args = [torch.as_tensor(a, device=dev) for a in k2_inputs()]
    ids = args[2]
    out = composite_sel.composite_pair_sel(*args, TS, TX, sigma_cutoff,
                                           term_eps)
    ct = torch.as_tensor(selected_cotangent(
        np.random.default_rng(11), ids.cpu().numpy(), tuple(out.shape)),
        device=dev)
    before = composite_sel.launches_bwd
    gs, gd = composite_sel.composite_pair_sel_bwd_tiles(
        *args, ct, out, TS, TX, sigma_cutoff, term_eps)
    g_spay, g_dpay = composite_sel.composite_pair_sel_bwd(
        *args, ct, out, TS, TX, sigma_cutoff, term_eps)
    torch.cuda.synchronize()
    assert composite_sel.launches_bwd == before + 2
    want_s, want_d = composite_sel.composite_pair_sel_bwd_plain(
        *args, ct, TS, TX, sigma_cutoff, term_eps)
    for got_s, got_d in ((gs, gd), (g_spay, g_dpay)):
        assert_rows_close(got_s[:K_T], want_s[:K_T], GRAD_REL,
                          "K2b static, per tile")
        assert_rows_close(got_d, want_d, GRAD_REL, "K2b dynamic")
        # pads, the trash row and the unselected tile 2 get nothing
        assert not got_d[:, 3].any() and not got_s[K_T].any()
        assert not got_s[2].any()


def _k2_both_ways(dev, inputs, ts, tx, sigma_cutoff, term_eps, seed,
                  plain_dtype=torch.float32):
    """K2f and K2b on the card against their plain versions (run in
    ``plain_dtype``)."""
    args = [torch.as_tensor(a, device=dev) for a in inputs]
    ids = args[2]
    before = (composite_sel.launches, composite_sel.launches_bwd)
    out = composite_sel.composite_pair_sel(*args, ts, tx, sigma_cutoff,
                                           term_eps)
    plain = [a.to(plain_dtype) if a.is_floating_point() else a for a in args]
    ref = composite_sel.composite_pair_sel_plain(*plain, ts, tx, sigma_cutoff,
                                                 term_eps).float()
    for b in range(ids.shape[0]):
        rows = ids[b].long()
        torch.testing.assert_close(out[b, rows], ref[b, rows], atol=5e-5,
                                   rtol=1e-4)
    ct = torch.as_tensor(selected_cotangent(
        np.random.default_rng(seed), ids.cpu().numpy(), tuple(out.shape)),
        device=dev)
    gs, gd = composite_sel.composite_pair_sel_bwd(*args, ct, out, ts, tx,
                                                  sigma_cutoff, term_eps)
    torch.cuda.synchronize()
    assert (composite_sel.launches, composite_sel.launches_bwd) == \
        (before[0] + 1, before[1] + 1)
    want_s, want_d = composite_sel.composite_pair_sel_bwd_plain(
        *plain, ct.to(plain_dtype), ts, tx, sigma_cutoff, term_eps)
    T = args[0].shape[0] - 1
    used = torch.unique(ids[ids < T].long())
    assert_rows_close(gs[used], want_s[used], GRAD_REL, "K2b static")
    assert_rows_close(gd, want_d, GRAD_REL, "K2b dynamic")
    assert not gs[T].any()
    return args


@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k2_narrow_gaussians_cull(dev, sigma_cutoff, term_eps):
    """Narrow footprints: most (entry, warp) pairs are culled, and the
    kernels still match the plain versions."""
    inputs = k2_inputs(seed=8, scale=(0.3, 1.5))
    args = _k2_both_ways(dev, inputs, TS, TX, sigma_cutoff, term_eps, 15)
    tile0 = args[0][:1]                        # a full static list
    culled = composite_sel.culled(
        composite_sel.cull_boxes(tile0, sigma_cutoff),
        composite_sel.warp_rects(args[2].new_zeros(1), TS, TX))
    assert float(culled.float().mean()) > 0.5


@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k2b_shared_tile_contention(dev, sigma_cutoff, term_eps):
    """24 envs select the same two tiles: their static gradients meet in
    two rows through the kernel's atomic adds."""
    _k2_both_ways(dev, k2_shared_tile_inputs(), TS, TX, sigma_cutoff,
                  term_eps, 16)


@pytest.mark.parametrize("ts", [8, 16, 24, 32, 12, 20, 28])
def test_k2_every_tile_size(dev, ts):
    """Every tile size up to 32, those that are not a multiple of 8 with
    masked pixels in the warps of the tile's right and bottom edges."""
    _k2_both_ways(dev, k2_inputs(seed=9, ts=ts), ts, TX, 3.0, 1e-4, 17)


LONG_CASES = [(1152, 16), (2048, 16), (256, 32), (1024, 32), (8192, 16),
              (4096, 32)]


@pytest.mark.parametrize("Kd,ts", LONG_CASES)
def test_k2_large_dyn_capacity(dev, Kd, ts):
    """Dynamic lists that fill capacities past the backward's window (896
    entries at ts 16, 128 at ts 32) and, at 8,192 and 4,096, past the
    forward's (3,968 and 3,840) and the first design's card limits: the
    walk stages them window by window.  The plain versions run in float64:
    over lists of ~2,000 entries their float32 log-space sums drift past
    the 2e-4 bound, while the kernels' walk stays within it.  Beside it,
    at Kd 2048 / ts 16, the kernels' error against float64 is printed next
    to the reference's own on these inputs (test_torch_grad.py's
    test_k2_reference_suffix_sums_on_long_lists: 6.41e-5 static, 1.86e-5
    dynamic)."""
    assert composite_sel.window(Kd, ts, True) < Kd
    _k2_both_ways(dev, k2_full_dyn_inputs(Kd, ts), ts, TX, 3.0, 1e-4, 18,
                  plain_dtype=torch.float64)


def test_k2b_suffix_sums_against_the_reference(dev):
    """K2b on the inputs of test_k2_reference_suffix_sums_on_long_lists
    (Kd 2048, ts 16, the cotangent of seed 18) against the plain backward
    in float64: no further from it than the reference's own float32
    backward (6.41e-5 of a row's scale static, 1.86e-5 dynamic, measured
    on the CPU in interpret mode).  Measured on an H100: 1.12e-5 and
    5.1e-6, so the kernels' float32 suffix sums on long lists are no
    fault against the reference."""
    spay, dpay, ids, cs, cd = (torch.as_tensor(a, device=dev)
                               for a in k2_full_dyn_inputs(2048, 16))
    ct = torch.as_tensor(selected_cotangent(
        np.random.default_rng(18), ids.cpu().numpy(),
        (ids.shape[0], spay.shape[0], 8, 256)), device=dev)
    args = (spay, dpay, ids, cs, cd)
    out = composite_sel.composite_pair_sel(*args, 16, TX, 3.0, 1e-4)
    gs, gd = composite_sel.composite_pair_sel_bwd(*args, ct, out, 16, TX,
                                                  3.0, 1e-4)
    want_s, want_d = composite_sel.composite_pair_sel_bwd_plain(
        *as_float64(args), ct.double(), 16, TX, 3.0, 1e-4)
    T = spay.shape[0] - 1
    err_s = rows_rel_err(gs[:T], want_s[:T])
    err_d = rows_rel_err(gd, want_d)
    print(f"K2b vs float64 at Kd 2048: static {err_s:.3e}, dynamic "
          f"{err_d:.3e} (the reference's own: 6.41e-5, 1.86e-5)")
    assert err_s <= 6.41e-5 and err_d <= 1.86e-5


@pytest.mark.parametrize("Kd,ts", LONG_CASES)
def test_k4_large_dyn_capacity(dev, Kd, ts):
    """K4f and K4b at capacities past the backward's window and, at 8,192
    and 4,096, past the forward's.  The plain versions run in float64: over
    lists of ~2,300 merged entries their float32 log-space sums drift past
    the 5e-5 and 2e-4 bounds, while the kernels' walk stays within them."""
    assert composite_sel.window(Kd, ts, True) < Kd
    args = [torch.as_tensor(a, device=dev) for a in k4_inputs(Kd=Kd, ts=ts)]
    plain = as_float64(args)
    leaves = (args[0].clone().requires_grad_(),
              args[1].clone().requires_grad_())
    before = (composite_pair.launches, composite_pair.launches_bwd)
    out = composite_pair.composite_pair(*leaves, *args[2:], ts, TX, 3.0, 1e-4)
    torch.testing.assert_close(out.detach(), composite_pair.composite_pair_plain(
        *plain, ts, TX, 3.0, 1e-4).float(), atol=5e-5, rtol=1e-4)
    ct = torch.as_tensor(np.random.default_rng(19).normal(
        size=tuple(out.shape)).astype(np.float32), device=dev)
    ct[args[4] == 0] = 0.0
    (out * ct).sum().backward()
    torch.cuda.synchronize()
    assert (composite_pair.launches, composite_pair.launches_bwd) == \
        (before[0] + 1, before[1] + 1)
    want_s, want_d = composite_pair.composite_pair_bwd_plain(
        *plain, ct.double(), ts, TX, 3.0, 1e-4)
    assert_rows_close(leaves[0].grad, want_s, GRAD_REL,
                      "K4b static, summed over envs")
    assert_rows_close(leaves[1].grad, want_d, GRAD_REL, "K4b dynamic")
    assert not leaves[1].grad[args[4] == 0].any()


def _scene_and_states(device):
    leaves = entry.build_scene_numpy(256, 64, 32, seed=0, sh_degree=3)
    vec = np.asarray([[120, 200, 149, 256, 0.3], [60, 400, 180, 300, -1.0]],
                     np.float32)
    actions = np.asarray([[149, 256], [170, 290]], np.float32)
    g = entry.graph_from_numpy(leaves, device=device)
    prep, step, P = entry.make_step_cached_batch(
        g, 64, 64, torch_raster(), dyn_capacity=128, sel_tiles=8,
        device=device)
    states = pusht.set_state(P, torch.as_tensor(vec, device=device))
    return g, prep, step, states, torch.as_tensor(actions, device=device)


def test_step_on_card_matches_cpu(dev):
    imgs = {}
    for d in ("cpu", dev):
        g, prep, step, states, actions = _scene_and_states(d)
        _, imgs[str(d)], drop = step(prep(g.scene), g.scene, states, actions)
        assert int(drop[0]) == 0
    torch.testing.assert_close(imgs["cuda"].cpu(), imgs["cpu"], atol=1e-4,
                               rtol=0)


def test_train_step_on_card_matches_cpu(dev):
    res = {}
    for d in ("cpu", dev):
        g, prep, step, states, actions = _scene_and_states(d)
        launched = (composite.launches_bwd, composite_sel.launches_bwd)
        _, loss, drop, grads = entry.loss_and_grads(prep, step, g.scene,
                                                    states, actions)
        assert int(drop[0]) == 0
        res[str(d)] = (loss, grads)
        if d == dev:
            assert (composite.launches_bwd, composite_sel.launches_bwd) == \
                (launched[0] + 1, launched[1] + 1)
    torch.testing.assert_close(res["cuda"][0].cpu(), res["cpu"][0],
                               rtol=1e-5, atol=0)
    assert_fields_close(res["cuda"][1], res["cpu"][1],
                        GRAD_REL)


def test_k3_kernel_matches_plain(dev):
    args = [torch.as_tensor(a, device=dev) for a in k3_inputs()]
    before = composite_single.launches
    out = composite_single.composite_sel_single(*args, TS, TX, 3.0, 1e-4)
    torch.cuda.synchronize()
    assert composite_single.launches == before + 1
    ref, applied, _ = composite_single.composite_sel_single_plain(
        *args, TS, TX, 3.0, 1e-4, return_work=True)
    torch.testing.assert_close(out[:, :K_T, :5], ref[:, :K_T, :5], atol=2e-5,
                               rtol=0)
    assert not out[:, :K_T, 5:].any()        # no gradient asked: row 5 is 0
    # an input that requires grad goes through K3f (which then records the
    # applied chunks in row 5), then K3b on backward
    leaf = args[0].clone().requires_grad_()
    before_bwd = composite_single.launches_bwd
    out_g = composite_single.composite_sel_single(leaf, *args[1:], TS, TX,
                                                  3.0, 1e-4)
    torch.testing.assert_close(out_g[:, :K_T, 5],
                               applied.float()[..., None].expand(-1, -1, 256))
    ct = torch.randn(out_g.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    (out_g[:, :K_T] * ct[:, :K_T]).sum().backward()
    torch.cuda.synchronize()
    assert composite_single.launches == before + 2
    assert composite_single.launches_bwd == before_bwd + 1
    want = composite_single.composite_sel_single_bwd_plain(
        *args, ct, TS, TX, 3.0, 1e-4)
    assert_rows_close(leaf.grad[:, :K_T], want[:, :K_T], GRAD_REL,
                      "K3 grad through the Function")


@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k3b_kernel_matches_plain(dev, sigma_cutoff, term_eps):
    args = [torch.as_tensor(a, device=dev) for a in k3_inputs()]
    leaf = args[0].clone().requires_grad_()
    out = composite_single.composite_sel_single(leaf, *args[1:], TS, TX,
                                                sigma_cutoff, term_eps)
    ct = torch.as_tensor(np.random.default_rng(13).normal(
        size=tuple(out.shape)).astype(np.float32), device=dev)
    ct[:, K_T] = 0.0
    before = composite_single.launches_bwd
    got = composite_single.composite_sel_single_bwd(
        *args, ct, out.detach(), TS, TX, sigma_cutoff, term_eps)
    torch.cuda.synchronize()
    assert composite_single.launches_bwd == before + 1
    want = composite_single.composite_sel_single_bwd_plain(
        *args, ct, TS, TX, sigma_cutoff, term_eps)
    assert_rows_close(got[:, :K_T], want[:, :K_T], GRAD_REL, "K3b")
    # the trash row, an empty tile and entries past a count get nothing
    assert not got[:, K_T].any() and not got[0, 2].any()
    assert not got[0, 1, :, 100:].any() and got[0, 1, :, :100].any()


def test_moving_rollout_on_card_matches_cpu(dev):
    res = {}
    for d in ("cpu", dev):
        leaves = entry.build_scene_numpy(256, 64, 32, seed=0, sh_degree=3)
        g = entry.graph_from_numpy(leaves, device=d)
        rollout, P = entry.make_step_moving_cached(
            g, 64, 64, torch_raster(), R=2, margin=8.0, kc=128, device=d)
        vec = np.asarray([[120, 200, 149, 256, 0.3],
                          [60, 400, 180, 300, -1.0]], np.float32)
        states = pusht.set_state(P, torch.as_tensor(vec, device=d))
        actions = torch.as_tensor([[149.0, 256.0], [170.0, 290.0]], device=d)
        launched = (composite_single.launches, composite_single.launches_bwd)
        _, loss, flags, grads = entry.rollout_loss_and_grads(
            rollout, g.scene, states, actions)
        res[str(d)] = (loss, flags, grads)
        if d == dev:
            assert (composite_single.launches,
                    composite_single.launches_bwd) == \
                (launched[0] + 2, launched[1] + 2)
    assert res["cuda"][1].tolist() == res["cpu"][1].tolist()
    torch.testing.assert_close(res["cuda"][0].cpu(), res["cpu"][0],
                               rtol=1e-5, atol=0)
    assert_fields_close(res["cuda"][2], res["cpu"][2],
                        GRAD_REL)


def test_k4_kernel_matches_plain(dev):
    args = [torch.as_tensor(a, device=dev) for a in k4_inputs()]
    before = composite_pair.launches
    out = composite_pair.composite_pair(*args, TS, TX, 3.0, 1e-4)
    torch.cuda.synchronize()
    assert composite_pair.launches == before + 1
    ref = composite_pair.composite_pair_plain(*args, TS, TX, 3.0, 1e-4)
    torch.testing.assert_close(out, ref, atol=5e-5, rtol=1e-4)
    skip = args[4]
    assert (out[skip == 0] == out.new_tensor(
        [0, 0, 0, 0, 1, 0, 0, 0])).all()


@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k4b_kernel_matches_plain(dev, sigma_cutoff, term_eps):
    args = [torch.as_tensor(a, device=dev) for a in k4_inputs()]
    leaves = (args[0].clone().requires_grad_(),
              args[1].clone().requires_grad_())
    out = composite_pair.composite_pair(*leaves, *args[2:], TS, TX,
                                        sigma_cutoff, term_eps)
    ct = torch.as_tensor(np.random.default_rng(14).normal(
        size=tuple(out.shape)).astype(np.float32), device=dev)
    ct[args[4] == 0] = 0.0
    before = composite_pair.launches_bwd
    (out * ct).sum().backward()
    torch.cuda.synchronize()
    assert composite_pair.launches_bwd == before + 1
    want_s, want_d = composite_pair.composite_pair_bwd_plain(
        *args, ct, TS, TX, sigma_cutoff, term_eps)
    assert_rows_close(leaves[0].grad, want_s, GRAD_REL,
                      "K4b static, summed over envs")
    assert_rows_close(leaves[1].grad, want_d, GRAD_REL, "K4b dynamic")
    assert not leaves[1].grad[args[4] == 0].any()
    assert not leaves[0].grad[2].any()            # the empty static tile


@pytest.mark.parametrize("ts", [8, 12, 16, 20, 24, 28, 32])
def test_k4_every_tile_size(dev, ts):
    """K4f and K4b at every tile size up to 32 against their plain
    versions."""
    args = [torch.as_tensor(a, device=dev) for a in k4_inputs(seed=7, ts=ts)]
    leaves = (args[0].clone().requires_grad_(),
              args[1].clone().requires_grad_())
    out = composite_pair.composite_pair(*leaves, *args[2:], ts, TX, 3.0, 1e-4)
    torch.testing.assert_close(out.detach(), composite_pair.composite_pair_plain(
        *args, ts, TX, 3.0, 1e-4), atol=5e-5, rtol=1e-4)
    ct = torch.as_tensor(np.random.default_rng(ts).normal(
        size=tuple(out.shape)).astype(np.float32), device=dev)
    ct[args[4] == 0] = 0.0
    (out * ct).sum().backward()
    want_s, want_d = composite_pair.composite_pair_bwd_plain(
        *args, ct, ts, TX, 3.0, 1e-4)
    assert_rows_close(leaves[0].grad, want_s, GRAD_REL,
                      "K4b static, summed over envs")
    assert_rows_close(leaves[1].grad, want_d, GRAD_REL, "K4b dynamic")


@pytest.mark.parametrize("Kd,ts", [(128, 16), (256, 12), (8192, 16),
                                   (4096, 32)])
def test_k4_touched_pairs_equal_k2(dev, Kd, ts):
    """K4 runs K2's block body: on every touched (env, tile) pair K4f's
    output equals K2f's on the same pair, and K4b's dynamic gradient
    K2b's, to the last bit, with the dynamic list in one window (Kd 128,
    256) and in several (8,192 at ts 16, 4,096 at ts 32)."""
    args = [torch.as_tensor(a, device=dev) for a in k4_inputs(Kd=Kd, ts=ts)]
    out4 = composite_pair.composite_pair(*args, ts, TX, 3.0, 1e-4)
    a2 = k2_slots_of_k4(*args)
    out2 = composite_sel.composite_pair_sel(*a2, ts, TX, 3.0, 1e-4)
    ids = a2[2]
    assert (composite_sel.window(Kd, ts, False) < Kd) == (Kd > 256)
    B, T = args[4].shape
    pairs = 0
    for b in range(B):
        for t in ids[b][ids[b] < T].tolist():
            assert torch.equal(out4[b, t], out2[b, t].T), (b, t)
            pairs += 1
    assert pairs == int((args[4] > 0).sum())
    ct4 = torch.as_tensor(np.random.default_rng(Kd).normal(
        size=tuple(out4.shape)).astype(np.float32), device=dev)
    ct4[args[4] == 0] = 0.0
    ct2 = torch.zeros_like(out2)
    bidx = torch.arange(B, device=dev)[:, None]
    real = ids < T
    safe = torch.where(real, ids, 0).long()
    # pads name the trash row, which takes zeros
    ct2[bidx, ids.long()] = torch.where(real[..., None, None],
                                        ct4[bidx, safe].transpose(-1, -2),
                                        0.0)
    _, gd4 = composite_pair.composite_pair_bwd(*args, ct4, out4, ts, TX,
                                               3.0, 1e-4)
    _, gd2 = composite_sel.composite_pair_sel_bwd(*a2, ct2, out2, ts, TX,
                                                  3.0, 1e-4)
    torch.cuda.synchronize()
    assert torch.equal(gd4[bidx, safe][real], gd2[real])


def test_per_env_step_on_card_matches_cpu(dev):
    res = {}
    for d in ("cpu", dev):
        leaves = entry.build_scene_numpy(256, 64, 32, seed=0, sh_degree=3)
        g = entry.graph_from_numpy(leaves, device=d)
        prep, step, P = entry.make_step_cached(g, 64, 64, torch_raster(),
                                               device=d)
        vec = np.asarray([[120, 200, 149, 256, 0.3],
                          [60, 400, 180, 300, -1.0]], np.float32)
        states = pusht.set_state(P, torch.as_tensor(vec, device=d))
        actions = torch.as_tensor([[149.0, 256.0], [170.0, 290.0]], device=d)
        launched = (composite_pair.launches, composite_pair.launches_bwd)
        _, imgs, n_trunc = step(prep(g.scene), g.scene, states, actions)
        _, loss, _, grads = entry.loss_and_grads(prep, step, g.scene, states,
                                                 actions)
        res[str(d)] = (imgs, n_trunc, loss, grads)
        if d == dev:
            assert (composite_pair.launches, composite_pair.launches_bwd) == \
                (launched[0] + 2, launched[1] + 1)
    torch.testing.assert_close(res["cuda"][0].cpu(), res["cpu"][0], atol=1e-4,
                               rtol=0)
    assert res["cuda"][1].tolist() == res["cpu"][1].tolist()
    torch.testing.assert_close(res["cuda"][2].cpu(), res["cpu"][2],
                               rtol=1e-5, atol=0)
    assert_fields_close(res["cuda"][3], res["cpu"][3],
                        GRAD_REL)
