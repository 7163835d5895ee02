"""Kernels K1f, K1b, K2f, K2b, K3f, K3b, K4f and K4b on the card against
their plain versions, and the port's step, train step, per-env step,
uncached step and moving-camera rollout on the card against its CPU path.

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
for K3f (K1's walk on each slot's list; every tile size from 1 to 32,
list capacities of 1 to 16 chunks, both payload modes, and the shared
mode's atomic gradient sums against float64).  K2's tests also cover narrow
footprints (the warp-level cull active) and many envs adding into one
tile's static gradient; K2's and K4's cover every tile size from 8 to 32
in steps of 4 (masked pixels where ts % 8 != 0), dynamic capacities that
take several windows (up to 8,192), and K4 against K2 on the same (env,
tile) pairs, bit for bit; K1's cover its edge cases (counts, skips, stops
after chunk 0 and 1) at tile sizes 8, 12, 16 and 32, alone and with a
leading env axis (each env's rows bit for bit those of K1 run on that env
alone), and the padded lists of a capacity that is not a multiple of 128.
Gradients: each
payload row within 2e-4 × that row's largest plain gradient.  The plain
backward is autograd through the plain forward, held to the same bound
against a float64 run on these near-opaque tiles with random cotangents
(``test_torch_grad.py``); the kernels' suffix sums are taken against the
forward's own accumulators, so they do not cancel.  The train step's
gradients on the card are held to the CPU path's at 2e-4 × each field's
largest gradient.

The pushT control step's kernel (``csrc/pusht_step.cu``) runs the plain
path's float32 operations one for one (no FMA contraction, IEEE division,
``sqrtf``, ``sinf``, ``cosf``), so it can agree with the plain path on the
card bit for bit; it is held to the port's physics tolerances all the same
(positions and velocities atol 1e-3, the angle 1e-4, ``n_contacts``
exact: the CPU tests' bounds against the reference), and each test prints
the max|Δ| it measured.  The arm's control-step kernel
(``csrc/arm_step.cu``) follows the plain step the same way and is held
to it bit for bit on the new state, the reward and the flags, the info
within 1e-5.  The candidate reprojection's kernel (``csrc/reproject.cu``,
R1) follows the plain reprojection op for op and is held to it bit for bit
on every payload row but the three colours, and on the sort key; the
colours within 1e-6 (it sums the SH coefficients in order, the plain
version's einsum goes through cuBLAS's gemv).
"""

import pathlib

import numpy as np
import pytest
import torch

from test_torch_helpers import (
    K_T, K_TS, K_TX, arm_case_inputs, arm_chain_past_caps, as_float64,
    assert_fields_close, assert_r1_matches_plain, reproject_case_inputs,
    assert_rows_close, k1_case_inputs, k1_inputs, k2_full_dyn_inputs, k2_inputs,
    k2_per_env_inputs, k2_shared_tile_inputs, k3_inputs, k3_shared_inputs, k4_inputs,
    pusht_case_actions, pusht_case_vectors, rows_rel_err,
    selected_cotangent, torch_raster,
)

from chip_smoke import k2_slots_of_k4
from sim_a_splat_torch import entry
from sim_a_splat_torch.ops import (
    composite, composite_pair, composite_sel, composite_single,
    rasterize_moving,
)
from sim_a_splat_torch.physics import pusht
from sim_a_splat_torch.utils import profiling

pytestmark = pytest.mark.cuda

TS, TX = K_TS, K_TX
GRAD_REL = 2e-4
SETTINGS = [(3.0, 1e-4), (None, None)]


def launch_counts(*ops) -> tuple:
    """The launch counts of the operators ``ops`` so far."""
    return tuple(profiling.launches[op] for op in ops)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def test_k1_kernel_matches_plain(dev):
    args = [torch.as_tensor(a, device=dev) for a in k1_inputs()]
    before = profiling.launches["composite_static"]
    out, car = composite.composite_static(*args, TS, TX, 3.0, 1e-4)
    torch.cuda.synchronize()
    assert profiling.launches["composite_static"] == before + 1
    ref_out, ref_car = composite.composite_static_plain(*args, TS, TX, 3.0,
                                                        1e-4)
    torch.testing.assert_close(out, ref_out, atol=2e-5, rtol=0)
    torch.testing.assert_close(car, ref_car, atol=2e-5, rtol=0)
    # an input that requires grad goes through K1f, then K1b on backward
    leaf = args[0].clone().requires_grad_()
    before_bwd = profiling.launches["composite_static_bwd"]
    out_g, _ = composite.composite_static(leaf, *args[1:], TS, TX, 3.0, 1e-4)
    assert profiling.launches["composite_static"] == before + 2
    ct = torch.randn(out_g.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    (out_g * ct).sum().backward()
    torch.cuda.synchronize()
    assert profiling.launches["composite_static_bwd"] == before_bwd + 1
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
    before = profiling.launches["composite_static_bwd"]
    got = composite.composite_static_bwd(*args, ct, out, car, TS, TX,
                                         sigma_cutoff, term_eps,
                                         chunk_acc=chunk_acc)
    torch.cuda.synchronize()
    assert profiling.launches["composite_static_bwd"] == before + 1
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
    before = launch_counts("composite_static", "composite_static_bwd")
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
    assert launch_counts("composite_static", "composite_static_bwd") == \
        (before[0] + 1, before[1] + 1)
    assert_rows_close(got, composite.composite_static_bwd_plain(
        *args, ct, ts, TX, sigma_cutoff, term_eps), GRAD_REL, "K1b")
    counts = torch.where(args[2] > 0, args[1], 0).tolist()
    for t, n in enumerate(applied.tolist()):    # never applied: zero
        assert not got[t, :, min(n * 128, counts[t]):].any()


def test_k2_kernel_matches_plain(dev):
    args = [torch.as_tensor(a, device=dev) for a in k2_inputs()]
    before = profiling.launches["composite_pair_sel"]
    out = composite_sel.composite_pair_sel(*args, TS, TX, 3.0, 1e-4)
    torch.cuda.synchronize()
    assert profiling.launches["composite_pair_sel"] == before + 1
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
    before = profiling.launches["composite_pair_sel_bwd"]
    gs, gd = composite_sel.composite_pair_sel_bwd_tiles(
        *args, ct, out, TS, TX, sigma_cutoff, term_eps)
    g_spay, g_dpay = composite_sel.composite_pair_sel_bwd(
        *args, ct, out, TS, TX, sigma_cutoff, term_eps)
    torch.cuda.synchronize()
    assert profiling.launches["composite_pair_sel_bwd"] == before + 2
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
    before = launch_counts("composite_pair_sel", "composite_pair_sel_bwd")
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
    assert launch_counts("composite_pair_sel", "composite_pair_sel_bwd") == \
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


@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k2_per_env_kernels_match_plain(dev, sigma_cutoff, term_eps,
                                        permuted):
    """K2f and K2b with a per-env (B, T+1, 10, Ks) static payload against
    their plain versions, with the dense ids and with ids out of tile order
    (the static gradient scattered by id); each env's forward rows equal
    K2f's shared mode on that env's payload alone, bit for bit."""
    spay, dpay, ids, cs, cd = k2_per_env_inputs()
    if permuted:
        order = np.asarray([[3, 1, 0, 5, 2, 4], [4, 0, 2, 1, 5, 3]])
        ids = ids[np.arange(2)[:, None], order]
        dpay = dpay[np.arange(2)[:, None], order]
        cd = cd[np.arange(2)[:, None], order]
    args = [torch.as_tensor(a, device=dev) for a in (spay, dpay, ids, cs, cd)]
    before = launch_counts("composite_pair_sel", "composite_pair_sel_bwd")
    out = composite_sel.composite_pair_sel(*args, TS, TX, sigma_cutoff,
                                           term_eps)
    ref = composite_sel.composite_pair_sel_plain(*args, TS, TX, sigma_cutoff,
                                                 term_eps)
    torch.testing.assert_close(out[:, :K_T], ref[:, :K_T], atol=5e-5,
                               rtol=1e-4)
    for b in range(2):
        one = composite_sel.composite_pair_sel(
            args[0][b], args[1][b:b + 1], args[2][b:b + 1], args[3][b],
            args[4][b:b + 1], TS, TX, sigma_cutoff, term_eps)
        assert torch.equal(out[b, :K_T], one[0, :K_T]), f"env {b}"
    ct = torch.as_tensor(selected_cotangent(
        np.random.default_rng(20), ids, tuple(out.shape)), device=dev)
    gs, gd = composite_sel.composite_pair_sel_bwd(*args, ct, out, TS, TX,
                                                  sigma_cutoff, term_eps)
    torch.cuda.synchronize()
    assert launch_counts("composite_pair_sel", "composite_pair_sel_bwd") == \
        (before[0] + 3, before[1] + 1)
    want_s, want_d = composite_sel.composite_pair_sel_bwd_plain(
        *args, ct, TS, TX, sigma_cutoff, term_eps)
    assert gs.shape == args[0].shape
    assert_rows_close(gs[:, :K_T], want_s[:, :K_T], GRAD_REL,
                      "K2b per-env static")
    assert_rows_close(gd, want_d, GRAD_REL, "K2b per-env dynamic")
    assert not gs[:, K_T].any()


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
    before = launch_counts("composite_pair", "composite_pair_bwd")
    out = composite_pair.composite_pair(*leaves, *args[2:], ts, TX, 3.0, 1e-4)
    torch.testing.assert_close(out.detach(), composite_pair.composite_pair_plain(
        *plain, ts, TX, 3.0, 1e-4).float(), atol=5e-5, rtol=1e-4)
    ct = torch.as_tensor(np.random.default_rng(19).normal(
        size=tuple(out.shape)).astype(np.float32), device=dev)
    ct[args[4] == 0] = 0.0
    (out * ct).sum().backward()
    torch.cuda.synchronize()
    assert launch_counts("composite_pair", "composite_pair_bwd") == \
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
        launched = launch_counts("composite_static_bwd",
                                 "composite_pair_sel_bwd")
        _, loss, drop, grads = entry.loss_and_grads(prep, step, g.scene,
                                                    states, actions)
        assert int(drop[0]) == 0
        res[str(d)] = (loss, grads)
        if d == dev:
            assert launch_counts("composite_static_bwd",
                                 "composite_pair_sel_bwd") == \
                (launched[0] + 1, launched[1] + 1)
    torch.testing.assert_close(res["cuda"][0].cpu(), res["cpu"][0],
                               rtol=1e-5, atol=0)
    assert_fields_close(res["cuda"][1], res["cpu"][1],
                        GRAD_REL)


def test_k3_kernel_matches_plain(dev):
    args = [torch.as_tensor(a, device=dev) for a in k3_inputs()]
    before = profiling.launches["composite_sel_single"]
    out = composite_single.composite_sel_single(*args, TS, TX, 3.0, 1e-4)
    torch.cuda.synchronize()
    assert profiling.launches["composite_sel_single"] == before + 1
    ref, applied, _ = composite_single.composite_sel_single_plain(
        *args, TS, TX, 3.0, 1e-4, return_work=True)
    torch.testing.assert_close(out[:, :K_T, :5], ref[:, :K_T, :5], atol=2e-5,
                               rtol=0)
    assert not out[:, :K_T, 5:].any()        # no gradient asked: row 5 is 0
    # an input that requires grad goes through K3f (which then records the
    # applied chunks in row 5), then K3b on backward
    leaf = args[0].clone().requires_grad_()
    before_bwd = profiling.launches["composite_sel_single_bwd"]
    out_g = composite_single.composite_sel_single(leaf, *args[1:], TS, TX,
                                                  3.0, 1e-4)
    torch.testing.assert_close(out_g[:, :K_T, 5],
                               applied.float()[..., None].expand(-1, -1, 256))
    ct = torch.randn(out_g.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    (out_g[:, :K_T] * ct[:, :K_T]).sum().backward()
    torch.cuda.synchronize()
    assert profiling.launches["composite_sel_single"] == before + 2
    assert profiling.launches["composite_sel_single_bwd"] == before_bwd + 1
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
    before = profiling.launches["composite_sel_single_bwd"]
    got = composite_single.composite_sel_single_bwd(
        *args, ct, out.detach(), TS, TX, sigma_cutoff, term_eps)
    torch.cuda.synchronize()
    assert profiling.launches["composite_sel_single_bwd"] == before + 1
    want = composite_single.composite_sel_single_bwd_plain(
        *args, ct, TS, TX, sigma_cutoff, term_eps)
    assert_rows_close(got[:, :K_T], want[:, :K_T], GRAD_REL, "K3b")
    # the trash row, an empty tile and entries past a count get nothing
    assert not got[:, K_T].any() and not got[0, 2].any()
    assert not got[0, 1, :, 100:].any() and got[0, 1, :, :100].any()


def k3_check(dev, args, ts, sigma_cutoff, term_eps, what):
    """K3f and K3b (through the Function) on CUDA tensors against the plain
    versions: out rows 0-4 atol 2e-5 at the named rows, row 5 exact, each
    gradient row within GRAD_REL; returns (out, grad, ct)."""
    spay, ids, counts = args
    leaf = spay.clone().requires_grad_()
    before = launch_counts("composite_sel_single", "composite_sel_single_bwd")
    out = composite_single.composite_sel_single(leaf, ids, counts, ts, TX,
                                                sigma_cutoff, term_eps)
    ref = composite_single.composite_sel_single_plain(
        spay, ids, counts, ts, TX, sigma_cutoff, term_eps, save_state=True)
    bidx = torch.arange(ids.shape[0], device=dev)[:, None]
    rows = ids.long()
    torch.testing.assert_close(out.detach()[bidx, rows][..., :5, :],
                               ref[bidx, rows][..., :5, :], atol=2e-5,
                               rtol=0, msg=what)
    assert torch.equal(out.detach()[bidx, rows][..., 5, :],
                       ref[bidx, rows][..., 5, :]), what
    ct = torch.zeros_like(ref)
    ct[bidx, rows] = torch.as_tensor(np.random.default_rng(ts).normal(
        size=(*ids.shape, 8, ts * ts)).astype(np.float32), device=dev)
    ct[:, -1] = 0.0
    (out * ct).sum().backward()
    torch.cuda.synchronize()
    assert launch_counts("composite_sel_single",
                         "composite_sel_single_bwd") == \
        (before[0] + 1, before[1] + 1), what
    want = composite_single.composite_sel_single_bwd_plain(
        spay, ids, counts, ct, ts, TX, sigma_cutoff, term_eps)
    assert_rows_close(leaf.grad[..., :-1, :, :], want[..., :-1, :, :],
                      GRAD_REL, what)
    assert not leaf.grad[..., -1, :, :].any(), what   # the pad row
    return out.detach(), leaf.grad, ct


@pytest.mark.parametrize("ts", [1, 4, 7, 8, 12, 16, 20, 28, 32])
@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k3_every_tile_size(dev, ts, sigma_cutoff, term_eps):
    """K3f and K3b at every tile size the reference renders up to 32: K1's
    8 × 4 warp rectangles with the pixels past the tile masked."""
    args = [torch.as_tensor(a, device=dev) for a in k3_inputs(ts=ts)]
    _, grad, _ = k3_check(dev, args, ts, sigma_cutoff, term_eps, f"ts {ts}")
    # an empty tile and entries past a count get nothing
    assert not grad[0, 2].any() and not grad[0, 1, :, 100:].any()


@pytest.mark.parametrize("Km", [128, 640, 2048])
@pytest.mark.parametrize("shared", [False, True])
def test_k3_list_capacities(dev, Km, shared):
    """K3 in both payload modes at list capacities of 1, 5 and 16 chunks
    (counts past the capacity at 128)."""
    make = k3_shared_inputs if shared else k3_inputs
    args = [torch.as_tensor(a, device=dev) for a in make(Km=Km)]
    k3_check(dev, args, TS, 3.0, 1e-4, f"Km {Km}, shared {shared}")


@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k3b_shared_atomics_against_float64(dev, sigma_cutoff, term_eps):
    """The shared mode's gradient, summed over envs and slots into each
    tile's row by atomicAdd, against the plain backward in float64, on
    tiles named by up to 3 envs at once."""
    args = [torch.as_tensor(a, device=dev) for a in k3_shared_inputs()]
    out, grad, ct = k3_check(dev, args, TS, sigma_cutoff, term_eps,
                             "shared")
    exact = composite_single.composite_sel_single_bwd_plain(
        *as_float64(args[:1]), *args[1:], ct.double(), TS, TX, sigma_cutoff,
        term_eps)
    assert_rows_close(grad[:K_T], exact[:K_T], GRAD_REL,
                      "K3b shared vs float64")
    assert not grad[2].any()                  # the empty tile


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
        launched = launch_counts("composite_sel_single",
                                 "composite_sel_single_bwd")
        _, loss, flags, grads = entry.rollout_loss_and_grads(
            rollout, g.scene, states, actions)
        res[str(d)] = (loss, flags, grads)
        if d == dev:
            assert launch_counts("composite_sel_single",
                                 "composite_sel_single_bwd") == \
                (launched[0] + 2, launched[1] + 2)
    assert res["cuda"][1].tolist() == res["cpu"][1].tolist()
    torch.testing.assert_close(res["cuda"][0].cpu(), res["cpu"][0],
                               rtol=1e-5, atol=0)
    assert_fields_close(res["cuda"][2], res["cpu"][2],
                        GRAD_REL)


def test_k4_kernel_matches_plain(dev):
    args = [torch.as_tensor(a, device=dev) for a in k4_inputs()]
    before = profiling.launches["composite_pair"]
    out = composite_pair.composite_pair(*args, TS, TX, 3.0, 1e-4)
    torch.cuda.synchronize()
    assert profiling.launches["composite_pair"] == before + 1
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
    before = profiling.launches["composite_pair_bwd"]
    (out * ct).sum().backward()
    torch.cuda.synchronize()
    assert profiling.launches["composite_pair_bwd"] == before + 1
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
        launched = launch_counts("composite_pair", "composite_pair_bwd")
        _, imgs, n_trunc = step(prep(g.scene), g.scene, states, actions)
        _, loss, _, grads = entry.loss_and_grads(prep, step, g.scene, states,
                                                 actions)
        res[str(d)] = (imgs, n_trunc, loss, grads)
        if d == dev:
            assert launch_counts("composite_pair", "composite_pair_bwd") == \
                (launched[0] + 2, launched[1] + 1)
    torch.testing.assert_close(res["cuda"][0].cpu(), res["cpu"][0], atol=1e-4,
                               rtol=0)
    assert res["cuda"][1].tolist() == res["cpu"][1].tolist()
    torch.testing.assert_close(res["cuda"][2].cpu(), res["cpu"][2],
                               rtol=1e-5, atol=0)
    assert_fields_close(res["cuda"][3], res["cpu"][3],
                        GRAD_REL)


@pytest.mark.parametrize("ts", [8, 12, 16, 32])
@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k1_env_axis(dev, ts, sigma_cutoff, term_eps):
    """K1f and K1b over (B, T, 10, K) in one launch each: against the plain
    versions, and each env's out, carries, chunk_acc and gradient equal to
    K1 run on that env alone, bit for bit (block t takes tile t % T)."""
    B = 3
    ins = [k1_case_inputs(ts, seed=4 + b) for b in range(B)]
    args = [torch.as_tensor(np.stack([a[i] for a in ins]), device=dev)
            for i in range(3)]
    before = launch_counts("composite_static", "composite_static_bwd")
    out, car, chunk_acc = composite.composite_static_fwd(
        *args, ts, TX, sigma_cutoff, term_eps)
    ct = torch.as_tensor(np.random.default_rng(ts + 1).normal(
        size=tuple(out.shape)).astype(np.float32), device=dev)
    got = composite.composite_static_bwd(*args, ct, out, car, ts, TX,
                                         sigma_cutoff, term_eps,
                                         chunk_acc=chunk_acc)
    torch.cuda.synchronize()
    assert launch_counts("composite_static", "composite_static_bwd") == \
        (before[0] + 1, before[1] + 1)
    want, want_car = composite.composite_static_plain(*args, ts, TX,
                                                      sigma_cutoff, term_eps)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=0)
    torch.testing.assert_close(car, want_car, atol=2e-5, rtol=0)
    assert_rows_close(got, composite.composite_static_bwd_plain(
        *args, ct, ts, TX, sigma_cutoff, term_eps), GRAD_REL, "batched K1b")
    for b in range(B):
        one = [a[b] for a in args]
        o, c, acc = composite.composite_static_fwd(*one, ts, TX, sigma_cutoff,
                                                   term_eps)
        g = composite.composite_static_bwd(*one, ct[b], o, c, ts, TX,
                                           sigma_cutoff, term_eps,
                                           chunk_acc=acc)
        assert torch.equal(o, out[b]) and torch.equal(c, car[b])
        assert torch.equal(acc, chunk_acc[b]) and torch.equal(g, got[b])


def test_k1_padded_route_on_card(dev):
    """A list capacity that is not a multiple of 128 (200): the lists are
    padded to 256 with zero-opacity entries and K1 runs without the early
    stop, on the card as on the CPU."""
    from sim_a_splat_torch.ops import rasterize_tiles as tiles
    from sim_a_splat_torch.ops.projection import Camera
    from sim_a_splat_torch.ops.transforms import SE3
    from sim_a_splat_torch.splat import loaders
    res = {}
    for d in ("cpu", dev):
        scene = loaders.synthetic_scene(300, seed=1, extent=0.8,
                                        scale_range=(0.03, 0.12), device=d)
        cam = Camera.from_fov(SE3(torch.tensor([1.0, 0, 0, 0], device=d),
                                  torch.tensor([0.0, 0.0, -3.0], device=d)),
                              0.8, 40, 28)
        shift = torch.tensor([[[0.0, 0, 0]], [[0.1, -0.05, 0.2]]], device=d)
        seen = []
        real = composite.composite_static

        def spy(*a):
            seen.append((tuple(a[0].shape), a[-1]))
            return real(*a)

        composite.composite_static = spy
        try:
            launched = profiling.launches["composite_static"]
            res[str(d)] = tiles.rasterize_raw(
                scene.means + shift, scene.quats, scene.log_scales,
                scene.colors_dc(), scene.opacities(), cam,
                torch_raster(tile_capacity=200))
        finally:
            composite.composite_static = real
        assert seen == [((2, 6, 10, 256), None)]   # padded, no early stop
        if d == dev:
            assert profiling.launches["composite_static"] == launched + 1
    (img_g, aux_g), (img_c, aux_c) = res["cuda"], res["cpu"]
    torch.testing.assert_close(img_g.cpu(), img_c, atol=5e-5, rtol=0)
    torch.testing.assert_close(aux_g.alpha.cpu(), aux_c.alpha, atol=5e-5,
                               rtol=0)
    assert aux_g.tile_counts.tolist() == aux_c.tile_counts.tolist()


def test_uncached_step_on_card_matches_cpu(dev):
    """``entry.make_step`` forward and in training on the card (K1f, K1b
    over the B·T tiles) against its CPU path."""
    res = {}
    for d in ("cpu", dev):
        leaves = entry.build_scene_numpy(256, 64, 32, seed=0, sh_degree=3)
        g = entry.graph_from_numpy(leaves, device=d)
        step, P = entry.make_step(g, 64, 64, torch_raster(tile_capacity=1024),
                                  device=d)
        vec = np.asarray([[120, 200, 149, 256, 0.3],
                          [60, 400, 180, 300, -1.0],
                          [200, 100, 120, 150, 2.0]], np.float32)
        states = pusht.set_state(P, torch.as_tensor(vec, device=d))
        actions = torch.as_tensor([[149.0, 256.0], [170.0, 290.0],
                                   [150.0, 150.0]], device=d)
        launched = launch_counts("composite_static", "composite_static_bwd")
        _, imgs = step(g.scene, states, actions)
        _, loss, _, grads = entry.loss_and_grads(None, step, g.scene, states,
                                                 actions)
        res[str(d)] = (imgs, loss, grads)
        if d == dev:
            assert launch_counts("composite_static",
                                 "composite_static_bwd") == \
                (launched[0] + 2, launched[1] + 1)
    torch.testing.assert_close(res["cuda"][0].cpu(), res["cpu"][0], atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(res["cuda"][1].cpu(), res["cpu"][1],
                               rtol=1e-5, atol=0)
    got, want = res["cuda"][2], res["cpu"][2]
    assert not bool(got.sh_rest.any()) and not bool(want.sh_rest.any())
    assert_fields_close(got._replace(sh_rest=None), want._replace(sh_rest=None),
                        GRAD_REL)


# the arm product path (entry.build_product_wrapper): 240×320, a 15 × 20
# tile grid, its capacities and the end-effector camera's near set
PRODUCT_TX, PRODUCT_T = 20, 300


@pytest.fixture(scope="module")
def product_inputs():
    """The K1, K2 and K3 arguments of a 2-frame train rollout of the arm
    product path (N = 6,000, sh3, 2 envs) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    wrapper = entry.build_product_wrapper(n_total=6000, sh_degree=3,
                                          render_size=(240, 320), device=dev)
    rollout, _, build_moving = entry.make_product_rollout(wrapper,
                                                          near_cap=2048)
    states, actions = entry.product_inputs(wrapper, 2, 2, settle=5)
    seen = {}
    kernels = {"k1": (composite, "composite_static"),
               "k2": (composite_sel, "composite_pair_sel"),
               "k3": (composite_single, "composite_sel_single")}
    real = {k: getattr(m, n) for k, (m, n) in kernels.items()}

    def capture(key):
        def wrapped(*args):
            seen.setdefault(key, tuple(
                a.detach() if torch.is_tensor(a) else a for a in args))
            return real[key](*args)
        return wrapped

    try:
        for k, (m, n) in kernels.items():
            setattr(m, n, capture(k))
        entry.product_loss_and_grads(rollout, wrapper.graph.scene, states,
                                     actions)
    finally:
        for k, (m, n) in kernels.items():
            setattr(m, n, real[k])
    with torch.no_grad():
        mc = build_moving(states)[1]
    return seen, mc


def test_k1_at_product_shapes(product_inputs):
    """K1f and K1b on the viewport's static lists, (300, 10, 1024): the
    non-square grid's tiles map to pixels as in the plain version."""
    a1 = product_inputs[0]["k1"]
    pay, counts, skip, ts, tx = a1[:5]
    assert tuple(pay.shape) == (PRODUCT_T, 10, 1024) and tx == PRODUCT_TX
    out, car, acc = composite.composite_static_fwd(*a1)
    want, want_car = composite.composite_static_plain(*a1)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=0)
    torch.testing.assert_close(car, want_car, atol=2e-5, rtol=0)
    ct = torch.randn(out.shape, device=out.device,
                     generator=torch.Generator(out.device).manual_seed(0))
    got = composite.composite_static_bwd(pay, counts, skip, ct, out, car,
                                         *a1[3:], chunk_acc=acc)
    assert_rows_close(got, composite.composite_static_bwd_plain(
        pay, counts, skip, ct, *a1[3:]), GRAD_REL, "K1b at 240×320")


def test_k2_at_product_shapes(product_inputs):
    """K2f and K2b on each env's 256 selected tiles of 300, dynamic lists of
    256 entries, against the plain versions."""
    a2 = product_inputs[0]["k2"]
    spay, dpay, ids = a2[:3]
    assert tuple(spay.shape) == (PRODUCT_T + 1, 10, 1024)
    assert tuple(dpay.shape[1:]) == (256, 10, 256) and a2[6] == PRODUCT_TX
    out = composite_sel.composite_pair_sel(*a2)
    ref = composite_sel.composite_pair_sel_plain(*a2)
    for b in range(ids.shape[0]):
        rows = ids[b].long()
        torch.testing.assert_close(out[b, rows], ref[b, rows], atol=5e-5,
                                   rtol=1e-4)
    ct = torch.as_tensor(selected_cotangent(
        np.random.default_rng(21), ids.cpu().numpy(), tuple(out.shape)),
        device=out.device)
    gs, gd = composite_sel.composite_pair_sel_bwd(*a2[:5], ct, out, *a2[5:])
    want_s, want_d = composite_sel.composite_pair_sel_bwd_plain(
        *a2[:5], ct, *a2[5:])
    used = torch.unique(ids[ids < PRODUCT_T].long())
    assert_rows_close(gs[used], want_s[used], GRAD_REL, "K2b static")
    assert_rows_close(gd, want_d, GRAD_REL, "K2b dynamic")


def test_k3_at_product_shapes_with_near_set(product_inputs):
    """K3f and K3b on the end-effector camera's merged lists (candidates,
    dynamics and the near set re-binned every frame), (2, 301, 10, 768),
    against the plain versions."""
    a3, mc = product_inputs[0]["k3"], product_inputs[1]
    assert int((mc.near_op > 0).sum(1).min()) > 0     # the near set is on
    spay, ids, counts = a3[:3]
    assert tuple(spay.shape[1:]) == (PRODUCT_T + 1, 10, 512 + 256)
    assert a3[4] == PRODUCT_TX
    out = composite_single.composite_sel_single_fwd(*a3, save_state=True)
    ref = composite_single.composite_sel_single_plain(*a3, save_state=True)
    torch.testing.assert_close(out[:, :PRODUCT_T, :5], ref[:, :PRODUCT_T, :5],
                               atol=2e-5, rtol=0)
    assert torch.equal(out[:, :PRODUCT_T, 5], ref[:, :PRODUCT_T, 5])
    ct = torch.zeros_like(ref)
    ct[:, :PRODUCT_T, :5] = torch.as_tensor(np.random.default_rng(22).normal(
        size=(spay.shape[0], PRODUCT_T, 5, ref.shape[-1])).astype(np.float32),
        device=out.device)
    got = composite_single.composite_sel_single_bwd(*a3[:3], ct, out,
                                                    *a3[3:])
    want = composite_single.composite_sel_single_bwd_plain(*a3[:3], ct,
                                                           *a3[3:])
    assert_rows_close(got[:, :PRODUCT_T], want[:, :PRODUCT_T], GRAD_REL,
                      "K3b at 240×320")


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
@pytest.mark.parametrize("B,contiguous", [(1, False), (8, False), (8, True)])
def test_r1_matches_plain(dev, B, contiguous, degree):
    """Kernel R1 against the plain reprojection on the card at the
    end-effector camera's shapes (T = 300, Kc = 512), its edge cases
    included (candidates behind the near plane, det ≤ 0 and NaN, pads at
    opacity 0, footprints exactly on tile borders): every payload row but
    the colours, and the key, bit for bit; the colours within 1e-6; the
    survivors' counts equal; one launch."""
    cache, cam, cfg = reproject_case_inputs(B, seed=10 + degree,
                                            contiguous=contiguous, device=dev)
    (before,) = launch_counts("reproject_candidates")
    with torch.no_grad():
        got = rasterize_moving.reproject_candidates(cache, cam, degree, cfg,
                                                    sort=False)
        want = rasterize_moving._reproject_plain(cache, cam, degree, cfg)
    assert launch_counts("reproject_candidates") == (before + 1,)
    gap = assert_r1_matches_plain(got, want)
    live = float((want[0][:, :, 9] > 0).float().mean())
    print(f"R1 B={B} degree {degree}: colours max|Δ| {gap:.3e}, "
          f"{live:.3f} of the candidates survive")


def test_render_moving_batch_on_r1_matches_plain(dev):
    """One teleop-shaped step of the arm product path (N = 6,000, both
    cameras at 240×320, 8 envs) with the end-effector camera's
    reprojection on R1 against the same step on the plain reprojection:
    the end-effector camera's images within 1e-5 (only the colours may
    differ, by ulps), the viewport's images and the render counters equal,
    one R1 launch against none."""
    w = entry.build_product_wrapper(n_total=6000, sh_degree=3,
                                    render_size=(240, 320), device=dev)
    _, step, build_moving = entry.make_product_rollout(w)
    states, actions = entry.product_inputs(w, 8, 1, settle=5)
    with torch.no_grad():
        caches = w.build_render_cache()
        mc = build_moving(states)
        (before,) = launch_counts("reproject_candidates")
        got = step(states, actions[0], caches, mc)
        assert launch_counts("reproject_candidates") == (before + 1,)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(rasterize_moving, "_on_kernel", lambda *a: False)
            want = step(states, actions[0], caches, mc)
        assert launch_counts("reproject_candidates") == (before + 1,)
    eef, view = got.obs["camera_0"], got.obs["camera_1"]
    gap = float((eef - want.obs["camera_0"]).abs().max())
    print(f"end-effector camera on R1: max|Δ| {gap:.3e}, mean "
          f"{float(eef.mean()):.4f}")
    torch.testing.assert_close(eef, want.obs["camera_0"], atol=1e-5, rtol=0)
    assert torch.equal(view, want.obs["camera_1"])
    assert float(eef.std()) > 0.01
    for k in ("render_overflow", "render_truncated"):
        assert torch.equal(got.info[k], want.info[k]), k


def test_asset_wrapper_cameras_on_k1(dev, tmp_path):
    """The splat env built from asset files (``envs/splat_assets.py``) on a
    ``build_demo_assets`` tree, the demo scripts' two cameras at 240×320:
    both images through K1 (one launch a camera) against K1's plain
    version, atol 1e-4 (chip_smoke's bound of a render against its plain
    path)."""
    from pathlib import Path
    from chip_smoke import ASSET_HOME, ASSET_JOINT_CONFIG, ASSET_RES
    from sim_a_splat_torch.envs.manipulator_envs import ManipulatorEnvF
    from sim_a_splat_torch.envs.splat_assets import SplatAssets
    from sim_a_splat_torch.examples.common import camera_setup
    from sim_a_splat_torch.physics import kinematics as kin
    from sim_a_splat_torch.tools.demo_assets import build_demo_assets
    desc = Path(__file__).resolve().parent.parent / "robot_description"
    urdf = desc / "pusharm6" / "urdf" / "pusharm6.urdf"
    paths = build_demo_assets(tmp_path, urdf, joint_config=np.asarray(
        ASSET_JOINT_CONFIG, np.float32))
    env = ManipulatorEnvF(chain=kin.load_chain(urdf), eef_link="push_tool",
                          device=str(dev))
    assets = SplatAssets.load(env, paths["assets"],
                              paths["match_object_name"],
                              paths["splat_config_name"],
                              paths["task_assets_path"],
                              paths["task_assets_name"],
                              package_path=str(desc))
    wrapper = assets.configure_cameras(camera_setup(ASSET_RES,
                                                    paths["assets"]))
    state, _ = env.reset(reset_to_state={"robot_pos": ASSET_HOME})
    draw = env.draw_state(state)
    before = profiling.launches["composite_static"]
    with torch.no_grad():
        got = wrapper.render(None, draw)
        torch.cuda.synchronize()
        assert profiling.launches["composite_static"] == before + 2
        real = composite.composite_static
        composite.composite_static = composite.composite_static_plain
        try:
            want = wrapper.render(None, draw)
        finally:
            composite.composite_static = real
    for a, b in zip(got, want):
        assert a.shape == (1, 240, 320, 3) and float(a.max()) > 0.05
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


def _train_inputs(device, n=600, res=64):
    """``benchmarks/train_scene.py``'s protocol at a small N and 64² on
    ``device``: its config, raster, camera 0 and the ground truth's render
    from it; the scene to train is another ``synthetic_scene`` (random
    rotations, anisotropic scales: the protocol's degraded init is
    isotropic, and its quats' gradient is 0 in exact arithmetic)."""
    from sim_a_splat_torch.splat import loaders, train
    gt, _, cams, cfg, raster = entry.train_scene_inputs(
        n=n, views=2, res=res, iters=10, device=device)
    image = torch.as_tensor(train.render_view(gt, cams[0], raster,
                                              device=device), device=device)
    start = loaders.synthetic_scene(n // 2, seed=5, extent=0.9,
                                    scale_range=(0.02, 0.06), sh_degree=1,
                                    device=device)
    return start, cams[0], image, cfg, raster


def test_k1_at_train_shapes(dev):
    """K1f and K1b on the trainer's lists (``train_scene.py``'s full
    width: the 12,000-gaussian ground truth, camera 0, 64 tiles of 16² at
    K = 512 with ``term_eps`` 1e-4) against their plain versions: out and
    carries atol 2e-5, the gradient's rows within 2e-4 of their largest."""
    from sim_a_splat_torch.splat import train
    gt, _, cams, _, raster = entry.train_scene_inputs(device=dev)
    seen = []
    real = composite.composite_static
    composite.composite_static = lambda *a: seen.append(a) or real(*a)
    try:
        train.render_view(gt, cams[0], raster, device=dev)
    finally:
        composite.composite_static = real
    (a1,) = seen
    pay, counts = a1[0], a1[1]
    assert tuple(pay.shape) == (64, 10, 512) and a1[5:] == (3.0, 1e-4)
    assert int(counts.max()) > 128            # several chunks a tile
    out, car, chunk_acc = composite.composite_static_fwd(*a1)
    want, want_car = composite.composite_static_plain(*a1)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=0)
    torch.testing.assert_close(car, want_car, atol=2e-5, rtol=0)
    ct = torch.as_tensor(np.random.default_rng(21).normal(
        size=tuple(out.shape)).astype(np.float32), device=dev)
    got = composite.composite_static_bwd(*a1[:3], ct, out, car, *a1[3:],
                                         chunk_acc=chunk_acc)
    assert_rows_close(got, composite.composite_static_bwd_plain(
        *a1[:3], ct, *a1[3:]), GRAD_REL, "K1b at the train shapes")


def test_splat_train_step_on_card_matches_cpu(dev):
    """One ``splat/train.py`` step (L1 + SSIM, K1f and K1b on the card)
    against the same step on the CPU path: the loss rtol 1e-5 (float32
    math libraries of two devices), each field's gradient and ‖∇means‖
    within 2e-4 of their largest, the updated scene within 1e-2 × its
    group's learning rate (``test_torch_train.py``'s bound of one Adam
    step)."""
    from sim_a_splat_torch.splat import train
    out = {}
    for d in (dev, torch.device("cpu")):
        init, cam, image, cfg, raster = _train_inputs(d)
        params = train.parameters(init)
        step = train.make_train_step(cfg, raster,
                                     train.make_optimizer(cfg, params))
        before = launch_counts("composite_static", "composite_static_bwd")
        _, loss, gnorm = step(params, cam, image)
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert launch_counts("composite_static",
                                 "composite_static_bwd") == \
                (before[0] + 1, before[1] + 1)
        grads = type(params)(*(None if p is None else p.grad.cpu()
                               for p in params))
        out[d.type] = (float(loss), gnorm.cpu(), grads,
                       type(params)(*(None if p is None else p.detach().cpu()
                                      for p in params)))
    (l_k, n_k, g_k, s_k), (l_p, n_p, g_p, s_p) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(l_k, l_p, rtol=1e-5)
    assert_fields_close(g_k, g_p, GRAD_REL)
    assert float((n_k - n_p).abs().max()) <= GRAD_REL * float(n_p.max())
    lrs = dict(means=cfg.lr_means, quats=cfg.lr_quats,
               log_scales=cfg.lr_scales, logit_opacities=cfg.lr_opacities,
               sh_dc=cfg.lr_sh_dc, sh_rest=cfg.lr_sh_rest)
    for name, lr in lrs.items():
        err = float((getattr(s_k, name) - getattr(s_p, name)).abs().max())
        assert err <= 1e-2 * lr, f"{name}: {err} > 1e-2 × {lr}"


def test_sharded_render_on_card_matches_single_device(dev):
    """The prim-sharded render on 2 gloo ranks of this card (the exchange
    and the all-gather on CUDA tensors, K1f/K1b on the owned rows) against
    the single-device ``rasterize`` on the card: the image atol 1e-4 and
    the gradient of sum(img²) to the means, on each rank, within 2e-4 of
    its largest.  The send capacity holds every shard's whole list, so no
    shard truncates."""
    import torch_ranks
    from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig, rasterize
    from sim_a_splat_torch.parallel import launch
    from sim_a_splat_torch.splat.loaders import synthetic_scene
    s = synthetic_scene(3000, seed=4, extent=0.9, scale_range=(0.02, 0.06),
                        device="cpu")
    scene = {"means": s.means.numpy(), "covs": s.covs().numpy(),
             "colors": s.colors_dc().numpy(),
             "opacities": s.opacities().numpy()}
    cam = ((1.0, 0.0, 0.0, 0.0), (0.0, 0.0, -3.0), 0.8, 64, 64)
    raster = dict(tile_capacity=1024, sigma_cutoff=3.0)
    res = launch(torch_ranks.sharded_render, 2, "gloo", "cuda", scene, cam,
                 raster, 1024, 2, True, "cuda", timeout_s=300)
    t = {k: torch.as_tensor(v, device=dev) for k, v in scene.items()}
    means = t["means"].clone().requires_grad_()
    img, aux = rasterize(means, t["covs"], t["colors"], t["opacities"],
                         torch_ranks._camera(cam, dev), RasterConfig(**raster))
    assert int(aux.n_overflowed_tiles) == 0
    (g,) = torch.autograd.grad(torch.sum(img ** 2), means)
    img, g = img.detach().cpu().numpy(), g.cpu().numpy()
    for r in res:
        np.testing.assert_allclose(r["img"], img, atol=1e-4, rtol=0)
        assert np.abs(r["grad_means"] - g).max() <= GRAD_REL * np.abs(g).max()


# --- the pushT control step's kernel ---------------------------------------

PUSHT_PARAMS = {"default": {}, "friction_damping": dict(friction=0.5,
                                                        damping=0.9),
                "cog_override": dict(block_cog=(3.0, 40.0))}
GOLDENS = pathlib.Path(__file__).parent / "assets" / "pusht_goldens.npz"


def _pusht_gaps(got, want, what):
    """max|Δ| of each state field, printed, and held to the port's physics
    tolerances."""
    gaps = {n: float((g - w).abs().max()) if g.numel() else 0.0
            for n, g, w in zip(pusht.PushTState._fields, got, want)}
    print(what, "max|Δ|", gaps)
    for n, gap in gaps.items():
        tol = 0.0 if n == "n_contacts" else 1e-4 if n == "block_angle" \
            else 1e-3
        assert gap <= tol, f"{what}: {n} max|Δ| {gap} > {tol}"
    return gaps


def _pusht_inputs(dev, B, seed):
    rng = np.random.default_rng(seed)
    vec = pusht_case_vectors(rng, B)
    return (torch.as_tensor(vec, device=dev),
            torch.as_tensor(pusht_case_actions(rng, vec), device=dev))


@pytest.mark.parametrize("params", list(PUSHT_PARAMS))
@pytest.mark.parametrize("B", [1, 128, 1000])
def test_pusht_kernel_matches_plain(dev, B, params):
    """One control step of B envs (the last block of 32 ragged at 1,000)
    through the kernel, one launch, against the plain path on the card:
    states with the agent inside the T, at a face tie and an edge tie,
    the T against the walls, no contact, and random resets."""
    P = pusht.PushTParams(**PUSHT_PARAMS[params])
    vec, actions = _pusht_inputs(dev, B, seed=B)
    states = pusht.set_state(P, vec)
    before = profiling.launches["pusht_step"]
    got = pusht.control_step(P, states, actions)
    torch.cuda.synchronize()
    assert profiling.launches["pusht_step"] == before + 1
    want = pusht.control_step_plain(P, states, actions)
    _pusht_gaps(got, want, f"control_step B={B} {params}")
    if B > 1:
        assert int(want.n_contacts.sum()) > 0           # contacts exercised


@pytest.mark.parametrize("legacy", [False, True])
def test_pusht_set_state_kernel_matches_plain(dev, legacy, monkeypatch):
    """``set_state``'s settling substep (no action) is one kernel launch,
    against the plain substep on the card."""
    P = pusht.PushTParams()
    vec, _ = _pusht_inputs(dev, 128, seed=7)
    before = profiling.launches["pusht_step"]
    got = pusht.set_state(P, vec, legacy=legacy)
    torch.cuda.synchronize()
    assert profiling.launches["pusht_step"] == before + 1
    monkeypatch.setattr(pusht, "substep", pusht.substep_plain)
    want = pusht.set_state(P, vec, legacy=legacy)
    assert profiling.launches["pusht_step"] == before + 1
    _pusht_gaps(got, want, f"set_state legacy={legacy}")


def test_pusht_goldens_through_the_kernel(dev):
    """The committed golden trajectories' starts and actions: the plain
    path steps each trajectory on the card, and from every state of it
    the kernel's control step is held to the plain one."""
    goldens = np.load(GOLDENS)
    contacts = 0
    for name in ("push_stem", "rotate_crossbar", "wall_pin", "legacy_push",
                 "cog_override"):
        cog = tuple(float(c) for c in goldens[f"{name}/block_cog"]) \
            if name == "cog_override" else None
        P = pusht.PushTParams(block_cog=cog)
        state = pusht.set_state(
            P, torch.as_tensor(goldens[f"{name}/start"][None],
                               dtype=torch.float32, device=dev),
            legacy=bool(goldens[f"{name}/legacy"]))
        for k, a in enumerate(goldens[f"{name}/actions"]):
            action = torch.as_tensor(a[None], dtype=torch.float32, device=dev)
            want = pusht.control_step_plain(P, state, action)
            _pusht_gaps(pusht.control_step(P, state, action), want,
                        f"{name} step {k}")
            contacts += int(want.n_contacts.sum())
            state = want
    assert contacts > 0


def test_pusht_kernel_launches_and_gradient(dev):
    """One launch a control step; an action that requires grad (grad mode
    on) takes the plain path, is left unchanged, and gets the plain path's
    gradient; under no_grad the same call launches the kernel."""
    P = pusht.PushTParams()
    st = pusht.set_state(P, torch.tensor([[80.0, 310.0, 149.0, 256.0, 0.0]],
                                         device=dev))
    act = torch.tensor([[140.0, 310.0]], device=dev)
    before = profiling.launches["pusht_step"]
    s = st
    for _ in range(3):
        s = pusht.control_step(P, s, act)
    assert profiling.launches["pusht_step"] == before + 3

    action = act.clone().requires_grad_()
    r, _ = pusht.reward_done(P, pusht.control_step(P, st, action))
    assert profiling.launches["pusht_step"] == before + 3
    (g,) = torch.autograd.grad(r.sum(), action)
    a2 = act.clone().requires_grad_()
    r2, _ = pusht.reward_done(P, pusht.control_step_plain(P, st, a2))
    (g2,) = torch.autograd.grad(r2.sum(), a2)
    assert torch.equal(action.detach(), act)
    assert bool(torch.isfinite(g).all())
    # the same plain computation twice; its backward sums with atomics
    torch.testing.assert_close(g, g2, rtol=1e-5, atol=0)
    with torch.no_grad():
        pusht.control_step(P, st, action)
    assert profiling.launches["pusht_step"] == before + 4


def test_pusht_substep_kernel_adds_to_n_contacts(dev):
    """``pusht.substep`` on the card adds its contacts to the state's
    ``n_contacts``, as the plain substep does (the kernel itself counts
    from 0)."""
    P = pusht.PushTParams()
    vec, actions = _pusht_inputs(dev, 64, seed=8)
    states = pusht.set_state(P, vec)
    states = states._replace(n_contacts=torch.arange(
        64, dtype=torch.float32, device=dev))
    got = pusht.substep(P, states, actions)
    want = pusht.substep_plain(P, states, actions)
    _pusht_gaps(got, want, "substep")
    assert bool((got.n_contacts >= states.n_contacts).all())


def test_pusht_kernel_is_tied_to_its_span_by_the_profiler(dev):
    """The profiler links the kernel to the operator that launched it,
    ``sim_a_splat::pusht_step``, so the device time of a span around the
    call holds it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    P = pusht.PushTParams()
    vec, actions = _pusht_inputs(dev, 128, seed=9)
    states = pusht.set_state(P, vec)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("probe"):
            pusht.control_step(P, states, actions)
        torch.cuda.synchronize()
    linked = [k for e in prof.events() if e.device_type == DeviceType.CPU
              and e.name == "sim_a_splat::pusht_step"
              for k in e.kernels if "pusht_step" in k.name]
    assert linked, "the operator holds no pusht_step kernel"
    us = sum(k.duration for k in linked)
    print(f"pusht_step linked to a host event: {len(linked)} record(s), "
          f"{us:.1f} us")
    assert us > 0


def test_pusht_kernel_rejects_inputs(dev):
    """CUDA inputs the kernel does not take raise; nothing falls back."""
    P = pusht.PushTParams()
    st = pusht.set_state(P, torch.tensor([[80.0, 310.0, 149.0, 256.0, 0.0]] * 2,
                                         device=dev))
    act = torch.tensor([[140.0, 310.0]], device=dev)
    with pytest.raises(ValueError, match="non-contiguous"):
        pusht.control_step(P, st, act.expand(2, 2))
    with pytest.raises(ValueError, match="float64"):
        pusht.control_step(P, st, act.repeat(2, 1).double())


# --- the arm's control-step kernel P2 -----------------------------------

ARM_STEPS = 64


def _arm_env(dev, **kw):
    """The arm product path's env (pusharm6 pushing the T) on ``dev``."""
    from sim_a_splat_torch.envs.manipulator_envs import ManipulatorEnvF
    from sim_a_splat_torch.physics import kinematics as kin
    return ManipulatorEnvF(chain=kin.load_chain(entry.PRODUCT_URDF),
                           eef_link="push_tool", device=str(dev), **kw)


def _arm_start(env, dev, B, start, steps=ARM_STEPS):
    """(state, (steps, B, 6) actions): the cells' reset settled 40 steps
    by the plain path, then their dither (``"settled"``); or the end
    effector pressing into, beside and away from the T
    (``arm_case_inputs``, ``"contact"``)."""
    if start == "settled":
        state, _ = env.reset(reset_to_state=entry.PRODUCT_RESET, batch=B)
        base = torch.tensor(entry.PRODUCT_ACTION, device=dev)
        for _ in range(40):
            state = env.step_plain(state, base.expand(B, 6)).state
        t = torch.arange(steps, device=dev)
        phase = torch.sin(2 * np.pi * t / 32)
        pattern = torch.tensor([0.0, 1.0, -1.0, 0.0, 1.0, 0.0], device=dev)
        actions = (base + 0.004 * phase[:, None] * pattern)[:, None]
        return state, actions.expand(steps, B, 6).contiguous()
    reset, actions = arm_case_inputs(env, B, steps,
                                     np.random.default_rng(B + 11))
    state, _ = env.reset(reset_to_state=reset, batch=B)
    return state, torch.as_tensor(actions, device=dev)


def _arm_gaps(got, want, what):
    """max|Δ| of every field of two arm transitions, printed; the state,
    reward and flags held equal, the info within 1e-5."""
    def gap(a, b):
        return float((a.float() - b.float()).abs().max()) if a.numel() \
            else 0.0
    state = {n: gap(a, b) for n, a, b in zip(
        ("q", "qd", "target_prev"), got.state.arm, want.state.arm)}
    state.update((n, gap(getattr(got.state, n), getattr(want.state, n)))
                 for n in got.state._fields[1:])
    state.update((n, gap(getattr(got, n), getattr(want, n)))
                 for n in ("reward", "terminated", "truncated"))
    info = {k: gap(got.info[k], want.info[k]) for k in want.info}
    print(what, "max|Δ| state", state, "info", info)
    assert list(got.info) == list(want.info)
    assert not any(state.values()), f"{what}: {state}"
    assert max(info.values()) <= 1e-5, f"{what}: {info}"
    return state, info


@pytest.mark.parametrize("start", ["settled", "contact"])
@pytest.mark.parametrize("B", [1, 8])
def test_arm_kernel_matches_plain(dev, B, start):
    """64 chained control steps through P2, one launch each, at B = 1 and
    B = 8, from the cells' settled reset under their dither and from the
    end effector pressing into the T: every step against ``step_plain``
    on the card from the same state, the state, reward and flags bit for
    bit, the info within 1e-5."""
    env = _arm_env(dev)
    state, actions = _arm_start(env, dev, B, start)
    pushed = 0.0
    with torch.no_grad():
        for k, a in enumerate(actions):
            before = profiling.launches["arm_step"]
            got = env.step(state, a)
            assert profiling.launches["arm_step"] == before + 1
            _arm_gaps(got, env.step_plain(state, a), f"B={B} {start} {k}")
            pushed = max(pushed, float(got.state.block_vel.abs().max()))
            state = got.state
    if start == "contact":
        assert pushed > 0                                 # contacts solved


def test_arm_kernel_other_chains_and_settings(dev):
    """P2 on pusharm5 and on a welded pushscara3 (a prismatic joint) with
    every scalar of the task changed, and without the T-block, against
    ``step_plain`` on the card over 16 chained steps of 40 envs."""
    from sim_a_splat_torch.envs.manipulator_envs import ManipulatorEnvF
    from sim_a_splat_torch.physics import kinematics as kin
    root = pathlib.Path(__file__).resolve().parent.parent
    cases = {
        "pusharm5": dict(),
        "pushscara3": dict(
            weld=((0.9659258, 0.0, 0.0, 0.258819), (0.1, -0.2, 0.05)),
            time_step=2e-2, kp=60.0, kd=15.0, eef_radius=0.02,
            contact_substeps=3, contact_bias=0.3, contact_slop=2e-4),
        "pusharm6": dict(env_objects=False)}
    for robot, kw in cases.items():
        chain = kin.load_chain(root / "robot_description" / robot / "urdf"
                               / f"{robot}.urdf")
        env = ManipulatorEnvF(chain=chain, eef_link="push_tool",
                              device=str(dev), **kw)
        reset, actions = arm_case_inputs(env, 40, 16,
                                         np.random.default_rng(5))
        state, _ = env.reset(reset_to_state=reset, batch=40)
        with torch.no_grad():
            for k, a in enumerate(torch.as_tensor(actions, device=dev)):
                got = env.step(state, a)
                _arm_gaps(got, env.step_plain(state, a), f"{robot} {k}")
                state = got.state


def test_arm_kernel_launches_and_gradient(dev):
    """One ``arm_step`` launch a step; an action that requires grad (grad
    mode on) takes the plain path and gets its gradient; under no_grad the
    same call launches P2."""
    env = _arm_env(dev)
    state, actions = _arm_start(env, dev, 8, "contact", steps=4)
    before = profiling.launches["arm_step"]
    s = state
    for a in actions[:3]:
        s = env.step(s, a).state
    assert profiling.launches["arm_step"] == before + 3
    act = actions[3].clone().requires_grad_()
    out = env.step(state, act)
    assert profiling.launches["arm_step"] == before + 3
    (g,) = torch.autograd.grad(out.state.block_pos.sum(), act)
    assert bool(torch.isfinite(g).all())
    with torch.no_grad():
        env.step(state, act)
    assert profiling.launches["arm_step"] == before + 4


# one collect-shaped arm step under a profiler, in a process of its own:
# prints the device µs of each arm_step kernel linked to the operator
_ARM_PROFILE_PROBE = """
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from sim_a_splat_torch import entry
from sim_a_splat_torch.envs.manipulator_envs import ManipulatorEnvF
from sim_a_splat_torch.physics import kinematics as kin
env = ManipulatorEnvF(chain=kin.load_chain(entry.PRODUCT_URDF),
                      eef_link="push_tool", device="cuda")
state, _ = env.reset(reset_to_state=entry.PRODUCT_RESET, batch=8)
action = torch.tensor(entry.PRODUCT_ACTION, device="cuda").expand(8, 6)
with torch.no_grad():
    state = env.step(state, action).state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("physics"):
            env.step(state, action)
        torch.cuda.synchronize()
print(*(k.duration for e in prof.events() if e.device_type == DeviceType.CPU
        and e.name == "sim_a_splat::arm_step"
        for k in e.kernels if "arm_step" in k.name))
"""


def test_arm_kernel_is_tied_to_its_span_by_the_profiler(dev):
    """The profiler links P2 to the operator that launched it,
    ``sim_a_splat::arm_step``, and so to the ``physics`` span around the
    call: the harness's ``physics_device_ms.arm_*`` read it.  In a process
    of its own: a profiler session late in a process that has run others
    may keep no device records (seen on the card in this file)."""
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "-c", _ARM_PROFILE_PROBE],
                         cwd=pathlib.Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    linked = [float(us) for us in out.stdout.split()]
    assert len(linked) == 1, "the operator holds no arm_step kernel"
    print(f"arm_step linked to a host event: {linked[0]:.1f} us")
    assert linked[0] > 0


# one pushT datagen step, one train step and one arm collect step under a
# profiler, with the program's spans on, in a process of its own: prints, by
# the innermost of the spans below around each host event that launched
# kernels (as the benchmark's harness attributes them), each kernel's device
# µs, and for each kernel the host events the profiler links it to
_RENDER_PROFILE_PROBE = """
import collections, json
import torch
from torch.profiler import ProfilerActivity, profile
from sim_a_splat_torch import entry
from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
from sim_a_splat_torch.physics import pusht
from sim_a_splat_torch.utils import profiling
SPANS = ("render.prepare", "render.select", "step.backward", "render.moving")
graph = entry.build_scene(n_bg=2000, n_block=400, n_agent=150, seed=0,
                          sh_degree=3, device="cuda")
raster = RasterConfig(tile_size=16, tile_capacity=256,
                      max_tiles_per_gaussian=16, sigma_cutoff=3.0,
                      term_eps=1e-4)
prepare, step_batch, params = entry.make_step_cached_batch(
    graph, 128, 128, raster, dyn_capacity=128, sel_tiles=16,
    dyn_max_tiles=9, device="cuda")
states = pusht.reset(params, torch.Generator(device="cuda").manual_seed(0),
                     8)
actions = states.agent_pos + 5.0

arm = entry.build_product_wrapper(n_total=6000, sh_degree=3,
                                  render_size=(240, 320), device="cuda")
collect = entry.make_product_collect(arm)
arm_states, arm_actions = entry.product_inputs(arm, 2, 1, settle=5)
arm_caches = arm.build_render_cache()

def both():
    with torch.no_grad():
        step_batch(prepare(graph.scene), graph.scene, states, actions)
        collect(arm_states, arm_actions[0], arm_caches)
    entry.loss_and_grads(prepare, step_batch, graph.scene, states, actions)

both()
torch.cuda.synchronize()
profiling.enable(True)
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    both()
    torch.cuda.synchronize()
events = prof.events()
spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
         if e.name in SPANS]
out = collections.defaultdict(lambda: collections.defaultdict(float))
linked = collections.defaultdict(set)
for e in events:
    if e.kernels and not e.name.startswith("cu"):
        t = e.time_range.start
        host = [s for s in spans if s[0] <= t <= s[1]]
        for k in e.kernels:
            linked[k.name].add(e.name)
            if host:
                out[max(host)[2]][k.name] += k.duration
print(json.dumps({"by_span": out,
                  "linked": {k: sorted(v) for k, v in linked.items()}}))
"""


def test_kernels_are_tied_to_their_spans_by_the_profiler(dev):
    """The profiler links each of K1f, K2f, K2b, K1b and R1 to its own
    operator (``sim_a_splat::composite_static`` …), and so ties K1f and K2f
    to the render spans around them (``render.prepare``,
    ``render.select``), K2b and K1b to ``step.backward`` and R1 to
    ``render.moving`` (inside the arm's ``render.cameras``), as it ties P1
    and P2 to ``physics``: the device time the benchmark reads under a
    span holds them.  In a process of its own (see the arm's profiler
    test)."""
    import json
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "-c", _RENDER_PROFILE_PROBE],
                         cwd=pathlib.Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.splitlines()[-1])
    by_span = got["by_span"]
    for span, kernels in by_span.items():
        print(span, {k[:40]: round(us, 1) for k, us in kernels.items()
                     if "composite" in k or "reproject" in k})
    for span, names in (
            ("render.prepare", (("composite_static_chunks",
                                 "composite_static"),
                                ("composite_static_combine",
                                 "composite_static"))),
            ("render.select", (("composite_pair_sel_fwd",
                                "composite_pair_sel"),)),
            ("step.backward", (("composite_pair_sel_bwd",
                                "composite_pair_sel_bwd"),
                               ("composite_static_bwd",
                                "composite_static_bwd"))),
            ("render.moving", (("reproject_candidates",
                                "reproject_candidates"),))):
        for name, op in names:
            us = sum(v for k, v in by_span.get(span, {}).items()
                     if name in k)
            assert us > 0, f"no {name} kernel under {span}"
            hosts = {h for k, v in got["linked"].items() if name in k
                     for h in v}
            print(name, "linked to", sorted(hosts))
            assert f"sim_a_splat::{op}" in hosts, (name, hosts)


@pytest.mark.parametrize("chain", ["links", "joints"])
def test_arm_chain_past_the_caps_takes_the_plain_path(dev, chain, tmp_path):
    """A chain past P2's caps (a 9th link, a 7th joint) steps on the card
    through ``step_plain``, as the reference steps any chain: the plain
    step's results bit for bit over 4 chained steps of 8 envs, and no
    ``arm_step`` launch."""
    from sim_a_splat_torch.envs.manipulator_envs import ManipulatorEnvF
    env = ManipulatorEnvF(chain=arm_chain_past_caps(chain, tmp_path),
                          eef_link="push_tool", device=str(dev))
    reset, actions = arm_case_inputs(env, 8, 4, np.random.default_rng(3))
    state, _ = env.reset(reset_to_state=reset, batch=8)
    before = profiling.launches["arm_step"]
    with torch.no_grad():
        for k, a in enumerate(torch.as_tensor(actions, device=dev)):
            got = env.step(state, a)
            _arm_gaps(got, env.step_plain(state, a), f"{chain} {k}")
            state = got.state
    assert profiling.launches["arm_step"] == before


def test_arm_kernel_rejects_inputs(dev):
    """CUDA inputs P2 does not take raise; nothing falls back."""
    env = _arm_env(dev)
    state, actions = _arm_start(env, dev, 4, "contact", steps=1)
    with pytest.raises(ValueError, match="float64"):
        env.step(state, actions[0].double())
    with pytest.raises(ValueError, match="non-contiguous"):
        env.step(state, actions[0].t().contiguous().t())


# the arm deployment's collect step (entry.make_product_collect) at the
# product shapes, held to the benchmark's plain reference
# (perfbench/reference/pusharm.py) by the cell's own check and limits
ARM_CELLS = {1: "teleop_b1", 8: "datagen_b8"}


@pytest.mark.parametrize("B", sorted(ARM_CELLS))
def test_collect_step_at_product_shapes_matches_the_reference(dev, B):
    """Both cameras of B envs through a few collect steps at N = 100k and
    240×320 (episodes of 4 steps at B = 8, so the episode's build and its
    rebuilds both run), then the cell's check: states, images, the
    rebuild decisions and the severe and bounded counts against the plain
    reference, each within the configuration's limit."""
    import json

    from perfbench.harness import bench as harness
    from perfbench.systems import pusharm

    root = pathlib.Path(__file__).resolve().parent.parent / "perfbench"
    cfg = harness.load_config("pusharm6_100k_sh3")
    mix = json.loads((root / "traffic" / f"{ARM_CELLS[B]}.json").read_text())
    mix.update(settle=10, window_phase=2,
               check={"steps": 2, "before": 6, "envs": B})
    mix["walk"] = dict(mix["walk"], steps=4 if B > 1 else 32)
    system = pusharm.System(cfg, mix, 2190000017, dev)
    for _ in range(7):
        system.step()
    steps_severe, severe = system.counters()
    system.release()
    got = dict(system.check(), severe=severe)
    print(f"B={B}: {got}")
    for k in pusharm.READINGS:
        assert got[k] <= cfg["limits"][k], (k, got[k], cfg["limits"][k])


def test_collect_step_spans_and_rebuild_counter_on_card(dev):
    """One traced collect step at an episode's start records the root
    ``step.arm`` with the physics' and the cameras' spans under it (the
    physics one launch of P2 in ``physics.solve``), and the counters
    ``render.moving_rebuilds``, ``arm_step`` (1) and
    ``reproject_candidates`` (one a ``render.moving`` call) in its step."""
    from sim_a_splat_torch.utils import profiling

    w = entry.build_product_wrapper(n_total=6000, sh_degree=3,
                                    render_size=(240, 320), device=dev)
    collect = entry.make_product_collect(w)
    states, actions = entry.product_inputs(w, 2, 1, settle=5)
    caches = w.build_render_cache()
    was = profiling.enabled()
    profiling.clear()
    profiling.enable(True)
    try:
        with torch.no_grad():
            tr, mc = collect(states, actions[0], caches)
        torch.cuda.synchronize()
        (root,) = profiling.roots("step.arm")
        events = [c for c in profiling.counter_events()
                  if c.name == "render.moving_rebuilds"]
        arm = [c for c in profiling.counter_events()
               if c.name == "arm_step"]
        r1 = [c for c in profiling.counter_events()
              if c.name == "reproject_candidates"]
    finally:
        profiling.enable(was)
        profiling.clear()
    for name in ("physics", "render.cameras", "render.moving",
                 "render.moving_build", "render.k2f", "render.k3f"):
        assert root.calls.get(name, 0) >= 1, (name, root.calls)
    # on the card the physics is one launch of P2 in one physics.solve
    assert root.calls["physics.solve"] == 1
    assert "physics.arm" not in root.calls
    assert "physics.info" not in root.calls
    assert [e.step for e in events] == [root.step]
    assert events[0].value == int(tr.info["render_rebuilt"].sum())
    assert [(e.step, e.value) for e in arm] == [(root.step, 1)]
    # the end-effector camera's reprojection: one R1 launch a render
    assert [(e.step, e.value) for e in r1] == [
        (root.step, root.calls["render.moving"])]


def test_splatfacto_step_past_the_old_binning_guard(dev):
    """One ``splat.train.Trainer`` step at 400,000 SH-3 gaussians and
    1600×900 (5,700 tiles: (T+1)·N past 2^31, which the binning refused
    before) runs through K1f and K1b, one launch each, and matches the
    benchmark's plain splatfacto step (``perfbench/reference/
    splatfacto.py``, in bands of tile rows) on the same inputs: nothing
    cut on either side; the image within 0.025 (a pixel whose α sits at
    the 3σ cutoff or the 1/255 floor switches on one side alone, by up to
    e^-4.5 ≈ 0.0111 of a colour each), the loss rtol 2e-3 (K1f's early
    stop at ``term_eps`` 1e-4 leaves out what the reference composites
    past it, in every opaque tile), each field's gradient within 0.1 of
    its largest (a switched pixel moves a small gaussian's gradient by its
    own share)."""
    import json
    from perfbench.reference import splatfacto as ref
    from perfbench.reference.splatfacto_scene import orbit, scenes
    from perfbench.systems.splatfacto import FIELDS, train_config
    from sim_a_splat_torch.ops.projection import Camera
    from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
    from sim_a_splat_torch.ops.transforms import SE3
    from sim_a_splat_torch.splat import train
    from sim_a_splat_torch.splat.scene import GaussianScene
    cfg = json.loads((pathlib.Path(__file__).resolve().parents[1]
                      / "perfbench/configs/splatfacto_1m_sh3_1600.json")
                     .read_text())
    cfg["n_gaussians"] = 400_000
    gt, init = scenes(cfg, 41, torch.Generator(device=dev).manual_seed(41))
    v = orbit(cfg, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    cam = Camera(SE3(v.q[7], v.center[7]), *(torch.tensor(x, **f32) for x in
                                            (v.fx, v.fy, v.cx, v.cy)),
                 v.width, v.height)
    raster = RasterConfig(
        tile_size=cfg["tile_size"], tile_capacity=cfg["tile_capacity"],
        max_tiles_per_gaussian=cfg["max_tiles_per_gaussian"],
        sigma_cutoff=cfg["sigma_cutoff"], term_eps=cfg["term_eps"],
        buckets=tuple(tuple(b) for b in cfg["buckets"]))
    T = -(-v.width // cfg["tile_size"]) * -(-v.height // cfg["tile_size"])
    assert (T + 1) * cfg["n_gaussians"] >= 2**31
    target = torch.as_tensor(train.render_view(
        GaussianScene(**gt), cam, raster, device=dev), device=dev)
    tr = train.Trainer(GaussianScene(**init), train_config(cfg), raster,
                       start_step=15000, device=dev)
    live = tr.scene
    before = launch_counts("composite_static", "composite_static_bwd")
    loss = tr.step(cam, target)
    torch.cuda.synchronize()
    assert launch_counts("composite_static", "composite_static_bwd") == \
        (before[0] + 1, before[1] + 1)
    assert int(tr.aux.n_overflowed_tiles) == int(tr.aux.n_slot_truncated) == 0
    want = ref.step(init, ref.camera(v.q[7], v.center[7], v.fx, v.fy, v.cx,
                                     v.cy, v.width, v.height), target,
                    ref.raster_of(cfg), cfg["sh_degree"], cfg["ssim_lambda"],
                    cfg["background"])
    assert want.overflowed == want.slot_truncated == 0
    gap = float((tr.image - want.image).abs().max())
    print(f"image {gap:.3e} loss {float(loss):.6f} {float(want.loss):.6f}")
    assert gap <= 0.025
    np.testing.assert_allclose(float(loss), float(want.loss), rtol=2e-3)
    for k, p in zip(FIELDS, live):
        g = want.grads[k]
        rel = float((p.grad - g).abs().max()) / float(g.abs().max())
        print(f"{k}: gradient gap {rel:.3e} of its largest")
        assert rel <= 0.1, k
