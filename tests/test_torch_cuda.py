"""Kernels K1f, K1b, K2f, K2b, K3f and K3b on the card against their plain
versions, and the port's step, train step and moving-camera rollout on the
card against its CPU path.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
False (decided inside the fixture, never at import).  This file imports no
JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda.py -p no:cacheprovider -n 0

Tolerances: the kernel and the plain version compute every alpha with the
same float32 operations (no contraction into FMAs, the same ``expf``), so
they differ only in how transmittance products and colour sums are
accumulated — sequentially per pixel in the kernel, by ``cumprod`` or in
log space in the plain versions: atol 2e-5 for K1f, atol 5e-5 / rtol 1e-4
for K2f (the CPU tests' bounds against the reference), atol 2e-5 for K3f
(K1's walk on per-env lists).  Gradients: each
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
    K_T, K_TS, K_TX, assert_rows_close, k1_inputs, k2_inputs, k3_inputs,
    selected_cotangent, torch_raster,
)

from sim_a_splat_torch import entry
from sim_a_splat_torch.ops import composite, composite_sel, composite_single
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
    out, car = composite.composite_static(*args, TS, TX, sigma_cutoff,
                                          term_eps)
    ct = torch.as_tensor(np.random.default_rng(10).normal(
        size=tuple(out.shape)).astype(np.float32), device=dev)
    before = composite.launches_bwd
    got = composite.composite_static_bwd(*args, ct, out, car, TS, TX,
                                         sigma_cutoff, term_eps)
    torch.cuda.synchronize()
    assert composite.launches_bwd == before + 1
    want = composite.composite_static_bwd_plain(*args, ct, TS, TX,
                                                sigma_cutoff, term_eps)
    assert_rows_close(got, want, GRAD_REL, "K1b")
    assert not got[5].any() and not got[2].any()    # skipped, empty tiles
    assert not got[3, :, 130:].any()                # past the count


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
    gs, gd = composite_sel.composite_pair_sel_bwd_slots(
        *args, ct, out, TS, TX, sigma_cutoff, term_eps)
    g_spay, g_dpay = composite_sel.composite_pair_sel_bwd(
        *args, ct, out, TS, TX, sigma_cutoff, term_eps)
    torch.cuda.synchronize()
    assert composite_sel.launches_bwd == before + 2
    want_s, want_d = composite_sel.composite_pair_sel_bwd_plain(
        *args, ct, TS, TX, sigma_cutoff, term_eps)
    assert_rows_close(g_spay[:K_T], want_s[:K_T], GRAD_REL,
                      "K2b static, per tile")
    assert_rows_close(g_dpay, want_d, GRAD_REL, "K2b dynamic")
    # per slot: pads are zero; the per-tile sum is the slots' sum
    assert not gs[:, 3].any() and not gd[:, 3].any()
    assert not g_spay[K_T].any()
    torch.testing.assert_close(
        g_spay, torch.zeros_like(g_spay).index_add_(
            0, ids.reshape(-1).long(), gs.reshape(-1, *gs.shape[2:])))


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
    for name, got, want in zip(res["cpu"][1]._fields, res["cuda"][1],
                               res["cpu"][1]):
        got = got.cpu()
        assert torch.isfinite(got).all(), name
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        assert err <= GRAD_REL * scale, \
            f"{name}: max|Δ| {err:.3e} > {GRAD_REL} × {scale:.3e}"


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
    for name, got, want in zip(res["cpu"][2]._fields, res["cuda"][2],
                               res["cpu"][2]):
        got = got.cpu()
        assert torch.isfinite(got).all(), name
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        assert err <= GRAD_REL * scale, \
            f"{name}: max|Δ| {err:.3e} > {GRAD_REL} × {scale:.3e}"
