"""Gradients of the port against the JAX reference, on the CPU.

(a) ``composite_static_bwd_plain`` against ``jax.vjp`` of
``composite_pallas`` (Pallas interpret mode, the reference's K1b).  Each of
the 10 payload rows is held to 1e-4 × that row's largest reference
gradient (measured ≤ 2.4e-5).  The cotangent is random on every pixel, and
the nearly opaque tile sends alphas toward the 0.999 clamp.  The
reference's suffix sums (s_tot − prefix) then cancel in float32 and are
divided by 1 − α ≥ 1e-3; autograd through the plain forward does no such
subtraction.

(b) ``composite_pair_sel_bwd_plain`` against ``jax.vjp`` of
``composite_pair_sel`` (interpret mode, the reference's K2b and its
per-tile sum), with the cotangent nonzero only on selected rows.  The
bound is 2e-3 × each row's largest reference gradient: on these inputs the
reference's own float32 suffix sums are off by up to 7.1e-4 of a row's
scale against the plain version run in float64 (checked here at 2e-3),
while the plain float32 version matches float64 to 5.5e-5 (checked at
2e-4).  (a) checks the plain float32 version against float64 too, at
1e-4.

(b') K2's per-env mode (a (B, T+1, 10, Ks) static payload): with the
reference's dense ids, the plain backward against ``jax.vjp`` of the
reference's 4-D mode at (b)'s bounds; with ids out of tile order, the
port scatters slot i's static gradient to row ``ids[b, i]`` (the true
gradient, held to float64 at 2e-4), where the reference places it at row
i: re-indexed by slot, the reference's gradient is the port's at (b)'s
bound.

(c) Both autograd Functions on CPU tensors: ``.backward()`` gives exactly
what ``torch.autograd.grad`` through the plain forward gives (it is that
computation), launches no kernel, and the forward-only call records no
graph.

(d) The whole train step: ``entry.loss_and_grads`` (device="cpu") against
``jax.value_and_grad`` of ``mean(imgs ** 2)`` through the reference's
``_make_step_cached_batch`` (Pallas interpret mode), for all six scene
fields, seeds 0 and 1.  Each field is held to 1e-4 × its largest reference
gradient; the loss to rtol 1e-5.  Here the cotangent is the loss's own,
small and smooth, and the two agree to ~4e-6 of each field's scale.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import (
    K_T, K_TS, K_TX, as_float64, assert_fields_close, assert_rows_close,
    graph_leaves, jax_pusht_states, jax_raster, k1_inputs, k2_full_dyn_inputs,
    k2_inputs, k2_per_env_inputs, np_of, random_state_vectors, rows_rel_err,
    selected_cotangent, tile_lists, torch_raster,
)

import __graft_entry__ as graft
from sim_a_splat_tpu.ops import pallas_composite as jk1
from sim_a_splat_tpu.ops.pallas_composite_sel import composite_pair_sel as jk2

from sim_a_splat_torch import entry
from sim_a_splat_torch.ops import composite, composite_sel
from sim_a_splat_torch.physics import pusht
from sim_a_splat_torch.utils import profiling

SETTINGS = [(3.0, 1e-4), (None, None)]


@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k1_bwd_plain_matches_pallas(sigma_cutoff, term_eps):
    pay, counts, skip = k1_inputs()
    ct = np.random.default_rng(10).normal(
        size=(K_T, K_TS * K_TS, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jk1.composite_pallas(
        p, jnp.asarray(counts), jnp.asarray(skip), K_TS, K_TX, sigma_cutoff,
        True, term_eps), jnp.asarray(pay))
    ref = np_of(vjp(jnp.asarray(ct))[0])
    args = [torch.as_tensor(a) for a in (pay, counts, skip, ct)]
    got = np_of(composite.composite_static_bwd_plain(
        *args, K_TS, K_TX, sigma_cutoff, term_eps))
    assert_rows_close(got, ref, 1e-4, "K1 payload grad")
    exact = np_of(composite.composite_static_bwd_plain(
        *as_float64(args), K_TS, K_TX, sigma_cutoff, term_eps))
    assert_rows_close(got, exact, 1e-4, "K1 payload grad vs float64")
    # skipped tile, empty tile, and entries past a tile's count: zero
    assert not got[5].any() and not got[2].any()
    assert not got[3, :, 130:].any() and got[3, :, :130].any()
    if term_eps is not None:      # the opaque tile stopped after its chunk 0
        _, _, applied, _ = composite.composite_static_plain(
            *(torch.as_tensor(a) for a in (pay, counts, skip)), K_TS, K_TX,
            sigma_cutoff, term_eps, return_work=True)
        n = int(applied[4]) * composite.CHUNK
        assert n < pay.shape[-1] and not got[4, :, n:].any()


@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k2_bwd_plain_matches_pallas(sigma_cutoff, term_eps):
    spay, dpay, ids, cs, cd = k2_inputs()
    B = ids.shape[0]
    ct = selected_cotangent(np.random.default_rng(11), ids,
                            (B, K_T + 1, 8, K_TS * K_TS))
    _, vjp = jax.vjp(lambda s, d: jk2(
        s, d, jnp.asarray(ids), jnp.asarray(cs), jnp.asarray(cd), K_TS, K_TX,
        sigma_cutoff, True, term_eps, "split", False),
        jnp.asarray(spay), jnp.asarray(dpay))
    ref_s, ref_d = (np_of(g) for g in vjp(jnp.asarray(ct)))
    args = [torch.as_tensor(a) for a in (spay, dpay, ids, cs, cd, ct)]
    got_s, got_d = (np_of(g) for g in
                    composite_sel.composite_pair_sel_bwd_plain(
                        *args, K_TS, K_TX, sigma_cutoff, term_eps))
    assert_rows_close(got_s[:K_T], ref_s[:K_T], 2e-3, "K2 static grad")
    assert_rows_close(got_d, ref_d, 2e-3, "K2 dynamic grad")
    exact_s, exact_d = (np_of(g) for g in
                        composite_sel.composite_pair_sel_bwd_plain(
                            *as_float64(args), K_TS, K_TX, sigma_cutoff,
                            term_eps))
    assert_rows_close(got_s[:K_T], exact_s[:K_T], 2e-4,
                      "K2 static grad vs float64")
    assert_rows_close(got_d, exact_d, 2e-4, "K2 dynamic grad vs float64")
    assert_rows_close(ref_s[:K_T], exact_s[:K_T], 2e-3,
                      "reference K2 static grad vs float64")
    # pads and the unselected tile 2 get nothing; so does the trash row
    assert not got_d[:, 3].any() and not got_s[K_T].any()
    assert not got_s[2].any()
    # the real slot without dynamic entries (env 1, slot 2, tile 0) still
    # passes the gradient of its static list
    assert got_s[0].any() and cd[1, 2] == 0


def _k2_vjp(spay, dpay, ids, cs, cd, ct, sigma_cutoff, term_eps):
    """The reference's (static, dynamic) gradients of ``composite_pair_sel``
    (interpret mode) for the cotangent ``ct``."""
    _, vjp = jax.vjp(lambda s, d: jk2(
        s, d, jnp.asarray(ids), jnp.asarray(cs), jnp.asarray(cd), K_TS, K_TX,
        sigma_cutoff, True, term_eps, "split", False),
        jnp.asarray(spay), jnp.asarray(dpay))
    return tuple(np_of(g) for g in vjp(jnp.asarray(ct)))


@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k2_per_env_bwd_plain_matches_pallas(sigma_cutoff, term_eps):
    spay, dpay, ids, cs, cd = k2_per_env_inputs()
    B = ids.shape[0]
    ct = selected_cotangent(np.random.default_rng(13), ids,
                            (B, K_T + 1, 8, K_TS * K_TS))
    ref_s, ref_d = _k2_vjp(spay, dpay, ids, cs, cd, ct, sigma_cutoff,
                           term_eps)
    args = [torch.as_tensor(a) for a in (spay, dpay, ids, cs, cd, ct)]
    got_s, got_d = (np_of(g) for g in
                    composite_sel.composite_pair_sel_bwd_plain(
                        *args, K_TS, K_TX, sigma_cutoff, term_eps))
    assert got_s.shape == spay.shape == ref_s.shape
    assert_rows_close(got_s[:, :K_T], ref_s[:, :K_T], 2e-3,
                      "K2 per-env static grad")
    assert_rows_close(got_d, ref_d, 2e-3, "K2 per-env dynamic grad")
    exact_s, exact_d = (np_of(g) for g in
                        composite_sel.composite_pair_sel_bwd_plain(
                            *as_float64(args), K_TS, K_TX, sigma_cutoff,
                            term_eps))
    assert_rows_close(got_s[:, :K_T], exact_s[:, :K_T], 2e-4,
                      "K2 per-env static grad vs float64")
    assert_rows_close(got_d, exact_d, 2e-4,
                      "K2 per-env dynamic grad vs float64")
    # nothing for the trash rows, the empty static lists (env 0 tile 2,
    # env 1 tile 3) and the slots without dynamic entries
    assert not got_s[:, K_T].any()
    assert not got_s[0, 2].any() and not got_s[1, 3].any()
    assert not got_d[0, 3].any() and not got_d[1, 1].any()
    assert got_s[1, 4].any() and got_s[0, 4].any()


def test_k2_per_env_permuted_ids():
    """Per-env payloads with ids out of tile order: the port's static
    gradient is scattered by id (autograd through the plain forward, and
    the Function on CPU tensors, held to float64); the reference's places
    slot i's gradient at row i, which re-indexed by slot is the port's."""
    spay, _, _, cs, cd = k2_per_env_inputs(seed=9)
    ids = np.asarray([[3, 1, 0, 5, 2, 4], [4, 0, 2, 1, 5, 3]], np.int32)
    rng = np.random.default_rng(19)
    dpay = np.stack([tile_lists(rng, ids[b], cd[b], 128, K_TS, K_TX)
                     for b in range(2)])
    ct = selected_cotangent(rng, ids, (2, K_T + 1, 8, K_TS * K_TS))
    args = [torch.as_tensor(a) for a in (spay, dpay, ids, cs, cd, ct)]
    got_s, got_d = composite_sel.composite_pair_sel_bwd_plain(
        *args, K_TS, K_TX, 3.0, 1e-4)
    exact_s, exact_d = composite_sel.composite_pair_sel_bwd_plain(
        *as_float64(args), K_TS, K_TX, 3.0, 1e-4)
    assert_rows_close(got_s[:, :K_T], exact_s[:, :K_T], 2e-4,
                      "per-env static grad, permuted ids, vs float64")
    assert_rows_close(got_d, exact_d, 2e-4,
                      "per-env dynamic grad, permuted ids, vs float64")
    leaves = (args[0].clone().requires_grad_(),
              args[1].clone().requires_grad_())
    out = composite_sel.composite_pair_sel(*leaves, *args[2:5], K_TS, K_TX,
                                           3.0, 1e-4)
    rows = (torch.arange(2)[:, None], args[2].long())
    (out[rows] * args[5][rows]).sum().backward()
    torch.testing.assert_close(leaves[0].grad, got_s, atol=0, rtol=0)
    torch.testing.assert_close(leaves[1].grad, got_d, atol=0, rtol=0)
    ref_s, ref_d = _k2_vjp(spay, dpay, ids, cs, cd, ct, 3.0, 1e-4)
    by_slot = np_of(got_s)[np.arange(2)[:, None], ids]     # (B, TT, 10, Ks)
    assert_rows_close(by_slot, ref_s[:, :K_T], 2e-3,
                      "the reference's static grad, slot-indexed")
    assert_rows_close(np_of(got_d), ref_d, 2e-3, "the dynamic grad")
    # measured: 295.6 on the moved rows; slot-indexed within 2.3e-4
    moved = ids != np.arange(K_T)
    assert np.abs(ref_s[:, :K_T][moved]
                  - np_of(got_s)[:, :K_T][moved]).max() > 1


def test_k2_reference_suffix_sums_on_long_lists():
    """The reference's own K2b (``_call_bwd`` in interpret mode, float32
    suffix sums ``s_tot - prefix``) on the inputs of the card test
    ``test_k2_large_dyn_capacity`` at Kd 2048, ts 16 (dynamic lists of up
    to 2,048 entries), against the port's plain backward in float64.
    Measured: 6.41e-5 of a row's scale on the static gradient and 1.86e-5
    on the dynamic one (the float32 plain version: 1.04e-5 and 2.7e-6).
    This is the yardstick for the card kernels' float32 suffix sums on
    the same input, which the card test measures beside it."""
    spay, dpay, ids, cs, cd = k2_full_dyn_inputs(2048, 16)
    B, T1 = ids.shape[0], spay.shape[0]
    ct = selected_cotangent(np.random.default_rng(18), ids,
                            (B, T1, 8, K_TS * K_TS))
    _, vjp = jax.vjp(lambda s, d: jk2(
        s, d, jnp.asarray(ids), jnp.asarray(cs), jnp.asarray(cd), K_TS, K_TX,
        3.0, True, 1e-4, "split", False), jnp.asarray(spay), jnp.asarray(dpay))
    ref_s, ref_d = (np_of(g) for g in vjp(jnp.asarray(ct)))
    args = [torch.as_tensor(a) for a in (spay, dpay, ids, cs, cd, ct)]
    exact_s, exact_d = (np_of(g) for g in
                        composite_sel.composite_pair_sel_bwd_plain(
                            *as_float64(args), K_TS, K_TX, 3.0, 1e-4))
    err_s = rows_rel_err(ref_s[:T1 - 1], exact_s[:T1 - 1])
    err_d = rows_rel_err(ref_d, exact_d)
    assert 3e-5 < err_s < 1e-4 and 5e-6 < err_d < 4e-5, (err_s, err_d)


def test_functions_backward_on_cpu():
    """The Functions' CPU backward is autograd through the plain forward;
    no kernel launches; the forward-only call builds no graph."""
    pay, counts, skip = (torch.as_tensor(a) for a in k1_inputs(seed=4))
    rng = np.random.default_rng(12)
    ct = torch.as_tensor(rng.normal(size=(K_T, K_TS * K_TS, 8)).astype(
        np.float32))
    launched = profiling.launches.copy()

    leaf = pay.clone().requires_grad_()
    out, carries = composite.composite_static(leaf, counts, skip, K_TS, K_TX,
                                              3.0, 1e-4)
    assert type(out.grad_fn).__name__ == "CompositeStaticBackward"
    assert not carries.requires_grad
    (out * ct).sum().backward()
    plain = pay.clone().requires_grad_()
    out_p, _ = composite.composite_static_plain(plain, counts, skip, K_TS,
                                                K_TX, 3.0, 1e-4)
    (want,) = torch.autograd.grad(out_p, plain, ct)
    torch.testing.assert_close(leaf.grad, want, atol=0, rtol=0)
    with torch.no_grad():
        out_ng, _ = composite.composite_static(leaf, counts, skip, K_TS, K_TX,
                                               3.0, 1e-4)
    assert out_ng.grad_fn is None and not out_ng.requires_grad

    spay, dpay, ids, cs, cd = (torch.as_tensor(a) for a in k2_inputs(seed=5))
    ct2 = torch.as_tensor(selected_cotangent(
        rng, np_of(ids), (ids.shape[0], K_T + 1, 8, K_TS * K_TS)))
    rows = (torch.arange(ids.shape[0])[:, None], ids.long())
    leaves = (spay.clone().requires_grad_(), dpay.clone().requires_grad_())
    out2 = composite_sel.composite_pair_sel(*leaves, ids, cs, cd, K_TS, K_TX,
                                            3.0, 1e-4)
    assert type(out2.grad_fn).__name__ == "CompositePairSelBackward"
    (out2[rows] * ct2[rows]).sum().backward()
    plain2 = (spay.clone().requires_grad_(), dpay.clone().requires_grad_())
    out2_p = composite_sel.composite_pair_sel_plain(*plain2, ids, cs, cd,
                                                    K_TS, K_TX, 3.0, 1e-4)
    want2 = torch.autograd.grad(out2_p[rows], plain2, ct2[rows])
    for got, w in zip((leaves[0].grad, leaves[1].grad), want2):
        torch.testing.assert_close(got, w, atol=0, rtol=0)
    assert profiling.launches == launched


def test_bwd_wrappers_check_inputs():
    pay, counts, skip = (torch.as_tensor(a) for a in k1_inputs())
    ct = torch.zeros((K_T, K_TS * K_TS, 8))
    out, car = composite.composite_static(pay, counts, skip, K_TS, K_TX)
    with pytest.raises(ValueError, match="ct"):
        composite.composite_static_bwd(pay, counts, skip, ct[:, :, :5], out,
                                       car, K_TS, K_TX)
    spay, dpay, ids, cs, cd = (torch.as_tensor(a) for a in k2_inputs())
    out2 = composite_sel.composite_pair_sel(spay, dpay, ids, cs, cd, K_TS,
                                            K_TX)
    with pytest.raises(ValueError, match="CUDA"):
        composite_sel.composite_pair_sel_bwd_tiles(
            spay, dpay, ids, cs, cd, torch.zeros_like(out2), out2, K_TS, K_TX)
    # K2b's shared memory: a window of W dynamic entries and one static
    # chunk staged, the merge positions, the warps' hit words and their
    # partials of both (55 KB at the main path's Kd = 128 with 4 warps of 2
    # pixels a thread); the window is the largest that fits (896 at ts 16)
    assert composite_sel.smem_bytes(128, 16, True) == 55_936
    limit = composite_sel.SMEM_OPTIN_BYTES
    assert composite_sel._block_bytes(896, 4, True) <= limit \
        < composite_sel._block_bytes(1024, 4, True)
    assert composite_sel.window(1024, 16, True) == 896


W = H = 64
STEP_KW = dict(dyn_capacity=128, sel_tiles=8, dyn_max_tiles=9)


@pytest.mark.parametrize("seed", [0, 1])
def test_train_step_grads_match_reference(seed):
    rng = np.random.default_rng(seed)
    graph = graft._build_scene(n_bg=256, n_block=64, n_agent=32, seed=seed,
                               sh_degree=3)
    B = 3
    vectors = random_state_vectors(rng, B)
    actions = (vectors[:, 2:4] + rng.normal(0, 10, (B, 2))).astype(np.float32)
    jstates, snp = jax_pusht_states(vectors)
    jprep, jstep, _ = graft._make_step_cached_batch(graph, W, H, jax_raster(),
                                                    **STEP_KW)

    def jloss(scene):
        _, imgs, n_drop = jstep(jprep(scene), scene, jstates,
                                jnp.asarray(actions))
        return jnp.mean(imgs ** 2), n_drop

    (jl, jdrop), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        graph.scene)

    g = entry.graph_from_numpy(graph_leaves(graph), device="cpu")
    prep, step, _ = entry.make_step_cached_batch(g, W, H, torch_raster(),
                                                 device="cpu", **STEP_KW)
    _, loss, n_drop, grads = entry.loss_and_grads(
        prep, step, g.scene, pusht.state_from_numpy(snp, device="cpu"),
        torch.as_tensor(actions))

    np.testing.assert_array_equal(np_of(n_drop), np_of(jdrop))
    assert int(n_drop[0]) == 0        # the comparison is of exact renders
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert_fields_close(grads, jgrads, 1e-4)
    assert not any(f.requires_grad for f in g.scene)   # inputs untouched
