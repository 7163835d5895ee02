"""The per-env fixed-camera step (kernel K4) against the JAX reference, on
the CPU.

(a) ``composite_pair_plain`` against ``composite_pallas_pair`` (Pallas
interpret mode), env by env, on tile lists with depth ties between the two
lists, counts past both capacities, empty lists, nearly opaque tiles and
pairs with skip 0: outputs atol 2e-5 with rtol 1e-4, K2's relative bound
(both use the same log-space algebra, but sum it in other orders: Hillis-
Steele lane scans and XLA's dot against torch's cumsum and bmm, measured
up to 2.6e-5 on rgb values near 0.5); the depth channel, up to 5 × the
alpha sum, at the same bounds relative to the largest depth.

(b) ``composite_pair_bwd_plain`` against ``jax.vjp`` of the Pallas kernel
(the static gradient summed over the envs, as the reference's vmap does),
with the bounds of ``test_torch_grad.py``'s K2 case: 2e-3 × each row's
largest reference gradient, since the reference's float32 suffix sums
(s_tot − prefix, divided by 1 − α ≥ 1e-3) cancel on the nearly opaque
tiles, and 2e-4 against the plain version run in float64.

(c) ``merge_sorted_lists`` against the reference's: the merged order and
counts exactly, with ties and +inf pads.

(d) The fused (K4) and unfused (merge + K1) branches of the port's
``rasterize_with_cache`` agree, as the reference's do
(``test_pallas_pair.py``): atol 2e-5 without early stop, 2e-4 with it.

(e) ``entry.make_step_cached`` against ``jax.vmap`` of the reference's
``_make_step_cached`` step, with ``static_skip`` True and False: images
atol 5e-5, states as ``test_torch_slice.py`` holds them.

(f) The train step: ``entry.loss_and_grads`` through ``make_step_cached``
against ``jax.value_and_grad`` of ``mean(imgs ** 2)`` through the
reference's vmapped step, all six scene fields within 1e-4 × each field's
largest reference gradient, the loss to rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import (
    K_T, K_TS, K_TX, as_float64, assert_fields_close, assert_rows_close,
    graph_leaves, jax_pusht_states, jax_raster, k4_inputs, np_of,
    random_state_vectors, torch_raster,
)

import __graft_entry__ as graft
from sim_a_splat_tpu.ops import rasterize_cached as jcached
from sim_a_splat_tpu.ops.pallas_composite_pair import composite_pallas_pair

from sim_a_splat_torch import entry
from sim_a_splat_torch.ops import composite, composite_pair, rasterize_cached
from sim_a_splat_torch.physics import pusht

SETTINGS = [(3.0, 1e-4), (None, None)]
P = K_TS * K_TS


def _ref_pair(spay, dpay, cs, cd, skip, sigma_cutoff, term_eps):
    """The reference K4 forward, one env at a time → (B, T, P, 8)."""
    return np.stack([np_of(composite_pallas_pair(
        jnp.asarray(spay), jnp.asarray(dpay[b]), jnp.asarray(cs),
        jnp.asarray(cd[b]), jnp.asarray(skip[b]), K_TS, K_TX, sigma_cutoff,
        True, term_eps)) for b in range(len(dpay))])


@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k4_plain_matches_pallas(sigma_cutoff, term_eps):
    spay, dpay, cs, cd, skip = k4_inputs()
    ref = _ref_pair(spay, dpay, cs, cd, skip, sigma_cutoff, term_eps)
    got, applied, _ = composite_pair.composite_pair_plain(
        *(torch.as_tensor(a) for a in (spay, dpay, cs, cd, skip)), K_TS,
        K_TX, sigma_cutoff, term_eps, return_work=True)
    got = np_of(got)
    assert got.shape == (2, K_T, P, 8)
    rows = [0, 1, 2, 4]
    np.testing.assert_allclose(got[..., rows], ref[..., rows], atol=2e-5,
                               rtol=1e-4)
    dscale = float(np.abs(spay[:, 8]).max())
    np.testing.assert_allclose(got[..., 3] / dscale, ref[..., 3] / dscale,
                               atol=2e-5, rtol=1e-4)
    # skipped pairs emit the empty composite, whatever their lists hold
    off = skip == 0
    assert off[1, 3] and cd[1, 3] > 0
    np.testing.assert_array_equal(got[off], np.broadcast_to(
        np.asarray([0, 0, 0, 0, 1, 0, 0, 0], np.float32), got[off].shape))
    if term_eps is not None:   # the opaque static tile stopped early
        assert 0 < int(applied[0, 4]) < spay.shape[-1] // composite.CHUNK


@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k4_bwd_plain_matches_pallas(sigma_cutoff, term_eps):
    spay, dpay, cs, cd, skip = k4_inputs()
    B = dpay.shape[0]
    ct = np.random.default_rng(12).normal(
        size=(B, K_T, P, 8)).astype(np.float32)
    ct[skip == 0] = 0.0     # the select against the static composite
    ref_s = np.zeros_like(spay)
    ref_d = np.zeros_like(dpay)
    for b in range(B):
        _, vjp = jax.vjp(lambda s, d: composite_pallas_pair(
            s, d, jnp.asarray(cs), jnp.asarray(cd[b]), jnp.asarray(skip[b]),
            K_TS, K_TX, sigma_cutoff, True, term_eps),
            jnp.asarray(spay), jnp.asarray(dpay[b]))
        g_s, g_d = vjp(jnp.asarray(ct[b]))
        ref_s += np_of(g_s)
        ref_d[b] = np_of(g_d)
    args = [torch.as_tensor(a) for a in (spay, dpay, cs, cd, skip, ct)]
    got_s, got_d = (np_of(g) for g in composite_pair.composite_pair_bwd_plain(
        *args, K_TS, K_TX, sigma_cutoff, term_eps))
    assert_rows_close(got_s, ref_s, 2e-3, "K4 static grad")
    assert_rows_close(got_d, ref_d, 2e-3, "K4 dynamic grad")
    exact_s, exact_d = (np_of(g) for g in composite_pair.composite_pair_bwd_plain(
        *as_float64(args), K_TS, K_TX, sigma_cutoff, term_eps))
    assert_rows_close(got_s, exact_s, 2e-4, "K4 static grad vs float64")
    assert_rows_close(got_d, exact_d, 2e-4, "K4 dynamic grad vs float64")
    assert_rows_close(ref_s, exact_s, 2e-3,
                      "reference K4 static grad vs float64")
    # skipped pairs, empty lists and entries past a count get nothing
    assert not got_d[skip == 0].any() and not got_s[2].any()
    assert not got_d[0, 0, :, 40:].any() and got_d[0, 0, :, :40].any()


def _cache_of(pay, counts):
    """A reference TileCache from a (T, 10, K) payload."""
    f = np.swapaxes(pay, 1, 2)
    return jcached.TileCache(jnp.asarray(f[..., 0:2]), jnp.asarray(f[..., 2:5]),
                             jnp.asarray(f[..., 5:8]), jnp.asarray(f[..., 9]),
                             jnp.asarray(f[..., 8]), jnp.asarray(counts))


def test_merge_sorted_lists_matches_reference():
    spay, dpay, cs, cd, _ = k4_inputs(seed=4)
    merged, counts = rasterize_cached.merge_sorted_lists(
        *(torch.as_tensor(a) for a in (spay, cs, dpay, cd)))
    merged = np_of(merged)
    for b in range(dpay.shape[0]):
        ref = jcached.merge_sorted_lists(_cache_of(spay, cs),
                                         _cache_of(dpay[b], cd[b]))
        want = np.swapaxes(np.concatenate(
            [np_of(ref.gxy), np_of(ref.gconic), np_of(ref.gcol),
             np_of(ref.gdepth)[..., None], np_of(ref.gop)[..., None]],
            axis=-1), 1, 2)
        np.testing.assert_array_equal(merged[b], want)
        np.testing.assert_array_equal(np_of(counts[b]), np_of(ref.counts))
    # ties put the static entry first; the active entries lead each list
    key = np.where(merged[..., 9, :] > 0, merged[..., 8, :], np.inf)
    assert (key[..., 1:] >= key[..., :-1]).all()


def _small_render_inputs(seed):
    g = entry.build_scene(256, 64, 32, seed=seed, sh_degree=0, device="cpu")
    st = g.scene.select(np.arange(256))
    dyn = g.scene.select(np.arange(256, 352))
    B, Nd = 2, dyn.means.shape[0]
    shift = torch.tensor([[[0.0, 0.0, 0.0]], [[9.0, -7.0, 0.0]]])
    return (st, dyn.means + torch.tensor([100.0, 250.0, 0.0]) + shift,
            dyn.quats.expand(B, Nd, 4), dyn.log_scales.expand(B, Nd, 3),
            dyn.colors_dc().expand(B, Nd, 3), dyn.opacities().expand(B, Nd))


@pytest.mark.parametrize("term_eps", [None, 1e-4])
def test_fused_matches_merged_render(term_eps):
    st, *dyn = _small_render_inputs(seed=2)
    cam = entry._fixed_camera(64, 64, torch.device("cpu"))
    cfg = torch_raster(term_eps=term_eps)
    cache = rasterize_cached.build_tile_cache_raw(
        st.means, st.quats, st.log_scales, st.colors_dc(), st.opacities(),
        cam, cfg)
    tol = 2e-5 if term_eps is None else 2e-4
    for scomp in (None, rasterize_cached.build_static_composite(cache, cam,
                                                                cfg)):
        launched = composite_pair.launches
        img_f, aux_f = rasterize_cached.rasterize_with_cache(
            cache, scomp, *dyn, cam, cfg, background=torch.ones(3))
        img_m, aux_m = rasterize_cached.rasterize_with_cache(
            cache, scomp, *dyn, cam, cfg._replace(fused_pair=False),
            background=torch.ones(3))
        assert composite_pair.launches == launched     # CPU: plain versions
        assert img_f.shape == (2, 64, 64, 3)
        np.testing.assert_allclose(np_of(img_f), np_of(img_m), atol=tol,
                                   rtol=1e-4)
        for a, b in zip(aux_f, aux_m):
            np.testing.assert_array_equal(np_of(a), np_of(b))
        assert int(aux_f.tile_counts[:, :].gt(0).sum()) > 0


W = H = 64
STEP_KW = dict(dyn_capacity=128, dyn_max_tiles=9)


def _reference_step(graph, static_skip):
    jprep, jstep, _ = graft._make_step_cached(graph, W, H, jax_raster(),
                                              static_skip=static_skip,
                                              **STEP_KW)

    def step(scene, states, actions):
        cache = jprep(scene)
        return jax.vmap(lambda s, a: jstep(cache, scene, s, a))(states,
                                                                actions)
    return step


def _inputs(seed, B=3):
    rng = np.random.default_rng(seed)
    graph = graft._build_scene(n_bg=256, n_block=64, n_agent=32, seed=seed,
                               sh_degree=3)
    vectors = random_state_vectors(rng, B)
    actions = (vectors[:, 2:4] + rng.normal(0, 10, (B, 2))).astype(np.float32)
    jstates, snp = jax_pusht_states(vectors)
    g = entry.graph_from_numpy(graph_leaves(graph), device="cpu")
    return (graph, jstates, g, pusht.state_from_numpy(snp, device="cpu"),
            actions)


@pytest.mark.parametrize("static_skip", [True, False])
def test_step_matches_reference(static_skip):
    graph, jstates, g, states, actions = _inputs(seed=static_skip + 0)
    jns, jimgs = jax.jit(_reference_step(graph, static_skip))(
        graph.scene, jstates, jnp.asarray(actions))
    prep, step, _ = entry.make_step_cached(
        g, W, H, torch_raster(), static_skip=static_skip, device="cpu",
        **STEP_KW)
    ns, imgs, n_trunc = step(prep(g.scene), g.scene, states,
                             torch.as_tensor(actions))
    assert imgs.shape == (3, H, W, 3) and n_trunc.shape == (3,)
    for name in ("agent_pos", "block_pos", "agent_vel", "block_vel"):
        np.testing.assert_allclose(np_of(getattr(ns, name)),
                                   np_of(getattr(jns, name)), atol=1e-3,
                                   err_msg=name)
    np.testing.assert_allclose(np_of(ns.block_angle), np_of(jns.block_angle),
                               atol=1e-4)
    np.testing.assert_array_equal(np_of(ns.n_contacts), np_of(jns.n_contacts))
    np.testing.assert_allclose(np_of(imgs), np_of(jimgs), atol=5e-5)


def test_train_step_grads_match_reference():
    graph, jstates, g, states, actions = _inputs(seed=1, B=2)
    jstep = _reference_step(graph, True)

    def jloss(scene):
        _, imgs = jstep(scene, jstates, jnp.asarray(actions))
        return jnp.mean(imgs ** 2)

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(graph.scene)
    prep, step, _ = entry.make_step_cached(g, W, H, torch_raster(),
                                           device="cpu", **STEP_KW)
    _, loss, _, grads = entry.loss_and_grads(prep, step, g.scene, states,
                                             torch.as_tensor(actions))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert_fields_close(grads, jgrads, 1e-4)


def test_function_backward_on_cpu():
    """The Function's CPU backward is autograd through the plain forward;
    no kernel launches; the forward-only call builds no graph."""
    spay, dpay, cs, cd, skip = (torch.as_tensor(a) for a in k4_inputs(5))
    ct = torch.as_tensor(np.random.default_rng(13).normal(
        size=(2, K_T, P, 8)).astype(np.float32))
    launched = (composite_pair.launches, composite_pair.launches_bwd)
    leaves = (spay.clone().requires_grad_(), dpay.clone().requires_grad_())
    out = composite_pair.composite_pair(*leaves, cs, cd, skip, K_TS, K_TX,
                                        3.0, 1e-4)
    assert type(out.grad_fn).__name__ == "CompositePairBackward"
    (out * ct).sum().backward()
    plain = (spay.clone().requires_grad_(), dpay.clone().requires_grad_())
    want = torch.autograd.grad(composite_pair.composite_pair_plain(
        *plain, cs, cd, skip, K_TS, K_TX, 3.0, 1e-4), plain, ct)
    for got, w in zip((leaves[0].grad, leaves[1].grad), want):
        torch.testing.assert_close(got, w, atol=0, rtol=0)
    with torch.no_grad():
        out_ng = composite_pair.composite_pair(*leaves, cs, cd, skip, K_TS,
                                               K_TX)
    assert out_ng.grad_fn is None and not out_ng.requires_grad
    assert (composite_pair.launches, composite_pair.launches_bwd) == launched


def test_wrappers_check_inputs():
    spay, dpay, cs, cd, skip = (torch.as_tensor(a) for a in k4_inputs())
    with pytest.raises(ValueError, match="skip"):
        composite_pair.composite_pair(spay, dpay, cs, cd, skip[0], K_TS, K_TX)
    with pytest.raises(ValueError, match="dpay"):
        composite_pair.composite_pair(spay, dpay[0], cs, cd, skip, K_TS, K_TX)
    out = composite_pair.composite_pair(spay, dpay, cs, cd, skip, K_TS, K_TX)
    with pytest.raises(ValueError, match="ct"):
        composite_pair.composite_pair_bwd(spay, dpay, cs, cd, skip,
                                          out[..., :5], out, K_TS, K_TX)

