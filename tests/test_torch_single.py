"""The design of kernels K3f and K3b, through plain PyTorch twins, on the
CPU, and K3's two payload modes against the reference.

K3f composites each slot's list as K1f composites a tile's: every chunk from
transmittance 1, then the in-order combine with the early stop, recording
the applied chunks in row 5 of ``out`` and, where asked, the chunk-start
accumulators and transmittance (``state``, (B, T+1, nc, 5, P)); K3b
restarts every applied chunk (as many as row 5 says) from that state.
``k3_twin_fwd`` and ``k3_twin_bwd`` below do the same steps through K1's
twins (``test_torch_static.chunked_fwd`` / ``chunked_bwd``), with the
kernels' placement of each slot's gradient (per env: at the row its id
names; shared: summed into the tile's row over envs and slots), and are
held to the port's plain versions and to the reference's Pallas kernels in
interpret mode:

- forward: rows 0-4 atol 2e-5 against ``composite_sel_single_plain`` and
  ``pallas_composite_sel._call_single_fwd``, row 5 (applied chunks) exact;
- backward: each payload row within 1e-4 × its largest gradient against
  the plain backward run in float64 and against ``jax.vjp`` of
  ``composite_sel_single``; and the cancellation rule the kernel relies on:
  the restarted prefix meets the next chunk's saved accumulator and, at the
  last applied chunk, ``out``, bit for bit.

The reference's per-env backward places slot i's gradient at payload row i
(``pallas_composite_sel.py:525-526``), not at row ``ids[b, i]``; with ids in
tile order (its only caller's) the two agree.  The port scatters by id, the
gradient of the forward; ``test_k3_permuted_ids`` records the difference.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import (
    K_T, K_TS, K_TX, as_float64, assert_rows_close, k3_inputs,
    k3_shared_inputs, np_of,
)
from test_torch_static import chunked_bwd, chunked_fwd

from sim_a_splat_tpu.ops import pallas_composite_sel as jk3

from sim_a_splat_torch.ops import composite_single
from sim_a_splat_torch.ops.composite import CHUNK, power_min_of

SETTINGS = [(3.0, 1e-4), (None, None)]
TILE_SIZES = [8, 12, 16, 20]


def _rows(ids):
    return torch.arange(ids.shape[0])[:, None], ids.long()


def k3_twin_fwd(spay, ids, counts, ts, tx, sigma_cutoff, term_eps):
    """Twin of K3f: each slot's list through K1f's twin → out (B, T+1, 8, P)
    with the applied chunks in row 5, and state (B, T+1, nc, 5, P)."""
    B, TT = ids.shape
    T1, _, K = spay.shape[-3:]
    P, nc = ts * ts, K // CHUNK
    pay, cnt = composite_single._slot_lists(spay, counts, ids)
    res, car, chunk_acc, applied = chunked_fwd(
        pay, cnt, torch.ones_like(cnt), ts, tx, sigma_cutoff, term_eps,
        tile_ids=ids.reshape(-1))
    res[..., 5] = applied[:, None].to(res.dtype)
    bidx, rows = _rows(ids)
    out = spay.new_zeros((B, T1, 8, P))
    out[bidx, rows] = res.reshape(B, TT, P, 8).transpose(-1, -2)
    state = spay.new_zeros((B, T1, nc, 5, P))
    state[bidx, rows] = torch.cat(
        [chunk_acc, car.transpose(1, 2)[:, :, None]], dim=2).reshape(
            B, TT, nc, 5, P)
    return out, state


def k3_twin_bwd(spay, ids, counts, ct, out, state, ts, tx, sigma_cutoff):
    """Twin of K3b: each slot's applied chunks (row 5 of ``out``) restarted
    from ``state`` through K1b's twin, the gradient scattered by id (per
    env) or summed per tile (shared) → (grad, the slots' prefixes (B·TT, K,
    P, 4))."""
    B, TT = ids.shape
    bidx, rows = _rows(ids)
    pay, cnt = composite_single._slot_lists(spay, counts, ids)
    ct_s = ct[bidx, rows].flatten(0, 1).transpose(-1, -2)      # (S, P, 8)
    out_s = out[bidx, rows].flatten(0, 1).transpose(-1, -2)
    st = state[bidx, rows].flatten(0, 1)                        # (S, nc, 5, P)
    g, prefixes = chunked_bwd(
        pay, cnt, torch.ones_like(cnt), ct_s, out_s,
        st[:, :, 4].transpose(1, 2), st[:, :, :4], ts, tx, sigma_cutoff,
        None, tile_ids=ids.reshape(-1), n_applied=out_s[:, 0, 5].long())
    grad = torch.zeros_like(spay)
    if spay.dim() == 3:
        grad.index_add_(0, rows.reshape(-1), g)
    else:
        grad[bidx, rows] = g.reshape(B, TT, *g.shape[1:])
    return grad, prefixes


def reference_fwd(spay, ids, counts, ts, sigma_cutoff, term_eps):
    return np_of(jk3._call_single_fwd(
        jnp.asarray(spay), jnp.asarray(ids), jnp.asarray(counts), ts, K_TX,
        power_min_of(sigma_cutoff), True, term_eps, save_state=True))


def reference_grad(spay, ids, counts, ct, ts, sigma_cutoff, term_eps):
    _, vjp = jax.vjp(lambda s: jk3.composite_sel_single(
        s, jnp.asarray(ids), jnp.asarray(counts), ts, K_TX, sigma_cutoff,
        True, term_eps), jnp.asarray(spay))
    return np_of(vjp(jnp.asarray(ct))[0])


def named_cotangent(seed, out, ids):
    """A random cotangent on the rows ``ids`` name, zero elsewhere and on
    the pad row."""
    ct = torch.zeros_like(out)
    bidx, rows = _rows(ids)
    ct[bidx, rows] = torch.as_tensor(np.random.default_rng(seed).normal(
        size=(*ids.shape, *out.shape[2:])).astype(np.float32))
    ct[:, K_T] = 0.0
    return ct


def check_prefix_rule(prefixes, out, state, ids, counts):
    """The restarted prefix of each applied chunk's last entry equals the
    next chunk's saved accumulator, or ``out`` after the last, bit for
    bit."""
    bidx, rows = _rows(ids)
    out_s = out[bidx, rows].flatten(0, 1)                       # (S, 8, P)
    st = state[bidx, rows].flatten(0, 1)
    cnt = (counts[rows] if counts.dim() == 1
           else counts[bidx, rows]).reshape(-1)
    for s in range(out_s.shape[0]):
        n_app = int(out_s[s, 5, 0])
        for c in range(n_app):
            end = min((c + 1) * CHUNK, int(cnt[s])) - 1
            want = st[s, c + 1, :4].T if c + 1 < n_app else out_s[s, :4].T
            assert torch.equal(prefixes[s, end], want), (s, c)


@pytest.mark.parametrize("ts", TILE_SIZES)
@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k3_forward_design_matches_plain_and_pallas(ts, sigma_cutoff,
                                                    term_eps):
    spay, ids, counts = k3_inputs(ts=ts)
    args = [torch.as_tensor(a) for a in (spay, ids, counts)]
    out, state = k3_twin_fwd(*args, ts, K_TX, sigma_cutoff, term_eps)
    want, applied, _ = composite_single.composite_sel_single_plain(
        *args, ts, K_TX, sigma_cutoff, term_eps, save_state=True,
        return_work=True)
    torch.testing.assert_close(out[:, :K_T, :5], want[:, :K_T, :5],
                               atol=2e-5, rtol=0)
    assert torch.equal(out[:, :, 5], want[:, :, 5])
    ref = reference_fwd(spay, ids, counts, ts, sigma_cutoff, term_eps)
    np.testing.assert_allclose(np_of(out)[:, :K_T, :5], ref[:, :K_T, :5],
                               atol=2e-5)
    np.testing.assert_array_equal(np_of(out)[:, :K_T, 5], ref[:, :K_T, 5])
    nc = spay.shape[-1] // CHUNK
    # the opaque tiles (env 0 tile 4, env 1 tile 1) stop after chunk 0;
    # without the stop, the lists cut mid-chunk apply ceil(count / 128)
    # chunks
    assert applied[0, 4] == (1 if term_eps is not None else nc)
    assert applied[1, 1] == (1 if term_eps is not None else nc)
    if term_eps is None:
        assert applied[0].tolist()[1:4] == [1, 0, 2]
    # the saved state: chunk 0 starts from acc 0, T 1
    assert not state[:, :K_T, 0, :4].any()
    assert bool((state[:, :K_T, 0, 4] == 1).all())


@pytest.mark.parametrize("ts", TILE_SIZES)
@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k3_backward_design_matches_pallas(ts, sigma_cutoff, term_eps):
    spay, ids, counts = k3_inputs(ts=ts)
    args = [torch.as_tensor(a) for a in (spay, ids, counts)]
    out, state = k3_twin_fwd(*args, ts, K_TX, sigma_cutoff, term_eps)
    ct = named_cotangent(13, out, args[1])
    got, prefixes = k3_twin_bwd(*args, ct, out, state, ts, K_TX,
                                sigma_cutoff)
    exact = composite_single.composite_sel_single_bwd_plain(
        *as_float64([args[0]]), *args[1:], ct.double(), ts, K_TX,
        sigma_cutoff, term_eps)
    assert_rows_close(got[:, :K_T], exact[:, :K_T], 1e-4,
                      "K3b twin vs float64")
    ref = reference_grad(spay, ids, counts, np_of(ct), ts, sigma_cutoff,
                         term_eps)
    assert_rows_close(got[:, :K_T], ref[:, :K_T], 1e-4,
                      "K3b twin vs the reference")
    # entries never applied: past a count, the empty tiles, chunks after a
    # stop; the pad row
    n_app = out[:, :, 5, 0].long()
    for b in range(2):
        for t in range(K_T):
            n = min(int(n_app[b, t]) * CHUNK, int(counts[b, t]))
            assert not got[b, t, :, n:].any()
    assert not got[:, K_T].any()
    check_prefix_rule(prefixes, out, state, args[1], args[2])


@pytest.mark.parametrize("sigma_cutoff,term_eps", SETTINGS)
def test_k3_shared_mode_matches_pallas(sigma_cutoff, term_eps):
    """The shared (T+1, 10, Km) payload: tiles named by several envs and
    pad slots; the port's Function (plain on the CPU) and the kernels'
    twins against the reference's 3-D mode, forward and gradient (summed
    over envs and slots into each tile's row)."""
    spay, ids, counts = k3_shared_inputs()
    args = [torch.as_tensor(a) for a in (spay, ids, counts)]
    ref = reference_fwd(spay, ids, counts, K_TS, sigma_cutoff, term_eps)
    leaf = args[0].clone().requires_grad_()
    out = composite_single.composite_sel_single(leaf, *args[1:], K_TS, K_TX,
                                                sigma_cutoff, term_eps)
    assert out.shape == (3, K_T + 1, 8, K_TS * K_TS)
    bidx, rows = _rows(args[1])
    real = rows < K_T
    got = np_of(out.detach()[bidx, rows][real])
    want = ref[np_of(bidx.expand_as(rows)[real]), np_of(rows[real])]
    np.testing.assert_allclose(got[:, :5], want[:, :5], atol=2e-5)
    np.testing.assert_array_equal(got[:, 5], want[:, 5])
    twin, state = k3_twin_fwd(*args, K_TS, K_TX, sigma_cutoff, term_eps)
    torch.testing.assert_close(twin[bidx, rows][real][:, :5],
                               out.detach()[bidx, rows][real][:, :5],
                               atol=2e-5, rtol=0)

    ct = named_cotangent(21, out.detach(), args[1])
    (out * ct).sum().backward()
    want_g = reference_grad(spay, ids, counts, np_of(ct), K_TS, sigma_cutoff,
                            term_eps)
    assert leaf.grad.shape == spay.shape
    assert_rows_close(leaf.grad[:K_T], want_g[:K_T], 1e-4,
                      "K3 shared grad (plain) vs the reference")
    got_t, prefixes = k3_twin_bwd(*args, ct, twin, state, K_TS, K_TX,
                                  sigma_cutoff)
    assert_rows_close(got_t[:K_T], want_g[:K_T], 1e-4,
                      "K3b shared twin vs the reference")
    exact = composite_single.composite_sel_single_bwd_plain(
        args[0].double(), *args[1:], ct.double(), K_TS, K_TX, sigma_cutoff,
        term_eps)
    assert_rows_close(got_t[:K_T], exact[:K_T], 1e-4,
                      "K3b shared twin vs float64")
    # the pad row and the empty tile collect nothing
    assert not got_t[K_T].any() and not got_t[2].any()
    check_prefix_rule(prefixes, twin, state, args[1], args[2])


def test_k3_permuted_ids():
    """Per-env payloads with ids out of tile order: the port's gradient
    (K3b's twin, and the Function on the CPU) is autograd through the plain
    forward, the gradient scattered by id; the reference's is the same
    numbers placed by slot (row i holds slot i's gradient), a fault of the
    reference that no caller of its reaches (they name tiles in order)."""
    spay, ids, counts = k3_inputs()
    ids = np.asarray([[3, 1, 0, 5, 2, 4], [4, 0, 2, 1, 5, 3]], np.int32)
    args = [torch.as_tensor(a) for a in (spay, ids, counts)]
    out, state = k3_twin_fwd(*args, K_TS, K_TX, 3.0, 1e-4)
    ct = named_cotangent(17, out, args[1])
    got, _ = k3_twin_bwd(*args, ct, out, state, K_TS, K_TX, 3.0)
    leaf = args[0].clone().requires_grad_()
    out_p = composite_single.composite_sel_single_plain(leaf, *args[1:],
                                                        K_TS, K_TX, 3.0, 1e-4)
    (want,) = torch.autograd.grad(out_p, leaf, ct)
    assert_rows_close(got[:, :K_T], want[:, :K_T], 1e-4,
                      "K3b twin vs autograd")
    leaf_f = args[0].clone().requires_grad_()
    out_f = composite_single.composite_sel_single(leaf_f, *args[1:], K_TS,
                                                  K_TX, 3.0, 1e-4)
    (out_f * ct).sum().backward()
    torch.testing.assert_close(leaf_f.grad, want, atol=0, rtol=0)
    ref = reference_grad(spay, ids, counts, np_of(ct), K_TS, 3.0, 1e-4)
    by_slot = np_of(got)[np.arange(2)[:, None], ids]        # (B, TT, 10, K)
    assert_rows_close(by_slot, ref[:, :K_T], 1e-4,
                      "the reference's gradient, slot-indexed")
    moved = ids != np.arange(K_T)
    assert np.abs(ref[:, :K_T][moved] - np_of(got)[:, :K_T][moved]).max() > 1
