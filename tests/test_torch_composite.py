"""The plain versions of kernels K1 and K2 against the reference's Pallas
kernels (interpret mode on the CPU), and the wrappers' CPU behaviour.

K1 (``composite_static_plain`` vs ``pallas_composite._call_fwd``): out and
carries atol 2e-5 — float32 on both sides; the reference forms in-chunk
transmittances with a Hillis-Steele product tree and the plain version with
``cumprod``, so they differ in the rounding of products of up to 128 terms.

K2 (``composite_pair_sel_plain`` vs ``composite_pair_sel``) on the selected
rows: atol 5e-5, rtol 1e-4, the bound the reference holds its own selected
-tile kernel to (tests/test_pallas_sel.py), for log-space sums over two
lists.  The inputs cover tiles that skip, tiles cut by counts mid-chunk,
early termination, equal static/dynamic depths, a real slot without
dynamic entries and pad slots.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_helpers import np_of, tile_lists

from sim_a_splat_tpu.ops import pallas_composite as jk1
from sim_a_splat_tpu.ops.pallas_composite_sel import composite_pair_sel as jk2

from sim_a_splat_torch.ops import composite, composite_sel

TS, TX, TY = 16, 3, 2
T = TX * TY


def _k1_inputs(seed=0, K=384):
    rng = np.random.default_rng(seed)
    counts = np.asarray([K, 200, 0, 130, K, 300], np.int32)
    skip = np.asarray([1, 1, 1, 1, 1, 0], np.int32)
    pay = tile_lists(rng, range(T), counts, K, TS, TX, opaque=(4,))
    return pay, counts, skip


@pytest.mark.parametrize("sigma_cutoff,term_eps", [(3.0, 1e-4), (None, None)])
def test_k1_plain_matches_pallas(sigma_cutoff, term_eps):
    pay, counts, skip = _k1_inputs()
    nc = pay.shape[2] // composite.CHUNK
    pmin = None if sigma_cutoff is None else -0.5 * sigma_cutoff**2
    ref_out, ref_car = jk1._call_fwd(jnp.asarray(pay), jnp.asarray(counts),
                                     jnp.asarray(skip), TS, TX, nc, pmin, True,
                                     term_eps)
    out, car, applied, hits = composite.composite_static_plain(
        torch.as_tensor(pay), torch.as_tensor(counts), torch.as_tensor(skip),
        TS, TX, sigma_cutoff, term_eps, return_work=True)
    np.testing.assert_allclose(np_of(out), np_of(ref_out), atol=2e-5)
    np.testing.assert_allclose(np_of(car), np_of(ref_car), atol=2e-5)
    ap = np_of(applied)
    assert ap[5] == 0 and ap[2] == 0          # skipped tile, empty tile
    assert ap[3] == 2                         # cut by its count mid-chunk
    if term_eps is not None:
        assert ap[4] < nc                     # the opaque tile stopped early
    np.testing.assert_array_equal(np_of(out[5, :, 4]), 1.0)
    # composited pairs: none in the skipped and empty tiles; in the tile cut
    # by its count, every entry before the count whose alpha is nonzero
    assert int(hits[5]) == 0 and int(hits[2]) == 0
    px, py = composite.pixel_centers(torch.tensor([3]), TS, TX)
    a3 = composite.entry_alpha(torch.as_tensor(pay[3:4, :, :counts[3]]), px,
                               py, composite.power_min_of(sigma_cutoff))
    assert int(hits[3]) == int((a3 > 0).sum()) > 0


def _k2_inputs(seed=1, Ks=256, Kd=128):
    rng = np.random.default_rng(seed)
    counts_s = np.asarray([Ks, 100, 0, 200, Ks, 150, 0], np.int32)  # + trash
    spay = np.zeros((T + 1, 10, Ks), np.float32)
    spay[:T] = tile_lists(rng, range(T), counts_s[:T], Ks, TS, TX,
                          opaque=(4,))
    ids = np.asarray([[0, 4, 3, T], [1, 5, 0, T]], np.int32)
    counts_d = np.asarray([[40, 128, 7, 0], [60, 128, 0, 0]], np.int32)
    B, TT = ids.shape
    dpay = tile_lists(rng, ids.reshape(-1), counts_d.reshape(-1), Kd, TS, TX)
    return spay, dpay.reshape(B, TT, 10, Kd), ids, counts_s, counts_d


@pytest.mark.parametrize("sigma_cutoff,term_eps", [(3.0, 1e-4), (None, None)])
def test_k2_plain_matches_pallas(sigma_cutoff, term_eps):
    spay, dpay, ids, cs, cd = _k2_inputs()
    ref = jk2(jnp.asarray(spay), jnp.asarray(dpay), jnp.asarray(ids),
              jnp.asarray(cs), jnp.asarray(cd), TS, TX, sigma_cutoff, True,
              term_eps, "split", False)
    out, applied, hits = composite_sel.composite_pair_sel_plain(
        *(torch.as_tensor(a) for a in (spay, dpay, ids, cs, cd)), TS, TX,
        sigma_cutoff, term_eps, return_work=True)
    B, TT = ids.shape
    for b in range(B):
        for i in range(TT):
            t = ids[b, i]
            np.testing.assert_allclose(np_of(out[b, t]), np_of(ref[b, t]),
                                       atol=5e-5, rtol=1e-4,
                                       err_msg=f"env {b} slot {i} tile {t}")
    if term_eps is not None:
        assert int(applied[0, 1]) < spay.shape[-1] // 128   # early stop
    # composited pairs: none at pad slots; a real slot without dynamic
    # entries counts its static entries alone (tile 0 is never cut early)
    assert int(hits[0, 3]) == 0 and int(hits[1, 3]) == 0
    px, py = composite.pixel_centers(torch.tensor([0]), TS, TX)
    a0 = composite.entry_alpha(torch.as_tensor(spay[0:1, :, :cs[0]]), px, py,
                               composite.power_min_of(sigma_cutoff))
    assert int(hits[1, 2]) == int((a0 > 0).sum()) > 0
    # equal static / dynamic depths really occur in these lists
    ds = set(spay[0, 8, :cs[0]].tolist())
    assert ds & set(dpay[1, 0, 8, :cd[1, 0]].tolist())


def test_wrappers_run_plain_on_cpu():
    pay, counts, skip = _k1_inputs(seed=2)
    args = (torch.as_tensor(pay), torch.as_tensor(counts),
            torch.as_tensor(skip), TS, TX, 3.0, 1e-4)
    before = composite.launches
    got = composite.composite_static(*args)
    want = composite.composite_static_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert composite.launches == before        # no kernel on the CPU

    k2 = [torch.as_tensor(a) for a in _k2_inputs(seed=3)]
    before = composite_sel.launches
    out = composite_sel.composite_pair_sel(*k2, TS, TX, 3.0, 1e-4)
    ref = composite_sel.composite_pair_sel_plain(*k2, TS, TX, 3.0, 1e-4)
    ids = k2[2]
    for b in range(ids.shape[0]):
        assert torch.equal(out[b, ids[b].long()], ref[b, ids[b].long()])
    assert composite_sel.launches == before


def test_wrappers_check_inputs():
    spay, dpay, ids, cs, cd = (torch.as_tensor(a) for a in _k2_inputs())
    with pytest.raises(NotImplementedError):
        composite_sel.composite_pair_sel(spay[None].expand(2, -1, -1, -1),
                                         dpay, ids, cs, cd, TS, TX)
    with pytest.raises(ValueError):
        composite_sel.composite_pair_sel(spay, dpay, ids.long(), cs, cd, TS,
                                         TX)
    pay, counts, skip = (torch.as_tensor(a) for a in _k1_inputs())
    with pytest.raises(ValueError):
        composite.composite_static(pay.double(), counts, skip, TS, TX)
    with pytest.raises(ValueError):
        composite.composite_static(pay[:, :, :200], counts, skip, TS, TX)


def test_kernel_library_is_keyed_by_source(tmp_path, monkeypatch):
    """The build is cached by a hash of the sources: editing a source (or
    the shared header) names a new library, so it is rebuilt."""
    import shutil
    from sim_a_splat_torch.ops import _kernels

    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC, csrc)
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    first = {n: _kernels._library_path(n) for n in _kernels.KERNEL_SOURCES}
    assert first == {n: _kernels._library_path(n)
                     for n in _kernels.KERNEL_SOURCES}
    (csrc / "composite.cu").write_text(
        (csrc / "composite.cu").read_text() + "\n// edited\n")
    assert _kernels._library_path("composite") != first["composite"]
    assert _kernels._library_path("composite_sel") == first["composite_sel"]
    (csrc / "composite_common.cuh").write_text(
        (csrc / "composite_common.cuh").read_text() + "\n// edited\n")
    assert _kernels._library_path("composite_sel") != first["composite_sel"]


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    from sim_a_splat_torch.ops import _kernels

    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _kernels.nvcc_path()
