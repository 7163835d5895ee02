"""Port's binning, tile-list gathers and tile selection against the JAX
reference: integers exact, payloads exact (they are gathers of the same
float32 values).  The scenes have many gaussians at one depth, so the order
of tied entries — the stable tie-break of every sort — is under test."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import jax_raster, np_of, torch_raster

from sim_a_splat_tpu.ops import rasterize_cached as jcached
from sim_a_splat_tpu.ops import rasterize_tiles as jtiles
from sim_a_splat_tpu.ops.projection import Projected as JProjected

from sim_a_splat_torch.ops import rasterize_cached as cached
from sim_a_splat_torch.ops import rasterize_tiles as tiles
from sim_a_splat_torch.ops.projection import Projected

TX, TY, TS = 4, 3, 16


def _projected(rng, n, tie_depths=True):
    """Projected fields as numpy: half the gaussians share a few depths."""
    f = np.float32
    xy = rng.uniform(-12, TX * TS + 12, (n, 2)).astype(f)
    depth = rng.uniform(1, 50, n).astype(f)
    if tie_depths:
        depth[: n // 2] = rng.choice([4.0, 7.5, 20.0], n // 2)
    conic = np.abs(rng.normal(0.2, 0.1, (n, 3))).astype(f)
    valid = rng.uniform(size=n) > 0.1
    radius = np.where(valid, np.ceil(rng.exponential(6.0, n)), 0).astype(f)
    return dict(xy=xy, depth=depth, conic=conic, radius=radius, valid=valid)


def _both(d):
    return (JProjected(**{k: jnp.asarray(v) for k, v in d.items()}),
            Projected(**{k: torch.as_tensor(v) for k, v in d.items()}))


CONFIGS = {
    "buckets": dict(max_tiles_per_gaussian=9,
                    buckets=((4, 0.90), (6, 0.06), (9, 0.04))),
    "uniform": dict(max_tiles_per_gaussian=6, buckets=None),
}


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_bin_gaussians_exact_with_ties(cfg):
    rng = np.random.default_rng(11)
    jcfg, tcfg = jax_raster(**CONFIGS[cfg]), torch_raster(**CONFIGS[cfg])
    envs = [_projected(rng, 300) for _ in range(3)]
    batched = Projected(*(torch.stack([torch.as_tensor(e[k]) for e in envs])
                          for k in Projected._fields))
    mine_b = tiles._bin_gaussians(batched, tcfg, TX, TY)
    for b, d in enumerate(envs):
        jp, tp = _both(d)
        ref = jtiles._bin_gaussians(jp, jcfg, TX, TY)
        mine = tiles._bin_gaussians(tp, tcfg, TX, TY)
        names = ("sorted_tile", "sorted_gidx", "starts", "counts", "trunc")
        for name, r, m, mb in zip(names, ref, mine, mine_b):
            np.testing.assert_array_equal(np_of(m), np_of(r), err_msg=name)
            np.testing.assert_array_equal(np_of(mb[b]), np_of(r), err_msg=name)
    if cfg == "uniform":
        assert int(np_of(ref[4])) > 0     # slot clipping is exercised


def test_gather_tile_lists_exact():
    rng = np.random.default_rng(12)
    d = _projected(rng, 400)
    colors = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    op = rng.uniform(0, 1.2, 400).astype(np.float32)
    jp, tp = _both(d)
    cfg = dict(tile_capacity=128, max_tiles_per_gaussian=9)
    ref, rcounts, rtrunc = jtiles.gather_tile_lists(
        jp, jnp.asarray(colors), jnp.asarray(op), jax_raster(**cfg), TX, TY)
    mine, counts, trunc = tiles.gather_tile_lists(
        tp, torch.as_tensor(colors), torch.as_tensor(op), torch_raster(**cfg),
        TX, TY)
    np.testing.assert_array_equal(np_of(counts), np_of(rcounts))
    assert int(trunc) == int(rtrunc)
    for m, r in zip(mine, ref):
        np.testing.assert_array_equal(np_of(m), np_of(r))


def test_select_touched_tiles_exact():
    rng = np.random.default_rng(13)
    T, B, sel = TX * TY, 5, 6
    dcounts = rng.choice([0, 0, 0, 1, 2, 2, 5], (B, T)).astype(np.int32)
    dcounts[0] = 0                                  # an env touching nothing
    dcounts[1] = 3                                  # every tile, all tied
    ids, cs, over = cached.select_touched_tiles(torch.as_tensor(dcounts),
                                                sel, T)
    rids, rcs, rover = jax.vmap(
        lambda c: jcached.select_touched_tiles(c, sel, T))(
            jnp.asarray(dcounts))
    np.testing.assert_array_equal(np_of(ids), np_of(rids))
    np.testing.assert_array_equal(np_of(cs), np_of(rcs))
    np.testing.assert_array_equal(np_of(over), np_of(rover))


def test_gather_tile_lists_sel_exact():
    rng = np.random.default_rng(14)
    B, n, Kd, sel = 3, 250, 128, 8
    T = TX * TY
    envs = [_projected(rng, n) for _ in range(B)]
    colors = rng.uniform(0, 1, (B, n, 3)).astype(np.float32)
    op = rng.uniform(0, 1, (B, n)).astype(np.float32)
    tcfg = torch_raster(max_tiles_per_gaussian=9)
    tp = Projected(*(torch.stack([torch.as_tensor(e[k]) for e in envs])
                     for k in Projected._fields))
    _, sg, st, cnt, _ = tiles._bin_gaussians(tp, tcfg, TX, TY)
    ids, _, _ = cached.select_touched_tiles(cnt, sel, T)
    dpay, csel = cached._gather_tile_lists_sel(
        tp, torch.as_tensor(colors), torch.as_tensor(op), sg, st, cnt, ids, Kd)
    jcfg = jax_raster(max_tiles_per_gaussian=9)
    for b, d in enumerate(envs):
        jp = JProjected(**{k: jnp.asarray(v) for k, v in d.items()})
        _, jsg, jst, jcnt, _ = jtiles._bin_gaussians(jp, jcfg, TX, TY)
        jids, _, _ = jcached.select_touched_tiles(jcnt, sel, T)
        rpay, rcsel = jcached._gather_tile_lists_sel(
            jp, jnp.asarray(colors[b]), jnp.asarray(op[b]), jsg, jst, jcnt,
            jids, Kd)
        np.testing.assert_array_equal(np_of(ids[b]), np_of(jids))
        np.testing.assert_array_equal(np_of(csel[b]), np_of(rcsel))
        np.testing.assert_array_equal(np_of(dpay[b]), np_of(rpay))


def test_binning_key_guard():
    """The keys are int64, so (T+1)·N past 2^31 bins
    (``test_torch_splatfacto.py``); what stays int32 is a tile's count,
    at most N, which the kernels take as int32: N = 2^31 raises."""
    n = 2**31                                 # a tile's count past int32
    big = Projected(xy=torch.zeros(1, 2).expand(n, 2),    # no storage
                    depth=torch.zeros(1).expand(n),
                    conic=torch.zeros(1, 3).expand(n, 3),
                    radius=torch.zeros(1).expand(n),
                    valid=torch.zeros(1, dtype=torch.bool).expand(n))
    with pytest.raises(ValueError, match="overflow"):
        tiles._bin_gaussians(big, torch_raster(), TX, TY)
