"""Shared helpers of the PyTorch port's parity tests (``test_torch_*.py``).

Each parity test makes its inputs with numpy from a seed, runs them through
the JAX reference (on the CPU, Pallas kernels in interpret mode) and through
the port with ``device="cpu"``, and compares the results as numpy arrays.
This module holds no tests.
"""

import numpy as np
import torch

# the suite runs several xdist workers, each single-threaded
torch.set_num_threads(1)

# small-scene raster settings shared by both packages (the bench's buckets)
SMALL_RASTER = dict(tile_size=16, tile_capacity=128, max_tiles_per_gaussian=16,
                    sigma_cutoff=3.0, term_eps=1e-4,
                    buckets=((4, 0.90), (6, 0.06), (9, 0.04)))


def jax_raster(**overrides):
    from sim_a_splat_tpu.ops.rasterize_tiles import RasterConfig
    return RasterConfig(backend="pallas_interpret", chunk=128,
                        **{**SMALL_RASTER, **overrides})


def torch_raster(**overrides):
    from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
    return RasterConfig(**{**SMALL_RASTER, **overrides})


def np_of(x) -> np.ndarray:
    """numpy copy of a JAX array or torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def graph_leaves(graph) -> dict:
    """A JAX SceneGraph's leaves as the numpy dict
    ``sim_a_splat_torch.entry.graph_from_numpy`` takes."""
    s = graph.scene
    return dict(means=np_of(s.means), quats=np_of(s.quats),
                log_scales=np_of(s.log_scales),
                logit_opacities=np_of(s.logit_opacities), sh_dc=np_of(s.sh_dc),
                sh_rest=None if s.sh_rest is None else np_of(s.sh_rest),
                link_ids=np_of(graph.link_ids),
                rest_inv_q=np_of(graph.rest_inv.q),
                rest_inv_t=np_of(graph.rest_inv.t))


def jax_pusht_states(vectors, legacy=False, block_cog=None):
    """Settled JAX pushT states (batched) from (B, 5) numpy state vectors,
    and the same states as a numpy dict by field name."""
    import jax
    import jax.numpy as jnp
    from sim_a_splat_tpu.physics import pusht as jpusht

    P = jpusht.PushTParams(block_cog=block_cog)
    st = jax.vmap(lambda v: jpusht.set_state(P, v, legacy=legacy))(
        jnp.asarray(vectors, jnp.float32))
    return st, {k: np_of(v) for k, v in st._asdict().items()}


def random_state_vectors(rng, B):
    """(B, 5) pushT reset vectors from the reference's distribution."""
    return np.stack([rng.integers(50, 248, B), rng.integers(50, 462, B),
                     rng.integers(100, 198, B), rng.integers(100, 412, B),
                     rng.normal(size=B) * 2 * np.pi - np.pi],
                    axis=1).astype(np.float32)


def tile_lists(rng, tile_ids, counts, K, ts, tx, opaque=(), depth_step=0.25,
               scale=(1.0, 6.0)):
    """(len(tile_ids), 10, K) float32 payload of depth-sorted tile lists in
    the kernels' row layout [x, y, conic a b c, r, g, b, depth, opacity],
    with footprint scales (standard deviations, px) drawn from ``scale``.

    Entries at or past ``counts[i]`` carry opacity 0 (and random geometry,
    as real padding does).  Depths lie on a ``depth_step`` grid in [1, 5],
    so entries tie within a list and across lists.  Lists at the positions
    in ``opaque`` are wide and nearly opaque, so a tile terminates early."""
    n = len(tile_ids)
    pay = np.zeros((n, 10, K), np.float32)
    for i, (t, cnt) in enumerate(zip(tile_ids, counts)):
        ox, oy = (t % tx) * ts, (t // tx) * ts
        sx, sy = rng.uniform(*scale, K), rng.uniform(*scale, K)
        rho = rng.uniform(-0.6, 0.6, K)
        op = rng.uniform(0.05, 0.95, K)
        if i in opaque:
            sx, sy, rho, op = sx * 6, sy * 6, rho * 0, np.full(K, 0.99)
        det = 1.0 - rho**2
        depth = np.sort(np.round(rng.uniform(1, 5, K) / depth_step)
                        * depth_step)
        op[min(cnt, K):] = 0.0
        pay[i] = [ox + rng.uniform(-4, ts + 4, K), oy + rng.uniform(-4, ts + 4, K),
                  1 / (sx**2 * det), -rho / (sx * sy * det), 1 / (sy**2 * det),
                  *rng.uniform(0, 1, (3, K)), depth, op]
    return pay


# tile grid of the kernel tests: 3 × 2 tiles of 16 × 16 pixels
K_TS, K_TX, K_T = 16, 3, 6


def k1_inputs(seed=0, K=384):
    """K1 inputs (payload (6, 10, K), counts, skip) that cover a full tile,
    tiles cut by their counts mid-chunk, an empty tile, a nearly opaque
    tile that stops early and a skipped tile."""
    rng = np.random.default_rng(seed)
    counts = np.asarray([K, 200, 0, 130, K, 300], np.int32)
    skip = np.asarray([1, 1, 1, 1, 1, 0], np.int32)
    pay = tile_lists(rng, range(K_T), counts, K, K_TS, K_TX, opaque=(4,))
    return pay, counts, skip


def k1_case_inputs(ts=K_TS, seed=4, K=384):
    """K1 inputs (payload (7, 10, K), counts, skip) over a 3-wide grid of
    ``ts`` × ``ts`` tiles, one edge case a tile: 0, every chunk applied;
    1, cut by its count mid-chunk; 2, count 0; 3, count past the capacity;
    4, nearly opaque, stops after chunk 0; 5, skip 0; 6, nearly opaque in
    chunk 1 only, stops after chunk 1 (with term_eps 1e-4)."""
    rng = np.random.default_rng(seed)
    counts = np.asarray([K, 200, 0, K + 40, K, 300, K], np.int32)
    skip = np.asarray([1, 1, 1, 1, 1, 0, 1], np.int32)
    pay = tile_lists(rng, range(7), counts, K, ts, K_TX, opaque=(4,),
                     scale=(0.5, 2.0))
    opaque = tile_lists(rng, [6], [K], K, ts, K_TX, opaque=(0,))
    pay[6, :, 128:256] = opaque[0, :, 128:256]
    return pay, counts, skip


def k2_inputs(seed=1, Ks=256, Kd=128, scale=(1.0, 6.0), ts=K_TS):
    """K2 inputs (spay_pad, dpay, ids, counts_s_pad, counts_d) for two envs
    of four slots: static tiles as in :func:`k1_inputs` plus the zero trash
    row, a nearly opaque tile that stops early, a real slot without dynamic
    entries, a pad slot per env, and static and dynamic depths on one grid
    so that they tie.  ``scale`` bounds the footprints' standard deviations
    (narrow ones leave most (entry, warp) pairs to the kernels' cull), over
    a 3 × 2 grid of ``ts`` × ``ts`` tiles."""
    rng = np.random.default_rng(seed)
    counts_s = np.asarray([Ks, 100, 0, 200, Ks, 150, 0], np.int32)  # + trash
    spay = np.zeros((K_T + 1, 10, Ks), np.float32)
    spay[:K_T] = tile_lists(rng, range(K_T), counts_s[:K_T], Ks, ts, K_TX,
                            opaque=(4,), scale=scale)
    ids = np.asarray([[0, 4, 3, K_T], [1, 5, 0, K_T]], np.int32)
    counts_d = np.asarray([[40, 128, 7, 0], [60, 128, 0, 0]], np.int32)
    B, TT = ids.shape
    dpay = tile_lists(rng, ids.reshape(-1), counts_d.reshape(-1), Kd, ts,
                      K_TX, scale=scale)
    return spay, dpay.reshape(B, TT, 10, Kd), ids, counts_s, counts_d


def k2_shared_tile_inputs(seed=6, B=24, Ks=256, Kd=128):
    """K2 inputs where every one of ``B`` envs selects tiles 0 and 4 (the
    static gradient's atomic adds then contend for two rows), plus one other
    tile (no env selects a tile twice) and a pad slot; dynamic lists of
    random counts."""
    spay, _, _, counts_s, _ = k2_inputs(seed, Ks, Kd)
    rng = np.random.default_rng(seed)
    ids = np.asarray([[0, 4, (1, 2, 3, 5)[b % 4], K_T] for b in range(B)],
                     np.int32)
    counts_d = rng.integers(0, Kd + 1, ids.shape).astype(np.int32)
    counts_d[:, -1] = 0
    dpay = tile_lists(rng, ids.reshape(-1), counts_d.reshape(-1), Kd, K_TS,
                      K_TX, scale=(0.5, 3.0))
    return spay, dpay.reshape(*ids.shape, 10, Kd), ids, counts_s, counts_d


def k2_full_dyn_inputs(Kd, ts=K_TS, seed=12):
    """K2 inputs as :func:`k2_inputs` but with dynamic lists that fill the
    capacity ``Kd`` (or most of it) and narrow footprints, so that every
    dynamic partial sum of the kernels' walk is exercised."""
    spay, dpay, ids, counts_s, _ = k2_inputs(seed, Kd=Kd, scale=(0.3, 2.0),
                                             ts=ts)
    rng = np.random.default_rng(seed)
    counts_d = np.asarray([[Kd, Kd - 100, 7, 0], [Kd // 2, Kd, 0, 0]],
                          np.int32)
    dpay = tile_lists(rng, ids.reshape(-1), counts_d.reshape(-1), Kd, ts,
                      K_TX, scale=(0.3, 2.0))
    return spay, dpay.reshape(*ids.shape, 10, Kd), ids, counts_s, counts_d


def k3_inputs(seed=2, Km=256):
    """K3 inputs for two envs over the 3 × 2 tile grid: per-env payloads
    (2, T+1, 10, Km) with the zero trash row, dense ids (each env names
    every tile once, as the moving render does), counts covering a full
    list, lists cut mid-chunk, an empty tile and a nearly opaque tile that
    stops early."""
    rng = np.random.default_rng(seed)
    counts = np.asarray([[Km, 100, 0, 200, Km, 150, 0],
                         [60, Km, 130, 0, 250, Km, 0]], np.int32)
    B = counts.shape[0]
    spay = np.zeros((B, K_T + 1, 10, Km), np.float32)
    for b in range(B):
        spay[b, :K_T] = tile_lists(rng, range(K_T), counts[b, :K_T], Km, K_TS,
                                   K_TX, opaque=(4,) if b == 0 else (1,))
    ids = np.tile(np.arange(K_T, dtype=np.int32), (B, 1))
    return spay, ids, counts


def k4_inputs(seed=3, Ks=256, Kd=128, ts=K_TS):
    """K4 inputs (spay (T, 10, Ks), dpay (2, T, 10, Kd), counts_s (T,),
    counts_d (2, T), skip (2, T)) over a 3 × 2 grid of ``ts`` × ``ts``
    tiles: a full static
    list, lists cut mid-chunk, an empty one, a count past the capacity and
    a nearly opaque tile that stops early; dynamic lists full, cut, empty,
    past the capacity and nearly opaque; pairs with skip 0 (one of them
    with dynamic entries, which it must ignore); static and dynamic depths
    on one grid, so that they tie."""
    rng = np.random.default_rng(seed)
    counts_s = np.asarray([Ks, 100, 0, 200, Ks + 40, 150], np.int32)
    spay = tile_lists(rng, range(K_T), counts_s, Ks, ts, K_TX, opaque=(4,))
    counts_d = np.asarray([[40, Kd, 7, 0, 60, Kd + 30],
                           [60, 0, Kd, 5, 0, 90]], np.int32)
    skip = np.asarray([[1, 1, 1, 0, 1, 1],
                       [1, 1, 1, 0, 0, 1]], np.int32)
    dpay = np.stack([tile_lists(rng, range(K_T), counts_d[b], Kd, ts, K_TX,
                                opaque=(5,) if b == 1 else ())
                     for b in range(2)])
    return spay, dpay, counts_s, counts_d, skip


def selected_cotangent(rng, ids, shape):
    """Cotangent of K2's out (B, T+1, 8, P) from ``rng``: normal on the rows
    the slots select (channels 0-4, the ones the output defines), zero on
    every other row and on the trash row, as the main path's select gives."""
    ct = np.zeros(shape, np.float32)
    T = shape[1] - 1
    for b, row in enumerate(ids):
        for t in row[row < T]:
            ct[b, t, :5] = rng.normal(size=(5, shape[-1]))
    return ct


SCENE_FIELDS = ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
                "sh_rest")


def as_float64(tensors):
    """The floating-point tensors of a list in float64, the others as they
    are (the plain versions run in float64 as an exact reference)."""
    return [a.double() if a.is_floating_point() else a for a in tensors]


def assert_fields_close(got, want, rel):
    """Each gradient field of the scene ``got`` finite and within ``rel`` ×
    that field's largest |want| (GaussianScenes of either package, on any
    device); a field ``want`` lacks (None) must be None in ``got``."""
    for name in SCENE_FIELDS:
        w = getattr(want, name)
        if w is None:
            assert getattr(got, name) is None, name
            continue
        g, w = np_of(getattr(got, name)), np_of(w)
        assert g.shape == w.shape and np.isfinite(g).all(), name
        scale = float(np.abs(w).max())
        assert scale > 0, name
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, \
            f"{name}: max|Δ| {err:.3e} > {rel} × {scale:.3e}"


def assert_rows_close(got, want, rel, what):
    """Each payload row (axis -2) of ``got`` within ``rel`` × that row's
    largest |want| (numpy arrays or tensors on any device)."""
    got, want = np_of(got), np_of(want)
    for r in range(want.shape[-2]):
        g, w = got[..., r, :], want[..., r, :]
        scale = float(np.abs(w).max())
        assert scale > 0, f"{what} row {r}: reference gradient is all zero"
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, \
            f"{what} row {r}: max|Δ| {err:.3e} > {rel} × {scale:.3e}"


def rows_rel_err(got, want) -> float:
    """The largest over payload rows (axis -2) of max|got - want| / that
    row's largest |want| (numpy arrays or tensors on any device)."""
    got, want = np_of(got), np_of(want)
    return max(float(np.abs(got[..., r, :] - want[..., r, :]).max())
               / float(np.abs(want[..., r, :]).max())
               for r in range(want.shape[-2]))
