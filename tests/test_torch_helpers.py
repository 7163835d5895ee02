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


def tile_lists(rng, tile_ids, counts, K, ts, tx, opaque=(), depth_step=0.25):
    """(len(tile_ids), 10, K) float32 payload of depth-sorted tile lists in
    the kernels' row layout [x, y, conic a b c, r, g, b, depth, opacity].

    Entries at or past ``counts[i]`` carry opacity 0 (and random geometry,
    as real padding does).  Depths lie on a ``depth_step`` grid in [1, 5],
    so entries tie within a list and across lists.  Lists at the positions
    in ``opaque`` are wide and nearly opaque, so a tile terminates early."""
    n = len(tile_ids)
    pay = np.zeros((n, 10, K), np.float32)
    for i, (t, cnt) in enumerate(zip(tile_ids, counts)):
        ox, oy = (t % tx) * ts, (t // tx) * ts
        sx, sy = rng.uniform(1.0, 6.0, K), rng.uniform(1.0, 6.0, K)
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
