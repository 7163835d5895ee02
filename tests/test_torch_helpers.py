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


def manipulator_leaves(state) -> dict:
    """A reference ManipulatorState's leaves as numpy by field name, ``arm``
    as (q, qd, target_prev): what ``entry.product_state_from_numpy``
    takes."""
    d = {k: np_of(v) for k, v in state._asdict().items() if k != "arm"}
    d["arm"] = [np_of(a) for a in state.arm]
    return d


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


# pushT state vectors the contacts' edge cases come from (the T at angle 0
# spans x 89-209, y 256-286 with its crossbar when its origin is at
# (149, 256)): the agent inside the crossbar; inside, 10 from two faces
# (a tie of the deepest face); outside, diagonal from a corner (a tie of
# the nearest edge); the T pressed into the left wall, the floor and a
# corner of the walls; no contact at all
PUSHT_EDGE_CASES = np.asarray([
    [149.0, 271.0, 149.0, 256.0, 0.0],
    [199.0, 276.0, 149.0, 256.0, 0.0],
    [219.0, 296.0, 149.0, 256.0, 0.0],
    [70.0, 200.0, 50.0, 256.0, 0.0],
    [200.0, 400.0, 149.0, 20.0, 0.7],
    [150.0, 300.0, 30.0, 30.0, 0.3],
    [60.0, 460.0, 149.0, 256.0, 0.5],
], np.float32)


def pusht_case_vectors(rng, B):
    """(B, 5) pushT state vectors: ``PUSHT_EDGE_CASES`` first, then draws
    of the reference's reset distribution."""
    vec = random_state_vectors(rng, B)
    n = min(B, len(PUSHT_EDGE_CASES))
    vec[:n] = PUSHT_EDGE_CASES[:n]
    return vec


def pusht_case_actions(rng, vec):
    """(B, 2) agent targets for ``vec``: the first half near each env's
    block (pushes), the rest anywhere in the workspace."""
    B = len(vec)
    act = rng.uniform((0.0, 0.0), (298.0, 512.0), (B, 2))
    h = (B + 1) // 2
    act[:h] = vec[:h, 2:4] + rng.normal(0.0, 30.0, (h, 2))
    return act.astype(np.float32)


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


def k2_per_env_inputs(seed=7, Ks=256, Kd=128, ts=K_TS):
    """K2 inputs in the per-env mode (spay_pad (2, T+1, 10, Ks), dpay
    (2, T, 10, Kd), ids (2, T), counts_s_pad (2, T+1), counts_d (2, T)) over
    the 3 × 2 grid of ``ts`` × ``ts`` tiles with the reference's dense ids
    ids[b] = arange(T): each env's own static lists (full, cut mid-chunk,
    empty, nearly opaque so that a tile stops early) with the zero trash
    row, dynamic lists full, cut, empty and nearly opaque, and static and
    dynamic depths on one grid, so that they tie."""
    rng = np.random.default_rng(seed)
    counts_s = np.asarray([[Ks, 100, 0, 200, Ks, 150, 0],
                           [60, Ks, 130, 0, 250, Ks, 0]], np.int32)
    counts_d = np.asarray([[40, Kd, 7, 0, 60, 90],
                           [Kd, 0, 25, Kd, 5, 70]], np.int32)
    B = counts_s.shape[0]
    spay = np.zeros((B, K_T + 1, 10, Ks), np.float32)
    dpay = np.zeros((B, K_T, 10, Kd), np.float32)
    for b in range(B):
        spay[b, :K_T] = tile_lists(rng, range(K_T), counts_s[b, :K_T], Ks,
                                   ts, K_TX, opaque=(4,) if b == 0 else (1,))
        dpay[b] = tile_lists(rng, range(K_T), counts_d[b], Kd, ts, K_TX,
                             opaque=(3,) if b == 1 else ())
    ids = np.tile(np.arange(K_T, dtype=np.int32), (B, 1))
    return spay, dpay, ids, counts_s, counts_d


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


def k3_inputs(seed=2, Km=256, ts=K_TS):
    """K3 inputs for two envs over the 3 × 2 grid of ``ts`` × ``ts`` tiles:
    per-env payloads (2, T+1, 10, Km) with the zero trash row, dense ids
    (each env names every tile once, as the moving render does), counts
    covering a full list, lists cut mid-chunk, an empty tile and a nearly
    opaque tile that stops early."""
    rng = np.random.default_rng(seed)
    counts = np.asarray([[Km, 100, 0, 200, Km, 150, 0],
                         [60, Km, 130, 0, 250, Km, 0]], np.int32)
    B = counts.shape[0]
    spay = np.zeros((B, K_T + 1, 10, Km), np.float32)
    for b in range(B):
        spay[b, :K_T] = tile_lists(rng, range(K_T), counts[b, :K_T], Km, ts,
                                   K_TX, opaque=(4,) if b == 0 else (1,))
    ids = np.tile(np.arange(K_T, dtype=np.int32), (B, 1))
    return spay, ids, counts


def k3_shared_inputs(seed=5, Km=256, ts=K_TS):
    """K3 inputs in the shared mode over the 3 × 2 tile grid: one payload
    (T+1, 10, Km) with the zero trash row, counts (T+1,), and ids (3, 5)
    naming tiles that repeat across envs (each at most once per env) and
    pad slots (the pad id T, count 0)."""
    rng = np.random.default_rng(seed)
    counts = np.asarray([Km, 100, 0, 200, Km, 150, 0], np.int32)
    spay = np.zeros((K_T + 1, 10, Km), np.float32)
    spay[:K_T] = tile_lists(rng, range(K_T), counts[:K_T], Km, ts, K_TX,
                            opaque=(4,))
    ids = np.asarray([[0, 1, 3, 4, K_T],
                      [4, 5, 0, K_T, K_T],
                      [3, 1, 4, 2, 0]], np.int32)
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


def arm_case_inputs(env, B, steps, rng):
    """Reset values ({robot_pos, block_pos, goal_pos}, one row an env) and
    (steps, B, ndof) joint targets for B envs of the arm ``env``: the joints
    drawn inside their limits; in the first third of the envs (at least
    one) the block's origin 0.03 m beyond the end effector in y, its yaw
    within 0.3 rad (the end effector pressing into the crossbar), in the
    second third within 0.12 m in x and y (inside the T, on an edge or
    beside it), in the rest 0.5 m away with the goal at the block (reward
    0, ``terminated``); the targets a random walk about the start that
    sweeps the end effector, every eighth env driving joint 1 past its
    position and velocity limits."""
    from sim_a_splat_torch.physics import kinematics as kin

    ch = env.chain
    lo = np.maximum(ch.lower, -2.0)
    hi = np.minimum(ch.upper, 2.0)
    q0 = (lo + (hi - lo) * rng.uniform(0.2, 0.8, (B, ch.ndof))).astype(
        np.float32)
    eef = kin.link_pose(ch, torch.as_tensor(q0), env.eef_link,
                        env._base("cpu")).t.numpy()[:, :2]
    kind = np.minimum(np.arange(B) // ((B + 2) // 3), 2)
    off = np.where((kind == 1)[:, None], rng.uniform(-0.12, 0.12, (B, 2)),
                   np.where((kind == 0)[:, None], [0.0, 0.03], 0.5))
    yaw = np.where(kind == 0, rng.uniform(-0.3, 0.3, B),
                   rng.uniform(-np.pi, np.pi, B))
    block = np.concatenate([eef + off, np.full((B, 1), 0.2), yaw[:, None]], 1)
    goal = np.stack([rng.uniform(0.3, 0.6, B), rng.uniform(-0.2, 0.2, B),
                     np.full(B, 0.2), rng.uniform(-np.pi, np.pi, B)], 1)
    goal = np.where((kind == 2)[:, None], block, goal)
    walk = np.cumsum(rng.normal(0, 0.05, (steps, B, ch.ndof)), 0)
    actions = (q0 + walk).astype(np.float32)
    actions[:, 7::8, min(1, ch.ndof - 1)] = 4.0
    reset = {"robot_pos": q0, "block_pos": block.astype(np.float32),
             "goal_pos": goal.astype(np.float32)}
    return reset, actions


def arm_chain_past_caps(kind, tmp_path):
    """pusharm6 grown past the arm kernel's caps (8 links, 6 joints),
    through ``kin.load_chain``: ``"links"`` adds a 9th link, fixed on
    ``push_tool``; ``"joints"`` makes ``tool_joint`` a 7th joint, revolute
    about z."""
    from sim_a_splat_torch import entry
    from sim_a_splat_torch.physics import kinematics as kin

    urdf = entry.PRODUCT_URDF.read_text()
    if kind == "links":
        urdf = urdf.replace(
            "</robot>", '  <link name="mount"/>\n'
            '  <joint name="mount_joint" type="fixed">\n'
            '    <parent link="push_tool"/>\n'
            '    <child link="mount"/>\n  </joint>\n</robot>')
    else:
        urdf = urdf.replace(
            '<joint name="tool_joint" type="fixed">',
            '<joint name="tool_joint" type="revolute">\n'
            '    <axis xyz="0 0 1"/>\n'
            '    <limit lower="-1" upper="1" velocity="3.14" effort="10"/>')
    path = tmp_path / f"pusharm6_{kind}.urdf"
    path.write_text(urdf)
    return kin.load_chain(path)


# the arm product path's end-effector camera: 240×320 at fov 1.05, a 15 × 20
# grid of 16-px tiles, 512 candidates a tile (kernel R1's shapes)
R1_HW, R1_TS, R1_KC = (240, 320), 16, 512


def reproject_case_inputs(B, seed=0, Kc=R1_KC, contiguous=False,
                          device="cpu"):
    """A candidate cache (SH degree 3) and B cameras for the reprojection
    at the end-effector camera's shapes, with its edge cases: about 10 %
    of the candidates behind the near plane, 5 % needles (log-scales
    (5, −9, −9), whose det rounds to ≤ 0 in about half), 2 % with scales
    that overflow (det NaN), 30 % pads (opacity 0), and in env 0 (identity
    rotation) 5 % on the camera's x = 0 plane, so u is cx = 160 exactly, a
    tile border, and u ± r (r an integer) meets the borders exactly.  The
    rest lie around their own tile, 0.05-4 m deep.  Fields are views of one
    gathered (B, T, 59, Kc) block, as ``build_moving_cache`` leaves them, or
    each contiguous.  Returns (cache, camera, config)."""
    from sim_a_splat_torch.ops import rasterize_moving as trm
    from sim_a_splat_torch.ops.projection import Camera
    from sim_a_splat_torch.ops.transforms import SE3

    rng = np.random.default_rng(seed)
    (H, W), ts = R1_HW, R1_TS
    tx, ty = W // ts, H // ts
    T = tx * ty
    q = rng.normal(0, 0.15, (B, 4)) + [1.0, 0, 0, 0]
    q[0] = [1.0, 0, 0, 0]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pos = rng.uniform(-0.5, 0.5, (B, 3))
    cam = Camera.from_fov(SE3(torch.as_tensor(q, dtype=torch.float32),
                              torch.as_tensor(pos, dtype=torch.float32)),
                          1.05, W, H)
    f = float(cam.fx)
    tiles = np.arange(T)
    shape = (B, T, Kc)
    z = rng.uniform(0.05, 4.0, shape)
    kind = rng.uniform(size=shape)
    z = np.where(kind < 0.10, rng.uniform(-0.5, 0.01, shape), z)
    zp = np.maximum(np.abs(z), 0.05)
    u = ((tiles % tx) * ts)[:, None] + rng.uniform(-40, 56, shape)
    v = ((tiles // tx) * ts)[:, None] + rng.uniform(-40, 56, shape)
    p_cam = np.stack([(u - W / 2) * zp / f, (v - H / 2) * zp / f, z], -1)
    p_cam[0, ..., 0] = np.where(kind[0] > 0.95, 0.0, p_cam[0, ..., 0])
    # camera → world: R(q) p + t, per env
    w, x, y, zq = q.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + zq * zq), 2 * (x * y - w * zq),
                  2 * (x * zq + w * y)], -1),
        np.stack([2 * (x * y + w * zq), 1 - 2 * (x * x + zq * zq),
                  2 * (y * zq - w * x)], -1),
        np.stack([2 * (x * zq - w * y), 2 * (y * zq + w * x),
                  1 - 2 * (x * x + y * y)], -1)], 1)
    means = np.einsum("bij,btkj->btki", R, p_cam) + pos[:, None, None]
    means[0] = np.where((kind[0] > 0.95)[..., None],
                        np.concatenate([np.broadcast_to(
                            np.float32(pos[0, 0]), shape[1:] + (1,)),
                            means[0, ..., 1:]], -1), means[0])
    quats = rng.normal(size=shape + (4,))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    ls = rng.uniform(-6.0, -1.0, shape + (3,))
    needle = (kind >= 0.10) & (kind < 0.15)
    ls[needle] = [5.0, -9.0, -9.0]
    ls[(kind >= 0.15) & (kind < 0.17)] = 40.0
    op = np.where(rng.uniform(size=shape) < 0.3, 0.0,
                  rng.uniform(0.05, 1.0, shape))
    sh = rng.normal(0, 0.4, shape + (48,))
    raw = np.concatenate([means, quats, ls, op[..., None], sh], -1)
    raw = torch.as_tensor(np.ascontiguousarray(
        np.moveaxis(raw, -1, 2)), dtype=torch.float32, device=device)
    fields = dict(mean=raw[:, :, 0:3], quat=raw[:, :, 3:7],
                  log_scales=raw[:, :, 7:10], opacity=raw[:, :, 10],
                  sh=raw[:, :, 11:].reshape(B, T, 16, 3, Kc))
    if contiguous:
        fields = {k: t.contiguous() for k, t in fields.items()}
    zeros = torch.zeros(B, device=device)
    cache = trm.MovingCache(
        **fields, counts=torch.full((B, T), Kc, dtype=torch.int32,
                                    device=device),
        base_q=cam.pose.q.to(device), base_t=cam.pose.t.to(device),
        s_trans=zeros, s_rot=zeros, z_min=zeros, near_gap=zeros,
        g_gap=zeros, margin=torch.tensor(16.0, device=device),
        n_build_truncated=zeros.int(),
        near_mean=torch.zeros(B, 8, 3, device=device),
        near_quat=torch.zeros(B, 8, 4, device=device),
        near_ls=torch.zeros(B, 8, 3, device=device),
        near_op=torch.zeros(B, 8, device=device),
        near_sh=torch.zeros(B, 8, 16, 3, device=device),
        z_split=torch.tensor(0.0, device=device),
        t_max=torch.tensor(0.05, device=device),
        n_near_over=zeros.int())
    return cache, cam.to(device), torch_raster(tile_size=ts)


def assert_r1_matches_plain(got, want):
    """R1's (payload, key) against the plain version's: every row but the
    colours and the key exactly (NaN where NaN), the colours within 1e-6;
    the survivors' counts equal.  Returns the colours' max|Δ| (tensors on
    any device)."""
    (pay, key), (wpay, wkey) = got, want
    rows = [r for r in range(10) if r not in range(5, 8)]
    torch.testing.assert_close(pay[:, :, rows], wpay[:, :, rows], rtol=0,
                               atol=0, equal_nan=True)
    torch.testing.assert_close(key, wkey, rtol=0, atol=0)
    torch.testing.assert_close(pay[:, :, 5:8], wpay[:, :, 5:8],
                               rtol=0, atol=1e-6)
    assert torch.equal((pay[:, :, 9] > 0).sum(-1), (wpay[:, :, 9] > 0).sum(-1))
    return float((pay[:, :, 5:8] - wpay[:, :, 5:8]).abs().max())
