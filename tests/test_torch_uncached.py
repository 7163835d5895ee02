"""The uncached full-grid render path of the port against the JAX
reference, on the CPU.

- ``composite_tiles`` against the reference's (the XLA scan), and against
  K1's plain version without the early stop: rgb, depth_acc and trans at
  atol 2e-5 (cumulative products of up to 384 float32 factors in chunks of
  64 against K1's of 128).
- the gather with a leading env axis: each env's lists and counts exactly
  the reference's of that env alone.
- ``rasterize``, ``rasterize_sh``, ``rasterize_raw`` and
  ``rasterize_raw_sh``: images, ``alpha`` and ``depth`` at atol 5e-5, the
  truncation counters and per-tile counts exactly, through K1's semantics
  (the reference's ``pallas_interpret`` backend) at K % 128 == 0, and at
  K % 128 != 0 through the port's padded lists against the reference's
  XLA fallback; a batch of envs against each env rendered alone by the
  reference.
- K1's plain forward and backward with a leading env axis against
  ``jax.vmap`` of ``composite_pallas`` and its ``jax.vjp`` (out and
  carries atol 2e-5 as for one image; gradient rows within 1e-4 of each
  row's largest, as ``test_torch_grad.py`` holds K1b).
- ``entry.make_step`` against ``jax.vmap`` of ``__graft_entry__._make_step``
  (the bench's raster, Pallas in interpret mode): images atol 5e-5, states
  to ``test_torch_physics.py``'s tolerances, the loss at rtol 1e-5 and the
  gradient of every scene field within 1e-4 of its largest
  (``jax.value_and_grad``); ``sh_rest``, which the step does not read,
  gets an exact zero on both sides.
- ``entry.entry(device="cpu")`` against ``__graft_entry__.entry()``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import (
    K_T, K_TS, K_TX, assert_fields_close, assert_rows_close, graph_leaves,
    jax_pusht_states, jax_raster, k1_case_inputs, k1_inputs, np_of,
    random_state_vectors, tile_lists, torch_raster,
)

import __graft_entry__ as graft
from sim_a_splat_tpu.ops import pallas_composite as jk1
from sim_a_splat_tpu.ops import rasterize_tiles as jtiles
from sim_a_splat_tpu.ops.projection import Camera as JCamera
from sim_a_splat_tpu.ops.transforms import SE3 as JSE3
from sim_a_splat_tpu.splat import loaders as jloaders

from sim_a_splat_torch import entry
from sim_a_splat_torch.ops import composite
from sim_a_splat_torch.ops import rasterize_tiles as tiles
from sim_a_splat_torch.ops.projection import Camera
from sim_a_splat_torch.ops.transforms import SE3
from sim_a_splat_torch.physics import pusht
from sim_a_splat_torch.splat import loaders

BENCH = dict(tile_capacity=1024)       # bench.py's raster (the rest shared)
IMG_ATOL = 5e-5


def _lists(seed=0, K=384, T=K_T):
    """(T, K, ·) tile-list fields of ``tile_lists`` and the payload."""
    rng = np.random.default_rng(seed)
    counts = np.asarray([K, 200, 0, 130, K, 300][:T], np.int32)
    pay = tile_lists(rng, range(T), counts, K, K_TS, K_TX, opaque=(4,))
    fields = (pay[:, 0:2].transpose(0, 2, 1), pay[:, 2:5].transpose(0, 2, 1),
              pay[:, 5:8].transpose(0, 2, 1), pay[:, 9], pay[:, 8])
    return [np.ascontiguousarray(f) for f in fields], pay, counts


@pytest.mark.parametrize("sigma_cutoff", [3.0, None])
def test_composite_tiles_matches(sigma_cutoff):
    fields, pay, counts = _lists()
    ids = np.asarray([4, 0, 5, 1, 3, 2], np.int32)   # any global tile ids
    cfg = tiles.RasterConfig(tile_size=K_TS, sigma_cutoff=sigma_cutoff,
                             chunk=64)
    jcfg = jtiles.RasterConfig(tile_size=K_TS, sigma_cutoff=sigma_cutoff,
                               chunk=64)
    got = tiles.composite_tiles(*(torch.as_tensor(f) for f in fields),
                                torch.as_tensor(ids), cfg, K_TX)
    want = jtiles.composite_tiles(*(jnp.asarray(f) for f in fields),
                                  jnp.asarray(ids), jcfg, K_TX)
    for name, a, b in zip(("rgb", "depth_acc", "trans"), got, want):
        np.testing.assert_allclose(np_of(a), np_of(b), rtol=0, atol=2e-5,
                                   err_msg=name)
    # K1's plain version without the early stop computes the same (its
    # counts skip only zero-opacity chunks); at tile ids 0..T-1
    got = tiles.composite_tiles(*(torch.as_tensor(f) for f in fields),
                                torch.arange(K_T), cfg, K_TX)
    ones = torch.ones(K_T, dtype=torch.int32)
    out, _ = composite.composite_static_plain(
        torch.as_tensor(pay), torch.as_tensor(counts), ones, K_TS, K_TX,
        sigma_cutoff, None)
    for name, a, b in zip(("rgb", "depth_acc", "trans"), got,
                          (out[..., 0:3], out[..., 3], out[..., 4])):
        np.testing.assert_allclose(np_of(a), np_of(b), rtol=0, atol=2e-5,
                                   err_msg=name)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tiles.composite_tiles(*(torch.as_tensor(f[:, :100]) for f in fields),
                              torch.arange(K_T), cfg, K_TX)


def _camera_pair(width, height, z=-3.0, B=None):
    q = np.asarray([1.0, 0, 0, 0], np.float32)
    t = np.asarray([0.0, 0.0, z], np.float32)
    cam = Camera.from_fov(SE3(torch.as_tensor(q), torch.as_tensor(t)), 0.8,
                          width, height)
    jcam = JCamera.from_fov(JSE3(jnp.asarray(q), jnp.asarray(t)), 0.8, width,
                            height)
    return cam, jcam


def _scenes(n=300, seed=0, sh_degree=0):
    kw = dict(extent=0.8, scale_range=(0.03, 0.12), sh_degree=sh_degree)
    return (loaders.synthetic_scene(n, seed=seed, device="cpu", **kw),
            jloaders.synthetic_scene(n, seed=seed, **kw))


def _check_render(got, want, what):
    img, aux = got
    jimg, jaux = want
    np.testing.assert_allclose(np_of(img), np_of(jimg), rtol=0,
                               atol=IMG_ATOL, err_msg=f"{what} image")
    np.testing.assert_allclose(np_of(aux.alpha), np_of(jaux.alpha), rtol=0,
                               atol=IMG_ATOL, err_msg=f"{what} alpha")
    np.testing.assert_allclose(np_of(aux.depth), np_of(jaux.depth), rtol=0,
                               atol=IMG_ATOL, err_msg=f"{what} depth")
    np.testing.assert_array_equal(np_of(aux.tile_counts),
                                  np_of(jaux.tile_counts))
    for name in ("n_overflowed_tiles", "n_slot_truncated"):
        np.testing.assert_array_equal(np_of(getattr(aux, name)),
                                      np_of(getattr(jaux, name)), name)


# (port overrides, reference overrides): K1's semantics with the early stop
# at K % 128 == 0; the padded route at 200 against the XLA fallback; and a
# capacity that overflows (the nearest K kept)
XLA = dict(backend="xla", chunk=40)
ROUTES = {
    "k1": (dict(tile_capacity=256),
           dict(tile_capacity=256)),
    "padded": (dict(tile_capacity=200, term_eps=None),
               dict(tile_capacity=200, term_eps=None, **XLA)),
    "padded_term_eps": (dict(tile_capacity=200),
                        dict(tile_capacity=200, **XLA)),
    "overflow": (dict(tile_capacity=128, max_tiles_per_gaussian=4,
                      buckets=None),
                 dict(tile_capacity=128, max_tiles_per_gaussian=4,
                      buckets=None)),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_rasterize_matches(route):
    mine_kw, ref_kw = ROUTES[route]
    cfg = torch_raster(**mine_kw)
    jcfg = jax_raster(**{k: v for k, v in ref_kw.items() if k not in XLA})
    jcfg = jcfg._replace(**{k: v for k, v in ref_kw.items() if k in XLA})
    scene, jscene = _scenes(n=400 if route == "overflow" else 300, seed=1)
    cam, jcam = _camera_pair(40, 28, z=-1.8 if route == "overflow" else -3.0)
    bg = (torch.tensor([0.3, 0.1, 0.6]), jnp.asarray([0.3, 0.1, 0.6]))
    got = tiles.rasterize(scene.means, scene.covs(), scene.colors_dc(),
                          scene.opacities(), cam, cfg, bg[0])
    want = jtiles.rasterize(jscene.means, jscene.covs(), jscene.colors_dc(),
                            jscene.opacities(), jcam, jcfg, bg[1])
    _check_render(got, want, "rasterize")
    assert float(got[1].alpha.max()) > 0.9
    if route == "overflow":
        assert int(got[1].n_overflowed_tiles) > 0
        assert int(got[1].n_slot_truncated) > 0
    got = tiles.rasterize_raw(scene.means, scene.quats, scene.log_scales,
                              scene.colors_dc(), scene.opacities(), cam, cfg)
    want = jtiles.rasterize_raw(jscene.means, jscene.quats,
                                jscene.log_scales, jscene.colors_dc(),
                                jscene.opacities(), jcam, jcfg)
    _check_render(got, want, "rasterize_raw")


@pytest.mark.parametrize("fn", ["rasterize_sh", "rasterize_raw_sh"])
def test_rasterize_sh_matches(fn):
    scene, jscene = _scenes(n=250, seed=2, sh_degree=3)
    cam, jcam = _camera_pair(33, 47)
    cfg, jcfg = torch_raster(tile_capacity=256), jax_raster(tile_capacity=256)
    if fn == "rasterize_sh":
        got = tiles.rasterize_sh(scene.means, scene.covs(), scene.sh_coeffs(),
                                 scene.opacities(), cam, 3, cfg)
        want = jtiles.rasterize_sh(jscene.means, jscene.covs(),
                                   jscene.sh_coeffs(), jscene.opacities(),
                                   jcam, 3, jcfg)
    else:
        got = tiles.rasterize_raw_sh(scene.means, scene.quats,
                                     scene.log_scales, scene.sh_coeffs(),
                                     scene.opacities(), cam, 3, cfg)
        want = jtiles.rasterize_raw_sh(jscene.means, jscene.quats,
                                       jscene.log_scales, jscene.sh_coeffs(),
                                       jscene.opacities(), jcam, 3, jcfg)
    _check_render(got, want, fn)


@pytest.mark.parametrize("capacity", [256, 200])
def test_rasterize_batch_matches_each_env(capacity):
    """(B, N) gaussians under one camera: env b's image, alpha, depth and
    counters are those of the reference rendering env b alone, and the port
    composites all B·T tiles in one call of K1's wrapper."""
    scene, jscene = _scenes(n=200, seed=3)
    cam, jcam = _camera_pair(40, 28)
    rng = np.random.default_rng(3)
    shift = rng.normal(0, 0.15, (3, 1, 3)).astype(np.float32)
    means = np_of(scene.means)[None] + shift
    cfg = torch_raster(tile_capacity=capacity)
    jcfg = jax_raster(tile_capacity=capacity)
    if capacity % 128:
        jcfg = jcfg._replace(term_eps=None, **XLA)
    calls = []
    real = composite.composite_static

    def counted(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    composite.composite_static = counted
    try:
        img, aux = tiles.rasterize_raw(torch.as_tensor(means), scene.quats,
                                       scene.log_scales, scene.colors_dc(),
                                       scene.opacities(), cam, cfg)
    finally:
        composite.composite_static = real
    assert calls == [(3, 6, 10, -(-capacity // 128) * 128)]
    assert img.shape == (3, 28, 40, 3) and aux.alpha.shape == (3, 28, 40)
    for b in range(3):
        want = jtiles.rasterize_raw(jnp.asarray(means[b]), jscene.quats,
                                    jscene.log_scales, jscene.colors_dc(),
                                    jscene.opacities(), jcam, jcfg)
        got = (img[b], tiles.RasterAux(*(None if f is None else f[b]
                                         for f in aux)))
        _check_render(got, want, f"env {b}")


@pytest.mark.parametrize("shared_colors", [True, False])
def test_batched_gather_tile_lists_exact(shared_colors):
    """(B, N) projected gaussians → (B, T, K, ·) lists, each env's gathered
    from its own row of the sorted keys: equal, bit for bit, to the
    reference's ``gather_tile_lists`` of that env alone (half the gaussians
    tie on three depths, so the stable tie-break is under test); colours
    and opacities shared by the envs or per env."""
    from sim_a_splat_tpu.ops.projection import Projected as JProjected
    from sim_a_splat_torch.ops.projection import Projected
    rng = np.random.default_rng(21)
    B, n, tx, ty = 3, 300, 4, 3
    f = np.float32
    depth = rng.uniform(1, 50, (B, n)).astype(f)
    depth[:, : n // 2] = rng.choice([4.0, 7.5, 20.0], (B, n // 2))
    valid = rng.uniform(size=(B, n)) > 0.1
    d = dict(xy=rng.uniform(-12, tx * 16 + 12, (B, n, 2)).astype(f),
             depth=depth,
             conic=np.abs(rng.normal(0.2, 0.1, (B, n, 3))).astype(f),
             radius=np.where(valid, np.ceil(rng.exponential(6.0, (B, n))),
                             0).astype(f),
             valid=valid)
    shape = () if shared_colors else (B,)
    colors = rng.uniform(0, 1, shape + (n, 3)).astype(f)
    op = rng.uniform(0, 1.2, shape + (n,)).astype(f)
    cfg = dict(tile_capacity=128, max_tiles_per_gaussian=9)
    mine, counts, trunc = tiles.gather_tile_lists(
        Projected(**{k: torch.as_tensor(v) for k, v in d.items()}),
        torch.as_tensor(colors), torch.as_tensor(op), torch_raster(**cfg),
        tx, ty)
    assert mine[0].shape == (B, tx * ty, 128, 2)
    for b in range(B):
        ref, rcounts, rtrunc = jtiles.gather_tile_lists(
            JProjected(**{k: jnp.asarray(v[b]) for k, v in d.items()}),
            jnp.asarray(colors if shared_colors else colors[b]),
            jnp.asarray(op if shared_colors else op[b]), jax_raster(**cfg),
            tx, ty)
        np.testing.assert_array_equal(np_of(counts[b]), np_of(rcounts))
        assert int(trunc[b]) == int(rtrunc)
        for m, r in zip(mine, ref):
            np.testing.assert_array_equal(np_of(m[b]), np_of(r))


@pytest.mark.parametrize("sigma_cutoff,term_eps", [(3.0, 1e-4),
                                                   (None, None)])
def test_batched_k1_plain_matches_vmapped_pallas(sigma_cutoff, term_eps):
    """K1's plain forward and backward over (B, T, 10, K) against
    ``jax.vmap`` of ``composite_pallas`` (interpret mode) and its vjp."""
    ins = [k1_inputs(seed=0), k1_case_inputs(seed=4)]
    T = min(a[0].shape[0] for a in ins)
    pay, counts, skip = (np.stack([a[i][:T] for a in ins]) for i in range(3))
    ct = np.random.default_rng(13).normal(
        size=(2, T, K_TS * K_TS, 8)).astype(np.float32)

    def one(p, c, s):
        return jk1.composite_pallas(p, c, s, K_TS, K_TX, sigma_cutoff, True,
                                    term_eps)

    want, vjp = jax.vjp(lambda p: jax.vmap(one)(p, jnp.asarray(counts),
                                                 jnp.asarray(skip)),
                        jnp.asarray(pay))
    want_g = np_of(vjp(jnp.asarray(ct))[0])
    args = [torch.as_tensor(a) for a in (pay, counts, skip)]
    out, carries = composite.composite_static_plain(*args, K_TS, K_TX,
                                                    sigma_cutoff, term_eps)
    assert out.shape == (2, T, K_TS * K_TS, 8)
    np.testing.assert_allclose(np_of(out[..., :5]), np_of(want)[..., :5],
                               rtol=0, atol=2e-5)
    for b in range(2):        # each env as composited alone
        alone, alone_car = composite.composite_static_plain(
            *(a[b] for a in args), K_TS, K_TX, sigma_cutoff, term_eps)
        assert torch.equal(out[b], alone) and torch.equal(carries[b],
                                                          alone_car)
    got_g = composite.composite_static_bwd_plain(
        *args, torch.as_tensor(ct), K_TS, K_TX, sigma_cutoff, term_eps)
    assert got_g.shape == pay.shape
    assert_rows_close(got_g, want_g, 1e-4, "batched K1 payload grad")
    # the wrapper's autograd Function on CPU tensors takes the env axis too
    leaf = args[0].clone().requires_grad_()
    out_f, _ = composite.composite_static(leaf, *args[1:], K_TS, K_TX,
                                          sigma_cutoff, term_eps)
    (out_f * torch.as_tensor(ct)).sum().backward()
    assert torch.equal(out_f, out)
    torch.testing.assert_close(leaf.grad, got_g, rtol=0, atol=0)


def test_k1_wrappers_check_env_axis():
    pay, counts, skip = (torch.as_tensor(a) for a in k1_inputs())
    pay2 = torch.stack([pay, pay])
    with pytest.raises(ValueError, match="counts"):
        composite.composite_static(pay2, counts, skip, K_TS, K_TX)
    with pytest.raises(ValueError, match="payload"):
        composite.composite_static(pay2[None], counts, skip, K_TS, K_TX)
    out, car = composite.composite_static(pay2, torch.stack([counts] * 2),
                                          torch.stack([skip] * 2), K_TS,
                                          K_TX)
    with pytest.raises(ValueError, match="ct"):
        composite.composite_static_bwd(
            pay2, torch.stack([counts] * 2), torch.stack([skip] * 2), out[0],
            out, car, K_TS, K_TX)


W = H = 64


def _states(seed, B):
    rng = np.random.default_rng(seed)
    vectors = random_state_vectors(rng, B)
    actions = (vectors[:, 2:4] + rng.normal(0, 10, (B, 2))).astype(np.float32)
    jstates, snp = jax_pusht_states(vectors)
    return jstates, pusht.state_from_numpy(snp, device="cpu"), actions


def _check_states(ns, jns):
    for name in ("agent_pos", "block_pos", "agent_vel", "block_vel"):
        np.testing.assert_allclose(np_of(getattr(ns, name)),
                                   np_of(getattr(jns, name)), atol=1e-3,
                                   err_msg=name)
    np.testing.assert_allclose(np_of(ns.block_angle), np_of(jns.block_angle),
                               atol=1e-4)
    np.testing.assert_array_equal(np_of(ns.n_contacts), np_of(jns.n_contacts))


def _make_step_pair(seed, B=3):
    graph = graft._build_scene(n_bg=256, n_block=64, n_agent=32, seed=seed,
                               sh_degree=3)
    jstates, states, actions = _states(seed, B)
    jstep, _ = graft._make_step(graph, W, H, jax_raster(**BENCH))

    def jrun(scene):
        return jax.vmap(lambda s, a: jstep(scene, s, a))(
            jstates, jnp.asarray(actions))

    g = entry.graph_from_numpy(graph_leaves(graph), device="cpu")
    step, _ = entry.make_step(g, W, H, torch_raster(**BENCH), device="cpu")
    return graph, jrun, g, step, states, torch.as_tensor(actions)


def _check_step(step, scene, states, actions, jns, jimgs):
    ns, imgs = step(scene, states, actions)
    assert imgs.shape == (actions.shape[0], 3, H, W)
    _check_states(ns, jns)
    np.testing.assert_allclose(np_of(imgs.permute(0, 2, 3, 1)), np_of(jimgs),
                               rtol=0, atol=IMG_ATOL)


def test_make_step_forward_matches_reference():
    graph, jrun, g, step, states, actions = _make_step_pair(seed=1)
    jns, jimgs = jax.jit(jrun)(graph.scene)
    _check_step(step, g.scene, states, actions, jns, jimgs)


def test_make_step_train_matches_reference():
    graph, jrun, g, step, states, actions = _make_step_pair(seed=0)

    def jloss(scene):
        ns, imgs = jrun(scene)
        return jnp.mean(imgs ** 2), (ns, imgs)

    (jl, (jns, jimgs)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(graph.scene)
    _check_step(step, g.scene, states, actions, jns, jimgs)

    ns2, loss, n_drop, grads = entry.loss_and_grads(None, step, g.scene,
                                                    states, actions)
    assert n_drop is None
    _check_states(ns2, jns)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert not bool(grads.sh_rest.any()) and not np.any(np_of(jgrads.sh_rest))
    assert_fields_close(grads._replace(sh_rest=None),
                        jgrads._replace(sh_rest=None), 1e-4)
    assert not any(f.requires_grad for f in g.scene)   # inputs untouched


def test_unread_scene_field_is_zero_only_where_declared():
    """Only the fields a step declares unread get a zero gradient; a field
    that lost its link to the loss anywhere else is an error."""
    scene = loaders.synthetic_scene(16, seed=0, sh_degree=1, device="cpu")

    def fn(leaves):     # reads no sh_rest
        return (leaves.means.sum() + leaves.sh_dc.sum()
                + leaves.quats.sum() + leaves.log_scales.sum()
                + leaves.logit_opacities.sum()),

    _, _, grads = entry._value_and_grads(scene, fn, unread=("sh_rest",))
    assert torch.equal(grads.sh_rest, torch.zeros_like(scene.sh_rest))
    assert torch.equal(grads.means, torch.ones_like(scene.means))
    with pytest.raises(RuntimeError):
        entry._value_and_grads(scene, fn)


def test_entry_matches_reference():
    jstep, (jscene, jstate, jaction) = graft.entry()
    jns, jimg = jax.jit(jstep)(jscene, jstate, jaction)
    step, (scene, states, actions) = entry.entry(device="cpu")
    assert scene.means.shape == jscene.means.shape
    np.testing.assert_array_equal(np_of(scene.means), np_of(jscene.means))
    np.testing.assert_array_equal(np_of(actions[0]), np_of(jaction))
    ns, imgs = step(scene, states, actions)
    assert imgs.shape == (1, 3, 128, 128)
    np.testing.assert_allclose(np_of(imgs[0].permute(1, 2, 0)), np_of(jimg),
                               rtol=0, atol=IMG_ATOL)
    _check_states(type(ns)(*(f[0] for f in ns)), jns)


@pytest.mark.parametrize("entry_point", ["make_step", "entry"])
def test_cuda_without_card_raises(entry_point):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the no-card refusal")
    g = entry.build_scene(64, 32, 16, device="cpu")
    calls = {"make_step": lambda: entry.make_step(g, W, H, torch_raster()),
             "entry": lambda: entry.entry()}
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry_point]()          # each defaults to device="cuda"
