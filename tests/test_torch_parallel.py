"""The port's distributed layer (``sim_a_splat_torch/parallel``,
``entry.dryrun_multichip``) against the reference's, on the CPU.

The port's ranks are processes of one gloo process group started by
``parallel.launch`` (``spawn``; their functions are in ``torch_ranks.py``),
each launch bounded by a timeout so that a hang fails the test.  The
reference runs here, in the test process, on conftest's virtual CPU
devices (a prim=2 mesh for its sharded render, an 8-way env mesh for its
train step, an env 2 × prim 2 mesh for its dry run's six branches).

Tolerances: the sharded image atol 3e-5 / rtol 1e-4 and its gradient to
the means atol 1e-4 / rtol 5e-3 (the reference's own
``tests/test_parallel.py``); the rollout atol 1e-5 against the port's own
unsharded rollout and, against the reference's, also rtol 1e-6 (a few
float32 ulps of positions up to 400 px); the train step 1e-6; the
two-process means
rtol 1e-5 (``tests/test_distributed.py``); the dry run's loss against the
same six branches in one process and against the reference's on the same
states 1e-5 relative, its gradient against the one-process gradient 1e-5
× each field's largest.

Where a shard holds more candidates for a tile than ``send_capacity``, the
sharded render keeps each shard's nearest ``send_capacity`` and so differs
from the single-device render by design (the reference's too).  At prim=2
the 333-gaussian scene sends 129 candidates from one shard into one tile,
so at the reference test's send 128 both sharded renders drop one: that
case is held to the reference's ``rasterize_sharded`` and the one-process
``rasterize_prim_shards``; at a send capacity of the whole list no shard
truncates and the render is held to the reference's ``rasterize`` too.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_ranks
from sim_a_splat_tpu.ops.projection import Camera as JCamera
from sim_a_splat_tpu.ops.rasterize_tiles import (
    RasterConfig as JRasterConfig, rasterize as jrasterize,
)
from sim_a_splat_tpu.ops.transforms import SE3 as JSE3
from sim_a_splat_tpu.parallel import (
    make_mesh as jmake_mesh, make_train_step as jmake_train_step,
    rasterize_sharded as jrasterize_sharded,
)
from sim_a_splat_tpu.physics import pusht as jpusht
from sim_a_splat_tpu.physics.pusht import PushTParams as JPushTParams
from sim_a_splat_tpu.splat import synthetic_scene as jsynthetic_scene

from sim_a_splat_torch import entry
from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
from sim_a_splat_torch.parallel import initialize_distributed, launch
from sim_a_splat_torch.parallel.render_sharding import rasterize_prim_shards

TIMEOUT_S = 240.0       # each launch: a hang fails the test, not the suite
ATOL, RTOL = 3e-5, 1e-4
B_ROLL, H_ROLL = 8, 5

# scene, camera (q, t, fov, width, height), raster
SCENES = {
    # tests/test_parallel.py's sharded-render scene
    "parallel": (lambda: jsynthetic_scene(333, seed=0, extent=0.8,
                                          scale_range=(0.03, 0.1)),
                 ((1.0, 0.0, 0.0, 0.0), (0.0, 0.0, -3.0), 0.8, 48, 32),
                 dict(tile_capacity=512, chunk=64, sigma_cutoff=3.0)),
    # the dry run's scene and camera: whole groups of gaussians at one depth
    "tie": (lambda: _tie_scene(),
            ((1.0, 0.0, 0.0, 0.0), (149.0, 256.0, -450.0), 1.05, 32, 32),
            dict(tile_size=16, tile_capacity=64, max_tiles_per_gaussian=9,
                 chunk=32, sigma_cutoff=3.0)),
    # tests/test_parallel.py's gradient scene
    "grad": (lambda: jsynthetic_scene(64, seed=1, extent=0.6,
                                      scale_range=(0.05, 0.1)),
             ((1.0, 0.0, 0.0, 0.0), (0.0, 0.0, -3.0), 0.8, 16, 16),
             dict(tile_capacity=128, chunk=32, sigma_cutoff=3.0)),
}
# (scene, send capacity, held to the reference's single-device rasterize)
RENDER_CASES = [("parallel", 128, False), ("parallel", 512, True),
                ("tie", 32, False), ("tie", 64, True), ("grad", 32, True)]


def _tie_scene():
    from __graft_entry__ import _build_scene
    return _build_scene(n_bg=256, n_block=64, n_agent=32).scene


def _jcamera(cam):
    q, t, fov, w, h = cam
    return JCamera.from_fov(JSE3(jnp.asarray(q), jnp.asarray(t)), fov, w, h)


def _scene_arrays(name):
    s = SCENES[name][0]()
    return {"means": np.asarray(s.means), "covs": np.asarray(s.covs()),
            "colors": np.asarray(s.colors_dc()),
            "opacities": np.asarray(s.opacities())}


def _reference_vecs(B, seed=0):
    P = JPushTParams()
    keys = jax.random.split(jax.random.key(seed), B)
    return np.asarray(jax.vmap(lambda k: jpusht.sample_reset_state(P, k))(
        keys))


@pytest.fixture(scope="module")
def two_ranks():
    """One launch of 2 gloo ranks on the CPU running every 2-rank job of
    this file → ({job: [rank 0's result, rank 1's]}, the jobs' inputs)."""
    arrays = {name: _scene_arrays(name) for name in SCENES}
    jobs = {}
    for name, send, _ in RENDER_CASES:
        _, cam, raster = SCENES[name]
        jobs[f"{name}/{send}"] = ("sharded_render", dict(
            scene=arrays[name], cam=cam, raster=raster, send_capacity=send,
            prim=2, grad=name == "grad"))
    vecs = _reference_vecs(B_ROLL)
    actions = np.tile(np.asarray([150.0, 250.0], np.float32),
                      (H_ROLL, B_ROLL, 1))
    jobs["rollout"] = ("pusht_rollout", dict(vecs=vecs, actions=actions))
    jobs["one_step"] = ("pusht_rollout", dict(vecs=vecs,
                                              actions=actions[:1]))
    batch = np.random.default_rng(0).normal(size=(32, 5)).astype(np.float32)
    jobs["train"] = ("linear_train", dict(batch=batch, steps=5, lr=0.1))
    jobs["mesh"] = ("mesh_checks", {})
    res = launch(torch_ranks.run_jobs, 2, "gloo", "cpu", jobs, "cpu",
                 timeout_s=TIMEOUT_S)
    out = {k: [r[k] for r in res] for k in jobs}
    return out, dict(arrays=arrays, vecs=vecs, actions=actions, batch=batch)


def test_initialize_distributed_without_configuration(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is False
    assert not torch.distributed.is_initialized()


def test_initialize_distributed_reports_explicit_failures(monkeypatch):
    """A partial explicit configuration (an address, no rank or world size)
    raises RuntimeError, never degrades to one process."""
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="explicit configuration"):
        initialize_distributed(backend="gloo",
                               init_method="tcp://127.0.0.1:1")
    assert not torch.distributed.is_initialized()


def test_make_mesh_and_shard_batch(two_ranks):
    res, _ = two_ranks
    for r, got in enumerate(res["mesh"]):
        assert got["prim_mesh"] == (("env", "prim"), (1, 2), (0, r))
        assert got["env_mesh"] == (("env", "prim"), (2, 1), (r, 0))
        np.testing.assert_array_equal(
            got["rows"]["x"], np.arange(8.0).reshape(4, 2)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["rows"]["n"][0],
                                      np.arange(4)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(
            got["rows_axis1"], np.arange(8).reshape(2, 4)[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["replicated"], np.zeros(3))
        np.testing.assert_array_equal(
            got["shard_vmap"], 2 * np.arange(8.0).reshape(4, 2)[2 * r:2 * r + 2])
        assert "cannot leave ranks out" in got["wrong_size"]
        assert "not divisible" in got["indivisible"]


@pytest.mark.parametrize("name,send,single", RENDER_CASES,
                         ids=[f"{n}-send{s}" for n, s, _ in RENDER_CASES])
def test_sharded_render_matches_reference(two_ranks, name, send, single):
    """The 2-rank render, the same image on both ranks, against the
    reference's ``rasterize_sharded`` on a prim=2 mesh (and its
    ``rasterize`` where no shard truncates) and against the port's
    one-process ``rasterize_prim_shards``."""
    res, inputs = two_ranks
    a = inputs["arrays"][name]
    _, cam, raster = SCENES[name]
    imgs = [r["img"] for r in res[f"{name}/{send}"]]
    np.testing.assert_array_equal(imgs[0], imgs[1])
    mesh = jmake_mesh(env=1, prim=2, devices=jax.devices()[:2])
    args = [jnp.asarray(a[k]) for k in ("means", "covs", "colors",
                                        "opacities")]
    ref_sh = jax.jit(lambda *x: jrasterize_sharded(
        mesh, *x, _jcamera(cam), JRasterConfig(**raster),
        send_capacity=send))(*args)
    np.testing.assert_allclose(imgs[0], np.asarray(ref_sh), atol=ATOL,
                               rtol=RTOL)
    if single:
        ref, aux = jrasterize(*args, _jcamera(cam), JRasterConfig(**raster))
        assert int(aux.n_overflowed_tiles) == 0 or name == "tie"
        np.testing.assert_allclose(imgs[0], np.asarray(ref), atol=ATOL,
                                   rtol=RTOL)
    one = rasterize_prim_shards(
        2, *(torch.tensor(a[k]) for k in ("means", "covs", "colors",
                                             "opacities")),
        torch_ranks._camera(cam, "cpu"), RasterConfig(**raster), send)
    np.testing.assert_allclose(imgs[0], one.numpy(), atol=1e-6, rtol=1e-6)


def test_sharded_render_gradient_on_every_rank(two_ranks):
    """The gradient of sum(img²) to the means, on each rank, against
    ``jax.grad`` of the reference's single-device ``rasterize``."""
    res, inputs = two_ranks
    a = inputs["arrays"]["grad"]
    _, cam, raster = SCENES["grad"]

    def loss_ref(means):
        img, _ = jrasterize(means, jnp.asarray(a["covs"]),
                            jnp.asarray(a["colors"]),
                            jnp.asarray(a["opacities"]), _jcamera(cam),
                            JRasterConfig(**raster))
        return jnp.sum(img ** 2)

    g_ref = np.asarray(jax.grad(loss_ref)(jnp.asarray(a["means"])))
    assert np.abs(g_ref).max() > 0
    for r in res["grad/32"]:
        np.testing.assert_allclose(r["grad_means"], g_ref, atol=1e-4,
                                   rtol=5e-3)


def _reference_reward(P, states):
    """The reference's reward and done, unjitted: under ``jax.jit`` XLA
    folds its goal area to 4,950 (ROADMAP §3), the port and the unjitted
    reference compute it as 6,300 (``test_torch_pusht_envs.py``)."""
    return jax.vmap(lambda s: jpusht.reward_done(P, s))(states)


def test_env_sharded_rollout(two_ranks):
    """B=8 envs, H=5 steps on 2 ranks (4 envs each): each rank's rows
    against the port's own rollout of all 8 envs in one process (atol 1e-5,
    the reference test's bound for its sharded against its unsharded
    rollout) and against the reference's vmapped rollout from the same
    reset states, to a few float32 ulps of each value (rtol 1e-6; the
    positions reach 400 px, where an ulp is 3e-5)."""
    from sim_a_splat_torch.physics import pusht
    res, inputs = two_ranks
    P = JPushTParams()
    vecs, actions = inputs["vecs"], inputs["actions"]

    states = jax.vmap(lambda v: jpusht.set_state(P, v))(jnp.asarray(vecs))
    step_j = jax.jit(jax.vmap(lambda s, a: jpusht.control_step(P, s, a)))
    obs, rew, done = [], [], []
    for t in range(H_ROLL):
        states = step_j(states, jnp.asarray(actions[t]))
        r, d = _reference_reward(P, states)
        obs.append(jax.vmap(jpusht.get_obs)(states))
        rew.append(r)
        done.append(d)
    obs, rew, done = (np.stack([np.asarray(x) for x in a])
                      for a in (obs, rew, done))
    Pt = pusht.PushTParams()
    st = pusht.set_state(Pt, torch.tensor(vecs))
    own = []
    for t in range(H_ROLL):
        st = pusht.control_step(Pt, st, torch.as_tensor(actions[t]))
        own.append(pusht.get_obs(st).numpy())
    own = np.stack(own)
    half = B_ROLL // 2
    for k, got in enumerate(res["rollout"]):
        rows = slice(k * half, (k + 1) * half)
        assert got["obs"].shape == (H_ROLL, half, 5)
        np.testing.assert_allclose(got["obs"], own[:, rows], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(got["obs"], obs[:, rows], atol=1e-5,
                                   rtol=1e-6)
        np.testing.assert_allclose(got["reward"], rew[:, rows], atol=1e-5)
        np.testing.assert_array_equal(got["done"], done[:, rows])


def test_two_process_mean_reward_and_block_position(two_ranks):
    """tests/test_distributed.py's check on the port: one control step of
    8 envs on 2 ranks, the env means of reward and block position equal on
    both ranks and to the reference's single-process means."""
    res, inputs = two_ranks
    P = JPushTParams()
    st = jax.jit(jax.vmap(lambda v: jpusht.control_step(
        P, jpusht.set_state(P, v), jnp.asarray([150.0, 250.0]))))(
        jnp.asarray(inputs["vecs"]))
    r, _ = _reference_reward(P, st)
    got = res["one_step"]
    assert got[0]["mean_r"] == got[1]["mean_r"]
    assert got[0]["mean_bp"] == got[1]["mean_bp"]
    np.testing.assert_allclose(got[0]["mean_r"], float(jnp.mean(r)),
                               rtol=1e-5)
    np.testing.assert_allclose(got[0]["mean_bp"],
                               float(jnp.mean(st.block_pos)), rtol=1e-5)


def test_train_step_replicated_params(two_ranks):
    """Five SGD steps of the data-parallel train step on 2 ranks against the
    reference's ``make_train_step`` on its 8-way env mesh."""
    import optax
    res, inputs = two_ranks
    batch = inputs["batch"]
    mesh = jmake_mesh()
    params = {"w": jnp.ones((5,)), "b": jnp.zeros(())}

    def loss_fn(p, x):
        return jnp.mean((x @ p["w"] + p["b"]) ** 2)

    opt = optax.sgd(0.1)
    step = jmake_train_step(loss_fn, opt, mesh)
    opt_state = opt.init(params)
    losses = []
    x = jax.device_put(jnp.asarray(batch), jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("env")))
    for _ in range(5):
        params, opt_state, loss = step(params, opt_state, x)
        losses.append(float(loss))
    for got in res["train"]:
        np.testing.assert_allclose(got["losses"], losses, atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(got["w"], np.asarray(params["w"]),
                                   atol=1e-6)
        np.testing.assert_allclose(got["b"], float(params["b"]), atol=1e-6)
    assert losses[-1] < losses[0]


def _reference_dryrun_loss(vecs):
    """The loss of the reference's ``dryrun_multichip(4)`` before its SGD
    step: its six branches as its ``loss_fn`` writes them (the same scene,
    configs and camera; the selected-tile batch under ``shard_map`` over
    env, the whole-scene render ``rasterize_sharded`` over prim) on an
    env 2 × prim 2 mesh of conftest's virtual devices, from the reset
    states ``vecs``."""
    import __graft_entry__ as graft
    from jax.sharding import PartitionSpec as JP
    from sim_a_splat_tpu.parallel import shard_batch as jshard_batch
    mesh = jmake_mesh(env=2, prim=2, devices=jax.devices()[:4])
    graph = graft._build_scene(n_bg=256, n_block=64, n_agent=32)
    raster = JRasterConfig(tile_size=16, tile_capacity=64,
                           max_tiles_per_gaussian=9, chunk=32,
                           sigma_cutoff=3.0)
    step, P = graft._make_step(graph, 32, 32, raster)
    raster_prod = JRasterConfig(tile_size=16, tile_capacity=128,
                                max_tiles_per_gaussian=9, chunk=32,
                                sigma_cutoff=3.0, backend="pallas_interpret",
                                term_eps=1e-4)
    prepare_c, step_c, _ = graft._make_step_cached(
        graph, 32, 32, raster_prod, dyn_capacity=128, static_skip=True,
        dyn_max_tiles=9)
    prepare_s, step_s, _ = graft._make_step_cached_batch(
        graph, 32, 32, raster_prod, dyn_capacity=128, sel_tiles=4,
        dyn_max_tiles=9)
    step_mv, _ = graft._make_step_moving(graph, 32, 32, raster._replace(
        buckets=((2, 0.5), (4, 0.3), (9, 0.2))))
    rollout_mc, _ = graft._make_step_moving_cached(
        graph, 32, 32, raster_prod, R=2, margin=8.0, kc=128,
        dyn_capacity=128, dyn_max_tiles=9)
    states = jshard_batch(mesh, jax.vmap(lambda v: jpusht.set_state(P, v))(
        jnp.asarray(vecs)))
    actions = jshard_batch(mesh, jnp.tile(
        jnp.asarray([150.0, 250.0], jnp.float32), (len(vecs), 1)))
    cam1 = _jcamera(((1.0, 0.0, 0.0, 0.0), (149.0, 256.0, -450.0), 1.05, 32,
                     32))

    def loss_fn(sc, states, actions):
        _, imgs = jax.vmap(lambda s, a: step(sc, s, a))(states, actions)
        cache = prepare_c(sc)
        _, imgs_c = jax.vmap(lambda s, a: step_c(cache, sc, s, a))(
            states, actions)
        imgs_s = jax.shard_map(
            lambda c, scene_, st, ac: step_s(c, scene_, st, ac)[1],
            mesh=mesh, in_specs=(JP(), JP(), JP("env"), JP("env")),
            out_specs=JP("env"), check_vma=False)(
                prepare_s(sc), sc, states, actions)
        _, imgs_m = jax.vmap(lambda s, a: step_mv(sc, s, a))(states, actions)
        _, l_mc, _ = rollout_mc(sc, states, actions)
        img1 = jrasterize_sharded(mesh, sc.means, sc.covs(), sc.colors_dc(),
                                  sc.opacities(), cam1, raster,
                                  send_capacity=32)
        return (jnp.mean(imgs ** 2) + jnp.mean(imgs_c ** 2)
                + jnp.mean(imgs_s ** 2) + jnp.mean(imgs_m ** 2) + l_mc
                + jnp.mean(img1 ** 2))

    return float(jax.jit(loss_fn)(graph.scene, states, actions))


def test_dryrun_multichip_four_ranks(capsys):
    """``dryrun_multichip(4)``'s six branches on 4 gloo ranks (env 2 × prim
    2) from the reference's reset draws (its keys): one loss on every rank
    (it raises where the ranks disagree) and the reference's report line;
    the loss equal to the reference's six branches on the same states and
    to the port's same loss computed in one process (every env, the prim
    render without collectives), and the gradient each rank's SGD step took
    (through the exchange, a mean over env) equal to that one-process
    loss's gradient, field by field."""
    vecs = _reference_vecs(4)
    res = entry.dryrun_ranks(4, "gloo", "cpu", vecs)
    loss = entry.dryrun_report(4, res)
    assert np.isfinite(loss)
    out = capsys.readouterr().out
    assert "dryrun_multichip(4): mesh={'env': 2, 'prim': 2}" in out
    assert f"loss={loss:.4f} ok [paths:" in out
    single, grads = entry.dryrun_single(4, device="cpu", vecs=vecs)
    np.testing.assert_allclose(loss, single, rtol=1e-5)
    np.testing.assert_allclose(loss, _reference_dryrun_loss(vecs), rtol=1e-5)
    for r in res:
        assert set(r["grads"]) == {k for k, g in grads._asdict().items()
                                   if g is not None}
        for k, g in r["grads"].items():
            want = getattr(grads, k)
            scale = float(want.abs().max())
            assert scale > 0, k
            np.testing.assert_allclose(g.numpy(), want.numpy(),
                                       atol=1e-5 * scale, rtol=0, err_msg=k)
