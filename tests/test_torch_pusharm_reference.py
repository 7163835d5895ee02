"""The arm deployment against the benchmark's plain reference
(``perfbench/reference/pusharm.py``), on the CPU at a small size: the
product scene at N = 3,000 from a seed, both cameras at 48×64, B = 2 envs
through the collect step (``entry.make_product_collect``), driven by the
cell's own system (``perfbench/systems/pusharm.py``) in episodes of 4
steps, so that an episode's build and the rebuilds past the margin budget
both run.

Tolerances, and why (``tests/test_torch_arm.py``'s and
``tests/test_torch_wrapper.py``'s reasons):
- FK, the PD step and the link posing: atol 1e-5 (float32 quaternion
  products and the same elementwise operations in the same order);
- one contact substep and the whole env step: joints atol 1e-5, the
  block's position and yaw atol 1e-4, its velocities atol 1e-3 (the clamps
  of ten float32 PGS iterations switch on last-bit differences);
- images: atol 6e-4 (``NEAR_ATOL``: both cameras sit inside the background
  cloud, where a gaussian a few centimetres from a lens projects with an
  ill-conditioned conic), up to 0.5 % of the values within 0.012 (an entry
  switched at the 3σ or the 1/255 cut-off, at most op·e^−4.5 times a
  colour ≤ 1.2), and the reference composites every list to its end where
  the program stops a tile under ``term_eps`` = 1e-4;
- the rebuild decisions, the counter and the severe and bounded counts:
  exact (the same binning, sorts stable on both sides), a budget within
  the configuration's ``rebuild_band`` of the threshold admitting either
  decision;
- the bfloat16 reference in the program's place fails at least one of the
  configuration's limits (the benchmark's control).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sim_a_splat_torch import entry
from sim_a_splat_torch.ops import composite_single
from sim_a_splat_torch.physics import kinematics as kin
from sim_a_splat_torch.splat.scene import GaussianScene
from sim_a_splat_torch.utils import profiling

from perfbench.harness import bench as harness
from perfbench.harness import guard
from perfbench.harness import trace as tr
from perfbench.reference import pusharm as ref_mod
from perfbench.reference import pusharm_scene
from perfbench.roofline import k3f, kernels
from perfbench.roofline.peaks import ALPHA_FLOPS, BLEND_FLOPS
from perfbench.systems import pusharm

ROOT = Path(__file__).resolve().parent.parent
NEAR_ATOL, FLIP_ATOL, FLIP_SHARE = 6e-4, 0.012, 0.005
SEED = 2190000005
STEPS = 7


def small_config():
    cfg = harness.load_config("pusharm6_100k_sh3")
    return dict(cfg, n_gaussians=3000, render_size=[48, 64])


def small_mix(name, batch):
    mix = json.loads((ROOT / "perfbench" / "traffic" / f"{name}.json")
                     .read_text())
    mix.update(batch=batch, settle=5, window_phase=2,
               check={"steps": 2, "before": STEPS - 1, "envs": batch})
    mix["walk"] = dict(mix["walk"], steps=4)
    return mix


@pytest.fixture(scope="module")
def run():
    """The datagen system at the small size after STEPS steps, every step's
    record kept, and its plain reference."""
    cfg = small_config()
    system = pusharm.System(cfg, small_mix("datagen_b8", 2), SEED, "cpu")
    records = []
    for _ in range(STEPS):
        system.step()
        records.append(system.last[1])
    return system, records, pusharm.Reference(cfg, system.leaves,
                                              system.link_ids)


def assert_images_close(got, want, what):
    d = (got.float() - want.float()).abs()
    off = int((d > NEAR_ATOL).sum())
    assert got.shape == want.shape, what
    assert float(d.max()) <= FLIP_ATOL and off <= FLIP_SHARE * d.numel(), \
        f"{what}: max|Δ| {float(d.max()):.3e}, {off} of {d.numel()} past " \
        f"{NEAR_ATOL}"


@pytest.mark.parametrize("part", ["fk", "pd_step", "contact_substep",
                                  "env_step"])
def test_physics_matches_the_reference(run, part):
    system, records, ref = run
    env = system.wrapper.env
    g = torch.Generator().manual_seed(11)
    lo, hi = ref.c["lo"], ref.c["hi"]
    q = lo + (hi - lo) * torch.rand((5, lo.numel()), generator=g)
    if part == "fk":
        got = kin.fk(env.chain, q)
        want = ref.fk(q)
        torch.testing.assert_close(got.q, want[0], atol=1e-5, rtol=0)
        torch.testing.assert_close(got.t, want[1], atol=1e-5, rtol=0)
        return
    s0 = records[2]["s0"]
    if part == "pd_step":
        target = s0.arm.q + 0.05 * torch.randn(s0.arm.q.shape, generator=g)
        got = kin.arm_step(env.chain, s0.arm, target)
        want = ref.pd_step(ref_mod.as_state(s0, torch.float32).arm, target)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        return
    if part == "contact_substep":
        # the end effector sweeping into the crossbar's near edge
        yaw = s0.block_yaw
        edge = torch.stack([-0.03 * torch.sin(yaw), 0.03 * torch.cos(yaw)],
                           -1) * -1.0
        exy = s0.block_pos + edge
        vel = torch.tensor([[0.05, 0.3], [-0.2, 0.4]])
        got = env._block_substep(s0, exy, vel, 0.0025)
        want = ref.block_substep(ref_mod.as_state(s0, torch.float32), exy,
                                 vel, 0.0025)
        assert bool((want.block_vel.abs() > 0).any()), "no contact"
    else:
        got = env.step(s0, records[2]["a"]).state
        want = ref.step(s0, records[2]["a"])
    for name in ("q", "qd", "target_prev"):
        torch.testing.assert_close(getattr(got.arm, name),
                                   getattr(want.arm, name), atol=1e-5,
                                   rtol=0)
    for name, atol in (("block_pos", 1e-4), ("block_yaw", 1e-4),
                       ("block_vel", 1e-3), ("block_omega", 1e-3)):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   atol=atol, rtol=0)


def test_link_posing_matches_the_reference(run):
    system, records, ref = run
    w = system.wrapper
    s = records[3]["new"]
    dyn = w.graph.scene.select(w._split[1])
    means, quats = w._pose_dynamics(w.env.draw_state(s), dyn)
    for b in range(system.B):
        want_m, want_q = ref.posed(ref_mod.as_state(s, torch.float32), b)
        torch.testing.assert_close(means[b], want_m, atol=1e-5, rtol=0)
        torch.testing.assert_close(quats[b], want_q, atol=1e-5, rtol=0)


@pytest.mark.parametrize("camera", ["eef", "view"])
def test_camera_images_match_the_reference(run, camera):
    system, records, ref = run
    envs = list(range(system.B))
    for i, r in enumerate(records):
        eef, view, _, _ = ref.frames(r["new"], r["build_q"], envs)
        want = eef if camera == "eef" else view
        assert_images_close(r[camera], want, f"{camera}, step {i}")


def test_rebuild_decisions_and_counts_match_the_reference(run):
    """Every step's rebuild decision against the reference's budget, and
    the severe and bounded counts of both cameras, exactly; the check of
    the cell reads the same."""
    system, records, ref = run
    cfg = system.cfg
    limit, band = cfg["rebuild_budget"], cfg["rebuild_band"]
    decided = rebuilt = 0
    for r in records:
        eef, view, severe, bounded = ref.frames(r["new"], r["build_q"],
                                                range(system.B))
        assert int(r["bounded"]) == bounded
        assert severe == 0
        if r["prev_q"] is None:
            continue
        for b in range(system.B):
            used = ref.budget_used(ref.build(r["prev_q"][b], lists=False),
                                   r["new"].arm.q[b])
            if abs(used - limit) > band * limit:
                decided += 1
                assert (used > limit) == bool(r["rebuilt"][b]), (used, b)
            rebuilt += int(r["rebuilt"][b])
    assert decided > 0 and rebuilt > 0
    assert system.check()["rebuild_gap"] == 0


def test_collect_step_records_its_spans_and_rebuild_counter(run):
    system, records, _ = run
    w, r = system.wrapper, records[-1]
    was = profiling.enabled()
    profiling.clear()
    profiling.enable(True)
    try:
        with torch.no_grad():
            # caches built from the state of four steps before: a rebuild
            mc = w.build_moving_caches(w.env.draw_state(records[-4]["s0"]),
                                       **system.build_kw)
            out, _ = system.collect(r["s0"], r["a"],
                                    w.build_render_cache(), mc)
        (root,) = profiling.roots("step.arm")
        events = [c for c in profiling.counter_events()
                  if c.name == "render.moving_rebuilds"]
    finally:
        profiling.enable(was)
        profiling.clear()
    for name in ("physics", "physics.arm", "physics.info", "render.cameras",
                 "render.moving", "render.moving_build"):
        assert root.calls.get(name, 0) == 1, (name, root.calls)
    assert root.calls["physics.solve"] == 4
    n = int(out.info["render_rebuilt"].sum())
    assert n > 0 and [(e.step, e.value) for e in events] == [(root.step, n)]


def test_a_pose_past_the_budget_is_rebuilt_and_exact(run):
    """Caches built at one state, the arm then driven far from it: the
    rollout's path (caches kept) flags the frame severe, as the reference
    does over the same caches; the collect step rebuilds every env and
    returns a frame that is not severe and equals the reference's over
    caches built at the new state.  (Not the full rebin's: the near set's
    wide footprints are cut at ``dyn_max_tiles`` slots, bounded
    truncations that the reference models and the rebin does not.)"""
    system, records, ref = run
    w, r = system.wrapper, records[1]
    kw = {k: system.cfg[k] for k in ("sel_tiles", "dyn_capacity",
                                     "dyn_max_tiles")}
    far = r["a"] + torch.tensor([0.25, -0.2, 0.3, 0.0, 0.0, 0.0])
    with torch.no_grad():
        caches = w.build_render_cache()
        mc = w.build_moving_caches(w.env.draw_state(r["s0"]),
                                   **system.build_kw)
        old = w.step_with_cache_batch(r["s0"], far, caches, moving_caches=mc,
                                      **kw)
        new, _ = system.collect(r["s0"], far, caches, mc)
    assert int(old.info["render_overflow"][0]) > 0
    _, _, severe_old, _ = ref.frames(old.state, r["s0"].arm.q,
                                     range(system.B))
    assert severe_old > 0
    assert new.info["render_rebuilt"].tolist() == [1] * system.B
    assert int(new.info["render_overflow"][0]) == 0
    eef, _, severe, _ = ref.frames(new.state, new.state.arm.q,
                                   range(system.B))
    assert severe == 0
    assert_images_close(new.obs["camera_0"], eef, "against the reference")


def test_the_benchmark_scene_is_the_sources_draws(run):
    """The scene the cell draws for itself (``pusharm_scene``) is the
    source's draws for the seed, as the program draws them: the same masks
    and fields (means within float32 rounding of the links' rest
    positions, which each side composes in its own precision)."""
    system, _, _ = run
    scene, masks = entry.product_scene(3000, 3, SEED, device="cpu")
    _, ids, want_masks = pusharm_scene.arm_scene(system.cfg, SEED, "cpu")
    assert sorted(masks) == sorted(want_masks)
    for k, m in masks.items():
        assert (m == want_masks[k]).all(), k
    for k, v in system.leaves.items():
        torch.testing.assert_close(getattr(scene, k), v, atol=1e-6, rtol=0)
    assert torch.equal(system.wrapper.graph.link_ids, ids)


@pytest.mark.parametrize("fault", ["shifted", "swapped"])
def test_a_wrong_link_split_in_the_program_fails_the_check(run, fault):
    """A program that splits the scene wrongly (every mask shifted by a
    quarter of a link's cluster, or two links' masks swapped) renders
    images that the reference, posing the scene's own split, holds past
    the configuration's ``image_gap``."""
    system, records, ref = run
    cfg = system.cfg
    leaves, _, masks = pusharm_scene.arm_scene(cfg, SEED, "cpu")
    if fault == "shifted":
        shift = int(cfg["n_gaussians"]) // int(cfg["link_share"]) // 4
        masks = {k: np.roll(m, shift) for k, m in masks.items()}
    else:
        masks["link2"], masks["link4"] = masks["link4"], masks["link2"]
    w = entry.build_product_wrapper(
        render_size=tuple(cfg["render_size"]), device="cpu",
        scene=GaussianScene(**leaves), link_masks=masks,
        raster=system.wrapper.raster)
    r = records[2]
    with torch.no_grad():
        out, _ = entry.make_product_collect(w)(r["s0"], r["a"],
                                               w.build_render_cache())
    rebuilt = out.info["render_rebuilt"].bool()[:, None]
    build_q = torch.where(rebuilt, out.state.arm.q, r["s0"].arm.q)
    eef, view, _, _ = ref.frames(out.state, build_q, range(system.B))
    gap = max(pusharm._gap(out.obs["camera_0"], eef),
              pusharm._gap(out.obs["camera_1"], view))
    assert gap > cfg["limits"]["image_gap"], gap


def test_the_bfloat16_reference_fails_a_limit(run):
    system, _, _ = run
    limits = system.cfg["limits"]
    low = system.control(torch.bfloat16)
    assert any(v > limits[k] for k, v in low.items()), low


def test_the_k3f_count_follows_the_plain_kernels_work(run):
    """``perfbench/roofline/k3f.py`` counts the entries and α > 0 pairs
    that K3f's plain version reports composited, on a collect step's own
    K3 call."""
    system, records, _ = run
    r = records[-1]
    caps = tr.Captures([k3f.CAPTURE])
    caps.on = True
    with tr.patched(caps.wrappers({})), torch.no_grad():
        system.collect(r["s0"], r["a"], system.wrapper.build_render_cache(),
                       None)
    (args,) = caps.args[k3f.CAPTURE]
    _, applied, hits = composite_single.composite_sel_single_plain(
        *args, return_work=True)
    spay, ids, counts, ts = args[:4]
    K = spay.shape[-1]
    cnt = counts[torch.arange(ids.shape[0])[:, None], ids.long()].long()
    c0 = torch.arange(K // 128) * 128
    entries = int((torch.clamp(cnt[..., None] - c0, 0, 128)
                   * (torch.arange(K // 128) < applied[..., None])).sum())
    flops, nbytes = k3f.work(args)
    P = ts * ts
    assert flops == ALPHA_FLOPS * P * entries + BLEND_FLOPS * int(hits.sum())
    assert nbytes == entries * 40 + ids.numel() * 8 * (1 + 4 * P)
    assert k3f in kernels()


def test_the_cells_check_reads_correct(run):
    """The cell's own check on the small run: every reading within the
    configuration's limit, its reference importing nothing of the
    program (the harness itself refuses a process holding JAX, as this
    suite's does)."""
    system, _, _ = run
    assert guard.reference_violations() == []
    readings = dict(system.check(), severe=system.counters()[1])
    assert set(readings) == set(pusharm.READINGS)
    for k, v in readings.items():
        assert v <= system.cfg["limits"][k], (k, v)
    assert readings["state_gap"] <= 1e-5
