#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``sim_a_splat_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--parent DIR]

With ``--parent DIR`` (the root of another checkout, e.g. the parent
commit's ``git archive``) it also builds that checkout's K2, K3 and K4
kernels and times them on the same inputs, in turns with this tree's
(parent, this, this, parent), beside this tree's times; K2 and K3
through the parent's own wrappers (``ops/composite_sel.py``,
``ops/composite_single.py``), whose launch interfaces differ from this
tree's.

It builds the port's CUDA kernels from ``sim_a_splat_torch/csrc``, holds
each against its plain PyTorch version at the shapes of its path, and
drives the port's paths through its entry points, each forward and in
training, at N=100k gaussians, SH degree 3 (the pushT paths at 256×256):

- the fixed camera (K1f, K1b, K2f, K2b), B=128 envs: the batched pushT
  splat env step (``entry.make_step_cached_batch``) and its train step
  (``entry.loss_and_grads``: the mean-square image loss and its gradient
  to every gaussian parameter), with the pushT control step's kernel P1
  (``csrc/pusht_step.cu``, one launch a step) against the plain control
  step on those envs, timed beside its chain bound;
- the same envs through the reference's per-env fixed-camera step
  (``entry.make_step_cached``, K1f, K1b, K4f, K4b), B=128, forward and
  in training, its images against the selected-tile path's and its
  ``static_skip=False`` variant;
- K2 and K4 at ``dyn_capacity`` 4096 on 2 of those envs, past the
  dynamic windows of their backward kernels (and past the first design's
  card limits), against their plain versions in float64, and at
  ``dyn_capacity`` 1024 and tile size 32 (a window of 128 entries in the
  backward kernels), timed;
- the moving camera attached to each env's agent (K3f, K3b): the R=16
  frame candidate-cache rollout (``entry.make_step_moving_cached``) at
  B=32 forward and B=16 in training (``entry.rollout_loss_and_grads``,
  with its peak device memory), and one frame against the full per-frame
  rebin (``entry.make_step_moving``); and K3 in its shared-payload mode
  (one env's lists shared by the B=16 envs of a frame), which no caller
  runs, against its plain versions; and K2 (K2f, K2b) in its per-env mode,
  which no caller runs either, on one B=32 frame's reprojected statics and
  dynamic lists apart (256 tiles, Ks 512, Kd 128, the dense ids): one
  forward and backward through its autograd Function, against its plain
  versions, and each env's rows against the shared mode run on that env's
  lists alone, bit for bit;
- the uncached step (``entry.make_step``, the reference's ``_make_step``
  that its ``entry()`` returns; K1f, K1b with a leading env axis), B=128,
  forward and in training (``entry.loss_and_grads(None, step, ...)``):
  every env poses all N gaussians and renders all 256 tiles, one K1 launch
  over the B·T tiles; batched K1f/K1b against their plain versions and
  each env's rows against K1 run on that env alone, bit for bit;
- the arm product path (``benchmarks/bench_product.py``; K1f, K1b, K2f,
  K2b, K3f, K3b): ``entry.build_product_wrapper`` (pusharm6, a viewport
  and an end-effector camera at 240×320, a 15 × 20 tile grid) and
  ``entry.make_product_rollout``, B=8, R=32 frames after a 40-step settle,
  forward and in training (``entry.product_loss_and_grads``), the kernels
  against their plain versions at the path's inputs (the end-effector
  camera's near set on), the B=1 teleop step with its moving-cache rebuild
  timed apart, and the arm physics' share of the rollout; and the arm's
  control step's kernel P2 (``csrc/arm_step.cu``, one launch a step) at
  B=1 and B=8 against the plain step over 32 chained steps from the
  settled states, timed beside its chain bound;
- the env layer: ``PushTEnvF.step`` at B=128 in each observation mode
  (state, keypoints, 96² images) beside ``control_step`` and the reward
  alone, its reward, done and observation held to the port's CPU run on
  the same states; then the splat env built from asset files
  (``envs/splat_assets.py``, the gym-free core of ``SplatEnvWrapper``) on
  a 100k-gaussian ``build_demo_assets`` tree with the demo scripts' two
  cameras at 240×320: 10 task-space steps at B=1, each rendering both
  cameras through K1f (the step and the render timed apart), the images
  against K1's plain version, a free-camera render and one joint-space
  step rendered from ``examples/assets``;
- the example drivers (``sim_a_splat_torch/examples``) through their own
  functions at their own sizes (``examples/assets``, two 240×320 cameras):
  ``demo_pusht_splat --steps 3``, ``demo_joint_sliders_splat --steps 40``
  (frames written), ``demo_hw_splat --replay 20`` and ``demo_viewer
  --selftest`` (320×320), K1f's launches counted in each, each demo's
  frames after its run against K1's plain version;
- splat training (``splat/train.py``, K1f and K1b):
  ``benchmarks/train_scene.py``'s protocol at its full width
  (``entry.train_scene_inputs``: a 12,000-gaussian SH-1 ground truth, a
  6,000-gaussian degraded init, 8 ring views at 128², K = 512 with
  ``term_eps`` 1e-4, 2,000 iterations of L1 + SSIM with per-field Adam and
  four densify/cull rounds) through ``train``, PSNR over the 8 views every
  250 iterations, gated (final mean ≥ 33 dB and ≥ 12 dB above iteration 0,
  N changed by a round); a steady-state iteration timed and split
  (forward + loss, backward, Adam, the host reads the loop leaves out) and
  profiled; one train step at the init and at the trained scene against
  the plain path; K1f and K1b on the train lists;
- the pipeline and the exports on a 100k-gaussian SH-3 scene:
  ``GaussianSplatPipeline.render`` at 640×480 (K1f over 40 × 30 tiles at
  K = 1,024) against K1's plain version, the RGB-D cloud at 320×240, the
  densified and culled point cloud, ``save_ply`` → ``load_ply`` bit for
  bit, the ellipsoids of 2,000 gaussians, and a ``transforms.json`` of 8
  ring cameras through ``load_dataset`` to renders (no image is read);
- the distributed layer (``parallel/``; ranks are processes of one
  process group, started by ``parallel.launch``; two ranks on one card
  run on gloo, as NCCL refuses a duplicate GPU, and gloo's collectives take
  the CUDA tensors): the prim-sharded render of the bench scene (100k sh3,
  256², send 1,024 a rank) on 2 gloo ranks against the single-device
  ``rasterize_sh`` (image and the gradient to the means, on each rank),
  K1f/K1b at the owned rows against their plain versions, the exchange's
  bytes and ms; the scaling protocol (``entry.bench_mesh``: B=32, N=20k,
  128², the uncached train step) at world 1 on NCCL and on 2 gloo ranks,
  its losses and gradients held to world 1's; ``dryrun_multichip(4)`` on
  4 gloo ranks (one loss on every rank, K1-K4 launched on each).  Two
  ranks on one card share its SMs: these times are the mechanism's cost,
  not a scaling efficiency (``chip_scaling.py`` runs them across cards);
- the viewer: one 240×320 frame of a 100k SH-3 scene served over local
  HTTP through ``viewer.scene_render_fn`` (K1f), against K1's plain
  version;
- the offline matcher: the native binding builds, and ``tools.match``
  recovers a known similarity by scaled ICP on pusharm6's link meshes.

It checks that every kernel of each path was launched (and no backward
kernel by a forward run), that the fixed-camera render is exact (no
dropped tiles), that all gradients are finite, that the images and the
gradients agree with the port's plain path, and that K4 (which runs K2's
block body) gives K2's output and dynamic gradient bit for bit on the
same (env, tile) pairs.  Any disagreement raises.

Output: phase reports, then the card's name and power limit, one JSON line
``{"kernels": [...]}`` with per-kernel launches, max |Δ|, kernel / plain
times and the roofline bound, and last ``{"ok": true, "device": {...}}``.
Kernel times are CUDA-event times over back-to-back calls, for every
kernel.  K1f and K1b run about as short as their Python dispatch, so the
device time of their kernels under the profiler is printed beside theirs.
Exits non-zero without a result where there is no CUDA device.  The top
rows of a device profile of one forward step and one train step are
printed with the phase reports.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

B, N, RES, SH_DEGREE = 128, 100_000, 256, 3
SEL_TILES, DYN_CAP, DYN_M = 36, 128, 9
BIG_KD = 4096   # a dynamic capacity past the backward kernels' windows
LONG_ENVS = 2   # envs of the BIG_KD phase (its float64 plain versions)
TS32_KD = 1024  # the dynamic capacity of the tile-size-32 phase
ITERS = 5
# the pushT kernel's bound, the dependent chain of one env: a PGS slot
# visit's normal and friction impulses on the velocity chain
# (PUSHT_SLOT_OPS float ops, the clamps' NaN tests counted), a substep's
# contacts and integration besides (PUSHT_SUBSTEP_OPS, the sinf, cosf,
# sqrtf and IEEE divisions at their instruction sequences), each
# PUSHT_OP_CYCLES (an FP32 op's latency on an H100) at the SM's top clock
PUSHT_SLOT_OPS, PUSHT_SUBSTEP_OPS, PUSHT_OP_CYCLES = 28, 150, 4
# the arm kernel's bound, likewise: its PGS slot visits at PUSHT_SLOT_OPS,
# a contact substep's two circle-quad contacts, per-slot constants and
# integration (ARM_SUBSTEP_OPS), and its FKs of the end effector's 7 links
# (ARM_FK_OPS each: a quaternion product, a normalisation and a rotation a
# link; the one with tangents counted twice)
ARM_SUBSTEP_OPS, ARM_FK_OPS = 120, 280
ARM_STEP_STEPS = 32   # chained steps of the arm kernel's check
# kernel R1's colours against the plain reprojection's: it sums the SH
# coefficients in order, the plain version's einsum through a gemv
R1_COLOUR_TOL = 1e-6
# the operators of K1-K4, whose launches the phases count
RENDER_OPS = ("composite_static", "composite_pair_sel", "composite_static_bwd",
              "composite_pair_sel_bwd", "composite_sel_single",
              "composite_sel_single_bwd", "composite_pair",
              "composite_pair_bwd")
# K2f and K2b of the first design (one thread per pixel, K2b's per-slot
# output summed by index_add_), K4 on that walk, and K1f and K1b of the
# first design (one block per tile walking its chunks in order): this
# script on an NVIDIA H100 80GB HBM3 at 700 W
FIRST_DESIGN_MS = {"composite_pair_sel": 1.2854,
                   "composite_pair_sel_bwd": 4.2181,
                   "composite_pair": 1.3624, "composite_pair_bwd": 4.2581,
                   "composite_static": 0.1340,
                   "composite_static_bwd": 0.5092}
# the uncached step (bench.py's BENCH_CACHE=0 branch): timed steps, and the
# envs its plain-version checks take at a time
UC_ITERS, UC_PLAIN_ENVS, UC_GRAD_ENVS = 3, 4, 2
# the arm product path (benchmarks/bench_product.py): envs, frames, settle
# steps, timed teleop steps, and the envs and frames of its plain-path checks
ARM_B, ARM_R, ARM_SETTLE, ARM_TELEOP_ITERS = 8, 32, 40, 10
ARM_PLAIN_B, ARM_PLAIN_R, ARM_RES = 2, 2, (240, 320)
# the env layer: PushTEnvF at B=ENV_B in each observation mode (ENV_RS²
# frames, ENV_ITERS timed steps), where at most ENV_EDGE_PIXELS pixels of a
# frame may differ from the CPU's (pixel centres on a shape's edge); and the
# splat env built from a demo asset tree: 2,000 gaussians on each of
# pusharm6's 8 links, 80,000 on the ground and a 4,000-gaussian task mesh
# (100,000, bench_product.py's N), captured at the demo's joint
# configuration, ASSET_STEPS task-space steps from the push-ready pose
ENV_B, ENV_ITERS, ENV_RS, ENV_EDGE_PIXELS = 128, 2, 96, 4
ASSET_N_PER_LINK, ASSET_N_GROUND, ASSET_TASK_N = 2000, 80000, 4000
ASSET_STEPS, ASSET_RES = 10, (240, 320)
ASSET_JOINT_CONFIG = (0.0, -0.45, 0.85, 0.0, 0.35, 0.0)
ASSET_HOME = (0.0, 0.785, 0.89, 0.0, 1.466, 0.0)
# the example drivers at their own sizes (sim_a_splat_torch/examples): the
# pushT demo's scripted steps (3: each is ~8-10 s of host-bound IK, the
# latency the asset env's ASSET_STEPS already read, so 3 give its step and
# render times and frames to hold), the slider sweep's steps, the hardware
# stream's messages, the viewer's frame size, and the demos' viewport's key
# in their camera setup (``examples.common.camera_setup``)
EX_PUSHT_STEPS, EX_SLIDER_STEPS, EX_HW_STEPS, EX_VIEW_SIZE = 3, 40, 20, 320
VIEWPORT_KEY = 0
# both product cameras sit inside the scene's background cloud: a gaussian
# a centimetre in front of a lens covers thousands of pixels, and its
# gradient (through the ill-conditioned 2-D covariance of its projection)
# moves with the summation order of the composite: two float32 orders of the
# same plain composite differed by 5.3e-4 of the field's largest on the CPU
# (N=3,000, a gaussian 0.012 m from the viewport with a screen radius of
# 8,924 px), and the kernels and the plain versions by up to 4.2e-3 (means)
# on an H100 at N=100k, the other gaussians by 3.3e-7 of their own largest.
# Gaussians within NEAR_LENS_M of a lens (the end-effector camera's near/far
# split) are held to TOL_GRAD_NEAR × the field's largest gradient, the
# others to TOL_GRAD × their own largest
NEAR_LENS_M, TOL_GRAD_NEAR = 0.35, 1e-2
# the moving camera (bench.py's moving_camera / moving_fwd variants, whose
# R=32 is cut to 16 frames to leave the env layer's phase room in the
# script's time)
B_MV_FWD, B_MV_TRAIN, R_MV, MV_ITERS = 32, 16, 16, 1
MV_KW = dict(margin=16.0, kc=512, dyn_capacity=DYN_CAP, dyn_max_tiles=DYN_M,
             cam_height=-420.0, z_split=0.0)
MV_RASTER = dict(tile_size=16, tile_capacity=1024, max_tiles_per_gaussian=16,
                 sigma_cutoff=3.0, term_eps=1e-4,
                 buckets=((4, 0.80), (9, 0.12), (16, 0.08)))
TOL_REBIN = (2e-5, 1e-4)  # atol, rtol: the reference's own bound for the
                          # cached render against the full rebin
# the splat trainer: benchmarks/train_scene.py's protocol at its full width
# (12,000-gaussian ground truth, a 6,000-gaussian degraded init, 8 ring
# views at 128², K = 512, term_eps 1e-4, 2,000 iterations, a refinement
# round every 400 from 400, PSNR over every view every 250 iterations);
# the gate on its final PSNR; TRAIN_STEADY_ITERS timed iterations of the
# trained scene
TRAIN_ITERS, TRAIN_EVAL_EVERY, TRAIN_STEADY_ITERS = 2000, 250, 40
TRAIN_GATE_DB, TRAIN_GAIN_DB = 33.0, 12.0
# the degraded init's quats gradient is rounding alone (see splat_training):
# held below this fraction of the means' largest gradient on both paths
QUAT_NOISE = 1e-5
# the JAX package's run of the same protocol (TRAIN_r05.json, on a TPU v5e):
# a quality reference only
TRAIN_R05 = dict(psnr_first=20.349, psnr_final=41.68, n_final=11772)
# the pipeline and the exports: a 100k-gaussian SH-3 synthetic scene,
# GaussianSplatPipeline's default raster (K = 1,024) at 640×480 (40 × 30
# tiles), the RGB-D cloud at 320×240, ellipsoids of 2,000 gaussians
PIPE_N, PIPE_RES, PIPE_RGBD_RES, PIPE_VIEWS = 100_000, (480, 640), \
    (240, 320), 8
DS_EDGE_PIXELS = 8
# the distributed layer: the prim-sharded render of the bench scene (N,
# SH_DEGREE, RES², the fixed camera; no buckets, as buckets are fractions
# of each shard's N) on DIST_RANKS gloo ranks of the one card, each rank's
# send capacity DIST_SEND (no shard truncates: every tile's merged list is
# the single-device list), DIST_REPS timed calls; the scaling protocol
# (benchmarks/scaling.py: B=32, N=20k, 128², the uncached train step) at
# world 1 on NCCL and on 2 gloo ranks, its losses and gradients within
# TOL_SCALING × the world-1 field's largest; dryrun_multichip on
# DRYRUN_RANKS gloo ranks
DIST_RANKS, DIST_SEND, DIST_REPS = 2, 1024, 3
DIST_RASTER = dict(tile_size=16, tile_capacity=1024,
                   max_tiles_per_gaussian=16, sigma_cutoff=3.0)
SCALING = dict(B=32, N=20_000, res=128, iters=3)
SCALING_PLAIN_ENVS = 8
TOL_SCALING = 1e-5
# the dry run's loss on every rank against its plain path in one process,
# relative (the CPU test holds the ranks to one process and to the JAX
# package at 1e-5)
DRYRUN_RANKS, TOL_DRYRUN = 4, 1e-5
# the viewer: one frame of a VIEW_N SH-3 synthetic scene at VIEW_RES (h, w)
VIEW_N, VIEW_RES = 100_000, (240, 320)
# FLOP per (pixel, list entry) pair, exp as one: the alpha (dx, dy, the
# conic quadratic, exp, opacity, clamp) is evaluated for every entry of an
# applied chunk; the blend (w = αT, four FMAs, T·(1-α)) only where α > 0
ALPHA_FLOPS, BLEND_FLOPS = 15, 11
# the gradient of one (pixel, entry) pair with α > 0: b = ct·rgbd, w, the
# prefix and suffix, dalpha, the 10 payload-row terms and the T update
# (42), and the pair's share of the 10 sums over the tile's pixels (10)
GRAD_FLOPS = 52
# H100 SXM published peaks (NVIDIA data sheet; at the 700 W power limit)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
TOL = 1e-4   # kernel vs plain: float32 products accumulated in another
             # order (per-pixel sequential vs cumprod / log space) over up
             # to 1,152 entries; depth rows are held to TOL × max depth
TOL_GRAD_LONG = 2e-3  # gradients at dyn_capacity BIG_KD against the plain
             # versions in float64: the kernels take each suffix sum as
             # ct . (out - prefix), and each step of those float32
             # accumulators rounds at the accumulator's size, so over merged
             # lists of thousands of entries (the main scene's at BIG_KD)
             # the error of a near-opaque entry's gradient grows past
             # TOL_GRAD; the bound tests/test_torch_grad.py holds float32
             # suffix sums to against float64
TOL_GRAD = 2e-4  # gradients, kernel vs plain: each payload row (and each
             # scene field) within TOL_GRAD × its largest plain gradient.
             # The plain backward is autograd through the plain forward; in
             # float32 it is held to the same bound against a float64 run on
             # near-opaque tiles with random cotangents
             # (tests/test_torch_grad.py), while the kernels' suffix sums
             # are taken against the forward's own accumulators


def log(msg=""):
    print(msg, flush=True)


def run(cmd):
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return (out.stdout + out.stderr).strip()


@contextlib.contextmanager
def replaced(module, name, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield old
    finally:
        setattr(module, name, old)


def cuda_ms(fn, reps, warmup=1):
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps=200, warmup=20):
    """Mean host µs of one ``fn()`` over ``reps`` back-to-back calls (the
    enqueue: the device is synchronised before the first and after the
    last, outside the clock; ``reps`` launches stay below the queue's
    depth)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


class NoDeviceTime(RuntimeError):
    """The profiler recorded no device time for a call in every try."""


def kernel_ms(fn, reps, tries=3):
    """Device time of one ``fn()``, its kernels' own time over ``reps``
    calls under the profiler (host gaps excluded: a call shorter than its
    Python dispatch is not timed by the dispatch).  A profile that recorded
    no device time is taken again, up to ``tries`` times."""
    fn()
    for _ in range(tries):
        ms = device_profile(lambda: [fn() for _ in range(reps)])[0] / reps
        if ms > 0:
            return ms
    raise NoDeviceTime(f"the profiler recorded no device time in {tries} "
                       "tries")


def device_ms_text(fn, reps):
    """:func:`kernel_ms` for a log line beside a kernel's CUDA-event time
    (the number kept): "not recorded" where three profiles held no device
    time for the call, which happens now and then late in a whole run."""
    try:
        return f"{kernel_ms(fn, reps):.4f} ms"
    except NoDeviceTime:
        return "not recorded"


def device_profile(fn):
    """(device time in ms, key averages) of one ``fn()`` under the profiler:
    the self time of every CUDA event, host gaps excluded."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in avg if str(e.device_type).endswith("CUDA")
                 and not getattr(e, "is_user_annotation", False))
    return dev_us / 1e3, avg


def bound(nbytes, flops):
    t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def pusht_row(pusht, P, state_sets, actions):
    """Kernel P1 (``csrc/pusht_step.cu``, one launch a control step) on
    each of ``state_sets`` against the plain control step on the card
    (max|Δ| per field, held to the port's physics tolerances), timed by
    CUDA events (its device time under the profiler beside) against the
    plain path's time and the chain bound, and the plain path a call
    whose action needs a gradient takes (forward and backward: the kernel
    has no backward).  Returns its ``kernels`` row."""
    import torch
    gaps = dict.fromkeys(pusht.PushTState._fields, 0.0)
    for st in state_sets:
        got = pusht.control_step(P, st, actions)
        want = pusht.control_step_plain(P, st, actions)
        for n, g, w in zip(pusht.PushTState._fields, got, want):
            gaps[n] = max(gaps[n], float((g - w).abs().max()))
    st = state_sets[0]

    def kernel():
        return pusht._step_kernel(P, st, actions, P.substeps)
    ms = cuda_ms(kernel, 50)
    plain_ms = cuda_ms(lambda: pusht.control_step_plain(P, st, actions), 2)
    act_g = actions.clone().requires_grad_()

    def grad_step():
        out = pusht.control_step(P, st, act_g)
        return torch.autograd.grad(out.block_pos.sum(), act_g)
    grad_ms = cuda_ms(grad_step, 2)
    mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                     "--format=csv,noheader,nounits"]).splitlines()[0])
    ops = P.substeps * (P.solver_iters * 10 * PUSHT_SLOT_OPS
                        + PUSHT_SUBSTEP_OPS)
    bound_ms = ops * PUSHT_OP_CYCLES / (mhz * 1e3)
    log(f"physics, pushT control step at B={actions.shape[0]}: kernel "
        f"pusht_step {ms:.4f} ms (events over 50 launches; device time "
        f"under the profiler {device_ms_text(kernel, 50)}), plain path "
        f"{plain_ms:.2f} ms (with a gradient to the action, forward and "
        f"backward: {grad_ms:.2f} ms), chain bound {bound_ms:.4f} ms ({ops} dependent "
        f"ops × {PUSHT_OP_CYCLES} cycles at {mhz:.0f} MHz); max|Δ| vs the "
        "plain path: " + ", ".join(f"{n} {g:.3e}" for n, g in gaps.items()))
    for n, g in gaps.items():
        tol = 0.0 if n == "n_contacts" else 1e-4 if n == "block_angle" \
            else 1e-3
        if g > tol:
            raise AssertionError(f"pusht_step: {n} max|Δ| {g} > {tol}")
    return dict(name="pusht_step", route="cuda",
                source="sim_a_splat_torch/csrc/pusht_step.cu", replaces=None,
                max_abs_err=max(gaps.values()), ms=ms, plain_ms=plain_ms,
                plain_grad_ms=grad_ms,
                bound_ms=bound_ms, bound_by="dependent chain",
                library_ms=None)


def arm_fields(tr) -> dict:
    """An arm transition's state (with reward and flags) and info, by
    name."""
    out = dict(zip(("q", "qd", "target_prev"), tr.state.arm))
    out.update((n, getattr(tr.state, n)) for n in tr.state._fields[1:])
    out.update(reward=tr.reward, terminated=tr.terminated,
               truncated=tr.truncated)
    return out, dict(tr.info)


def arm_step_row(env, inputs, launches):
    """Kernel P2 (``csrc/arm_step.cu``, one launch a control step) on each
    of ``inputs`` ({B: (state, (R, B, 6) actions)}): R chained steps
    against the plain step on the card from the same states (max|Δ| per
    field; the state, reward and flags held equal, the info within 1e-5),
    its launch timed by CUDA events (called through the launch helper
    ``_kernels.launch``, whose host cost is below the kernel's; its device
    time under the profiler beside) against the plain path's time and the
    chain bound, the host ms of a step through the env's wrapper, and the
    host µs of one launch through each layer: the C entry point called
    directly, ``_kernels.launch``, the operator's CUDA kernel called as a
    Python function, and the operator ``torch.ops.sim_a_splat.arm_step``.
    Returns its ``kernels`` row (``ms`` at the largest B, ``ms_b<B>`` at
    each)."""
    import ctypes

    import torch
    from sim_a_splat_torch.envs import manipulator_envs as me
    from sim_a_splat_torch.ops import _kernels
    c = env.kernel_constants()
    mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                     "--format=csv,noheader,nounits"]).splitlines()[0])
    ops = (c.contact_substeps * (c.iterations * 2 * PUSHT_SLOT_OPS
                                 + ARM_SUBSTEP_OPS) + 3 * ARM_FK_OPS)
    bound_ms = ops * PUSHT_OP_CYCLES / (mhz * 1e3)
    row = dict(name="arm_step", route="cuda",
               source="sim_a_splat_torch/csrc/arm_step.cu", replaces=None,
               launches=launches, max_abs_err=0.0, bound_ms=bound_ms,
               bound_by="dependent chain", library_ms=None)
    for B, (st, acts) in sorted(inputs.items()):
        state_gap, info_gap = {}, {}
        s = st
        with torch.no_grad():
            for a in acts:
                got, want = env.step(s, a), env.step_plain(s, a)
                for gaps, g, w in zip((state_gap, info_gap), arm_fields(got),
                                      arm_fields(want)):
                    for n in w:
                        d = float((g[n].float() - w[n].float()).abs().max())
                        gaps[n] = max(gaps.get(n, 0.0), d)
                s = got.state
        a0 = acts[0]
        fields = {**st.arm._asdict(), **st._asdict()}
        inputs = [fields[n] for n in me._KERNEL_INPUTS]
        # the outputs stay referenced while the launches write them
        outs, arrays = me.kernel_arguments(inputs, a0, c.ndof)
        addr = [ctypes.addressof(x) for x in arrays]
        entry_point = _kernels.function("arm_step", "arm_step_launch",
                                        me._STEP_ARGS)
        stream = torch.cuda.current_stream().cuda_stream

        def kernel():
            _kernels.launch("arm_step", "arm_step", me._STEP_ARGS, a0.device,
                            *addr, B, c)
        calls = {
            "C entry point": lambda: entry_point(*addr, B, c, stream),
            "_kernels.launch": kernel,
            "the operator's kernel": lambda: me._launch(
                inputs, a0, ctypes.addressof(c)),
            "the operator": lambda: torch.ops.sim_a_splat.arm_step(
                inputs, a0, ctypes.addressof(c))}
        with torch.no_grad():
            call_us = {k: host_us(f) for k, f in calls.items()}
            ms = cuda_ms(kernel, 200, warmup=20)
            plain_ms = cuda_ms(lambda: env.step_plain(st, a0), 2)
            dev_ms = device_ms_text(kernel, 50)
            env.step(st, a0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                env.step(st, a0)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / 50
        del outs
        log(f"physics, the arm's control step at B={B}: kernel arm_step "
            f"{ms:.4f} ms (events over 200 launches; device time under the "
            f"profiler {dev_ms}), a step through the env's wrapper "
            f"{host_ms:.4f} ms (host clock), plain path {plain_ms:.2f} ms, "
            f"chain bound {bound_ms:.4f} ms ({ops} dependent ops × "
            f"{PUSHT_OP_CYCLES} cycles at {mhz:.0f} MHz); host µs a launch "
            "(200 in a row): " + ", ".join(f"{k} {v:.2f}"
                                           for k, v in call_us.items())
            + "; max|Δ| vs the plain path over "
            f"{len(acts)} chained steps: state "
            + ", ".join(f"{n} {g:.3e}" for n, g in state_gap.items())
            + "; info " + ", ".join(f"{n} {g:.3e}"
                                    for n, g in info_gap.items()))
        if any(state_gap.values()) or max(info_gap.values()) > 1e-5:
            raise AssertionError(f"arm_step at B={B} is not the plain step: "
                                 f"{state_gap}, {info_gap}")
        row.update({f"ms_b{B}": ms, f"plain_ms_b{B}": plain_ms,
                    f"host_ms_b{B}": host_ms, "ms": ms, "plain_ms": plain_ms,
                    f"launch_host_us_b{B}": call_us})
        row["max_abs_err"] = max(row["max_abs_err"], *info_gap.values())
    return row


def reproject_row(rasterize_moving, args):
    """Kernel R1 (``csrc/reproject.cu``, one launch a moving-camera render)
    on the arm product path's end-effector camera: the candidate caches and
    cameras of a captured render at B = ARM_B, and env 0's alone at B = 1.
    Held to the plain reprojection on the same inputs: every payload row
    but the colours, and the key, bit for bit (NaN where NaN); the colours
    within R1_COLOUR_TOL; the survivors' counts equal.  The operator's
    launch timed by CUDA events over 200 launches (its device time under
    the profiler beside), the whole kernel path (the camera constants and
    the launch) and the plain version beside it, against the bytes bound:
    each candidate's fields read once and its ten rows and key written once
    (280 B at SH degree 3) at 3.35 TB/s.  Returns its ``kernels`` row
    (``ms`` at B = ARM_B, ``ms_b<B>`` at each)."""
    import torch
    from sim_a_splat_torch.ops.projection import Camera
    from sim_a_splat_torch.ops.transforms import SE3
    cache, cams, degree, cfg = args
    op = torch.ops.sim_a_splat.reproject_candidates
    K = (degree + 1) ** 2
    row = dict(name="reproject_candidates", route="cuda",
               source="sim_a_splat_torch/csrc/reproject.cu", replaces=None,
               max_abs_err=0.0, bound_by="bytes", library_ms=None)
    for B in (1, ARM_B):
        c = type(cache)(*(f[:B] if f.dim() else f for f in cache))
        cam = Camera(SE3(cams.pose.q[:B], cams.pose.t[:B]), cams.fx, cams.fy,
                     cams.cx, cams.cy, cams.width, cams.height)
        a = rasterize_moving.r1_arguments(c, cam, degree, cfg)
        with torch.no_grad():
            pay, key = op(*a)
            wpay, wkey = rasterize_moving._reproject_plain(c, cam, degree,
                                                           cfg)
            rows = [r for r in range(10) if r not in range(5, 8)]
            same = (torch.equal(key, wkey) and bool(
                ((pay[:, :, rows] == wpay[:, :, rows])
                 | (pay[:, :, rows].isnan() & wpay[:, :, rows].isnan()))
                .all()))
            colour = float((pay[:, :, 5:8] - wpay[:, :, 5:8]).abs().max())
            counts = (pay[:, :, 9] > 0).sum(-1)
            same_counts = torch.equal(counts, (wpay[:, :, 9] > 0).sum(-1))
            ms = cuda_ms(lambda: op(*a), 200, warmup=20)
            dev_ms = device_ms_text(lambda: op(*a), 50)
            path_ms = cuda_ms(lambda: rasterize_moving._reproject_kernel(
                c, cam, degree, cfg), 200, warmup=5)
            plain_ms = cuda_ms(lambda: rasterize_moving._reproject_plain(
                c, cam, degree, cfg), 20, warmup=2)
        n = pay.shape[0] * pay.shape[1] * pay.shape[3]
        nbytes = n * 4 * ((3 + 4 + 3 + 1 + 3 * K) + 11)
        bound_ms = nbytes / 3.35e12 * 1e3
        log(f"render, the end-effector camera's reprojection at B={B} "
            f"({tuple(pay.shape)}, SH degree {degree}, "
            f"{float((counts > 0).float().mean()):.3f} of the tiles "
            f"holding survivors, {int(counts.sum())} survivors): kernel "
            f"reproject_candidates {ms:.4f} ms (events over 200 launches; "
            f"device time under the profiler {dev_ms}), the kernel path "
            f"with its camera constants {path_ms:.4f} ms, plain path "
            f"{plain_ms:.4f} ms, bytes bound {bound_ms:.4f} ms "
            f"({nbytes / 1e6:.1f} MB at 3.35 TB/s, "
            f"{bound_ms / ms * 100:.1f} % of it); rows but the colours and "
            f"the key bit-equal: {same}, survivors' counts equal: "
            f"{same_counts}, colours max|Δ| {colour:.3e}")
        if not (same and same_counts and colour <= R1_COLOUR_TOL):
            raise AssertionError(
                f"reproject_candidates at B={B} is not the plain "
                f"reprojection: rows and key equal {same}, counts equal "
                f"{same_counts}, colours max|Δ| {colour}")
        row.update({f"ms_b{B}": ms, f"plain_ms_b{B}": plain_ms,
                    f"path_ms_b{B}": path_ms, f"bound_ms_b{B}": bound_ms,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms})
        row["max_abs_err"] = max(row["max_abs_err"], colour)
    return row


def check_rows(name, got, want, what, rel=TOL_GRAD):
    """Each payload row (axis -2) of ``got`` within ``rel`` × that row's
    largest |want|; returns the max |Δ| over all rows."""
    worst = 0.0
    for r in range(want.shape[-2]):
        g, w = got[..., r, :], want[..., r, :]
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        worst = max(worst, err / scale if scale > 0 else err)
        if not err <= rel * scale:
            raise AssertionError(f"{name} {what} row {r}: max|Δ| {err} > "
                                 f"{rel} × {scale}")
    err = float((got - want).abs().max())
    log(f"  {name} {what}: max|Δ| = {err:.3e}, largest per-row max|Δ| / "
        f"max|g| = {worst:.3e} (tolerance {rel:.1e})")
    return err


def check_fields(what, g_k, g_p, fields):
    """Each gradient field of the scene ``g_k`` finite and within TOL_GRAD ×
    that field's largest gradient in ``g_p`` (the plain path's); returns
    the largest max|Δ| / max|g| over the fields."""
    import torch
    worst = 0.0
    for n in fields:
        got, want = getattr(g_k, n), getattr(g_p, n)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        log(f"  grad {n}: max|Δ| = {err:.3e}, max|g| = {scale:.3e} "
            f"(tolerance {TOL_GRAD:.1e} × max|g|)")
        if not (bool(torch.isfinite(got).all()) and err <= TOL_GRAD * scale):
            raise AssertionError(f"{what} gradient of {n} disagrees with the "
                                 f"plain path: {err} > {TOL_GRAD} × {scale}")
        worst = max(worst, err / scale)
    return worst


def check(name, got, want, atol, what):
    err = float((got - want).abs().max())
    log(f"  {name} {what}: max|Δ| = {err:.3e} (tolerance {atol:.1e})")
    if not err <= atol:
        raise AssertionError(f"{name} {what} disagrees with its plain "
                             f"version: max|Δ| {err} > {atol}")
    return err


def k2_slots_of_k4(spay, dpay, counts_s, counts_d, skip):
    """K2's inputs (spay_pad, dpay, ids, counts_s_pad, counts_d) for the
    (env, tile) pairs that K4's inputs touch (skip > 0): the static lists
    with the zero trash row, each env's touched tiles as its slots in tile
    order (pads name the trash row), their dynamic lists and counts."""
    import torch
    B, T = skip.shape
    on = skip > 0
    TT = max(int(on.sum(1).max()), 1)
    order = torch.argsort((~on).to(torch.int8), dim=1, stable=True)[:, :TT]
    real = torch.gather(on, 1, order)
    ids = torch.where(real, order, T).to(torch.int32)
    bidx = torch.arange(B, device=skip.device)[:, None]
    safe = torch.where(real, order, 0)
    dsel = torch.where(real[..., None, None], dpay[bidx, safe], 0.0)
    cd = torch.where(real, counts_d[bidx, safe], 0).to(torch.int32)
    return (torch.cat([spay, spay.new_zeros((1, *spay.shape[1:]))]),
            dsel.contiguous(), ids,
            torch.cat([counts_s, counts_s.new_zeros(1)]), cd)


def parent_libraries(parent):
    """{source name: loaded library} of the K2, K3 and K4 kernels of the
    checkout at ``parent``, built from its ``csrc`` (one nvcc each, in
    parallel) into ``sim_a_splat_torch/_build/parent/``."""
    import ctypes
    from pathlib import Path
    from sim_a_splat_torch.ops import _kernels
    csrc = Path(parent).resolve() / "sim_a_splat_torch" / "csrc"
    out = _kernels.BUILD_DIR / "parent"
    out.mkdir(parents=True, exist_ok=True)
    names = ("composite_sel", "composite_sel_bwd", "composite_pair",
             "composite_pair_bwd", "composite_single", "composite_single_bwd")
    jobs = {n: (csrc / f"{n}.cu", csrc, out / f"lib{n}.so") for n in names}
    _kernels.compile_all(list(jobs.values()))
    return {n: ctypes.CDLL(str(job[2])) for n, job in jobs.items()}


def parent_module(parent, name):
    """The checkout ``parent``'s wrapper module ``ops/<name>.py``, loaded
    beside this tree's (it launches whatever library ``_kernels`` holds for
    its sources: the parent's inside ``kernels_of``)."""
    import importlib.util
    from pathlib import Path
    path = Path(parent).resolve() / "sim_a_splat_torch" / "ops" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"parent_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def kernels_of(libs):
    """The port's wrappers launch the kernels of ``libs`` ({source name:
    library}, e.g. parent_libraries') while inside; the tree's after."""
    from sim_a_splat_torch.ops import _kernels
    saved = {n: _kernels._loaded.get(n) for n in libs}
    _kernels._loaded.update(libs)
    try:
        yield
    finally:
        for n, lib in saved.items():
            if lib is None:
                _kernels._loaded.pop(n, None)
            else:
                _kernels._loaded[n] = lib


def versus_parent(label, fn, parent, reps, parent_fn=None):
    """With the parent's libraries ``parent``: ``fn()`` (one kernel call
    through its wrapper) timed by CUDA events with the parent's kernels and
    this tree's, in turns (parent, this, this, parent), logged with the
    ratio of the means; returns (this tree's ms, the parent's ms), or None
    without ``parent``.  ``parent_fn``, where given, is the call of the
    parent's turns (through the parent's wrapper)."""
    if not parent:
        return None
    times = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        with kernels_of(parent) if who == "parent" else contextlib.nullcontext():
            f = parent_fn if who == "parent" and parent_fn else fn
            times[who].append(cuda_ms(f, reps))
    new, old = (sum(times[k]) / 2 for k in ("this", "parent"))
    log(f"  {label}: this tree {times['this'][0]:.4f} / {times['this'][1]:.4f}"
        f" ms, the parent's kernel {times['parent'][0]:.4f} / "
        f"{times['parent'][1]:.4f} ms (in turns, this call): "
        f"{new / old - 1:+.1%}")
    return new, old


def static_rows(a1, dev, backward=True):
    """K1f and K1b on the captured arguments ``a1`` of one
    ``composite.composite_static`` call against their plain versions (K1b
    for a numpy-seeded cotangent), timed by CUDA events beside their bound;
    logs the applied chunks and the cull's skipped share.  Returns the two
    rows of the ``kernels`` line (K1f's alone without ``backward``)."""
    import numpy as np
    import torch
    from sim_a_splat_torch.ops import composite, composite_sel
    log("K1 composite_static vs composite_static_plain "
        f"(payload {tuple(a1[0].shape)}):")
    out_k, car_k, acc_k = composite.composite_static_fwd(*a1)
    out_p, car_p, applied, hits = composite.composite_static_plain(
        *a1, return_work=True)
    pay, counts, skip = a1[:3]
    rows = [0, 1, 2, 4]
    e1 = max(check("K1", out_k[..., rows], out_p[..., rows], TOL, "rgb+trans"),
             check("K1", car_k, car_p, TOL, "carries"))
    dscale = max(1.0, float(pay[:, 8].abs().max()))
    check("K1", out_k[..., 3] / dscale, out_p[..., 3] / dscale, TOL,
          "depth_acc / max depth")
    T, _, K = pay.shape
    P_ = a1[3] ** 2
    nc = K // composite.CHUNK
    cnt = torch.where(skip > 0, counts, 0).long()
    c0 = torch.arange(nc, device=dev) * composite.CHUNK
    per_chunk = torch.clamp(cnt[:, None] - c0, 0, composite.CHUNK)
    used = torch.arange(nc, device=dev)[None] < applied[:, None]
    entries = int((per_chunk * used).sum())
    blended = int(hits.sum())
    b_ms, b_by = bound(entries * 40 + T * 8 + T * P_ * (8 + nc) * 4,
                       ALPHA_FLOPS * P_ * entries + BLEND_FLOPS * blended)
    k1 = dict(name="composite_static", route="cuda",
              source="sim_a_splat_torch/csrc/composite.cu",
              replaces="sim_a_splat_tpu/ops/pallas_composite.py:238",
              max_abs_err=e1,
              ms=cuda_ms(lambda: composite.composite_static(*a1), 20),
              plain_ms=cuda_ms(lambda: composite.composite_static_plain(*a1),
                               3),
              bound_ms=b_ms, bound_by=b_by, library_ms=None)
    chunk_blocks = int(torch.clamp((cnt + composite.CHUNK - 1)
                                   // composite.CHUNK, max=nc).sum())
    log(f"  applied entries {entries} of {int(cnt.clamp(max=K).sum())} "
        f"active, chunks {int(applied.sum())} applied of {chunk_blocks} "
        f"composited by the chunk blocks; (pixel, entry) pairs: "
        f"{P_ * entries} alpha, {blended} blended (α > 0); kernel "
        f"{k1['ms']:.4f} ms (its two launches' device time under the "
        "profiler "
        f"{device_ms_text(lambda: composite.composite_static(*a1), 20)}; "
        f"first design {FIRST_DESIGN_MS['composite_static']} ms), plain "
        f"{k1['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    # the (applied entry, warp) pairs that the cull skips, by the kernels'
    # test's plain twin on K1's warp rectangles
    box1 = composite_sel.cull_boxes(pay, a1[5])             # (T, 4, K)
    cull1 = composite_sel.culled(box1, composite.warp_rects(
        torch.arange(T, device=dev, dtype=torch.int32), a1[3], a1[4]))
    col_used = (torch.arange(K, device=dev) < torch.minimum(
        cnt, applied * composite.CHUNK)[:, None])           # (T, K)
    skipped1 = int((cull1 & col_used[:, None]).sum())
    pairs1 = int(col_used.sum()) * cull1.shape[1]
    log(f"  cull skipped {skipped1} of {pairs1} (applied entry, warp) pairs "
        f"({skipped1 / pairs1:.4f}); {composite.kernel_threads(a1[3])} "
        f"threads a block")
    if not backward:
        return [k1]

    # 3b. K1b at full size, for a numpy-seeded cotangent ----------------------
    log("K1b composite_static_bwd vs composite_static_bwd_plain:")
    ct1 = torch.as_tensor(np.random.default_rng(0).normal(
        size=tuple(out_k.shape)).astype(np.float32), device=dev)
    a1b = (pay, counts, skip, ct1, out_k, car_k, *a1[3:])
    g_k = composite.composite_static_bwd(*a1b, chunk_acc=acc_k)
    g_p = composite.composite_static_bwd_plain(pay, counts, skip, ct1,
                                               *a1[3:])
    e1b = check_rows("K1b", g_k, g_p, "payload grad")
    if not bool(torch.isfinite(g_k).all()):
        raise AssertionError("K1b: gradient not finite")
    # reads: applied payload columns, counts/skip, 5 channels each of ct and
    # out, carries; writes every gradient column once
    b_ms, b_by = bound(entries * 40 + T * 8 + T * P_ * (2 * 5 + nc) * 4
                       + T * 10 * K * 4,
                       ALPHA_FLOPS * P_ * entries + GRAD_FLOPS * blended)
    k1b = dict(name="composite_static_bwd", route="cuda",
               source="sim_a_splat_torch/csrc/composite_bwd.cu",
               replaces="sim_a_splat_tpu/ops/pallas_composite.py:277",
               max_abs_err=e1b,
               ms=cuda_ms(lambda: composite.composite_static_bwd(
                   *a1b, chunk_acc=acc_k), 20),
               plain_ms=cuda_ms(lambda: composite.composite_static_bwd_plain(
                   pay, counts, skip, ct1, *a1[3:]), 3),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"  gradient pairs (α > 0): {blended}; kernel {k1b['ms']:.4f} ms "
        "(device time under the profiler "
        + device_ms_text(lambda: composite.composite_static_bwd(
            *a1b, chunk_acc=acc_k), 20)
        + f"; first design {FIRST_DESIGN_MS['composite_static_bwd']} ms), "
        f"plain {k1b['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    return [k1, k1b]


def sel_rows(a2, parent, dev, plain_envs=8, parent_k2=None):
    """K2f and K2b on the captured arguments ``a2`` of one
    ``composite_sel.composite_pair_sel`` call against their plain versions
    (K2b for a numpy-seeded cotangent on the selected rows, the plain
    version ``plain_envs`` envs at a time), timed by CUDA events beside
    their bound (and the parent's kernels with ``parent``); logs the
    cull's skipped share.  Returns the two rows of the ``kernels`` line."""
    import numpy as np
    import torch
    from sim_a_splat_torch.ops import composite, composite_sel
    rows = [0, 1, 2, 4]
    spay, dpay, ids, cs_pad, cd = a2[:5]
    ts2, tx2, sigma2 = a2[5], a2[6], a2[7]
    P_ = ts2 ** 2
    log(f"K2 composite_pair_sel vs plain (spay {tuple(spay.shape)}, "
        f"dpay {tuple(dpay.shape)}):")
    out_k = composite_sel.composite_pair_sel(*a2)
    out_p, applied, hits = composite_sel.composite_pair_sel_plain(
        *a2, return_work=True)
    bidx = torch.arange(ids.shape[0], device=dev)[:, None]
    sel_k, sel_p = out_k[bidx, ids.long()], out_p[bidx, ids.long()]
    e2 = check("K2", sel_k[:, :, rows], sel_p[:, :, rows], TOL,
               "rgb+trans (selected rows)")
    dscale = max(1.0, float(spay[:, 8].abs().max()), float(dpay[:, :, 8].abs().max()))
    check("K2", sel_k[:, :, 3] / dscale, sel_p[:, :, 3] / dscale, TOL,
          "depth_acc / max depth")
    Ks, Kd = spay.shape[-1], dpay.shape[-1]
    cs_slot = torch.clamp(cs_pad[ids.long()].long(), max=Ks)       # (B, TT)
    c0 = torch.arange(Ks // composite.CHUNK, device=dev) * composite.CHUNK
    per_chunk = torch.clamp(cs_slot[..., None] - c0, 0, composite.CHUNK)
    used = torch.arange(len(c0), device=dev) < applied[..., None]
    s_entries = (per_chunk * used).sum(-1)                          # (B, TT)
    d_entries = torch.clamp(cd.long(), max=Kd)
    entries = int(s_entries.sum() + d_entries.sum())
    blended = int(hits.sum())
    T1 = spay.shape[0]
    tile_need = torch.zeros(T1, dtype=torch.long, device=dev).scatter_reduce(
        0, ids.long().reshape(-1), s_entries.reshape(-1), "amax")
    real = ids.long() < T1 - 1
    rows_written = int(real.sum()) + int((~real).any(dim=1).sum())
    nbytes = (int(tile_need.sum()) * 40 + int(d_entries.sum()) * 40
              + ids.numel() * 8 + T1 * 4 + rows_written * 8 * P_ * 4)
    b_ms, b_by = bound(nbytes,
                       ALPHA_FLOPS * P_ * entries + BLEND_FLOPS * blended)
    k2 = dict(name="composite_pair_sel", route="cuda",
              source="sim_a_splat_torch/csrc/composite_sel.cu",
              replaces="sim_a_splat_tpu/ops/pallas_composite_sel.py:583",
              max_abs_err=e2,
              ms=cuda_ms(lambda: composite_sel.composite_pair_sel(*a2), 10),
              plain_ms=cuda_ms(
                  lambda: composite_sel.composite_pair_sel_plain(*a2), 1),
              bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"  slots {ids.numel()} ({int(real.sum())} real), entries "
        f"{entries}; (pixel, entry) pairs: {P_ * entries} alpha, {blended} "
        f"blended (α > 0); kernel {k2['ms']:.4f} ms "
        f"({composite_sel.blocks_per_sm(False, Kd, ts2)} blocks/SM, "
        f"{composite_sel.smem_bytes(Kd, ts2, False)} B shared; first design "
        f"{FIRST_DESIGN_MS['composite_pair_sel']} ms), plain "
        f"{k2['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    versus_parent("K2f", lambda: composite_sel.composite_pair_sel(*a2),
                  parent, 10,
                  parent_fn=lambda: parent_k2.composite_pair_sel(*a2))
    # the (entry, warp) pairs of the applied entries that the cull skips,
    # by the kernels' test's plain twin
    sbox = composite_sel.cull_boxes(spay, sigma2)           # (T+1, 4, Ks)
    dbox = composite_sel.cull_boxes(dpay, sigma2).flatten(0, 1)
    lim_s = s_entries.reshape(-1, 1)
    lim_d = d_entries.reshape(-1, 1)
    flat_ids = ids.reshape(-1)
    skipped = pairs = 0
    for s0 in range(0, flat_ids.numel(), 512):
        sl = slice(s0, s0 + 512)
        rects = composite_sel.warp_rects(flat_ids[sl], ts2, tx2)
        cs_ = composite_sel.culled(sbox[flat_ids[sl].long()], rects)
        cd_ = composite_sel.culled(dbox[sl], rects)
        on_s = torch.arange(Ks, device=dev) < lim_s[sl]     # (S, Ks)
        on_d = torch.arange(Kd, device=dev) < lim_d[sl]
        skipped += int((cs_ & on_s[:, None]).sum() + (cd_ & on_d[:, None]).sum())
        pairs += (int(on_s.sum()) + int(on_d.sum())) * rects.shape[1]
    log(f"  cull skipped {skipped} of {pairs} (entry, warp) pairs "
        f"({skipped / pairs:.4f})")

    # 4b. K2b at full size, for a numpy-seeded cotangent on the selected rows -
    B_, TT = ids.shape
    log(f"K2b composite_pair_sel_bwd vs composite_pair_sel_bwd_plain "
        f"(all {B_ * TT} slots; the plain version {plain_envs} envs at a "
        "time):")
    ct2 = torch.zeros_like(out_k)
    ct2[bidx, ids.long(), :5] = torch.as_tensor(np.random.default_rng(1).normal(
        size=(B_, TT, 5, P_)).astype(np.float32), device=dev)
    ct2[:, T1 - 1] = 0.0                       # the trash row: pads only
    a2b = (spay, dpay, ids, cs_pad, cd, ct2, out_k, *a2[5:])

    def k2b_plain():
        g_s, g_d = torch.zeros_like(spay), torch.empty_like(dpay)
        for b0 in range(0, B_, plain_envs):
            sl = slice(b0, b0 + plain_envs)
            s_, d_ = composite_sel.composite_pair_sel_bwd_plain(
                spay, dpay[sl], ids[sl], cs_pad, cd[sl], ct2[sl], *a2[5:])
            g_s += s_
            g_d[sl] = d_
        return g_s, g_d

    gs_p, gd_p = k2b_plain()
    gs_k, gd_k = composite_sel.composite_pair_sel_bwd(*a2b)
    e2b = max(check_rows("K2b", gs_k[:T1 - 1], gs_p[:T1 - 1],
                         "static grad, summed per tile"),
              check_rows("K2b", gd_k, gd_p, "dynamic grad"))
    if not (bool(torch.isfinite(gs_k).all()) and bool(torch.isfinite(gd_k).all())):
        raise AssertionError("K2b: gradient not finite")
    if bool(gs_k[T1 - 1].any()) or bool(gd_k[~real].any()):
        raise AssertionError("K2b: pad slots or the trash row got a nonzero "
                             "gradient")
    # reads as K2f plus 5 channels each of ct and out at every written row;
    # writes the per-tile static gradient (atomic adds into (T+1, 10, Ks))
    # and the per-slot dynamic gradient once
    b_ms, b_by = bound(int(tile_need.sum()) * 40 + int(d_entries.sum()) * 40
                       + ids.numel() * 8 + T1 * 4 + rows_written * 2 * 5 * P_ * 4
                       + T1 * 10 * Ks * 4 + ids.numel() * 10 * Kd * 4,
                       ALPHA_FLOPS * P_ * entries + GRAD_FLOPS * blended)
    k2b = dict(name="composite_pair_sel_bwd", route="cuda",
               source="sim_a_splat_torch/csrc/composite_sel_bwd.cu",
               replaces="sim_a_splat_tpu/ops/pallas_composite_sel.py:633",
               max_abs_err=e2b,
               # the whole gradient: the per-tile sum is in the kernel
               ms=cuda_ms(lambda: composite_sel.composite_pair_sel_bwd(*a2b),
                          10),
               plain_ms=cuda_ms(k2b_plain, 1, warmup=0),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"  gradient pairs (α > 0): {blended}; kernel {k2b['ms']:.4f} ms "
        f"with the per-tile sum and its zero fill "
        f"({composite_sel.blocks_per_sm(True, Kd, ts2)} blocks/SM, "
        f"{composite_sel.smem_bytes(Kd, ts2, True)} B shared; first design "
        f"{FIRST_DESIGN_MS['composite_pair_sel_bwd']} ms), plain "
        f"{k2b['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    versus_parent("K2b", lambda: composite_sel.composite_pair_sel_bwd(*a2b),
                  parent, 10,
                  parent_fn=lambda: parent_k2.composite_pair_sel_bwd(*a2b))
    return [k2, k2b]


def per_env_lists(rasterize_moving, payload, key, kc, ts, tx, raster):
    """K2's per-env inputs from one moving frame's lists, captured where
    ``render_moving_batch`` merges them (``_sort_by_key`` of its payload
    (B, T, 10, kc + Kd) and key): each env's reprojected statics (the first
    kc columns) and the frame's dynamic lists apart, each sorted by depth,
    with the zero trash row and the dense ids ids[b] = arange(T) → the
    arguments of ``composite_sel.composite_pair_sel``."""
    import math
    import torch
    lists = []
    for cols in (slice(0, kc), slice(kc, None)):
        k = key[..., cols]
        lists.append((rasterize_moving._sort_by_key(payload[..., cols], k),
                      torch.sum(k < math.inf, dim=-1).to(torch.int32)))
    (spay, cs), (dpay, cd) = lists
    B_, T = cs.shape
    spay_pad = torch.cat([spay, spay.new_zeros((B_, 1) + spay.shape[2:])], 1)
    cs_pad = torch.cat([cs, cs.new_zeros((B_, 1))], 1)
    ids = torch.arange(T, dtype=torch.int32, device=cs.device).expand(
        B_, T).contiguous()
    return (spay_pad.contiguous(), dpay.contiguous(), ids, cs_pad.contiguous(),
            cd.contiguous(), ts, tx, raster.sigma_cutoff, raster.term_eps)


def sel_per_env_rows(a2, reset_counts, counts_now, dev, plain_envs=2):
    """K2f and K2b in the per-env mode on ``a2`` (per-env static lists
    (B, T+1, 10, Ks) with counts (B, T+1), dense ids): one forward and its
    backward through ``composite_sel.composite_pair_sel`` (the launches
    counted), each kernel against its plain version (the plain backward
    ``plain_envs`` envs at a time), each env's forward rows against the
    shared-mode K2f run on that env's lists alone, bit for bit, and the
    times by CUDA events beside the bound, which counts each env's own
    static read and, in K2b, the gradient's zero fill.  Returns the two
    rows of the ``kernels`` line."""
    import numpy as np
    import torch
    from sim_a_splat_torch.ops import composite, composite_sel
    spay, dpay, ids, cs_pad, cd = a2[:5]
    ts2 = a2[5]
    P_ = ts2 ** 2
    B_, TT = ids.shape
    T1, Ks, Kd = spay.shape[1], spay.shape[-1], dpay.shape[-1]
    log(f"K2 per-env mode (spay {tuple(spay.shape)}, "
        f"{spay.numel() * 4 / 1e6:.1f} MB; dpay {tuple(dpay.shape)}; dense "
        f"ids; static entries a slot: mean "
        f"{float(cs_pad[:, :-1].float().mean()):.1f}, dynamic "
        f"{float(cd.float().mean()):.1f}):")
    bidx = torch.arange(B_, device=dev)[:, None]
    named = bidx, ids.long()
    ct = torch.zeros((B_, T1, 8, P_), device=dev)
    ct[bidx, ids.long(), :5] = torch.as_tensor(np.random.default_rng(2).normal(
        size=(B_, TT, 5, P_)).astype(np.float32), device=dev)
    ct[:, T1 - 1] = 0.0                         # the trash row: pads only

    # the phase's run: one forward and backward through the Function
    leaves = (spay.clone().requires_grad_(), dpay.clone().requires_grad_())
    reset_counts()
    out_f = composite_sel.composite_pair_sel(*leaves, *a2[2:])
    (out_f[named] * ct[named]).sum().backward()
    torch.cuda.synchronize()
    launches = counts_now()
    want = {"composite_pair_sel": 1, "composite_pair_sel_bwd": 1}
    if any(n != want.get(k, 0) for k, n in launches.items()):
        raise AssertionError(f"one per-env forward and backward launched "
                             f"{launches}")
    out_k, gs_k, gd_k = out_f.detach(), leaves[0].grad, leaves[1].grad

    out_p, applied, hits = composite_sel.composite_pair_sel_plain(
        *a2, return_work=True)
    rows = [0, 1, 2, 4]
    sel_k, sel_p = out_k[named], out_p[named]
    e_f = check("K2 per-env", sel_k[:, :, rows], sel_p[:, :, rows], TOL,
                "rgb+trans (selected rows)")
    dscale = max(1.0, float(spay[:, :, 8].abs().max()),
                 float(dpay[:, :, 8].abs().max()))
    check("K2 per-env", sel_k[:, :, 3] / dscale, sel_p[:, :, 3] / dscale,
          TOL, "depth_acc / max depth")
    for b in range(B_):
        one = composite_sel.composite_pair_sel(
            spay[b], dpay[b:b + 1], ids[b:b + 1], cs_pad[b], cd[b:b + 1],
            *a2[5:])
        if not torch.equal(one[0, ids[b].long()], out_k[b, ids[b].long()]):
            raise AssertionError(f"K2 per-env: env {b}'s rows differ from "
                                 "the shared mode on its lists alone")
    log(f"  each of the {B_} envs' rows equal to the shared-mode K2f on "
        "that env's lists alone, bit for bit")

    def bwd_plain():
        g_s, g_d = torch.zeros_like(spay), torch.empty_like(dpay)
        for b0 in range(0, B_, plain_envs):
            sl = slice(b0, b0 + plain_envs)
            g_s[sl], g_d[sl] = composite_sel.composite_pair_sel_bwd_plain(
                spay[sl], dpay[sl], ids[sl], cs_pad[sl], cd[sl], ct[sl],
                *a2[5:])
        return g_s, g_d

    gs_p, gd_p = bwd_plain()
    e_b = max(check_rows("K2b per-env", gs_k[:, :T1 - 1], gs_p[:, :T1 - 1],
                         "static grad, per env and tile"),
              check_rows("K2b per-env", gd_k, gd_p, "dynamic grad"))
    if not (bool(torch.isfinite(gs_k).all()) and bool(torch.isfinite(gd_k).all())):
        raise AssertionError("K2b per-env: gradient not finite")
    if bool(gs_k[:, T1 - 1].any()):
        raise AssertionError("K2b per-env: a trash row got a gradient")

    # the work these inputs need: each slot reads its own env's static list
    cs_slot = torch.clamp(cs_pad[named].long(), max=Ks)             # (B, TT)
    c0 = torch.arange(Ks // composite.CHUNK, device=dev) * composite.CHUNK
    per_chunk = torch.clamp(cs_slot[..., None] - c0, 0, composite.CHUNK)
    used = torch.arange(len(c0), device=dev) < applied[..., None]
    s_entries = int((per_chunk * used).sum())
    d_entries = int(torch.clamp(cd.long(), max=Kd).sum())
    entries, blended = s_entries + d_entries, int(hits.sum())
    reads = (s_entries + d_entries) * 40 + ids.numel() * 8 + cs_pad.numel() * 4
    b_f = bound(reads + ids.numel() * 8 * P_ * 4,
                ALPHA_FLOPS * P_ * entries + BLEND_FLOPS * blended)
    # K2b: + 5 channels each of ct and out a row; the static gradient
    # (B, T+1, 10, Ks) and the dynamic one each written once (the static
    # one's zero fill is that write: the atomic adds touch only the applied
    # entries, which the reads above count)
    b_b = bound(reads + ids.numel() * 2 * 5 * P_ * 4 + spay.numel() * 4
                + dpay.numel() * 4,
                ALPHA_FLOPS * P_ * entries + GRAD_FLOPS * blended)
    a2b = (spay, dpay, ids, cs_pad, cd, ct, out_k, *a2[5:])
    k2 = dict(name="composite_pair_sel_per_env", route="cuda",
              source="sim_a_splat_torch/csrc/composite_sel.cu",
              replaces="sim_a_splat_tpu/ops/pallas_composite_sel.py:583",
              max_abs_err=e_f, launches=launches["composite_pair_sel"],
              ms=cuda_ms(lambda: composite_sel.composite_pair_sel(*a2), 10),
              plain_ms=cuda_ms(
                  lambda: composite_sel.composite_pair_sel_plain(*a2), 1),
              bound_ms=b_f[0], bound_by=b_f[1], library_ms=None)
    k2b = dict(name="composite_pair_sel_bwd_per_env", route="cuda",
               source="sim_a_splat_torch/csrc/composite_sel_bwd.cu",
               replaces="sim_a_splat_tpu/ops/pallas_composite_sel.py:633",
               max_abs_err=e_b, launches=launches["composite_pair_sel_bwd"],
               ms=cuda_ms(lambda: composite_sel.composite_pair_sel_bwd(*a2b),
                          10),
               plain_ms=cuda_ms(bwd_plain, 1, warmup=0),
               bound_ms=b_b[0], bound_by=b_b[1], library_ms=None)
    shared = (spay[0], dpay, ids, cs_pad[0], cd, *a2[5:])
    fill_ms = cuda_ms(lambda: torch.zeros_like(spay), 10)
    log(f"  slots {ids.numel()}, entries {entries} ({s_entries} static, read "
        f"per env); (pixel, entry) pairs: {P_ * entries} alpha, {blended} "
        f"blended (α > 0); K2f {k2['ms']:.4f} ms (the shared mode on env 0's "
        f"lists for every env: "
        f"{cuda_ms(lambda: composite_sel.composite_pair_sel(*shared), 10):.4f}"
        f" ms), plain {k2['plain_ms']:.3f} ms, bound {b_f[0]:.4f} ms "
        f"({b_f[1]}); K2b {k2b['ms']:.4f} ms with the gradient's zero fill "
        f"({fill_ms:.4f} ms alone), plain {k2b['plain_ms']:.3f} ms ("
        f"{plain_envs} envs at a time), bound {b_b[0]:.4f} ms ({b_b[1]})")
    return [k2, k2b]


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a "
              "CUDA device", file=sys.stderr)
        return 2
    from sim_a_splat_torch import entry
    from sim_a_splat_torch.ops import (
        _kernels, composite, composite_pair, composite_sel, composite_single,
        rasterize_moving,
    )
    from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
    from sim_a_splat_torch.envs import manipulator_envs
    from sim_a_splat_torch.physics import pusht
    from sim_a_splat_torch.utils import profiling

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. toolchain ------------------------------------------------------------
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()})")
    log("nvcc: " + run([_kernels.nvcc_path(), "--version"]).splitlines()[-1])
    try:
        import triton
        log(f"triton {triton.__version__} imports")
    except ImportError as e:
        log(f"triton does not import ({e})")

    # 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    report = _kernels.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"(parallel nvcc; rebuilt: {sorted(report) or 'none, cached'})")
    parent = parent_k2 = parent_k3 = None
    if "--parent" in sys.argv[1:]:
        t0 = time.perf_counter()
        parent_dir = sys.argv[sys.argv.index("--parent") + 1]
        parent = parent_libraries(parent_dir)
        parent_k2 = parent_module(parent_dir, "composite_sel")
        parent_k3 = parent_module(parent_dir, "composite_single")
        log(f"the parent's K2, K3 and K4 kernels built in "
            f"{time.perf_counter() - t0:.2f} s")
    for name, r in report.items():
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}.cu ptxas: {line.strip()}")

    # scene and step at full width ---------------------------------------------
    graph = bench_graph(entry, dev)
    raster = RasterConfig(tile_size=16, tile_capacity=1024,
                          max_tiles_per_gaussian=16, sigma_cutoff=3.0, term_eps=1e-4,
                          buckets=((4, 0.90), (6, 0.06), (9, 0.04)))
    prepare, step, P = entry.make_step_cached_batch(
        graph, RES, RES, raster, dyn_capacity=DYN_CAP, sel_tiles=SEL_TILES,
        dyn_max_tiles=DYN_M, device=dev)
    scene = graph.scene
    gen = torch.Generator(device=dev).manual_seed(0)
    states0 = pusht.reset(P, gen, B)
    actions = torch.tensor([[150.0, 250.0]], device=dev).repeat(B, 1)

    # one step with the kernels' inputs captured (also the warm-up)
    seen = {}

    def capture(key, fn):
        def wrapped(*args, **kw):
            seen[key] = args
            return fn(*args, **kw)
        return wrapped

    with replaced(composite, "composite_static",
                  capture("k1", composite.composite_static)), \
            replaced(composite_sel, "composite_pair_sel",
                     capture("k2", composite_sel.composite_pair_sel)):
        _, imgs0, drop0 = step(prepare(scene), scene, states0, actions)
    torch.cuda.synchronize()
    log(f"first step: n_drop {drop0.tolist()}")

    kernels = []

    # 3-4. K1 and K2 at full size ---------------------------------------------
    kernels += static_rows(seen["k1"], dev)
    kernels += sel_rows(seen["k2"], parent, dev, parent_k2=parent_k2)


    # 5. the main path forward, timed ----------------------------------------
    # the launches since the last reset_counts() (profiling.launches
    # counts every kernel's by operator name), K1-K4's unless asked
    base = profiling.launches.copy()

    def reset_counts():
        nonlocal base
        base = profiling.launches.copy()

    def counts_now(ops=RENDER_OPS):
        return {n: profiling.launches[n] - base[n] for n in ops}

    fixed_names = ("composite_static", "composite_pair_sel",
                   "composite_static_bwd", "composite_pair_sel_bwd")

    reset_counts()
    states = states0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_host = time.perf_counter()
    start.record()
    drops = []
    for _ in range(ITERS):
        cache = prepare(scene)
        states, imgs, n_drop = step(cache, scene, states, actions)
        drops.append(n_drop)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_host
    launches = counts_now()
    step_ms = start.elapsed_time(end) / ITERS
    drops = torch.stack(drops).cpu()
    exact = bool((drops[:, 0] == 0).all())
    log(f"main path, forward: {ITERS} × (prepare + step_batch), B={B}, N={N}, "
        f"sh{SH_DEGREE}, {RES}²: {step_ms:.2f} ms/step (events), "
        f"{wall / ITERS * 1e3:.2f} ms/step (host clock), "
        f"{B * 1e3 / step_ms:.1f} frames/s; exact={exact}, "
        f"bounded truncations={int(drops[-1, 1])}, launches {launches}, "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not exact:
        raise AssertionError(f"sel-dropped tiles: {drops[:, 0].tolist()}")
    p1_fwd = counts_now(("pusht_step",))["pusht_step"]
    if p1_fwd != ITERS:
        raise AssertionError(f"pusht_step launched {p1_fwd} times in "
                             f"{ITERS} steps of the main path")
    for name in ("composite_static", "composite_pair_sel"):
        if launches[name] < ITERS:
            raise AssertionError(f"kernel {name} launched {launches[name]} "
                                 f"times in {ITERS} steps of the main path")
    for name in ("composite_static_bwd", "composite_pair_sel_bwd",
                 "composite_sel_single", "composite_sel_single_bwd",
                 "composite_pair", "composite_pair_bwd"):
        if launches[name]:
            raise AssertionError(f"the forward step launched {name}")
    if imgs.shape != (B, 3, RES, RES) or not bool(torch.isfinite(imgs).all()):
        raise AssertionError(f"bad images {tuple(imgs.shape)}")
    # each phase alone; the render is step_batch with the control step
    # replaced by its precomputed result
    prep_ms = cuda_ms(lambda: prepare(scene), 3)
    phys_ms = cuda_ms(lambda: pusht.control_step(P, states0, actions), 3)
    cache0, s_next = prepare(scene), pusht.control_step(P, states0, actions)
    with replaced(pusht, "control_step", lambda *_: s_next):
        rend_ms = cuda_ms(lambda: step(cache0, scene, states0, actions), 3)
        rend_dev_ms = device_profile(
            lambda: step(cache0, scene, states0, actions))[0]
    log(f"breakdown (events, each phase alone): prepare {prep_ms:.2f} ms, "
        f"control_step {phys_ms:.2f} ms, step_batch without control_step "
        f"{rend_ms:.2f} ms (first K2 design: 8.96 ms; its device time "
        f"{rend_dev_ms:.2f} ms); sum {prep_ms + phys_ms + rend_ms:.2f} ms vs "
        f"{step_ms:.2f} ms/step")
    p1 = pusht_row(pusht, P, (states0, states), actions)
    p1["launches_fwd"] = p1_fwd

    # image against the port's plain path on the first 8 envs
    s8 = pusht.PushTState(*(f[:8] for f in states0))
    _, imgs_k, drop_k = step(prepare(scene), scene, s8, actions[:8])
    with replaced(composite, "composite_static",
                  composite.composite_static_plain), \
            replaced(composite_sel, "composite_pair_sel",
                     composite_sel.composite_pair_sel_plain):
        _, imgs_p, drop_p = step(prepare(scene), scene, s8, actions[:8])
    e_img = check("step", imgs_k, imgs_p, TOL,
                  "image vs the plain path (first 8 envs)")
    if drop_k.tolist() != drop_p.tolist():
        raise AssertionError(f"n_drop {drop_k.tolist()} (kernels) vs "
                             f"{drop_p.tolist()} (plain)")

    # device profile of one step (where the time goes) -------------------------
    def profiled(label, fn, ms_per_step):
        dev_ms, avg = device_profile(fn)
        table = avg.table(sort_by="self_cuda_time_total", row_limit=11)
        log(f"profile of one {label}: device time {dev_ms:.2f} ms of "
            f"{ms_per_step:.2f} ms/step, idle share "
            f"{1 - dev_ms / ms_per_step:.3f}")
        for line in table.splitlines()[:14]:
            log("  " + line)

    profiled("step", lambda: step(prepare(scene), scene, states0, actions),
             step_ms)

    # 6. the main path's train step, timed ------------------------------------
    fields = [n for n, f in zip(scene._fields, scene) if f is not None]
    reset_counts()
    states = states0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_host = time.perf_counter()
    start.record()
    out_train = []
    for _ in range(ITERS):
        states, loss, n_drop, grads = entry.loss_and_grads(
            prepare, step, scene, states, actions)
        out_train.append((loss, n_drop, grads))
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_host
    launches = counts_now()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    p1["launches"] = counts_now(("pusht_step",))["pusht_step"]
    kernels.append(p1)
    if p1["launches"] != ITERS:
        raise AssertionError(f"pusht_step launched {p1['launches']} times in "
                             f"{ITERS} train steps of the main path")
    launches = {n: launches[n] for n in fixed_names}
    train_ms = start.elapsed_time(end) / ITERS
    drops = torch.stack([o[1] for o in out_train]).cpu()
    exact = bool((drops[:, 0] == 0).all())
    finite = all(bool(torch.isfinite(getattr(g, n)).all())
                 for _, _, g in out_train for n in fields)
    log(f"main path, train: {ITERS} × loss_and_grads (prepare + step_batch + "
        f"mean(imgs²) + its gradient to {', '.join(fields)}): "
        f"{train_ms:.2f} ms/step (events), {wall / ITERS * 1e3:.2f} ms/step "
        f"(host clock), {B * 1e3 / train_ms:.1f} frames/s; exact={exact}, "
        f"grads finite={finite}, loss {float(out_train[-1][0]):.6f}, "
        f"launches {launches}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not exact:
        raise AssertionError(f"sel-dropped tiles: {drops[:, 0].tolist()}")
    if not finite:
        raise AssertionError("a gradient of the train step is not finite")
    for name, n in launches.items():
        if n < ITERS:
            raise AssertionError(f"kernel {name} launched {n} times in "
                                 f"{ITERS} train steps of the main path")
    # its forward and backward alone (the backward on a kept graph)
    leaves = type(scene)(*(None if f is None else f.detach().requires_grad_()
                           for f in scene))
    leaf_list = [f for f in leaves if f is not None]

    def forward():
        _, imgs_, _ = step(prepare(leaves), leaves, states0, actions)
        return torch.mean(imgs_ ** 2)

    fwd_ms = cuda_ms(forward, 3)
    loss0 = forward()
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(loss0, leaf_list,
                                                 retain_graph=True), 3)
    bwd_dev_ms = device_profile(lambda: torch.autograd.grad(
        loss0, leaf_list, retain_graph=True))[0]
    del loss0
    log(f"breakdown (events, each phase alone): forward with the graph kept "
        f"{fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms (its device time "
        f"{bwd_dev_ms:.2f} ms); sum {fwd_ms + bwd_ms:.2f} ms vs "
        f"{train_ms:.2f} ms/step")
    profiled("train step", lambda: entry.loss_and_grads(
        prepare, step, scene, states0, actions), train_ms)

    # 7. the train step's gradients against the port's plain path, 8 envs ------
    _, loss_k, drop_k, g_k = entry.loss_and_grads(prepare, step, scene, s8,
                                                  actions[:8])
    with replaced(composite, "composite_static",
                  composite.composite_static_plain), \
            replaced(composite_sel, "composite_pair_sel",
                     composite_sel.composite_pair_sel_plain):
        _, loss_p, drop_p, g_p = entry.loss_and_grads(prepare, step, scene,
                                                      s8, actions[:8])
    if drop_k.tolist() != drop_p.tolist():
        raise AssertionError(f"n_drop {drop_k.tolist()} (kernels) vs "
                             f"{drop_p.tolist()} (plain)")
    log(f"train step vs the plain path (first 8 envs): loss {float(loss_k)} "
        f"vs {float(loss_p)}")
    e_grad = check_fields("train-step", g_k, g_p, fields)

    log(f"image max|Δ| vs plain: {e_img:.3e}; train-step gradients max|Δ| / "
        f"max|g|: {e_grad:.3e}; {time.perf_counter() - t_start:.1f} s so far")
    del out_train, g_k, g_p

    # 8-11. the per-env fixed-camera step (kernel K4) --------------------------
    kernels += per_env_camera(entry, composite, composite_sel, composite_pair,
                              pusht, graph, scene, P, states0, actions,
                              raster, imgs0, drop0, reset_counts, counts_now,
                              profiled, parent, dev)
    del imgs0
    log(f"{time.perf_counter() - t_start:.1f} s so far")

    # 11b. K2 and K4 at a dynamic capacity past their backward kernels'
    # windows, and at tile size 32 ---------------------------------------------
    large_capacity(entry, composite_sel, composite_pair, pusht, graph, scene,
                   states0, actions, raster, parent, dev, parent_k2)
    log(f"{time.perf_counter() - t_start:.1f} s so far")

    # 12-15. the moving camera -----------------------------------------------
    kernels += moving_camera(entry, composite, composite_single,
                             rasterize_moving, pusht, graph, scene, P, gen,
                             reset_counts, counts_now, profiled, parent,
                             parent_k3, dev)
    log(f"{time.perf_counter() - t_start:.1f} s so far")

    # 16-18. the uncached step (K1 over B images' tiles) -----------------------
    torch.cuda.empty_cache()
    kernels += uncached_step(entry, composite, pusht, graph, scene, P, raster,
                             reset_counts, counts_now, profiled, dev)
    log(f"{time.perf_counter() - t_start:.1f} s so far")

    # 19-24. the arm product path (K1, K2 and K3 at 240×320) ------------------
    del graph, scene, prepare, step
    torch.cuda.empty_cache()
    kernels += arm_product(entry, composite, composite_sel, composite_single,
                           reset_counts, counts_now, profiled, dev)
    log(f"{time.perf_counter() - t_start:.1f} s so far")

    # 25-27. the env layer (pushT's envs; the splat env from asset files) ----
    torch.cuda.empty_cache()
    kernels += env_layer(composite, reset_counts, counts_now, dev)
    log(f"{time.perf_counter() - t_start:.1f} s so far")

    # 27b. the example drivers (K1f at 240×320 and in the viewer) ----------
    kernels += examples_phase(composite, reset_counts, counts_now, dev)
    log(f"{time.perf_counter() - t_start:.1f} s so far")

    # 28-31. the splat trainer (K1f, K1b at train_scene.py's full width) ----
    torch.cuda.empty_cache()
    kernels += splat_training(entry, composite, reset_counts, counts_now,
                              profiled, dev)
    log(f"{time.perf_counter() - t_start:.1f} s so far")

    # 32-33. the pipeline and the exports (K1f at 640×480) ------------------
    torch.cuda.empty_cache()
    kernels += splat_pipeline(entry, composite, reset_counts, counts_now,
                              dev)
    log(f"{time.perf_counter() - t_start:.1f} s so far")

    # 34-37. the distributed layer (K1f, K1b on the owned rows; dryrun: K1-K4)
    torch.cuda.empty_cache()
    kernels += distributed(entry, dev)
    log(f"{time.perf_counter() - t_start:.1f} s so far")

    # 38-39. the viewer (K1f) and the offline matching tools -----------------
    viewer_phase(composite, reset_counts, counts_now, dev)
    tools_phase()
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def per_env_camera(entry, composite, composite_sel, composite_pair, pusht,
                   graph, scene, P, states0, actions, raster, imgs_sel,
                   drop_sel, reset_counts, counts_now, profiled, parent, dev):
    """The per-env fixed-camera path (``entry.make_step_cached``, the
    reference's vmapped ``_make_step_cached``): K4f/K4b against their plain
    versions at full size, against K2f/K2b on the same (env, tile) pairs
    (bit for bit) and, with ``parent``, timed beside the parent's kernels;
    ITERS forward steps and ITERS train steps (timed, launches checked), the
    images against the plain path (8 envs), against the selected-tile
    path's ``imgs_sel`` (same states, both exact) and with
    ``static_skip=False`` (16 envs), and the gradients against the plain
    path (8 envs).  Returns the K4f and K4b entries of the ``kernels``
    line."""
    import numpy as np
    import torch
    prepare, step, _ = entry.make_step_cached(
        graph, RES, RES, raster, dyn_capacity=DYN_CAP, dyn_max_tiles=DYN_M,
        device=dev)

    # 8. K4f and K4b at full size, on one step's captured inputs -------------
    seen = {}
    real_k4 = composite_pair.composite_pair

    def capture(*args):
        seen["k4"] = args
        return real_k4(*args)

    with replaced(composite_pair, "composite_pair", capture):
        _, imgs0, trunc0 = step(prepare(scene), scene, states0, actions)
    torch.cuda.synchronize()
    a4 = seen.pop("k4")
    spay, dpay, cs, cd, skip = a4[:5]
    Bk, T = skip.shape
    Ks, Kd = spay.shape[-1], dpay.shape[-1]
    P_ = a4[5] ** 2
    log(f"per-env step (make_step_cached, B={Bk}): first step's bounded "
        f"truncations {int(trunc0.sum())}")
    log(f"K4 composite_pair vs composite_pair_plain (spay "
        f"{tuple(spay.shape)}, dpay {tuple(dpay.shape)}):")
    out_k = composite_pair.composite_pair(*a4)
    out_p, applied, hits = composite_pair.composite_pair_plain(
        *a4, return_work=True)
    rows = [0, 1, 2, 4]
    e4 = check("K4", out_k[..., rows], out_p[..., rows], TOL, "rgb+trans")
    dscale = max(1.0, float(spay[:, 8].abs().max()),
                 float(dpay[:, :, 8].abs().max()))
    check("K4", out_k[..., 3] / dscale, out_p[..., 3] / dscale, TOL,
          "depth_acc / max depth")
    on = skip > 0
    c0 = torch.arange(Ks // composite.CHUNK, device=dev) * composite.CHUNK
    per_chunk = torch.clamp(torch.clamp(cs.long(), max=Ks)[:, None] - c0, 0,
                            composite.CHUNK)                   # (T, nc)
    used = torch.arange(len(c0), device=dev) < applied[..., None]
    s_entries = (per_chunk * used).sum(-1)                     # (B, T)
    d_entries = torch.clamp(cd.long(), max=Kd) * on
    entries = int(s_entries.sum() + d_entries.sum())
    blended = int(hits.sum())
    n_on = int(on.sum())
    # reads each tile's applied static columns once (shared by the envs),
    # the touched pairs' dynamic entries, counts and skip; writes every
    # (env, tile) row of out
    in_bytes = (int(s_entries.amax(0).sum()) * 40 + int(d_entries.sum()) * 40
                + T * 4 + Bk * T * 8)
    b_ms, b_by = bound(in_bytes + Bk * T * P_ * 8 * 4,
                       ALPHA_FLOPS * P_ * entries + BLEND_FLOPS * blended)
    k4 = dict(name="composite_pair", route="cuda",
              source="sim_a_splat_torch/csrc/composite_pair.cu",
              replaces="sim_a_splat_tpu/ops/pallas_composite_pair.py:352",
              max_abs_err=e4,
              ms=cuda_ms(lambda: composite_pair.composite_pair(*a4), 10),
              plain_ms=cuda_ms(
                  lambda: composite_pair.composite_pair_plain(*a4), 1),
              bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"  touched (env, tile) pairs {n_on} of {Bk * T}, entries {entries}; "
        f"(pixel, entry) pairs: {P_ * entries} alpha, {blended} blended "
        f"(α > 0); kernel {k4['ms']:.4f} ms (first design "
        f"{FIRST_DESIGN_MS['composite_pair']} ms), plain "
        f"{k4['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    versus_parent("K4f", lambda: composite_pair.composite_pair(*a4), parent,
                  10)
    # K4 runs K2's block body: K2f on the same (env, tile) pairs
    a2 = k2_slots_of_k4(*a4[:5])
    ids = a2[2]
    out2 = composite_sel.composite_pair_sel(*a2, *a4[5:])
    bidx = torch.arange(Bk, device=dev)[:, None]
    real = ids < T
    safe = torch.where(real, ids, 0).long()
    same = torch.equal(out_k[bidx, safe][real],
                       out2[bidx, safe][real].transpose(-1, -2))
    k2_ms = cuda_ms(lambda: composite_sel.composite_pair_sel(*a2, *a4[5:]),
                    10)
    log(f"  K4f on the {int(real.sum())} touched pairs equals K2f on the same "
        f"pairs (slots of {tuple(ids.shape)}) bit for bit: {same}; K2f there "
        f"{k2_ms:.4f} ms, K4f {k4['ms']:.4f} ms "
        f"({k4['ms'] / k2_ms:.2f}×, with the skipped pairs' output)")
    if not same:
        raise AssertionError("K4f differs from K2f on the same pairs")

    log("K4b composite_pair_bwd vs composite_pair_bwd_plain (the plain "
        "version 8 envs at a time):")
    ct4 = torch.zeros_like(out_k)
    ct4[on] = torch.nn.functional.pad(torch.as_tensor(
        np.random.default_rng(3).normal(size=(n_on, P_, 5)).astype(
            np.float32), device=dev), (0, 3))
    a4b = (spay, dpay, cs, cd, skip, ct4, out_k, *a4[5:])
    gs_k, gd_k = composite_pair.composite_pair_bwd(*a4b)

    def k4b_plain():
        g_s, g_d = torch.zeros_like(spay), torch.empty_like(dpay)
        for b0 in range(0, Bk, 8):
            sl = slice(b0, b0 + 8)
            s_, d_ = composite_pair.composite_pair_bwd_plain(
                spay, dpay[sl], cs, cd[sl], skip[sl], ct4[sl], *a4[5:])
            g_s += s_
            g_d[sl] = d_
        return g_s, g_d

    gs_p, gd_p = k4b_plain()
    e4b = max(check_rows("K4b", gs_k, gs_p, "static grad, summed over envs"),
              check_rows("K4b", gd_k, gd_p, "dynamic grad"))
    if not (bool(torch.isfinite(gs_k).all())
            and bool(torch.isfinite(gd_k).all())):
        raise AssertionError("K4b: gradient not finite")
    if bool(gd_k[~on].any()):
        raise AssertionError("K4b: a skipped pair got a dynamic gradient")
    # reads as K4f plus 5 channels each of ct and out at the touched pairs;
    # writes the static gradient and the whole dynamic gradient once
    b_ms, b_by = bound(in_bytes + n_on * 2 * 5 * P_ * 4
                       + (spay.numel() + dpay.numel()) * 4,
                       ALPHA_FLOPS * P_ * entries + GRAD_FLOPS * blended)
    k4b = dict(name="composite_pair_bwd", route="cuda",
               source="sim_a_splat_torch/csrc/composite_pair_bwd.cu",
               replaces="sim_a_splat_tpu/ops/pallas_composite_pair.py:386",
               max_abs_err=e4b,
               ms=cuda_ms(lambda: composite_pair.composite_pair_bwd(*a4b),
                          10),
               plain_ms=cuda_ms(k4b_plain, 1, warmup=0),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"  gradient pairs (α > 0): {blended}; kernel {k4b['ms']:.4f} ms "
        f"(with the zero fill of the static gradient; first design "
        f"{FIRST_DESIGN_MS['composite_pair_bwd']} ms), plain "
        f"{k4b['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    versus_parent("K4b", lambda: composite_pair.composite_pair_bwd(*a4b),
                  parent, 10)
    ct2 = torch.zeros_like(out2)
    ct2[bidx, ids.long()] = torch.where(             # pads: the trash row
        real[..., None, None], ct4[bidx, safe].transpose(-1, -2), 0.0)
    a2b = (*a2, ct2, out2, *a4[5:])
    _, gd2 = composite_sel.composite_pair_sel_bwd(*a2b)
    same = torch.equal(gd_k[bidx, safe][real], gd2[real])
    k2b_ms = cuda_ms(lambda: composite_sel.composite_pair_sel_bwd(*a2b), 10)
    log(f"  K4b's dynamic gradient on the touched pairs equals K2b's bit for "
        f"bit: {same}; K2b there {k2b_ms:.4f} ms, K4b {k4b['ms']:.4f} ms "
        f"({k4b['ms'] / k2b_ms:.2f}×, with the skipped pairs' zero rows)")
    if not same:
        raise AssertionError("K4b's dynamic gradient differs from K2b's")
    del a4, a4b, out_k, out_p, ct4, gs_k, gd_k, gs_p, gd_p, spay, dpay
    del a2, a2b, out2, ct2, gd2

    # 9. the per-env step forward, timed --------------------------------------
    def forward_counts(n):
        want = dict.fromkeys(counts_now(), 0)
        want.update(composite_static=n, composite_pair=n)
        return want

    reset_counts()
    states = states0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_host = time.perf_counter()
    start.record()
    for _ in range(ITERS):
        states, imgs, trunc = step(prepare(scene), scene, states, actions)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_host
    launches = counts_now()
    step_ms = start.elapsed_time(end) / ITERS
    log(f"per-env step, forward: {ITERS} × (prepare + step), B={B}, N={N}, "
        f"sh{SH_DEGREE}, {RES}²: {step_ms:.2f} ms/step (events), "
        f"{wall / ITERS * 1e3:.2f} ms/step (host clock), "
        f"{B * 1e3 / step_ms:.1f} frames/s; bounded truncations "
        f"{int(trunc.sum())}, launches {launches}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches != forward_counts(ITERS):
        raise AssertionError(f"{ITERS} forward steps of the per-env path "
                             f"launched {launches}")
    if imgs.shape != (B, RES, RES, 3) or not bool(torch.isfinite(imgs).all()):
        raise AssertionError(f"bad per-env images {tuple(imgs.shape)}")
    prep_ms = cuda_ms(lambda: prepare(scene), 3)
    cache0, s_next = prepare(scene), pusht.control_step(P, states0, actions)
    with replaced(pusht, "control_step", lambda *_: s_next):
        rend_ms = cuda_ms(lambda: step(cache0, scene, states0, actions), 3)
    log(f"breakdown (events, each phase alone): prepare {prep_ms:.2f} ms, "
        f"step without control_step {rend_ms:.2f} ms")
    del cache0
    profiled("per-env step", lambda: step(prepare(scene), scene, states0,
                                          actions), step_ms)

    # 10. its images against the plain path, the selected-tile path and the
    # step without the static skip -------------------------------------------
    s8 = pusht.PushTState(*(f[:8] for f in states0))
    _, imgs_k, tr_k = step(prepare(scene), scene, s8, actions[:8])
    with replaced(composite, "composite_static",
                  composite.composite_static_plain), \
            replaced(composite_pair, "composite_pair",
                     composite_pair.composite_pair_plain):
        _, imgs_p, tr_p = step(prepare(scene), scene, s8, actions[:8])
    e_img = check("per-env step", imgs_k, imgs_p, TOL,
                  "image vs the plain path (first 8 envs)")
    if tr_k.tolist() != tr_p.tolist():
        raise AssertionError(f"truncations {tr_k.tolist()} (kernels) vs "
                             f"{tr_p.tolist()} (plain)")
    if int(drop_sel[0]) != 0:
        raise AssertionError(f"the selected-tile step dropped tiles: "
                             f"{drop_sel.tolist()}")
    check("per-env step", imgs0, imgs_sel.permute(0, 2, 3, 1), TOL,
          f"image vs the selected-tile path (all {B} envs, both exact)")
    prep_ns, step_ns, _ = entry.make_step_cached(
        graph, RES, RES, raster, dyn_capacity=DYN_CAP, dyn_max_tiles=DYN_M,
        static_skip=False, device=dev)
    s16 = pusht.PushTState(*(f[:16] for f in states0))
    reset_counts()
    _, imgs_ns, _ = step_ns(prep_ns(scene), scene, s16, actions[:16])
    launches = counts_now()
    check("per-env step", imgs_ns, imgs0[:16], TOL,
          "static_skip=False vs True (first 16 envs)")
    if launches["composite_static"] or launches["composite_pair"] != 1:
        raise AssertionError(f"the step without the static skip launched "
                             f"{launches}")
    del imgs_ns, imgs_k, imgs_p, imgs0

    # 11. the per-env train step, timed, and its gradients against the plain
    # path on 8 envs -----------------------------------------------------------
    fields = [n for n, f in zip(scene._fields, scene) if f is not None]
    reset_counts()
    states = states0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_host = time.perf_counter()
    start.record()
    finite = True
    for _ in range(ITERS):
        states, loss, _, grads = entry.loss_and_grads(prepare, step, scene,
                                                      states, actions)
        finite &= all(bool(torch.isfinite(getattr(grads, n)).all())
                      for n in fields)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_host
    launches = counts_now()
    train_ms = start.elapsed_time(end) / ITERS
    log(f"per-env step, train: {ITERS} × loss_and_grads: {train_ms:.2f} "
        f"ms/step (events), {wall / ITERS * 1e3:.2f} ms/step (host clock), "
        f"{B * 1e3 / train_ms:.1f} frames/s; grads finite={finite}, loss "
        f"{float(loss):.6f}, launches {launches}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    want = forward_counts(ITERS)
    want.update(composite_static_bwd=ITERS, composite_pair_bwd=ITERS)
    if launches != want:
        raise AssertionError(f"{ITERS} train steps of the per-env path "
                             f"launched {launches}")
    if not finite:
        raise AssertionError("a gradient of the per-env train step is not "
                             "finite")
    k4["launches"] = launches["composite_pair"]
    k4b["launches"] = launches["composite_pair_bwd"]
    del grads

    _, loss_k, _, g_k = entry.loss_and_grads(prepare, step, scene, s8,
                                             actions[:8])
    with replaced(composite, "composite_static",
                  composite.composite_static_plain), \
            replaced(composite_pair, "composite_pair",
                     composite_pair.composite_pair_plain):
        _, loss_p, _, g_p = entry.loss_and_grads(prepare, step, scene, s8,
                                                 actions[:8])
    log(f"per-env train step vs the plain path (first 8 envs): loss "
        f"{float(loss_k)} vs {float(loss_p)}")
    e_grad = check_fields("per-env train-step", g_k, g_p, fields)
    log(f"per-env image max|Δ| vs plain: {e_img:.3e}; gradients max|Δ| / "
        f"max|g|: {e_grad:.3e}")
    return [k4, k4b]


def large_capacity(entry, composite_sel, composite_pair, pusht, graph, scene,
                   states0, actions, raster, parent, dev, parent_k2=None):
    """K2f, K2b, K4f and K4b at ``dyn_capacity`` BIG_KD, past the dynamic
    windows of the backward kernels (896 entries at ts 16) and past the
    first design's card limits, on LONG_ENVS envs of the main path's scene
    through the selected-tile and the per-env steps, against their plain
    versions run in float64 (their float32 log-space sums drift over
    dynamic lists of thousands of entries), the gradients at TOL_GRAD_LONG;
    then all four at tile size 32 and ``dyn_capacity`` TS32_KD on 8 envs
    (the backward's window: 128 entries), K4 against K2 on the same pairs
    bit for bit, timed (beside the parent's kernels with ``parent``)."""
    import numpy as np
    import torch

    def f64(args):
        return [a.double() if torch.is_tensor(a) and a.is_floating_point()
                else a for a in args]
    sN = pusht.PushTState(*(f[:LONG_ENVS] for f in states0))
    aN = actions[:LONG_ENVS]
    seen = {}

    def capture(key, fn):
        def wrapped(*args):
            seen[key] = args
            return fn(*args)
        return wrapped

    prepare, step, _ = entry.make_step_cached_batch(
        graph, RES, RES, raster, dyn_capacity=BIG_KD, sel_tiles=SEL_TILES,
        dyn_max_tiles=DYN_M, device=dev)
    with replaced(composite_sel, "composite_pair_sel",
                  capture("k2", composite_sel.composite_pair_sel)):
        step(prepare(scene), scene, sN, aN)
    a2 = seen.pop("k2")
    spay, dpay, ids, cs_pad, cd = a2[:5]
    ts = a2[5]
    T1 = spay.shape[0]
    log(f"K2 at dyn_capacity {BIG_KD} ({LONG_ENVS} envs; windows of "
        f"{composite_sel.window(BIG_KD, ts, False)} (K2f) and "
        f"{composite_sel.window(BIG_KD, ts, True)} (K2b) entries, largest "
        f"dynamic count {int(cd.max())}):")
    rows = [0, 1, 2, 4]
    out_k = composite_sel.composite_pair_sel(*a2)
    out_p = composite_sel.composite_pair_sel_plain(*f64(a2))
    bidx = torch.arange(ids.shape[0], device=dev)[:, None]
    sel_k, sel_p = out_k[bidx, ids.long()], out_p[bidx, ids.long()]
    check("K2", sel_k[:, :, rows], sel_p[:, :, rows], TOL,
          "rgb+trans (selected rows)")
    dscale = max(1.0, float(spay[:, 8].abs().max()),
                 float(dpay[:, :, 8].abs().max()))
    check("K2", sel_k[:, :, 3] / dscale, sel_p[:, :, 3] / dscale, TOL,
          "depth_acc / max depth")
    ct = torch.zeros_like(out_k)
    ct[bidx, ids.long(), :5] = torch.as_tensor(np.random.default_rng(4).normal(
        size=(*ids.shape, 5, out_k.shape[-1])).astype(np.float32), device=dev)
    ct[:, T1 - 1] = 0.0
    a2b = (*a2[:5], ct, out_k, *a2[5:])
    gs_k, gd_k = composite_sel.composite_pair_sel_bwd(*a2b)
    gs_p, gd_p = composite_sel.composite_pair_sel_bwd_plain(
        *f64(a2[:5]), ct.double(), *a2[5:])
    check_rows("K2b", gs_k[:T1 - 1], gs_p[:T1 - 1],
               "static grad, summed per tile", TOL_GRAD_LONG)
    check_rows("K2b", gd_k, gd_p, "dynamic grad", TOL_GRAD_LONG)
    log(f"  K2f {cuda_ms(lambda: composite_sel.composite_pair_sel(*a2), 5):.4f}"
        f" ms ({composite_sel.smem_bytes(BIG_KD, ts, False)} B shared), K2b "
        f"{cuda_ms(lambda: composite_sel.composite_pair_sel_bwd(*a2b), 5):.4f}"
        f" ms ({composite_sel.smem_bytes(BIG_KD, ts, True)} B shared)")
    del a2, a2b, spay, dpay, out_k, out_p, sel_k, sel_p, ct, gs_k, gd_k
    del gs_p, gd_p

    prepare, step, _ = entry.make_step_cached(
        graph, RES, RES, raster, dyn_capacity=BIG_KD, dyn_max_tiles=DYN_M,
        device=dev)
    with replaced(composite_pair, "composite_pair",
                  capture("k4", composite_pair.composite_pair)):
        step(prepare(scene), scene, sN, aN)
    a4 = seen.pop("k4")
    skip = a4[4]
    log(f"K4 at dyn_capacity {BIG_KD} ({LONG_ENVS} envs, "
        f"{int((skip > 0).sum())} touched pairs, largest dynamic count "
        f"{int(a4[3].max())}):")
    out_k = composite_pair.composite_pair(*a4)
    out_p = composite_pair.composite_pair_plain(*f64(a4))
    check("K4", out_k[..., rows], out_p[..., rows], TOL, "rgb+trans")
    dscale = max(1.0, float(a4[0][:, 8].abs().max()),
                 float(a4[1][:, :, 8].abs().max()))
    check("K4", out_k[..., 3] / dscale, out_p[..., 3] / dscale, TOL,
          "depth_acc / max depth")
    ct = torch.zeros_like(out_k)
    ct[skip > 0] = torch.nn.functional.pad(torch.as_tensor(
        np.random.default_rng(5).normal(
            size=(int((skip > 0).sum()), out_k.shape[2], 5)).astype(
                np.float32), device=dev), (0, 3))
    a4b = (*a4[:5], ct, out_k, *a4[5:])
    gs_k, gd_k = composite_pair.composite_pair_bwd(*a4b)
    gs_p, gd_p = composite_pair.composite_pair_bwd_plain(*f64(a4[:5]),
                                                         ct.double(), *a4[5:])
    check_rows("K4b", gs_k, gs_p, "static grad, summed over envs",
               TOL_GRAD_LONG)
    check_rows("K4b", gd_k, gd_p, "dynamic grad", TOL_GRAD_LONG)
    log(f"  K4f {cuda_ms(lambda: composite_pair.composite_pair(*a4), 5):.4f} "
        f"ms, K4b {cuda_ms(lambda: composite_pair.composite_pair_bwd(*a4b), 5):.4f} ms")
    del a4, a4b, out_k, out_p, ct, gs_k, gd_k, gs_p, gd_p

    # tile size 32: K2b's and K4b's window is one chunk -----------------------
    raster32 = raster._replace(tile_size=32, tile_capacity=4096)
    s8 = pusht.PushTState(*(f[:8] for f in states0))
    prepare, step, _ = entry.make_step_cached_batch(
        graph, RES, RES, raster32, dyn_capacity=TS32_KD, sel_tiles=SEL_TILES,
        dyn_max_tiles=DYN_M, device=dev)
    with replaced(composite_sel, "composite_pair_sel",
                  capture("k2", composite_sel.composite_pair_sel)):
        step(prepare(scene), scene, s8, actions[:8])
    prepare, step, _ = entry.make_step_cached(
        graph, RES, RES, raster32, dyn_capacity=TS32_KD, dyn_max_tiles=DYN_M,
        device=dev)
    with replaced(composite_pair, "composite_pair",
                  capture("k4", composite_pair.composite_pair)):
        step(prepare(scene), scene, s8, actions[:8])
    a2, a4 = seen.pop("k2"), seen.pop("k4")
    log(f"K2 and K4 at tile size 32, dyn_capacity {TS32_KD} (8 envs; "
        f"windows {composite_sel.window(TS32_KD, 32, False)} forward, "
        f"{composite_sel.window(TS32_KD, 32, True)} backward; largest dynamic "
        f"count {int(a2[4].max())}, {int((a4[4] > 0).sum())} touched pairs):")
    out2 = composite_sel.composite_pair_sel(*a2)
    out4 = composite_pair.composite_pair(*a4)
    k2 = k2_slots_of_k4(*a4[:5])
    real = k2[2] < a4[4].shape[1]
    safe = torch.where(real, k2[2], 0).long()
    b8 = torch.arange(8, device=dev)[:, None]
    same = torch.equal(out4[b8, safe][real], composite_sel.composite_pair_sel(
        *k2, *a4[5:])[b8, safe][real].transpose(-1, -2))
    log(f"  K4f equals K2f on the touched pairs bit for bit: {same}")
    if not same:
        raise AssertionError("K4f differs from K2f on the same pairs at "
                             "tile size 32")
    ids = a2[2]
    ct2 = torch.zeros_like(out2)
    ct2[b8, ids.long(), :5] = torch.as_tensor(np.random.default_rng(6).normal(
        size=(*ids.shape, 5, out2.shape[-1])).astype(np.float32), device=dev)
    ct2[:, -1] = 0.0
    ct4 = torch.zeros_like(out4)
    ct4[a4[4] > 0] = torch.nn.functional.pad(torch.as_tensor(
        np.random.default_rng(7).normal(
            size=(int((a4[4] > 0).sum()), out4.shape[2], 5)).astype(
                np.float32), device=dev), (0, 3))
    a2b = (*a2[:5], ct2, out2, *a2[5:])
    a4b = (*a4[:5], ct4, out4, *a4[5:])
    for g in (*composite_sel.composite_pair_sel_bwd(*a2b),
              *composite_pair.composite_pair_bwd(*a4b)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError("a gradient at tile size 32 is not finite")
    # K2 of the parent through its own wrapper (its launch interface
    # differs from this tree's)
    for label, fn, parent_fn in (
            ("K2f", lambda: composite_sel.composite_pair_sel(*a2),
             lambda: parent_k2.composite_pair_sel(*a2)),
            ("K2b", lambda: composite_sel.composite_pair_sel_bwd(*a2b),
             lambda: parent_k2.composite_pair_sel_bwd(*a2b)),
            ("K4f", lambda: composite_pair.composite_pair(*a4), None),
            ("K4b", lambda: composite_pair.composite_pair_bwd(*a4b), None)):
        if versus_parent(f"{label} at ts 32", fn, parent, 5,
                         parent_fn=parent_fn) is None:
            log(f"  {label} at ts 32: {cuda_ms(fn, 5):.4f} ms")


def single_rows(a3, parent, parent_k3, dev, plain_envs=4):
    """K3f and K3b on the captured arguments ``a3`` of one
    ``composite_single.composite_sel_single`` call against their plain
    versions (K3b for a numpy-seeded cotangent, the plain version
    ``plain_envs`` envs at a time), timed by CUDA events beside their bound
    (and the parent's kernels with ``parent``).  Returns the two rows of
    the ``kernels`` line."""
    import numpy as np
    import torch
    from sim_a_splat_torch.ops import composite, composite_single
    spay, ids, counts_pad = a3[:3]
    Bk, T1, _, Km = spay.shape
    T, P_ = T1 - 1, a3[3] ** 2
    log(f"K3 composite_sel_single vs plain (spay {tuple(spay.shape)}):")
    out_k = composite_single.composite_sel_single(*a3)
    out_p, applied, hits = composite_single.composite_sel_single_plain(
        *a3, return_work=True)
    rows = [0, 1, 2, 4]
    e3 = check("K3", out_k[:, :T, rows], out_p[:, :T, rows], TOL,
               "rgb+trans")
    dscale = max(1.0, float(spay[:, :, 8].abs().max()))
    check("K3", out_k[:, :T, 3] / dscale, out_p[:, :T, 3] / dscale, TOL,
          "depth_acc / max depth")
    cnt = counts_pad[:, :T].long()
    c0 = torch.arange(Km // composite.CHUNK, device=dev) * composite.CHUNK
    per_chunk = torch.clamp(cnt[..., None] - c0, 0, composite.CHUNK)
    used = torch.arange(len(c0), device=dev) < applied[..., None]
    entries = int((per_chunk * used).sum())
    blended = int(hits.sum())
    # reads the applied payload columns, ids and counts; writes 8 rows of
    # every named tile
    nbytes = entries * 40 + ids.numel() * 8 + Bk * T * 8 * P_ * 4
    b_ms, b_by = bound(nbytes,
                       ALPHA_FLOPS * P_ * entries + BLEND_FLOPS * blended)
    k3 = dict(name="composite_sel_single", route="cuda",
              source="sim_a_splat_torch/csrc/composite_single.cu",
              replaces="sim_a_splat_tpu/ops/pallas_composite_sel.py:465",
              max_abs_err=e3,
              ms=cuda_ms(lambda: composite_single.composite_sel_single(*a3),
                         20),
              plain_ms=cuda_ms(
                  lambda: composite_single.composite_sel_single_plain(*a3), 2),
              bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"  applied entries {entries} of {int(cnt.clamp(max=Km).sum())} "
        f"active; (pixel, entry) pairs: {P_ * entries} alpha, {blended} "
        f"blended (α > 0); kernel {k3['ms']:.4f} ms, plain "
        f"{k3['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    versus_parent("K3f", lambda: composite_single.composite_sel_single(*a3),
                  parent, 20,
                  parent_fn=lambda: parent_k3.composite_sel_single(*a3))

    log("K3b composite_sel_single_bwd vs composite_sel_single_bwd_plain "
        f"(the plain version {plain_envs} envs at a time):")
    with torch.enable_grad():        # the training forward: row 5 is filled
        out_s = composite_single.composite_sel_single(
            spay.detach().requires_grad_(), *a3[1:]).detach()
    ct3 = torch.zeros_like(out_s)
    ct3[:, :T, :5] = torch.as_tensor(np.random.default_rng(2).normal(
        size=(Bk, T, 5, P_)).astype(np.float32), device=dev)
    a3b = (spay, ids, counts_pad, ct3, out_s, *a3[3:])
    g_k = composite_single.composite_sel_single_bwd(*a3b)

    def k3b_plain():
        g = torch.empty_like(spay)
        for b0 in range(0, Bk, plain_envs):
            sl = slice(b0, b0 + plain_envs)
            g[sl] = composite_single.composite_sel_single_bwd_plain(
                spay[sl], ids[sl], counts_pad[sl], ct3[sl], *a3[3:])
        return g

    g_p = k3b_plain()
    e3b = check_rows("K3b", g_k[:, :T], g_p[:, :T], "payload grad")
    if not bool(torch.isfinite(g_k).all()) or bool(g_k[:, T].any()):
        raise AssertionError("K3b: gradient not finite, or the trash row "
                             "got one")
    # reads as K3f plus 5 channels each of ct and out at every named tile;
    # writes the whole (B, T+1, 10, Km) gradient once
    nbytes = (entries * 40 + ids.numel() * 8 + Bk * T * 2 * 5 * P_ * 4
              + spay.numel() * 4)
    b_ms, b_by = bound(nbytes,
                       ALPHA_FLOPS * P_ * entries + GRAD_FLOPS * blended)
    k3b = dict(name="composite_sel_single_bwd", route="cuda",
               source="sim_a_splat_torch/csrc/composite_single_bwd.cu",
               replaces="sim_a_splat_tpu/ops/pallas_composite_sel.py:500",
               max_abs_err=e3b,
               ms=cuda_ms(lambda: composite_single.composite_sel_single_bwd(
                   *a3b), 10),
               plain_ms=cuda_ms(k3b_plain, 1, warmup=0),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"  gradient pairs (α > 0): {blended}; kernel {k3b['ms']:.4f} ms "
        f"(with its recompute of the chunk-start state), plain "
        f"{k3b['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    versus_parent(
        "K3b", lambda: composite_single.composite_sel_single_bwd(*a3b),
        parent, 10,
        parent_fn=lambda: parent_k3.composite_sel_single_bwd(*a3b))
    return [k3, k3b]


def moving_camera(entry, composite, composite_single, rasterize_moving,
                  pusht, graph, scene, P, gen, reset_counts, counts_now,
                  profiled, parent, parent_k3, dev):
    """The moving-camera path: K3f/K3b against their plain versions at full
    size (and beside the parent's kernels with ``parent``), K3's shared
    mode, the B=32 forward rollout (timed, profiled, one frame against the
    full rebin), the B=16 train rollout (timed, broken down, its peak
    memory) and its gradients against the plain path.  Returns the K3f and
    K3b entries of the ``kernels`` line."""
    import numpy as np
    import torch
    from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
    raster = RasterConfig(**MV_RASTER)

    def rollout_of(R):
        return entry.make_step_moving_cached(graph, RES, RES, raster, R=R,
                                             device=dev, **MV_KW)[0]

    rollout, roll1, roll2, roll4 = (rollout_of(r) for r in (R_MV, 1, 2, 4))
    st_fwd = pusht.reset(P, gen, B_MV_FWD)
    st_train = pusht.PushTState(*(f[:B_MV_TRAIN] for f in st_fwd))
    act = torch.tensor([[150.0, 250.0]], device=dev).repeat(B_MV_FWD, 1)
    act_train = act[:B_MV_TRAIN]
    log(f"moving camera: N={N}, sh{SH_DEGREE}, {RES}², kc {MV_KW['kc']}, "
        f"margin {MV_KW['margin']}, buckets {raster.buckets}, R={R_MV}")

    # 12. K3f and K3b at full size, on one frame of a B=16 rollout ------------
    seen = {}
    real_k3 = composite_single.composite_sel_single

    def capture(*args):
        seen["k3"] = args
        return real_k3(*args)

    with torch.no_grad(), replaced(composite_single, "composite_sel_single",
                                   capture):
        roll2(scene, st_train, act_train)                    # also warm-up
    torch.cuda.synchronize()
    a3 = seen.pop("k3")
    k3, k3b = single_rows(a3, parent, parent_k3, dev)
    spay, ids, counts_pad = a3[:3]
    Bk, T = spay.shape[0], spay.shape[1] - 1
    P_ = a3[3] ** 2
    rows = [0, 1, 2, 4]

    # 12b. K3 in the shared-payload mode: env 0's lists shared by all envs --
    sp, cn = spay[0].contiguous(), counts_pad[0].contiguous()
    a3s = (sp, ids, cn, *a3[3:])
    log(f"K3 shared mode (spay {tuple(sp.shape)}, ids {tuple(ids.shape)}):")
    bidx = torch.arange(Bk, device=dev)[:, None]
    named = bidx, ids.long()
    real = ids < T
    out_k = composite_single.composite_sel_single(*a3s)[named][real]
    out_p = composite_single.composite_sel_single_plain(*a3s)[named][real]
    e3s = check("K3 shared", out_k[:, rows], out_p[:, rows], TOL, "rgb+trans")
    dscale = max(1.0, float(sp[:, 8].abs().max()))
    check("K3 shared", out_k[:, 3] / dscale, out_p[:, 3] / dscale, TOL,
          "depth_acc / max depth")
    with torch.enable_grad():
        out_s = composite_single.composite_sel_single(
            sp.detach().requires_grad_(), *a3s[1:]).detach()
    ct3 = torch.zeros_like(out_s)
    ct3[named] = torch.as_tensor(np.random.default_rng(4).normal(
        size=(Bk, ids.shape[1], 8, P_)).astype(np.float32), device=dev)
    ct3[:, T] = 0.0
    a3sb = (sp, ids, cn, ct3, out_s, *a3[3:])
    g_k = composite_single.composite_sel_single_bwd(*a3sb)
    g_p = torch.zeros_like(sp)
    for b0 in range(0, Bk, 4):
        sl = slice(b0, b0 + 4)
        g_p += composite_single.composite_sel_single_bwd_plain(
            sp, ids[sl], cn, ct3[sl], *a3[3:])
    e3sb = check_rows("K3b shared", g_k[:T], g_p[:T], "payload grad (summed "
                      "over envs by atomicAdd)")
    if not bool(torch.isfinite(g_k).all()) or bool(g_k[T].any()):
        raise AssertionError("K3b shared: gradient not finite, or the pad "
                             "row got one")
    f_ms = cuda_ms(lambda: composite_single.composite_sel_single(*a3s), 20)
    b_ms = cuda_ms(lambda: composite_single.composite_sel_single_bwd(*a3sb),
                   10)
    log(f"  K3f shared {f_ms:.4f} ms, K3b shared {b_ms:.4f} ms (max|Δ| "
        f"{e3s:.3e} / {e3sb:.3e})")
    del a3, a3s, a3sb, spay, sp, ids, counts_pad, out_k, out_p, out_s, ct3
    del g_k, g_p

    # 13. the forward rollout, B=32, timed ------------------------------------
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t_host = time.perf_counter()
    start.record()
    flags = []
    with torch.no_grad():
        for _ in range(MV_ITERS):
            _, loss, f = rollout(scene, st_fwd, act)
            flags.append(f)
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t_host) / MV_ITERS
    launches = counts_now()
    ev_ms = start.elapsed_time(end) / MV_ITERS
    flags = torch.stack(flags).cpu()
    log(f"moving camera, forward: {MV_ITERS} × rollout (B={B_MV_FWD}, "
        f"R={R_MV}): {ev_ms:.2f} ms/rollout (events), {wall * 1e3:.2f} "
        f"ms/rollout (host clock), {B_MV_FWD * R_MV / wall:.1f} frames/s; "
        f"loss {float(loss):.6f}, flags [severe, bounded] "
        f"{flags.tolist()}, launches {launches}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches["composite_sel_single"] != R_MV * MV_ITERS:
        raise AssertionError(f"K3f launched {launches['composite_sel_single']}"
                             f" times in {MV_ITERS} rollouts of {R_MV} frames")
    if any(launches[n] for n in launches if n != "composite_sel_single"):
        raise AssertionError(f"the forward rollout launched {launches}")
    if not bool(torch.isfinite(loss)):
        raise AssertionError("the forward rollout's loss is not finite")

    def short_rollout():
        with torch.no_grad():
            roll2(scene, st_fwd, act)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    short_rollout()
    ms2 = (time.perf_counter() - t0) * 1e3
    log(f"  R=2 rollout (host clock, for the profile's idle share): "
        f"{ms2:.2f} ms")
    profiled("R=2 forward rollout", short_rollout, ms2)

    # 14. one frame against the full per-frame rebin (kernel K1) ---------------
    real_render = rasterize_moving.render_moving_batch
    real_sort = rasterize_moving._sort_by_key
    merged_cols = MV_KW["kc"] + MV_KW["dyn_capacity"]

    def keep(*args, **kw):
        seen["mv"] = real_render(*args, **kw)
        return seen["mv"]

    def keep_lists(payload, key):            # the statics and dynamics apart
        if payload.shape[-1] == merged_cols:
            seen["lists"] = (payload, key)
        return real_sort(payload, key)

    with torch.no_grad():
        with replaced(rasterize_moving, "render_moving_batch", keep), \
                replaced(rasterize_moving, "_sort_by_key", keep_lists):
            _, _, flags1 = roll1(scene, st_fwd, act)
        step_rb, _ = entry.make_step_moving(graph, RES, RES, raster,
                                            cam_height=MV_KW["cam_height"],
                                            device=dev)
        _, img_rb, n_trunc = step_rb(scene, st_fwd, act)
    img_c, aux = seen.pop("mv")
    # 14b. K2 in its per-env mode on this frame's lists (no caller runs it)
    per_env_rows = sel_per_env_rows(
        per_env_lists(rasterize_moving, *seen.pop("lists"), MV_KW["kc"],
                      raster.tile_size, RES // raster.tile_size, raster),
        reset_counts, counts_now, dev)
    torch.cuda.empty_cache()
    diff = (img_c.permute(0, 2, 3, 1) - img_rb).abs()
    per_env = diff.flatten(1).amax(1)
    flags1, n_trunc = flags1.tolist(), int(n_trunc.sum())
    log(f"one frame vs the full rebin (make_step_moving, B={B_MV_FWD}): "
        f"max|Δ| {float(per_env.max()):.3e}, median over envs "
        f"{float(per_env.median()):.3e}; cached flags [severe, bounded] "
        f"{flags1} (frame: {int(aux.n_overflowed_tiles)} overflowed tiles, "
        f"{int(aux.n_slot_truncated)} slot-truncated), rebin truncations "
        f"{n_trunc}")
    if not bool(torch.isfinite(img_c).all()) or \
            img_c.shape != (B_MV_FWD, 3, RES, RES):
        raise AssertionError(f"bad moving images {tuple(img_c.shape)}")
    if flags1 == [0, 0] and n_trunc == 0:
        atol, rtol = TOL_REBIN
        if not bool((diff <= atol + rtol * img_rb.abs()).all()):
            raise AssertionError("the cached frame disagrees with the rebin "
                                 "with nothing truncated")
        log(f"  exact case: within atol {atol} / rtol {rtol}")
    else:
        log("  not gated: a flag or a truncation count is nonzero")
    del img_c, img_rb, diff, aux

    # 15. the train rollout, B=16, timed and broken down ----------------------
    entry.rollout_loss_and_grads(roll2, scene, st_train, act_train)  # warm-up
    phases = {"build": 0.0, "control_step": 0.0, "backward": 0.0}

    def timed(key, fn):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*args, **kw)
            torch.cuda.synchronize()
            phases[key] += time.perf_counter() - t
            return r
        return wrapped

    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start.record()
    t_host = time.perf_counter()
    with replaced(rasterize_moving, "build_moving_cache",
                  timed("build", rasterize_moving.build_moving_cache)), \
            replaced(pusht, "control_step",
                     timed("control_step", pusht.control_step)), \
            replaced(torch.autograd, "grad",
                     timed("backward", torch.autograd.grad)):
        _, loss, flags_t, grads = entry.rollout_loss_and_grads(
            rollout, scene, st_train, act_train)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_host
    launches = counts_now()
    k3["launches"] = launches["composite_sel_single"]
    k3b["launches"] = launches["composite_sel_single_bwd"]
    fields = [n for n, f in zip(grads._fields, grads) if f is not None]
    finite = all(bool(torch.isfinite(getattr(grads, n)).all())
                 for n in fields)
    frames_s = wall - phases["build"] - phases["backward"]
    log(f"moving camera, train: rollout_loss_and_grads (B={B_MV_TRAIN}, "
        f"R={R_MV}; K3b recomputes its restart state): "
        f"{start.elapsed_time(end):.2f} ms (events), "
        f"{wall * 1e3:.2f} ms (host clock), "
        f"{B_MV_TRAIN * R_MV / wall:.1f} frames/s; loss {float(loss):.6f}, "
        f"flags {flags_t.tolist()}, grads finite={finite}, launches "
        f"{launches}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  breakdown (host clock, each phase synchronised): cache build "
        f"{phases['build'] * 1e3:.2f} ms, {R_MV} frames "
        f"{frames_s * 1e3:.2f} ms (control_step "
        f"{phases['control_step'] * 1e3:.2f} ms of it), backward "
        f"{phases['backward'] * 1e3:.2f} ms")
    if not finite:
        raise AssertionError("a gradient of the train rollout is not finite")
    for name in ("composite_sel_single", "composite_sel_single_bwd"):
        if launches[name] != R_MV:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"a train rollout of {R_MV} frames")
    del grads

    # gradients against the port's plain path, B=2, R=4 -----------------------
    st2 = pusht.PushTState(*(f[:2] for f in st_train))
    _, loss_k, flags_k, g_k = entry.rollout_loss_and_grads(
        roll4, scene, st2, act[:2])
    with replaced(composite_single, "composite_sel_single",
                  composite_single.composite_sel_single_plain):
        _, loss_p, flags_p, g_p = entry.rollout_loss_and_grads(
            roll4, scene, st2, act[:2])
    if flags_k.tolist() != flags_p.tolist():
        raise AssertionError(f"flags {flags_k.tolist()} (kernels) vs "
                             f"{flags_p.tolist()} (plain)")
    log(f"train rollout vs the plain path (B=2, R=4): loss {float(loss_k)} "
        f"vs {float(loss_p)}, flags {flags_k.tolist()}")
    check_fields("train-rollout", g_k, g_p, fields)
    return [k3, k3b] + per_env_rows


def uncached_step(entry, composite, pusht, graph, scene, P, raster,
                  reset_counts, counts_now, profiled, dev):
    """The uncached step (``entry.make_step``, B=128): batched K1f/K1b
    against their plain versions on the step's own inputs and, env by env,
    against K1 run on that env alone (bit for bit); the forward step and
    the train step timed, profiled and checked (launches, images and
    gradients against the plain path on a few envs).  Returns the batched
    K1f and K1b entries of the ``kernels`` line."""
    import numpy as np
    import torch
    step, _ = entry.make_step(graph, RES, RES, raster, device=dev)
    states0 = pusht.reset(P, torch.Generator(device=dev).manual_seed(1), B)
    actions = torch.tensor([[150.0, 250.0]], device=dev).repeat(B, 1)
    log(f"uncached step (make_step): B={B}, N={N}, sh{SH_DEGREE} scene "
        f"(DC colours, as the reference's _make_step), {RES}², "
        f"tile_capacity {raster.tile_capacity}, term_eps {raster.term_eps}")

    # 16. batched K1f and K1b on the step's own inputs ------------------------
    seen = {}
    real_k1 = composite.composite_static

    def capture(*args):
        seen["k1"] = args
        return real_k1(*args)

    with torch.no_grad(), replaced(composite, "composite_static", capture):
        _, imgs0 = step(scene, states0, actions)              # also warm-up
    torch.cuda.synchronize()
    a1 = seen.pop("k1")
    pay, counts, skip = a1[:3]
    Bk, T, _, K = pay.shape
    P_, nc = a1[3] ** 2, K // composite.CHUNK
    tail = a1[3:]
    log(f"K1 composite_static with an env axis vs composite_static_plain "
        f"(payload {tuple(pay.shape)}; the plain version {UC_PLAIN_ENVS} "
        f"envs at a time):")
    out_k, car_k, acc_k = composite.composite_static_fwd(*a1)
    rows = [0, 1, 2, 4]
    applied = torch.empty((Bk, T), dtype=torch.long, device=dev)
    hits = torch.empty_like(applied)
    e1 = 0.0
    dscale = max(1.0, float(pay[:, :, 8].abs().max()))
    for b0 in range(0, Bk, UC_PLAIN_ENVS):
        sl = slice(b0, b0 + UC_PLAIN_ENVS)
        out_p, car_p, applied[sl], hits[sl] = composite.composite_static_plain(
            pay[sl], counts[sl], skip[sl], *tail, return_work=True)
        for got, want, what in (
                (out_k[sl][..., rows], out_p[..., rows], "rgb+trans"),
                (car_k[sl], car_p, "carries"),
                (out_k[sl][..., 3] / dscale, out_p[..., 3] / dscale,
                 "depth_acc / max depth")):
            err = float((got - want).abs().max())
            if not err <= TOL:
                raise AssertionError(f"batched K1 {what} disagrees with its "
                                     f"plain version (envs {b0}+): {err}")
            e1 = max(e1, err)
        del out_p, car_p
    log(f"  batched K1 rgb+trans, carries, depth_acc / max depth: max|Δ| = "
        f"{e1:.3e} (tolerance {TOL:.1e})")
    for b in range(Bk):                      # env b alone: the same bits
        o, c, a = composite.composite_static_fwd(pay[b], counts[b], skip[b],
                                                 *tail)
        if not (torch.equal(o, out_k[b]) and torch.equal(c, car_k[b])
                and torch.equal(a, acc_k[b])):
            raise AssertionError(f"batched K1f: env {b}'s rows differ from "
                                 "K1f run on env b alone")
    log(f"  each of the {Bk} envs' out, carries and chunk_acc equal K1f run "
        "on that env alone, bit for bit")
    cnt = torch.where(skip > 0, counts, 0).long()
    c0 = torch.arange(nc, device=dev) * composite.CHUNK
    per_chunk = torch.clamp(cnt[..., None] - c0, 0, composite.CHUNK)
    used = torch.arange(nc, device=dev) < applied[..., None]
    entries = int((per_chunk * used).sum())
    blended = int(hits.sum())
    tiles_ = Bk * T
    b_ms, b_by = bound(entries * 40 + tiles_ * 8 + tiles_ * P_ * (8 + nc) * 4,
                       ALPHA_FLOPS * P_ * entries + BLEND_FLOPS * blended)

    def plain_all():
        for b0 in range(0, Bk, UC_PLAIN_ENVS):
            sl = slice(b0, b0 + UC_PLAIN_ENVS)
            composite.composite_static_plain(pay[sl], counts[sl], skip[sl],
                                             *tail)

    k1 = dict(name="composite_static_envs", route="cuda",
              source="sim_a_splat_torch/csrc/composite.cu",
              replaces="sim_a_splat_tpu/ops/pallas_composite.py:238",
              max_abs_err=e1,
              ms=cuda_ms(lambda: composite.composite_static(*a1), 10),
              plain_ms=cuda_ms(plain_all, 1, warmup=0),
              bound_ms=b_ms, bound_by=b_by, library_ms=None)
    # (a launch lasts milliseconds here, far past its Python dispatch, so
    # CUDA events time the kernels themselves)
    log(f"  applied entries {entries} of {int(cnt.clamp(max=K).sum())} "
        f"active over {tiles_} tiles; (pixel, entry) pairs: {P_ * entries} "
        f"alpha, {blended} blended (α > 0); kernel {k1['ms']:.4f} ms, "
        f"plain {k1['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    # the profiler's reading of 3 such calls, launch by launch (the chunk
    # blocks and the combine), beside the events' time above
    _, avg = device_profile(lambda: [composite.composite_static(*a1)
                                     for _ in range(3)])
    rows_k = [e for e in avg if str(e.device_type).endswith("CUDA")
              and "composite_static" in e.key]
    for e in rows_k:
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        log(f"  profiler, 3 calls: {e.key[:60]} × {e.count}, "
            f"{dev_us / 1e3 / max(e.count, 1):.4f} ms a launch")
    if not rows_k:
        log("  profiler, 3 calls: no K1f kernel recorded")

    log("K1b composite_static_bwd with an env axis vs "
        f"composite_static_bwd_plain ({UC_PLAIN_ENVS} envs at a time):")
    ct1 = torch.as_tensor(np.random.default_rng(5).normal(
        size=tuple(out_k.shape)).astype(np.float32), device=dev)
    a1b = (pay, counts, skip, ct1, out_k, car_k, *tail)
    g_k = composite.composite_static_bwd(*a1b, chunk_acc=acc_k)

    def bwd_plain():
        g = torch.empty_like(pay)
        for b0 in range(0, Bk, UC_PLAIN_ENVS):
            sl = slice(b0, b0 + UC_PLAIN_ENVS)
            g[sl] = composite.composite_static_bwd_plain(
                pay[sl], counts[sl], skip[sl], ct1[sl], *tail)
        return g

    g_p = bwd_plain()
    e1b = check_rows("batched K1b", g_k, g_p, "payload grad")
    if not bool(torch.isfinite(g_k).all()):
        raise AssertionError("batched K1b: gradient not finite")
    del g_p
    for b in range(Bk):
        g = composite.composite_static_bwd(pay[b], counts[b], skip[b], ct1[b],
                                           out_k[b], car_k[b], *tail,
                                           chunk_acc=acc_k[b])
        if not torch.equal(g, g_k[b]):
            raise AssertionError(f"batched K1b: env {b}'s gradient differs "
                                 "from K1b run on env b alone")
    log(f"  each of the {Bk} envs' gradient equals K1b run on that env "
        "alone, bit for bit")
    b_ms, b_by = bound(entries * 40 + tiles_ * 8
                       + tiles_ * P_ * (2 * 5 + nc) * 4 + pay.numel() * 4,
                       ALPHA_FLOPS * P_ * entries + GRAD_FLOPS * blended)
    k1b = dict(name="composite_static_bwd_envs", route="cuda",
               source="sim_a_splat_torch/csrc/composite_bwd.cu",
               replaces="sim_a_splat_tpu/ops/pallas_composite.py:277",
               max_abs_err=e1b,
               ms=cuda_ms(lambda: composite.composite_static_bwd(
                   *a1b, chunk_acc=acc_k), 5),
               plain_ms=cuda_ms(bwd_plain, 1, warmup=0),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"  gradient pairs (α > 0): {blended}; kernel {k1b['ms']:.4f} ms, "
        f"plain {k1b['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    del a1, a1b, pay, counts, skip, out_k, car_k, acc_k, ct1, g_k, g, o, c, a
    torch.cuda.empty_cache()

    # 17. the uncached step forward and in training, timed ---------------------
    others = ("composite_pair_sel", "composite_pair_sel_bwd",
              "composite_sel_single", "composite_sel_single_bwd",
              "composite_pair", "composite_pair_bwd")
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t_host = time.perf_counter()
    start.record()
    states = states0
    with torch.no_grad():
        for _ in range(UC_ITERS):
            states, imgs = step(scene, states, actions)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_host
    launches = counts_now()
    step_ms = start.elapsed_time(end) / UC_ITERS
    log(f"uncached step, forward: {UC_ITERS} × step, B={B}: {step_ms:.2f} "
        f"ms/step (events), {wall / UC_ITERS * 1e3:.2f} ms/step (host "
        f"clock), {B * 1e3 / step_ms:.1f} frames/s; launches {launches}, "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches["composite_static"] != UC_ITERS or \
            launches["composite_static_bwd"] or \
            any(launches[n] for n in others):
        raise AssertionError(f"the uncached forward step launched {launches}")
    if imgs.shape != (B, 3, RES, RES) or not bool(torch.isfinite(imgs).all()):
        raise AssertionError(f"bad images {tuple(imgs.shape)}")
    s_next = pusht.control_step(P, states0, actions)
    with torch.no_grad(), replaced(pusht, "control_step", lambda *_: s_next):
        rend_ms = cuda_ms(lambda: step(scene, states0, actions), 3)
        rend_dev_ms = device_profile(lambda: step(scene, states0, actions))[0]
    log(f"  breakdown (events): step without control_step {rend_ms:.2f} ms "
        f"(its device time {rend_dev_ms:.2f} ms)")
    with torch.no_grad():
        profiled("uncached step", lambda: step(scene, states0, actions),
                 step_ms)

    # the image against the port's plain path on the first envs
    sub = pusht.PushTState(*(f[:UC_PLAIN_ENVS] for f in states0))
    with torch.no_grad():
        _, imgs_k = step(scene, sub, actions[:UC_PLAIN_ENVS])
        with replaced(composite, "composite_static",
                      composite.composite_static_plain):
            _, imgs_p = step(scene, sub, actions[:UC_PLAIN_ENVS])
    e_img = check("uncached step", imgs_k, imgs_p, TOL,
                  f"image vs the plain path (first {UC_PLAIN_ENVS} envs)")
    del imgs, imgs0, imgs_k, imgs_p

    fields = [n for n, f in zip(scene._fields, scene) if f is not None]
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_host = time.perf_counter()
    start.record()
    states = states0
    for _ in range(UC_ITERS):
        states, loss, _, grads = entry.loss_and_grads(None, step, scene,
                                                      states, actions)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_host
    launches = counts_now()
    train_ms = start.elapsed_time(end) / UC_ITERS
    finite = all(bool(torch.isfinite(getattr(grads, n)).all())
                 for n in fields)
    log(f"uncached step, train: {UC_ITERS} × loss_and_grads(None, step, ...) "
        f"(mean(imgs²) and its gradient to {', '.join(fields)}): "
        f"{train_ms:.2f} ms/step (events), {wall / UC_ITERS * 1e3:.2f} "
        f"ms/step (host clock), {B * 1e3 / train_ms:.1f} frames/s; grads "
        f"finite={finite}, loss {float(loss):.6f}, launches {launches}, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not finite:
        raise AssertionError("a gradient of the uncached train step is not "
                             "finite")
    for name in ("composite_static", "composite_static_bwd"):
        if launches[name] != UC_ITERS:
            raise AssertionError(f"kernel {name} launched {launches[name]} "
                                 f"times in {UC_ITERS} uncached train steps")
    if any(launches[n] for n in others):
        raise AssertionError(f"the uncached train step launched {launches}")
    k1["launches"] = launches["composite_static"]
    k1b["launches"] = launches["composite_static_bwd"]
    del grads
    leaves = type(scene)(*(None if f is None else f.detach().requires_grad_()
                           for f in scene))
    leaf_list = [f for f in leaves if f is not None]

    def forward():
        return torch.mean(step(leaves, states0, actions)[1] ** 2)

    fwd_ms = cuda_ms(forward, 2)
    loss0 = forward()
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        loss0, leaf_list, retain_graph=True, allow_unused=True), 2)
    bwd_dev_ms, avg = device_profile(lambda: torch.autograd.grad(
        loss0, leaf_list, retain_graph=True, allow_unused=True))
    del loss0
    log(f"  breakdown (events, each phase alone): forward with the graph "
        f"kept {fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms (its device time "
        f"{bwd_dev_ms:.2f} ms); sum {fwd_ms + bwd_ms:.2f} ms vs "
        f"{train_ms:.2f} ms/step")
    for line in avg.table(sort_by="self_cuda_time_total",
                          row_limit=6).splitlines()[:9]:
        log("    " + line)
    profiled("uncached train step", lambda: entry.loss_and_grads(
        None, step, scene, states0, actions), train_ms)

    # 18. the train step's gradients against the port's plain path -----------
    sub = pusht.PushTState(*(f[:UC_GRAD_ENVS] for f in states0))
    _, loss_k, _, g_k = entry.loss_and_grads(None, step, scene, sub,
                                             actions[:UC_GRAD_ENVS])
    with replaced(composite, "composite_static",
                  composite.composite_static_plain):
        _, loss_p, _, g_p = entry.loss_and_grads(None, step, scene, sub,
                                                 actions[:UC_GRAD_ENVS])
    log(f"uncached train step vs the plain path (first {UC_GRAD_ENVS} envs): "
        f"loss {float(loss_k)} vs {float(loss_p)}")
    read = [n for n in fields if n != "sh_rest"]   # DC colours: no sh_rest
    e_grad = check_fields("uncached train-step", g_k, g_p, read)
    if g_k.sh_rest is not None and bool(g_k.sh_rest.any()):
        raise AssertionError("the uncached step reads no sh_rest, yet its "
                             "gradient is nonzero")
    log(f"uncached step: image max|Δ| vs plain {e_img:.3e}; train-step "
        f"gradients max|Δ| / max|g| {e_grad:.3e}")
    return [k1, k1b]


def near_lens(wrapper, states_list):
    """(N,) bool: the gaussians of ``wrapper``'s scene, as posed at any of
    ``states_list``, that lie within NEAR_LENS_M of a camera's lens (its
    depth in (−0.05, NEAR_LENS_M) m) for any env."""
    import torch
    from sim_a_splat_torch.ops.projection import project_raw
    base = wrapper._base_env()
    near = None
    with torch.no_grad():
        for states in states_list:
            draws = base.draw_state(states)
            posed = wrapper.graph.posed(wrapper._body_poses(draws))
            for _, spec in wrapper.cameras:
                pose = (wrapper._moving_pose(spec, draws)
                        if spec.type == "moving"
                        else spec.pose(wrapper.device))
                d = project_raw(posed.means, posed.quats, posed.log_scales,
                                wrapper._camera(pose, spec)).depth
                hit = ((d > -0.05) & (d < NEAR_LENS_M)).any(0)
                near = hit if near is None else near | hit
    return near


def arm_product(entry, composite, composite_sel, composite_single,
                reset_counts, counts_now, profiled, dev):
    """The arm product path (``benchmarks/bench_product.py``): B=8 envs of
    ``pusharm6`` in an N=100k sh3 splat scene, a fixed viewport and an
    end-effector camera at 240×320, R=ARM_R frames after a 40-step settle.
    K1f/K1b, K2f/K2b and K3f/K3b against their plain versions at the
    path's captured inputs (a 15 × 20 tile grid, the near set on); the
    forward rollout and the train rollout timed (launches, counters, peak
    memory, a profile); the B=1 teleop step with its moving-cache rebuild
    timed apart; images and gradients against the port's plain path; the
    moving camera against its full rebin where no frame is severe; then P2
    (``arm_step``, one launch a step: ``ARM_R`` in the forward rollout)
    at B = 1 and B = 8 from the cells' settled states; R1
    (``reproject_candidates``, one launch a frame of the forward rollout,
    none in the train rollout, whose gradient takes the plain
    reprojection) on a teleop step's end-effector camera at B = 8 and
    B = 1 (:func:`reproject_row`).  Returns the six kernels' rows (names
    ending ``_arm``), P2's and R1's."""
    import torch
    from sim_a_splat_torch.envs import manipulator_envs
    from sim_a_splat_torch.envs.manipulator_envs import (
        ManipulatorEnvF, ManipulatorState,
    )
    from sim_a_splat_torch.ops import rasterize_moving

    t0 = time.perf_counter()
    h, w = ARM_RES
    wrapper = entry.build_product_wrapper(n_total=N, sh_degree=SH_DEGREE,
                                          seed=0, render_size=ARM_RES,
                                          device=dev)
    scene = wrapper.graph.scene
    n_dyn = int((wrapper.graph.link_ids > 0).sum())
    rollout, step, build_moving = entry.make_product_rollout(wrapper)
    log(f"arm product path: pusharm6, N={N} ({N - n_dyn} static, {n_dyn} "
        f"on {wrapper.graph.num_bodies - 1} bodies), sh{SH_DEGREE}, 2 cameras "
        f"at {h}×{w}, B={ARM_B}, R={ARM_R}, {entry.PRODUCT_RENDER}, raster "
        f"{wrapper.raster}; built in {time.perf_counter() - t0:.2f} s")

    states, actions_seq = entry.product_inputs(wrapper, ARM_B, ARM_R,
                                               settle=ARM_SETTLE)

    # 19. the kernels' inputs on a 2-frame train rollout (also the warm-up) --
    seen = {}

    def capture(key, fn):
        def wrapped(*args):
            seen.setdefault(key, tuple(a.detach() if torch.is_tensor(a) else a
                                       for a in args))
            return fn(*args)
        return wrapped

    with replaced(composite, "composite_static",
                  capture("k1", composite.composite_static)), \
            replaced(composite_sel, "composite_pair_sel",
                     capture("k2", composite_sel.composite_pair_sel)), \
            replaced(composite_single, "composite_sel_single",
                     capture("k3", composite_single.composite_sel_single)):
        entry.product_loss_and_grads(rollout, scene, states, actions_seq[:2])
    torch.cuda.synchronize()
    tx, ty = -(-w // 16), -(-h // 16)
    shapes = (tuple(seen["k1"][0].shape), seen["k1"][4],
              tuple(seen["k2"][0].shape), tuple(seen["k2"][1].shape),
              tuple(seen["k3"][0].shape), seen["k3"][4])
    if shapes != ((tx * ty, 10, 1024), tx, (tx * ty + 1, 10, 1024),
                  (ARM_B, min(256, tx * ty), 10, 256),
                  (ARM_B, tx * ty + 1, 10, 512 + 256), tx):
        raise AssertionError(f"the path's kernel inputs {shapes}: not the "
                             f"{ty} × {tx} grid of the product path")
    with torch.no_grad():
        mc = build_moving(states)[1]
    n_near = (mc.near_op > 0).sum(1).tolist()
    log(f"  tile grid {ty} × {tx} (T = {tx * ty}); K1 payload {shapes[0]}, "
        f"K2 static {shapes[2]} and dynamic {shapes[3]}, K3 {shapes[4]}; "
        f"near set per env {n_near} (cap {entry.PRODUCT_RENDER['near_cap']}, "
        f"overflow {mc.n_near_over.tolist()}), build-time truncations "
        f"{mc.n_build_truncated.tolist()}")
    if not min(n_near) > 0:
        raise AssertionError("the end-effector camera's near set is empty")

    # 20. K1, K2 and K3 at the path's inputs against their plain versions ----
    rows = (static_rows(seen["k1"], dev)
            + sel_rows(seen["k2"], None, dev, plain_envs=1)
            + single_rows(seen["k3"], None, None, dev))
    for r in rows:
        r["name"] += "_arm"
    del seen, mc

    # 20b. kernel R1 on a teleop step's end-effector camera, B = 8 and 1 ----
    r1_args = {}

    def capture_r1(cache, cams, degree, cfg, **kw):
        r1_args.setdefault("args", (cache, cams, degree, cfg))
        return real_r1(cache, cams, degree, cfg, **kw)

    with torch.no_grad(), replaced(rasterize_moving, "reproject_candidates",
                                   capture_r1) as real_r1:
        step(states, actions_seq[0], wrapper.build_render_cache(),
             build_moving(states))
    r1_row = reproject_row(rasterize_moving, r1_args.pop("args"))

    # 21. the forward rollout, timed and profiled -----------------------------
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t_host = time.perf_counter()
    start.record()
    with torch.no_grad():
        trs, loss = rollout(scene, states, actions_seq)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_host
    launches = counts_now()
    over = trs.info["render_overflow"][:, 0].tolist()
    trunc = trs.info["render_truncated"][:, 0].tolist()
    log(f"arm product, forward: rollout (B={ARM_B}, R={ARM_R}): "
        f"{start.elapsed_time(end):.2f} ms (events), {wall * 1e3:.2f} ms "
        f"(host clock), {ARM_B * ARM_R / wall:.1f} env-frames/s (2 cameras "
        f"each); loss {float(loss):.6f}, launches {launches}, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"render_overflow per frame {over}, render_truncated per frame "
        f"{trunc}")
    want = dict(composite_static=1, composite_pair_sel=ARM_R,
                composite_sel_single=ARM_R)
    if any(launches[n] != want.get(n, 0) for n in launches):
        raise AssertionError(f"the forward rollout launched {launches}, "
                             f"not {want}")
    p2_launches = counts_now(("arm_step",))["arm_step"]
    if p2_launches != ARM_R:
        raise AssertionError(f"arm_step launched {p2_launches} times in "
                             f"{ARM_R} steps of the forward rollout")
    r1_row["launches"] = counts_now(("reproject_candidates",))[
        "reproject_candidates"]
    if r1_row["launches"] != ARM_R:
        raise AssertionError(f"reproject_candidates launched "
                             f"{r1_row['launches']} times in {ARM_R} frames "
                             "of the forward rollout")
    for i, k in enumerate(("camera_0", "camera_1")):
        img = trs.obs[k]
        if img.shape != (ARM_R, ARM_B, 3, h, w) or \
                not bool(torch.isfinite(img).all()):
            raise AssertionError(f"bad {k} {tuple(img.shape)}")
    if not bool(torch.isfinite(loss)):
        raise AssertionError("the forward rollout's loss is not finite")
    del trs
    # the same R env steps alone: the arm physics' share of the rollout
    env = wrapper._base_env()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = states
    with torch.no_grad():
        for a in actions_seq:
            s = env.step(s, a).state
    torch.cuda.synchronize()
    phys = time.perf_counter() - t0
    log(f"  the arm physics alone (the same {ARM_R} env steps): "
        f"{phys * 1e3:.2f} ms, {phys / wall:.3f} of the rollout")

    def short_rollout():
        with torch.no_grad():
            rollout(scene, states, actions_seq[:4])
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    short_rollout()
    ms4 = (time.perf_counter() - t0) * 1e3
    log(f"  R=4 rollout (host clock, for the profile's idle share): "
        f"{ms4:.2f} ms")
    profiled("R=4 arm forward rollout", short_rollout, ms4)

    # 22. the train rollout, timed and broken down ----------------------------
    phases = {"physics": 0.0, "build": 0.0, "backward": 0.0}

    def timed(key, fn):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*args, **kw)
            torch.cuda.synchronize()
            phases[key] += time.perf_counter() - t
            return r
        return wrapped

    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start.record()
    t_host = time.perf_counter()
    with replaced(ManipulatorEnvF, "step",
                  timed("physics", ManipulatorEnvF.step)), \
            replaced(rasterize_moving, "build_moving_cache",
                     timed("build", rasterize_moving.build_moving_cache)), \
            replaced(torch.autograd, "grad",
                     timed("backward", torch.autograd.grad)):
        trs, loss, grads = entry.product_loss_and_grads(rollout, scene, states,
                                                        actions_seq)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_host
    launches = counts_now()
    for r in rows:
        r["launches"] = launches[r["name"].removesuffix("_arm")]
    fields = [n for n, f in zip(grads._fields, grads) if f is not None]
    finite = all(bool(torch.isfinite(getattr(grads, n)).all())
                 for n in fields)
    log(f"arm product, train: product_loss_and_grads (B={ARM_B}, "
        f"R={ARM_R}; each frame's render recomputed in the backward): "
        f"{start.elapsed_time(end):.2f} ms (events), {wall * 1e3:.2f} ms "
        f"(host clock), {ARM_B * ARM_R / wall:.1f} env-frames/s; loss "
        f"{float(loss):.6f}, grads finite={finite}, launches {launches}, "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        "render_overflow per frame "
        f"{trs.info['render_overflow'][:, 0].tolist()}")
    log(f"  breakdown (host clock, each phase synchronised): arm physics "
        f"{phases['physics'] * 1e3:.2f} ms ({phases['physics'] / wall:.3f}), "
        f"moving-cache build {phases['build'] * 1e3:.2f} ms, backward "
        f"{phases['backward'] * 1e3:.2f} ms, the rest (renders, K1 build) "
        f"{(wall - sum(phases.values())) * 1e3:.2f} ms")
    want = dict(composite_static=1, composite_static_bwd=1,
                composite_pair_sel=2 * ARM_R, composite_pair_sel_bwd=ARM_R,
                composite_sel_single=2 * ARM_R,
                composite_sel_single_bwd=ARM_R)
    if any(launches[n] != want.get(n, 0) for n in launches):
        raise AssertionError(f"the train rollout launched {launches}, not "
                             f"{want}")
    r1_train = counts_now(("reproject_candidates",))["reproject_candidates"]
    if r1_train:
        raise AssertionError(f"reproject_candidates launched {r1_train} "
                             "times in the train rollout (its gradient takes "
                             "the plain reprojection)")
    if not finite:
        raise AssertionError("a gradient of the train rollout is not finite")
    del trs, grads

    # 23. the B=1 teleop step, caches prebuilt --------------------------------
    st1, act1 = entry.product_inputs(wrapper, 1, 1, settle=ARM_SETTLE)
    act1 = act1[0]
    with torch.no_grad():
        caches = wrapper.build_render_cache()
        mc1 = build_moving(st1)
        rebuild_ms = cuda_ms(lambda: build_moving(st1), 3)
        step(st1, act1, caches, mc1)                          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = st1
        for _ in range(ARM_TELEOP_ITERS):
            tr = step(s, act1, caches, mc1)
            s = tr.state
        torch.cuda.synchronize()
    teleop_ms = (time.perf_counter() - t0) * 1e3 / ARM_TELEOP_ITERS
    log(f"arm product, teleop: B=1 step_with_cache_batch, forward, 2 × "
        f"{h}×{w}: {teleop_ms:.2f} ms/step (host clock, {ARM_TELEOP_ITERS} "
        f"steps), severe {int(tr.info['render_overflow'][0])}; moving-cache "
        f"rebuild {rebuild_ms:.2f} ms (events), timed apart")
    del caches, mc1, tr

    # 24. against the port's plain path, B=2, R=2 -----------------------------
    st2 = ManipulatorState(*(type(f)(*(g[:ARM_PLAIN_B] for g in f))
                             if isinstance(f, tuple) else f[:ARM_PLAIN_B]
                             for f in states))
    acts2 = actions_seq[:ARM_PLAIN_R, :ARM_PLAIN_B]
    plain = (replaced(composite, "composite_static",
                      composite.composite_static_plain),
             replaced(composite_sel, "composite_pair_sel",
                      composite_sel.composite_pair_sel_plain),
             replaced(composite_single, "composite_sel_single",
                      composite_single.composite_sel_single_plain))
    trs_k, loss_k, g_k = entry.product_loss_and_grads(rollout, scene, st2,
                                                      acts2)
    with plain[0], plain[1], plain[2]:
        trs_p, loss_p, g_p = entry.product_loss_and_grads(rollout, scene,
                                                          st2, acts2)
    for k in ("render_overflow", "render_truncated"):
        if not torch.equal(trs_k.info[k], trs_p.info[k]):
            raise AssertionError(f"{k} {trs_k.info[k].tolist()} (kernels) vs "
                                 f"{trs_p.info[k].tolist()} (plain)")
    for k in ("camera_0", "camera_1"):
        check("arm product", trs_k.obs[k], trs_p.obs[k], TOL,
              f"{k} vs the plain path (B={ARM_PLAIN_B}, R={ARM_PLAIN_R})")
    log(f"  loss {float(loss_k)} (kernels) vs {float(loss_p)} (plain)")
    near = near_lens(wrapper, (st2, trs_k.state))
    log(f"  gradients: {int(near.sum())} gaussians lie within "
        f"{NEAR_LENS_M} m of a lens (held to {TOL_GRAD_NEAR} × each field's "
        f"largest), the other {int((~near).sum())} to {TOL_GRAD} × their "
        "own largest")
    for n in fields:
        got, want = getattr(g_k, n), getattr(g_p, n)
        err = (got - want).abs().reshape(len(near), -1).amax(1)
        mag = want.abs().reshape(len(near), -1).amax(1)
        far_rel = float(err[~near].max() / mag[~near].max())
        near_rel = float(err[near].max() / mag.max()) if near.any() else 0.0
        log(f"  grad {n}: far max|Δ| / max|g| {far_rel:.3e}, near-lens "
            f"max|Δ| / max|g| of the field {near_rel:.3e}")
        if not (bool(torch.isfinite(got).all()) and far_rel <= TOL_GRAD
                and near_rel <= TOL_GRAD_NEAR):
            raise AssertionError(f"arm product gradient of {n} disagrees "
                                 "with the plain path")
    del trs_k, trs_p, g_k, g_p

    # the moving camera over its candidate cache against its full rebin, one
    # frame, where no env-frame is severe
    kw = {k: entry.PRODUCT_RENDER[k] for k in ("sel_tiles", "dyn_capacity",
                                               "dyn_max_tiles")}
    with torch.no_grad():
        s1 = wrapper._base_env().step(st2, acts2[0]).state
        caches = wrapper.build_render_cache()
        imgs_c, aux_c = wrapper.render_with_cache_batch(
            s1, caches, moving_caches=build_moving(st2), **kw)
        imgs_r, _ = wrapper.render_with_cache_batch(s1, caches, **kw)
    diff = (imgs_c[0] - imgs_r[0]).abs()
    severe = int(aux_c["dropped_tiles"])
    log(f"  end-effector camera vs its full rebin (one frame, "
        f"B={ARM_PLAIN_B}): max|Δ| {float(diff.max()):.3e}, severe "
        f"{severe}, bounded {int(aux_c['truncated'])}")
    if severe == 0 and int(aux_c["truncated"]) == 0:
        atol, rtol = TOL_REBIN
        if not bool((diff <= atol + rtol * imgs_r[0].abs()).all()):
            raise AssertionError("the cached end-effector frame disagrees "
                                 "with the rebin with nothing truncated")
        log(f"  exact case: within atol {atol} / rtol {rtol}")
    else:
        log("  not gated: a severe or bounded count is nonzero")

    # 25. P2, the arm's control step, at the cells' B = 1 and B = 8 --------
    p2_inputs = {b: entry.product_inputs(wrapper, b, ARM_STEP_STEPS,
                                         settle=ARM_SETTLE)
                 for b in (1, ARM_B)}
    rows.append(arm_step_row(wrapper._base_env(), p2_inputs, p2_launches))
    rows.append(r1_row)
    return rows



def pusht_env_layer(dev):
    """``PushTEnvF.step`` at B=ENV_B in each observation mode (96² frames),
    timed beside ``control_step``, ``reward_done`` and ``observe`` alone
    (host clock, synchronised: the eager physics is host-bound); its
    reward, done and observation held to the port's CPU run on the same
    states."""
    import torch
    from sim_a_splat_torch.envs.pusht_envs import PushTEnvF
    from sim_a_splat_torch.physics import pusht
    P = pusht.PushTParams()

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(ENV_ITERS):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / ENV_ITERS, out

    gen = torch.Generator(device=dev).manual_seed(3)
    states, _ = PushTEnvF(device=str(dev)).reset(gen, batch=ENV_B)
    actions = states.block_pos.clone()        # each agent heads for its block
    phys_ms, s1 = timed(lambda: pusht.control_step(P, states, actions))
    rew_ms, _ = timed(lambda: pusht.reward_done(P, s1))
    log(f"env layer, pushT: B={ENV_B}, control_step alone {phys_ms:.2f} ms, "
        f"reward_done alone {rew_ms:.2f} ms (host clock, {ENV_ITERS} calls "
        "each)")
    for mode in ("state", "keypoints", "image"):
        env = PushTEnvF(obs_mode=mode, render_size=ENV_RS, device=str(dev))
        cpu = PushTEnvF(obs_mode=mode, render_size=ENV_RS, device="cpu")
        step_ms, tr = timed(lambda: env.step(states, actions))
        obs_ms, _ = timed(lambda: env.observe(tr.state, action=actions))
        log(f"  {mode}: PushTEnvF.step {step_ms:.2f} ms (reward_done "
            f"{rew_ms / step_ms:.3f} of it, observe {obs_ms:.2f} ms, "
            f"{obs_ms / step_ms:.3f})")
        cs = pusht.PushTState(*(f.cpu() for f in tr.state))
        r_c, d_c = pusht.reward_done(P, cs)
        check("env layer", tr.reward.cpu(), r_c, 1e-5,
              f"{mode} reward vs the CPU on the same states")
        if not torch.equal(tr.done.cpu(), d_c):
            raise AssertionError(f"{mode}: done differs from the CPU's")
        obs_c = cpu.observe(cs, action=actions.cpu())
        if mode == "image":
            img = tr.obs["image"].cpu()
            flips = ((img - obs_c["image"]).abs().amax(1) > 1e-6).sum((1, 2))
            covered = float((img.amin(1) < 0.99).float().mean())
            log(f"  image vs the CPU: at most {int(flips.max())} pixels of a "
                f"frame differ (allowed {ENV_EDGE_PIXELS}, pixel centres on "
                f"a shape's edge); {covered:.3f} of the pixels not white")
            if int(flips.max()) > ENV_EDGE_PIXELS or covered < 0.05:
                raise AssertionError("pushT frames disagree with the CPU's")
            check("env layer", tr.obs["agent_pos"].cpu(), obs_c["agent_pos"],
                  1e-4, "image agent_pos vs the CPU")
        else:
            check("env layer", tr.obs.cpu(), obs_c, 1e-4,
                  f"{mode} observation vs the CPU")
    log(f"  rewards: mean {float(tr.reward.mean()):.4f}, "
        f"{int(tr.done.sum())} of {ENV_B} done")


def env_layer(composite, reset_counts, counts_now, dev):
    """The env layer: :func:`pusht_env_layer`, then ``SplatEnvWrapper``'s
    gym-free core (``envs/splat_assets.py``) on a demo asset tree of
    100,000 gaussians (``build_demo_assets``, written to a temporary
    directory) with two cameras at 240×320: ASSET_STEPS task-space steps at
    B=1, each rendering both cameras (K1f over the full tile grid), the
    step and the render timed apart; the images against K1's plain version;
    the free-camera render; and one joint-space step rendered from
    ``examples/assets``.  Returns
    K1f's row on this path (``composite_static_assets``)."""
    import tempfile
    from pathlib import Path
    import numpy as np
    import torch
    from sim_a_splat_torch.envs.eef_wrapper import ManipulatorEEFWrapperF
    from sim_a_splat_torch.envs.manipulator_envs import ManipulatorEnvF
    from sim_a_splat_torch.envs.splat_assets import SplatAssets, render_cameras
    from sim_a_splat_torch.examples.common import camera_setup, look_at
    from sim_a_splat_torch.ops import quaternion as quat
    from sim_a_splat_torch.ops.projection import Camera
    from sim_a_splat_torch.ops.transforms import SE3
    from sim_a_splat_torch.physics import kinematics as kin
    from sim_a_splat_torch.tools.demo_assets import build_demo_assets

    pusht_env_layer(dev)

    root = Path(__file__).resolve().parent
    desc = root / "robot_description"
    urdf = desc / "pusharm6" / "urdf" / "pusharm6.urdf"
    env = ManipulatorEnvF(chain=kin.load_chain(urdf), eef_link="push_tool",
                          env_objects=True, device=str(dev))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths = build_demo_assets(
            tmp, urdf, joint_config=np.asarray(ASSET_JOINT_CONFIG, np.float32),
            n_per_link=ASSET_N_PER_LINK, n_ground=ASSET_N_GROUND)
        t_build = time.perf_counter() - t0
        assets = SplatAssets.load(
            env, paths["assets"], paths["match_object_name"],
            paths["splat_config_name"], paths["task_assets_path"],
            paths["task_assets_name"], task_splat_count=ASSET_TASK_N,
            package_path=str(desc))
        cameras = camera_setup(ASSET_RES, paths["assets"])
    wrapper = assets.configure_cameras(cameras)
    n = assets.scene_splat_frame.num_gaussians
    h, w = ASSET_RES
    log(f"env layer, asset wrapper: build_demo_assets {t_build:.2f} s, load "
        f"and configure {time.perf_counter() - t0 - t_build:.2f} s; N={n} "
        f"(8 links × {ASSET_N_PER_LINK}, ground {ASSET_N_GROUND}, task mesh "
        f"{ASSET_TASK_N}), sh{assets.scene_splat_frame.sh_degree}, 2 cameras "
        f"at {h}×{w}, raster {wrapper.raster}")
    if n != 100_000:
        raise AssertionError(f"the asset scene holds {n} gaussians")

    eef = ManipulatorEEFWrapperF(env=env)
    state, obs = eef.reset(reset_to_state={"robot_pos": ASSET_HOME,
                                           "block_pos": (0.45, 0.0, 0.2, 0.0)})
    pos, rpy = obs["eef_pos"], quat.to_rpy(obs["eef_quat"])
    seen = []
    real_k1 = composite.composite_static

    def capture(*args):
        seen.append(args)
        return real_k1(*args)

    with torch.no_grad(), replaced(composite, "composite_static", capture):
        render_cameras(wrapper, env.draw_state(state))          # warm-up
    if len(seen) != 2:
        raise AssertionError(f"one render launched K1 {len(seen)} times")

    # 25. the main path: task-space steps, each rendering both cameras -----
    reset_counts()
    t_step = t_render = 0.0
    with torch.no_grad():
        for i in range(ASSET_STEPS):
            act = {"eef_pos": pos + torch.tensor([0.0, 0.0, -0.002 * (i + 1)],
                                                 device=dev),
                   "eef_ori": rpy}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr = eef.step(state, act)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            imgs = render_cameras(wrapper, env.draw_state(tr.state))
            t_render += time.perf_counter() - t1
            t_step += t1 - t0
            if not bool(tr.info["ik_converged"].all()):
                raise AssertionError(f"asset step {i}: IK did not converge")
            state = tr.state
    launches = counts_now()
    want = dict(composite_static=2 * ASSET_STEPS)
    if any(launches[k] != want.get(k, 0) for k in launches):
        raise AssertionError(f"the asset steps launched {launches}, not "
                             f"{want}")
    for i, img in enumerate(imgs):
        if img.shape != (h, w, 3) or not np.isfinite(img).all() or \
                img.max() < 0.05:
            raise AssertionError(f"bad camera_{i} {img.shape}")
    draw = env.draw_state(state)
    render_ms = cuda_ms(lambda: wrapper.render(None, draw), 5)
    log(f"  {ASSET_STEPS} task-space steps at B=1: step (IK + env) "
        f"{t_step * 1e3 / ASSET_STEPS:.2f} ms, render of both cameras with "
        f"the host copy {t_render * 1e3 / ASSET_STEPS:.2f} ms (host clock, "
        f"synchronised); the render alone {render_ms:.2f} ms (events); "
        f"launches {launches}; image means "
        f"{[round(float(i.mean()), 4) for i in imgs]}")

    # 26. the images against K1's plain version, K1f on the path's inputs ---
    with torch.no_grad():
        got = wrapper.render(None, draw)
        with replaced(composite, "composite_static",
                      composite.composite_static_plain):
            want_imgs = wrapper.render(None, draw)
    for k, (a, b) in enumerate(zip(got, want_imgs)):
        check("asset wrapper", a, b, TOL, f"camera_{k} vs K1's plain version")
    a1 = seen[-1]                               # the viewport's lists
    a1 = (a1[0][0], a1[1][0], a1[2][0], *a1[3:])
    rows = static_rows(a1, dev, backward=False)
    rows[0]["name"] = "composite_static_assets"
    rows[0]["launches"] = launches["composite_static"]

    # 27. the free camera, and one joint-space step from examples/assets ----
    q, t = look_at([0.9, 0.9, 0.7], [0.35, 0.0, 0.2])
    cam = Camera.from_fov(SE3(torch.tensor(q, device=dev),
                              torch.tensor(t, dtype=torch.float32,
                                           device=dev)), 0.9, 160, 120)
    with torch.no_grad():
        free = wrapper.render_camera(draw, cam)
    if free.shape != (1, 120, 160, 3) or not bool(torch.isfinite(free).all()):
        raise AssertionError(f"bad free-camera image {tuple(free.shape)}")
    ex = SplatAssets.load(env, root / "examples" / "assets", "pusharm6",
                          "demo-run/splat.npz",
                          root / "examples" / "assets" / "tblock_paper",
                          "tblock_paper.obj", package_path=str(desc))
    ex_wrapper = ex.configure_cameras(
        camera_setup(ASSET_RES, root / "examples" / "assets"))
    reset_counts()
    with torch.no_grad():
        tr = env.step(state, state.arm.q)
        ex_imgs = render_cameras(ex_wrapper, env.draw_state(tr.state))
    if counts_now()["composite_static"] != 2 or not all(
            np.isfinite(i).all() and i.max() > 0.05 for i in ex_imgs):
        raise AssertionError("examples/assets did not render")
    log(f"  free camera 120×160: mean {float(free.mean()):.4f}; "
        f"examples/assets (N={ex.scene_splat_frame.num_gaussians}): one step, "
        f"image means {[round(float(i.mean()), 4) for i in ex_imgs]}")
    return rows

def examples_phase(composite, reset_counts, counts_now, dev):
    """The example drivers (``sim_a_splat_torch/examples``) on the card
    through their own functions at their own sizes (the shipped
    ``examples/assets`` tree, both cameras at 240×320): ``demo_pusht_splat
    --steps EX_PUSHT_STEPS`` (task-space steps, both cameras rendered and
    written each step), ``demo_joint_sliders_splat --steps EX_SLIDER_STEPS``
    (with ``--out``, so each step renders), ``demo_hw_splat --replay
    EX_HW_STEPS`` (no camera observation) and ``demo_viewer --selftest``
    (one 320×320 JPEG).  Each demo's launches of K1f are counted over its
    run; after it, its frames (both cameras, or the viewer's) are held
    against K1's plain version.  Logs each env's build s, the step ms and
    the render ms a camera.  Returns K1f's row on the pushT demo's viewport
    lists (``composite_static_examples``), launches summed over the
    demos."""
    import tempfile
    from pathlib import Path
    import torch
    from sim_a_splat_torch.examples import (
        demo_hw_splat, demo_joint_sliders_splat, demo_pusht_splat,
        demo_viewer,
    )
    from sim_a_splat_torch.examples.common import make_manipulator_splat_env
    from sim_a_splat_torch.ops.projection import Camera
    from sim_a_splat_torch.ops.transforms import SE3
    from sim_a_splat_torch.viewer import orbit_pose

    seen, real_k1 = [], composite.composite_static

    def capture(*args):
        seen.append(args)
        return real_k1(*args)

    def hold(name, render):
        """``render()`` (a list of images) on K1f against K1's plain
        version; returns its events ms."""
        with torch.no_grad():
            got = render()
            with replaced(composite, "composite_static",
                          composite.composite_static_plain):
                want = render()
        got = [torch.as_tensor(a) for a in got]
        # the hardware demo's weld carries the end effector's camera away
        # from the scene: only the frames together must show it
        if not all(bool(torch.isfinite(a).all()) for a in got) \
                or max(float(a.max()) for a in got) < 0.05:
            raise AssertionError(f"{name}: bad frames")
        for k, (a, b) in enumerate(zip(got, want)):
            check(name, a, torch.as_tensor(b), TOL,
                  f"frame {k} vs K1's plain version")
        return cuda_ms(render, 5)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    total = 0
    report = []
    with tempfile.TemporaryDirectory() as tmp:
        # demo_pusht_splat: pushT keypoints drive the end effector (IK)
        build_s, env = timed(lambda: make_manipulator_splat_env(
            eef=True, device=dev))
        pt = demo_pusht_splat.pusht_keypoints_env(96, seed=0, device=dev)
        out = Path(tmp) / "pusht"
        out.mkdir()
        reset_counts()
        with torch.no_grad(), replaced(composite, "composite_static",
                                       capture):
            run_s, n = timed(lambda: demo_pusht_splat.run_headless(
                pt, env, EX_PUSHT_STEPS, out))
        launches = counts_now()
        frames = len(list(out.glob("*.ppm")))
        if launches["composite_static"] != 2 * n or frames != 2 * n \
                or n != EX_PUSHT_STEPS:
            raise AssertionError(f"demo_pusht_splat: {n} steps, {frames} "
                                 f"frames, launches {launches}")
        total += launches["composite_static"]
        draw = env._draw()
        ms = hold("demo_pusht_splat", lambda: env.wrapper_f.render(None, draw))
        report.append(("demo_pusht_splat", build_s, run_s / n, ms / 2))
        # the last step's launches, one a camera in render order (the
        # end-effector camera, then the viewport): the viewport's lists
        keys = env.render_cam_keys
        a1 = seen[len(seen) - len(keys) + keys.index(VIEWPORT_KEY)]
        a1 = (a1[0][0], a1[1][0], a1[2][0], *a1[3:])

        # demo_joint_sliders_splat: the scripted sweep, frames written
        build_s, env = timed(lambda: demo_joint_sliders_splat.make_env(
            device=dev))
        out = Path(tmp) / "sliders"
        out.mkdir()
        reset_counts()
        with torch.no_grad():
            run_s, n = timed(lambda: demo_joint_sliders_splat.run(
                env, EX_SLIDER_STEPS, out))
        launches = counts_now()
        if launches["composite_static"] != 2 * n or n != EX_SLIDER_STEPS:
            raise AssertionError(f"demo_joint_sliders_splat: {n} steps, "
                                 f"launches {launches}")
        total += launches["composite_static"]
        draw = env._draw()
        ms = hold("demo_joint_sliders_splat",
                  lambda: env.wrapper_f.render(None, draw))
        report.append(("demo_joint_sliders_splat", build_s, run_s / n, ms / 2))

        # demo_hw_splat: a replayed joint stream on the non-identity weld
        build_s, env = timed(lambda: demo_hw_splat.create_splat_env(dev))
        reset_counts()

        def replay():
            for t in range(EX_HW_STEPS):
                demo_hw_splat.joint_state_callback(
                    demo_hw_splat.replay_message(t, EX_HW_STEPS), env)

        with torch.no_grad():
            run_s, _ = timed(replay)
        launches = counts_now()
        if any(launches.values()):
            raise AssertionError(f"demo_hw_splat's replay (no camera "
                                 f"observation) launched {launches}")
        draw = env._draw()
        ms = hold("demo_hw_splat", lambda: env.wrapper_f.render(None, draw))
        report.append(("demo_hw_splat", build_s, run_s / EX_HW_STEPS, ms / 2))

        # demo_viewer --selftest: one JPEG through the viewer's callback
        build_s, env = timed(lambda: demo_viewer.create_splat_env(
            EX_VIEW_SIZE, dev))
        viewer = demo_viewer.make_viewer(env, EX_VIEW_SIZE)
        try:
            reset_counts()
            with torch.no_grad():
                run_s, jpg = timed(lambda: demo_viewer.selftest(viewer))
            launches = counts_now()
            cam = viewer.camera
        finally:
            viewer.close()
        if launches["composite_static"] != 1:
            raise AssertionError(f"demo_viewer --selftest launched {launches}")
        total += 1
        q, t = orbit_pose(cam["azim"], cam["elev"], cam["dist"],
                          cam["target"])
        orbit = Camera.from_fov(SE3(torch.as_tensor(q, device=dev),
                                    torch.as_tensor(t, device=dev)),
                                demo_viewer.FOV, EX_VIEW_SIZE, EX_VIEW_SIZE)
        ms = hold("demo_viewer", lambda: [env.render_free_camera(orbit)])
        report.append(("demo_viewer", build_s, run_s, ms))
    for name, build_s, step_s, ms in report:
        log(f"  {name}: env build {build_s:.2f} s, step {step_s * 1e3:.2f} "
            f"ms (host clock, synchronised; the pushT and slider steps "
            f"render both cameras and write the frames), render "
            f"{ms:.2f} ms a camera (events)")
    rows = static_rows(a1, dev, backward=False)
    rows[0]["name"] = "composite_static_examples"
    rows[0]["launches"] = total
    return rows


def splat_training(entry, composite, reset_counts, counts_now, profiled,
                   dev):
    """The splat trainer (``splat/train.py``) on ``benchmarks/train_scene.py``'s
    protocol at its full width (``entry.train_scene_inputs``): the 2,000
    iterations with four refinement rounds through K1f and K1b, PSNR over
    the 8 views every 250, gated; a steady-state iteration timed and split;
    one train step against the plain path; K1f and K1b at the train shapes
    against their plain versions.  Returns their rows."""
    import numpy as np
    import torch
    from sim_a_splat_torch.splat import train

    gt, init, cams, cfg, raster = entry.train_scene_inputs(
        iters=TRAIN_ITERS, device=dev)
    t0 = time.perf_counter()
    gt_views = [train.render_view(gt, c, raster, device=dev) for c in cams]
    log(f"splat trainer: train_scene.py's protocol, ground truth N="
        f"{gt.num_gaussians} sh{gt.sh_degree}, init N={init.num_gaussians}, "
        f"{len(cams)} views at {cams[0].height}², {cfg.iters} iterations, "
        f"refinement every {cfg.refine_every} from {cfg.refine_start}, SSIM "
        f"λ {cfg.ssim_lambda}, raster {raster}; GT renders "
        f"{time.perf_counter() - t0:.2f} s, view 0 mean "
        f"{gt_views[0].mean():.4f}")

    curve = []

    def eval_psnr(scene, it):
        vals = [train.psnr(train.render_view(scene, c, raster, device=dev), v)
                for c, v in zip(cams, gt_views)]
        curve.append(dict(iter=it, psnr_mean=float(np.mean(vals)),
                          psnr_min=float(np.min(vals)),
                          n_gaussians=scene.num_gaussians))
        log(f"  eval @ {it}: PSNR mean {np.mean(vals):.3f} dB, min "
            f"{np.min(vals):.3f}, N={scene.num_gaussians}")

    # 28. the main path: the whole protocol through train() ----------------
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eval_psnr(init, 0)
    t1 = time.perf_counter()
    scene, hist = train.train(init, cams, gt_views, cfg, raster,
                              eval_every=TRAIN_EVAL_EVERY, eval_fn=eval_psnr,
                              device=dev)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t1
    eval_psnr(scene, cfg.iters)
    wall = time.perf_counter() - t0
    launches = counts_now()
    n_evals = len(curve)
    want = dict(composite_static=cfg.iters + n_evals * len(cams),
                composite_static_bwd=cfg.iters)
    if any(launches[k] != want.get(k, 0) for k in launches):
        raise AssertionError(f"the protocol launched {launches}, not {want}")
    n_hist = hist["n_gaussians"]
    rounds = list(range(cfg.refine_start, cfg.iters, cfg.refine_every))
    n_rounds = [(n_hist[r - 1], n_hist[r]) for r in rounds]
    first, last = curve[0], curve[-1]
    log(f"  the protocol: {wall:.2f} s with the evals, train() "
        f"{t_train:.2f} s ({t_train * 1e3 / cfg.iters:.2f} ms an iteration "
        f"with its evals and rounds, host clock); launches {launches}; "
        f"N before → after each round {n_rounds}; loss "
        f"{hist['loss'][0]:.5f} → {hist['loss'][-1]:.5f}")
    log(f"  PSNR curve (iter, mean, min, N): "
        + json.dumps([[c["iter"], round(c["psnr_mean"], 3),
                       round(c["psnr_min"], 3), c["n_gaussians"]]
                      for c in curve]))
    log(f"  final PSNR mean {last['psnr_mean']:.3f} dB, min "
        f"{last['psnr_min']:.3f} dB (iteration 0: {first['psnr_mean']:.3f}), "
        f"n_final {scene.num_gaussians}; quality reference only, the JAX "
        f"package on a TPU v5e (TRAIN_r05.json): "
        f"{TRAIN_R05['psnr_first']} → {TRAIN_R05['psnr_final']} dB, n_final "
        f"{TRAIN_R05['n_final']}")
    if not (last["psnr_mean"] >= TRAIN_GATE_DB
            and last["psnr_mean"] - first["psnr_mean"] >= TRAIN_GAIN_DB):
        raise AssertionError(
            f"final PSNR {last['psnr_mean']:.3f} dB from "
            f"{first['psnr_mean']:.3f}: the gate is ≥ {TRAIN_GATE_DB} dB and "
            f"≥ {TRAIN_GAIN_DB} dB above iteration 0")
    if all(a == b for a, b in n_rounds):
        raise AssertionError(f"no refinement round changed N: {n_rounds}")
    if not all(np.isfinite(hist["loss"])):
        raise AssertionError("a non-finite training loss")

    # 29. a steady-state iteration of the trained scene, timed and split ----
    params = train.parameters(scene)
    opt = train.make_optimizer(cfg, params)
    step = train.make_train_step(cfg, raster, opt)
    imgs = [torch.as_tensor(v, device=dev) for v in gt_views]
    acc = torch.zeros(params.num_gaussians, device=dev)

    def iterations(n, read_back):
        """``n`` iterations of ``train``'s loop body; ``read_back`` adds the
        reference's per-iteration host reads (``float(loss)`` and the
        ‖∇means‖ copy).  Returns (ms by events, ms by the host clock)."""
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        for i in range(n):
            _, loss, gnorm = step(params, cams[i % len(cams)],
                                  imgs[i % len(cams)])
            acc.add_(gnorm)
            if read_back:
                float(loss)
                gnorm.cpu()
        end.record()
        torch.cuda.synchronize()
        return (start.elapsed_time(end) / n,
                (time.perf_counter() - t) * 1e3 / n)

    iterations(5, False)                                    # warm-up
    # in turns (without, with, with, without the reads): host-clock times
    # drift within a call
    runs = [iterations(TRAIN_STEADY_ITERS, rb)
            for rb in (False, True, True, False)]
    it_ev, it_host = (float(np.mean([r[i] for r in runs[::3]]))
                      for i in (0, 1))
    rb_ev, rb_host = (float(np.mean([r[i] for r in runs[1:3]]))
                      for i in (0, 1))
    cam, img = cams[0], imgs[0]
    fwd_ms = cuda_ms(lambda: train.train_loss(params, cam, img, cfg, raster),
                     TRAIN_STEADY_ITERS)
    leaves = [p for p in params if p is not None]
    loss0 = train.train_loss(params, cam, img, cfg, raster)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(loss0, leaves,
                                                 retain_graph=True),
                     TRAIN_STEADY_ITERS)
    del loss0
    adam_ms = cuda_ms(opt.step, TRAIN_STEADY_ITERS)
    log(f"  steady-state iteration (N={params.num_gaussians}, 2 × "
        f"{TRAIN_STEADY_ITERS} iterations): {it_ev:.3f} ms (events), "
        f"{it_host:.3f} ms (host clock); with the reference's per-iteration "
        f"host reads (float(loss), ‖∇means‖ to the host) {rb_ev:.3f} / "
        f"{rb_host:.3f} ms, so the syncs the port's loop leaves out cost "
        f"{rb_host - it_host:.3f} ms; split (events, each part alone): "
        f"forward + loss {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms, Adam "
        f"{adam_ms:.3f} ms, sum {fwd_ms + bwd_ms + adam_ms:.3f} ms")
    profiled("splat train step",
             lambda: step(params, cam, img), it_ev)

    # 30. one full-width train step against the plain path: at the degraded
    # init (view 0, its GT image) and at the trained scene ------------------
    def one_step(start):
        p = train.parameters(start)
        loss = train.train_loss(p, cams[0], imgs[0], cfg, raster)
        loss.backward()
        grads = type(p)(*(None if f is None else f.grad for f in p))
        return float(loss.detach()), \
            torch.linalg.vector_norm(grads.means, dim=-1), grads

    seen = []
    real_k1 = composite.composite_static

    def capture(*args):
        seen.append(args)
        return real_k1(*args)

    for label, start in (("the degraded init", init),
                         ("the trained scene", scene)):
        with replaced(composite, "composite_static", capture):
            loss_k, gn_k, g_k = one_step(start)
        with replaced(composite, "composite_static",
                      composite.composite_static_plain):
            loss_p, gn_p, g_p = one_step(start)
        rel = abs(loss_k - loss_p) / abs(loss_p)
        log(f"  one train step at {label} (N={start.num_gaussians}, view 0) "
            f"vs the plain path: loss {loss_k} vs {loss_p} (relative "
            f"{rel:.3e}, tolerance 1e-6)")
        if not rel <= 1e-6:
            raise AssertionError(f"train-step loss {loss_k} vs {loss_p}")
        fields = [n for n, f in zip(g_p._fields, g_p) if f is not None]
        if start is init:
            # every init gaussian is isotropic (unit quaternion, equal
            # scales), so R S Sᵀ Rᵀ = s² I for any rotation and the quats'
            # gradient is 0 in exact arithmetic: both paths must give only
            # rounding, below QUAT_NOISE × the means' largest gradient
            fields.remove("quats")
            noise = QUAT_NOISE * float(g_p.means.abs().max())
            q_k, q_p = (float(g.quats.abs().max()) for g in (g_k, g_p))
            log(f"  grad quats (zero in exact arithmetic here): max|g| "
                f"{q_k:.3e} (kernels), {q_p:.3e} (plain); bound {noise:.3e}")
            if not max(q_k, q_p) <= noise:
                raise AssertionError("the isotropic init's quats gradient "
                                     "is not rounding")
        check_fields("splat train-step", g_k, g_p, fields)
        e_gn = float((gn_k - gn_p).abs().max())
        log(f"  ‖∇means‖: max|Δ| = {e_gn:.3e}, max {float(gn_p.max()):.3e} "
            f"(tolerance {TOL_GRAD:.1e} × max)")
        if not e_gn <= TOL_GRAD * float(gn_p.max()):
            raise AssertionError("‖∇means‖ disagrees with the plain path")

    # 31. K1f and K1b at the train shapes ------------------------------------
    rows = static_rows(seen[0], dev)
    for r, key in zip(rows, ("composite_static", "composite_static_bwd")):
        r["name"] += "_train"
        r["launches"] = launches[key]
    return rows


def splat_pipeline(entry, composite, reset_counts, counts_now, dev):
    """``splat/pipeline.py`` and ``splat/export.py`` on a PIPE_N SH-3
    ``synthetic_scene``: ``render`` at 640×480 (K1f over 40 × 30 tiles at
    K = 1,024) against K1's plain version, timed; the RGB-D cloud at
    320×240; the point cloud with densify and cull; ``save_ply`` →
    ``load_ply`` bit for bit; the ellipsoids of 2,000 gaussians; and a
    ``transforms.json`` written from ring cameras, read by
    ``load_dataset``, each dataset camera rendered (no image is read: the
    card's machine has no PIL).  Returns K1f's row at 640×480."""
    import tempfile
    from pathlib import Path
    import numpy as np
    import torch
    from sim_a_splat_torch.ops.transforms import SE3, Sim3
    from sim_a_splat_torch.splat import (
        GaussianSplatPipeline, ellipsoid_mesh, load_dataset, load_ply,
        save_ply, synthetic_scene,
    )

    t0 = time.perf_counter()
    scene = synthetic_scene(PIPE_N, seed=0, sh_degree=3, device=dev)
    pipe = GaussianSplatPipeline(scene=scene, dataparser=Sim3.identity())
    pose = SE3(torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev),
               torch.tensor([0.0, 0.0, -3.0], device=dev))
    h, w = PIPE_RES
    rh, rw = PIPE_RGBD_RES
    ring = entry.ring_cameras(PIPE_VIEWS, radius=3.2, height=-1.2, res=128,
                              device=dev)
    seen = []
    real_k1 = composite.composite_static

    def capture(*args):
        seen.append(args)
        return real_k1(*args)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # the dataset: the ring cameras as nerfstudio frames (OpenGL
        # camera-to-world), no images
        frames = []
        for i, c in enumerate(ring):
            c2w = np.eye(4)
            c2w[:3, :3] = (c.pose.rotation_matrix().cpu().double().numpy()
                           @ np.diag([1.0, -1.0, -1.0]))
            c2w[:3, 3] = c.pose.t.cpu().double().numpy()
            frames.append({"file_path": f"images/frame_{i:05d}.png",
                           "transform_matrix": c2w.tolist()})
        (tmp / "transforms.json").write_text(json.dumps({
            "w": 128, "h": 128, "fl_x": float(ring[0].fx),
            "fl_y": float(ring[0].fy), "cx": 64.0, "cy": 64.0,
            "camera_model": "OPENCV", "frames": frames}))
        ds = load_dataset(tmp, "all", device=dev)

        # 32. the main path: every render of the pipeline -----------------
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with replaced(composite, "composite_static", capture):
            out = pipe.render(pose, width=w, height=h)
        rgbd = pipe.generate_rgbd_point_cloud(pose, width=rw, height=rh)
        ds_imgs = [pipe.render(c.pose, camera=c)["rgb"] for c in ds.cameras()]
        torch.cuda.synchronize()
        t_renders = time.perf_counter() - t1
        launches = counts_now()
        want = dict(composite_static=2 + len(ring))
        if any(launches[k] != want.get(k, 0) for k in launches):
            raise AssertionError(f"the pipeline launched {launches}, not "
                                 f"{want}")
        # each dataset camera is its ring camera after a float64 round trip
        # (OpenGL matrix, JSON, quaternion): poses within 1e-6, and renders
        # that differ only where a pixel's entry sits on the 3σ or 1/255
        # cut-off (at most DS_EDGE_PIXELS pixels a view over 1e-4)
        for k, (c, r, img) in enumerate(zip(ds.cameras(), ring, ds_imgs)):
            check("pipeline", c.pose.q, r.pose.q, 1e-6,
                  f"dataset camera {k}'s quaternion vs its ring camera's")
            check("pipeline", c.pose.t, r.pose.t, 1e-6,
                  f"dataset camera {k}'s position vs its ring camera's")
            if (c.width, c.height) != (r.width, r.height) or any(
                    float(getattr(c, a)) != float(getattr(r, a))
                    for a in ("fx", "fy", "cx", "cy")):
                raise AssertionError(f"dataset camera {k}'s intrinsics")
            d = (img - pipe.render(r.pose, camera=r)["rgb"]).abs().amax(-1)
            n_off = int((d > 1e-4).sum())
            log(f"  dataset camera {k} vs its ring camera: render max|Δ| "
                f"{float(d.max()):.3e}, {n_off} pixels over 1e-4")
            if n_off > DS_EDGE_PIXELS:
                raise AssertionError(f"dataset camera {k}: {n_off} pixels")
        pc = pipe.generate_point_cloud(densify_scene=True, cull_scene=True)
        kept = int(((scene.opacities() >= 0.1)
                    & (scene.scales().amax(-1) <= 0.5)).sum())
        save_ply(tmp / "scene.ply", scene)
        back = load_ply(tmp / "scene.ply", device=dev)
        ply_mb = (tmp / "scene.ply").stat().st_size / 2**20
        mesh, vcol = ellipsoid_mesh(scene)
    if len(pc["points"]) != 2 * kept or not np.isfinite(pc["points"]).all():
        raise AssertionError(f"densified cloud of {len(pc['points'])} "
                             f"points, not 2 × {kept}")
    if not all(torch.equal(a, b) for a, b in zip(scene, back)):
        raise AssertionError("save_ply → load_ply is not bit for bit")
    if mesh.vertices.shape != (2000 * 42, 3) or len(vcol) != 2000 * 42 \
            or not np.isfinite(mesh.vertices).all():
        raise AssertionError(f"ellipsoid mesh {mesh.vertices.shape}")
    if len(rgbd["points"]) < 1000 or not np.isfinite(rgbd["points"]).all():
        raise AssertionError(f"RGB-D cloud of {len(rgbd['points'])} points")
    for k, shape in (("rgb", (h, w, 3)), ("depth", (h, w)),
                     ("accumulation", (h, w))):
        if tuple(out[k].shape) != shape or \
                not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"render {k} {tuple(out[k].shape)}")

    # 33. the render against K1's plain version, K1f at its inputs ----------
    with replaced(composite, "composite_static",
                  composite.composite_static_plain):
        plain = pipe.render(pose, width=w, height=h)
    check("pipeline", out["rgb"], plain["rgb"], TOL,
          f"rgb {h}×{w} vs K1's plain version")
    check("pipeline", out["accumulation"], plain["accumulation"], TOL,
          "accumulation vs K1's plain version")
    dmax = max(1.0, float(plain["depth"].abs().max()))
    check("pipeline", out["depth"] / dmax, plain["depth"] / dmax, TOL,
          "depth / max depth vs K1's plain version")
    render_ms = cuda_ms(lambda: pipe.render(pose, width=w, height=h), 5)
    log(f"splat pipeline: N={PIPE_N} sh3, set-up "
        f"{t1 - t0:.2f} s; the main path's renders ({w}×{h}, the RGB-D "
        f"cloud's {rw}×{rh}, {len(ring)} dataset cameras at 128²) "
        f"{t_renders:.2f} s (host clock), launches {launches}; render at "
        f"{w}×{h} {render_ms:.2f} ms (events), accumulation mean "
        f"{float(out['accumulation'].mean()):.4f}; RGB-D cloud "
        f"{len(rgbd['points'])} points; densify + cull {len(pc['points'])} "
        f"points (2 × {kept}); save_ply {ply_mb:.1f} MiB → load_ply bit for "
        f"bit; ellipsoids of 2,000 gaussians: {len(mesh.vertices)} "
        f"vertices, {len(mesh.faces)} faces")
    rows = static_rows(seen[0], dev, backward=False)
    rows[0]["name"] = "composite_static_pipeline"
    rows[0]["launches"] = launches["composite_static"]
    return rows


# --- the distributed layer ----------------------------------------------------

def bench_graph(entry, dev):
    """The bench's pushT scene graph: N gaussians (N/20 block, N/50 agent),
    SH degree SH_DEGREE, seed 0."""
    nb, na = max(N // 20, 100), max(N // 50, 50)
    return entry.build_scene(n_bg=N - nb - na, n_block=nb, n_agent=na,
                             seed=0, sh_degree=SH_DEGREE, device=dev)


def sharded_render_rank(ranks=DIST_RANKS):
    """One rank of the distributed phase's prim-sharded render (started by
    ``parallel.launch``): the bench scene through ``rasterize_sharded_sh``
    on a prim = ``ranks`` mesh, one warm-up forward + backward with K1's
    arguments captured, then the counted run (one forward and the gradient
    of sum(img²) to the means), the forward, the train step and the
    exchange alone timed by CUDA events; rank 0 holds K1f and K1b at the
    captured owned-rows payload against their plain versions
    (``static_rows``)."""
    import torch
    import torch.distributed as dist
    from sim_a_splat_torch import entry
    from sim_a_splat_torch.ops import composite
    from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
    from sim_a_splat_torch.parallel import make_mesh, rasterize_sharded_sh
    from sim_a_splat_torch.parallel import render_sharding
    from sim_a_splat_torch.utils import profiling
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(env=1, prim=ranks, device="cuda")
    group = mesh.get_group("prim")
    scene = bench_graph(entry, dev).scene
    cam = entry._fixed_camera(RES, RES, dev)
    cfg = RasterConfig(**DIST_RASTER)
    covs, sh, opac = scene.covs(), scene.sh_coeffs(), scene.opacities()
    means = scene.means.detach().requires_grad_()

    def render(m):
        return rasterize_sharded_sh(mesh, m, covs, sh, opac, cam, SH_DEGREE,
                                    cfg, DIST_SEND)

    def train():
        img = render(means)
        return img, torch.autograd.grad(torch.sum(img ** 2), means)[0]

    seen = []
    real_k1 = composite.composite_static
    with replaced(composite, "composite_static",
                  lambda *a: seen.append(a) or real_k1(*a)):
        train()
    torch.cuda.synchronize()
    dist.barrier()
    before = profiling.launches.copy()
    t0 = time.perf_counter()
    img, g = train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: profiling.launches[n] - before[n]
                for n in ("composite_static", "composite_static_bwd")}
    fwd_ms = cuda_ms(lambda: render(means.detach()), DIST_REPS)
    train_ms = cuda_ms(train, DIST_REPS)
    send = torch.zeros((seen[0][0].shape[0], render_sharding.N_FIELDS,
                        DIST_SEND), device=dev)
    xch_ms = cuda_ms(lambda: render_sharding._all_to_all(send, group),
                     DIST_REPS)
    dist.barrier()
    rows = []
    if dist.get_rank() == 0:
        rows = static_rows(seen[0], dev)
        for r, name in zip(rows, ("composite_static_sharded",
                                  "composite_static_bwd_sharded")):
            r["name"] = name
            r["launches"] = launches[name.replace("_sharded", "")]
    return {"img": img.detach().cpu().numpy(), "grad": g.cpu().numpy(),
            "wall_s": wall, "launches": launches, "fwd_ms": fwd_ms,
            "train_ms": train_ms, "exchange_ms": xch_ms, "rows": rows,
            "payload": tuple(seen[0][0].shape),
            "owned": int((seen[0][2] > 0).sum())}


def sharded_render_phase(entry, dev, ranks=DIST_RANKS, backend="gloo"):
    """The prim-sharded render of the bench scene on ``ranks`` ranks of
    ``backend`` (:func:`sharded_render_rank`) against the card's
    single-device ``rasterize_sh``: the image within TOL, the gradient to
    the means within TOL_GRAD × its largest, on each rank, one K1f and one
    K1b launch a rank; logs the exchange's bytes and ms and the render's
    ms.  Returns K1f's and K1b's rows at rank 0's owned rows
    (``composite_static_sharded``, ``composite_static_bwd_sharded``)."""
    import numpy as np
    import torch
    from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig, rasterize_sh
    from sim_a_splat_torch.parallel import launch
    from sim_a_splat_torch.parallel.render_sharding import exchange_bytes

    t0 = time.perf_counter()
    scene = bench_graph(entry, dev).scene
    cam = entry._fixed_camera(RES, RES, dev)
    cfg = RasterConfig(**DIST_RASTER)
    means = scene.means.detach().requires_grad_()
    covs, sh, opac = scene.covs(), scene.sh_coeffs(), scene.opacities()
    img_1, aux = rasterize_sh(means, covs, sh, opac, cam, SH_DEGREE, cfg)
    (g_1,) = torch.autograd.grad(torch.sum(img_1 ** 2), means)
    single_ms = cuda_ms(lambda: rasterize_sh(means.detach(), covs, sh, opac,
                                             cam, SH_DEGREE, cfg), DIST_REPS)
    img_1, g_1 = img_1.detach().cpu().numpy(), g_1.cpu().numpy()
    del scene, means, covs, sh, opac
    t1 = time.perf_counter()
    res = launch(sharded_render_rank, ranks, backend, dev, ranks)
    t_ranks = time.perf_counter() - t1
    g_scale = float(np.abs(g_1).max())
    for r, out in enumerate(res):
        e_img = float(np.abs(out["img"] - img_1).max())
        e_g = float(np.abs(out["grad"] - g_1).max())
        log(f"  rank {r}: image max|Δ| vs the single-device render "
            f"{e_img:.3e} (tolerance {TOL:.1e}), gradient to the means "
            f"max|Δ| {e_g:.3e} of max|g| {g_scale:.3e} (tolerance "
            f"{TOL_GRAD:.1e} × max|g|); launches {out['launches']}")
        if not e_img <= TOL:
            raise AssertionError(f"rank {r}'s sharded image: {e_img}")
        if not (np.isfinite(out["grad"]).all() and e_g <= TOL_GRAD * g_scale):
            raise AssertionError(f"rank {r}'s sharded gradient: {e_g}")
        if out["launches"] != {"composite_static": 1,
                               "composite_static_bwd": 1}:
            raise AssertionError(f"rank {r} launched {out['launches']}")
    nbytes = exchange_bytes(cam, cfg, DIST_SEND, ranks)
    log(f"prim-sharded render: N={N} sh{SH_DEGREE} {RES}², K="
        f"{cfg.tile_capacity}, send {DIST_SEND}, {ranks} {backend} ranks; "
        f"n_overflowed_tiles (single device) "
        f"{int(aux.n_overflowed_tiles)}; K1 payload {res[0]['payload']} "
        f"with {res[0]['owned']} owned tiles active; exchange "
        f"{nbytes / 1e6:.2f} MB a rank, "
        + ", ".join(f"rank {r}: exchange {o['exchange_ms']:.2f} ms, render "
                    f"{o['fwd_ms']:.2f} ms, render + gradient "
                    f"{o['train_ms']:.2f} ms, counted run "
                    f"{o['wall_s'] * 1e3:.2f} ms (host clock)"
                    for r, o in enumerate(res))
        + f"; single-device render {single_ms:.2f} ms (events); "
        f"the ranks' launch {t_ranks:.1f} s, the phase "
        f"{time.perf_counter() - t0:.1f} s")
    return res[0]["rows"]


def scaling_plain(entry):
    """The scaling protocol's step in this process with K1's plain version
    → (loss, gradients by scene field), SCALING_PLAIN_ENVS envs at a time
    (the plain backward keeps ~1.8 GB an env): the loss is a mean over the
    envs, so the batch's loss and gradient are the slices' means."""
    from sim_a_splat_torch.ops import composite
    from sim_a_splat_torch.parallel.mesh import tree_map
    B, n = SCALING["B"], SCALING_PLAIN_ENVS
    scene, step, states, actions = entry.scaling_inputs(
        B, SCALING["N"], SCALING["res"], device="cuda")
    fwd_bwd = entry.scaling_step(step)
    loss, grads = 0.0, {}
    with replaced(composite, "composite_static",
                  composite.composite_static_plain):
        for b0 in range(0, B, n):
            _, l_, g_ = fwd_bwd(scene, tree_map(lambda a: a[b0:b0 + n],
                                                states), actions[b0:b0 + n])
            loss += float(l_) * n / B
            for k, v in g_._asdict().items():
                if v is not None:
                    grads[k] = grads.get(k, 0.0) + v * (n / B)
    return loss, grads


def scaling_phase(entry, worlds):
    """The scaling protocol (``entry.bench_mesh``, SCALING) at each (world,
    backend) of ``worlds``, the first the reference: every rank launches
    K1f and K1b once a timed step; the first world's losses and gradients
    are held to the same step with K1's plain version (``scaling_plain``:
    the loss and each gradient field within TOL_GRAD), and every other
    world's to the first's within TOL_SCALING (relative; each gradient
    field to its largest).  Logs frames/s and, across cards,
    the efficiency frames/s ÷ (world × the first's); returns
    {world: frames/s}."""
    import torch
    fps, ref = {}, None
    for world, backend in worlds:
        t0 = time.perf_counter()
        f, res = entry.bench_mesh(world, backend, device="cuda", **SCALING)
        fps[world] = f
        for k, out in enumerate(res):
            if (out["launches"], out["launches_bwd"]) != \
                    (SCALING["iters"],) * 2:
                raise AssertionError(
                    f"scaling, world {world}, rank {k} launched K1f/K1b "
                    f"{out['launches']}/{out['launches_bwd']}")
        if ref is None:
            ref, w0 = res[0], world
            plain = scaling_plain(entry)
            for k, out in enumerate(res):
                hold_to_plain(f"scaling, world {world}, rank {k}",
                              out["loss"], out["grads"], *plain, TOL_GRAD)
        else:
            for k, out in enumerate(res):
                e_loss = abs(out["loss"] - ref["loss"]) / abs(ref["loss"])
                worst = 0.0
                for name, g in ref["grads"].items():
                    scale = float(g.abs().max())
                    err = float((out["grads"][name] - g).abs().max())
                    worst = max(worst, err / scale if scale else err)
                    if not (bool(torch.isfinite(out["grads"][name]).all())
                            and err <= TOL_SCALING * scale):
                        raise AssertionError(
                            f"scaling, world {world}, rank {k}: gradient of "
                            f"{name} {err} > {TOL_SCALING} × {scale}")
                if not e_loss <= TOL_SCALING:
                    raise AssertionError(
                        f"scaling, world {world}, rank {k}: loss "
                        f"{out['loss']} vs {ref['loss']}")
                log(f"  scaling, world {world}, rank {k}: loss rel. Δ "
                    f"{e_loss:.3e}, gradients max|Δ| / max|g| {worst:.3e} "
                    f"(tolerance {TOL_SCALING:.0e})")
        log(f"scaling protocol (B={SCALING['B']}, N={SCALING['N']}, "
            f"{SCALING['res']}², uncached train step, {SCALING['iters']} "
            f"timed steps), world {world} ({backend}): {f:.2f} frames/s, "
            f"ranks {[round(o['seconds'], 3) for o in res]} s, frames/s ÷ "
            f"(world × world {w0}'s) {f / (world / w0 * fps[w0]):.3f}; the "
            f"call {time.perf_counter() - t0:.1f} s (host clock)")
    return fps


def distributed(entry, dev):
    """The distributed layer on the one card (ranks are processes of one
    process group; two ranks on one card need gloo, as NCCL refuses a
    duplicate GPU; gloo's collectives take the CUDA tensors):

    - the prim-sharded render of the bench scene on DIST_RANKS gloo ranks
      against the card's single-device render
      (:func:`sharded_render_phase`);
    - the scaling protocol's train step at world 1 (NCCL) and on 2 gloo
      ranks, frames/s, world 1's loss and gradients held to K1's plain
      version, the 2 ranks' to world 1's;
    - ``dryrun_multichip`` on DRYRUN_RANKS gloo ranks: one finite loss,
      every kernel K1-K4 launched forward and backward on every rank, each
      rank's loss and gradient held to the plain path's.

    Two ranks on one card share its SMs and gloo goes through the host:
    the times are the mechanism's cost on one card, not a scaling
    efficiency.  Returns the two sharded K1 rows."""
    # 34. the prim-sharded render against the single-device render --------
    rows = sharded_render_phase(entry, dev)

    # 35-36. the scaling protocol at world 1 (NCCL) and 2 (gloo) ----------
    scaling_phase(entry, [(1, "nccl"), (2, "gloo")])

    # 37. dryrun_multichip on DRYRUN_RANKS gloo ranks ----------------------
    dryrun_phase(entry)
    return rows


def plain_kernels():
    """Every kernel K1-K4 swapped for its plain PyTorch version (forward,
    and autograd through it for the backward) while the context lasts."""
    from sim_a_splat_torch.ops import (
        composite, composite_pair, composite_sel, composite_single,
    )
    stack = contextlib.ExitStack()
    for module, name in ((composite, "composite_static"),
                         (composite_pair, "composite_pair"),
                         (composite_sel, "composite_pair_sel"),
                         (composite_single, "composite_sel_single")):
        stack.enter_context(replaced(module, name,
                                     getattr(module, f"{name}_plain")))
    return stack


def hold_to_plain(what, loss, grads, loss_p, grads_p, rel_loss):
    """A run's loss within ``rel_loss`` (relative) of the plain path's, and
    each gradient field (name → tensor) finite and within TOL_GRAD × that
    field's largest plain gradient."""
    import torch
    e_loss = abs(loss - loss_p) / abs(loss_p)
    worst = 0.0
    for name, want in grads_p.items():
        got, want = grads[name].cpu(), want.cpu()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        if not (bool(torch.isfinite(got).all()) and err <= TOL_GRAD * scale):
            raise AssertionError(f"{what}: gradient of {name} {err} > "
                                 f"{TOL_GRAD} × {scale} (the plain path's)")
        worst = max(worst, err / scale if scale else err)
    log(f"  {what} vs the plain path: loss {loss} vs {loss_p} (rel. Δ "
        f"{e_loss:.3e}, tolerance {rel_loss:.0e}), gradients max|Δ| / max|g| "
        f"{worst:.3e} (tolerance {TOL_GRAD:.1e})")
    if not e_loss <= rel_loss:
        raise AssertionError(f"{what}: loss {loss} vs the plain path's "
                             f"{loss_p}")


def dryrun_phase(entry, ranks=DRYRUN_RANKS, backend="gloo"):
    """``dryrun_multichip`` on ``ranks`` ranks of ``backend``: one finite
    loss on every rank, every kernel K1-K4 launched forward and backward on
    every rank, and each rank's loss and the gradient its SGD step took
    held to the same loss and gradient computed in one process with every
    kernel's plain version (``entry.dryrun_single``): the loss within
    TOL_DRYRUN, each gradient field within TOL_GRAD × its largest."""
    t0 = time.perf_counter()
    res = entry.dryrun_ranks(ranks, backend, "cuda")
    loss = entry.dryrun_report(ranks, res)
    for k, out in enumerate(res):
        idle = [n for n, c in out["launches"].items() if c == 0]
        if idle:
            raise AssertionError(f"dryrun rank {k} did not launch {idle}")
    with plain_kernels():
        loss_p, g_p = entry.dryrun_single(ranks, "cuda")
    g_p = {k: g for k, g in g_p._asdict().items() if g is not None}
    for k, out in enumerate(res):
        hold_to_plain(f"dryrun rank {k}", out["loss"], out["grads"], loss_p,
                      g_p, TOL_DRYRUN)
    log(f"dryrun_multichip({ranks}) on {backend} ranks: loss {loss:.6f} on "
        f"every rank, launches per rank {res[0]['launches']}, "
        f"{time.perf_counter() - t0:.1f} s")


def viewer_phase(composite, reset_counts, counts_now, dev):
    """The viewer: a VIEW_N SH-3 synthetic scene through
    ``viewer.scene_render_fn`` (``rasterize_sh``, kernel K1f) behind
    ``SplatViewer``: one frame served over local HTTP (its K1f launch
    counted), the frame against K1's plain version at the same pose, the
    render and the request timed."""
    import urllib.request
    import torch
    from sim_a_splat_torch.splat import synthetic_scene
    from sim_a_splat_torch.viewer import SplatViewer, orbit_pose, scene_render_fn

    t0 = time.perf_counter()
    h, w = VIEW_RES
    scene = synthetic_scene(VIEW_N, seed=0, sh_degree=3, device=dev)
    render = scene_render_fn(scene, width=w, height=h, device=dev)
    viewer = SplatViewer(render)
    try:
        render(*orbit_pose(-1.57, 0.5, 4.0, (0.0, 0.0, 0.0)), {})  # warm-up
        reset_counts()
        t1 = time.perf_counter()
        with urllib.request.urlopen(viewer.url + "frame.jpg",
                                    timeout=30) as r:
            ctype, body = r.headers.get("Content-Type"), r.read()
        http_ms = (time.perf_counter() - t1) * 1e3
        launches = counts_now()
    finally:
        viewer.close()
    if launches["composite_static"] != 1 or \
            any(v for k, v in launches.items() if k != "composite_static"):
        raise AssertionError(f"the viewer's frame launched {launches}")
    if ctype not in ("image/jpeg",) or body[:2] not in (b"\xff\xd8", b"P6"):
        raise AssertionError(f"the viewer served {ctype} {body[:8]!r}")
    q, t = orbit_pose(-1.57, 0.5, 4.0, (0.0, 0.0, 0.0))
    img = render(q, t, {})
    with replaced(composite, "composite_static",
                  composite.composite_static_plain):
        plain = render(q, t, {})
    check("viewer", img, plain, TOL, f"frame {h}×{w} vs K1's plain version")
    if not float(img.std()) > 0.01:
        raise AssertionError("the viewer's frame is blank")
    render_ms = cuda_ms(lambda: render(q, t, {}), 5)
    log(f"viewer: N={VIEW_N} sh3 at {w}×{h}, one frame over local HTTP "
        f"{http_ms:.2f} ms (host clock, {len(body)} bytes of {ctype}), "
        f"launches {launches['composite_static']} K1f; the render "
        f"{render_ms:.2f} ms (events); {time.perf_counter() - t0:.1f} s")


def primitive_mesh_urdf(urdf, out_dir):
    """A copy of ``urdf`` in ``out_dir`` whose cylinder and sphere visuals
    are OBJ meshes of the same shapes (the matcher reads mesh files, as
    the reference's does); returns its path."""
    import re
    from pathlib import Path
    from sim_a_splat_torch.tools import meshio
    out_dir = Path(out_dir)
    text = Path(urdf).read_text()
    count = [0]

    def mesh_of(m):
        kind, attrs = m.group(1), dict(re.findall(r'(\w+)="([^"]*)"',
                                                  m.group(2)))
        if kind == "cylinder":
            mesh = meshio.cylinder_mesh(float(attrs["radius"]),
                                        float(attrs["length"]))
        else:
            ico = meshio.icosphere(2)
            mesh = meshio.TriMesh(ico.vertices * float(attrs["radius"]),
                                  ico.faces)
        name = f"visual_{count[0]}.obj"
        count[0] += 1
        meshio.save_obj(out_dir / name, mesh)
        return f'<mesh filename="{name}"/>'

    text = re.sub(r"<(cylinder|sphere)\s([^>]*)/>", mesh_of, text)
    path = out_dir / Path(urdf).name
    path.write_text(text)
    return path


def tools_phase():
    """The offline matching tools on their native path: the port's binding
    of the C++ KD-tree / BVH builds (``native.available()``), and
    ``tools.match`` runs scaled ICP on pusharm6's link meshes (its URDF's
    cylinders and sphere as OBJ files) against a splat made of their
    surface samples under a known similarity, plus a background cloud: the
    similarity recovered within 5e-3, each link's mask holding its own
    samples and no background."""
    import tempfile
    from pathlib import Path
    import numpy as np
    import torch
    from sim_a_splat_torch import native
    from sim_a_splat_torch.physics import kinematics as kin
    from sim_a_splat_torch.splat.scene import GaussianScene
    from sim_a_splat_torch.tools import meshio
    from sim_a_splat_torch.tools.match import load_link_meshes, match

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError(f"the native binding did not build: "
                             f"{native.build_error}")
    t_build = time.perf_counter() - t0
    urdf = Path(__file__).resolve().parent / "robot_description" / \
        "pusharm6" / "urdf" / "pusharm6.urdf"
    q = np.asarray(ASSET_JOINT_CONFIG)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        path = primitive_mesh_urdf(urdf, tmp)
        meshes = load_link_meshes(kin.load_chain(path), tmp, q)
        rng = np.random.default_rng(0)
        parts = [meshio.sample_surface(m, 600, seed=i)
                 for i, m in enumerate(meshes.values())]
        bg = rng.uniform(-3, 3, (2000, 3)) + np.array([0.0, 0.0, 5.0])
        c, s_ = np.cos(0.3), np.sin(0.3)
        R = np.array([[c, -s_, 0.0], [s_, c, 0.0], [0.0, 0.0, 1.0]])
        s, t = 0.2112, np.array([0.4, -0.1, 0.3])
        world = np.concatenate(parts + [bg])
        means = s * world @ R.T + t + rng.normal(0, 1e-5, world.shape)
        n = len(means)
        scene = GaussianScene(*(torch.as_tensor(np.asarray(a, np.float32))
                                for a in (means, np.tile([1.0, 0, 0, 0],
                                                         (n, 1)),
                                          np.full((n, 3), -6.0),
                                          np.full(n, 2.0), np.zeros((n, 3)))))
        init = np.eye(4)
        init[:3, :3] = 0.2 * np.array([[np.cos(0.25), -np.sin(0.25), 0.0],
                                       [np.sin(0.25), np.cos(0.25), 0.0],
                                       [0.0, 0.0, 1.0]])
        init[:3, 3] = t + 0.01
        t1 = time.perf_counter()
        res = match(path, scene, q, tmp / "out", trans_init=init,
                    max_correspondence_distance=0.1, distance_threshold=0.004,
                    n_sample_points=5000)
        t_match = time.perf_counter() - t1
        written = sorted(p.name for p in (tmp / "out").iterdir())
    want = np.eye(4)
    want[:3, :3] = s * R
    want[:3, 3] = t
    err = float(np.abs(res.icp_transformation - want).max())
    n_parts = np.cumsum([0] + [len(p) for p in parts])
    held = [float(res.link_masks[f"link{i}"][n_parts[i]:n_parts[i + 1]].mean())
            for i in range(len(parts))]
    stray = int(sum(m[n_parts[-1]:].sum() for m in res.link_masks.values()))
    log(f"tools: native binding built/loaded in {t_build:.2f} s; match on "
        f"pusharm6's {len(meshes)} link meshes ({n} splat means, "
        f"{n_parts[-1]} on the links): scaled ICP rmse {res.rmse:.3e}, "
        f"fitness {res.fitness:.3f}, scale {res.scale:.5f} (true {s}), "
        f"similarity max|Δ| {err:.3e}, each link's mask holds "
        f"{min(held):.3f}-{max(held):.3f} of its samples, {stray} background "
        f"means in a mask; artifacts {written}; {t_match:.2f} s")
    if not (err <= 5e-3 and min(held) > 0.9 and stray == 0):
        raise AssertionError("the matcher did not recover the similarity "
                             "or the link masks")


if __name__ == "__main__":
    sys.exit(main())
