"""Port's batched pushT physics against the JAX reference.

States along the committed Chipmunk golden trajectories
(``tests/assets/pusht_goldens.npz``) are taken from the reference, and one
batched port ``control_step`` from each is compared with
``jax.vmap(pusht.control_step)``: positions atol 1e-3, angle atol 1e-4
(10 substeps × 10 float32 PGS sweeps; the two libraries differ in the last
bit of sin/cos and in fused multiply-adds, which contacts amplify).

The card's kernel ``csrc/pusht_step.cu`` (it runs on the card only; its
tests are in ``test_torch_cuda.py``): CPU tensors take the plain path and
launch nothing, the constants handed to it are the plain path's float32
scalars bit for bit, it builds without fast math and without FMA
contraction, and its source, built for this host by ``g++`` with a shim
for the CUDA keywords and run thread by thread, steps the envs exactly as
the plain path does where both take sqrt, sin and cos correctly rounded.
"""

import ctypes
import pathlib
import re
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import (
    PUSHT_EDGE_CASES, jax_pusht_states, np_of, pusht_case_actions,
    pusht_case_vectors,
)

from sim_a_splat_tpu.physics import pusht as jpusht
from sim_a_splat_torch.ops import _kernels
from sim_a_splat_torch.physics import planar, pusht
from sim_a_splat_torch.utils import profiling

GOLDENS = np.load(pathlib.Path(__file__).parent / "assets" / "pusht_goldens.npz")
TRAJ = ("push_stem", "rotate_crossbar", "wall_pin", "legacy_push")
STEPS = (0, 5, 10, 15)


def _golden_states(names, block_cog=None):
    """Reference states at ``STEPS`` of each trajectory, with the action
    taken there: (stacked JAX state, (K, 2) actions)."""
    P = jpusht.PushTParams(block_cog=block_cog)
    step = jax.jit(lambda s, a: jpusht.control_step(P, s, a))
    states, actions = [], []
    for name in names:
        start = GOLDENS[f"{name}/start"]
        acts = GOLDENS[f"{name}/actions"]
        s, _ = jax_pusht_states(start[None],
                                legacy=bool(GOLDENS[f"{name}/legacy"]),
                                block_cog=block_cog)
        s = jax.tree.map(lambda a: a[0], s)
        for k in range(min(max(STEPS) + 1, len(acts))):
            if k in STEPS:
                states.append(s)
                actions.append(acts[k])
            s = step(s, jnp.asarray(acts[k]))
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *states)
    return stacked, np.asarray(actions, np.float32), P


@pytest.mark.parametrize("case", ["standard", "cog_override"])
def test_control_step_batched_matches_reference(case):
    if case == "standard":
        jstates, actions, jP = _golden_states(TRAJ)
        P = pusht.PushTParams()
    else:
        cog = tuple(float(c) for c in GOLDENS["cog_override/block_cog"])
        jstates, actions, jP = _golden_states(["cog_override"], cog)
        P = pusht.PushTParams(block_cog=cog)
    ref = jax.vmap(lambda s, a: jpusht.control_step(jP, s, a))(
        jstates, jnp.asarray(actions))
    mine = pusht.control_step(P, _port_state(jstates),
                              torch.as_tensor(actions))
    _assert_step_close(mine, ref)


def _port_state(jstates):
    """The port's CPU state of a batched JAX state."""
    return pusht.state_from_numpy({k: np_of(v) for k, v in
                                   jstates._asdict().items()}, device="cpu")


def _assert_step_close(mine, ref):
    """A port control step against the reference's: positions and
    velocities atol 1e-3, angle 1e-4, ``n_contacts`` exact; the contacts
    exercised."""
    assert int(np_of(ref.n_contacts).sum()) > 0
    for name in ("agent_pos", "agent_vel", "block_pos", "block_vel",
                 "block_omega"):
        np.testing.assert_allclose(np_of(getattr(mine, name)),
                                   np_of(getattr(ref, name)), atol=1e-3,
                                   err_msg=name)
    np.testing.assert_allclose(np_of(mine.block_angle),
                               np_of(ref.block_angle), atol=1e-4)
    np.testing.assert_array_equal(np_of(mine.n_contacts),
                                  np_of(ref.n_contacts))


@pytest.mark.parametrize("case", ["standard", "cog_override"])
def test_set_state_matches_reference(case):
    rng = np.random.default_rng(5)
    vec = np.stack([rng.integers(50, 248, 6), rng.integers(50, 462, 6),
                    rng.integers(100, 198, 6), rng.integers(100, 412, 6),
                    rng.uniform(-4, 4, 6)], 1).astype(np.float32)
    cog = None
    if case == "cog_override":
        cog = tuple(float(c) for c in GOLDENS["cog_override/block_cog"])
    _, ref = jax_pusht_states(vec, block_cog=cog)
    mine = pusht.set_state(pusht.PushTParams(block_cog=cog),
                           torch.as_tensor(vec))
    for name, r in ref.items():
        np.testing.assert_allclose(np_of(getattr(mine, name)), r, atol=1e-4,
                                   err_msg=name)


def test_reset_uses_generator():
    P = pusht.PushTParams()
    a = pusht.reset(P, torch.Generator().manual_seed(3), 16)
    b = pusht.reset(P, torch.Generator().manual_seed(3), 16)
    c = pusht.reset(P, torch.Generator().manual_seed(4), 16)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.block_pos, c.block_pos)
    assert a.agent_pos.shape == (16, 2) and a.block_angle.shape == (16,)
    assert torch.all((a.agent_pos >= 40) & (a.agent_pos <= 470))


# --- the card's kernel, seen from the CPU -----------------------------------

PARAMS = {"default": {}, "cog_override": dict(block_cog=(3.0, 40.0)),
          "friction_damping": dict(friction=0.5, damping=0.9),
          "bias_mass": dict(bias=0.3, mass=2.5, slop=0.25)}


def _states(P, B, seed):
    rng = np.random.default_rng(seed)
    vec = pusht_case_vectors(rng, B)
    return (pusht.set_state(P, torch.as_tensor(vec)),
            torch.as_tensor(pusht_case_actions(rng, vec)))


@pytest.mark.parametrize("call", ["control_step", "set_state"])
def test_cpu_tensors_take_the_plain_path(call, monkeypatch):
    """On CPU tensors nothing launches: the results are the plain path's,
    bit for bit, and the launch count stays where it was."""
    P = pusht.PushTParams()
    before = profiling.launches.copy()
    states, actions = _states(P, 16, seed=1)
    if call == "control_step":
        got = pusht.control_step(P, states, actions)
        want = pusht.control_step_plain(P, states, actions)
    else:
        vec = torch.as_tensor(pusht_case_vectors(np.random.default_rng(2),
                                                 16))
        got = pusht.set_state(P, vec, legacy=True)
        monkeypatch.setattr(pusht, "substep", pusht.substep_plain)
        want = pusht.set_state(P, vec, legacy=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert profiling.launches == before


def _f32_bits(x) -> bytes:
    """The float32 a Python scalar becomes as an operand of a float32
    tensor, as bytes."""
    return (torch.ones((), dtype=torch.float32) * x).numpy().tobytes()


@pytest.mark.parametrize("case", list(PARAMS))
def test_kernel_constants_are_the_plain_paths_float32(case, monkeypatch):
    """The constant block handed to the kernel holds, bit for bit, the
    float32 values the plain path computes with: the scalars it passes to
    ``solve_contacts`` and uses itself, and its constant tensors."""
    P = pusht.PushTParams(**PARAMS[case])
    seen = {}

    def spy(body, contacts, inv_mass, inv_inertia, dt, iterations, bias,
            slop):
        seen.update(inv_mass=inv_mass, inv_inertia=inv_inertia, dt=dt,
                    iterations=iterations, bias_rate=bias / dt, slop=slop,
                    friction=contacts.friction)
        return planar.solve_contacts(body, contacts, inv_mass, inv_inertia,
                                     dt, iterations=iterations, bias=bias,
                                     slop=slop)
    monkeypatch.setattr(pusht, "solve_contacts", spy)
    states, actions = _states(P, 4, seed=3)
    pusht.substep_plain(P, states, actions)
    c = pusht.kernel_constants(P)
    scalars = dict(inv_mass=seen["inv_mass"],
                   inv_inertia=seen["inv_inertia"], dt=seen["dt"],
                   bias_rate=seen["bias_rate"], slop=seen["slop"],
                   k_p=P.k_p, k_v=P.k_v, radius=P.agent_radius,
                   damp=P.damping ** P.dt if P.damping > 0 else 0.0)
    for name, x in scalars.items():
        assert struct.pack("f", getattr(c, name)) == _f32_bits(x), name
    # friction: the agent's slots carry the parameter, the walls' 0
    assert struct.pack("f", c.friction) == \
        seen["friction"][0, 0].numpy().tobytes()
    assert not seen["friction"][:, 2:].any()
    assert c.iterations == seen["iterations"] == P.solver_iters
    tensors = pusht._constants(P, torch.device("cpu"))
    for name in ("polys", "cog", "wall_n", "wall_b"):
        assert np.asarray(getattr(c, name), np.float32).tobytes() == \
            tensors[name].numpy().tobytes(), name


def test_pusht_step_builds_without_fast_math():
    """``pusht_step`` is one of the kernel sources; nvcc builds it with no
    fast math and no FMA contraction, and the source calls no fast
    intrinsic."""
    assert "pusht_step" in _kernels.KERNEL_SOURCES
    flags = _kernels.flags("pusht_step")
    assert "-fmad=false" in flags
    assert not [f for f in flags if re.search(
        r"fast.math|ftz=true|prec-(div|sqrt)=false|fmad=true", f)]
    src = (_kernels.CSRC / "pusht_step.cu").read_text()
    assert not re.search(r"__(fdividef|sinf|cosf|expf|fsqrt|fmaf|fma_r)",
                         src)
    assert _kernels._library_path("pusht_step").name.startswith(
        "libpusht_step_")


@pytest.mark.parametrize("bad,match", [("float64", "float64"),
                                       ("non-contiguous", "non-contiguous"),
                                       ("shape", r"\(4, 1\)")])
def test_kernel_wrapper_rejects_inputs(bad, match):
    """The kernel's wrapper raises, before any launch, on inputs it does
    not take."""
    P = pusht.PushTParams()
    states, actions = _states(P, 4, seed=4)
    if bad == "float64":
        actions = actions.double()
    elif bad == "non-contiguous":
        actions = actions[:1].expand(4, 2)
    else:
        states = states._replace(block_angle=states.block_angle[:, None])
    with pytest.raises(ValueError, match=match):
        pusht._step_kernel(P, states, actions, P.substeps)


# the CUDA keywords of csrc/pusht_step.cu for a host compiler, with sinf
# and cosf correctly rounded (sqrtf and division are IEEE on both)
_HOST_SHIM = """#pragma once
#include <cmath>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define cosf(x) ((float)std::cos((double)(x)))
#define sinf(x) ((float)std::sin((double)(x)))
struct Dim { int x; };
static thread_local Dim blockIdx, threadIdx;
using std::isnan;
"""
_HOST_LAUNCH = """
extern "C" void launch(const float* const* in, float* const* out, int B,
                       int substeps, int has_action, PushTConstants c) {
  for (int b = 0; b * host::THREADS < B; ++b)
    for (int t = 0; t < host::THREADS; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      host::pusht_step(in[0], in[1], in[2], in[3], in[4], in[5], in[6],
                       out[0], out[1], out[2], out[3], out[4], out[5],
                       out[6], B, substeps, has_action, c);
    }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``csrc/pusht_step.cu``'s kernel (the source up to its CUDA launch
    function) built for this host by g++ with no FMA contraction, each
    thread run in turn: a function of (params, state, action or None,
    substeps) → state."""
    d = tmp_path_factory.mktemp("pusht_host")
    (d / "cuda_runtime.h").write_text(_HOST_SHIM)
    src = (_kernels.CSRC / "pusht_step.cu").read_text()
    (d / "host.cpp").write_text(
        src[:src.index('extern "C"')].replace("namespace {",
                                              "namespace host {", 1)
        + _HOST_LAUNCH)
    lib_path = d / "libhost.so"
    subprocess.run([shutil.which("g++") or "g++", "-O2", "-std=c++17",
                    "-ffp-contract=off", "-shared", "-fPIC", "-I", str(d),
                    "-o", str(lib_path), str(d / "host.cpp")], check=True)
    fn = ctypes.CDLL(str(lib_path)).launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + \
        [pusht.KernelConstants]
    fn.restype = None

    def run(P, state, action, substeps):
        ins = [t.contiguous() for t in state[:-1]] + [
            torch.zeros(1) if action is None else action.contiguous()]
        outs = [torch.empty_like(t) for t in state]
        ptrs = [(ctypes.c_void_p * 7)(*(t.data_ptr() for t in ins)),
                (ctypes.c_void_p * 7)(*(t.data_ptr() for t in outs))]
        fn(ctypes.addressof(ptrs[0]), ctypes.addressof(ptrs[1]),
           state.agent_pos.shape[0], substeps, int(action is not None),
           pusht.kernel_constants(P))
        return pusht.PushTState(*outs)
    return run


@pytest.fixture
def rounded_math(monkeypatch):
    """The plain path with sqrt, sin and cos correctly rounded (through
    float64), as the host-built kernel takes them."""
    for name in ("sqrt", "sin", "cos"):
        f = getattr(torch, name)
        monkeypatch.setattr(torch, name,
                            lambda a, f=f: f(a.double()).float())


@pytest.mark.parametrize("case", list(PARAMS))
def test_kernel_source_on_the_host_matches_the_plain_path(
        case, host_kernel, rounded_math):
    """The kernel's source, run on this host, against the plain path on
    1,000 envs (the contacts' edge cases first, B not a multiple of 32):
    the control step and ``set_state``'s settling substep, value for
    value."""
    P = pusht.PushTParams(**PARAMS[case])
    B = 1000
    vec = torch.as_tensor(pusht_case_vectors(np.random.default_rng(9), B))
    settled = pusht.set_state(P, vec)
    zero2, zero = torch.zeros(B, 2), torch.zeros(B)
    start = pusht.PushTState(vec[:, :2], zero2, vec[:, 2:4], vec[:, 4],
                             zero2, zero, zero)
    got = host_kernel(P, start, None, 1)
    for name, g, w in zip(pusht.PushTState._fields, got, settled):
        assert torch.equal(g, w), f"set_state {name}"
    actions = torch.as_tensor(pusht_case_actions(np.random.default_rng(10),
                                                 np_of(vec)))
    want = pusht.control_step_plain(P, settled, actions)
    got = host_kernel(P, settled, actions, P.substeps)
    assert int(want.n_contacts.sum()) > 0
    for name, g, w in zip(pusht.PushTState._fields, got, want):
        assert torch.equal(g, w), f"control_step {name}"


@pytest.mark.parametrize("case", ["goldens", "edge_cases",
                                  "edge_cases_set_state"])
def test_kernel_source_on_the_host_matches_the_reference(case, host_kernel):
    """The kernel's source, run on this host, against the JAX reference on
    the same inputs: a control step from the golden trajectories' states
    and from the contacts' edge cases (settled by the reference; pushes
    and free targets), at the physics tolerances, and ``set_state``'s
    settling substep of the edge cases at the ``set_state`` test's 1e-4."""
    P = pusht.PushTParams()
    if case == "goldens":
        jstates, actions, jP = _golden_states(TRAJ)
    else:
        jP = jpusht.PushTParams()
        jstates, settled = jax_pusht_states(PUSHT_EDGE_CASES)
        actions = pusht_case_actions(np.random.default_rng(11),
                                     PUSHT_EDGE_CASES)
    if case == "edge_cases_set_state":
        vec = torch.as_tensor(PUSHT_EDGE_CASES)
        B = len(vec)
        zero2, zero = torch.zeros(B, 2), torch.zeros(B)
        start = pusht.PushTState(vec[:, :2], zero2, vec[:, 2:4], vec[:, 4],
                                 zero2, zero, zero)
        got = host_kernel(P, start, None, 1)
        for name, r in settled.items():
            g = np_of(getattr(got, name))
            print(f"set_state {name} max|d| {np.abs(g - r).max():.3g}")
            np.testing.assert_allclose(g, r, atol=1e-4, err_msg=name)
        return
    ref = jax.vmap(lambda s, a: jpusht.control_step(jP, s, a))(
        jstates, jnp.asarray(actions))
    got = host_kernel(P, _port_state(jstates), torch.as_tensor(actions),
                      P.substeps)
    for name, g, r in zip(pusht.PushTState._fields, got, ref):
        print(f"{name} max|d| {np.abs(np_of(g) - np_of(r)).max():.3g}")
    _assert_step_close(got, ref)
