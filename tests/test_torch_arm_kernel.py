"""The arm's control-step kernel P2 (``csrc/arm_step.cu``), seen from the
CPU (it runs on the card only; its card tests are in
``test_torch_cuda.py``).

- Its source up to its CUDA launch function, built for this host by
  ``g++`` with no FMA contraction and a shim for the CUDA keywords, run
  thread by thread through the env's own wrapper (``_step_kernel``): held
  to ``step_plain`` with ``torch.equal`` on every state field, the reward
  and ``terminated``, and at 1e-5 on the info, for pusharm6, pusharm5 and
  pushscara3 (a prismatic joint), with and without the T-block, on 300
  envs with the end effector in and out of the block, over 20 chained
  steps.  The plain path computes there as it does on the card
  (``card_arithmetic``): sqrt, sin, cos and atan2 correctly rounded (as
  the host build takes them), a tensor divided by a Python scalar as a
  product with the scalar's float32 reciprocal, and each sum over a last
  axis of 3 or 4 in the card's order (read on an H100: (x0 + x2) + x1 and
  (x0 + x2) + (x1 + x3)).  The same steps are held to the JAX
  reference at ``test_torch_arm.py``'s tolerances, the block's contact
  outputs on the envs whose step float32 resolves (a float64 run of the
  plain path as the witness; at most 1 % of the env-steps left out).
- The constants handed to it are the plain path's float32 scalars and
  tensors bit for bit; its caps are the wrapper's; it builds without fast
  math and without FMA contraction.
- The wrapper raises on inputs it does not take; CPU tensors, inputs
  that need a gradient and a chain past the caps take the plain path.
"""

import ctypes
import dataclasses
import inspect
import re
import shutil
import struct
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import arm_case_inputs, arm_chain_past_caps, np_of

from sim_a_splat_tpu.envs import manipulator_envs as jme
from sim_a_splat_tpu.physics import kinematics as jk
from sim_a_splat_torch.envs import manipulator_envs as me
from sim_a_splat_torch.ops import _kernels
from sim_a_splat_torch.ops import quaternion as quat
from sim_a_splat_torch.physics import kinematics as kin
from sim_a_splat_torch.physics import planar
from sim_a_splat_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
ROBOTS = ("pusharm6", "pusharm5", "pushscara3")
B, STEPS = 300, 20
# test_torch_arm.py's tolerances against the reference: the joints, the
# clock and the end effector 1e-5, the block's position and yaw 1e-4, its
# velocities 1e-3, the reward 2e-4, ``terminated`` exact, the info 1e-5 but
# the block's pose 1e-4 and velocity 1e-3; the block's fields (and the
# reward and flags that follow from them) are its contact outputs
ATOL = {"block_pos": 1e-4, "block_yaw": 1e-4, "block_vel": 1e-3,
        "block_omega": 1e-3, "reward": 2e-4, "terminated": 0.0,
        "info.block_pose": 1e-4, "info.block_vel": 1e-3}
CONTACT = tuple(ATOL)
# the share of env-steps whose contact outputs float32 may leave
# unresolved (see _assert_close_to_reference)
UNRESOLVED_SHARE = 0.01


def urdf(name):
    return REPO / "robot_description" / name / "urdf" / f"{name}.urdf"


def envs(name, env_objects, **kw):
    """The port's env and the reference's, alike, on the CPU."""
    port = me.ManipulatorEnvF(chain=kin.load_chain(urdf(name)),
                              eef_link="push_tool", env_objects=env_objects,
                              device="cpu", **kw)
    ref = jme.ManipulatorEnvF(chain=jk.load_chain(urdf(name)),
                              eef_link="push_tool", env_objects=env_objects,
                              **kw)
    return port, ref


# the CUDA keywords of csrc/arm_step.cu for a host compiler, with sinf,
# cosf and atan2f correctly rounded (sqrtf and division are IEEE on both)
_HOST_SHIM = """#pragma once
#include <cmath>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define cosf(x) ((float)std::cos((double)(x)))
#define sinf(x) ((float)std::sin((double)(x)))
#define atan2f(y, x) ((float)std::atan2((double)(y), (double)(x)))
struct Dim { int x; };
static thread_local Dim blockIdx, threadIdx;
using std::isnan;
"""
_HOST_LAUNCH = """
extern "C" void launch(const void* const* in, const long long* stride,
                       void* const* out, int B, ArmConstants c) {
  host::ArmIO io;
  for (int k = 0; k < N_IN; ++k) {
    io.in[k] = (const float*)in[k];
    io.stride[k] = stride[k];
  }
  for (int k = 0; k < N_OUT_F32; ++k) io.out[k] = (float*)out[k];
  for (int k = N_OUT_F32; k < N_OUT; ++k)
    io.flag[k - N_OUT_F32] = (bool*)out[k];
  for (int b = 0; b * host::THREADS < B; ++b)
    for (int t = 0; t < host::THREADS; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      host::arm_step(io, B, c);
    }
}
extern "C" int constants_size() { return (int)sizeof(ArmConstants); }
"""


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """``csrc/arm_step.cu`` (the source up to its CUDA launch function)
    built for this host by g++ with no FMA contraction."""
    d = tmp_path_factory.mktemp("arm_host")
    (d / "cuda_runtime.h").write_text(_HOST_SHIM)
    src = (_kernels.CSRC / "arm_step.cu").read_text()
    (d / "host.cpp").write_text(
        src[:src.index('extern "C"')].replace("namespace {",
                                              "namespace host {", 1)
        + _HOST_LAUNCH)
    lib_path = d / "libhost.so"
    subprocess.run([shutil.which("g++") or "g++", "-O2", "-std=c++17",
                    "-ffp-contract=off", "-shared", "-fPIC", "-I", str(d),
                    "-o", str(lib_path), str(d / "host.cpp")], check=True)
    return ctypes.CDLL(str(lib_path))


@pytest.fixture
def host_kernel(host_library):
    """The env's kernel path (``_step_kernel``: its checks, its constants,
    the operator ``sim_a_splat::arm_step``, the outputs it assembles) with
    the host-built kernel as the operator's kernel for CPU tensors while
    the test runs, each thread run in turn.  Yields the list of its
    calls' batch sizes."""
    fn = host_library.launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                           me.ArmKernelConstants]
    fn.restype = None
    calls = []

    def kernel(state, action, constants):
        c = me.ArmKernelConstants.from_address(constants)
        out, arrays = me.kernel_arguments(state, action, c.ndof)
        fn(*(ctypes.addressof(a) for a in arrays), action.shape[0], c)
        calls.append(action.shape[0])
        return out

    with torch.library._scoped_library("sim_a_splat", "IMPL") as lib:
        lib.impl("arm_step", kernel, "CPU")
        yield calls


class _CardTorch:
    """``torch`` as the port's physics modules see it in
    ``card_arithmetic``: sqrt, sin, cos, atan2 and sum replaced, the rest
    ``torch``'s own."""

    def __init__(self):
        self.sum = self._sum
        for name in ("sqrt", "sin", "cos"):
            f = getattr(torch, name)
            setattr(self, name, lambda a, f=f: f(a.double()).float())
        self.atan2 = lambda y, x: torch.atan2(y.double(),
                                              x.double()).float()

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def _sum(x, dim=None, keepdim=False):
        if dim not in (-1, x.dim() - 1) or x.shape[-1] not in (3, 4):
            return torch.sum(x) if dim is None else \
                torch.sum(x, dim, keepdim=keepdim)
        a = x.unbind(-1)
        s = (a[0] + a[2]) + a[1] if len(a) == 3 else \
            (a[0] + a[2]) + (a[1] + a[3])
        return s.unsqueeze(-1) if keepdim else s


@pytest.fixture
def card_arithmetic(monkeypatch):
    """The plain path computing as it does on the card, where the kernel
    follows it: sqrt, sin, cos and atan2 correctly rounded (through
    float64, as the host-built kernel takes them) and each ``torch.sum``
    over a last axis of 3 or 4 in the order the card's reduction adds
    (elements 0 and 2, then 1, or then 1 and 3), in the port's quaternion,
    kinematics, planar and env modules; and a tensor divided by a Python
    scalar as its product with the scalar's float32 reciprocal (PyTorch's
    CUDA division by a CPU scalar)."""
    card = _CardTorch()
    for mod in (quat, kin, planar, me):
        monkeypatch.setattr(mod, "torch", card)
    div = torch.Tensor.__truediv__

    def card_div(a, b):
        if isinstance(b, float):
            return a * float(np.float32(1.0) / np.float32(b))
        return div(a, b)
    monkeypatch.setattr(torch.Tensor, "__truediv__", card_div)


def _jax_state(s):
    """The reference's batched state of the port's CPU state."""
    arm = jk.ArmState(*(jnp.asarray(np_of(a)) for a in s.arm))
    return jme.ManipulatorState(arm, *(jnp.asarray(np_of(f)) for f in s[1:]))


def _assert_kernel_is_plain(got, want, what):
    """Every state field, the reward and the flags equal; the info within
    1e-5."""
    for name in me.ManipulatorState._fields[1:]:
        assert torch.equal(getattr(got.state, name),
                           getattr(want.state, name)), f"{what}: {name}"
    for name, g, w in zip(("q", "qd", "target_prev"), got.state.arm,
                          want.state.arm):
        assert torch.equal(g, w), f"{what}: {name}"
    for name in ("reward", "terminated", "truncated"):
        assert torch.equal(getattr(got, name), getattr(want, name)), \
            f"{what}: {name}"
    assert list(got.info) == list(want.info)
    for k in want.info:
        torch.testing.assert_close(got.info[k], want.info[k], rtol=0,
                                   atol=1e-5, msg=f"{what}: info {k}")
    for k in want.obs:
        assert torch.equal(got.obs[k], want.obs[k]), f"{what}: obs {k}"


def _fields(tr) -> dict:
    """A transition's compared fields as float64 numpy arrays (B, ·), by
    name (``info.`` before the info's keys)."""
    out = dict(zip(("q", "qd", "target_prev"), tr.state.arm))
    out.update((n, getattr(tr.state, n))
               for n in me.ManipulatorState._fields[1:])
    out.update(reward=tr.reward, terminated=tr.terminated)
    out.update((f"info.{k}", v) for k, v in tr.info.items())
    return {k: np_of(v).astype(np.float64).reshape(len(np_of(v)), -1)
            for k, v in out.items()}


def _assert_close_to_reference(got, ref, exact, what) -> int:
    """The kernel's step ``got`` against the reference's ``ref`` from the
    same state, at ``test_torch_arm.py``'s tolerances (``ATOL``; 1e-5 for
    the rest).  The block's contact outputs (``CONTACT``) are held so on
    every env whose step float32 resolves: where the kernel's and the
    reference's both lie within the tolerance of ``exact``, the plain path
    run in float64 from the same state.  In a deep contact the ten PGS
    sweeps' clamps switch on last-bit differences and both float32
    results stray from float64's (block velocities by up to 0.05 m/s);
    returns the number of envs so left out, which the caller bounds."""
    g, r, x = _fields(got), _fields(ref), _fields(exact)
    assert set(g) == set(r)
    resolved = np.ones(len(g["q"]), bool)
    for k in CONTACT:
        if k in g:
            tol = ATOL[k]
            resolved &= (np.abs(g[k] - x[k]) <= tol).all(1) & \
                (np.abs(r[k] - x[k]) <= tol).all(1)
    for k in g:
        rows = resolved if k in CONTACT else slice(None)
        np.testing.assert_allclose(g[k][rows], r[k][rows],
                                   atol=ATOL.get(k, 1e-5), rtol=0,
                                   err_msg=f"{what}: {k}")
    return int((~resolved).sum())


def _in_float64(state):
    return type(state)(kin.ArmState(*(t.double() for t in state.arm)),
                       *(t.double() for t in state[1:]))


@pytest.mark.parametrize("env_objects", [True, False])
@pytest.mark.parametrize("robot", ROBOTS)
def test_kernel_source_on_the_host_matches_the_plain_path_and_reference(
        robot, env_objects, host_kernel, card_arithmetic):
    """300 envs, the end effector pressing into the block, near it and far
    from it (``arm_case_inputs``), 20 chained steps through the kernel
    (its states carried on; the first from ``reset``'s column slices, read
    through their strides): each step against ``step_plain`` from the same
    state, bit for bit, and against the reference's step."""
    env, jenv = envs(robot, env_objects)
    reset, actions = arm_case_inputs(env, B, STEPS,
                                     np.random.default_rng(len(robot)))
    state, _ = env.reset(reset_to_state=reset, batch=B)
    assert not state.block_pos.is_contiguous()
    jstep = jax.jit(jax.vmap(jenv.step))
    pushed = unresolved = 0
    for k, a in enumerate(actions):
        a = torch.as_tensor(a)
        got = env._step_kernel(state, a)
        _assert_kernel_is_plain(got, env.step_plain(state, a), f"step {k}")
        ref = jstep(_jax_state(state), jnp.asarray(np_of(a)))
        exact = env.step_plain(_in_float64(state), a.double())
        unresolved += _assert_close_to_reference(got, ref, exact,
                                                 f"step {k}")
        pushed = max(pushed, int((got.state.block_vel != 0).any(-1).sum()))
        state = got.state
    print(f"{robot} env_objects={env_objects}: {unresolved} of {B * STEPS} "
          "env-steps not resolved by float32")
    assert unresolved <= UNRESOLVED_SHARE * B * STEPS
    assert host_kernel == [B] * STEPS
    if env_objects:
        assert 0 < pushed <= 2 * B // 3           # in and out of contact
        assert bool(got.terminated[2 * B // 3:].all())
    assert bool(got.terminated.all()) != env_objects


def test_kernel_source_with_other_task_settings(host_kernel,
                                                card_arithmetic):
    """A welded pushscara3 with every scalar of the task changed (three
    contact substeps, whose fractions are not dyadic) against
    ``step_plain``, bit for bit, over 10 chained steps."""
    env, _ = envs("pushscara3", True, weld=((0.9659258, 0.0, 0.0, 0.258819),
                                            (0.1, -0.2, 0.05)),
                  time_step=2e-2, kp=60.0, kd=15.0, eef_radius=0.02,
                  contact_substeps=3, contact_bias=0.3, contact_slop=2e-4)
    reset, actions = arm_case_inputs(env, 96, 10, np.random.default_rng(3))
    state, _ = env.reset(reset_to_state=reset, batch=96)
    for k, a in enumerate(actions):
        a = torch.as_tensor(a)
        got = env._step_kernel(state, a)
        _assert_kernel_is_plain(got, env.step_plain(state, a), f"step {k}")
        state = got.state
    assert bool((state.block_vel != 0).any())


def test_host_constants_block_is_the_wrappers(host_library):
    """The kernel's ``ArmConstants`` and the wrapper's ctypes mirror have
    one size, and the caps are the source's."""
    assert host_library.constants_size() == \
        ctypes.sizeof(me.ArmKernelConstants)
    src = (_kernels.CSRC / "arm_step.cu").read_text()
    caps = dict(re.findall(r"constexpr int (ARM_MAX_\w+) = (\d+);", src))
    assert (int(caps["ARM_MAX_LINKS"]), int(caps["ARM_MAX_DOF"])) == \
        (me.ARM_MAX_LINKS, me.ARM_MAX_DOF)


def _f32_bits(x) -> bytes:
    """The float32 a Python scalar becomes as an operand of a float32
    tensor, as bytes."""
    return (torch.ones((), dtype=torch.float32) * x).numpy().tobytes()


@pytest.mark.parametrize("case", ["default", "welded_custom"])
def test_arm_kernel_constants_are_the_plain_paths_float32(case,
                                                          monkeypatch):
    """The constant block handed to the kernel holds, bit for bit, the
    float32 values the plain path computes with: the scalars it hands
    ``arm_step``, ``circle_poly_contact`` and ``solve_contacts`` and
    computes itself, its chain tensors and its constant tensors."""
    kw = {} if case == "default" else dict(
        weld=((0.9659258, 0.0, 0.0, 0.258819), (0.1, -0.2, 0.05)),
        time_step=2e-2, kp=60.0, kd=15.0, eef_radius=0.02,
        contact_substeps=3, contact_bias=0.3, contact_slop=2e-4)
    robot = "pusharm6" if case == "default" else "pushscara3"
    env, _ = envs(robot, True, **kw)
    seen = {}
    arm_step, contact, solve = (kin.arm_step, planar.circle_poly_contact,
                                planar.solve_contacts)

    def arm_spy(chain, state, target, **k):
        seen.update(arm=k)
        return arm_step(chain, state, target, **k)

    def contact_spy(center, radius, poly, other_vel, friction):
        seen.update(radius=radius, mu=friction)
        return contact(center, radius, poly, other_vel, friction)

    def solve_spy(body, contacts, inv_mass, inv_inertia, dt, iterations,
                  bias, slop):
        seen.update(inv_mass=inv_mass, inv_inertia=inv_inertia, dt=dt,
                    iterations=iterations, bias_rate=bias / dt, slop=slop)
        return solve(body, contacts, inv_mass, inv_inertia, dt,
                     iterations=iterations, bias=bias, slop=slop)
    monkeypatch.setattr(me.kin, "arm_step", arm_spy)
    monkeypatch.setattr(me.planar, "circle_poly_contact", contact_spy)
    monkeypatch.setattr(me.planar, "solve_contacts", solve_spy)
    reset, actions = arm_case_inputs(env, 4, 1, np.random.default_rng(0))
    state, _ = env.reset(reset_to_state=reset, batch=4)
    env.step_plain(state, torch.as_tensor(actions[0]))
    monkeypatch.undo()

    c = env.kernel_constants()
    substeps = inspect.signature(kin.arm_step).parameters["substeps"]
    pd = seen["arm"]
    scalars = dict(kp=pd["kp"], kd=pd["kd"], dt=pd["dt"],
                   pd_h=pd["dt"] / substeps.default,
                   radius=seen["radius"], mu=seen["mu"],
                   inv_mass=seen["inv_mass"], inv_inertia=seen["inv_inertia"],
                   bias_rate=seen["bias_rate"], slop=seen["slop"],
                   contact_h=seen["dt"], done_below=0.02)
    for name, x in scalars.items():
        assert struct.pack("f", getattr(c, name)) == _f32_bits(x), name
    # the card's division by the scalar dt: times float32(1) / float32(dt)
    assert np.float32(c.inv_dt) == np.float32(1.0) / np.float32(pd["dt"])
    assert (c.pd_substeps, c.iterations, c.contact_substeps) == (
        substeps.default, seen["iterations"], env.contact_substeps)
    assert (c.num_links, c.ndof, c.eef, c.env_objects) == (
        env.chain.num_links, env.chain.ndof,
        env.chain.link_index(env.eef_link), 1)
    L, D = env.chain.num_links, env.chain.ndof
    for name, a in (("parent", env.chain.parent), ("jtype", env.chain.jtype),
                    ("qidx", env.chain.qidx)):
        assert list(getattr(c, name))[:L] == a.tolist(), name
    tensors = kin.chain_tensors(env.chain, torch.device("cpu"))
    for name in ("origin_q", "origin_t", "axis", "lo", "hi", "vmax"):
        a = tensors[name].numpy().ravel()
        assert np.asarray(getattr(c, name), np.float32)[:a.size].tobytes() \
            == a.tobytes(), name
    consts = env._consts(torch.device("cpu"))
    for name, t in (("weld_q", consts["base"].q), ("weld_t", consts["base"].t),
                    ("polys", consts["polys"]), ("cog", consts["cog"])):
        assert np.asarray(getattr(c, name), np.float32).tobytes() == \
            t.numpy().tobytes(), name


def test_arm_step_builds_without_fast_math():
    """``arm_step`` is one of the kernel sources; nvcc builds it with no
    fast math and no FMA contraction, and the source calls no fast
    intrinsic."""
    assert "arm_step" in _kernels.KERNEL_SOURCES
    flags = _kernels.flags("arm_step")
    assert "-fmad=false" in flags
    assert not [f for f in flags if re.search(
        r"fast.math|ftz=true|prec-(div|sqrt)=false|fmad=true", f)]
    src = (_kernels.CSRC / "arm_step.cu").read_text()
    assert not re.search(
        r"__(fdividef|sinf|cosf|expf|fsqrt|fmaf|fma_r|atan2f)", src)
    assert _kernels._library_path("arm_step").name.startswith(
        "libarm_step_")


def _cpu_inputs(robot="pusharm6", B=8):
    env, _ = envs(robot, True)
    reset, actions = arm_case_inputs(env, B, 1, np.random.default_rng(1))
    state, _ = env.reset(reset_to_state=reset, batch=B)
    return env, state, torch.as_tensor(actions[0])


@pytest.mark.parametrize("bad,match", [
    ("float64", "float64"), ("non-contiguous", "non-contiguous"),
    ("shape", r"\(8, 1\)"), ("links", "at most 8 links"),
    ("joints", "6 joints")])
def test_kernel_wrapper_rejects_inputs(bad, match):
    """The kernel's wrapper raises, before any launch, on inputs it does
    not take: not float32, a row whose elements are not adjacent, a wrong
    shape, a chain past the kernel's caps.  A stride-0 action (an expanded
    row) and column slices are rows it reads."""
    env, state, action = _cpu_inputs()
    if bad == "float64":
        action = action.double()
    elif bad == "non-contiguous":
        state = state._replace(arm=state.arm._replace(
            qd=state.arm.qd.t().contiguous().t()))
    elif bad == "shape":
        state = state._replace(block_yaw=state.block_yaw[:, None])
    elif bad == "links":
        env = dataclasses.replace(env, chain=dataclasses.replace(
            env.chain, link_names=env.chain.link_names + ("extra",)))
    else:
        env = dataclasses.replace(env, chain=dataclasses.replace(
            env.chain, lower=np.zeros(7, np.float32)))
    with pytest.raises(ValueError, match=match):
        env._step_kernel(state, action)
    # what it does take goes on to the operator, which has no CPU kernel
    env, state, action = _cpu_inputs()
    with pytest.raises(NotImplementedError, match="CPU"):
        env._step_kernel(state, action[:1].expand(8, -1))


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_and_gradient_inputs_take_the_plain_path(grad):
    """On CPU tensors nothing launches: ``step`` is ``step_plain`` bit for
    bit, and the launch count stays where it was; an action that needs a
    gradient gets the plain path's."""
    before = profiling.launches.copy()
    env, state, action = _cpu_inputs()
    a1 = action.clone().requires_grad_(grad)
    a2 = action.clone().requires_grad_(grad)
    got, want = env.step(state, a1), env.step_plain(state, a2)
    _assert_kernel_is_plain(got, want, "cpu")
    for k in want.info:
        assert torch.equal(got.info[k], want.info[k]), k
    if grad:
        (g1,) = torch.autograd.grad(got.state.block_pos.sum(), a1)
        (g2,) = torch.autograd.grad(want.state.block_pos.sum(), a2)
        assert torch.equal(g1, g2) and bool(g1.abs().sum() > 0)
    assert profiling.launches == before


def _card_like(t):
    """A stand-in for ``t`` on a CUDA device, for the dispatch decision."""
    return types.SimpleNamespace(device=torch.device("cuda"),
                                 requires_grad=t.requires_grad)


@pytest.mark.parametrize("chain", ["pusharm6", "links", "joints"])
def test_the_kernel_takes_chains_within_its_caps(chain, tmp_path):
    """``step`` sends inputs on the card to the kernel only for a chain
    within its caps (``ARM_MAX_LINKS``, ``ARM_MAX_DOF``): a 9th link or a
    7th joint takes ``step_plain``, as on the CPU."""
    env, state, action = _cpu_inputs()
    if chain != "pusharm6":
        env = dataclasses.replace(env,
                                  chain=arm_chain_past_caps(chain, tmp_path))
    card = me.ManipulatorState(
        kin.ArmState(*map(_card_like, state.arm)),
        *map(_card_like, state[1:]))
    assert env._on_kernel(card, _card_like(action)) == (chain == "pusharm6")
    assert not env._on_kernel(state, action)
