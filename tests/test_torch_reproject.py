"""Kernel R1 (``csrc/reproject.cu``), the moving camera's candidate
reprojection, on the CPU.

- Its source up to its CUDA launch function, built for this host by ``g++``
  with no FMA contraction and a shim for the CUDA keywords, run thread by
  thread through the module's own wrapper (``_reproject_kernel``: its
  checks, its camera constants, the operator
  ``sim_a_splat::reproject_candidates``): held to the plain version
  (``_reproject_plain``) on the CPU at the end-effector camera's shapes
  (T = 300, Kc = 512) with its edge cases (``reproject_case_inputs``), for
  SH degrees 0-3, fields as views of one block and each contiguous.  Every
  payload row but the colours, and the key, exactly (NaN where the plain
  version has NaN); the colours within 1e-6, as the kernel sums the
  coefficients in order and the plain version's einsum does not.  Both
  take ``exp`` correctly rounded (through float64): PyTorch's CPU ``exp``
  is not (1 % of these scales differ by an ulp), where on the card the
  kernel's ``expf`` is the one PyTorch's CUDA kernel calls.
- The route: only CUDA inputs that need no gradient, of SH degree ≤ 3, go
  to R1; the wrapper raises on inputs the kernel does not take.
"""

import ctypes
import shutil
import subprocess
import types

import pytest
import torch

from test_torch_helpers import assert_r1_matches_plain, reproject_case_inputs

from sim_a_splat_torch.ops import _kernels
from sim_a_splat_torch.ops import rasterize_moving as trm
from sim_a_splat_torch.ops.projection import Camera
from sim_a_splat_torch.ops.transforms import SE3

# the CUDA keywords of csrc/reproject.cu for a host compiler
_HOST_SHIM = """#pragma once
#include <cmath>
#include <cstring>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define expf(x) ((float)std::exp((double)(x)))
struct Dim { int x, y, z; };
static thread_local Dim blockIdx, threadIdx;
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}
"""
_HOST_LAUNCH = """
extern "C" void launch(ReprojectInputs in, const float* cams, float* payload,
                       float* keys, int B, int T, int Kc, int tx, int ts,
                       int degree, float near, float eps2d) {
  for (int b = 0; b < B; ++b)
    for (int t = 0; t < T; ++t)
      for (int g = 0; g * host::THREADS < Kc; ++g)
        for (int i = 0; i < host::THREADS; ++i) {
          blockIdx = {g, t, b};
          threadIdx = {i, 0, 0};
          switch (degree) {
            case 0: host::reproject_candidates<0>(in, cams, payload, keys,
                        T, Kc, tx, ts, near, eps2d); break;
            case 1: host::reproject_candidates<1>(in, cams, payload, keys,
                        T, Kc, tx, ts, near, eps2d); break;
            case 2: host::reproject_candidates<2>(in, cams, payload, keys,
                        T, Kc, tx, ts, near, eps2d); break;
            case 3: host::reproject_candidates<3>(in, cams, payload, keys,
                        T, Kc, tx, ts, near, eps2d); break;
          }
        }
}
"""


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """``csrc/reproject.cu`` (the source up to its CUDA launch function)
    built for this host by g++ with no FMA contraction."""
    d = tmp_path_factory.mktemp("reproject_host")
    (d / "cuda_runtime.h").write_text(_HOST_SHIM)
    src = (_kernels.CSRC / "reproject.cu").read_text()
    (d / "host.cpp").write_text(
        src[:src.index('extern "C"')].replace("namespace {",
                                              "namespace host {", 1)
        + _HOST_LAUNCH)
    lib_path = d / "libhost.so"
    subprocess.run([shutil.which("g++") or "g++", "-O2", "-std=c++17",
                    "-ffp-contract=off", "-shared", "-fPIC", "-I", str(d),
                    "-o", str(lib_path), str(d / "host.cpp")], check=True)
    fn = ctypes.CDLL(str(lib_path)).launch
    fn.argtypes = trm._R1_ARGS[:-1]
    fn.restype = None
    return fn


class _CorrectExp:
    """``torch`` as the plain version sees it under ``host_kernel``:
    ``exp`` correctly rounded (through float64), the rest ``torch``'s
    own."""

    @staticmethod
    def exp(a):
        return torch.exp(a.double()).float()

    def __getattr__(self, name):
        return getattr(torch, name)


@pytest.fixture
def host_kernel(host_library, monkeypatch):
    """The host-built kernel as the operator's kernel for CPU tensors while
    the test runs, and the plain version's ``exp`` correctly rounded, as
    the host build takes it.  Yields the list of its calls' (B, T, Kc)."""
    monkeypatch.setattr(trm, "torch", _CorrectExp())
    calls = []

    def kernel(mean, quat, log_scales, opacity, sh, cams, tx, ts, degree,
               near, eps2d):
        B, T, _, Kc = mean.shape
        payload = torch.empty((B, T, 10, Kc))
        key = torch.empty((B, T, Kc))
        fields = (mean, quat, log_scales, opacity, sh)
        inputs = trm.ReprojectInputs(*(f.data_ptr() for f in fields),
                                     *(f.stride()[:-1] for f in fields))
        host_library(inputs, cams.data_ptr(), payload.data_ptr(),
                     key.data_ptr(), B, T, Kc, tx, ts, degree, near, eps2d)
        calls.append((B, T, Kc))
        return payload, key

    with torch.library._scoped_library("sim_a_splat", "IMPL") as lib:
        lib.impl("reproject_candidates", kernel, "CPU")
        yield calls


@pytest.mark.parametrize("contiguous", [False, True])
@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_host_built_kernel_matches_plain(host_kernel, degree, contiguous):
    """R1's arithmetic, built for the host, against the plain version on
    2 envs at the end-effector camera's shapes, its edge cases included:
    survivors and keys exact, so K3f's chunks start where they do."""
    cache, cam, cfg = reproject_case_inputs(2, seed=degree,
                                            contiguous=contiguous)
    got = trm._reproject_kernel(cache, cam, degree, cfg)
    want = trm._reproject_plain(cache, cam, degree, cfg)
    assert host_kernel == [(2, 300, 512)]
    gap = assert_r1_matches_plain(got, want)
    print(f"degree {degree}: colours max|Δ| {gap:.3e}")
    # the edge cases are there: NaN conics (overflowing scales), pads,
    # candidates behind the near plane, u on a tile border
    pay = want[0]
    assert bool(torch.isnan(pay[:, :, 2]).any())
    assert bool(((pay[:, :, 8] <= 0.01) & (pay[:, :, 9] == 0)).any())
    assert bool((pay[0, :, 0] == 160.0).any())
    assert 0.2 < float((pay[:, :, 9] > 0).float().mean()) < 0.8


def test_sorted_path_over_the_kernel(host_kernel):
    """``reproject_candidates(sort=True)`` sorts R1's output as it sorts
    the plain version's: the same payload order and counts."""
    cache, cam, cfg = reproject_case_inputs(1, seed=7)
    want_pay, want_counts = trm.reproject_candidates(cache, cam, 3, cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trm, "_on_kernel", lambda *a: True)
        got_pay, got_counts = trm.reproject_candidates(cache, cam, 3, cfg)
    assert host_kernel == [(1, 300, 512)]
    assert torch.equal(got_counts, want_counts)
    rows = [0, 1, 2, 3, 4, 8, 9]
    torch.testing.assert_close(got_pay[:, :, rows], want_pay[:, :, rows],
                               rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got_pay[:, :, 5:8], want_pay[:, :, 5:8],
                               rtol=0, atol=1e-6)


def _card_like(t, requires_grad=None):
    """A stand-in for a CUDA tensor, as far as the route reads one."""
    return types.SimpleNamespace(
        device=torch.device("cuda"),
        requires_grad=t.requires_grad if requires_grad is None
        else requires_grad)


def test_route_takes_the_kernel_only_on_the_card():
    """R1 reprojects inputs on the card that need no gradient, of SH degree
    ≤ 3; a CPU cache, a cache that needs a gradient under grad mode, and
    degree 4 take the plain version."""
    cache, cam, _ = reproject_case_inputs(1, Kc=128)
    card = trm.MovingCache(*map(_card_like, cache))
    card_cam = Camera(SE3(*map(_card_like, cam.pose)),
                      *map(_card_like, (cam.fx, cam.fy, cam.cx, cam.cy)),
                      cam.width, cam.height)
    assert trm._on_kernel(card, card_cam, 3)
    assert trm._on_kernel(card, card_cam, 0)
    assert not trm._on_kernel(card, card_cam, 4)
    assert not trm._on_kernel(cache, cam, 3)
    grad = card._replace(mean=_card_like(cache.mean, requires_grad=True))
    assert not trm._on_kernel(grad, card_cam, 3)
    with torch.no_grad():
        assert trm._on_kernel(grad, card_cam, 3)
    moved = Camera(SE3(card_cam.pose.q, _card_like(cam.pose.t, True)),
                   card_cam.fx, card_cam.fy, card_cam.cx, card_cam.cy,
                   cam.width, cam.height)
    assert not trm._on_kernel(card, moved, 3)


def test_cpu_and_gradient_inputs_run_the_plain_version(host_kernel):
    """On the CPU, with or without a gradient, ``reproject_candidates``
    launches nothing: the operator's (host) kernel is never called."""
    cache, cam, cfg = reproject_case_inputs(1, Kc=128)
    trm.reproject_candidates(cache, cam, 3, cfg)
    mean = cache.mean.clone().requires_grad_()
    pay, _ = trm.reproject_candidates(cache._replace(mean=mean), cam, 3, cfg,
                                      sort=False)
    pay[:, :, 8].sum().backward()
    assert host_kernel == []
    assert mean.grad is not None


@pytest.mark.parametrize("fault", ["float64", "kc_strided", "quat_rows",
                                   "sh_degree", "sh_short", "camera_dtype",
                                   "cameras_count"])
def test_wrapper_rejects_inputs(fault):
    """The kernel's wrapper raises on a type, shape or layout R1 does not
    take, before any launch: a float64 field, a Kc axis that is not
    contiguous, a quaternion with 3 rows, SH degree 4, fewer coefficients
    than the degree needs, float64 cameras, a camera count that is neither
    1 nor B."""
    cache, cam, cfg = reproject_case_inputs(2, Kc=128)
    degree = 3
    if fault == "float64":
        cache = cache._replace(log_scales=cache.log_scales.double())
    elif fault == "kc_strided":
        cache = cache._replace(opacity=torch.zeros(2, 300, 256)[..., ::2])
    elif fault == "quat_rows":
        cache = cache._replace(quat=cache.quat[:, :, :3])
    elif fault == "sh_degree":
        degree = 4
    elif fault == "sh_short":
        cache = cache._replace(sh=cache.sh[:, :, :9])
    elif fault == "camera_dtype":
        cam = Camera(SE3(cam.pose.q.double(), cam.pose.t.double()), cam.fx,
                     cam.fy, cam.cx, cam.cy, cam.width, cam.height)
    else:
        cam = Camera(SE3(cam.pose.q[[0, 1, 0]], cam.pose.t[[0, 1, 0]]),
                     cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height)
    with pytest.raises(ValueError, match="reproject_candidates"):
        trm._reproject_kernel(cache, cam, degree, cfg)
