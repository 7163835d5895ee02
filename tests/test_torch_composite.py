"""The plain versions of kernels K1 and K2 against the reference's Pallas
kernels (interpret mode on the CPU), the wrappers' CPU behaviour, and the
build, load and operators of every kernel (``ops/_kernels.py``).

K1 (``composite_static_plain`` vs ``pallas_composite._call_fwd``): out and
carries atol 2e-5 — float32 on both sides; the reference forms in-chunk
transmittances with a Hillis-Steele product tree and the plain version with
``cumprod``, so they differ in the rounding of products of up to 128 terms.

K2 (``composite_pair_sel_plain`` vs ``composite_pair_sel``) on the selected
rows: atol 5e-5, rtol 1e-4, the bound the reference holds its own selected
-tile kernel to (tests/test_pallas_sel.py), for log-space sums over two
lists.  The inputs cover tiles that skip, tiles cut by counts mid-chunk,
early termination, equal static/dynamic depths, a real slot without
dynamic entries and pad slots.  K2's per-env mode (a (B, T+1, 10, Ks)
static payload, the reference's dense ids) is held to the reference's 4-D
mode at the same bound, and each env's rows to the shared mode run on that
env's payload alone, bit for bit.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_helpers import (
    k1_inputs, k2_inputs, k2_per_env_inputs, np_of,
)

from sim_a_splat_tpu.ops import pallas_composite as jk1
from sim_a_splat_tpu.ops.pallas_composite_sel import composite_pair_sel as jk2

from sim_a_splat_torch.ops import composite, composite_sel
from sim_a_splat_torch.utils import profiling

TS, TX, TY = 16, 3, 2
T = TX * TY


@pytest.mark.parametrize("sigma_cutoff,term_eps", [(3.0, 1e-4), (None, None)])
def test_k1_plain_matches_pallas(sigma_cutoff, term_eps):
    pay, counts, skip = k1_inputs()
    nc = pay.shape[2] // composite.CHUNK
    pmin = None if sigma_cutoff is None else -0.5 * sigma_cutoff**2
    ref_out, ref_car = jk1._call_fwd(jnp.asarray(pay), jnp.asarray(counts),
                                     jnp.asarray(skip), TS, TX, nc, pmin, True,
                                     term_eps)
    out, car, applied, hits = composite.composite_static_plain(
        torch.as_tensor(pay), torch.as_tensor(counts), torch.as_tensor(skip),
        TS, TX, sigma_cutoff, term_eps, return_work=True)
    np.testing.assert_allclose(np_of(out), np_of(ref_out), atol=2e-5)
    np.testing.assert_allclose(np_of(car), np_of(ref_car), atol=2e-5)
    ap = np_of(applied)
    assert ap[5] == 0 and ap[2] == 0          # skipped tile, empty tile
    assert ap[3] == 2                         # cut by its count mid-chunk
    if term_eps is not None:
        assert ap[4] < nc                     # the opaque tile stopped early
    np.testing.assert_array_equal(np_of(out[5, :, 4]), 1.0)
    # composited pairs: none in the skipped and empty tiles; in the tile cut
    # by its count, every entry before the count whose alpha is nonzero
    assert int(hits[5]) == 0 and int(hits[2]) == 0
    px, py = composite.pixel_centers(torch.tensor([3]), TS, TX)
    a3 = composite.entry_alpha(torch.as_tensor(pay[3:4, :, :counts[3]]), px,
                               py, composite.power_min_of(sigma_cutoff))
    assert int(hits[3]) == int((a3 > 0).sum()) > 0


@pytest.mark.parametrize("sigma_cutoff,term_eps", [(3.0, 1e-4), (None, None)])
def test_k2_plain_matches_pallas(sigma_cutoff, term_eps):
    spay, dpay, ids, cs, cd = k2_inputs()
    ref = jk2(jnp.asarray(spay), jnp.asarray(dpay), jnp.asarray(ids),
              jnp.asarray(cs), jnp.asarray(cd), TS, TX, sigma_cutoff, True,
              term_eps, "split", False)
    out, applied, hits = composite_sel.composite_pair_sel_plain(
        *(torch.as_tensor(a) for a in (spay, dpay, ids, cs, cd)), TS, TX,
        sigma_cutoff, term_eps, return_work=True)
    B, TT = ids.shape
    for b in range(B):
        for i in range(TT):
            t = ids[b, i]
            np.testing.assert_allclose(np_of(out[b, t]), np_of(ref[b, t]),
                                       atol=5e-5, rtol=1e-4,
                                       err_msg=f"env {b} slot {i} tile {t}")
    if term_eps is not None:
        assert int(applied[0, 1]) < spay.shape[-1] // 128   # early stop
    # composited pairs: none at pad slots; a real slot without dynamic
    # entries counts its static entries alone (tile 0 is never cut early)
    assert int(hits[0, 3]) == 0 and int(hits[1, 3]) == 0
    px, py = composite.pixel_centers(torch.tensor([0]), TS, TX)
    a0 = composite.entry_alpha(torch.as_tensor(spay[0:1, :, :cs[0]]), px, py,
                               composite.power_min_of(sigma_cutoff))
    assert int(hits[1, 2]) == int((a0 > 0).sum()) > 0
    # equal static / dynamic depths really occur in these lists
    ds = set(spay[0, 8, :cs[0]].tolist())
    assert ds & set(dpay[1, 0, 8, :cd[1, 0]].tolist())


@pytest.mark.parametrize("sigma_cutoff,term_eps", [(3.0, 1e-4), (None, None)])
def test_k2_per_env_plain_matches_pallas(sigma_cutoff, term_eps):
    spay, dpay, ids, cs, cd = k2_per_env_inputs()
    ref = jk2(jnp.asarray(spay), jnp.asarray(dpay), jnp.asarray(ids),
              jnp.asarray(cs), jnp.asarray(cd), TS, TX, sigma_cutoff, True,
              term_eps, "split", False)
    out, applied, hits = composite_sel.composite_pair_sel_plain(
        *(torch.as_tensor(a) for a in (spay, dpay, ids, cs, cd)), TS, TX,
        sigma_cutoff, term_eps, return_work=True)
    assert out.shape == (2, T + 1, 8, TS * TS)
    np.testing.assert_allclose(np_of(out[:, :T]), np_of(ref[:, :T]),
                               atol=5e-5, rtol=1e-4)
    if term_eps is not None:          # env 0's opaque tile 4 stopped early
        assert int(applied[0, 4]) < spay.shape[-1] // 128
        assert int(applied[1, 4]) == 2
    # an empty static list (env 0, tile 2) composites its dynamic list
    # alone; a slot without dynamic entries (env 0, tile 3) its static list
    assert int(applied[0, 2]) == 0 and int(hits[0, 2]) > 0
    px, py = composite.pixel_centers(torch.tensor([3]), TS, TX)
    a0 = composite.entry_alpha(torch.as_tensor(spay[0, 3:4, :, :cs[0, 3]]),
                               px, py, composite.power_min_of(sigma_cutoff))
    assert int(hits[0, 3]) == int((a0 > 0).sum()) > 0
    ds = set(spay[1, 0, 8, :cs[1, 0]].tolist())
    assert ds & set(dpay[1, 0, 8, :cd[1, 0]].tolist())   # depths tie


def test_k2_per_env_rows_equal_shared_mode():
    """Each env's rows of the per-env mode are the shared mode run on that
    env's static payload alone, bit for bit (the plain version, and the
    public wrapper on CPU tensors)."""
    args = [torch.as_tensor(a) for a in k2_per_env_inputs(seed=8)]
    spay, dpay, ids, cs, cd = args
    for fn in (composite_sel.composite_pair_sel_plain,
               composite_sel.composite_pair_sel):
        out = fn(*args, TS, TX, 3.0, 1e-4)
        for b in range(ids.shape[0]):
            one = fn(spay[b], dpay[b:b + 1], ids[b:b + 1], cs[b], cd[b:b + 1],
                     TS, TX, 3.0, 1e-4)
            assert torch.equal(out[b, :T], one[0, :T]), f"env {b}"


def test_wrappers_run_plain_on_cpu():
    pay, counts, skip = k1_inputs(seed=2)
    args = (torch.as_tensor(pay), torch.as_tensor(counts),
            torch.as_tensor(skip), TS, TX, 3.0, 1e-4)
    before = profiling.launches.copy()
    got = composite.composite_static(*args)
    want = composite.composite_static_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert profiling.launches == before        # no kernel on the CPU

    k2 = [torch.as_tensor(a) for a in k2_inputs(seed=3)]
    out = composite_sel.composite_pair_sel(*k2, TS, TX, 3.0, 1e-4)
    ref = composite_sel.composite_pair_sel_plain(*k2, TS, TX, 3.0, 1e-4)
    ids = k2[2]
    for b in range(ids.shape[0]):
        assert torch.equal(out[b, ids[b].long()], ref[b, ids[b].long()])
    assert profiling.launches == before


def test_wrappers_check_inputs():
    spay, dpay, ids, cs, cd = (torch.as_tensor(a) for a in k2_inputs())
    # a per-env payload runs (each env its own copy of the shared lists
    # gives the shared mode's rows); its counts must be per env too
    per_env = spay[None].expand(2, -1, -1, -1)
    out = composite_sel.composite_pair_sel(per_env, dpay, ids,
                                           cs[None].expand(2, -1), cd, TS, TX)
    want = composite_sel.composite_pair_sel(spay, dpay, ids, cs, cd, TS, TX)
    rows = (torch.arange(2)[:, None], ids.long())
    assert torch.equal(out[rows], want[rows])
    with pytest.raises(ValueError, match="counts_s_pad"):
        composite_sel.composite_pair_sel(per_env, dpay, ids, cs, cd, TS, TX)
    with pytest.raises(ValueError, match="ids"):
        composite_sel.composite_pair_sel(per_env[:1], dpay, ids,
                                         cs[None], cd, TS, TX)
    with pytest.raises(ValueError):
        composite_sel.composite_pair_sel(spay, dpay, ids.long(), cs, cd, TS,
                                         TX)
    pay, counts, skip = (torch.as_tensor(a) for a in k1_inputs())
    with pytest.raises(ValueError):
        composite.composite_static(pay.double(), counts, skip, TS, TX)
    with pytest.raises(ValueError):
        composite.composite_static(pay[:, :, :200], counts, skip, TS, TX)


def test_kernel_library_is_keyed_by_source(tmp_path, monkeypatch):
    """The build is cached by a hash of the sources: editing a source (or
    the shared header) names a new library, so it is rebuilt."""
    import shutil
    from sim_a_splat_torch.ops import _kernels

    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC, csrc)
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    first = {n: _kernels._library_path(n) for n in _kernels.KERNEL_SOURCES}
    assert first == {n: _kernels._library_path(n)
                     for n in _kernels.KERNEL_SOURCES}
    (csrc / "composite.cu").write_text(
        (csrc / "composite.cu").read_text() + "\n// edited\n")
    assert _kernels._library_path("composite") != first["composite"]
    assert _kernels._library_path("composite_sel") == first["composite_sel"]
    (csrc / "composite_common.cuh").write_text(
        (csrc / "composite_common.cuh").read_text() + "\n// edited\n")
    assert _kernels._library_path("composite_sel") != first["composite_sel"]


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    from sim_a_splat_torch.ops import _kernels

    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _kernels.nvcc_path()


# every kernel's operator in the library sim_a_splat: its schema, and the
# module that registers it
OPERATORS = {
    "composite_static": (
        "ops.composite", "composite_static(Tensor payload, Tensor counts, "
        "Tensor skip, int ts, int tx, float? sigma_cutoff, float? term_eps) "
        "-> (Tensor, Tensor, Tensor)"),
    "composite_static_bwd": (
        "ops.composite", "composite_static_bwd(Tensor payload, Tensor "
        "counts, Tensor skip, Tensor ct, Tensor out, Tensor carries, Tensor "
        "chunk_acc, int ts, int tx, float? sigma_cutoff, float? term_eps) "
        "-> Tensor"),
    "composite_pair_sel": (
        "ops.composite_sel", "composite_pair_sel(Tensor spay_pad, Tensor "
        "dpay, Tensor ids, Tensor counts_s_pad, Tensor counts_d, int ts, "
        "int tx, float? sigma_cutoff, float? term_eps) -> Tensor"),
    "composite_pair_sel_bwd": (
        "ops.composite_sel", "composite_pair_sel_bwd(Tensor spay_pad, Tensor "
        "dpay, Tensor ids, Tensor counts_s_pad, Tensor counts_d, Tensor ct, "
        "Tensor out, int ts, int tx, float? sigma_cutoff, float? term_eps) "
        "-> (Tensor, Tensor)"),
    "composite_sel_single": (
        "ops.composite_single", "composite_sel_single(Tensor spay_pad, "
        "Tensor ids, Tensor counts_pad, int ts, int tx, float? sigma_cutoff, "
        "float? term_eps, bool save_state) -> Tensor"),
    "composite_sel_single_bwd": (
        "ops.composite_single", "composite_sel_single_bwd(Tensor spay_pad, "
        "Tensor ids, Tensor counts_pad, Tensor ct, Tensor out, int ts, "
        "int tx, float? sigma_cutoff) -> Tensor"),
    "composite_pair": (
        "ops.composite_pair", "composite_pair(Tensor spay, Tensor dpay, "
        "Tensor counts_s, Tensor counts_d, Tensor skip, int ts, int tx, "
        "float? sigma_cutoff, float? term_eps) -> Tensor"),
    "composite_pair_bwd": (
        "ops.composite_pair", "composite_pair_bwd(Tensor spay, Tensor dpay, "
        "Tensor counts_s, Tensor counts_d, Tensor skip, Tensor ct, Tensor "
        "out, int ts, int tx, float? sigma_cutoff, float? term_eps) -> "
        "(Tensor, Tensor)"),
    "pusht_step": (
        "physics.pusht", "pusht_step(Tensor[] state, Tensor? action, "
        "int substeps, int constants) -> Tensor[]"),
    "arm_step": (
        "envs.manipulator_envs", "arm_step(Tensor[] state, Tensor action, "
        "int constants) -> Tensor[]"),
    "reproject_candidates": (
        "ops.rasterize_moving", "reproject_candidates(Tensor mean, Tensor "
        "quat, Tensor log_scales, Tensor opacity, Tensor sh, Tensor cams, "
        "int tx, int ts, int degree, float near, float eps2d) -> (Tensor, "
        "Tensor)"),
}
KERNEL_MODULES = sorted({m for m, _ in OPERATORS.values()})

# imports the kernel modules in the order given, then prints, for every
# operator, its schema and whether CPU tensors found no kernel for it
_OPERATOR_PROBE = """
import importlib, json, sys
import torch
for m in sys.argv[1:]:
    importlib.import_module("sim_a_splat_torch." + m)
out = {}
for name in %r:
    op = getattr(torch.ops.sim_a_splat, name)
    args = []
    for a in op.default._schema.arguments:
        t = str(a.type)
        args.append([torch.zeros(1)] if t == "List[Tensor]" else None
                    if t.startswith("Optional") else torch.zeros(1)
                    if t == "Tensor" else False if t == "bool" else 0)
    try:
        op(*args)
        found = "ran"
    except NotImplementedError as e:
        found = str(e).splitlines()[0]
    out[name] = [str(op.default._schema), found]
print(json.dumps(out))
""" % (list(OPERATORS),)


@pytest.fixture(scope="module")
def operators_by_first_module():
    """{first kernel module: the probe's output}, each kernel module
    imported first (the others after it) in a process of its own."""
    out = {}
    for k, first in enumerate(KERNEL_MODULES):
        order = KERNEL_MODULES[k:] + KERNEL_MODULES[:k]
        run = subprocess.run(
            [sys.executable, "-c", _OPERATOR_PROBE, *order],
            capture_output=True, text=True, check=True, timeout=300,
            cwd=Path(__file__).resolve().parent.parent)
        out[first] = json.loads(run.stdout.splitlines()[-1])
    return out


@pytest.mark.parametrize("name", list(OPERATORS))
def test_each_kernel_is_a_cuda_operator_of_one_library(
        name, operators_by_first_module):
    """Each kernel launches through an operator of the one library
    ``sim_a_splat`` (``ops/_kernels.py``): the operator is registered with
    its schema whichever kernel module is imported first, and has a kernel
    for CUDA alone (CPU tensors find none)."""
    module, schema = OPERATORS[name]
    for first, ops in operators_by_first_module.items():
        got_schema, found = ops[name]
        assert got_schema == "sim_a_splat::" + schema, first
        assert f"'sim_a_splat::{name}'" in found, (first, found)
        assert "'CPU' backend" in found, (first, found)
