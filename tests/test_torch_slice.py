"""The port's batched pushT step against the JAX reference, end to end.

``sim_a_splat_torch.entry.make_step_cached_batch`` (device="cpu", plain
kernel versions) and ``__graft_entry__._make_step_cached_batch`` (Pallas in
interpret mode) run on the same numpy scene, states and actions.  Images
agree within atol 5e-5: both sides are float32, but the reference composites
with log-space / cumulative-product transmittances and the port's plain
versions with their own product order, and the 3σ and ALPHA_MIN cut-offs
are discontinuous, so the comparison is held at float32 rounding of
products of up to a few hundred terms.  The truncation counters must match
exactly.
"""

import ast
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import (
    graph_leaves, jax_pusht_states, jax_raster, np_of, random_state_vectors,
    torch_raster,
)

import __graft_entry__ as graft
from sim_a_splat_torch import entry
from sim_a_splat_torch.physics import pusht
from sim_a_splat_torch.viewer import scene_render_fn

ROOT = pathlib.Path(__file__).resolve().parent.parent
W = H = 64
STEP_KW = dict(dyn_capacity=128, sel_tiles=8, dyn_max_tiles=9)


def test_build_scene_matches_reference():
    ref = graph_leaves(graft._build_scene(n_bg=256, n_block=64, n_agent=32,
                                          seed=3, sh_degree=3))
    mine = entry.build_scene_numpy(n_bg=256, n_block=64, n_agent=32, seed=3,
                                   sh_degree=3)
    assert set(ref) == set(mine)
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)


def _run_both(graph, vectors, actions):
    jstates, snp = jax_pusht_states(vectors)
    jprep, jstep, _ = graft._make_step_cached_batch(
        graph, W, H, jax_raster(), **STEP_KW)
    jns, jimgs, jdrop = jax.jit(
        lambda sc, s, a: jstep(jprep(sc), sc, s, a))(
            graph.scene, jstates, jnp.asarray(actions))

    g = entry.graph_from_numpy(graph_leaves(graph), device="cpu")
    prep, step, _ = entry.make_step_cached_batch(
        g, W, H, torch_raster(), device="cpu", **STEP_KW)
    ns, imgs, drop = step(prep(g.scene), g.scene,
                          pusht.state_from_numpy(snp, device="cpu"),
                          torch.as_tensor(actions))
    return (jns, jimgs, jdrop), (ns, imgs, drop)


@pytest.mark.parametrize("seed", [0, 1])
def test_step_matches_reference(seed):
    rng = np.random.default_rng(seed)
    graph = graft._build_scene(n_bg=256, n_block=64, n_agent=32, seed=seed,
                               sh_degree=3)
    B = 3
    vectors = random_state_vectors(rng, B)
    # push each agent toward its block so contacts happen
    actions = (vectors[:, 2:4] + rng.normal(0, 10, (B, 2))).astype(np.float32)
    (jns, jimgs, jdrop), (ns, imgs, drop) = _run_both(graph, vectors, actions)

    assert imgs.shape == (B, 3, H, W)
    np.testing.assert_array_equal(np_of(drop), np_of(jdrop))
    assert int(drop[0]) == 0          # the comparison is of exact renders
    for name in ("agent_pos", "block_pos", "agent_vel", "block_vel"):
        np.testing.assert_allclose(np_of(getattr(ns, name)),
                                   np_of(getattr(jns, name)), atol=1e-3,
                                   err_msg=name)
    np.testing.assert_allclose(np_of(ns.block_angle), np_of(jns.block_angle),
                               atol=1e-4)
    np.testing.assert_array_equal(np_of(ns.n_contacts), np_of(jns.n_contacts))
    np.testing.assert_allclose(np_of(imgs), np_of(jimgs), atol=5e-5)


@pytest.mark.parametrize("entry_point", ["make_step_cached_batch",
                                         "build_scene", "state_from_numpy",
                                         "make_step_moving_cached",
                                         "make_step_moving",
                                         "make_step_cached",
                                         "dryrun_multichip", "bench_mesh",
                                         "scaling_inputs",
                                         "scene_render_fn"])
def test_cuda_without_card_raises(entry_point):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the no-card refusal")
    g = entry.build_scene(64, 32, 16, device="cpu")
    calls = {
        "make_step_cached_batch": lambda: entry.make_step_cached_batch(
            g, W, H, torch_raster()),
        "make_step_moving_cached": lambda: entry.make_step_moving_cached(
            g, W, H, torch_raster()),
        "make_step_moving": lambda: entry.make_step_moving(
            g, W, H, torch_raster()),
        "make_step_cached": lambda: entry.make_step_cached(
            g, W, H, torch_raster()),
        "build_scene": lambda: entry.build_scene(64, 32, 16),
        "state_from_numpy": lambda: pusht.state_from_numpy(
            [np.zeros((2, 2))] * 4 + [np.zeros(2)] * 3),
        "dryrun_multichip": lambda: entry.dryrun_multichip(2),
        "bench_mesh": lambda: entry.bench_mesh(1),
        "scaling_inputs": lambda: entry.scaling_inputs(2, 500, 32),
        "scene_render_fn": lambda: scene_render_fn(g.scene),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry_point]()          # each defaults to device="cuda"


@pytest.mark.parametrize("script,needs", [("chip_smoke.py", "CUDA device"),
                                          ("chip_scaling.py",
                                           "two CUDA devices"),
                                          ("chip_trace.py", "CUDA device")])
def test_card_scripts_refuse_without_cards(script, needs):
    """Each card script, run as a user runs it, exits non-zero and prints
    no result where the cards it needs are missing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the no-card refusal")
    out = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert needs in out.stderr


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither JAX nor the
    reference package (checked in a fresh interpreter)."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import sim_a_splat_torch
        mods = [m.name for m in pkgutil.walk_packages(
            sim_a_splat_torch.__path__, "sim_a_splat_torch.")]
        for name in mods:
            importlib.import_module(name)
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "flax",
                                             "optax", "orbax",
                                             "sim_a_splat_tpu",
                                             "__graft_entry__"))
        print(len(mods))
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sim_a_splat_tpu",
             "__graft_entry__")


@pytest.mark.parametrize("path", ["chip_smoke.py", "chip_scaling.py",
                                  "chip_trace.py", "sim_a_splat_torch"])
def test_no_reference_import_statements(path):
    """No import statement anywhere in the port or in the card scripts
    (also inside functions) names JAX or the reference package."""
    files = [ROOT / path] if path.endswith(".py") else \
        sorted((ROOT / path).rglob("*.py"))
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{f}: imports {n}"


def _reference_paths(tree):
    """The string constants of a module (f-string parts too) that name the
    reference package, leaving out docstrings and the ``replaces`` labels
    of the card scripts' ``kernels`` line (the file:line of the TPU kernel
    each CUDA kernel replaces, which the line must name)."""
    skip = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant):
            skip.add(id(body[0].value))                       # docstring
        if isinstance(node, ast.keyword) and node.arg == "replaces":
            skip.update(id(n) for n in ast.walk(node.value))
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "replaces":
                    skip.update(id(n) for n in ast.walk(v))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and "sim_a_splat_tpu" in n.value and id(n) not in skip]


def test_port_keeps_its_own_native_sources():
    """The native binding builds from the port's own copy of the C++
    sources, and no module of the port and no card script names a path
    in the reference package outside a docstring or a comment (a path
    built from the string "sim_a_splat_tpu" counts)."""
    from sim_a_splat_torch import native
    pkg = (ROOT / "sim_a_splat_torch").resolve()
    for src in native.SOURCES:
        assert src.resolve().is_relative_to(pkg), src
        assert src.exists(), src
    files = sorted((ROOT / "sim_a_splat_torch").rglob("*.py")) + [
        ROOT / n for n in ("chip_smoke.py", "chip_scaling.py",
                           "chip_levers.py", "chip_trace.py")]
    for f in files:
        hits = _reference_paths(ast.parse(f.read_text()))
        assert not hits, f"{f.relative_to(ROOT)} names {hits}"
    # the scan sees a path built from the package's name
    built = ast.parse('p = ROOT / "sim_a_splat_tpu" / "native"\n'
                      'q = f"{ROOT}/sim_a_splat_tpu/x.cpp"\n')
    assert len(_reference_paths(built)) == 2
