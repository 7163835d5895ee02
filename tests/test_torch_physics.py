"""Port's batched pushT physics against the JAX reference.

States along the committed Chipmunk golden trajectories
(``tests/assets/pusht_goldens.npz``) are taken from the reference, and one
batched port ``control_step`` from each is compared with
``jax.vmap(pusht.control_step)``: positions atol 1e-3, angle atol 1e-4
(10 substeps × 10 float32 PGS sweeps; the two libraries differ in the last
bit of sin/cos and in fused multiply-adds, which contacts amplify).
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import jax_pusht_states, np_of

from sim_a_splat_tpu.physics import pusht as jpusht
from sim_a_splat_torch.physics import pusht

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
    mine = pusht.control_step(
        P, pusht.state_from_numpy({k: np_of(v) for k, v in
                                   jstates._asdict().items()}, device="cpu"),
        torch.as_tensor(actions))
    assert int(np_of(ref.n_contacts).sum()) > 0      # contacts exercised
    for name in ("agent_pos", "agent_vel", "block_pos", "block_vel"):
        np.testing.assert_allclose(np_of(getattr(mine, name)),
                                   np_of(getattr(ref, name)), atol=1e-3,
                                   err_msg=name)
    np.testing.assert_allclose(np_of(mine.block_angle),
                               np_of(ref.block_angle), atol=1e-4)
    np.testing.assert_allclose(np_of(mine.block_omega),
                               np_of(ref.block_omega), atol=1e-3)
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
