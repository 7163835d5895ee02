"""Env-sharded rollouts and the data-parallel train step.

Port of ``sim_a_splat_tpu/parallel/rollout.py``.  B environments are split
over the ``env`` axis: each rank steps and renders its own rows, so the hot
loop has no communication at all; collectives appear only for the
gradient (a mean over ``env``) and the reported loss.

The port's physics and renderers are batched already, so there is no vmap:
``step_fn`` and ``loss_fn`` take a batch.  The reference's train step takes
an optax optimizer and returns new parameters; this one takes a
``torch.optim`` optimizer over the parameters' tensors and updates them in
place.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from sim_a_splat_torch.parallel.mesh import (
    ENV_AXIS, axis_size, shard_batch, tree_map,
)


def shard_vmap(f: Callable, mesh: DeviceMesh):
    """``f`` (batched) on this rank's env rows of a global batch: the
    returned function takes the global batch and returns this rank's
    outputs."""
    def g(*trees):
        return f(*shard_batch(mesh, trees))
    return g


def _stack(outs):
    first = outs[0]
    if torch.is_tensor(first):
        return torch.stack(outs)
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs]) for k in first}
    if isinstance(first, (tuple, list)):
        items = [_stack([o[i] for o in outs]) for i in range(len(first))]
        return type(first)(*items) if hasattr(first, "_fields") \
            else type(first)(items)
    return outs


def make_rollout(step_fn: Callable, mesh: DeviceMesh, horizon: int):
    """A ``horizon``-step rollout of this rank's env shard.

    ``step_fn(states, actions) -> (states, outputs)`` is the batched
    transition; ``rollout(states (B_local, ·), actions (horizon, B_local,
    ·))`` returns the final states and the outputs stacked
    (horizon, B_local, ·).  The states stay on the device across the loop:
    nothing is read back to the host per step.  Take this rank's rows of a
    global batch with ``shard_batch(mesh, states)`` and
    ``shard_batch(mesh, actions, axis=1)``."""
    del mesh        # each rank steps only its own rows

    def rollout(states, actions):
        if actions.shape[0] != horizon:
            raise ValueError(f"actions hold {actions.shape[0]} steps, the "
                             f"rollout {horizon}")
        outs = []
        for t in range(horizon):
            states, out = step_fn(states, actions[t])
            outs.append(out)
        return states, _stack(outs)

    return rollout


def make_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                    mesh: DeviceMesh):
    """Data-parallel train step: parameters replicated, batch sharded over
    ``env``.

    ``loss_fn(params, batch) -> scalar`` averages over its batch;
    ``optimizer`` holds the tensors of ``params`` (leaves that require
    grad).  ``step(params, batch)`` takes the global batch, computes the
    loss and its gradient on this rank's rows, all-reduces the gradient as
    a mean over ``env`` (every shard holds as many rows, so that is the
    gradient of the global batch's mean), takes one optimizer step and
    returns the global mean loss.  A global batch that the env axis does
    not divide raises ``ValueError``."""
    group = mesh.get_group(ENV_AXIS)
    n_env = axis_size(mesh, ENV_AXIS)
    params_of = [p for g in optimizer.param_groups for p in g["params"]]

    def step(params, batch):
        local = shard_batch(mesh, batch)
        loss = loss_fn(params, local)
        grads = torch.autograd.grad(loss, params_of, allow_unused=True)
        flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                          for p, g in zip(params_of, grads)]
                         + [loss.detach()[None]])
        dist.all_reduce(flat, group=group)
        flat /= n_env
        off = 0
        for p in params_of:
            p.grad = flat[off:off + p.numel()].view_as(p).clone()
            off += p.numel()
        optimizer.step()
        return flat[-1]

    return step


def mean_over_env(mesh: DeviceMesh, tree):
    """Each leaf's mean over the ``env`` group (a replicated metric)."""
    group = mesh.get_group(ENV_AXIS)
    n_env = axis_size(mesh, ENV_AXIS)

    def mean(a):
        t = a.detach().clone()
        dist.all_reduce(t, group=group)
        return t / n_env

    return tree_map(mean, tree)
