"""Rank functions of the port's multi-rank tests (``test_torch_parallel.py``).

``parallel.launch`` starts each rank with ``spawn`` and pickles the
function by its import path, so they live in this module, which imports
the port and torch only (no JAX: every rank would pay for importing it).
Each takes numpy inputs and returns numpy results.
"""

from __future__ import annotations

import numpy as np
import torch


def _camera(cam, dev):
    from sim_a_splat_torch.ops.projection import Camera
    from sim_a_splat_torch.ops.transforms import SE3
    q, t, fov, w, h = cam
    return Camera.from_fov(SE3(torch.tensor(q, device=dev),
                               torch.tensor(t, device=dev)), fov, w, h)


def sharded_render(scene: dict, cam, raster: dict, send_capacity: int,
                   prim: int, grad: bool, device: str = "cpu"):
    """``rasterize_sharded`` of the scene (numpy ``means, covs, colors,
    opacities``) on an env=world/prim × prim mesh → {"img": (H, W, 3)} and,
    with ``grad``, "grad_means" (N, 3): the gradient of sum(img²) to the
    means on this rank."""
    from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig
    from sim_a_splat_torch.parallel import make_mesh, rasterize_sharded
    dev = torch.device(device)
    mesh = make_mesh(prim=prim, device=device)
    t = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
         for k, v in scene.items()}
    means = t["means"].requires_grad_(grad)
    img = rasterize_sharded(mesh, means, t["covs"], t["colors"],
                            t["opacities"], _camera(cam, dev),
                            RasterConfig(**raster), send_capacity)
    out = {"img": img.detach().cpu().numpy()}
    if grad:
        (g,) = torch.autograd.grad(torch.sum(img ** 2), means)
        out["grad_means"] = g.cpu().numpy()
    return out


def pusht_rollout(vecs: np.ndarray, actions: np.ndarray, device="cpu"):
    """``make_rollout`` of the pushT control step from the states ``vecs``
    (B, 5) (``set_state``) under ``actions`` (H, B, 2), on an env-only mesh
    → this rank's stacked (obs, reward, done) and final observation, and the
    env means of the last reward and block position (``mean_over_env``)."""
    from sim_a_splat_torch.parallel import (
        make_mesh, make_rollout, mean_over_env, shard_batch,
    )
    from sim_a_splat_torch.physics import pusht
    from sim_a_splat_torch.physics.pusht import PushTParams
    dev = torch.device(device)
    mesh = make_mesh(device=device)
    P = PushTParams()
    states = pusht.set_state(P, shard_batch(
        mesh, torch.as_tensor(vecs, dtype=torch.float32, device=dev)))
    acts = shard_batch(mesh, torch.as_tensor(actions, dtype=torch.float32,
                                             device=dev), axis=1)

    def step_fn(s, a):
        s = pusht.control_step(P, s, a)
        r, d = pusht.reward_done(P, s)
        return s, (pusht.get_obs(s), r, d)

    final, (obs, r, d) = make_rollout(step_fn, mesh, actions.shape[0])(
        states, acts)
    means = mean_over_env(mesh, (r[-1].mean(), final.block_pos.mean()))
    return {"obs": obs.cpu().numpy(), "reward": r.cpu().numpy(),
            "done": d.cpu().numpy(), "mean_r": float(means[0]),
            "mean_bp": float(means[1])}


def linear_train(batch: np.ndarray, steps: int, lr: float, device="cpu"):
    """``make_train_step`` of mean((x·w + b)²) with ``torch.optim.SGD`` from
    w = 1, b = 0 over the global ``batch`` → the losses and parameters."""
    from sim_a_splat_torch.parallel import make_mesh, make_train_step
    dev = torch.device(device)
    mesh = make_mesh(device=device)
    params = {"w": torch.ones(batch.shape[1], device=dev, requires_grad=True),
              "b": torch.zeros((), device=dev, requires_grad=True)}
    opt = torch.optim.SGD([params["w"], params["b"]], lr=lr)

    def loss_fn(p, x):
        return torch.mean((x @ p["w"] + p["b"]) ** 2)

    step = make_train_step(loss_fn, opt, mesh)
    x = torch.as_tensor(batch, device=dev)
    losses = [float(step(params, x)) for _ in range(steps)]
    return {"losses": losses, "w": params["w"].detach().cpu().numpy(),
            "b": float(params["b"])}


def mesh_checks(device="cpu"):
    """``make_mesh``, ``shard_batch``, ``replicate`` and ``shard_vmap`` on
    this rank: the mesh's shape and names, this rank's coordinate and rows
    of a global batch, rank 0's tree, a batched function on this rank's
    rows, and the
    errors of a mesh of the wrong size and of a batch the env axis does
    not divide."""
    import torch.distributed as dist
    from sim_a_splat_torch.parallel import (
        make_mesh, replicate, shard_batch, shard_vmap,
    )
    out = {}
    world = dist.get_world_size()
    mesh = make_mesh(env=1, prim=world, device=device)
    out["prim_mesh"] = (tuple(mesh.mesh_dim_names), tuple(mesh.shape),
                        tuple(mesh.get_coordinate()))
    mesh = make_mesh(device=device)
    out["env_mesh"] = (tuple(mesh.mesh_dim_names), tuple(mesh.shape),
                       tuple(mesh.get_coordinate()))
    batch = {"x": torch.arange(8.0).reshape(4, 2), "n": [torch.arange(4)]}
    out["rows"] = shard_batch(mesh, batch)
    out["rows_axis1"] = shard_batch(mesh, torch.arange(8).reshape(2, 4),
                                    axis=1)
    out["replicated"] = replicate(mesh, torch.full((3,), float(
        dist.get_rank())))
    out["shard_vmap"] = shard_vmap(lambda x: 2 * x, mesh)(
        torch.arange(8.0).reshape(4, 2))
    for name, fn in (("wrong_size", lambda: make_mesh(env=world + 1,
                                                      device=device)),
                     ("indivisible", lambda: shard_batch(
                         mesh, torch.zeros(world + 1, 2)))):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def run_jobs(jobs: dict, device="cpu"):
    """Each job (name → (function name in this module, kwargs)) on this
    rank, in order → {name: result}."""
    return {name: globals()[fn](device=device, **kw)
            for name, (fn, kw) in jobs.items()}
