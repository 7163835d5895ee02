"""Process groups, the (env, prim) device mesh, batch sharding and the rank
launcher.

Port of ``sim_a_splat_tpu/parallel/mesh.py`` over ``torch.distributed``.
The reference's two scaling axes keep their names:

- ``env``  — data parallelism over environment instances: every rank steps
  and renders its own rows of the global batch;
- ``prim`` — primitive/tile sharding inside the renderer
  (``parallel/render_sharding.py``): the ranks of one ``prim`` group each
  hold a slice of a scene's gaussians and exchange per-tile candidate lists.

The reference is one SPMD program over a ``jax.sharding.Mesh``: an array
carries its sharding and XLA places it.  Here every rank is a process that
holds only its own data, so ``env_sharding``, ``replicated`` and
``prim_sharding`` (named shardings of a global array) have no counterpart:
``shard_batch`` takes a rank's rows of a global batch, ``replicate`` makes a
tree the same on every rank, and the render takes its ``prim`` shard itself.

:func:`make_mesh` is a ``DeviceMesh`` of the whole world.  The reference
trims its device list to env·prim; a process group cannot leave out ranks
that joined it, so a world of another size raises.

:func:`launch` starts the ranks of one program on this host (start method
``spawn``, which CUDA needs) and returns what each rank's function
returned.  Every process group it creates has a timeout, so a rank that
dies makes the others fail instead of waiting forever.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

ENV_AXIS = "env"
PRIM_AXIS = "prim"

# the variables a launcher such as torchrun sets for each rank
CLUSTER_VARIABLES = ("MASTER_ADDR", "WORLD_SIZE", "RANK")
DEFAULT_TIMEOUT_S = 600.0


def initialize_distributed(**kwargs) -> bool:
    """Join the process group (``torch.distributed.init_process_group`` with
    ``kwargs``).  Returns True when the process is part of a process group
    after the call.

    Failure policy (the reference's): where the caller asked for a
    distributed run, by passing kwargs or by setting the cluster variables
    (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``), a failure raises
    ``RuntimeError``; it is never degraded to a single process.  With
    neither, the call does nothing and returns False.  A ``timeout`` of
    :data:`DEFAULT_TIMEOUT_S` is added where kwargs give none."""
    if dist.is_initialized():
        return True
    env_configured = any(os.environ.get(k) for k in CLUSTER_VARIABLES)
    if not (kwargs or env_configured):
        return False
    kwargs.setdefault("timeout", datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    try:
        dist.init_process_group(**kwargs)
    except Exception as exc:
        raise RuntimeError(
            f"torch.distributed.init_process_group failed with explicit "
            f"configuration (kwargs={sorted(kwargs)}, cluster variables "
            f"{'set' if env_configured else 'unset'}): {exc}") from exc
    return dist.is_initialized()


def make_mesh(env: int | None = None, prim: int = 1,
              device="cuda") -> DeviceMesh:
    """``DeviceMesh`` of the whole process group with dimensions
    ``("env", "prim")``, in the reference's axis order (env outer, so the
    ranks of a ``prim`` group are neighbours).  ``env=None`` takes every
    rank the ``prim`` axis leaves.  Needs an initialized process group;
    raises ``ValueError`` where env·prim is not the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_distributed (or run under launch)")
    n = dist.get_world_size()
    if env is None:
        if n % prim:
            raise ValueError(f"{n} ranks not divisible by prim={prim}")
        env = n // prim
    if env * prim != n:
        raise ValueError(
            f"mesh env={env} × prim={prim} needs {env * prim} ranks, the "
            f"process group has {n} (a process group cannot leave ranks out)")
    return init_device_mesh(torch.device(device).type, (env, prim),
                            mesh_dim_names=(ENV_AXIS, PRIM_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def tree_map(fn: Callable, tree):
    """``fn`` on every tensor or numpy leaf of a tree of dicts, lists,
    tuples and named tuples; other leaves (None, numbers) pass through."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [tree_map(fn, v) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return tree


def shard_batch(mesh: DeviceMesh, tree, axis: int = 0):
    """This rank's rows of a global batch: every leaf split along ``axis``
    into one block per ``env`` coordinate, in order (the reference's
    ``env_sharding``).  A batch the env axis does not divide raises
    ``ValueError``, as the reference's sharding refuses it."""
    n_env = axis_size(mesh, ENV_AXIS)
    e = mesh.get_local_rank(ENV_AXIS)

    def rows(a):
        B = a.shape[axis]
        if B % n_env:
            raise ValueError(f"global batch {B} is not divisible by the "
                             f"env axis ({n_env} shards)")
        n = B // n_env
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(e * n, (e + 1) * n)
        return a[tuple(idx)]

    return tree_map(rows, tree)


def replicate(mesh: DeviceMesh, tree):
    """The tree of global rank 0 on every rank of the mesh (a broadcast),
    as new tensors."""
    del mesh        # the mesh spans the whole process group

    def bcast(a):
        t = torch.as_tensor(a).clone()
        dist.broadcast(t, 0)
        return t

    return tree_map(bcast, tree)


# --- the launcher --------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_host(tree):
    return tree_map(lambda a: a.detach().cpu() if torch.is_tensor(a) else a,
                    tree)


def _rank_main(rank, world_size, backend, device_type, port, timeout_s, fn,
               args, results):
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}",
            world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = _to_host(fn(*args))
        finally:
            dist.destroy_process_group()
        # pickled here, by value: a tensor put on a multiprocessing queue
        # travels in shared memory that may be gone once this rank exits
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn: Callable, world_size: int, backend: str, device, *args,
           timeout_s: float = DEFAULT_TIMEOUT_S) -> list[Any]:
    """Run ``fn(*args)`` on ``world_size`` ranks of one process group
    (``backend`` "nccl" or "gloo", the caller's choice, never switched) and
    return each rank's result, tensors moved to the host, by rank.

    Each rank is a process started with ``spawn`` (``fn`` and ``args``
    must pickle: a module-level function), joined to the group over TCP on
    a free local port with ``timeout_s`` as the group's timeout; on
    ``device`` "cuda" rank r selects card r mod the card count.  The CUDA
    kernels are built here, before the ranks start, so the ranks only load
    them.  A rank that raises, dies or outlasts ``timeout_s`` makes this
    call stop every rank and raise ``RuntimeError`` with what it knows."""
    import multiprocessing

    from sim_a_splat_torch import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        from sim_a_splat_torch.ops import _kernels
        _kernels.build_all()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, backend, dev.type, port,
                               timeout_s, fn, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got: dict = {}
    deadline = time.monotonic() + timeout_s + 60.0
    try:
        while len(got) < world_size:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(
                        f"rank(s) {dead} exited with codes "
                        f"{[procs[r].exitcode for r in dead]} before "
                        "returning") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"ranks {sorted(set(range(world_size)) - set(got))} "
                        f"did not finish within {timeout_s} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = pickle.loads(out)
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world_size)]
