"""Episode recording and checkpoint/resume.

Port of ``sim_a_splat_tpu/utils/episodes.py``:

- :class:`EpisodeRecorder` appends steps (obs/action/reward/done trees of
  tensors, arrays or numbers), flushes each episode to a compressed
  ``.npz`` shard and keeps an ``index.json``, in the reference's layout
  and member names, so each package loads the other's episodes;
- :func:`save_checkpoint` / :func:`restore_checkpoint` keep any tree of
  tensors (env states, scenes, optimizer state).  The reference writes
  orbax checkpoints; orbax is a JAX library, so the port writes its own
  format instead: one ``torch.save`` file of the tree's leaves in
  traversal order, read back with ``torch.load(weights_only=True)`` into
  the structure, dtypes and devices of a tree ``like`` it.  The two
  packages do not read each other's checkpoints.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch


def _to_numpy(tree):
    """Leaves as numpy arrays, dicts in sorted key order (as the
    reference's ``jax.tree.map`` gives them, so the shards' members come
    in the same order)."""
    if isinstance(tree, dict):
        return {k: _to_numpy(tree[k]) for k in sorted(tree)}
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


class EpisodeRecorder:
    def __init__(self, out_dir: str | Path):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self._steps: list = []
        self._episode = 0
        self._index: list = []

    def add_step(self, **fields) -> None:
        self._steps.append(_to_numpy(fields))

    def end_episode(self, **meta) -> Path:
        """Stack the buffered steps and write one npz shard."""
        if not self._steps:
            raise ValueError("no steps buffered")
        stacked: dict = {}
        keys = self._steps[0].keys()
        for k in keys:
            leaves = [s[k] for s in self._steps]
            if isinstance(leaves[0], dict):
                for sub in leaves[0]:
                    stacked[f"{k}.{sub}"] = np.stack(
                        [l[sub] for l in leaves])
            else:
                stacked[k] = np.stack(leaves)
        path = self.out_dir / f"episode_{self._episode:06d}.npz"
        self._write_npz(path, stacked)
        self._index.append({"episode": self._episode,
                            "length": len(self._steps),
                            "file": path.name, **meta})
        (self.out_dir / "index.json").write_text(
            json.dumps(self._index, indent=2))
        self._steps = []
        self._episode += 1
        return path

    @staticmethod
    def _write_npz(path: Path, stacked: dict) -> None:
        """The native multithreaded-deflate npz writer
        (``sim_a_splat_torch.native``) where it builds, else
        ``np.savez_compressed`` (also past zip32's limits, which the native
        writer refuses).  Both write standard npz."""
        from sim_a_splat_torch import native

        if native.available():
            try:
                native.npz_write(path, stacked)
                return
            except OSError:      # zip32 overflow → zip64-capable writer
                pass
        np.savez_compressed(path, **stacked)

    @staticmethod
    def load_episode(path: str | Path) -> dict:
        z = np.load(path)
        out: dict = {}
        for k in z.files:
            if "." in k:
                top, sub = k.split(".", 1)
                out.setdefault(top, {})[sub] = z[k]
            else:
                out[k] = z[k]
        return out


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(like, it):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    if isinstance(like, (tuple, list)):
        items = [_rebuild(v, it) for v in like]
        return type(like)(*items) if hasattr(like, "_fields") \
            else type(like)(items)
    got = next(it)
    if torch.is_tensor(like):
        if not torch.is_tensor(got) or got.shape != like.shape:
            raise ValueError(f"checkpoint leaf {getattr(got, 'shape', got)} "
                             f"does not match {tuple(like.shape)}")
        return got.to(device=like.device, dtype=like.dtype)
    return got


def save_checkpoint(path: str | Path, tree) -> None:
    """Write the leaves of ``tree`` (tensors, numbers, None; dicts by
    sorted key) to one file, atomically (written aside, then renamed)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves = [x.detach().cpu() if torch.is_tensor(x) else x
              for x in _leaves(tree)]
    tmp = path.with_name(path.name + ".tmp")
    torch.save({"leaves": leaves}, tmp)
    tmp.replace(path)


def restore_checkpoint(path: str | Path, like):
    """The checkpoint at ``path`` in the structure of ``like``, each tensor
    leaf on the device and in the dtype of ``like``'s."""
    leaves = torch.load(Path(path), weights_only=True)["leaves"]
    if len(leaves) != len(_leaves(like)):
        raise ValueError(f"checkpoint holds {len(leaves)} leaves, the "
                         f"structure {len(_leaves(like))}")
    return _rebuild(like, iter(leaves))
