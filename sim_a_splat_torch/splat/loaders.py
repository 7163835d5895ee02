"""Scene loaders producing :class:`GaussianScene`.

Port of ``sim_a_splat_tpu/splat/loaders.py``:

- ``load_json``: a JSON dump of raw (pre-activation) parameters, keys
  means / rotations / colors / opacities / scalings;
- ``load_nerfstudio``: a splatfacto run directory (its newest
  ``step-*.ckpt``, read with ``torch.load`` on the host);
- ``load_ply``: the standard INRIA / gsplat ``.ply`` export;
- ``load_npz`` / ``save_npz``: the package's own format; ``load``
  dispatches on the path;
- ``synthetic_scene``: the deterministic random toy scene, drawn with numpy
  in the reference's order, so that both packages build the same scene
  from a seed;
- ``aabb_mask``: the gaussians inside an axis-aligned box.

Every loader returns raw parameters as float32 tensors on ``device``
("cuda" unless asked); activations live on the scene.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from sim_a_splat_torch import resolve_device
from sim_a_splat_torch.ops import sh as sh_ops
from sim_a_splat_torch.splat.scene import GaussianScene


def _to_scene(means, quats, log_scales, logit_opacities, sh_dc, sh_rest=None,
              device="cuda") -> GaussianScene:
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return GaussianScene(
        means=f32(means), quats=f32(quats), log_scales=f32(log_scales),
        logit_opacities=f32(logit_opacities).reshape(-1), sh_dc=f32(sh_dc),
        sh_rest=None if sh_rest is None else f32(sh_rest))


def load_json(path: str | Path, device="cuda") -> GaussianScene:
    """JSON dump of raw parameters; ``colors`` are SH DC coefficients
    unless ``colors_are_sh`` is false, then RGB."""
    with open(path, "r") as f:
        data = json.load(f)
    colors = np.asarray(data["colors"], np.float32)
    sh_dc = (colors if data.get("colors_are_sh", True)
             else sh_ops.rgb_to_sh(torch.as_tensor(colors)).numpy())
    return _to_scene(data["means"], data["rotations"], data["scalings"],
                     data["opacities"], sh_dc, device=device)


def load_nerfstudio(checkpoint_dir: str | Path,
                    device="cuda") -> GaussianScene:
    """A splatfacto model from a nerfstudio run directory: its newest
    ``step-*.ckpt`` (searched recursively), whose ``pipeline`` keys end in
    ``gauss_params.{means,quats,scales,opacities,features_dc,
    features_rest}``."""
    checkpoint_dir = Path(checkpoint_dir)
    ckpts = sorted(checkpoint_dir.rglob("step-*.ckpt"))
    if not ckpts:
        raise FileNotFoundError(f"no step-*.ckpt under {checkpoint_dir}")
    state = torch.load(ckpts[-1], map_location="cpu", weights_only=False)
    pipeline = state["pipeline"] if "pipeline" in state else state

    def find(suffix):
        for k, v in pipeline.items():
            if k.endswith(suffix):
                return v.detach().cpu().numpy()
        raise KeyError(f"no key ending in {suffix!r} in checkpoint")

    try:
        sh_rest = find("gauss_params.features_rest")
        if sh_rest.size == 0:
            sh_rest = None
    except KeyError:
        sh_rest = None
    return _to_scene(find("gauss_params.means"), find("gauss_params.quats"),
                     find("gauss_params.scales"),
                     find("gauss_params.opacities"),
                     find("gauss_params.features_dc"), sh_rest, device=device)


def load_ply(path: str | Path, device="cuda") -> GaussianScene:
    """Standard 3DGS ``.ply`` export (binary_little_endian, x y z nx ny nz
    f_dc_* f_rest_* opacity scale_* rot_*)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = 0
        props = []
        for line in header:
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                props.append(line.split()[-1])
        data = np.frombuffer(f.read(n * len(props) * 4), dtype="<f4")
    data = data.reshape(n, len(props))
    col = {p: i for i, p in enumerate(props)}

    n_rest = sum(1 for p in props if p.startswith("f_rest_"))
    sh_rest = None
    if n_rest:
        rest = data[:, [col[f"f_rest_{i}"] for i in range(n_rest)]]
        # the file stores the rest bands channel-major (all R, all G, all B)
        sh_rest = rest.reshape(n, 3, n_rest // 3).transpose(0, 2, 1)
    return _to_scene(
        data[:, [col["x"], col["y"], col["z"]]],
        data[:, [col["rot_0"], col["rot_1"], col["rot_2"], col["rot_3"]]],
        data[:, [col["scale_0"], col["scale_1"], col["scale_2"]]],
        data[:, col["opacity"]],
        data[:, [col["f_dc_0"], col["f_dc_1"], col["f_dc_2"]]], sh_rest,
        device=device)


def load_npz(path: str | Path, device="cuda") -> GaussianScene:
    z = np.load(path)
    return _to_scene(
        z["means"], z["quats"], z["log_scales"], z["logit_opacities"],
        z["sh_dc"], z["sh_rest"] if "sh_rest" in z.files else None,
        device=device)


def save_npz(path: str | Path, scene: GaussianScene) -> None:
    arrays = {k: v.detach().cpu().numpy() for k, v in scene._asdict().items()
              if v is not None}
    np.savez_compressed(path, **arrays)


def load(path: str | Path, device="cuda") -> GaussianScene:
    """Dispatch on the path: a directory is a nerfstudio run, else the
    extension (.json, .ply, .npz)."""
    path = Path(path)
    if path.is_dir():
        return load_nerfstudio(path, device)
    loader = {".json": load_json, ".ply": load_ply,
              ".npz": load_npz}.get(path.suffix.lower())
    if loader is None:
        raise ValueError(f"unsupported splat format: {path}")
    return loader(path, device)


def synthetic_scene(n: int = 64, seed: int = 0, extent: float = 1.0,
                    scale_range: tuple[float, float] = (0.02, 0.08),
                    sh_degree: int = 0, device="cuda") -> GaussianScene:
    """N random gaussians in [-extent, extent]³ on ``device``: unit quats,
    log-uniform scales in ``scale_range``, logit opacities in [0.5, 3],
    DC colours from RGB in [0.1, 0.9], and with ``sh_degree`` > 0 rest
    bands ~ N(0, 0.1²)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    means = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    log_scales = np.log(
        rng.uniform(scale_range[0], scale_range[1], (n, 3))).astype(np.float32)
    logit_opacities = rng.uniform(0.5, 3.0, (n,)).astype(np.float32)
    rgb = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    sh_dc = sh_ops.rgb_to_sh(torch.as_tensor(rgb))
    sh_rest = None
    if sh_degree > 0:
        k = (sh_degree + 1) ** 2 - 1
        sh_rest = torch.as_tensor(
            (rng.normal(size=(n, k, 3)) * 0.1).astype(np.float32))
    return GaussianScene(*(None if a is None else
                           torch.as_tensor(a, dtype=torch.float32).to(dev)
                           for a in (means, quats, log_scales,
                                     logit_opacities, sh_dc, sh_rest)))


def aabb_mask(scene: GaussianScene, bounds) -> torch.Tensor:
    """(N,) bool: the gaussians whose means lie in the axis-aligned box
    ``bounds`` (3, 2) [lo, hi], bounds included."""
    b = torch.as_tensor(np.asarray(bounds, np.float32),
                        device=scene.means.device)
    return torch.all((scene.means >= b[:, 0]) & (scene.means <= b[:, 1]),
                     dim=-1)
