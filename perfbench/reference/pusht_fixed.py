"""Plain reference of the pushT splat env under the fixed top-down camera.

One control step of B envs (``pusht_physics``), then each env's image: the
scene's static gaussians (link id 0) stand still, the T-block's and the
agent's (link ids 1, 2) are posed by the env's new state, and every tile
composites the static list (capacity ``tile_capacity``) and the env's
dynamic list (capacity ``dyn_capacity``, ``dyn_max_tiles`` bbox slots)
interleaved by depth, a static entry first on equal depth, on a white
background (``splat_render``).  Its counters: the env's touched tiles past
``sel_tiles`` (severe) and its dynamic lists' truncations, tiles over
capacity plus gaussians with more bbox tiles than slots (bounded).

The train step's loss is mean(images²) over the batch, and its gradient
flows to every scene field through the render (not through the physics,
which reads no scene field).

It imports torch and numpy only: nothing of the program.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import pusht_physics as phys
from perfbench.reference import splat_render as sr

FIELDS = ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
          "sh_rest")
CAMERA_T = (149.0, 256.0, -450.0)   # the camera's centre over the table
CAMERA_FOV = 1.05                   # vertical field of view, radians


class Reference:
    """The cell's plain reference in one dtype (float32; bfloat16 for the
    control).  ``leaves`` maps :data:`FIELDS` to the scene's tensors and
    ``link_ids`` (N,) names each gaussian's body."""

    def __init__(self, cfg: dict, leaves: dict, link_ids, dtype=torch.float32):
        self.cfg = cfg
        self.dtype = dtype
        self.leaves = {k: leaves[k].detach().to(dtype) for k in FIELDS}
        dev = self.leaves["means"].device
        ids = torch.as_tensor(link_ids, device=dev).long()
        self.stat = torch.nonzero(ids == 0)[:, 0]
        self.dyn = torch.nonzero(ids > 0)[:, 0]
        self.dyn_body = ids[self.dyn]
        self.params = phys.Params()
        H = W = int(cfg["resolution"])
        half = torch.tensor(0.5 * CAMERA_FOV, dtype=dtype, device=dev)
        f = 0.5 * H / torch.tan(half)
        center = torch.tensor(CAMERA_T, dtype=dtype, device=dev)
        self.cam = sr.Cam(torch.eye(3, dtype=dtype, device=dev), -center,
                          f, f, torch.tensor(W / 2.0, dtype=dtype, device=dev),
                          torch.tensor(H / 2.0, dtype=dtype, device=dev),
                          W, H, center)
        self.ts = int(cfg["tile_size"])
        self.tx, self.ty = -(-W // self.ts), -(-H // self.ts)
        self.white = torch.ones(3, dtype=dtype, device=dev)
        self.degree = int(cfg["sh_degree"])

    # --- physics --------------------------------------------------------
    def reset(self, vec):
        return phys.reset(self.params, vec.to(self.dtype))

    def control_step(self, states, actions):
        s = phys.State(*(f.to(self.dtype) for f in states))
        return phys.control_step(self.params, s, actions.to(self.dtype))

    # --- render ---------------------------------------------------------
    def _static(self, lv):
        c = self.cfg
        st = {k: lv[k][self.stat] for k in FIELDS}
        proj = sr.project(st["means"], st["quats"], st["log_scales"], self.cam)
        cols = sr.sh_colors(st["sh_dc"], st["sh_rest"], st["means"], self.cam,
                            self.degree)
        with torch.no_grad():
            lists = sr.bin_tiles(proj, self.ts, self.tx, self.ty,
                                 int(c["tile_capacity"]),
                                 int(c["max_tiles_per_gaussian"]),
                                 c["buckets"])
        return sr.fields(proj, cols, torch.sigmoid(st["logit_opacities"]),
                          lists.ids)

    def _posed(self, lv, states, b):
        """Means and quats of env b's dynamic gaussians: each body at its
        pose (block: angle about z and position; agent: position)."""
        dt, dev = self.dtype, lv["means"].device
        ang = states.block_angle[b].to(dt)
        zero = torch.zeros((), dtype=dt, device=dev)
        one = torch.ones((), dtype=dt, device=dev)
        q_body = torch.stack([
            torch.stack([one, zero, zero, zero]),
            torch.stack([torch.cos(0.5 * ang), zero, zero,
                         torch.sin(0.5 * ang)]),
            torch.stack([one, zero, zero, zero])])
        t_body = torch.stack([
            torch.stack([zero, zero, zero]),
            torch.cat([states.block_pos[b].to(dt), zero[None]]),
            torch.cat([states.agent_pos[b].to(dt), zero[None]])])
        q = q_body[self.dyn_body]
        means = sr.qrotate(q, lv["means"][self.dyn]) + t_body[self.dyn_body]
        quats = sr.qmul(q, lv["quats"][self.dyn])
        return means, quats

    def _env(self, lv, static_fields, states, b):
        """Image (3, H, W) of env b."""
        c = self.cfg
        means, quats = self._posed(lv, states, b)
        d = self.dyn
        proj = sr.project(means, quats, lv["log_scales"][d], self.cam)
        cols = sr.sh_colors(lv["sh_dc"][d], lv["sh_rest"][d], means, self.cam,
                            self.degree)
        with torch.no_grad():
            lists = sr.bin_tiles(proj, self.ts, self.tx, self.ty,
                                 int(c["dyn_capacity"]),
                                 int(c["dyn_max_tiles"]), c["buckets"])
        dyn_fields = sr.fields(proj, cols,
                                torch.sigmoid(lv["logit_opacities"][d]),
                                lists.ids)
        both = torch.cat([static_fields, dyn_fields], dim=1)     # (T, L, 10)
        key = torch.where(both[..., 9] > 0, both[..., 8],
                          torch.full_like(both[..., 8], math.inf))
        order = torch.sort(key, dim=1, stable=True).indices
        merged = torch.gather(both, 1, order[..., None].expand_as(both))
        return sr.composite(merged, self.ts, self.tx, self.ty,
                            self.cam.height, self.cam.width,
                            c["sigma_cutoff"], self.white)

    def render(self, states, envs):
        """Images (len(envs), 3, H, W) of ``envs`` at ``states``."""
        with torch.no_grad():
            sf = self._static(self.leaves)
            return torch.stack([self._env(self.leaves, sf, states, b)
                                for b in envs])

    def counters(self, states):
        """(severe, bounded) summed over every env at ``states``: the
        dynamic lists alone, no image."""
        c = self.cfg
        severe = bounded = 0
        with torch.no_grad():
            for b in range(states.agent_pos.shape[0]):
                means, quats = self._posed(self.leaves, states, b)
                proj = sr.project(means, quats,
                                  self.leaves["log_scales"][self.dyn], self.cam)
                lists = sr.bin_tiles(proj, self.ts, self.tx, self.ty,
                                     int(c["dyn_capacity"]),
                                     int(c["dyn_max_tiles"]), c["buckets"])
                severe += max(0, int((lists.counts > 0).sum())
                              - int(c["sel_tiles"]))
                bounded += int((lists.counts > int(c["dyn_capacity"])).sum()) \
                    + lists.slot_truncated
        return severe, bounded

    def loss_and_grads(self, states, env_block: int = 4):
        """mean(images²) over every env at ``states`` and its gradient to
        each scene field, the envs taken ``env_block`` at a time."""
        lv = {k: v.clone().requires_grad_() for k, v in self.leaves.items()}
        B = states.agent_pos.shape[0]
        n = B * 3 * self.cam.height * self.cam.width
        loss = torch.zeros((), dtype=self.dtype, device=lv["means"].device)
        for b0 in range(0, B, env_block):
            sf = self._static(lv)
            part = sum((self._env(lv, sf, states, b) ** 2).sum()
                       for b in range(b0, min(B, b0 + env_block))) / n
            part.backward()
            loss = loss + part.detach()
        return loss, {k: v.grad for k, v in lv.items()}
