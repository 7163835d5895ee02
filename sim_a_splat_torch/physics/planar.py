"""Planar rigid-body primitives, batched over envs.

Port of the pieces of ``sim_a_splat_tpu/physics/planar.py`` that the pushT
control step uses: ``moment_for_poly``, ``rot2d`` (here ``rotate2d``, which
applies the rotation), ``cross2``, ``perp``, ``Contact``,
``circle_poly_contact`` and the projected Gauss-Seidel solver
``solve_contacts``.  Every tensor carries a leading env axis B; the
reference's ``vmap`` is that axis and its ``fori_loop`` a Python loop.  The
contacts are resolved in the reference's order, slot by slot, so the
sequential impulses match it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def moment_for_poly(mass: float, verts) -> float:
    """Chipmunk ``cpMomentForPoly`` about the body origin (host float)."""
    import numpy as np

    v = np.asarray(verts, np.float64)
    s1 = 0.0
    s2 = 0.0
    n = len(v)
    for i in range(n):
        v1, v2 = v[i], v[(i + 1) % n]
        a = float(v2[0] * v1[1] - v2[1] * v1[0])
        b = float(v1 @ v1 + v1 @ v2 + v2 @ v2)
        s1 += a * b
        s2 += a
    return mass * s1 / (6.0 * s2)


def rotate2d(angle: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``rot2d(angle) @ v`` with v (..., 2) broadcast against angle (...)."""
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x, y = v[..., 0:1], v[..., 1:2]
    return torch.cat([c * x + (-s) * y, s * x + c * y], dim=-1)


def cross2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """z-component of the 2-D cross product (..., 2) × (..., 2) → (...)."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def perp(v: torch.Tensor) -> torch.Tensor:
    """90° counter-clockwise rotation."""
    return torch.stack([-v[..., 1], v[..., 0]], dim=-1)


def _norm2(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


class Contact(NamedTuple):
    """Fixed contact slots (struct of arrays, leading dims (B, C))."""

    point: torch.Tensor     # (..., 2) world contact point
    normal: torch.Tensor    # (..., 2) impulse direction on the dynamic body
    depth: torch.Tensor     # (...,)  penetration depth (>0 ⇒ touching)
    active: torch.Tensor    # (...,)  bool
    friction: torch.Tensor  # (...,)  Coulomb coefficient
    other_vel: torch.Tensor  # (..., 2) velocity of the other body


def circle_poly_contact(center: torch.Tensor, radius: float,
                        poly: torch.Tensor, other_vel: torch.Tensor,
                        friction: float) -> Contact:
    """Deepest contact between circles (B, 2) and convex CCW polygons
    (B, V, 2).  The normal points poly → circle."""
    v0 = poly
    v1 = torch.roll(poly, -1, dims=-2)
    edges = v1 - v0
    n = -perp(edges)
    n = n / torch.clamp(_norm2(n), min=1e-9)[..., None]
    rel = center[..., None, :] - v0                           # (B, V, 2)
    d = torch.sum(n * rel, dim=-1)                            # (B, V)
    dmax, iface = torch.max(d, dim=-1)

    t = torch.clamp(
        torch.sum(rel * edges, dim=-1)
        / torch.clamp(torch.sum(edges * edges, dim=-1), min=1e-9),
        0.0, 1.0)
    cp = v0 + t[..., None] * edges
    dist = _norm2(center[..., None, :] - cp)
    iedge = torch.argmin(dist, dim=-1)

    def pick(a, i):
        return a.gather(-2, i[..., None, None].expand(a.shape[:-2] + (1, 2)))[..., 0, :]

    dist_e = dist.gather(-1, iedge[..., None])[..., 0]
    inside = dmax < 0.0
    normal_out = (center - pick(cp, iedge)) / torch.clamp(dist_e, min=1e-9)[..., None]
    normal = torch.where(inside[..., None], pick(n, iface), normal_out)
    depth = torch.where(inside, radius - dmax, radius - dist_e)
    point = center - normal * (radius - depth * 0.5)[..., None]
    return Contact(point=point, normal=normal, depth=depth, active=depth > 0.0,
                   friction=torch.full_like(depth, friction),
                   other_vel=other_vel)


class PlanarBody(NamedTuple):
    """Dynamic rigid body state (batched): CoG, angle, velocities."""

    cog: torch.Tensor      # (B, 2)
    angle: torch.Tensor    # (B,)
    vel: torch.Tensor      # (B, 2)
    omega: torch.Tensor    # (B,)


def _dot2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def solve_contacts(body: PlanarBody, contacts: Contact, inv_mass: float,
                   inv_inertia: float, dt: float, iterations: int = 10,
                   bias: float = 0.2, slop: float = 0.1):
    """Projected Gauss-Seidel over fixed contact slots (B, C), Chipmunk's
    split-impulse scheme.  Returns (vel, omega, bias_vel, bias_omega, jn)."""
    C = contacts.normal.shape[-2]
    tangents = perp(contacts.normal)
    r = contacts.point - body.cog[..., None, :]
    rxn = cross2(r, contacts.normal)
    rxt = cross2(r, tangents)
    k_n = inv_mass + inv_inertia * rxn * rxn
    k_t = inv_mass + inv_inertia * rxt * rxt
    zero = torch.zeros_like(k_n)
    inv_k_n = torch.where(contacts.active, 1.0 / k_n, zero)
    inv_k_t = torch.where(contacts.active, 1.0 / k_t, zero)
    bias_target = (bias / dt) * torch.clamp(contacts.depth - slop, min=0.0)
    perp_r = perp(r)

    v, w = body.vel, body.omega
    vb, wb = torch.zeros_like(v), torch.zeros_like(w)
    jn = [zero[..., i] for i in range(C)]
    jt = list(jn)
    jb = list(jn)
    for _ in range(iterations):
        for i in range(C):
            n_i = contacts.normal[..., i, :]
            t_i = tangents[..., i, :]
            pr_i = perp_r[..., i, :]
            ov_i = contacts.other_vel[..., i, :]
            # normal impulse (real velocity)
            rel = _dot2(n_i, v + w[..., None] * pr_i - ov_i)
            dj = -rel * inv_k_n[..., i]
            jn_new = torch.clamp(jn[i] + dj, min=0.0)
            dj = jn_new - jn[i]
            jn[i] = jn_new
            v = v + (dj * inv_mass)[..., None] * n_i
            w = w + dj * inv_inertia * rxn[..., i]
            # friction impulse, clamped by μ·jn
            relt = _dot2(t_i, v + w[..., None] * pr_i - ov_i)
            djt = -relt * inv_k_t[..., i]
            lim = contacts.friction[..., i] * jn[i]
            jt_new = torch.minimum(torch.maximum(jt[i] + djt, -lim), lim)
            djt = jt_new - jt[i]
            jt[i] = jt_new
            v = v + (djt * inv_mass)[..., None] * t_i
            w = w + djt * inv_inertia * rxt[..., i]
            # bias impulse (pseudo velocity, position correction only)
            relb = _dot2(n_i, vb + wb[..., None] * pr_i)
            djb = (bias_target[..., i] - relb) * inv_k_n[..., i]
            jb_new = torch.clamp(jb[i] + djb, min=0.0)
            djb = jb_new - jb[i]
            jb[i] = jb_new
            vb = vb + (djb * inv_mass)[..., None] * n_i
            wb = wb + djb * inv_inertia * rxn[..., i]
    return v, w, vb, wb, torch.stack(jn, dim=-1)
