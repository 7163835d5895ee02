"""Real spherical-harmonics color evaluation (degree 0..3).

Port of ``sim_a_splat_tpu/ops/sh.py``: the same basis constants and the
same expression order, so float32 rounding follows the reference term by
term.  Layout of ``sh`` coefficients: (..., K, 3), K = (deg+1)², band-major.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def num_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def sh_to_rgb(sh_dc: torch.Tensor) -> torch.Tensor:
    """DC-band-only color."""
    return sh_dc * C0 + 0.5


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / C0


def _rest_bands(result, r, dirs, degree: int, off: int):
    """Add bands 1..degree; ``r[..., k + off, :]`` is basis function k."""
    if degree >= 1:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (
            result
            - C1 * y * r[..., 1 + off, :]
            + C1 * z * r[..., 2 + off, :]
            - C1 * x * r[..., 3 + off, :]
        )
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        result = (
            result
            + C2[0] * xy * r[..., 4 + off, :]
            + C2[1] * yz * r[..., 5 + off, :]
            + C2[2] * (2.0 * zz - xx - yy) * r[..., 6 + off, :]
            + C2[3] * xz * r[..., 7 + off, :]
            + C2[4] * (xx - yy) * r[..., 8 + off, :]
        )
    if degree >= 3:
        result = (
            result
            + C3[0] * y * (3.0 * xx - yy) * r[..., 9 + off, :]
            + C3[1] * xy * z * r[..., 10 + off, :]
            + C3[2] * y * (4.0 * zz - xx - yy) * r[..., 11 + off, :]
            + C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * r[..., 12 + off, :]
            + C3[4] * x * (4.0 * zz - xx - yy) * r[..., 13 + off, :]
            + C3[5] * z * (xx - yy) * r[..., 14 + off, :]
            + C3[6] * x * (xx - 3.0 * yy) * r[..., 15 + off, :]
        )
    return result


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """SH color in view directions, before the +0.5 offset and clamp.

    ``sh`` (..., K, 3) with K ≥ (degree+1)²; ``dirs`` (..., 3) unit."""
    return _rest_bands(C0 * sh[..., 0, :], sh, dirs, degree, 0)


def eval_sh_color(sh: torch.Tensor, dirs: torch.Tensor,
                  degree: int) -> torch.Tensor:
    """Full splat color: ``eval_sh`` + 0.5, clamped at 0 (gsplat classic)."""
    return torch.clamp(eval_sh(sh, dirs, degree) + 0.5, min=0.0)


def eval_sh_color_split(sh_dc: torch.Tensor, sh_rest, dirs: torch.Tensor,
                        degree: int) -> torch.Tensor:
    """``eval_sh_color`` on split storage (``sh_dc`` (..., 3), ``sh_rest``
    (..., K-1, 3) or None) without building the (N, K, 3) concat."""
    result = _rest_bands(C0 * sh_dc, sh_rest, dirs, degree, -1)
    return torch.clamp(result + 0.5, min=0.0)
