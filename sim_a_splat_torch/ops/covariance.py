"""Gaussian covariance composition.

Port of ``sim_a_splat_tpu/ops/covariance.py``: Σ = (R S)(R S)ᵀ with
S = diag(scaling), the inverse covariance by passing 1/scaling, and the
rotation Σ' = R Σ Rᵀ; batch-first and differentiable.  The 3×3 products
are ``torch.matmul`` in float32 (the package turns TF32 off).
"""

from __future__ import annotations

import torch

from sim_a_splat_torch.ops import quaternion as quat


def compute_cov(q: torch.Tensor, scaling: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quats + (..., 3) scales → (..., 3, 3) covariances
    Σ = R S Sᵀ Rᵀ (activations applied by the caller)."""
    M = quat.to_rotation_matrix(q) * scaling[..., None, :]  # R @ diag(s)
    return M @ M.transpose(-1, -2)


def compute_cov_inv(q: torch.Tensor, scaling: torch.Tensor) -> torch.Tensor:
    """Inverse covariance via reciprocal scales."""
    return compute_cov(q, 1.0 / scaling)


def transform_cov(R: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """Rotate covariances: Σ' = R Σ Rᵀ (R broadcastable against cov)."""
    return R @ cov @ R.transpose(-1, -2)
