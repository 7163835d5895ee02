"""Differentiable SSIM (structural similarity) for training losses.

Port of ``sim_a_splat_tpu/ops/ssim.py``: splatfacto's loss term
(1 − SSIM) with torchmetrics' window (11×11 Gaussian, σ = 1.5, data range
1.0, K = (0.01, 0.03)), the per-pixel map averaged over the VALID region
and the channels.  The blur is separable and depthwise, two
``conv2d(..., groups=C)`` passes in the reference's order (H, then W);
it stays a plain torch stage, as the reference's ``lax`` convolutions do.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable depthwise Gaussian filter, VALID padding.

    ``img`` is (H, W, C); returns (H−size+1, W−size+1, C)."""
    C = img.shape[-1]
    size = kernel.shape[0]
    x = img.permute(2, 0, 1)[None]                          # NCHW
    x = F.conv2d(x, kernel.reshape(1, 1, size, 1).expand(C, 1, size, 1),
                 groups=C)
    x = F.conv2d(x, kernel.reshape(1, 1, 1, size).expand(C, 1, 1, size),
                 groups=C)
    return x[0].permute(1, 2, 0)


def ssim(img: torch.Tensor, ref: torch.Tensor, kernel_size: int = 11,
         sigma: float = 1.5, data_range: float = 1.0,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM between two (H, W, C) images in [0, data_range]."""
    kernel = torch.as_tensor(_gaussian_kernel(kernel_size, sigma),
                             device=img.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x = _blur(img, kernel)
    mu_y = _blur(ref, kernel)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_x = _blur(img * img, kernel) - mu_xx
    sigma_y = _blur(ref * ref, kernel) - mu_yy
    sigma_xy = _blur(img * ref, kernel) - mu_xy
    num = (2.0 * mu_xy + c1) * (2.0 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2)
    return torch.mean(num / den)


def ssim_loss(img: torch.Tensor, ref: torch.Tensor, **kw) -> torch.Tensor:
    """1 − SSIM, the splatfacto loss term."""
    return 1.0 - ssim(img, ref, **kw)
