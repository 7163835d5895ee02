"""Gaussian splat scene container.

Port of ``GaussianScene`` (``sim_a_splat_tpu/splat/scene.py``): raw
(pre-activation) parameters with the activations applied on demand —
opacities = sigmoid(logit_opacities), DC colors = SH2RGB(sh_dc).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from sim_a_splat_torch.ops import sh as sh_ops


class GaussianScene(NamedTuple):
    """N gaussians, raw parameters; ``sh_rest`` is None for DC-only scenes,
    else (N, K-1, 3) with K = (sh_degree+1)²."""

    means: torch.Tensor             # (N, 3)
    quats: torch.Tensor             # (N, 4) wxyz, not necessarily normalized
    log_scales: torch.Tensor        # (N, 3)
    logit_opacities: torch.Tensor   # (N,)
    sh_dc: torch.Tensor             # (N, 3)
    sh_rest: Optional[torch.Tensor] = None

    @property
    def sh_degree(self) -> int:
        if self.sh_rest is None:
            return 0
        return int(round((1 + self.sh_rest.shape[1]) ** 0.5)) - 1

    def opacities(self) -> torch.Tensor:
        return torch.sigmoid(self.logit_opacities)

    def colors_dc(self) -> torch.Tensor:
        return sh_ops.sh_to_rgb(self.sh_dc)

    def sh_coeffs(self) -> torch.Tensor:
        """Full (N, K, 3) SH stack (DC prepended to the rest bands)."""
        if self.sh_rest is None:
            return self.sh_dc[:, None, :]
        return torch.cat([self.sh_dc[:, None, :], self.sh_rest], dim=1)

    def select(self, idx) -> "GaussianScene":
        """Subset by integer indices; a contiguous run becomes a slice (a
        view, no copy)."""
        a = np.asarray(idx.cpu() if torch.is_tensor(idx) else idx)
        if (a.ndim == 1 and a.dtype.kind in "iu" and a.size > 0
                and np.all(np.diff(a) == 1)):
            lo, hi = int(a[0]), int(a[0]) + a.size

            def take(x):
                return x[lo:hi]
        else:
            index = torch.as_tensor(a, dtype=torch.long,
                                    device=self.means.device)

            def take(x):
                return x[index]
        return GaussianScene(*(None if f is None else take(f) for f in self))

    def to(self, device) -> "GaussianScene":
        return GaussianScene(*(None if f is None else f.to(device)
                               for f in self))
