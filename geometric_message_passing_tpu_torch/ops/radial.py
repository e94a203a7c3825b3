"""Radial bases of edge lengths (port of ``ops/radial.py``; the Gaussian
smearing of SchNet so far)."""

from __future__ import annotations

import numpy as np
import torch


def gaussian_smearing(r: torch.Tensor, start: float = 0.0, stop: float = 10.0,
                      num_gaussians: int = 50) -> torch.Tensor:
    """``exp(coeff (r - mu_k)^2)`` on ``num_gaussians`` even offsets from
    ``start`` to ``stop``, ``coeff = -0.5 / step^2`` (PyG's
    ``GaussianSmearing``).  ``r`` ``[E]`` gives ``[E, num_gaussians]``."""
    grid = np.linspace(start, stop, num_gaussians)
    offset = torch.as_tensor(grid, dtype=r.dtype, device=r.device)
    coeff = -0.5 / float(np.diff(grid)[0]) ** 2
    diff = r[..., None] - offset if r.ndim == 1 else r - offset
    return torch.exp(coeff * diff**2)
