"""Radial bases of edge lengths (port of ``ops/radial.py``): the Bessel
basis with its polynomial cutoff (GVP-GNN's edge embedding) and SchNet's
Gaussian smearing."""

from __future__ import annotations

import math

import numpy as np
import torch


def bessel_basis(r: torch.Tensor, r_max: float, num_basis: int = 8,
                 eps: float = 1e-12) -> torch.Tensor:
    """``sqrt(2/r_max) sin(n pi r / r_max) / r`` for n = 1..num_basis.

    ``r`` ``[..., 1]`` gives ``[..., num_basis]``.  Lengths at most ``eps``
    (the zero-length pad edges) are read as ``eps``, so value and gradient
    stay finite there."""
    n = torch.as_tensor(np.pi / r_max * np.arange(1, num_basis + 1),
                        dtype=r.dtype, device=r.device)
    r_safe = torch.where(r > eps, r, torch.full_like(r, eps))
    return math.sqrt(2.0 / r_max) * torch.sin(n * r_safe) / r_safe


def polynomial_cutoff(r: torch.Tensor, r_max: float, p: int = 6) -> torch.Tensor:
    """DimeNet's smooth polynomial envelope of ``r / r_max``, zero from
    ``r_max`` on."""
    x = r / r_max
    envelope = (1.0
                - ((p + 1.0) * (p + 2.0) / 2.0) * x**p
                + p * (p + 2.0) * x ** (p + 1)
                - (p * (p + 1.0) / 2.0) * x ** (p + 2))
    return envelope * (r < r_max)


def radial_embedding(lengths: torch.Tensor, r_max: float, num_bessel: int = 8,
                     num_polynomial_cutoff: int = 5) -> torch.Tensor:
    """Bessel basis times the polynomial cutoff: ``[E, 1]`` lengths give
    ``[E, num_bessel]``."""
    return (bessel_basis(lengths, r_max, num_bessel)
            * polynomial_cutoff(lengths, r_max, num_polynomial_cutoff))


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
