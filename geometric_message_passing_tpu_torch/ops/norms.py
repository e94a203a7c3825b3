"""Gradient-safe vector norm (port of ``ops/norms.py``).

``torch.linalg.norm`` has a NaN gradient at 0, and padded batches hold
exactly-zero edge vectors (every pad edge is a self-loop on the pad node);
masking after the norm does not mend the backward pass (0 * NaN is NaN).
The double ``where`` gives value 0 and gradient 0 at the origin
(``safe_norm``; ``safe_normalize`` gives the unit vector, 0 at the origin).
``safe_arctan2`` pins x to 1 at (0, 0), where pad triplets and quads sit.
"""

from __future__ import annotations

import torch


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
              eps: float = 1e-24) -> torch.Tensor:
    """L2 norm over ``dim`` with value 0 and zero gradient where the squared
    norm is at most ``eps``."""
    sq = (x * x).sum(dim=dim, keepdim=keepdim)
    positive = sq > eps
    safe = torch.where(positive, sq, torch.ones_like(sq))
    return torch.where(positive, torch.sqrt(safe), torch.zeros_like(sq))


def safe_normalize(x: torch.Tensor, dim: int = -1,
                   eps: float = 1e-24) -> torch.Tensor:
    """``x / ||x||`` over ``dim`` with output 0 and zero gradient where the
    squared norm is at most ``eps``."""
    sq = (x * x).sum(dim=dim, keepdim=True)
    positive = sq > eps
    inv = torch.where(positive,
                      1.0 / torch.sqrt(torch.where(positive, sq,
                                                   torch.ones_like(sq))),
                      torch.zeros_like(sq))
    return x * inv


def safe_arctan2(y: torch.Tensor, x: torch.Tensor,
                 eps: float = 1e-12) -> torch.Tensor:
    """``atan2(y, x)`` with finite gradients at (0, 0): where both
    ``|x|`` and ``|y|`` are below ``eps``, x is pinned to 1 before the call
    (value 0, gradient 0 in x and 1 in y)."""
    degen = (x.abs() < eps) & (y.abs() < eps)
    return torch.atan2(y, torch.where(degen, torch.ones_like(x), x))
