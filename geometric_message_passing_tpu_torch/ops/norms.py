"""Gradient-safe vector norm (port of ``ops/norms.py``).

``torch.linalg.norm`` has a NaN gradient at 0, and padded batches hold
exactly-zero edge vectors (every pad edge is a self-loop on the pad node);
masking after the norm does not mend the backward pass (0 * NaN is NaN).
The double ``where`` gives value 0 and gradient 0 at the origin
(``safe_norm``; ``safe_normalize`` gives the unit vector, 0 at the origin).
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
