"""Real spherical harmonics by a CG recursion (port of ``ops/spherical.py``).

Convention: basis order m = -l..l with the l=1 component equal to
sqrt(3) * (y, z, x) for a unit input; parity (-1)^l; component
normalization: ||Y_l(v_hat)||^2 = 2l+1 for any unit vector.

Evaluation: Y_0 = 1;  Y_1 = sqrt(3) (y, z, x);
Y_l = c_l K_l^T (Y_{l-1} (x) Y_1), where K_l couples (l-1) x 1 -> l; the
coefficients are float64 numpy constants computed once on the host.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from ..irreps import wigner_3j
from .norms import safe_normalize


@functools.lru_cache(maxsize=None)
def _coupling(l: int) -> np.ndarray:
    """K[m_prev, m_1, m_l] with orthonormal columns, coupling (l-1) x 1 -> l."""
    return np.ascontiguousarray(
        np.transpose(wigner_3j(l, l - 1, 1), (1, 2, 0)) * math.sqrt(2 * l + 1)
    )


@functools.lru_cache(maxsize=None)
def sh_normalization_constants(lmax: int) -> Tuple[float, ...]:
    """c_l making ||Y_l|| = sqrt(2l+1) on the unit sphere (float64, at one
    generic point: the norm is constant on the sphere by the addition
    theorem)."""
    v = np.array([0.2673, 0.5345, 0.8018])
    v = v / np.linalg.norm(v)
    ys = [np.ones(1), math.sqrt(3.0) * np.array([v[1], v[2], v[0]])]
    consts = [1.0, 1.0]
    for l in range(2, lmax + 1):
        K = _coupling(l)
        raw = np.einsum("aim,a,i->m", K, ys[l - 1], ys[1])
        c = math.sqrt(2 * l + 1) / np.linalg.norm(raw)
        consts.append(c)
        ys.append(c * raw)
    return tuple(consts)


def spherical_harmonics(vectors: torch.Tensor, lmax: int,
                        normalize: bool = True) -> torch.Tensor:
    """Concatenated ``[Y_0, Y_1, ..., Y_lmax]``, ``[..., (lmax+1)^2]``.

    ``vectors``: ``[..., 3]``.  With ``normalize=True`` the inputs are made
    unit first; a zero vector (a pad edge) gives zero SH for l >= 1, with a
    zero gradient."""
    if normalize:
        vectors = safe_normalize(vectors, dim=-1)
    x, y, z = vectors[..., 0], vectors[..., 1], vectors[..., 2]
    consts = sh_normalization_constants(lmax)
    out = [torch.ones(vectors.shape[:-1] + (1,), dtype=vectors.dtype,
                      device=vectors.device)]
    if lmax >= 1:
        y1 = math.sqrt(3.0) * torch.stack([y, z, x], dim=-1)
        out.append(y1)
        prev = y1
        for l in range(2, lmax + 1):
            K = torch.as_tensor(consts[l] * _coupling(l), dtype=vectors.dtype,
                                device=vectors.device)
            prev = torch.einsum("...a,...i,aim->...m", prev, y1, K)
            out.append(prev)
    return torch.cat(out, dim=-1)
