"""Geometric vector perceptron primitives (port of ``nn/gvp.py``).

Features are ``(s, V)`` tuples, ``s [N, ns]`` and ``V [N, nv, 3]``, the JAX
package's layout.  Module names follow its flax tree: a ``GVP`` holds the
Linears ``wh``, ``ws``, ``wv``, ``wsv`` (flax ``Dense`` kernels ``[in, out]``
are these Linears' transposed weights), a ``GVPLayerNorm`` its
``layer_norm`` (flax ``LayerNorm_0``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .basic import ACT, torch_linear_init_


def norm_no_nan(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
                eps: float = 1e-8, sqrt: bool = True) -> torch.Tensor:
    """L2 norm over ``dim`` with the squared norm clipped below at ``eps``
    (so neither value nor gradient is NaN at 0)."""
    out = torch.clamp_min((x * x).sum(dim=dim, keepdim=keepdim), eps)
    return torch.sqrt(out) if sqrt else out


def tuple_sum(*args):
    return tuple(map(sum, zip(*args)))


def tuple_cat(*args):
    s_args, v_args = list(zip(*args))
    return torch.cat(s_args, dim=-1), torch.cat(v_args, dim=-2)


def tuple_index(x, idx):
    return x[0][idx], x[1][idx]


def merge(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``(s, V)`` -> flat ``[..., ns + 3 nv]``."""
    return torch.cat([s, v.reshape(v.shape[:-2] + (v.shape[-2] * 3,))], dim=-1)


def split(x: torch.Tensor, nv: int):
    """Inverse of ``merge``."""
    s = x[..., : -3 * nv]
    v = x[..., -3 * nv:].reshape(x.shape[:-1] + (nv, 3))
    return s, v


def _linear(in_features: int, out_features: int, generator: torch.Generator,
            bias: bool = True) -> nn.Linear:
    """A torch Linear with its default initialisation drawn from
    ``generator`` (the reference's GVPs are raw ``torch.nn.Linear``s)."""
    layer = nn.Linear(in_features, out_features, bias=bias)
    torch_linear_init_(layer.weight, in_features, generator)
    if bias:
        torch_linear_init_(layer.bias, in_features, generator)
    return layer


class GVP(nn.Module):
    """Geometric vector perceptron with optional vector gating.

    ``forward((s, V))`` returns ``(s', V')``, or ``s'`` alone when the
    output has no vector channels; with no vector input, ``forward(s)``
    and ``V'`` is zero."""

    def __init__(self, in_dims: Tuple[int, int], out_dims: Tuple[int, int],
                 h_dim: Optional[int] = None, act_s: Optional[str] = "relu",
                 act_v: Optional[str] = "sigmoid", vector_gate: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        si, vi = in_dims
        so, vo = out_dims
        self.in_dims, self.out_dims = (si, vi), (so, vo)
        self.act_s, self.act_v, self.vector_gate = act_s, act_v, vector_gate
        if vi:
            self.h_dim = h_dim or max(vi, vo)
            self.wh = _linear(vi, self.h_dim, generator, bias=False)
            self.ws = _linear(self.h_dim + si, so, generator)
            if vo:
                self.wv = _linear(self.h_dim, vo, generator, bias=False)
                if vector_gate:
                    self.wsv = _linear(so, vo, generator)
        else:
            self.ws = _linear(si, so, generator)

    def forward(self, x):
        vo = self.out_dims[1]
        if self.in_dims[1]:
            s, v = x
            vh = self.wh(v.transpose(-1, -2))                 # [..., 3, h]
            vn = norm_no_nan(vh, dim=-2)                      # [..., h]
            s = self.ws(torch.cat([s, vn], dim=-1))
            if vo:
                v = self.wv(vh).transpose(-1, -2)             # [..., vo, 3]
                if self.vector_gate:
                    gate_in = ACT[self.act_v](s) if self.act_v else s
                    v = v * torch.sigmoid(self.wsv(gate_in))[..., None]
                elif self.act_v:
                    v = v * ACT[self.act_v](norm_no_nan(v, dim=-1, keepdim=True))
        else:
            s = self.ws(x)
            if vo:
                v = s.new_zeros(s.shape[:-1] + (vo, 3))
        if self.act_s:
            s = ACT[self.act_s](s)
        return (s, v) if vo else s


class GVPLayerNorm(nn.Module):
    """LayerNorm on the scalars (eps 1e-5) and, on the vectors, division by
    the root mean over channels of the clipped squared norms."""

    def __init__(self, dims: Tuple[int, int]):
        super().__init__()
        self.dims = dims
        self.layer_norm = nn.LayerNorm(dims[0], eps=1e-5)

    def forward(self, x):
        if not self.dims[1]:
            return self.layer_norm(x)
        s, v = x
        vn = norm_no_nan(v, dim=-1, keepdim=True, sqrt=False)
        vn = torch.sqrt(vn.mean(dim=-2, keepdim=True))
        return self.layer_norm(s), v / vn


class GVPDropout(nn.Module):
    """Dropout of a tuple: element-wise on the scalars, whole vector
    channels on the vectors, the kept values scaled by ``1 / (1 - rate)``.

    The mask is drawn from the ``generator`` given to ``forward`` (never
    from torch's global generator); it is the identity when ``train`` is
    False or the rate is 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        if self.rate == 0.0 or not train:
            return x
        if generator is None:
            raise ValueError("GVPDropout in training needs a torch.Generator")
        s, v = x
        keep = 1.0 - self.rate
        s_keep = torch.rand(s.shape, generator=generator, device=s.device) < keep
        v_keep = torch.rand(v.shape[:-1], generator=generator,
                            device=v.device) < keep
        s = torch.where(s_keep, s / keep, torch.zeros_like(s))
        v = torch.where(v_keep[..., None], v / keep, torch.zeros_like(v))
        return s, v
