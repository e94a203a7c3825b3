"""Scalar building blocks (port of ``nn/basic.py``): activations, the
``torch.nn.Linear`` default initialisation drawn from a given generator, the
``Linear`` whose product follows a precision (``precision.py``), the
Linear/Norm/Act ``MLP``, and ``RowParallelDense`` (a Linear whose input is
split over a mesh axis: tensor parallelism)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .. import precision as prec
from ..ops.scatter import segment_sum

ACT = {
    "relu": torch.relu,
    "swish": F.silu,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "abs": torch.abs,
    None: lambda x: x,
}


def torch_linear_init_(t: torch.Tensor, fan_in: int,
                       generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place from U(-1/sqrt(fan_in), 1/sqrt(fan_in)): the
    default of a torch Linear's weight (kaiming_uniform, a=sqrt(5)) and bias."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class Linear(nn.Linear):
    """``torch.nn.Linear`` whose product runs at ``precision`` (the JAX
    ``Dense(precision=)``; None: the process default, see
    ``precision.py``).  Same parameters and names."""

    precision: Optional[str] = None
    site: str = "dense"          # the product's name for precision.record

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return prec.linear(x, self.weight, self.bias, self.precision,
                           self.site)


class OutputLinear(Linear):
    """A model's output layer: ``torch.nn.Linear`` computed as ``b + x @
    W^T`` in one ``addmm`` with ``W^T`` made contiguous, so every row of the
    result is computed alike and equal input rows give bitwise-equal outputs
    wherever they sit in the batch.  On the CPU, ``F.linear``'s product with
    the transposed weight rounds the rows of a 2- or 3-column output
    differently (a third of random cases), which decides the argmax between
    two logits that a model cannot tell apart: a position-blind MPNN would
    "separate" the two isomorphic k-chains by rounding alone.  Same
    parameters and names; ``x`` is ``[rows, in_features]``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return prec.addmm(self.bias, x, self.weight.t().contiguous(),
                          self.precision, self.site)


def linear(in_features: int, out_features: int,
           generator: torch.Generator, cls=Linear,
           precision: Optional[str] = None, site: str = "dense") -> Linear:
    """A ``cls`` (``Linear`` or ``OutputLinear``) at ``precision`` with the
    default init of a torch Linear drawn from ``generator``; ``site`` names
    its product for ``precision.record``."""
    layer = cls(in_features, out_features)
    layer.precision, layer.site = precision, site
    torch_linear_init_(layer.weight, in_features, generator)
    torch_linear_init_(layer.bias, in_features, generator)
    return layer


class RowParallelDense(nn.Module):
    """A Linear whose INPUT features are split over ``axis`` of ``mesh``
    (tensor parallelism, the JAX package's ``RowParallelDense``): each rank
    holds the weight columns of its input slice (``weight [out_features,
    in_features]``, ``in_features`` the local width), computes its partial
    product, and one ``differentiable.psum`` completes the contraction;
    the bias is added after it, once.  A full Linear's weight splits on
    dim 1 onto the ranks (flax's kernel ``[in, out]`` on axis 0).  Every row
    is computed alike, as in ``OutputLinear``."""

    def __init__(self, in_features: int, out_features: int, mesh, axis: str,
                 *, generator: torch.Generator):
        super().__init__()
        self.mesh, self.axis = mesh, axis
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        torch_linear_init_(self.weight, in_features, generator)
        torch_linear_init_(self.bias, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..parallel.mesh import differentiable

        partial = prec.matmul(x, self.weight.t().contiguous(), site="dense")
        return differentiable.psum(self.mesh, partial, self.axis) + self.bias


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm`` over every axis but the last (the JAX
    package's ``nn.basic.BatchNorm``: momentum 0.9, eps 1e-5), not
    ``torch.nn.BatchNorm1d``, whose statistics differ in two ways:

    * the variance is flax's fast one, ``E[x^2] - E[x]^2`` clipped at 0:
      biased, and that same value normalises and enters the running
      average (torch keeps an unbiased running variance);
    * the running averages move as ``ra = m * ra + (1 - m) * batch``
      (torch's ``momentum`` is ``1 - m``).

    Every row counts, pad rows included, as in the JAX models.  In train
    mode (``module.train()``) the batch statistics normalise and the
    buffers ``running_mean`` / ``running_var`` (flax's ``batch_stats``
    ``mean`` / ``var``) are updated; in eval mode the buffers normalise.
    ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias``, flax's order;
    ``weight`` / ``bias`` are flax's ``scale`` / ``bias``."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            dims = tuple(range(x.ndim - 1))
            mean = x.mean(dim=dims)
            var = torch.clamp_min((x * x).mean(dim=dims) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class MLP(nn.Module):
    """Linear -> Norm -> Act, once per width of ``hidden``; the last layer's
    norm and activation only with ``norm_final`` / ``act_final``.  ``norm``
    is ``'layer'`` (LayerNorm, eps 1e-5), ``'batch'`` (``BatchNorm``,
    momentum 0.9, eps 1e-5: batch statistics in train mode, running ones in
    eval mode) or None.  Linears take torch's default init from
    ``generator``.

    ``dense[k]`` and ``norm[k]`` are the JAX MLP's ``Dense_k`` and
    ``LayerNorm_k`` / ``BatchNorm_k``."""

    def __init__(self, in_dim: int, hidden: Sequence[int],
                 activation: Optional[str] = "relu",
                 norm: Optional[str] = "layer", act_final: bool = True,
                 norm_final: bool = True, *, generator: torch.Generator):
        super().__init__()
        if norm not in ("layer", "batch", None):
            raise ValueError(f"MLP norm must be 'layer', 'batch' or None, "
                             f"got {norm!r}")
        if activation not in ACT:
            raise ValueError(f"activation must be one of {sorted(map(str, ACT))}")
        self.act = ACT[activation]
        self.act_final = act_final
        widths = [in_dim, *hidden]
        self.dense = nn.ModuleList(linear(a, b, generator)
                                   for a, b in zip(widths, widths[1:]))
        n_norm = 0 if norm is None else len(hidden) - (0 if norm_final else 1)
        make_norm = ((lambda w: BatchNorm(w, momentum=0.9, eps=1e-5))
                     if norm == "batch" else (lambda w: nn.LayerNorm(w, eps=1e-5)))
        self.norm = nn.ModuleList(make_norm(w) for w in hidden[:n_norm])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.dense) - 1
        for i, dense in enumerate(self.dense):
            x = dense(x)
            if i < len(self.norm):
                x = self.norm[i](x)
            if i < last or self.act_final:
                x = self.act(x)
        return x


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weight, idx):
        ctx.save_for_backward(idx)
        ctx.rows = weight.shape[0]
        return weight[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        rows = segment_sum(g.reshape(idx.numel(), -1), idx.reshape(-1),
                           ctx.rows)
        return rows.reshape((ctx.rows,) + g.shape[idx.ndim:]), None


class Embedding(nn.Embedding):
    """``torch.nn.Embedding`` whose weight gradient is the segment sum of
    the output's gradient over the indices (``ops.scatter.segment_sum``:
    K4 on the card, one launch per backward), bitwise repeatable and fast
    for a few distinct indices repeated 1e5 times (a box's species), where
    ``nn.Embedding``'s own backward is not repeatable on the card.  Same
    parameter, same values."""

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return _Lookup.apply(self.weight, idx)
