"""Parameter initialisation matching ``torch.nn.Linear``'s default (port of
``nn/basic.py``'s ``torch_linear_*`` inits), drawn from a given generator."""

from __future__ import annotations

import math

import torch


def torch_linear_init_(t: torch.Tensor, fan_in: int,
                       generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place from U(-1/sqrt(fan_in), 1/sqrt(fan_in)): the
    default of a torch Linear's weight (kaiming_uniform, a=sqrt(5)) and bias."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def linear(in_features: int, out_features: int,
           generator: torch.Generator) -> torch.nn.Linear:
    """A ``torch.nn.Linear`` with its default init drawn from ``generator``."""
    layer = torch.nn.Linear(in_features, out_features)
    torch_linear_init_(layer.weight, in_features, generator)
    torch_linear_init_(layer.bias, in_features, generator)
    return layer
