"""SchNet, invariant continuous-filter convolutions (port of
``models/schnet.py``).

Kept as the JAX package has them: the embedding table has 100 rows whatever
``in_dim`` is; the edge length is that of ``pos[senders] - pos[receivers]``;
the message ``x[senders] * W`` is summed at the receivers; the model's
``cutoff`` (default 10.0) sets both the Gaussian grid and the cosine cutoff,
whatever radius built the graph.  Given ``seg_plans``, the sender gather's
backward and the receiver sum run the sorted segment sum (the hand-written
kernel on the card).

Module names follow the flax tree (``embedding``, ``interactions[i]`` for
``interaction_i`` with ``dense_0``..``dense_4``, ``dense_0``/``dense_1``),
so ``weights.schnet_from_jax`` carries a JAX model's values over.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn
from torch.nn import functional as F

from .. import resolve_device
from ..graph import GraphBatch
from ..nn.basic import Embedding, OutputLinear
from ..ops.norms import safe_norm
from ..ops.radial import gaussian_smearing
from ..ops.scatter import segment_sum
from ..ops.sorted_segsum import SegmentPlan, sorted_gather, sorted_segment_sum
from .pooling import POOL


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x) - math.log(2.0)


def _xavier_linear(in_features: int, out_features: int,
                   generator: torch.Generator, bias: bool = True,
                   cls=nn.Linear) -> nn.Linear:
    """A ``cls`` (``nn.Linear`` or ``OutputLinear``) with a Glorot-uniform
    weight from ``generator`` and a zero bias (PyG SchNet's
    ``reset_parameters``)."""
    layer = cls(in_features, out_features, bias=bias)
    bound = math.sqrt(6.0 / (in_features + out_features))
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        if bias:
            layer.bias.zero_()
    return layer


class SchNetInteraction(nn.Module):
    """CFConv with its filter network and output transform: filter
    ``W = Dense(ssp(Dense(edge_attr))) * cosine_cutoff``, message
    ``x_j * W`` with ``x = Dense(h)``, summed at the receivers, then
    ``Dense(ssp(Dense(.)))``."""

    def __init__(self, hidden_channels: int, num_filters: int,
                 num_gaussians: int, cutoff: float, *,
                 generator: torch.Generator):
        super().__init__()
        self.cutoff = cutoff
        self.dense_0 = _xavier_linear(num_gaussians, num_filters, generator)
        self.dense_1 = _xavier_linear(num_filters, num_filters, generator)
        self.dense_2 = _xavier_linear(hidden_channels, num_filters, generator,
                                      bias=False)
        self.dense_3 = _xavier_linear(num_filters, hidden_channels, generator)
        self.dense_4 = _xavier_linear(hidden_channels, hidden_channels,
                                      generator)

    def forward(self, h, senders, receivers, edge_weight, edge_attr,
                edge_mask, seg_plans: Optional[Dict[str, SegmentPlan]] = None):
        W = self.dense_1(shifted_softplus(self.dense_0(edge_attr)))
        C = 0.5 * (torch.cos(edge_weight * math.pi / self.cutoff) + 1.0)
        W = W * (C * (edge_weight < self.cutoff))[:, None]
        x = self.dense_2(h)
        if seg_plans is not None:
            msg = sorted_gather(x, senders, seg_plans["snd"], edge_mask) * W
            x = sorted_segment_sum(msg, seg_plans["rcv"], receivers, edge_mask)
        else:
            x = segment_sum(x[senders] * W, receivers, h.shape[0],
                            mask=edge_mask)
        return self.dense_4(shifted_softplus(self.dense_3(x)))


class SchNetModel(nn.Module):
    """SchNet with the JAX package's constructor surface (and defaults);
    ``forward(batch, seg_plans=None)`` returns ``[num_graphs, out_dim]``.
    ``in_dim`` and ``max_num_neighbors`` are accepted and unused, as there.

    Parameters are drawn on the CPU from ``generator`` (seeded with 0 when
    None), then moved to ``device`` (default ``"cuda"``, which raises when
    CUDA is absent)."""

    def __init__(self, hidden_channels: int = 128, in_dim: int = 1,
                 out_dim: int = 1, num_filters: int = 128, num_layers: int = 6,
                 num_gaussians: int = 50, cutoff: float = 10.0,
                 max_num_neighbors: int = 32, pool: str = "sum", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        if pool not in POOL:
            raise ValueError(f"pool must be one of {sorted(POOL)}, got {pool!r}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cutoff, self.num_gaussians, self.pool = cutoff, num_gaussians, pool
        self.embedding = Embedding(100, hidden_channels)
        with torch.no_grad():
            self.embedding.weight.normal_(0.0, 1.0, generator=generator)
        self.interactions = nn.ModuleList(
            SchNetInteraction(hidden_channels, num_filters, num_gaussians,
                              cutoff, generator=generator)
            for _ in range(num_layers))
        self.dense_0 = _xavier_linear(hidden_channels, hidden_channels // 2,
                                      generator)
        self.dense_1 = _xavier_linear(hidden_channels // 2, out_dim, generator,
                                      cls=OutputLinear)
        self.to(dev)

    def forward(self, batch: GraphBatch,
                seg_plans: Optional[Dict[str, SegmentPlan]] = None
                ) -> torch.Tensor:
        h = self.embedding(batch.atoms)
        edge_weight = safe_norm(batch.pos[batch.senders]
                                - batch.pos[batch.receivers])
        edge_attr = gaussian_smearing(edge_weight, 0.0, self.cutoff,
                                      self.num_gaussians)
        for interaction in self.interactions:
            h = h + interaction(h, batch.senders, batch.receivers, edge_weight,
                                edge_attr, batch.edge_mask, seg_plans=seg_plans)
        out = shifted_softplus(self.dense_0(POOL[self.pool](h, batch)))
        return self.dense_1(out)
