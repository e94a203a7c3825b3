"""The geometric-GNN-101 teaching models (port of ``models/gnn101.py``):
``MPNN101Layer``, ``InvariantMPNNLayer``, ``EquivariantMPNNLayer`` and the
models ``CoordMPNNModel``, ``InvariantMPNNModel``, ``FinalMPNNModel``.  The
notebook's first model is ``models.egnn.MPNNModel``.

The contract is the JAX package's (``tests/test_gnn101.py``): the three
models are permutation invariant; ``CoordMPNNModel`` (raw coordinates in
the node features) is NOT rotation invariant, by design; the invariant and
final models are invariant to rotations and translations; the equivariant
layer's positions rotate with the input while its features do not.

Layer MLPs are ``_BNMLP``: Linear -> BatchNorm -> ReLU, twice, with flax's
statistics (``nn.basic.BatchNorm``, momentum 0.99 as flax's default, eps
1e-5) over every row of the padded batch, pad rows included.  Train or
eval mode is the module's (``model.train()`` / ``model.eval()``); the JAX
``train`` argument has no twin.  Every sum and mean is
``ops.scatter.segment_sum`` / ``segment_mean`` (K4 on the card): per
forward, one K4 a layer for the message sum, two more for the equivariant
layer's position mean, and two for the mean pool.

Initialisation follows flax's default ``Dense``, as the JAX models do: a
LeCun truncated normal kernel (std ``sqrt(1 / fan_in) / 0.8796``, cut at
two standard deviations) and a zero bias, drawn from ``generator``.  This
differs from the torch-style ``nn.basic.linear`` of the other port models.
Module names follow the flax tree (``dense_k`` for ``Dense_k``,
``bnmlp_k`` for ``_BNMLP_k``, ``layers[k]`` for the layers), so
``weights.gnn101_from_jax`` carries a JAX model's values over.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from .. import resolve_device
from ..graph import GraphBatch
from ..nn.basic import BatchNorm
from ..ops.norms import safe_norm
from ..ops.scatter import segment_mean, segment_sum
from .pooling import POOL

# flax's truncated-normal std correction: the std of a unit normal cut at +-2
_TRUNC_STD = 0.87962566103423978


def flax_dense(in_features: int, out_features: int,
               generator: torch.Generator) -> nn.Linear:
    """A ``torch.nn.Linear`` with flax's default ``Dense`` init drawn from
    ``generator``: LeCun truncated normal weight, zero bias."""
    layer = nn.Linear(in_features, out_features)
    std = math.sqrt(1.0 / in_features) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        layer.bias.zero_()
    return layer


class _BNMLP(nn.Module):
    """Linear -> BatchNorm -> ReLU, twice (the notebook's message and
    update MLP); ``dense[k]`` / ``norm[k]`` are flax's ``Dense_k`` /
    ``BatchNorm_k``."""

    def __init__(self, in_dim: int, emb_dim: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.dense = nn.ModuleList([flax_dense(in_dim, emb_dim, generator),
                                    flax_dense(emb_dim, emb_dim, generator)])
        self.norm = nn.ModuleList(BatchNorm(emb_dim, momentum=0.99, eps=1e-5)
                                  for _ in range(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for dense, norm in zip(self.dense, self.norm):
            x = torch.relu(norm(dense(x)))
        return x


class MPNN101Layer(nn.Module):
    """Message ``psi([h_i, h_j, e_ij])`` (i the receiver), sum at each
    receiver, update ``phi([h_i, m_i])``."""

    def __init__(self, emb_dim: int = 64, edge_dim: int = 4, *,
                 generator: torch.Generator):
        super().__init__()
        self.bnmlp_0 = _BNMLP(2 * emb_dim + edge_dim, emb_dim,
                              generator=generator)
        self.bnmlp_1 = _BNMLP(2 * emb_dim, emb_dim, generator=generator)

    def forward(self, h, senders, receivers, edge_attr, edge_mask):
        msg = self.bnmlp_0(torch.cat([h[receivers], h[senders], edge_attr], -1))
        aggr = segment_sum(msg, receivers, h.shape[0], mask=edge_mask)
        return self.bnmlp_1(torch.cat([h, aggr], -1))


class InvariantMPNNLayer(nn.Module):
    """``MPNN101Layer`` whose messages also see the edge length
    ``|x_i - x_j|``: invariant to rotations and translations."""

    def __init__(self, emb_dim: int = 64, edge_dim: int = 4, *,
                 generator: torch.Generator):
        super().__init__()
        self.bnmlp_0 = _BNMLP(2 * emb_dim + 1 + edge_dim, emb_dim,
                              generator=generator)
        self.bnmlp_1 = _BNMLP(2 * emb_dim, emb_dim, generator=generator)

    def forward(self, h, pos, senders, receivers, edge_attr, edge_mask):
        dists = safe_norm(pos[receivers] - pos[senders], keepdim=True)
        msg = self.bnmlp_0(torch.cat([h[receivers], h[senders], dists,
                                      edge_attr], -1))
        aggr = segment_sum(msg, receivers, h.shape[0], mask=edge_mask)
        return self.bnmlp_1(torch.cat([h, aggr], -1))


class EquivariantMPNNLayer(nn.Module):
    """EGNN-style: invariant messages, plus positions moved by the mean of
    ``(x_i - x_j) * scale(m_ij)`` at each receiver, with the scale head
    ``Dense(emb) -> ReLU -> Dense(1)``; returns ``(h_new, pos + pos_aggr)``.
    Flax names the head's outer ``Dense(1)`` ``Dense_0`` (it is built
    first) and the inner ``Dense(emb)`` ``Dense_1``: ``dense_0`` /
    ``dense_1`` here."""

    def __init__(self, emb_dim: int = 64, edge_dim: int = 4, *,
                 generator: torch.Generator):
        super().__init__()
        self.bnmlp_0 = _BNMLP(2 * emb_dim + 1 + edge_dim, emb_dim,
                              generator=generator)
        self.dense_1 = flax_dense(emb_dim, emb_dim, generator)
        self.dense_0 = flax_dense(emb_dim, 1, generator)
        self.bnmlp_1 = _BNMLP(2 * emb_dim, emb_dim, generator=generator)

    def forward(self, h, pos, senders, receivers, edge_attr, edge_mask):
        n = h.shape[0]
        pos_diff = pos[receivers] - pos[senders]
        dists = safe_norm(pos_diff, keepdim=True)
        msg = self.bnmlp_0(torch.cat([h[receivers], h[senders], dists,
                                      edge_attr], -1))
        scale = self.dense_0(torch.relu(self.dense_1(msg)))
        aggr = segment_sum(msg, receivers, n, mask=edge_mask)
        pos_aggr = segment_mean(pos_diff * scale, receivers, n, mask=edge_mask)
        h_new = self.bnmlp_1(torch.cat([h, aggr], -1))
        return h_new, pos + pos_aggr


def _edge_attr_or_zeros(batch: GraphBatch, edge_attr: Optional[torch.Tensor],
                        edge_dim: int) -> torch.Tensor:
    if edge_attr is not None:
        return edge_attr
    return batch.pos.new_zeros((batch.senders.shape[0], edge_dim))


class _Model101(nn.Module):
    """Input Dense on the one-hot atom types (``pos`` too with
    ``coords``), ``num_layers`` residual layers, mean pool, output Dense.
    Weights are drawn on the CPU from ``generator`` (seeded with 0 when
    None), then moved to ``device`` (default
    ``"cuda"``, which raises when CUDA is absent)."""

    layer_cls = MPNN101Layer
    coords = False

    def __init__(self, num_layers: int = 4, emb_dim: int = 64,
                 in_dim: int = 11, edge_dim: int = 4, out_dim: int = 1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_layers, self.emb_dim = num_layers, emb_dim
        self.in_dim, self.edge_dim, self.out_dim = in_dim, edge_dim, out_dim
        self.dense_0 = flax_dense(in_dim + (3 if self.coords else 0), emb_dim,
                                  generator)
        self.layers = nn.ModuleList(
            self.layer_cls(emb_dim, edge_dim, generator=generator)
            for _ in range(num_layers))
        self.dense_1 = flax_dense(emb_dim, out_dim, generator)
        self.to(dev)

    def embed(self, batch: GraphBatch) -> torch.Tensor:
        feats = F.one_hot(batch.atoms.long(), self.in_dim).to(batch.pos.dtype)
        if self.coords:
            feats = torch.cat([feats, batch.pos], -1)
        return self.dense_0(feats)

    def readout(self, h: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
        return self.dense_1(POOL["mean"](h, batch))


class CoordMPNNModel(_Model101):
    """Raw coordinates concatenated into the initial node features, then
    ``MPNN101Layer``s: fits a fixed frame, provably NOT rotation invariant
    (the notebook's lesson)."""

    coords = True

    def forward(self, batch: GraphBatch,
                edge_attr: Optional[torch.Tensor] = None) -> torch.Tensor:
        ea = _edge_attr_or_zeros(batch, edge_attr, self.edge_dim)
        h = self.embed(batch)
        for layer in self.layers:
            h = h + layer(h, batch.senders, batch.receivers, ea,
                          batch.edge_mask)
        return self.readout(h, batch)


class InvariantMPNNModel(_Model101):
    """Distance-conditioned messages (``InvariantMPNNLayer``): E(3)
    invariant."""

    layer_cls = InvariantMPNNLayer

    def forward(self, batch: GraphBatch,
                edge_attr: Optional[torch.Tensor] = None) -> torch.Tensor:
        ea = _edge_attr_or_zeros(batch, edge_attr, self.edge_dim)
        h = self.embed(batch)
        for layer in self.layers:
            h = h + layer(h, batch.pos, batch.senders, batch.receivers, ea,
                          batch.edge_mask)
        return self.readout(h, batch)


class FinalMPNNModel(_Model101):
    """Equivariant layers (``EquivariantMPNNLayer``), invariant readout
    over ``h``."""

    layer_cls = EquivariantMPNNLayer

    def forward(self, batch: GraphBatch,
                edge_attr: Optional[torch.Tensor] = None) -> torch.Tensor:
        ea = _edge_attr_or_zeros(batch, edge_attr, self.edge_dim)
        h = self.embed(batch)
        pos = batch.pos
        for layer in self.layers:
            h_new, pos = layer(h, pos, batch.senders, batch.receivers, ea,
                               batch.edge_mask)
            h = h + h_new
        return self.readout(h, batch)
