"""E(n)-equivariant GNN and the positions-blind MPNN baseline (port of
``models/egnn.py``: ``EGNNLayer``, ``EGNNModel``, ``MPNNLayer``,
``MPNNModel``).

Two paths through a layer, as in the JAX package:

* plain: gathers by indexing and masked segment reductions
  (``ops.scatter``, ``index_add_``), with ``aggr`` sum, mean or max;
* box scale, given ``seg_plans`` (``ops.sorted_segsum.batch_seg_plans``):
  every segment reduction and every gather's backward runs the sorted
  segment sum (the hand-written kernel on the card); sum aggregation only.

Module names follow the flax tree (``emb_in``, ``convs[i]`` for ``conv_i``
with ``mlp_msg``/``mlp_pos``/``mlp_upd``, ``dense_0``/``dense_1`` or
``pred``), so ``weights.egnn_from_jax`` and ``weights.mpnn_from_jax`` carry
a JAX model's values over.  The MPNN's sums are ``ops.scatter.segment_sum``
(K4 on the card).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .. import resolve_device
from ..graph import GraphBatch
from ..nn.basic import Embedding, MLP, OutputLinear, linear
from ..ops.norms import safe_norm
from ..ops.scatter import segment_max, segment_mean, segment_sum
from ..ops.sorted_segsum import SegmentPlan, sorted_gather, sorted_segment_sum
from .pooling import POOL

_AGGR = {"sum": segment_sum, "add": segment_sum, "mean": segment_mean,
         "max": segment_max}


class EGNNLayer(nn.Module):
    """One EGNN layer.  Message ``m_ij = MLP([h_i, h_j, |x_i - x_j|])``,
    position message ``(x_i - x_j) * MLP_pos(m_ij)``; ``aggr`` of the
    messages and the mean of the position messages at each receiver; returns
    ``(MLP_upd([h, m_agg]), x + pos_agg)``."""

    def __init__(self, emb_dim: int, activation: str = "relu",
                 norm: Optional[str] = "layer", aggr: str = "add", *,
                 generator: torch.Generator):
        super().__init__()
        if aggr not in _AGGR:
            raise ValueError(f"aggr must be one of {sorted(_AGGR)}, got {aggr!r}")
        d = emb_dim
        self.aggr = aggr
        self.mlp_msg = MLP(2 * d + 1, (d, d), activation, norm,
                           generator=generator)
        self.mlp_pos = MLP(d, (d, 1), activation, norm, norm_final=False,
                           act_final=False, generator=generator)
        self.mlp_upd = MLP(2 * d, (d, d), activation, norm, generator=generator)

    def message(self, h_i, h_j, dists):
        msg = self.mlp_msg(torch.cat([h_i, h_j, dists], dim=-1))
        return msg, self.mlp_pos(msg)

    def update(self, h, msg_aggr):
        return self.mlp_upd(torch.cat([h, msg_aggr], dim=-1))

    def forward(self, h: torch.Tensor, pos: torch.Tensor,
                senders: torch.Tensor, receivers: torch.Tensor,
                edge_mask: torch.Tensor,
                seg_plans: Optional[Dict[str, SegmentPlan]] = None):
        if seg_plans is not None:
            if self.aggr not in ("sum", "add"):
                raise ValueError(
                    "seg_plans (the sorted segment-sum path) only supports "
                    f"aggr='sum'/'add', got {self.aggr!r}; drop seg_plans to "
                    "use the plain path with this aggregation")
            rcv, snd = seg_plans["rcv"], seg_plans["snd"]
            h_i = sorted_gather(h, receivers, rcv, edge_mask)
            h_j = sorted_gather(h, senders, snd, edge_mask)
            pos_diff = (sorted_gather(pos, receivers, rcv, edge_mask)
                        - sorted_gather(pos, senders, snd, edge_mask))
            dists = safe_norm(pos_diff, keepdim=True)
            msg, scale = self.message(h_i, h_j, dists)
            pos_msg = pos_diff * scale
            msg_aggr = sorted_segment_sum(msg, rcv, receivers, edge_mask)
            pc = sorted_segment_sum(torch.cat([pos_msg, torch.ones_like(scale)],
                                              dim=-1), rcv, receivers, edge_mask)
            pos_aggr = pc[:, :3] / torch.clamp_min(pc[:, 3:], 1.0)
        else:
            n = h.shape[0]
            h_i, h_j = h[receivers], h[senders]       # i = target, j = source
            pos_diff = pos[receivers] - pos[senders]
            dists = safe_norm(pos_diff, keepdim=True)
            msg, scale = self.message(h_i, h_j, dists)
            msg_aggr = _AGGR[self.aggr](msg, receivers, n, mask=edge_mask)
            pos_aggr = segment_mean(pos_diff * scale, receivers, n,
                                    mask=edge_mask)
        return self.update(h, msg_aggr), pos + pos_aggr


class EGNNModel(nn.Module):
    """EGNN with the JAX package's constructor surface; ``forward(batch,
    seg_plans=None)`` returns ``[num_graphs, out_dim]``.  Positions are
    updated without a residual; ``h`` with one when ``residual``.

    Parameters are drawn on the CPU from ``generator`` (seeded with 0 when
    None), then moved to ``device`` (default ``"cuda"``, which raises when
    CUDA is absent)."""

    def __init__(self, num_layers: int = 5, emb_dim: int = 128,
                 in_dim: int = 1, out_dim: int = 1, activation: str = "relu",
                 norm: Optional[str] = "layer", aggr: str = "sum",
                 pool: str = "sum", residual: bool = True,
                 equivariant_pred: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        if pool not in POOL:
            raise ValueError(f"pool must be one of {sorted(POOL)}, got {pool!r}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_layers, self.emb_dim = num_layers, emb_dim
        self.pool, self.residual = pool, residual
        self.equivariant_pred = equivariant_pred
        self.emb_in = Embedding(in_dim, emb_dim)
        with torch.no_grad():
            self.emb_in.weight.normal_(0.0, 1.0, generator=generator)
        self.convs = nn.ModuleList(
            EGNNLayer(emb_dim, activation, norm, aggr, generator=generator)
            for _ in range(num_layers))
        if equivariant_pred:
            self.pred = linear(emb_dim + 3, out_dim, generator, OutputLinear)
        else:
            self.dense_0 = linear(emb_dim, emb_dim, generator)
            self.dense_1 = linear(emb_dim, out_dim, generator, OutputLinear)
        self.to(dev)

    def forward(self, batch: GraphBatch,
                seg_plans: Optional[Dict[str, SegmentPlan]] = None
                ) -> torch.Tensor:
        h = self.emb_in(batch.atoms)
        pos = batch.pos
        for conv in self.convs:
            h_update, pos = conv(h, pos, batch.senders, batch.receivers,
                                 batch.edge_mask, seg_plans=seg_plans)
            h = h + h_update if self.residual else h_update
        pool = POOL[self.pool]
        if self.equivariant_pred:
            return self.pred(pool(torch.cat([h, pos], dim=-1), batch))
        return self.dense_1(torch.relu(self.dense_0(pool(h, batch))))


class MPNNLayer(nn.Module):
    """One MPNN layer: message ``MLP([h_i, h_j])`` (i the receiver),
    ``aggr`` of the messages at each receiver, update
    ``MLP([h, m_agg])``."""

    def __init__(self, emb_dim: int, activation: str = "relu",
                 norm: Optional[str] = "layer", aggr: str = "add", *,
                 generator: torch.Generator):
        super().__init__()
        if aggr not in _AGGR:
            raise ValueError(f"aggr must be one of {sorted(_AGGR)}, got {aggr!r}")
        d = emb_dim
        self.aggr = aggr
        self.mlp_msg = MLP(2 * d, (d, d), activation, norm, generator=generator)
        self.mlp_upd = MLP(2 * d, (d, d), activation, norm, generator=generator)

    def forward(self, h: torch.Tensor, senders: torch.Tensor,
                receivers: torch.Tensor, edge_mask: torch.Tensor
                ) -> torch.Tensor:
        msg = self.mlp_msg(torch.cat([h[receivers], h[senders]], dim=-1))
        msg_aggr = _AGGR[self.aggr](msg, receivers, h.shape[0], mask=edge_mask)
        return self.mlp_upd(torch.cat([h, msg_aggr], dim=-1))


class MPNNModel(nn.Module):
    """The positions-blind MPNN with the JAX package's constructor surface
    (and defaults); ``forward(batch)`` returns ``[num_graphs, out_dim]``
    through the pool and Linear-ReLU-Linear.

    Parameters are drawn on the CPU from ``generator`` (seeded with 0 when
    None), then moved to ``device`` (default ``"cuda"``, which raises when
    CUDA is absent)."""

    def __init__(self, num_layers: int = 4, emb_dim: int = 64,
                 in_dim: int = 1, out_dim: int = 1, activation: str = "relu",
                 norm: Optional[str] = "layer", aggr: str = "sum",
                 pool: str = "sum", residual: bool = True, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        if pool not in POOL:
            raise ValueError(f"pool must be one of {sorted(POOL)}, got {pool!r}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_layers, self.emb_dim, self.out_dim = num_layers, emb_dim, out_dim
        self.pool, self.residual = pool, residual
        self.emb_in = Embedding(in_dim, emb_dim)
        with torch.no_grad():
            self.emb_in.weight.normal_(0.0, 1.0, generator=generator)
        self.convs = nn.ModuleList(
            MPNNLayer(emb_dim, activation, norm, aggr, generator=generator)
            for _ in range(num_layers))
        self.dense_0 = linear(emb_dim, emb_dim, generator)
        self.dense_1 = linear(emb_dim, out_dim, generator, OutputLinear)
        self.to(dev)

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        h = self.emb_in(batch.atoms)
        for conv in self.convs:
            h_update = conv(h, batch.senders, batch.receivers, batch.edge_mask)
            h = h + h_update if self.residual else h_update
        out = POOL[self.pool](h, batch)
        return self.dense_1(torch.relu(self.dense_0(out)))
