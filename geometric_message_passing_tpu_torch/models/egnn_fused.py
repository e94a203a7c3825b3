"""EGNN over the fused message kernel (port of ``models/egnn_fused.py``,
per-layer strategy).

Each layer's gather -> message MLP -> position scaling -> masked receiver
sums is one call of ``ops.edge.egnn_message`` (the hand-written CUDA kernel
on the card, its plain version on the CPU); the node update MLP and the
readout are plain tensor ops between calls.  Parameters keep the flax names
and shapes of the JAX model (``msg_w1 [2d+1, d]`` ... ``upd_ln2_bias``), so
``weights.egnn_fused_from_jax`` carries a JAX model's values over exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .. import resolve_device
from ..graph import GraphBatch
from ..nn.basic import linear, torch_linear_init_
from ..ops.edge import egnn_message, layernorm, pack_egnn_weights
from .pooling import POOL

# (name, shape as a function of d, init): init is ("linear", fan_in(d)) for
# torch-Linear uniform draws, or "ones" / "zeros" for LayerNorm affines
_LAYER_PARAMS = (
    ("msg_w1", lambda d: (2 * d + 1, d), ("linear", lambda d: 2 * d + 1)),
    ("msg_b1", lambda d: (d,), ("linear", lambda d: 2 * d + 1)),
    ("msg_ln1_scale", lambda d: (d,), "ones"),
    ("msg_ln1_bias", lambda d: (d,), "zeros"),
    ("msg_w2", lambda d: (d, d), ("linear", lambda d: d)),
    ("msg_b2", lambda d: (d,), ("linear", lambda d: d)),
    ("msg_ln2_scale", lambda d: (d,), "ones"),
    ("msg_ln2_bias", lambda d: (d,), "zeros"),
    ("pos_w1", lambda d: (d, d), ("linear", lambda d: d)),
    ("pos_b1", lambda d: (d,), ("linear", lambda d: d)),
    ("pos_ln1_scale", lambda d: (d,), "ones"),
    ("pos_ln1_bias", lambda d: (d,), "zeros"),
    ("pos_w2", lambda d: (d, 1), ("linear", lambda d: d)),
    ("pos_b2", lambda d: (1,), ("linear", lambda d: d)),
    ("upd_w1", lambda d: (2 * d, d), ("linear", lambda d: 2 * d)),
    ("upd_b1", lambda d: (d,), ("linear", lambda d: 2 * d)),
    ("upd_ln1_scale", lambda d: (d,), "ones"),
    ("upd_ln1_bias", lambda d: (d,), "zeros"),
    ("upd_w2", lambda d: (d, d), ("linear", lambda d: d)),
    ("upd_b2", lambda d: (d,), ("linear", lambda d: d)),
    ("upd_ln2_scale", lambda d: (d,), "ones"),
    ("upd_ln2_bias", lambda d: (d,), "zeros"),
)
_MSG_PARAMS = tuple(name for name, _, _ in _LAYER_PARAMS
                    if not name.startswith("upd_"))


class FusedEGNNLayer(nn.Module):
    """EGNN layer (layer norm + relu; sum aggregation for messages, mean for
    positions).  Returns ``(h_update, new_pos)``; the model adds the
    residual to ``h``."""

    def __init__(self, emb_dim: int, generator: torch.Generator):
        super().__init__()
        self.emb_dim = d = emb_dim
        for name, shape, init in _LAYER_PARAMS:
            t = torch.empty(shape(d))
            if init == "ones":
                t.fill_(1.0)
            elif init == "zeros":
                t.zero_()
            else:
                torch_linear_init_(t, init[1](d), generator)
            self.register_parameter(name, nn.Parameter(t))

    def packed(self) -> torch.Tensor:
        """The ``[4d+12, d]`` message rows the kernel reads."""
        return pack_egnn_weights({n: getattr(self, n) for n in _MSG_PARAMS})

    def forward(self, h: torch.Tensor, pos: torch.Tensor,
                senders: torch.Tensor, receivers: torch.Tensor,
                edge_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        msg_aggr, pos_sum, cnt = egnn_message(senders, receivers, edge_mask,
                                              h, pos, self.packed())
        pos_aggr = pos_sum / torch.clamp_min(cnt, 1.0)
        u_in = torch.cat([h, msg_aggr], dim=-1)
        u = torch.relu(layernorm(u_in @ self.upd_w1 + self.upd_b1,
                                 self.upd_ln1_scale, self.upd_ln1_bias))
        upd = torch.relu(layernorm(u @ self.upd_w2 + self.upd_b2,
                                   self.upd_ln2_scale, self.upd_ln2_bias))
        return upd, pos + pos_aggr


class EGNNFusedModel(nn.Module):
    """EGNN model over ``FusedEGNNLayer`` (relu, layernorm, sum aggregation,
    residual h, non-residual pos).  ``forward(batch)`` returns
    ``[num_graphs, out_dim]``.

    Parameters are drawn on the CPU from ``generator`` (a fresh generator
    seeded with 0 when None), then moved to ``device`` (default ``"cuda"``,
    which raises when CUDA is absent)."""

    def __init__(self, num_layers: int = 5, emb_dim: int = 128,
                 in_dim: int = 1, out_dim: int = 1, pool: str = "sum",
                 residual: bool = True, equivariant_pred: bool = False, *,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        if pool not in POOL:
            raise ValueError(f"pool must be one of {sorted(POOL)}, got {pool!r}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_layers, self.emb_dim = num_layers, emb_dim
        self.in_dim, self.out_dim = in_dim, out_dim
        self.pool, self.residual = pool, residual
        self.equivariant_pred = equivariant_pred

        self.emb_in = nn.Embedding(in_dim, emb_dim)
        with torch.no_grad():
            self.emb_in.weight.normal_(0.0, 1.0, generator=generator)
        self.convs = nn.ModuleList(
            FusedEGNNLayer(emb_dim, generator) for _ in range(num_layers))
        if equivariant_pred:
            self.pred = linear(emb_dim + 3, out_dim, generator)
        else:
            self.dense_0 = linear(emb_dim, emb_dim, generator)
            self.dense_1 = linear(emb_dim, out_dim, generator)
        self.to(dev)

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        h = self.emb_in(batch.atoms)
        pos = batch.pos
        for conv in self.convs:
            h_update, pos = conv(h, pos, batch.senders, batch.receivers,
                                 batch.edge_mask)
            h = h + h_update if self.residual else h_update
        pool = POOL[self.pool]
        if self.equivariant_pred:
            return self.pred(pool(torch.cat([h, pos], dim=-1), batch))
        out = torch.relu(self.dense_0(pool(h, batch)))
        return self.dense_1(out)

