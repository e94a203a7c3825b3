"""TFN's force field over the 'uvu' edge tensor product (port of
``models/tfn_ff.py::TFNForceField``).

The zoo's ``TFNModel`` carries a fully connected per-edge weight tensor
(~94k floats an edge at 64 channels, max_ell 3), which cannot exist at box
scale.  This stack keeps TFN's macro-structure (embed -> L x [conv -> gate
-> zero-pad residual] -> invariant readout) with the conv swapped for the
interaction blocks' 'uvu' product and post-linear
(``nn.mace_blocks.RealAgnosticInteractionBlock``, edge chunks included).

On the card every segment sum is K4: each conv chunk's message sum, the
sum pool and the embedding's gradient (``nn.basic.Embedding``).

Module names follow the flax tree (``emb_in``, ``interactions[i]`` for
``interaction_i``, ``gates[i]`` for ``gates_i``, ``dense_0`` / ``dense_1``
for ``Dense_0`` / ``Dense_1``), so ``weights.tfn_ff_from_jax`` carries a
JAX model's values over.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from .. import resolve_device
from ..graph import GraphBatch
from ..irreps import Irreps
from ..nn.basic import Embedding, OutputLinear, linear
from ..nn.equivariant import (Activation, Gate, inverse_reshape_irreps,
                              irreps2gate, pad_to_irreps)
from ..nn.mace_blocks import RealAgnosticInteractionBlock
from .mace_ff import edge_geometry
from .pooling import POOL


class TFNForceField(nn.Module):
    """TFN-shaped force field with the JAX package's constructor surface and
    defaults: ``forward(batch)`` returns ``[num_graphs, out_dim]`` from the
    pooled features' scalar slice through Linear-ReLU-Linear.

    Parameters are drawn on the CPU from ``generator`` (seeded with 0 when
    None), then moved to ``device`` (default ``"cuda"``, which raises when
    CUDA is absent).  ``tp_precision`` is the precision of the interaction
    blocks' 'uvu' products and post-convolution linears (``precision.py``;
    the JAX default, None, follows the process default: exact f32 unless
    ``--matmul_precision`` lowers it)."""

    def __init__(self, r_max: float = 10.0, num_bessel: int = 8,
                 num_polynomial_cutoff: int = 5, max_ell: int = 2,
                 num_layers: int = 4, emb_dim: int = 64, in_dim: int = 8,
                 out_dim: int = 1, avg_num_neighbors: float = 12.0,
                 pool: str = "sum", gate: bool = True, residual: bool = True,
                 edge_chunk: Optional[int] = None,
                 node_chunk: Optional[int] = 16384,
                 tp_precision: Optional[str] = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if pool not in POOL:
            raise ValueError(f"pool must be one of {sorted(POOL)}, got {pool!r}")
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.r_max, self.num_bessel = r_max, num_bessel
        self.num_polynomial_cutoff, self.max_ell = num_polynomial_cutoff, max_ell
        self.in_dim, self.emb_dim, self.pool = in_dim, emb_dim, pool
        self.residual = residual
        sh_irreps = Irreps.spherical_harmonics(max_ell)
        hidden = (sh_irreps * emb_dim).sort().simplify()
        self.hidden_irreps = hidden
        attrs = Irreps(f"{in_dim}x0e")
        scalars = Irreps(f"{emb_dim}x0e")
        self.emb_in = Embedding(in_dim, emb_dim)
        with torch.no_grad():
            self.emb_in.weight.normal_(0.0, 1.0, generator=generator)
        self.interactions = nn.ModuleList(
            RealAgnosticInteractionBlock(
                attrs, scalars if i == 0 else hidden, sh_irreps,
                Irreps(f"{num_bessel}x0e"), hidden, hidden,
                avg_num_neighbors=avg_num_neighbors, edge_chunk=edge_chunk,
                node_chunk=node_chunk, precision=tp_precision,
                generator=generator)
            for i in range(num_layers))
        gate_scalars, gates, gated = irreps2gate(hidden)
        self.n_scalar = gate_scalars.dim
        self.gate = self.act = None
        if gate and gated.num_irreps > 0:
            # NequIP's gate: the conv targets the one-multiplicity hidden
            # irreps; the gates come from the update's own scalars
            self.gates = nn.ModuleList(linear(self.n_scalar, gates.dim,
                                              generator)
                                       for _ in range(num_layers))
            self.gate = Gate(gate_scalars, gates, gated)
        elif gate:
            self.act = Activation(hidden, act="silu")
        self.dense_0 = linear(emb_dim, emb_dim, generator)
        self.dense_1 = linear(emb_dim, out_dim, generator, OutputLinear)
        self.to(dev)

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        node_attrs = F.one_hot(batch.atoms.long(), self.in_dim).to(
            batch.pos.dtype)
        h = self.emb_in(batch.atoms)
        edge_sh, edge_feats = edge_geometry(batch, self.max_ell, self.r_max,
                                            self.num_bessel,
                                            self.num_polynomial_cutoff)
        ns = self.n_scalar
        for i, interaction in enumerate(self.interactions):
            m, _ = interaction(node_attrs, h, edge_sh, edge_feats,
                               batch.senders, batch.receivers, batch.edge_mask)
            h_update = inverse_reshape_irreps(m, self.hidden_irreps)
            if self.gate is not None:
                sc_part = h_update[:, :ns]
                h_update = self.gate(torch.cat(
                    [sc_part, self.gates[i](sc_part), h_update[:, ns:]],
                    dim=-1))
            elif self.act is not None:
                h_update = self.act(h_update)
            h = (h_update + pad_to_irreps(h, h_update.shape[-1])
                 if self.residual else h_update)
        out = POOL[self.pool](h, batch)[:, :self.emb_dim]
        return self.dense_1(torch.relu(self.dense_0(out)))
