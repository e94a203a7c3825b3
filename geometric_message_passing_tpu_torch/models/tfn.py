"""Tensor Field Network (port of ``models/tfn.py::TFNModel``).

Node features start as a ``emb_dim x 0e`` embedding and pass through
``num_layers`` ``TensorProductConvLayer``s whose output irreps are
``hidden`` (by default ``emb_dim`` copies of every SH irrep up to
``max_ell``), each with a zero-padded residual.  The edge geometry is the
vector ``pos[senders] - pos[receivers]``: its spherical harmonics and the
Bessel radial embedding of its length.  Readout: the pooled features'
scalar slice through Linear-ReLU-Linear, or with ``equivariant_pred`` one
Linear over the whole pooled vector, as in the JAX package.

Module names follow the flax tree (``emb_in``, ``convs[i]`` for ``conv_i``,
``dense_0``/``dense_1`` for ``Dense_0``/``Dense_1``, ``pred``), so
``weights.tfn_from_jax`` carries a JAX model's values over.

Tensor parallelism (``tp_axis``, ``tp_size``, ``mesh``): as in
``models/mace.py``; the gated convs keep one gates entry per gated irrep
(``nn/conv.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..graph import GraphBatch
from ..irreps import Irreps
from ..nn.basic import Embedding, OutputLinear, RowParallelDense, linear
from ..nn.conv import TensorProductConvLayer, check_tp
from ..nn.equivariant import pad_to_irreps
from ..ops.norms import safe_norm
from ..ops.radial import radial_embedding
from ..ops.spherical import spherical_harmonics
from .pooling import POOL


class TFNModel(nn.Module):
    """TFN with the JAX package's constructor surface (and defaults);
    ``forward(batch)`` returns ``[num_graphs, out_dim]``.

    Parameters are drawn on the CPU from ``generator`` (seeded with 0 when
    None), then moved to ``device`` (default ``"cuda"``, which raises when
    CUDA is absent).  ``tp_precision`` is the precision of the conv layers'
    edge products (stage 1; ``precision.py``; None: the process default);
    K7, their stage 2, computes exact f32 whatever it says.
    ``tp_axis`` needs ``mesh`` (``ValueError`` otherwise).  ``config``
    holds the constructor's arguments."""

    def __init__(self, r_max: float = 10.0, num_bessel: int = 8,
                 num_polynomial_cutoff: int = 5, max_ell: int = 2,
                 num_layers: int = 5, emb_dim: int = 64,
                 hidden_irreps: Optional[str] = None, mlp_dim: int = 256,
                 in_dim: int = 1, out_dim: int = 1, aggr: str = "sum",
                 pool: str = "first", gate: bool = True,
                 batch_norm: bool = False, residual: bool = True,
                 equivariant_pred: bool = False,
                 tp_axis: Optional[str] = None, tp_size: int = 1,
                 weights_bf16: bool = False,
                 tp_precision: Optional[str] = "highest", *,
                 generator: Optional[torch.Generator] = None, device=None,
                 mesh=None):
        config = {k: v for k, v in locals().items()
                  if k not in ("self", "generator", "device", "mesh",
                               "__class__")}
        super().__init__()
        check_tp(tp_axis, tp_size, mesh, "TFNModel")
        self.config = config
        dev = resolve_device(device)
        if pool not in POOL:
            raise ValueError(f"pool must be one of {sorted(POOL)}, got {pool!r}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.r_max, self.num_bessel = r_max, num_bessel
        self.num_polynomial_cutoff, self.max_ell = num_polynomial_cutoff, max_ell
        self.emb_dim, self.pool = emb_dim, pool
        self.residual, self.equivariant_pred = residual, equivariant_pred
        sh_irreps = Irreps.spherical_harmonics(max_ell)
        hidden = (Irreps(hidden_irreps) if hidden_irreps is not None
                  else (sh_irreps * emb_dim).sort().simplify())
        self.hidden_irreps = hidden

        self.emb_in = Embedding(in_dim, emb_dim)
        with torch.no_grad():
            self.emb_in.weight.normal_(0.0, 1.0, generator=generator)
        self.convs = nn.ModuleList(
            TensorProductConvLayer(
                Irreps(f"{emb_dim}x0e") if i == 0 else hidden, hidden,
                sh_irreps, edge_dim=num_bessel, mlp_dim=mlp_dim, aggr=aggr,
                batch_norm=batch_norm, gate=gate, weights_bf16=weights_bf16,
                tp_precision=tp_precision, tp_axis=tp_axis, tp_size=tp_size,
                mesh=mesh, generator=generator)
            for i in range(num_layers))
        if tp_axis is not None:
            if equivariant_pred:
                self.pred = RowParallelDense(hidden.dim, out_dim, mesh,
                                             tp_axis, generator=generator)
            else:
                self.dense_0 = RowParallelDense(emb_dim, emb_dim * tp_size,
                                                mesh, tp_axis,
                                                generator=generator)
                self.dense_1 = linear(emb_dim * tp_size, out_dim, generator,
                                      OutputLinear)
        elif equivariant_pred:
            self.pred = linear(hidden.dim, out_dim, generator, OutputLinear)
        else:
            self.dense_0 = linear(emb_dim, emb_dim, generator)
            self.dense_1 = linear(emb_dim, out_dim, generator, OutputLinear)
        self.to(dev)

    def edge_inputs(self, batch: GraphBatch):
        """``(edge_sh [E, (max_ell+1)^2], edge_feats [E, num_bessel])`` of
        the edge vectors ``pos[senders] - pos[receivers]``."""
        vectors = batch.pos[batch.senders] - batch.pos[batch.receivers]
        lengths = safe_norm(vectors, dim=-1, keepdim=True)
        return (spherical_harmonics(vectors, self.max_ell),
                radial_embedding(lengths, self.r_max, self.num_bessel,
                                 self.num_polynomial_cutoff))

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        h = self.emb_in(batch.atoms)
        edge_sh, edge_feats = self.edge_inputs(batch)
        for conv in self.convs:
            h_update = conv(h, batch.senders, batch.receivers, edge_sh,
                            edge_feats, edge_mask=batch.edge_mask,
                            node_mask=batch.node_mask)
            h = (h_update + pad_to_irreps(h, h_update.shape[-1])
                 if self.residual else h_update)
        out = POOL[self.pool](h, batch)
        if self.equivariant_pred:
            return self.pred(out)
        return self.dense_1(torch.relu(self.dense_0(out[:, :self.emb_dim])))
