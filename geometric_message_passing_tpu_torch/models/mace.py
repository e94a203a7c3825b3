"""MACE, higher body-order equivariant message passing (port of
``models/mace.py::MACEModel``).

Each layer: TFN's ``TensorProductConvLayer`` (ungated, with the batch
norm when ``batch_norm``; its per-edge contraction is K7 and its sum onto
the senders K4 on the card), then ``EquivariantProductBasisBlock`` (the
symmetric contraction of the layer's output to ``correlation``, an
``IrrepsLinear`` and the previous ``h`` zero-padded to the hidden width as
the self-connection).  Node features start as an ``emb_dim x 0e``
embedding; ``hidden`` is ``hidden_irreps`` or ``emb_dim`` copies of every
SH irrep up to ``max_ell``.  Readout: the pooled features' scalar slice
``[:, :emb_dim]`` through Linear-ReLU-Linear, or with ``equivariant_pred``
one Linear (``pred``) over the whole pooled vector.

Tensor parallelism (``tp_axis``, ``tp_size``, ``mesh``; built by
``parallel.tp.tp_local_model`` with this rank's ``emb_dim`` and
``hidden_irreps``, 1/tp_size of the full model's): the layers run on this
rank's channels and sum their channel-mixing products over the axis
(``nn/conv.py``); the readout's first Linear is a ``RowParallelDense``
(``dense_0``, full width out, or ``pred``), ``dense_1`` is replicated.

Module names follow the flax tree (``emb_in``, ``convs[i]`` for ``conv_i``,
``prods[i]`` for ``prod_i``, ``dense_0``/``dense_1``, ``pred``), so
``weights.mace_from_jax`` carries a JAX model's values over.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..graph import GraphBatch
from ..irreps import Irreps
from ..nn.basic import Embedding, OutputLinear, RowParallelDense, linear
from ..nn.conv import (EquivariantProductBasisBlock, TensorProductConvLayer,
                       check_tp)
from ..nn.equivariant import pad_to_irreps, reshape_irreps
from ..ops.norms import safe_norm
from ..ops.radial import radial_embedding
from ..ops.spherical import spherical_harmonics
from .pooling import POOL

# the stages tp_precision may cover (the JAX package's tp_precision_scope)
SCOPES = ("all", "conv", "prod", "heads")


class MACEModel(nn.Module):
    """MACE with the JAX package's constructor surface (and defaults);
    ``forward(batch)`` returns ``[num_graphs, out_dim]``.

    Parameters are drawn on the CPU from ``generator`` (seeded with 0 when
    None), then moved to ``device`` (default ``"cuda"``, which raises when
    CUDA is absent).  ``tp_precision`` is the precision (``precision.py``)
    of the stages ``tp_precision_scope`` names, as in the JAX package
    (``_scoped_precision``): ``conv`` the edge products' stage 1, ``prod``
    the symmetric contraction and the product block's linear, ``all`` both,
    ``heads`` both and the conv layers' weight heads; every other product
    follows the process default.  ``weights_bf16`` makes the conv layers'
    weight heads emit bf16, as in TFN.  ``tp_axis`` needs ``mesh``
    (``ValueError`` otherwise).  ``config`` holds the constructor's
    arguments."""

    def __init__(self, r_max: float = 10.0, num_bessel: int = 8,
                 num_polynomial_cutoff: int = 5, max_ell: int = 2,
                 correlation: int = 3, num_layers: int = 5, emb_dim: int = 64,
                 hidden_irreps: Optional[str] = None, mlp_dim: int = 256,
                 in_dim: int = 1, out_dim: int = 1, aggr: str = "sum",
                 pool: str = "sum", batch_norm: bool = True,
                 residual: bool = True, equivariant_pred: bool = False,
                 tp_axis: Optional[str] = None, tp_size: int = 1,
                 weights_bf16: bool = False,
                 tp_precision: Optional[str] = "highest",
                 tp_precision_scope: str = "conv", *,
                 generator: Optional[torch.Generator] = None, device=None,
                 mesh=None):
        config = {k: v for k, v in locals().items()
                  if k not in ("self", "generator", "device", "mesh",
                               "__class__")}
        super().__init__()
        check_tp(tp_axis, tp_size, mesh, "MACEModel")
        self.config = config
        dev = resolve_device(device)
        if pool not in POOL:
            raise ValueError(f"pool must be one of {sorted(POOL)}, got {pool!r}")
        if tp_precision_scope not in SCOPES:
            raise ValueError(f"tp_precision_scope must be one of {SCOPES}, "
                             f"got {tp_precision_scope!r}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.tp_precision = tp_precision
        self.tp_precision_scope = tp_precision_scope
        self.r_max, self.num_bessel = r_max, num_bessel
        self.num_polynomial_cutoff, self.max_ell = num_polynomial_cutoff, max_ell
        self.correlation, self.num_layers = correlation, num_layers
        self.emb_dim, self.out_dim, self.pool = emb_dim, out_dim, pool
        self.equivariant_pred = equivariant_pred
        sh_irreps = Irreps.spherical_harmonics(max_ell)
        hidden = (Irreps(hidden_irreps) if hidden_irreps is not None
                  else (sh_irreps * emb_dim).sort().simplify())
        self.hidden_irreps = hidden

        self.emb_in = Embedding(in_dim, emb_dim)
        with torch.no_grad():
            self.emb_in.weight.normal_(0.0, 1.0, generator=generator)
        self.convs = nn.ModuleList()
        self.prods = nn.ModuleList()
        for i in range(num_layers):
            self.convs.append(TensorProductConvLayer(
                Irreps(f"{emb_dim}x0e") if i == 0 else hidden, hidden,
                sh_irreps, edge_dim=num_bessel, mlp_dim=mlp_dim, aggr=aggr,
                batch_norm=batch_norm, gate=False, weights_bf16=weights_bf16,
                tp_precision=self._scoped_precision("conv"),
                head_precision=self._scoped_precision("heads"),
                tp_axis=tp_axis, tp_size=tp_size, mesh=mesh,
                generator=generator))
            self.prods.append(EquivariantProductBasisBlock(
                hidden, hidden, correlation, use_sc=residual,
                element_dependent=False, num_elements=in_dim,
                tp_axis=tp_axis, tp_size=tp_size,
                precision=self._scoped_precision("prod"), mesh=mesh,
                generator=generator))
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

    def _scoped_precision(self, stage: str) -> Optional[str]:
        """``tp_precision`` where ``tp_precision_scope`` covers ``stage``
        (``conv``, ``prod`` or ``heads``), else None (the process
        default)."""
        if self.tp_precision is None:
            return None
        scopes = ("all", "heads") if stage != "heads" else ("heads",)
        return (self.tp_precision
                if self.tp_precision_scope in scopes + (stage,) else None)

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
        for conv, prod in zip(self.convs, self.prods):
            h_update = conv(h, batch.senders, batch.receivers, edge_sh,
                            edge_feats, edge_mask=batch.edge_mask,
                            node_mask=batch.node_mask)
            sc = pad_to_irreps(h, h_update.shape[-1])
            h = prod(reshape_irreps(h_update, self.hidden_irreps), sc)
        out = POOL[self.pool](h, batch)
        if self.equivariant_pred:
            return self.pred(out)
        return self.dense_1(torch.relu(self.dense_0(out[:, :self.emb_dim])))
