"""MACE's force field over the real interaction blocks (port of
``models/mace_ff.py::MACEForceField``).

The zoo's ``MACEModel`` carries a fully connected per-edge weight tensor,
O(E * mul^2 * paths) floats, which cannot exist at box scale.  This stack
takes the interaction blocks' 'uvu' product instead, O(E * paths * mul):

    embed -> [ interaction ('uvu' conv) -> product basis (symmetric
               contraction) -> per-layer linear readout ] x L
          -> per-graph energy, the sum of every layer's readout pooled

On the card every segment sum is K4: each conv chunk's message sum and
each layer's pool.  The products (the 'uvu' product, the weight MLP, the
self-connection and the symmetric contraction) are PyTorch's in f32: none
is a kernel in the JAX package.  ``edge_chunk`` and ``node_chunk`` bound the
per-edge and per-node intermediates (``nn.mace_blocks._InteractionBase
._conv``, ``nn.conv.EquivariantProductBasisBlock``).

Module names follow the flax tree (``node_embedding``, ``interactions[i]``
for ``interaction_i``, ``products[i]`` for ``product_i``, ``readouts[i]``
for ``readout_i``), so ``weights.mace_ff_from_jax`` carries a JAX model's
values over.

Edge-partitioned execution ("gp", ``parallel.halo``): built with
``gp_axis`` and ``mesh`` and called with ``halo_plan`` (this rank's slice,
``HaloPlan.local(rank)``) on this rank's part of the batch
(``halo.gp_rank_batch``: node rows by block, edges on their receiver's
owner with ``senders`` catalog indices, ``receivers`` local rows).  The
positions are exchanged once into a catalog for the edge geometry; each
layer exchanges the flat irreps row after ``linear_up`` (one all-to-all);
the per-graph energies are summed over the axis, so every rank returns
the whole ``[G, 1]``.  That sum is ``differentiable.psum_replicated``:
every rank differentiates the same loss, so the backward passes the
cotangent through, and the ranks' parameter gradients are then summed
over the axis (``parallel.data.all_reduce_grads``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from .. import resolve_device
from ..graph import GraphBatch
from ..irreps import Irreps
from ..nn.conv import EquivariantProductBasisBlock
from ..nn.equivariant import IrrepsLinear
from ..nn.mace_blocks import interaction_classes
from ..ops.norms import safe_norm
from ..ops.radial import radial_embedding
from ..ops.spherical import spherical_harmonics
from ..parallel.halo import halo_catalog
from ..parallel.mesh import differentiable
from .pooling import POOL

# the blocks that return (message, self-connection or None)
FF_INTERACTIONS = ("RealAgnosticResidualInteractionBlock",
                   "RealAgnosticInteractionBlock")


def edge_geometry(batch: GraphBatch, max_ell: int, r_max: float,
                  num_bessel: int, num_polynomial_cutoff: int,
                  pos_src: Optional[torch.Tensor] = None):
    """``(edge_sh [E, (max_ell+1)^2], edge_feats [E, num_bessel])`` of the
    edge vectors ``pos_src[senders] - pos[receivers]`` (``pos_src``: the
    positions the senders index, ``batch.pos`` unless given, as the gp
    catalog is)."""
    pos_src = batch.pos if pos_src is None else pos_src
    vectors = pos_src[batch.senders] - batch.pos[batch.receivers]
    lengths = safe_norm(vectors, dim=-1, keepdim=True)
    return (spherical_harmonics(vectors, max_ell),
            radial_embedding(lengths, r_max, num_bessel,
                             num_polynomial_cutoff))


class MACEForceField(nn.Module):
    """Energy model with the JAX package's constructor surface and defaults:
    ``forward(batch)`` returns ``[num_graphs, 1]``.

    Parameters are drawn on the CPU from ``generator`` (seeded with 0 when
    None), then moved to ``device`` (default ``"cuda"``, which raises when
    CUDA is absent).  ``tp_precision`` is the precision of the interaction
    blocks' 'uvu' products and post-convolution linears and of the product
    blocks (``precision.py``; None: the process default).  ``interaction``
    and ``interaction_first`` name one of ``FF_INTERACTIONS``.  ``gp_axis``
    needs ``mesh`` (the ``parallel.Mesh`` holding that axis) and the sum
    pool (``ValueError`` otherwise); such a model runs the single-rank
    forward unless ``forward`` is given a ``halo_plan``."""

    def __init__(self, r_max: float = 5.0, num_bessel: int = 8,
                 num_polynomial_cutoff: int = 5, max_ell: int = 3,
                 correlation: int = 3, num_layers: int = 2, emb_dim: int = 64,
                 in_dim: int = 8,
                 interaction: str = "RealAgnosticResidualInteractionBlock",
                 interaction_first: str = "RealAgnosticResidualInteractionBlock",
                 avg_num_neighbors: float = 12.0, pool: str = "sum",
                 edge_chunk: Optional[int] = None,
                 node_chunk: Optional[int] = 16384,
                 tp_precision: Optional[str] = "highest",
                 gp_axis: Optional[str] = None, *, mesh=None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if gp_axis is not None:
            if mesh is None or gp_axis not in mesh.shape:
                raise ValueError(f"MACEForceField(gp_axis={gp_axis!r}) needs "
                                 "mesh=, a parallel.Mesh with that axis")
            if pool not in ("sum", "add"):
                raise ValueError("edge-partitioned execution completes the "
                                 "pool with a sum over the axis: pool must "
                                 f"be 'sum' or 'add', got {pool!r}")
        self.gp_axis, self.mesh = gp_axis, mesh
        for name in (interaction, interaction_first):
            if name not in FF_INTERACTIONS:
                raise ValueError(f"interaction must be one of "
                                 f"{FF_INTERACTIONS}, got {name!r}")
        if pool not in POOL:
            raise ValueError(f"pool must be one of {sorted(POOL)}, got {pool!r}")
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.r_max, self.num_bessel = r_max, num_bessel
        self.num_polynomial_cutoff, self.max_ell = num_polynomial_cutoff, max_ell
        self.in_dim, self.pool = in_dim, pool
        sh_irreps = Irreps.spherical_harmonics(max_ell)
        hidden = (sh_irreps * emb_dim).sort().simplify()
        self.hidden_irreps = hidden
        attrs = Irreps(f"{in_dim}x0e")
        scalars = Irreps(f"{emb_dim}x0e")
        self.node_embedding = IrrepsLinear(attrs, scalars, generator=generator)
        self.interactions = nn.ModuleList()
        self.products = nn.ModuleList()
        self.readouts = nn.ModuleList()
        for i in range(num_layers):
            cls = interaction_classes[interaction_first if i == 0
                                      else interaction]
            self.interactions.append(cls(
                attrs, scalars if i == 0 else hidden, sh_irreps,
                Irreps(f"{num_bessel}x0e"), hidden, hidden,
                avg_num_neighbors=avg_num_neighbors, edge_chunk=edge_chunk,
                node_chunk=node_chunk, precision=tp_precision,
                generator=generator))
            # the self-connection is added where the interaction returns one
            self.products.append(EquivariantProductBasisBlock(
                hidden, hidden, correlation, use_sc=True,
                element_dependent=False, num_elements=in_dim,
                precision=tp_precision, node_chunk=node_chunk,
                generator=generator))
            self.readouts.append(IrrepsLinear(hidden, Irreps("1x0e"),
                                              generator=generator))
        self.to(dev)

    def forward(self, batch: GraphBatch, halo_plan=None) -> torch.Tensor:
        exchange = None
        if halo_plan is not None:
            if self.gp_axis is None:
                raise ValueError("halo_plan needs a model built with gp_axis= "
                                 "and mesh=")

            def exchange(x):
                return halo_catalog(x, halo_plan, self.mesh, self.gp_axis)
        node_attrs = F.one_hot(batch.atoms.long(), self.in_dim).to(
            batch.pos.dtype)
        h = self.node_embedding(node_attrs)
        edge_sh, edge_feats = edge_geometry(
            batch, self.max_ell, self.r_max, self.num_bessel,
            self.num_polynomial_cutoff,
            None if exchange is None else exchange(batch.pos))
        energy = None
        for interaction, product, readout in zip(
                self.interactions, self.products, self.readouts):
            m, sc = interaction(node_attrs, h, edge_sh, edge_feats,
                                batch.senders, batch.receivers,
                                batch.edge_mask, halo_exchange=exchange)
            h = product(m, sc, None)
            e = POOL[self.pool](readout(h), batch)
            energy = e if energy is None else energy + e
        if exchange is not None:     # a graph's nodes may span ranks
            energy = differentiable.psum_replicated(self.mesh, energy,
                                                    self.gp_axis)
        return energy
