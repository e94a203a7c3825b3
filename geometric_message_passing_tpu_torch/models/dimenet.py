"""DimeNet++, directional message passing over triplets (port of
``models/dimenet.py``).

Triplets come precomputed on the batch (``GraphBatch.triplets``).  The hot
loop of each interaction block is the triplet pass: project the spherical
basis, gather ``x_kj[idx_kj]``, multiply, and sum over ``idx_ji`` into the
edges.  That sum is the triplet fold: ``idx_ji`` is ascending, so the fold
runs the sorted segment sum (K3 on the card) over an identity plan built on
the device (``ops.sorted_segsum.ascending_plan``), one launch per block and
triplet chunk.  Every other sum (edges into nodes in the output blocks, the
pool) is ``ops.scatter.segment_sum``: K4 on the card.

As in the JAX package (and the fork it follows), the triplet angle is taken
at node i, between (j - i) and (k - i), not at j as in stock DimeNet.

``triplet_chunk`` slices the triplet axis with a Python loop (the last chunk
is shorter; nothing is padded, so each chunk's ``idx_ji`` stays ascending)
and accumulates the chunks inside the fold's launches (``sorted_fold`` with
``acc``: each chunk's K3 launch adds the sum so far).  With more than one
chunk, and when the model already trades time for memory (``edge_chunk``,
``remat_blocks`` or ``remat_full_blocks`` set), each chunk's body (the
basis, the ``lin_sbf`` projection, the gather ``x_kj[idx_kj]`` and the
product) runs under ``torch.utils.checkpoint``, so its rows are recomputed
in the backward, not kept; the fold sits outside the checkpoint (its
backward is a gather, and the recompute does not fold again).  Without
those options the chunks' rows are kept: the recompute costs a third of a
step or more at 10k-30k atoms, where the rows fit.  With ``sbf_in_chunk``
(the default) the angular half of the basis
is evaluated per chunk from the positions, and with ``rbf_in_chunk`` the
radial Bessel half too, from the edge lengths, instead of an ``[E, ns*nr]``
table.

The box-scale options are schedule changes, not changes of the function or
of the parameters: ``edge_chunk`` runs the interaction blocks' per-edge MLP
chains (before and after the triplet pass) in blocks of that many edges,
each under checkpoint (``edge_chunked``), and the output blocks' edge gate
and its K4 sum chunk by chunk into the ``[N, hidden]`` sum; ``remat_blocks``
checkpoints the chains whole when ``edge_chunk`` is unset;
``remat_full_blocks`` checkpoints each interaction block whole (its
backward reruns the block's triplet pass: K3 twice per chunk) and leaves
the output blocks unchunked but with their gate checkpointed, as does
``chunk_output_blocks=False``.  The wiring is the JAX package's.

Module names map onto the flax tree (``weights.dimenet_from_jax``):
``rbf.freq``, ``emb`` (``emb``, ``lin_rbf`` = Dense_0, ``lin`` = Dense_1),
``interactions[b]`` for ``interaction_b`` (``lin_ji``, ``lin_kj``,
``lin_rbf1``, ``lin_rbf2``, ``lin_down``, ``lin_up``, ``lin`` = Dense_0..6,
``before_skip``/``after_skip`` = ResidualLayer_0.., ``lin_sbf1``,
``lin_sbf2``) and ``outputs[b]`` for ``output_b`` (``lin_rbf``, ``lin_up``,
``lins[k]``, ``lin`` = Dense_0..).  Embedding tables are stored as in the
JAX package, uniform on [0, 2 sqrt 3), and shifted by -sqrt 3 when read.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..graph import GraphBatch
from ..nn.basic import Embedding, torch_linear_init_
from ..ops.dimenet_basis import (DistEmb, angle_cbf, angle_emb, angle_product,
                                 sph_bessel_rbf)
from ..ops.norms import safe_arctan2, safe_norm
from ..ops.scatter import segment_sum
from ..ops.sorted_segsum import SegmentPlan, ascending_plan, sorted_fold
from .pooling import POOL

SQRT3 = math.sqrt(3.0)


def swish(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): the
    intermediates are recomputed in the backward instead of kept."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def chunk_slices(n: int, chunk: Optional[int]) -> List[slice]:
    """``range(n)`` in slices of ``chunk`` rows, the last one shorter; one
    slice when ``chunk`` is None or ``n <= chunk``."""
    step = n if chunk is None or n <= chunk else chunk
    return [slice(c, min(c + step, n)) for c in range(0, max(n, 1),
                                                      max(step, 1))]


def edge_chunked(fn, chunk: Optional[int], *arrays: torch.Tensor):
    """A row-independent per-edge stage ``fn(*arrays)`` (a tensor or a tuple
    of tensors, row for row of ``arrays``) in blocks of ``chunk`` rows, each
    under checkpoint, the blocks' outputs concatenated: only the blocks'
    outputs are kept for the backward, not their intermediates.  Row for
    row the same arithmetic as ``fn(*arrays)``; one block: ``fn`` itself."""
    slices = chunk_slices(arrays[0].shape[0], chunk)
    if len(slices) == 1:
        return fn(*arrays)
    parts = [remat(fn, *(a[s] for a in arrays)) for s in slices]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def glorot_orthogonal_(weight: torch.Tensor, generator: torch.Generator,
                       scale: float = 2.0) -> torch.Tensor:
    """Fill a Linear's ``weight [out, in]`` in place: a random orthogonal
    matrix (QR of a Gaussian one drawn from ``generator``) rescaled to
    variance ``scale / (fan_in + fan_out)`` (DimeNet's GlorotOrthogonal)."""
    out_f, in_f = weight.shape
    a = torch.randn(max(out_f, in_f), min(out_f, in_f), generator=generator,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    w = q if out_f >= in_f else q.T
    w = w * math.sqrt(scale / ((in_f + out_f) * w.var(unbiased=False).item()))
    with torch.no_grad():
        return weight.copy_(w.to(weight.dtype))


def dense(in_f: int, out_f: int, generator: torch.Generator,
          bias: bool = True, init: str = "glorot") -> nn.Linear:
    """A Linear with its weight drawn from ``generator`` by ``init``:
    ``'glorot'`` (glorot_orthogonal, zero bias), ``'torch'`` (torch's
    default for weight and bias) or ``'zeros'``."""
    layer = nn.Linear(in_f, out_f, bias=bias)
    with torch.no_grad():
        if init == "glorot":
            glorot_orthogonal_(layer.weight, generator)
        elif init == "torch":
            torch_linear_init_(layer.weight, in_f, generator)
        elif init == "zeros":
            layer.weight.zero_()
        else:
            raise ValueError(f"unknown init {init!r}")
        if bias:
            if init == "torch":
                torch_linear_init_(layer.bias, in_f, generator)
            else:
                layer.bias.zero_()
    return layer


def atom_embedding(hidden: int, generator: torch.Generator) -> Embedding:
    """95 x ``hidden`` table, uniform on [0, 2 sqrt 3) as the JAX package
    stores it (read back shifted by -sqrt 3: torch's U(-sqrt 3, sqrt 3))."""
    emb = Embedding(95, hidden)
    with torch.no_grad():
        emb.weight.uniform_(0.0, 2 * SQRT3, generator=generator)
    return emb


class ResidualLayer(nn.Module):
    def __init__(self, hidden: int, *, generator: torch.Generator):
        super().__init__()
        self.lin1 = dense(hidden, hidden, generator)
        self.lin2 = dense(hidden, hidden, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + swish(self.lin2(swish(self.lin1(x))))


class EmbeddingBlock(nn.Module):
    """x_e = act(W [emb(z_i), emb(z_j), act(W_rbf rbf)]); the two Linears
    keep torch's default init (PyG's EmbeddingBlock)."""

    def __init__(self, num_radial: int, hidden: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.emb = atom_embedding(hidden, generator)
        self.lin_rbf = dense(num_radial, hidden, generator, init="torch")
        self.lin = dense(3 * hidden, hidden, generator, init="torch")

    def forward(self, atoms, rbf, senders, receivers) -> torch.Tensor:
        x = self.emb(atoms) - SQRT3
        rbf0 = swish(self.lin_rbf(rbf))
        return swish(self.lin(torch.cat([x[receivers], x[senders], rbf0], -1)))


class TripletFold:
    """The triplet fold of one batch, shared by every block: the masked sum
    over ``idx_ji`` of rows given chunk by chunk (slices of the triplet
    axis; one chunk when ``chunk`` is None), each chunk through its own
    ``ascending_plan`` (K3 on the card: one launch a chunk, which skips the
    masked rows and adds the chunks before it).  ``remat``: with more than
    one chunk, each chunk's rows under checkpoint (``self.remat``)."""

    def __init__(self, idx_ji: torch.Tensor, t_mask: torch.Tensor,
                 num_edges: int, chunk: Optional[int] = None,
                 remat: bool = True):
        self.slices = chunk_slices(idx_ji.shape[0], chunk)
        self.plans: List[SegmentPlan] = [ascending_plan(idx_ji[s], num_edges)
                                         for s in self.slices]
        self.idx_ji, self.t_mask = idx_ji, t_mask
        self.remat = remat and len(self.slices) > 1

    def sum(self, rows_of) -> torch.Tensor:
        """``[E, D]``: the fold of ``rows_of(s)``, the ``[len(s), D]`` rows
        of the triplets ``s``.  With ``self.remat`` each chunk's
        ``rows_of`` runs under checkpoint: its rows and intermediates are
        recomputed in the backward, and the fold (whose backward is a
        gather of the cotangent) is not rerun."""
        acc = None
        for s, plan in zip(self.slices, self.plans):
            rows = remat(rows_of, s) if self.remat else rows_of(s)
            acc = sorted_fold(rows, self.idx_ji[s], plan, self.t_mask[s],
                              acc=acc)
        return acc


class InteractionPPBlock(nn.Module):
    """Triplet-level directional interaction with down/up projection (PyG
    ``InteractionPPBlock``).  ``edge_chunk``: the per-edge chains before and
    after the triplet pass run in edge blocks under checkpoint
    (``edge_chunked``); else ``remat`` checkpoints each chain whole."""

    def __init__(self, hidden: int, int_emb_size: int, basis_emb_size: int,
                 num_spherical: int, num_radial: int, num_before_skip: int,
                 num_after_skip: int, remat: bool = False,
                 edge_chunk: Optional[int] = None, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.remat, self.edge_chunk = remat, edge_chunk
        self.lin_ji = dense(hidden, hidden, g)
        self.lin_kj = dense(hidden, hidden, g)
        self.lin_rbf1 = dense(num_radial, basis_emb_size, g, bias=False)
        self.lin_rbf2 = dense(basis_emb_size, hidden, g, bias=False)
        self.lin_down = dense(hidden, int_emb_size, g, bias=False)
        self.lin_sbf1 = dense(num_spherical * num_radial, basis_emb_size, g,
                              bias=False)
        self.lin_sbf2 = dense(basis_emb_size, int_emb_size, g, bias=False)
        self.lin_up = dense(int_emb_size, hidden, g, bias=False)
        self.before_skip = nn.ModuleList(ResidualLayer(hidden, generator=g)
                                         for _ in range(num_before_skip))
        self.lin = dense(hidden, hidden, g)
        self.after_skip = nn.ModuleList(ResidualLayer(hidden, generator=g)
                                        for _ in range(num_after_skip))

    def pre(self, x, rbf):
        x_ji = swish(self.lin_ji(x))
        x_kj = swish(self.lin_kj(x)) * self.lin_rbf2(self.lin_rbf1(rbf))
        return x_ji, swish(self.lin_down(x_kj))

    def post(self, x_ji, x_kj, x):
        h = x_ji + swish(self.lin_up(x_kj))
        for layer in self.before_skip:
            h = layer(h)
        h = swish(self.lin(h)) + x
        for layer in self.after_skip:
            h = layer(h)
        return h

    def _stage(self, fn, *arrays):
        if self.edge_chunk is not None:
            return edge_chunked(fn, self.edge_chunk, *arrays)
        return remat(fn, *arrays) if self.remat else fn(*arrays)

    def rows(self, s: slice, x_kj, sbf_of, idx_kj) -> torch.Tensor:
        """The triplet pass's rows of the triplets ``s``: their basis
        projected, times ``x_kj`` gathered at their edge k -> j."""
        return x_kj[idx_kj[s]] * self.lin_sbf2(self.lin_sbf1(sbf_of(s)))

    def forward(self, x, rbf, sbf_of, idx_kj,
                fold: TripletFold) -> torch.Tensor:
        """``sbf_of(s)``: the spherical basis of the triplets ``s``."""
        x_ji, x_kj = self._stage(self.pre, x, rbf)
        # bound by value: the backward calls the rows again to recompute
        folded = fold.sum(functools.partial(self.rows, x_kj=x_kj,
                                            sbf_of=sbf_of, idx_kj=idx_kj))
        return self._stage(self.post, x_ji, folded, x)


class OutputPPBlock(nn.Module):
    """Edge features gated by the radial basis, summed into their receivers
    (K4 on the card), then the node MLP; the last Linear starts at 0.
    ``edge_chunk``: the gate and its sum run chunk by chunk (each chunk's
    gate under checkpoint, its K4 sum outside it) into the ``[N, hidden]``
    sum; else ``remat`` checkpoints the gate whole.  The backward reruns no
    sum."""

    def __init__(self, num_radial: int, hidden: int, out_emb_channels: int,
                 out_dim: int, num_output_layers: int, remat: bool = False,
                 edge_chunk: Optional[int] = None, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.remat, self.edge_chunk = remat, edge_chunk
        self.lin_rbf = dense(num_radial, hidden, g, bias=False)
        self.lin_up = dense(hidden, out_emb_channels, g, bias=False)
        self.lins = nn.ModuleList(dense(out_emb_channels, out_emb_channels, g)
                                  for _ in range(num_output_layers))
        self.lin = dense(out_emb_channels, out_dim, g, bias=False, init="zeros")

    def gate(self, x, rbf):
        return self.lin_rbf(rbf) * x

    def gate_sum(self, x, rbf, receivers, num_nodes, edge_mask):
        """``[N, hidden]``: the masked sum of the gated edges into their
        receivers, one K4 launch a chunk."""
        slices = chunk_slices(x.shape[0], self.edge_chunk)
        checkpointed = self.remat or len(slices) > 1
        acc = None
        for s in slices:
            gated = (remat(self.gate, x[s], rbf[s]) if checkpointed
                     else self.gate(x[s], rbf[s]))
            part = segment_sum(gated, receivers[s], num_nodes,
                               mask=edge_mask[s])
            acc = part if acc is None else acc + part
        return acc

    def forward(self, x, rbf, receivers, num_nodes, edge_mask) -> torch.Tensor:
        x = self.lin_up(self.gate_sum(x, rbf, receivers, num_nodes, edge_mask))
        for lin in self.lins:
            x = swish(lin(x))
        return self.lin(x)


def angle_at_i(pos: torch.Tensor, idx_i, idx_j, idx_k) -> torch.Tensor:
    """The fork's triplet angle at node i between (j - i) and (k - i)."""
    pos_i = pos[idx_i]
    pos_ji = pos[idx_j] - pos_i
    pos_ki = pos[idx_k] - pos_i
    a = (pos_ji * pos_ki).sum(-1)
    b = safe_norm(torch.linalg.cross(pos_ji, pos_ki, dim=-1))
    return safe_arctan2(b, a)


class DimeNetPPModel(nn.Module):
    """DimeNet++ with the JAX package's constructor surface and defaults;
    ``forward(batch)`` returns ``[num_graphs, out_dim]`` and needs
    ``batch.triplets``.  ``in_dim``, ``max_num_neighbors`` and ``act`` are
    accepted and unused (swish throughout), as there.  ``triplet_chunk``,
    ``sbf_in_chunk``, ``rbf_in_chunk``, ``edge_chunk``, ``remat_blocks``,
    ``remat_full_blocks`` and ``chunk_output_blocks`` change the schedule
    (the module docstring), not the function or the parameters.

    Parameters are drawn on the CPU from ``generator`` (seeded with 0 when
    None), then moved to ``device`` (default ``"cuda"``, which raises when
    CUDA is absent)."""

    def __init__(self, hidden_channels: int = 128, in_dim: int = 1,
                 out_dim: int = 1, num_layers: int = 4, int_emb_size: int = 64,
                 basis_emb_size: int = 8, out_emb_channels: int = 256,
                 num_spherical: int = 7, num_radial: int = 6,
                 cutoff: float = 10.0, max_num_neighbors: int = 32,
                 envelope_exponent: int = 5, num_before_skip: int = 1,
                 num_after_skip: int = 2, num_output_layers: int = 3,
                 act: str = "swish", pool: str = "sum",
                 triplet_chunk: Optional[int] = None,
                 sbf_in_chunk: bool = True, remat_blocks: bool = False,
                 edge_chunk: Optional[int] = None,
                 remat_full_blocks: bool = False, rbf_in_chunk: bool = False,
                 chunk_output_blocks: bool = True, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if pool not in POOL:
            raise ValueError(f"pool must be one of {sorted(POOL)}, got {pool!r}")
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.out_dim, self.pool, self.cutoff = out_dim, pool, cutoff
        self.num_spherical, self.num_radial = num_spherical, num_radial
        self.triplet_chunk, self.sbf_in_chunk = triplet_chunk, sbf_in_chunk
        self.rbf_in_chunk = rbf_in_chunk
        self.remat_full_blocks = remat_full_blocks
        # the triplet chunks' rows are recomputed only where the schedule
        # already trades time for memory
        self.remat_chunks = (remat_blocks or remat_full_blocks
                             or edge_chunk is not None)
        # the JAX package's wiring: under whole-block remat (or with
        # chunk_output_blocks off) the output blocks go unchunked, their
        # gate checkpointed
        out_chunk = (edge_chunk if chunk_output_blocks
                     and not remat_full_blocks else None)
        out_remat = (remat_blocks or remat_full_blocks
                     or not chunk_output_blocks)
        self.rbf = DistEmb(num_radial, cutoff, envelope_exponent,
                           zero_outside=True)
        self.emb = EmbeddingBlock(num_radial, hidden_channels, generator=g)
        self.outputs = nn.ModuleList(
            OutputPPBlock(num_radial, hidden_channels, out_emb_channels,
                          out_dim, num_output_layers, out_remat, out_chunk,
                          generator=g)
            for _ in range(num_layers + 1))
        self.interactions = nn.ModuleList(
            InteractionPPBlock(hidden_channels, int_emb_size, basis_emb_size,
                               num_spherical, num_radial, num_before_skip,
                               num_after_skip, remat_blocks, edge_chunk,
                               generator=g)
            for _ in range(num_layers))
        self.to(dev)

    def _sbf_of(self, batch: GraphBatch, dist: torch.Tensor):
        """``s -> [len(s), ns*nr]`` spherical basis of the triplets ``s``:
        slices of one materialised basis, or (chunked with
        ``sbf_in_chunk``) the angle and the product evaluated per chunk
        from the positions and the per-edge radial table (with
        ``rbf_in_chunk``: the radial half evaluated per chunk from the
        edge lengths)."""
        tri, ns, nr = batch.triplets, self.num_spherical, self.num_radial
        if self.triplet_chunk is not None and self.sbf_in_chunk:
            if self.rbf_in_chunk:
                def radial(s: slice) -> torch.Tensor:
                    return sph_bessel_rbf(dist[tri.idx_kj[s]], ns, nr,
                                          self.cutoff)
            else:
                rbf_sph = sph_bessel_rbf(dist, ns, nr, self.cutoff)

                def radial(s: slice) -> torch.Tensor:
                    return rbf_sph[tri.idx_kj[s]]

            def sbf_of(s: slice) -> torch.Tensor:
                angle = angle_at_i(batch.pos, tri.idx_i[s], tri.idx_j[s],
                                   tri.idx_k[s])
                return angle_product(radial(s), angle_cbf(angle, ns))
            return sbf_of
        angle = angle_at_i(batch.pos, tri.idx_i, tri.idx_j, tri.idx_k)
        sbf = angle_emb(dist, angle, tri.idx_kj, ns, nr, self.cutoff)
        return lambda s: sbf[s]

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        tri = batch.triplets
        if tri is None:
            raise ValueError("DimeNet++ needs triplet indices (batch.triplets)")
        j, i = batch.senders, batch.receivers
        dist = safe_norm(batch.pos[i] - batch.pos[j])
        sbf_of = self._sbf_of(batch, dist)
        rbf = self.rbf(dist)
        fold = TripletFold(tri.idx_ji, tri.t_mask, batch.num_edges,
                           self.triplet_chunk, remat=self.remat_chunks)
        x = self.emb(batch.atoms, rbf, j, i)
        P = self.outputs[0](x, rbf, i, batch.num_nodes, batch.edge_mask)
        for interaction, output in zip(self.interactions, self.outputs[1:]):
            if self.remat_full_blocks:
                x = remat(interaction, x, rbf, sbf_of, tri.idx_kj, fold)
            else:
                x = interaction(x, rbf, sbf_of, tri.idx_kj, fold)
            P = P + output(x, rbf, i, batch.num_nodes, batch.edge_mask)
        return POOL[self.pool](P, batch)
