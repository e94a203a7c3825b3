"""MACE's block library (port of ``nn/mace_blocks.py``): the embedding and
readout blocks, the scale-shift and atomic-energy blocks, the element-
dependent weights, and the five interaction blocks with their registry
(``interaction_classes``), the building blocks of the force-field stacks
(``models/mace_ff.py``, ``models/tfn_ff.py``).

An interaction's convolution (``_InteractionBase._conv``): gather the
senders' features, the per-edge weights from an MLP of the radial
features, the 'uvu' tensor product (``tensor_product.EdgeTensorProductUVU``)
and the masked segment sum onto the receivers (``ops.scatter.segment_sum``:
K4 on the card).  With ``edge_chunk`` the edges run in chunks of that many,
each chunk's gather, weights and product under ``torch.utils.checkpoint``,
so one chunk's per-edge tensors are alive at a time, forward and backward.

Modules carry the flax names (``linear_up``, ``conv_tp_weights``,
``linear``, ``skip_tp``; parameters ``w{i}``, ``w{a}_{b}``, ``weights``), so
``weights.mace_ff_from_jax`` carries a JAX model's values over.
``precision`` (the JAX package's): the precision of the 'uvu' product and
of the post-convolution ``linear`` (``precision.py``); every other product
follows the process default.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import precision as prec

from ..irreps import Irreps
from ..ops.scatter import segment_sum
from .basic import ACT
from .equivariant import Activation, IrrepsLinear, _act_second_moment, reshape_irreps
from .tensor_product import EdgeTensorProductUVU, FullyConnectedTensorProduct


def _normal(shape, generator: torch.Generator) -> nn.Parameter:
    w = torch.empty(shape)
    with torch.no_grad():
        w.normal_(0.0, 1.0, generator=generator)
    return nn.Parameter(w)


class E3FullyConnectedNet(nn.Module):
    """e3nn ``nn.FullyConnectedNet``: ``x = act(x @ (W / sqrt(fan_in)))``
    for each width, the activation rescaled to unit second moment and left
    off after the last; weights ``w{i}`` ``[fan_in, width]`` from N(0, 1),
    no bias."""

    def __init__(self, in_dim: int, widths: Sequence[int], act: str = "silu",
                 *, generator: torch.Generator):
        super().__init__()
        self.act = act
        dims = [in_dim, *widths]
        for i, (a, b) in enumerate(zip(dims, dims[1:])):
            setattr(self, f"w{i}", _normal((a, b), generator))
        self.n = len(widths)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            w = getattr(self, f"w{i}")
            x = prec.matmul(x, w / math.sqrt(w.shape[0]), site="radial")
            if i < self.n - 1:
                x = ACT[self.act](x) * _act_second_moment(self.act)
        return x


class LinearNodeEmbeddingBlock(nn.Module):
    """An ``IrrepsLinear`` over the node attributes (flax
    ``IrrepsLinear_0`` as ``linear``)."""

    def __init__(self, irreps_in: Irreps, irreps_out: Irreps, *,
                 generator: torch.Generator):
        super().__init__()
        self.linear = IrrepsLinear(Irreps(irreps_in), Irreps(irreps_out),
                                   generator=generator)

    def forward(self, node_attrs: torch.Tensor) -> torch.Tensor:
        return self.linear(node_attrs)


class LinearReadoutBlock(LinearNodeEmbeddingBlock):
    """An ``IrrepsLinear`` readout, to one scalar by default."""

    def __init__(self, irreps_in: Irreps, irreps_out: Irreps = Irreps("1x0e"),
                 *, generator: torch.Generator):
        super().__init__(irreps_in, irreps_out, generator=generator)


class NonLinearReadoutBlock(nn.Module):
    """``IrrepsLinear`` -> scalar activation -> ``IrrepsLinear`` (flax
    ``IrrepsLinear_0`` / ``_1`` as ``linear_0`` / ``linear_1``)."""

    def __init__(self, irreps_in: Irreps, mlp_irreps: Irreps,
                 gate: str = "silu", irreps_out: Irreps = Irreps("1x0e"), *,
                 generator: torch.Generator):
        super().__init__()
        hidden = Irreps(mlp_irreps)
        self.linear_0 = IrrepsLinear(Irreps(irreps_in), hidden,
                                     generator=generator)
        self.act = Activation(hidden, act=gate)
        self.linear_1 = IrrepsLinear(hidden, Irreps(irreps_out),
                                     generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_1(self.act(self.linear_0(x)))


class AtomicEnergiesBlock(nn.Module):
    """Fixed reference energies per element: ``one_hot @ energies``."""

    def __init__(self, atomic_energies: Sequence[float]):
        super().__init__()
        self.register_buffer("atomic_energies", torch.tensor(
            np.asarray(atomic_energies, np.float32)), persistent=False)

    def forward(self, one_hot: torch.Tensor) -> torch.Tensor:
        return prec.matmul(one_hot, self.atomic_energies.to(one_hot.dtype),
                           site="energies")


class ScaleShiftBlock(nn.Module):
    """``scale * x + shift``."""

    def __init__(self, scale: float, shift: float):
        super().__init__()
        self.scale, self.shift = scale, shift

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale * x + self.shift


class TensorProductWeightsBlock(nn.Module):
    """Element-dependent tensor-product weights ``einsum('be,ba,aek->bk',
    edge_feats, node_attrs_one_hot, weights)``; ``weights`` ``[elements,
    edge_feats, out]`` from the Glorot uniform law with the element axis as
    the batch axis (fan in ``edge_feats``, fan out ``out``)."""

    def __init__(self, num_elements: int, num_edge_feats: int,
                 num_feats_out: int, *, generator: torch.Generator):
        super().__init__()
        bound = math.sqrt(6.0 / (num_edge_feats + num_feats_out))
        w = torch.empty(num_elements, num_edge_feats, num_feats_out)
        with torch.no_grad():
            w.uniform_(-bound, bound, generator=generator)
        self.weights = nn.Parameter(w)

    def forward(self, node_attrs_one_hot: torch.Tensor,
                edge_feats: torch.Tensor) -> torch.Tensor:
        return prec.einsum("be,ba,aek->bk", edge_feats, node_attrs_one_hot,
                           self.weights, site="radial")


class _InteractionBase(nn.Module):
    """What the interaction blocks share: their irreps, the 'uvu' product
    ``tp`` and the convolution ``_conv``.  ``edge_chunk`` (used by the two
    ``RealAgnostic*`` blocks): edges per chunk of the convolution, None for
    one pass.  ``node_chunk``: node blocks of their ``skip_tp``.
    ``FOLD_ACC_ELEMS``: accumulator elements above which a chunked
    convolution applies the post-conv linear to each chunk (a class
    attribute, so tests can force the fold at toy sizes).

    ``halo_exchange`` of the ``RealAgnostic*`` blocks' ``forward``
    (edge-partitioned execution, ``parallel.halo``): a callable that maps
    the local node features after ``linear_up``, ``[n_local, D]``, to the
    gather catalog ``[n_local + k * B, D]`` (``halo.halo_catalog``);
    ``senders`` then index the catalog, while ``receivers``, the segment
    targets and the self-connection stay local.  The catalog is built
    before ``_conv``, so no chunk runs a collective."""

    FOLD_ACC_ELEMS = 2 ** 28

    def __init__(self, node_attrs_irreps: Irreps, node_feats_irreps: Irreps,
                 edge_attrs_irreps: Irreps, edge_feats_irreps: Irreps,
                 target_irreps: Irreps, hidden_irreps: Irreps,
                 avg_num_neighbors: float = 1.0,
                 edge_chunk: Optional[int] = None,
                 node_chunk: Optional[int] = None,
                 precision: Optional[str] = None, *,
                 generator: torch.Generator):
        super().__init__()
        self.node_attrs_irreps = Irreps(node_attrs_irreps)
        self.node_feats_irreps = Irreps(node_feats_irreps)
        self.edge_attrs_irreps = Irreps(edge_attrs_irreps)
        self.edge_feats_irreps = Irreps(edge_feats_irreps)
        self.target_irreps = Irreps(target_irreps)
        self.hidden_irreps = Irreps(hidden_irreps)
        self.avg_num_neighbors = avg_num_neighbors
        self.edge_chunk, self.node_chunk = edge_chunk, node_chunk
        self.precision = precision
        self.tp = EdgeTensorProductUVU(self.node_feats_irreps,
                                       self.edge_attrs_irreps,
                                       self.target_irreps, precision=precision)
        self.linear_up = IrrepsLinear(self.node_feats_irreps,
                                      self.node_feats_irreps,
                                      generator=generator)

    def _weight_net(self, generator: torch.Generator) -> E3FullyConnectedNet:
        return E3FullyConnectedNet(self.edge_feats_irreps.dim,
                                   (64, 64, 64, self.tp.weight_numel),
                                   generator=generator)

    def _linear_out_irreps(self, irreps_mid: Irreps) -> Irreps:
        """For each distinct irrep of ``irreps_mid``, its multiplicity in the
        target (e3nn-MACE's ``linear_out_irreps``)."""
        out = []
        for _, ir in irreps_mid.simplify():
            found = [(mul, t) for mul, t in self.target_irreps if t == ir]
            if not found:
                raise ValueError(f"{ir} not in {self.target_irreps}")
            out.append(found[0])
        return Irreps(out).simplify()

    def _message(self, node_feats: torch.Tensor, senders: torch.Tensor,
                 edge_attrs: torch.Tensor,
                 tp_weights: torch.Tensor) -> torch.Tensor:
        return self.tp.apply(node_feats[senders], edge_attrs, tp_weights)

    def _chunk(self, node_feats, senders, edge_attrs, edge_feats,
               fold: bool) -> torch.Tensor:
        mji = self._message(node_feats, senders, edge_attrs,
                            self.conv_tp_weights(edge_feats))
        return self.linear(mji) if fold else mji

    def _conv(self, node_feats: torch.Tensor, edge_attrs: torch.Tensor,
              edge_feats: torch.Tensor, senders: torch.Tensor,
              receivers: torch.Tensor, edge_mask: Optional[torch.Tensor],
              num_nodes: int) -> torch.Tensor:
        """gather -> weight MLP -> 'uvu' product -> masked segment sum ->
        ``linear``, in edge chunks when ``E > edge_chunk``.

        Chunks: the tail chunk is padded with index 0 and mask False; each
        chunk's body (gather, weights, product) runs under
        ``torch.utils.checkpoint(use_reentrant=False)`` and its sum is
        added to the accumulator (``acc + segment_sum``: K4 on the card, and
        no chunk's accumulator outlives the next).  The sum sits outside the
        checkpoint: its backward needs only the ids and the mask, so the
        backward's recompute of the body does not sum again.
        ``node_feats`` is an input of every chunk, its gradient the sum of
        the chunks'.  When ``num_nodes * tp.irreps_out.dim`` exceeds
        ``FOLD_ACC_ELEMS`` the linear (which commutes with the sum) is
        applied to each chunk's messages, so the accumulator has the target
        width."""
        E, C = senders.shape[0], self.edge_chunk
        if C is None or E <= C:
            return self.linear(segment_sum(
                self._chunk(node_feats, senders, edge_attrs, edge_feats,
                            False), receivers, num_nodes, mask=edge_mask))
        fold = num_nodes * self.tp.irreps_out.dim > self.FOLD_ACC_ELEMS
        n_chunks = -(-E // C)
        pad = n_chunks * C - E
        mask = (edge_mask if edge_mask is not None
                else torch.ones(E, dtype=torch.bool, device=senders.device))

        def pad_to(x, fill):
            if not pad:
                return x
            return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]),
                                            fill)])

        s, r = pad_to(senders, 0), pad_to(receivers, 0)
        ea, ef = pad_to(edge_attrs, 0), pad_to(edge_feats, 0)
        m = pad_to(mask, False)
        acc = None
        for k in range(n_chunks):
            sl = slice(k * C, (k + 1) * C)
            mji = checkpoint(self._chunk, node_feats, s[sl], ea[sl], ef[sl],
                             fold, use_reentrant=False,
                             preserve_rng_state=False)
            part = segment_sum(mji, r[sl], num_nodes, mask=m[sl])
            acc = part if acc is None else acc + part
        return acc if fold else self.linear(acc)


class ResidualElementDependentInteractionBlock(_InteractionBase):
    """Element-dependent 'uvu' weights (``TensorProductWeightsBlock`` of the
    senders' species), one pass; returns ``linear(message) / avg + skip``,
    flat ``[N, irreps_out.dim]``."""

    def __init__(self, *args, generator: torch.Generator, **kw):
        super().__init__(*args, generator=generator, **kw)
        irreps_out = self._linear_out_irreps(self.tp.irreps_out)
        self.skip_tp = FullyConnectedTensorProduct(
            self.node_feats_irreps, self.node_attrs_irreps, irreps_out,
            generator=generator)
        self.conv_tp_weights = TensorProductWeightsBlock(
            self.node_attrs_irreps.num_irreps, self.edge_feats_irreps.num_irreps,
            self.tp.weight_numel, generator=generator)
        self.linear = IrrepsLinear(self.tp.irreps_out, irreps_out,
                                   generator=generator)

    def forward(self, node_attrs, node_feats, edge_attrs, edge_feats,
                senders, receivers, edge_mask=None) -> torch.Tensor:
        sc = self.skip_tp(node_feats, node_attrs)
        node_feats = self.linear_up(node_feats)
        mji = self._message(node_feats, senders, edge_attrs,
                            self.conv_tp_weights(node_attrs[senders],
                                                 edge_feats))
        message = segment_sum(mji, receivers, node_feats.shape[0],
                              mask=edge_mask)
        return self.linear(message) / self.avg_num_neighbors + sc


class AgnosticNonlinearInteractionBlock(_InteractionBase):
    """Species-agnostic weight MLP, one pass; the message then passes the
    self-connection product ``skip_tp(message, node_attrs)``."""

    def __init__(self, *args, generator: torch.Generator, **kw):
        super().__init__(*args, generator=generator, **kw)
        irreps_out = self._linear_out_irreps(self.tp.irreps_out)
        self.conv_tp_weights = self._weight_net(generator)
        self.linear = IrrepsLinear(self.tp.irreps_out, irreps_out,
                                   generator=generator)
        self.skip_tp = FullyConnectedTensorProduct(
            irreps_out, self.node_attrs_irreps, irreps_out,
            generator=generator)

    def forward(self, node_attrs, node_feats, edge_attrs, edge_feats,
                senders, receivers, edge_mask=None) -> torch.Tensor:
        num_nodes = node_feats.shape[0]
        node_feats = self.linear_up(node_feats)
        mji = self._message(node_feats, senders, edge_attrs,
                            self.conv_tp_weights(edge_feats))
        message = segment_sum(mji, receivers, num_nodes, mask=edge_mask)
        message = self.linear(message) / self.avg_num_neighbors
        return self.skip_tp(message, node_attrs)


class AgnosticResidualNonlinearInteractionBlock(_InteractionBase):
    """Species-agnostic weight MLP, one pass; returns ``linear(message) /
    avg + skip_tp(node_feats, node_attrs)``."""

    def __init__(self, *args, generator: torch.Generator, **kw):
        super().__init__(*args, generator=generator, **kw)
        irreps_out = self._linear_out_irreps(self.tp.irreps_out)
        self.skip_tp = FullyConnectedTensorProduct(
            self.node_feats_irreps, self.node_attrs_irreps, irreps_out,
            generator=generator)
        self.conv_tp_weights = self._weight_net(generator)
        self.linear = IrrepsLinear(self.tp.irreps_out, irreps_out,
                                   generator=generator)

    def forward(self, node_attrs, node_feats, edge_attrs, edge_feats,
                senders, receivers, edge_mask=None) -> torch.Tensor:
        sc = self.skip_tp(node_feats, node_attrs)
        num_nodes = node_feats.shape[0]
        node_feats = self.linear_up(node_feats)
        mji = self._message(node_feats, senders, edge_attrs,
                            self.conv_tp_weights(edge_feats))
        message = segment_sum(mji, receivers, num_nodes, mask=edge_mask)
        return self.linear(message) / self.avg_num_neighbors + sc


class RealAgnosticInteractionBlock(_InteractionBase):
    """The force fields' interaction without a residual: the (chunked)
    convolution to the target irreps, divided by ``avg_num_neighbors``,
    then ``skip_tp(message, node_attrs)`` (node blocks of ``node_chunk``);
    returns ``(message [N, channels, sum_l (2l+1)], None)``."""

    def __init__(self, *args, generator: torch.Generator, **kw):
        super().__init__(*args, generator=generator, **kw)
        self.conv_tp_weights = self._weight_net(generator)
        self.linear = IrrepsLinear(self.tp.irreps_out, self.target_irreps,
                                   precision=self.precision,
                                   generator=generator, site="conv_linear")
        self.skip_tp = FullyConnectedTensorProduct(
            self.target_irreps, self.node_attrs_irreps, self.target_irreps,
            node_chunk=self.node_chunk, generator=generator)

    def forward(self, node_attrs, node_feats, edge_attrs, edge_feats,
                senders, receivers, edge_mask=None, halo_exchange=None
                ) -> Tuple[torch.Tensor, None]:
        num_nodes = node_feats.shape[0]
        node_feats = self.linear_up(node_feats)
        if halo_exchange is not None:
            node_feats = halo_exchange(node_feats)
        message = self._conv(node_feats, edge_attrs, edge_feats, senders,
                             receivers, edge_mask, num_nodes
                             ) / self.avg_num_neighbors
        message = self.skip_tp(message, node_attrs)
        return reshape_irreps(message, self.target_irreps), None


class RealAgnosticResidualInteractionBlock(_InteractionBase):
    """MACE's default interaction: the self-connection ``skip_tp(node_feats,
    node_attrs)`` to the hidden irreps (node blocks of ``node_chunk``) and
    the (chunked) convolution to the target irreps divided by
    ``avg_num_neighbors``; returns ``(message [N, channels, sum_l (2l+1)],
    sc [N, hidden_irreps.dim])``."""

    def __init__(self, *args, generator: torch.Generator, **kw):
        super().__init__(*args, generator=generator, **kw)
        self.skip_tp = FullyConnectedTensorProduct(
            self.node_feats_irreps, self.node_attrs_irreps, self.hidden_irreps,
            node_chunk=self.node_chunk, generator=generator)
        self.conv_tp_weights = self._weight_net(generator)
        self.linear = IrrepsLinear(self.tp.irreps_out, self.target_irreps,
                                   precision=self.precision,
                                   generator=generator, site="conv_linear")

    def forward(self, node_attrs, node_feats, edge_attrs, edge_feats,
                senders, receivers, edge_mask=None, halo_exchange=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        sc = self.skip_tp(node_feats, node_attrs)
        num_nodes = node_feats.shape[0]
        node_feats = self.linear_up(node_feats)
        if halo_exchange is not None:
            node_feats = halo_exchange(node_feats)
        message = self._conv(node_feats, edge_attrs, edge_feats, senders,
                             receivers, edge_mask, num_nodes
                             ) / self.avg_num_neighbors
        return reshape_irreps(message, self.target_irreps), sc


interaction_classes = {
    "AgnosticNonlinearInteractionBlock": AgnosticNonlinearInteractionBlock,
    "ResidualElementDependentInteractionBlock":
        ResidualElementDependentInteractionBlock,
    "AgnosticResidualNonlinearInteractionBlock":
        AgnosticResidualNonlinearInteractionBlock,
    "RealAgnosticResidualInteractionBlock":
        RealAgnosticResidualInteractionBlock,
    "RealAgnosticInteractionBlock": RealAgnosticInteractionBlock,
}

gate_dict = {"abs": "abs", "tanh": "tanh", "silu": "silu", "None": None}
