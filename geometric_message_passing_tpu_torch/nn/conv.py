"""``TensorProductConvLayer``, the equivariant graph convolution of TFN and
MACE, and MACE's ``EquivariantProductBasisBlock`` (port of ``nn/conv.py``,
without ``tp_axis``).

Per edge: the edge tensor product of ``node_feats[receivers]``, the edge's
spherical harmonics and per-edge weights from an edge MLP; the messages are
summed (or averaged) onto ``senders``.  That direction is the JAX package's
(and its reference's) quirk, kept as it is: with symmetric edge lists the
two directions agree.  The sum is ``ops.scatter.segment_sum``, the
hand-written CSR segment sum (K4) on the card.

The edge MLP's trunk (``fc``: Linear + ReLU) is shared; its last layer is
one head per output-irrep group (``fc_out[g]``, flax ``fc_out{g}``), so each
group's weights come out as their own ``[E, n_p*u*w]`` tensor and reach K7
as a free view.  ``weights_bf16``: the heads compute and emit bf16 (flax
``Dense(dtype=bfloat16)``) and K7 converts them to f32 inside the kernel.
``tp_precision`` is accepted and has no effect on the card: every product
there is exact f32 (TF32 stays off).

``EquivariantProductBasisBlock``: the symmetric contraction, then an
``IrrepsLinear``, then the self-connection added; with ``node_chunk``, in
row blocks under ``torch.utils.checkpoint`` (box scale).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..irreps import Irreps
from ..ops.scatter import segment_mean, segment_sum
from .basic import MLP, linear
from .equivariant import (Activation, EquivariantBatchNorm, Gate,
                          IrrepsLinear, irreps2gate)
from .symmetric_contraction import SymmetricContraction
from .tensor_product import EdgeTensorProduct, node_blocks


class TensorProductConvLayer(nn.Module):
    """``forward(node_feats [N, in_irreps.dim], senders, receivers, edge_sh,
    edge_feats, edge_mask=None, node_mask=None)`` returns ``[N,
    out_irreps.dim]``.  ``edge_dim`` is the width of ``edge_feats`` (flax
    infers it).  Training mode (``module.train()``) is the JAX ``train=True``
    of the batch norm; ``node_mask`` keeps pad nodes out of its
    statistics."""

    def __init__(self, in_irreps: Irreps, out_irreps: Irreps,
                 sh_irreps: Irreps, edge_dim: int = 8, mlp_dim: int = 256,
                 aggr: str = "sum", batch_norm: bool = False,
                 gate: bool = False, weights_bf16: bool = False,
                 tp_precision: Optional[str] = None, *,
                 generator: torch.Generator):
        super().__init__()
        if aggr not in ("sum", "add", "mean"):
            raise ValueError(f"aggr must be 'sum', 'add' or 'mean', got {aggr!r}")
        self.aggr, self.weights_bf16 = aggr, weights_bf16
        out_irreps = Irreps(out_irreps)
        if gate:
            scalars, gates, gated = irreps2gate(out_irreps)
            if gated.num_irreps == 0:
                self.gate = Activation(out_irreps, act="silu")
                tp_out = out_irreps
            else:
                self.gate = Gate(scalars, gates, gated)
                tp_out = self.gate.irreps_in   # scalars + gates + gated
        else:
            self.gate = None
            tp_out = out_irreps
        self.tp = EdgeTensorProduct(Irreps(in_irreps), Irreps(sh_irreps),
                                    tp_out, precision=tp_precision)
        self.fc = MLP(edge_dim, (mlp_dim,), activation="relu", norm=None,
                      act_final=True, generator=generator)
        self.fc_out = nn.ModuleList(linear(mlp_dim, n, generator)
                                    for n in self.tp.group_weight_numels)
        self.bn = EquivariantBatchNorm(out_irreps) if batch_norm else None

    def heads(self, edge_feats: torch.Tensor):
        """The per-group edge weights ``[E, n_p*u*w]`` (bf16 with
        ``weights_bf16``)."""
        a = self.fc(edge_feats)
        if not self.weights_bf16:
            return [head(a) for head in self.fc_out]
        a16 = a.to(torch.bfloat16)
        return [F.linear(a16, head.weight.to(torch.bfloat16),
                         head.bias.to(torch.bfloat16)) for head in self.fc_out]

    def forward(self, node_feats, senders, receivers, edge_sh, edge_feats,
                edge_mask=None, node_mask=None) -> torch.Tensor:
        n = node_feats.shape[0]
        msg = self.tp.apply_grouped(node_feats[receivers], edge_sh,
                                    self.heads(edge_feats))
        reduce = segment_mean if self.aggr == "mean" else segment_sum
        out = reduce(msg, senders, n, mask=edge_mask)
        if self.gate is not None:
            out = self.gate(out)
        if self.bn is not None:
            out = self.bn(out, mask=node_mask)
        return out



class EquivariantProductBasisBlock(nn.Module):
    """``forward(node_feats [N, c, sum d], sc=None, node_attrs=None)``:
    ``SymmetricContraction`` (``symmetric_contraction``, flax
    ``SymmetricContraction_0``) -> ``IrrepsLinear`` (``linear``, flax
    ``IrrepsLinear_0``) -> ``+ sc`` when ``use_sc``; returns flat
    ``[N, target_irreps.dim]``.  ``precision`` is accepted for the JAX
    surface (exact f32 here).  ``node_chunk``: the three steps run in
    blocks of that many nodes, each under ``torch.utils.checkpoint``
    (``tensor_product.node_blocks``), so one block's ``[n, c, d, d]``
    intermediates are alive at a time; the rows are independent, so the
    result is the single pass's.  ``tp_axis`` (tensor parallelism) is not
    ported yet and raises ``NotImplementedError``."""

    def __init__(self, node_feats_irreps: Irreps, target_irreps: Irreps,
                 correlation: int, use_sc: bool = True,
                 element_dependent: bool = False,
                 num_elements: Optional[int] = None,
                 tp_axis: Optional[str] = None, tp_size: int = 1,
                 precision: Optional[str] = None,
                 node_chunk: Optional[int] = None, *,
                 generator: torch.Generator):
        super().__init__()
        if tp_axis is not None or tp_size != 1:
            raise NotImplementedError(
                "EquivariantProductBasisBlock(tp_axis=...) (tensor "
                "parallelism) is not ported yet")
        self.use_sc, self.node_chunk = use_sc, node_chunk
        self.symmetric_contraction = SymmetricContraction(
            Irreps(node_feats_irreps), Irreps(target_irreps), correlation,
            element_dependent=element_dependent, num_elements=num_elements,
            chain_precision=precision, generator=generator)
        self.linear = IrrepsLinear(Irreps(target_irreps), Irreps(target_irreps),
                                   precision=precision, generator=generator)

    def forward(self, node_feats: torch.Tensor,
                sc: Optional[torch.Tensor] = None,
                node_attrs: Optional[torch.Tensor] = None) -> torch.Tensor:
        C = self.node_chunk
        if C is None or node_feats.shape[0] <= C:
            return self._block(node_feats, sc, node_attrs)
        return node_blocks(self._block, C, node_feats, sc, node_attrs)

    def _block(self, node_feats: torch.Tensor, sc: Optional[torch.Tensor],
               node_attrs: Optional[torch.Tensor]) -> torch.Tensor:
        out = self.linear(self.symmetric_contraction(node_feats, node_attrs))
        if self.use_sc and sc is not None:
            out = out + sc
        return out
