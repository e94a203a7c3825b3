"""``TensorProductConvLayer``, the equivariant graph convolution of TFN and
MACE, and MACE's ``EquivariantProductBasisBlock`` (port of ``nn/conv.py``).

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
``tp_precision`` is the precision of the edge product's stage 1 (K7, its
stage 2, computes exact f32 whatever it says), ``head_precision`` that of
the weight heads (``precision.py``; None: the process default).

``EquivariantProductBasisBlock``: the symmetric contraction, then an
``IrrepsLinear``, then the self-connection added; with ``node_chunk``, in
row blocks under ``torch.utils.checkpoint`` (box scale).

Tensor parallelism (``tp_axis``, ``tp_size``, ``mesh``; ``parallel/tp.py``):
each rank holds ``1/tp_size`` of the channels (mul) of every irrep and the
module is built with those local multiplicities.  The channel-mixing
products are row-parallel: the edge tensor product maps local-mul inputs
to FULL-mul outputs (its path weights times ``1/sqrt(tp_size)``, so the
fan-in normalisation is the full model's), and after the segment sum one
``differentiable.psum`` over ``tp_axis`` completes the contraction before
``shard_mul_slice`` keeps this rank's channels; the product block's
``IrrepsLinear`` likewise (``fan_mult=tp_size``).  Under tensor parallelism
the gate scalars stay one ``0e`` entry per gated irrep: a merged entry's
mul slice would pair this rank's gated channels with other channels'
gates.  ``parallel.tp.shard_model_variables`` maps the full model's head
columns onto that layout.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import precision as prec
from ..irreps import Irrep, Irreps
from ..ops.scatter import segment_mean, segment_sum
from .basic import MLP, linear
from .equivariant import (Activation, EquivariantBatchNorm, Gate,
                          IrrepsLinear, irreps2gate, scale_mul,
                          shard_mul_slice)
from .symmetric_contraction import SymmetricContraction
from .tensor_product import EdgeTensorProduct, node_blocks


def check_tp(tp_axis: Optional[str], tp_size: int, mesh, where: str) -> None:
    """``ValueError`` unless ``tp_axis`` is None with ``tp_size`` 1, or an
    axis of ``mesh`` with ``tp_size`` ranks (there is no process-global
    mesh: a tensor-parallel module is given its own)."""
    if tp_axis is None:
        if tp_size != 1:
            raise ValueError(f"{where}: tp_size {tp_size} without tp_axis")
        return
    if mesh is None:
        raise ValueError(f"{where}(tp_axis={tp_axis!r}) needs mesh=, the "
                         "parallel.Mesh its ranks form")
    if mesh.shape.get(tp_axis) != tp_size:
        raise ValueError(f"{where}: tp_size {tp_size}, but mesh axis "
                         f"{tp_axis!r} has {mesh.shape.get(tp_axis)} ranks")


class TensorProductConvLayer(nn.Module):
    """``forward(node_feats [N, in_irreps.dim], senders, receivers, edge_sh,
    edge_feats, edge_mask=None, node_mask=None)`` returns ``[N,
    out_irreps.dim]``.  ``edge_dim`` is the width of ``edge_feats`` (flax
    infers it).  Training mode (``module.train()``) is the JAX ``train=True``
    of the batch norm; ``node_mask`` keeps pad nodes out of its
    statistics.  With ``tp_axis`` the irreps are this rank's (local mul)
    and ``tp_out_full`` is the edge product's full-mul output."""

    def __init__(self, in_irreps: Irreps, out_irreps: Irreps,
                 sh_irreps: Irreps, edge_dim: int = 8, mlp_dim: int = 256,
                 aggr: str = "sum", batch_norm: bool = False,
                 gate: bool = False, weights_bf16: bool = False,
                 tp_precision: Optional[str] = None,
                 tp_axis: Optional[str] = None, tp_size: int = 1,
                 mesh=None, head_precision: Optional[str] = None, *,
                 generator: torch.Generator):
        super().__init__()
        if aggr not in ("sum", "add", "mean"):
            raise ValueError(f"aggr must be 'sum', 'add' or 'mean', got {aggr!r}")
        check_tp(tp_axis, tp_size, mesh, "TensorProductConvLayer")
        self.aggr, self.weights_bf16 = aggr, weights_bf16
        self.tp_axis, self.tp_size, self.mesh = tp_axis, tp_size, mesh
        out_irreps = Irreps(out_irreps)
        if gate:
            scalars, gates, gated = irreps2gate(out_irreps)
            if tp_axis is not None:     # one gates entry per gated irrep
                gates = Irreps([(mul, Irrep(0, 1)) for mul, _ in gated])
            if gated.num_irreps == 0:
                self.gate = Activation(out_irreps, act="silu")
                tp_out = out_irreps
            else:
                self.gate = Gate(scalars, gates, gated)
                tp_out = self.gate.irreps_in   # scalars + gates + gated
        else:
            self.gate = None
            tp_out = out_irreps
        self.tp_out_full = None
        if tp_axis is not None:
            self.tp_out_full = tp_out = scale_mul(tp_out, tp_size)
        self.tp = EdgeTensorProduct(Irreps(in_irreps), Irreps(sh_irreps),
                                    tp_out, path_weight_scale=tp_size ** -0.5,
                                    precision=tp_precision)
        self.fc = MLP(edge_dim, (mlp_dim,), activation="relu", norm=None,
                      act_final=True, generator=generator)
        self.fc_out = nn.ModuleList(
            linear(mlp_dim, n, generator, precision=head_precision,
                   site="heads") for n in self.tp.group_weight_numels)
        self.bn = EquivariantBatchNorm(out_irreps) if batch_norm else None

    def heads(self, edge_feats: torch.Tensor):
        """The per-group edge weights ``[E, n_p*u*w]`` (bf16 with
        ``weights_bf16``)."""
        a = self.fc(edge_feats)
        if not self.weights_bf16:
            return [head(a) for head in self.fc_out]
        a16 = a.to(torch.bfloat16)
        return [prec.linear(a16, head.weight.to(torch.bfloat16),
                            head.bias.to(torch.bfloat16), head.precision,
                            head.site) for head in self.fc_out]

    def forward(self, node_feats, senders, receivers, edge_sh, edge_feats,
                edge_mask=None, node_mask=None) -> torch.Tensor:
        n = node_feats.shape[0]
        msg = self.tp.apply_grouped(node_feats[receivers], edge_sh,
                                    self.heads(edge_feats))
        reduce = segment_mean if self.aggr == "mean" else segment_sum
        out = reduce(msg, senders, n, mask=edge_mask)
        if self.tp_axis is not None:
            out = _psum_slice(self.mesh, out, self.tp_out_full, self.tp_size,
                              self.tp_axis)
        if self.gate is not None:
            out = self.gate(out)
        if self.bn is not None:
            out = self.bn(out, mask=node_mask)
        return out


def _psum_slice(mesh, x: torch.Tensor, irreps_full: Irreps, tp_size: int,
                axis: str) -> torch.Tensor:
    """The row-parallel product's end: the partial full-mul result summed
    over ``axis``, then this rank's channels."""
    from ..parallel.mesh import differentiable

    x = differentiable.psum(mesh, x, axis)
    return shard_mul_slice(x, irreps_full, tp_size, mesh.coords[axis])


class EquivariantProductBasisBlock(nn.Module):
    """``forward(node_feats [N, c, sum d], sc=None, node_attrs=None)``:
    ``SymmetricContraction`` (``symmetric_contraction``, flax
    ``SymmetricContraction_0``) -> ``IrrepsLinear`` (``linear``, flax
    ``IrrepsLinear_0``) -> ``+ sc`` when ``use_sc``; returns flat
    ``[N, target_irreps.dim]``.  ``precision``: the precision of the
    contraction's chain and of the ``IrrepsLinear`` (``precision.py``).
    ``node_chunk``: the three steps run in
    blocks of that many nodes, each under ``torch.utils.checkpoint``
    (``tensor_product.node_blocks``), so one block's ``[n, c, d, d]``
    intermediates are alive at a time; the rows are independent, so the
    result is the single pass's.  With ``tp_axis`` the channels are this
    rank's: the symmetric contraction is channel-wise and runs locally, the
    ``IrrepsLinear`` maps them to the full multiplicities
    (``fan_mult=tp_size``), then ``differentiable.psum`` and this rank's
    slice; ``node_chunk`` is off, as in the JAX package."""

    def __init__(self, node_feats_irreps: Irreps, target_irreps: Irreps,
                 correlation: int, use_sc: bool = True,
                 element_dependent: bool = False,
                 num_elements: Optional[int] = None,
                 tp_axis: Optional[str] = None, tp_size: int = 1,
                 precision: Optional[str] = None,
                 node_chunk: Optional[int] = None, mesh=None, *,
                 generator: torch.Generator):
        super().__init__()
        check_tp(tp_axis, tp_size, mesh, "EquivariantProductBasisBlock")
        self.use_sc = use_sc
        self.node_chunk = None if tp_axis is not None else node_chunk
        self.tp_axis, self.tp_size, self.mesh = tp_axis, tp_size, mesh
        target = Irreps(target_irreps)
        self.target_full = scale_mul(target, tp_size)
        self.symmetric_contraction = SymmetricContraction(
            Irreps(node_feats_irreps), target, correlation,
            element_dependent=element_dependent, num_elements=num_elements,
            chain_precision=precision, generator=generator)
        self.linear = IrrepsLinear(target, self.target_full, fan_mult=tp_size,
                                   precision=precision, generator=generator,
                                   site="prod_linear")

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
        if self.tp_axis is not None:
            out = _psum_slice(self.mesh, out, self.target_full, self.tp_size,
                              self.tp_axis)
        if self.use_sc and sc is not None:
            out = out + sc
        return out
