"""Equivariant primitives over irreps-typed features (port of
``nn/equivariant.py``).

Features are flat ``[N, irreps.dim]`` in e3nn's layout: per irrep block,
multiplicity-major (``[mul, 2l+1]`` row-major).  Ported here: the block
helpers, ``Gate`` and ``Activation`` (e3nn's gated nonlinearity, activations
rescaled to keep the second moment), ``EquivariantBatchNorm`` (e3nn's
``nn.BatchNorm``: running statistics as buffers, ``mask`` keeps pad rows out
of them), MACE's channel layout (``reshape_irreps`` /
``inverse_reshape_irreps``) and ``IrrepsLinear`` (e3nn's ``o3.Linear``).
The tensor-parallel helpers: ``scale_mul`` (the full irreps of a mul
shard) and ``shard_mul_slice`` (a shard's channels of full features).
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import precision as prec
from ..irreps import Irrep, Irreps
from .basic import ACT


def split_blocks(x: torch.Tensor, irreps: Irreps) -> List[torch.Tensor]:
    """Flat ``[..., irreps.dim]`` -> list of ``[..., mul, 2l+1]`` blocks."""
    out, ix = [], 0
    for mul, ir in irreps:
        d = mul * ir.dim
        out.append(x[..., ix:ix + d].reshape(x.shape[:-1] + (mul, ir.dim)))
        ix += d
    return out


def merge_blocks(blocks: List[torch.Tensor]) -> torch.Tensor:
    """Inverse of ``split_blocks``."""
    flat = [b.reshape(b.shape[:-2] + (b.shape[-2] * b.shape[-1],))
            for b in blocks]
    return torch.cat(flat, dim=-1)


def scale_mul(irreps: Irreps, k: int) -> Irreps:
    """Every multiplicity times ``k``: the full irreps of a ``k``-way mul
    shard."""
    return Irreps([(mul * k, ir) for mul, ir in irreps])


def shard_mul_slice(x: torch.Tensor, irreps_full: Irreps, tp_size: int,
                    shard_index: int) -> torch.Tensor:
    """Shard ``shard_index``'s channels of flat full-mul features: block
    ``shard_index`` of ``tp_size`` of the mul axis of every irrep."""
    outs = []
    for blk, (mul, _) in zip(split_blocks(x, irreps_full), irreps_full):
        loc = mul // tp_size
        outs.append(blk[..., shard_index * loc:(shard_index + 1) * loc, :])
    return merge_blocks(outs)


def reshape_irreps(x: torch.Tensor, irreps: Irreps) -> torch.Tensor:
    """Flat ``[N, sum mul*d]`` -> ``[N, mul, sum d]`` for irreps of one
    multiplicity: MACE's feature layout."""
    if len({mul for mul, _ in irreps}) != 1:
        raise ValueError(f"needs one multiplicity for every irrep, got {irreps}")
    return torch.cat(split_blocks(x, irreps), dim=-1)


def inverse_reshape_irreps(x: torch.Tensor, irreps: Irreps) -> torch.Tensor:
    """``[N, mul, sum d]`` -> flat ``[N, sum mul*d]``."""
    out, ix = [], 0
    for mul, ir in irreps:
        blk = x[..., ix:ix + ir.dim]
        out.append(blk.reshape(blk.shape[:-2] + (mul * ir.dim,)))
        ix += ir.dim
    return torch.cat(out, dim=-1)


def pad_to_irreps(x: torch.Tensor, target_dim: int) -> torch.Tensor:
    """Zero-pad the last axis to ``target_dim`` (the residual of a layer
    whose output irreps extend its input's)."""
    pad = target_dim - x.shape[-1]
    if pad == 0:
        return x
    return torch.nn.functional.pad(x, (0, pad))


class IrrepsLinear(nn.Module):
    """Per-irrep block linear map (e3nn ``o3.Linear``): output block k is
    ``sum_{i: ir_i == ir_k} x_i W_ik / sqrt(fan)``, fan the total input
    multiplicity feeding irrep k (times ``fan_mult``), weights drawn from
    N(0, 1) (``generator``).

    Parameters ``w{i}_{k}`` of shape ``[mul_in, mul_out]``, the flax names;
    when both sides list the same irreps with one multiplicity each (MACE's
    square map) only the diagonal ``w{k}_{k}`` exist, with fan ``mul_in``,
    as in the JAX package's fast path.  ``precision``: the precision of its
    products (``precision.py``; None: the process default); ``site`` names
    them for ``precision.record``."""

    def __init__(self, irreps_in: Irreps, irreps_out: Irreps,
                 fan_mult: int = 1, precision: Optional[str] = None, *,
                 generator: torch.Generator, site: str = "irreps_linear"):
        super().__init__()
        self.precision, self.site = precision, site
        self.irreps_in, self.irreps_out = Irreps(irreps_in), Irreps(irreps_out)
        ins, outs = self.irreps_in, self.irreps_out
        square = ([ir for _, ir in ins] == [ir for _, ir in outs]
                  and len({m for m, _ in ins}) == 1
                  and len({m for m, _ in outs}) == 1)
        # per output block: its [(input block, parameter name)] and its fan
        self.paths: List[List[Tuple[int, str]]] = []
        self.fans: List[int] = []
        for ko, (mul_out, ir_out) in enumerate(outs):
            if square:
                pairs = [ko]
                fan = fan_mult * ins[ko][0]
            else:
                pairs = [ki for ki, (_, ir_in) in enumerate(ins) if ir_in == ir_out]
                fan = fan_mult * sum(ins[ki][0] for ki in pairs)
            names = []
            for ki in pairs:
                name = f"w{ki}_{ko}"
                w = torch.empty(ins[ki][0], mul_out)
                with torch.no_grad():
                    w.normal_(0.0, 1.0, generator=generator)
                setattr(self, name, nn.Parameter(w))
                names.append((ki, name))
            self.paths.append(names)
            self.fans.append(fan)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = split_blocks(x, self.irreps_in)
        outs = []
        for (mul_out, ir_out), names, fan in zip(self.irreps_out, self.paths,
                                                 self.fans):
            if not names:
                outs.append(x.new_zeros(x.shape[:-1] + (mul_out, ir_out.dim)))
                continue
            y = sum(prec.einsum("...ud,uw->...wd", xs[ki], getattr(self, name),
                                precision=self.precision, site=self.site)
                    for ki, name in names)
            outs.append(y / math.sqrt(max(fan, 1)))
        return merge_blocks(outs)


@functools.lru_cache(maxsize=None)
def _act_second_moment(name: str) -> float:
    """1/sqrt(E_{x~N(0,1)}[act(x)^2]), e3nn's normalize2mom constant: the
    activation evaluated in float32 on a 200001-point grid over [-12, 12],
    the squares and the trapezoid rule in float64 (the JAX package's
    recipe)."""
    xs = np.linspace(-12, 12, 200001)
    w = np.exp(-0.5 * xs**2) / math.sqrt(2 * math.pi)
    ys = ACT[name](torch.as_tensor(xs, dtype=torch.float32)).numpy()
    m2 = np.trapezoid(ys**2 * w, xs)
    return float(1.0 / math.sqrt(m2))


def irreps2gate(irreps: Irreps) -> Tuple[Irreps, Irreps, Irreps]:
    """Split into (scalars, gates, gated): the even scalars, one 0e gate per
    gated multiplicity (merged), and everything else."""
    scalars, gated = [], []
    for mul, ir in irreps:
        (scalars if (ir.l == 0 and ir.p == 1) else gated).append((mul, ir))
    scalars = Irreps(scalars).simplify()
    gated = Irreps(gated).simplify()
    gates = Irreps([(mul, Irrep(0, 1)) for mul, _ in gated]).simplify()
    return scalars, gates, gated


class Gate(nn.Module):
    """e3nn-style gated nonlinearity.  Input irreps: scalars + gates + gated
    (in that order).  Scalars -> silu, gates -> sigmoid, each gated irrep
    multiplied by its gate; activations rescaled to keep the second
    moment."""

    def __init__(self, irreps_scalars: Irreps, irreps_gates: Irreps,
                 irreps_gated: Irreps, act_scalars: str = "silu",
                 act_gates: str = "sigmoid"):
        super().__init__()
        self.irreps_scalars = Irreps(irreps_scalars)
        self.irreps_gates = Irreps(irreps_gates)
        self.irreps_gated = Irreps(irreps_gated)
        self.act_scalars, self.act_gates = act_scalars, act_gates

    @property
    def irreps_in(self) -> Irreps:
        return self.irreps_scalars + self.irreps_gates + self.irreps_gated

    @property
    def irreps_out(self) -> Irreps:
        return self.irreps_scalars + self.irreps_gated

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ns, ng = self.irreps_scalars.dim, self.irreps_gates.dim
        scalars = x[..., :ns]
        gates = x[..., ns:ns + ng]
        gated = x[..., ns + ng:]
        if ns:
            scalars = ACT[self.act_scalars](scalars) * _act_second_moment(
                self.act_scalars)
        if ng:
            gates = ACT[self.act_gates](gates) * _act_second_moment(
                self.act_gates)
            out_blocks, off = [], 0
            for b in split_blocks(gated, self.irreps_gated):
                mul = b.shape[-2]
                out_blocks.append(b * gates[..., off:off + mul, None])
                off += mul
            gated = merge_blocks(out_blocks)
        return torch.cat([scalars, gated], dim=-1)


class Activation(nn.Module):
    """Scalar-only equivariant activation (e3nn ``nn.Activation`` with one
    activation), rescaled to keep the second moment."""

    def __init__(self, irreps: Irreps, act: str = "silu"):
        super().__init__()
        self.irreps = Irreps(irreps)
        if not all(ir.l == 0 for _, ir in self.irreps):
            raise ValueError(f"Activation takes scalars only, got {self.irreps}")
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ACT[self.act](x) * _act_second_moment(self.act)


class EquivariantBatchNorm(nn.Module):
    """e3nn ``nn.BatchNorm``: per-irrep RMS normalization with running
    statistics; scalars also get mean subtraction; an affine weight per
    multiplicity (and a bias for scalars).  normalization 'component',
    momentum 0.1.

    Training mode (``module.train()``) uses the batch's statistics (over the
    rows ``mask`` keeps, when given) and updates the running buffers
    ``mean{k}`` (scalars) and ``var{k}`` in place; eval mode reads them.
    Names follow the flax tree (``batch_stats/mean{k}``, ``var{k}``,
    ``params/weight{k}``, ``bias{k}``)."""

    def __init__(self, irreps: Irreps, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True):
        super().__init__()
        self.irreps = Irreps(irreps)
        self.eps, self.momentum, self.affine = eps, momentum, affine
        for k, (mul, ir) in enumerate(self.irreps):
            scalar = ir.l == 0 and ir.p == 1
            if scalar:
                self.register_buffer(f"mean{k}", torch.zeros(mul))
            self.register_buffer(f"var{k}", torch.ones(mul))
            if affine:
                setattr(self, f"weight{k}", nn.Parameter(torch.ones(mul)))
                if scalar:
                    setattr(self, f"bias{k}", nn.Parameter(torch.zeros(mul)))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        outs = []
        if mask is not None:
            w = mask.to(x.dtype)[:, None]
            denom = torch.clamp_min(w.sum(), 1.0)
        for k, ((mul, ir), field) in enumerate(zip(self.irreps,
                                                   split_blocks(x, self.irreps))):
            scalar = ir.l == 0 and ir.p == 1
            if scalar:
                ra_mean = getattr(self, f"mean{k}")
                if self.training:
                    fm = ((field[..., 0] * w).sum(0) / denom if mask is not None
                          else field[..., 0].mean(0))
                    with torch.no_grad():
                        ra_mean.copy_((1 - self.momentum) * ra_mean
                                      + self.momentum * fm)
                else:
                    fm = ra_mean
                field = field - fm[:, None]
            ra_var = getattr(self, f"var{k}")
            if self.training:
                fn = (field**2).mean(-1)
                fn = (fn * w).sum(0) / denom if mask is not None else fn.mean(0)
                with torch.no_grad():
                    ra_var.copy_((1 - self.momentum) * ra_var
                                 + self.momentum * fn)
            else:
                fn = ra_var
            inv = (fn + self.eps) ** -0.5
            if self.affine:
                inv = inv * getattr(self, f"weight{k}")
            field = field * inv[:, None]
            if scalar and self.affine:
                field = field + getattr(self, f"bias{k}")[:, None]
            outs.append(field)
        return merge_blocks(outs)
