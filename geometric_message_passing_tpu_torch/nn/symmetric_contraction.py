"""MACE's symmetric contraction, the higher body-order product basis (port
of ``nn/symmetric_contraction.py``: ``Contraction`` and
``SymmetricContraction``).

The generalised CG (U) tensors come from the port's own
``irreps.u_matrix_real``.  They are constants: non-persistent buffers (not
in the state dict, not trained), built once per process on the host and
copied to the module's device with it.  The products are PyTorch's
(einsums, batched matrix products) at ``chain_precision``
(``precision.py``; None: the process default): this operation has no
Pallas kernel in the JAX package, so none here either.

Two evaluations of the same polynomial, as in the JAX package:

* the descending-nu chain (Horner form): ``correlation >= 4``,
  ``element_dependent=True`` and ``fused_lowrank=False``;
* ``_fused_chain``, the reassociated form for ``correlation <= 3`` without
  element dependence (the default): the chain's ``[n, c, D, d, d]``
  intermediate never exists, its largest tensor is ``x (x) x`` at
  ``[n, c, d, d]``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import precision as prec
from ..irreps import Irrep, Irreps, u_matrix_real


def _normal_param(shape, std: float, generator: torch.Generator) -> nn.Parameter:
    w = torch.empty(shape)
    with torch.no_grad():
        w.normal_(0.0, std, generator=generator)
    return nn.Parameter(w)


def _chain(U: dict, W: dict, x: torch.Tensor, correlation: int,
           y: Optional[torch.Tensor] = None,
           precision: Optional[str] = None) -> torch.Tensor:
    """The descending-nu chain: ``U[nu]`` is ``[..., d, K_nu]``, ``W[nu]``
    ``[K_nu, c]`` (``[elements, K_nu, c]`` with the one-hot ``y``), ``x``
    ``[b, c, d]``; returns ``[b, c, ...]``.  Every einsum at
    ``precision``."""
    def ein(eq, *ops):
        return prec.einsum(eq, *ops, precision=precision, site="chain")

    nu = correlation
    if y is not None:
        out = ein("...ik,ekc,bci,be->bc...", U[nu], W[nu], x, y)
        for nu in range(correlation - 1, 0, -1):
            c = ein("...k,ekc,be->bc...", U[nu], W[nu], y) + out
            out = ein("bc...i,bci->bc...", c, x)
        return out
    out = ein("...ik,kc,bci->bc...", U[nu], W[nu], x)
    for nu in range(correlation - 1, 0, -1):
        c = ein("...k,kc->c...", U[nu], W[nu]) + out
        out = ein("bc...i,bci->bc...", c, x)
    return out


class Contraction(nn.Module):
    """The contraction to one output irrep over every correlation order:
    ``forward(x [n, c, irreps_in.dim], y=None)`` -> ``[n, c *
    ir_out.dim]``.  Buffers ``u{nu}``, parameters ``w{nu}`` (``[K_nu, c]``,
    or ``[num_elements, K_nu, c]`` with ``element_dependent``) drawn from
    N(0, 1/K_nu)."""

    def __init__(self, irreps_in: Irreps, ir_out: Irrep, correlation: int,
                 num_features: int, element_dependent: bool = False,
                 num_elements: Optional[int] = None, *,
                 generator: torch.Generator):
        super().__init__()
        self.correlation = correlation
        self.element_dependent = element_dependent
        for nu in range(1, correlation + 1):
            U = u_matrix_real(Irreps(irreps_in), ir_out, nu)
            self.register_buffer(f"u{nu}", torch.tensor(U, dtype=torch.float32),
                                 persistent=False)
            k = U.shape[-1]
            shape = ((num_elements, k, num_features) if element_dependent
                     else (k, num_features))
            setattr(self, f"w{nu}", _normal_param(shape, 1.0 / k, generator))

    def forward(self, x: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        nus = range(1, self.correlation + 1)
        U = {nu: getattr(self, f"u{nu}").to(x.dtype) for nu in nus}
        W = {nu: getattr(self, f"w{nu}") for nu in nus}
        out = _chain(U, W, x, self.correlation,
                     y if self.element_dependent else None)
        return out.reshape(out.shape[0], -1)


@functools.lru_cache(maxsize=None)
def _stacked_u(coupling: str, irs_out: Tuple[str, ...], nu: int) -> np.ndarray:
    """The output irreps' U tensors stacked block-diagonally over (output
    dim, paths): ``[D, d, ..., d, K]``, each irrep's block at its (o, k)
    offsets and zeros elsewhere, float32, once per process."""
    blocks = []
    for ir in irs_out:
        u = np.asarray(u_matrix_real(Irreps(coupling), Irrep.parse(ir), nu),
                       dtype=np.float32)
        if u.ndim == nu + 1:     # scalar output: d_out axis omitted
            u = u[None]
        blocks.append(u)
    D = sum(b.shape[0] for b in blocks)
    K = sum(b.shape[-1] for b in blocks)
    d = blocks[0].shape[1]
    out = np.zeros((D,) + (d,) * nu + (K,), dtype=np.float32)
    o = k = 0
    for b in blocks:
        out[o:o + b.shape[0], ..., k:k + b.shape[-1]] = b
        o += b.shape[0]
        k += b.shape[-1]
    return out


class SymmetricContraction(nn.Module):
    """Every output irrep contracted in one chain over U tensors stacked
    block-diagonally (the zero blocks annihilate the cross terms, so the
    numbers are the per-irrep results).  ``forward(x [n, c, sum_l d_l],
    y=None)`` (``reshape_irreps`` layout) -> flat ``[n, sum c * d_out]``.

    Buffers ``u{nu}`` (non-persistent); per output irrep the parameters
    ``contraction_{ir}_w{nu}`` (``[K_i, c]``, or ``[num_elements, K_i, c]``)
    drawn from N(0, 1/K_i) and concatenated along K in the forward.

    ``chain_precision``: the precision of the chain's products, in both
    forms (``precision.py``; None: the process default).  ``chain_dtype``
    (the JAX package's speed knob, e.g. ``"bfloat16"``; set by no model,
    an attribute that may be set after construction): x, U, W (and y) cast
    to it, the chain computed in it (its intermediates stay in it), the
    output cast back to x's type."""

    def __init__(self, irreps_in: Irreps, irreps_out: Irreps,
                 correlation: int, element_dependent: bool = False,
                 num_elements: Optional[int] = None,
                 chain_dtype: Optional[str] = None,
                 chain_precision: Optional[str] = None,
                 fused_lowrank: bool = True, *, generator: torch.Generator):
        super().__init__()
        self.chain_dtype, self.chain_precision = chain_dtype, chain_precision
        irreps_in, irreps_out = Irreps(irreps_in), Irreps(irreps_out)
        muls = {mul for mul, _ in irreps_in}
        if len(muls) != 1:
            raise ValueError(f"irreps_in needs one multiplicity, got {irreps_in}")
        num_features = muls.pop()
        coupling = Irreps([(1, ir) for _, ir in irreps_in])
        self.irs_out = [ir for _, ir in irreps_out]
        self.correlation = correlation
        self.element_dependent = element_dependent
        self.fused = (fused_lowrank and correlation <= 3
                      and not element_dependent)
        self.names = {}
        for nu in range(1, correlation + 1):
            U = _stacked_u(str(coupling), tuple(map(str, self.irs_out)), nu)
            self.register_buffer(f"u{nu}", torch.from_numpy(U.copy()),
                                 persistent=False)
            self.names[nu] = []
            for ir in self.irs_out:
                k = u_matrix_real(coupling, ir, nu).shape[-1]
                shape = ((num_elements, k, num_features) if element_dependent
                         else (k, num_features))
                name = f"contraction_{ir}_w{nu}"
                setattr(self, name, _normal_param(shape, 1.0 / k, generator))
                self.names[nu].append(name)

    def weights(self) -> dict:
        """``{nu: W_nu}``, each irrep's parameters concatenated along K."""
        return {nu: torch.cat([getattr(self, n) for n in names], dim=-2)
                for nu, names in self.names.items()}

    def forward(self, x: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        in_dtype = x.dtype
        U = {nu: getattr(self, f"u{nu}").to(x.dtype) for nu in self.names}
        W = self.weights()
        y = y if self.element_dependent else None
        if self.chain_dtype is not None:
            cd = getattr(torch, self.chain_dtype)
            x = x.to(cd)
            U = {k: v.to(cd) for k, v in U.items()}
            W = {k: v.to(cd) for k, v in W.items()}
            y = None if y is None else y.to(cd)
        if self.fused:
            out = self._fused_chain(x, U, W)
        else:
            out = _chain(U, W, x, self.correlation, y, self.chain_precision)
        out = out.to(in_dtype)
        outs, o = [], 0          # [n, c, D] in output-irrep order -> flat
        for ir in self.irs_out:
            blk = out[..., o:o + ir.dim]
            outs.append(blk.reshape(blk.shape[0], -1))
            o += ir.dim
        return torch.cat(outs, dim=-1)

    def _fused_chain(self, x: torch.Tensor, U: dict, W: dict) -> torch.Tensor:
        """The chain reassociated (correlation <= 3): with ``z = [x (x) x,
        x]`` of width d^2 + d and ``M`` the U3W3 / U2W2 projections,
        ``out2[b, c, (D, j1)] = z[b, c] @ M[c]``, one product batched over
        the channels; then ``U1W1`` is added and ``x`` contracted once more,
        as in the chain."""
        b, c, d = x.shape
        nu = self.correlation
        D = U[1].shape[0]

        def ein(eq, *ops):
            return prec.einsum(eq, *ops, precision=self.chain_precision,
                               site="chain")

        A1 = ein("...k,kc->c...", U[1], W[1])                      # [c, D, j1]
        if nu == 1:
            return ein("bci,cDi->bcD", x, A1)
        # A2: [c, D, j1, i] -> [c, i, (D, j1)]
        A2 = ein("...k,kc->c...", U[2], W[2])
        A2 = A2.permute(0, 3, 1, 2).reshape(c, d, D * d)
        if nu == 3:
            # A3: [c, D, j1, j2, i] -> [c, (i, j2), (D, j1)]
            A3 = ein("...k,kc->c...", U[3], W[3])
            A3 = A3.permute(0, 4, 3, 1, 2).reshape(c, d * d, D * d)
            M = torch.cat([A3, A2], dim=1)                          # [c, d²+d, Dd]
            xx = ein("bci,bcj->bcij", x, x).reshape(b, c, d * d)
            z = torch.cat([xx, x], dim=-1)                          # [b, c, d²+d]
            out2 = ein("bcz,czq->bcq", z, M)
        else:
            out2 = ein("bci,ciq->bcq", x, A2)
        out2 = out2.reshape(b, c, D, d) + A1[None]
        return ein("bcqj,bcj->bcq", out2, x)
