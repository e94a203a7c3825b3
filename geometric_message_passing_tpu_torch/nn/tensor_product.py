"""Edge-wise Clebsch-Gordan tensor product (port of ``nn/tensor_product.py``:
``EdgeTensorProduct``, e3nn's ``FullyConnectedTensorProduct(irreps_in,
irreps_sh, irreps_out, shared_weights=False)`` with per-edge weights).

Features are laid out as ``[E, mul, 2l+1]`` blocks and each CG path is

    tmp[e,u,m3] = x[e,u,m1] sh[e,m2] C[m1,m2,m3]       (stage 1)
    out[e,w,m3] = sum_u W_p[e,u,w] tmp[e,u,m3]          (stage 2)

with the paths that share an output irrep accumulated.  Normalization
follows e3nn's defaults (component irreps, 'element' paths): the path
weight sqrt((2l3+1)/fan_in) is folded into the CG constant.

Stage 1 is a plain product (one per-edge CG matrix ``sh @ C``, then one
batched product with the input), as the JAX package leaves it to XLA.
Stage 2 contracts every output-irrep group in one call of
``ops.edge_contract.edge_weighted_contract_grouped``: one launch of the
hand-written kernel K7 per layer and direction on the card, its plain
version on the CPU.  Each group's ``T [E, (p,u), m]`` is built contiguous;
its weights, the head output ``[E, n_p*u*w]`` (or a slice of the flat
weights), are passed as the free view ``[E, (p,u), w]`` and never copied.

``precision`` (the JAX package's ``tp_precision``) is accepted and has no
effect: on the card both stages are exact f32 (TF32 stays off and K7 uses
f32 FMAs).  MACE's ``EdgeTensorProductUVU`` and
``FullyConnectedTensorProduct`` wait for the MACE slice.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..irreps import Irreps, tp_paths, wigner_3j
from ..ops.edge_contract import edge_weighted_contract_grouped
from .equivariant import merge_blocks, split_blocks


def _combined_cg(paths, irreps_in: Irreps, irreps_sh: Irreps,
                 scale: float = 1.0) -> np.ndarray:
    """Block-sparse combined CG constant ``C[a, b, M]`` (float32) with the
    path weights folded in: ``a`` indexes the per-channel input layout (sum
    of the input irreps' dims), ``b`` the SH dim, ``M`` the (path, m3) pairs
    in ``paths`` order."""
    a_off, ix = [], 0
    for _, ir in irreps_in:
        a_off.append(ix)
        ix += ir.dim
    L = ix
    sh_off, ix = [], 0
    for mul, ir in irreps_sh:
        sh_off.append(ix)
        ix += mul * ir.dim
    S = ix
    M = sum(p.ir_out.dim for p in paths)
    C = np.zeros((L, S, M), dtype=np.float32)
    m = 0
    for p in paths:
        w3j = wigner_3j(p.ir_in1.l, p.ir_in2.l, p.ir_out.l)
        d1, d2, d3 = p.ir_in1.dim, p.ir_in2.dim, p.ir_out.dim
        a0, b0 = a_off[p.i_in1], sh_off[p.i_in2]
        C[a0:a0 + d1, b0:b0 + d2, m:m + d3] = (p.path_weight * scale) * w3j
        m += d3
    return C


def _to_channel_layout(x: torch.Tensor, irreps: Irreps) -> torch.Tensor:
    """Flat ``[E, sum mul*d]`` -> ``[E, mul, sum d]`` (uniform mul)."""
    return torch.cat(split_blocks(x, irreps), dim=-1)


def _stage1(x: torch.Tensor, sh: torch.Tensor, C: torch.Tensor
            ) -> torch.Tensor:
    """``tmp[e,u,m] = sum_ab x[e,u,a] sh[e,b] C[a,b,m]``: the per-edge CG
    matrix ``sh @ C`` ``[E, a, m]``, then one batched product."""
    L, S, M = C.shape
    lead = x.shape[:-2]
    xf = x.reshape((-1,) + x.shape[-2:])
    Ce = (sh.reshape(-1, S) @ C.permute(1, 0, 2).reshape(S, L * M))
    return torch.bmm(xf, Ce.reshape(-1, L, M)).reshape(
        lead + (x.shape[-2], M))


class EdgeTensorProduct:
    """Descriptor and apply of the fully connected edge tensor product; no
    parameters (the per-edge weights are inputs).  Built once per layer."""

    def __init__(self, irreps_in: Irreps, irreps_sh: Irreps,
                 irreps_out: Irreps, path_weight_scale: float = 1.0,
                 precision: Optional[str] = None):
        self.irreps_in = Irreps(irreps_in)
        self.irreps_sh = Irreps(irreps_sh)
        self.irreps_out = Irreps(irreps_out)
        self.path_weight_scale = float(path_weight_scale)
        self.precision = precision
        paths = tp_paths(self.irreps_in, self.irreps_sh, self.irreps_out)
        # grouped by output irrep (stable): the weight layout and the
        # combined CG's M axis are contiguous per output irrep
        self.paths = sorted(paths, key=lambda p: p.i_out)
        if not all(p.mul_in2 == 1 for p in self.paths):
            raise ValueError("EdgeTensorProduct: SH multiplicity must be 1")
        self.weight_numel = sum(p.mul_in1 * p.mul_out for p in self.paths)
        self._sh_offsets, ix = [], 0
        for mul, ir in self.irreps_sh:
            self._sh_offsets.append((ix, ir.dim))
            ix += mul * ir.dim
        muls = {mul for mul, _ in self.irreps_in}
        self._uniform_mul = muls.pop() if len(muls) == 1 else None
        if self._uniform_mul is not None:
            self._C = _combined_cg(self.paths, self.irreps_in, self.irreps_sh,
                                   self.path_weight_scale)
            # per group: (i_out, n_paths, m_start, w_start, d3, u, mul_out)
            self._groups = []
            m = w = 0
            for i_out, (mul_o, ir_o) in enumerate(self.irreps_out):
                pids = [p for p in self.paths if p.i_out == i_out]
                if pids:
                    self._groups.append((i_out, len(pids), m, w, ir_o.dim,
                                         pids[0].mul_in1, mul_o))
                    m += len(pids) * ir_o.dim
                    w += sum(p.mul_in1 * p.mul_out for p in pids)

    @property
    def group_weight_numels(self) -> List[int]:
        """Per-output-irrep-group weight widths, in group order (the flat
        weight vector is their concatenation)."""
        if self._uniform_mul is None:
            return [self.weight_numel]
        u = self._uniform_mul
        return [n_p * u * mul_o for _, n_p, _, _, _, _, mul_o in self._groups]

    @property
    def group_shapes(self) -> List[tuple]:
        """``(K, m, w)`` of each group's contraction: K = n_paths * u."""
        return [(n_p * u, d3, mul_o)
                for _, n_p, _, _, d3, u, mul_o in self._groups]

    def apply(self, x: torch.Tensor, sh: torch.Tensor,
              weights: torch.Tensor) -> torch.Tensor:
        """x ``[E, irreps_in.dim]``, sh ``[E, irreps_sh.dim]``, weights
        ``[E, weight_numel]``; returns ``[E, irreps_out.dim]``."""
        if self._uniform_mul is not None:
            return self._apply_combined(x, sh, weights)
        return self._apply_per_path(x, sh, weights)

    def apply_grouped(self, x: torch.Tensor, sh: torch.Tensor,
                      ws: Sequence[torch.Tensor]) -> torch.Tensor:
        """``apply`` with the per-edge weights split per output-irrep group
        (widths ``group_weight_numels``; within a group path-major, then
        ``[u, w]`` row-major), as the conv's per-group heads emit them."""
        if self._uniform_mul is None:
            return self._apply_per_path(x, sh, torch.cat(list(ws), dim=-1))
        return self._apply_combined(x, sh, None, ws=ws)

    def _zeros_for_missing(self, outs, x: torch.Tensor) -> torch.Tensor:
        for k, (mul, ir) in enumerate(self.irreps_out):
            if outs[k] is None:
                outs[k] = x.new_zeros(x.shape[:-1] + (mul, ir.dim))
        return merge_blocks(outs)

    def _apply_combined(self, x, sh, weights, ws=None) -> torch.Tensor:
        """Stage 1 over the combined CG constant, then the contractions of
        all output irreps over their contiguous k = (path, u) axes in one
        grouped K7 call."""
        u = self._uniform_mul
        xr = _to_channel_layout(x, self.irreps_in)            # [E, u, L]
        C = torch.as_tensor(self._C, dtype=x.dtype, device=x.device)
        tmp = _stage1(xr, sh, C)                             # [E, u, M]
        e = x.shape[0]
        Ts, Ws = [], []
        for g, (i_out, n_p, m0, w0, d3, _, mul_o) in enumerate(self._groups):
            T = tmp[..., m0:m0 + n_p * d3].reshape(e, u, n_p, d3)
            Ts.append(T.transpose(1, 2).reshape(e, n_p * u, d3))  # [E, (p,u), m]
            nW = n_p * u * mul_o
            W = ws[g] if ws is not None else weights[..., w0:w0 + nW]
            Ws.append(W.reshape(e, n_p * u, mul_o))           # [E, (p,u), w]
        outs = [None] * len(self.irreps_out)
        if Ts:
            for g, out in zip(self._groups,
                              edge_weighted_contract_grouped(Ts, Ws)):
                outs[g[0]] = out                               # [E, w, m]
        return self._zeros_for_missing(outs, x)

    def _apply_per_path(self, x, sh, weights) -> torch.Tensor:
        """Non-uniform input multiplicities: per-path CG contractions, the
        paths of one output irrep stacked along the input-mul axis, all
        output irreps in one grouped K7 call."""
        xs = split_blocks(x, self.irreps_in)
        groups = {}   # i_out -> ([tmp...], [W...])
        w_off = 0
        e = x.shape[0]
        for p in self.paths:
            off, d2 = self._sh_offsets[p.i_in2]
            C = torch.as_tensor(
                wigner_3j(p.ir_in1.l, p.ir_in2.l, p.ir_out.l),
                dtype=x.dtype, device=x.device)
            nW = p.mul_in1 * p.mul_out
            W = weights[..., w_off:w_off + nW].reshape(e, p.mul_in1, p.mul_out)
            w_off += nW
            tmp = (p.path_weight * self.path_weight_scale) * _stage1(
                xs[p.i_in1], sh[..., off:off + d2], C)
            g = groups.setdefault(p.i_out, ([], []))
            g[0].append(tmp)
            g[1].append(W)
        outs = [None] * len(self.irreps_out)
        if groups:
            got = edge_weighted_contract_grouped(
                [torch.cat(tmps, dim=-2) for tmps, _ in groups.values()],
                [torch.cat(wss, dim=-2) for _, wss in groups.values()])
            for i_out, out in zip(groups, got):
                outs[i_out] = out
        return self._zeros_for_missing(outs, x)


@functools.lru_cache(maxsize=None)
def edge_tensor_product(irreps_in: Irreps, irreps_sh: Irreps,
                        irreps_out: Irreps) -> EdgeTensorProduct:
    return EdgeTensorProduct(irreps_in, irreps_sh, irreps_out)
