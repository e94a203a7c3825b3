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

``EdgeTensorProductUVU`` is the 'uvu' product of MACE's force-field
convolutions: one weight per path and channel, O(E * paths * mul) weights
in place of the fully connected O(E * paths * mul^2).  Its four forms
(combined CG, per-path broadcast, (l1, l2)-pair groups, per path) are twins
of one function; ``apply`` picks one by the edge count and ``grouping`` as
the JAX package does.  None of them is a kernel in the JAX package, so all
four are PyTorch products and elementwise operations here.
``FullyConnectedTensorProduct`` (shared weights, e3nn's
``internal_weights=True``) is the interaction blocks' self-connection; with
``node_chunk`` it runs row blocks under ``torch.utils.checkpoint``.

``precision`` (the JAX package's ``tp_precision``) is the precision of
stage 1's products and of every product of the 'uvu' forms
(``precision.py``; None: the process default).  Stage 2 is K7 on the card,
which computes with f32 FMAs whatever the precision.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import precision as prec
from ..irreps import Irreps, tp_paths, tp_paths_uvu, wigner_3j
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


def _stage1(x: torch.Tensor, sh: torch.Tensor, C: torch.Tensor,
            precision: Optional[str] = None) -> torch.Tensor:
    """``tmp[e,u,m] = sum_ab x[e,u,a] sh[e,b] C[a,b,m]``: the per-edge CG
    matrix ``sh @ C`` ``[E, a, m]``, then one batched product, both at
    ``precision``."""
    L, S, M = C.shape
    lead = x.shape[:-2]
    xf = x.reshape((-1,) + x.shape[-2:])
    Ce = prec.matmul(sh.reshape(-1, S), C.permute(1, 0, 2).reshape(S, L * M),
                     precision, "tp")
    return prec.bmm(xf, Ce.reshape(-1, L, M), precision, "tp").reshape(
        lead + (x.shape[-2], M))


def _merge_outs(outs, irreps_out: Irreps, x: torch.Tensor) -> torch.Tensor:
    """Per-output-irrep blocks ``[..., mul, 2l+1]`` (None: no path feeds
    it, zeros) merged into the flat ``[..., irreps_out.dim]`` layout."""
    for k, (mul, ir) in enumerate(irreps_out):
        if outs[k] is None:
            outs[k] = x.new_zeros(x.shape[:-1] + (mul, ir.dim))
    return merge_blocks(outs)


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

    def _apply_combined(self, x, sh, weights, ws=None) -> torch.Tensor:
        """Stage 1 over the combined CG constant, then the contractions of
        all output irreps over their contiguous k = (path, u) axes in one
        grouped K7 call."""
        u = self._uniform_mul
        xr = _to_channel_layout(x, self.irreps_in)            # [E, u, L]
        C = torch.as_tensor(self._C, dtype=x.dtype, device=x.device)
        tmp = _stage1(xr, sh, C, self.precision)             # [E, u, M]
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
        return _merge_outs(outs, self.irreps_out, x)

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
                xs[p.i_in1], sh[..., off:off + d2], C, self.precision)
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
        return _merge_outs(outs, self.irreps_out, x)


@functools.lru_cache(maxsize=None)
def edge_tensor_product(irreps_in: Irreps, irreps_sh: Irreps,
                        irreps_out: Irreps) -> EdgeTensorProduct:
    return EdgeTensorProduct(irreps_in, irreps_sh, irreps_out)


def node_blocks(fn, chunk: int, *xs: Optional[torch.Tensor]) -> torch.Tensor:
    """``fn(*xs)`` over row blocks of ``chunk`` rows, each block under
    ``torch.utils.checkpoint`` (its intermediates are recomputed in the
    backward, so one block's are alive at a time).  The inputs (None passes
    through) are zero-padded to whole blocks, as the JAX package pads its
    scan, and the result is cut back to the rows given."""
    n = xs[0].shape[0]
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n

    def pad_to(x):
        if x is None or not pad:
            return x
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    xs = [pad_to(x) for x in xs]
    outs = [checkpoint(fn, *(None if x is None else x[k * chunk:(k + 1) * chunk]
                             for x in xs),
                       use_reentrant=False, preserve_rng_state=False)
            for k in range(n_chunks)]
    return torch.cat(outs)[:n]


class _Constants:
    """Float32 numpy constants as tensors of a given type and device, made
    once per (name, dtype, device), outside inference mode: one made under
    ``Predictor``'s ``torch.inference_mode`` could not be saved for a later
    training step's backward."""

    def __init__(self):
        self._arrays, self._tensors = {}, {}

    def add(self, name, array: np.ndarray) -> None:
        self._arrays[name] = np.asarray(array, np.float32)

    def get(self, name, like: torch.Tensor) -> torch.Tensor:
        key = (name, like.dtype, like.device)
        if key not in self._tensors:
            with torch.inference_mode(False):
                self._tensors[key] = torch.as_tensor(
                    self._arrays[name], dtype=like.dtype, device=like.device)
        return self._tensors[key]


class EdgeTensorProductUVU:
    """'uvu' edge tensor product with per-edge weights: the ``conv_tp`` of
    MACE's interaction blocks (e3nn ``o3.TensorProduct`` with
    ``tp_out_irreps_with_instructions``).  No parameters.

    Weights ``[E, weight_numel]``: per path ``mul_in1`` weights, in path
    order.  Output: the unsimplified, sorted ``irreps_out`` of
    ``irreps.tp_paths_uvu``, one slot per path.

    ``apply`` takes the combined form up to ``COMBINED_MAX_EDGES`` edges (a
    dense CG constant: few, large products, for small batches), and above
    it the form ``grouping`` names (``LARGE_GROUPING`` by default):
    ``"bcast"`` (per path, the CG contraction as an elementwise product and
    a short sum), ``"pair"`` (one product per (l1, l2) pair, all its l3
    outputs) or anything else per path; non-uniform input multiplicities
    always take the per-path form.  ``precision``: every product of the
    four forms runs at it (``precision.py``; the elementwise products of
    the broadcast form are exact f32 in any case)."""

    COMBINED_MAX_EDGES = 4096
    LARGE_GROUPING = "bcast"

    def __init__(self, irreps_in: Irreps, irreps_sh: Irreps, target: Irreps,
                 precision: Optional[str] = None,
                 grouping: Optional[str] = None):
        self.precision = precision
        self.irreps_in = Irreps(irreps_in)
        self.irreps_sh = Irreps(irreps_sh)
        self.irreps_out, paths = tp_paths_uvu(self.irreps_in, self.irreps_sh,
                                              Irreps(target))
        if not all(p.mul_in2 == 1 for p in paths):
            raise ValueError("EdgeTensorProductUVU: SH multiplicity must be 1")
        # each path owns its output slot: in slot order the combined CG's M
        # axis is the merged output layout
        self.paths = sorted(paths, key=lambda p: p.i_out)
        self.weight_numel = sum(p.mul_in1 for p in self.paths)
        self.grouping = self.LARGE_GROUPING if grouping is None else grouping
        self._sh_offsets, ix = [], 0
        for mul, ir in self.irreps_sh:
            self._sh_offsets.append((ix, ir.dim))
            ix += mul * ir.dim
        self._w_offsets = [int(o) for o in np.cumsum(
            [0] + [p.mul_in1 for p in self.paths])[:-1]]
        self._const = _Constants()
        for k, p in enumerate(self.paths):
            self._const.add(("w3j", k),
                            wigner_3j(p.ir_in1.l, p.ir_in2.l, p.ir_out.l))
        muls = {mul for mul, _ in self.irreps_in}
        self._uniform_mul = muls.pop() if len(muls) == 1 else None
        if self._uniform_mul is None:
            return
        self._const.add("C", _combined_cg(self.paths, self.irreps_in,
                                          self.irreps_sh))
        self._d3 = [p.ir_out.dim for p in self.paths]
        # (l1, l2) pairs: every l3 output of one operand pair in one product
        by_pair = {}
        for k, p in enumerate(self.paths):
            by_pair.setdefault((p.i_in1, p.i_in2), []).append(k)
        self._pair_groups = []
        for g, ((i1, i2), pids) in enumerate(by_pair.items()):
            d1 = self.irreps_in[i1][1].dim
            d2 = self.irreps_sh[i2][1].dim
            d3s = [self.paths[k].ir_out.dim for k in pids]
            Cg = np.zeros((d1, d2, sum(d3s)), dtype=np.float32)
            m = 0
            for k in pids:
                p = self.paths[k]
                Cg[:, :, m:m + p.ir_out.dim] = p.path_weight * wigner_3j(
                    p.ir_in1.l, p.ir_in2.l, p.ir_out.l)
                m += p.ir_out.dim
            self._const.add(("pair", g), Cg)
            self._pair_groups.append((i1, i2, pids, d3s,
                                      [self._w_offsets[k] for k in pids]))

    def apply(self, x: torch.Tensor, sh: torch.Tensor,
              weights: torch.Tensor) -> torch.Tensor:
        """x ``[E, irreps_in.dim]``, sh ``[E, irreps_sh.dim]``, weights
        ``[E, weight_numel]``; returns ``[E, irreps_out.dim]``."""
        large = x.shape[0] > self.COMBINED_MAX_EDGES
        if self._uniform_mul is not None and not large:
            return self._apply_combined(x, sh, weights)
        if self._uniform_mul is not None and self.grouping == "bcast":
            return self._apply_bcast(x, sh, weights)
        if self._uniform_mul is not None and self.grouping == "pair":
            return self._apply_pair_grouped(x, sh, weights)
        return self._apply_per_path(x, sh, weights)

    def _path_inputs(self, k: int, xs, sh: torch.Tensor,
                     weights: torch.Tensor):
        """Path ``k``'s input block ``[E, u, d1]``, SH block ``[E, d2]``, CG
        ``[d1, d2, d3]`` and weights ``[E, u]``."""
        p = self.paths[k]
        off, d2 = self._sh_offsets[p.i_in2]
        w0 = self._w_offsets[k]
        return (xs[p.i_in1], sh[..., off:off + d2],
                self._const.get(("w3j", k), sh),
                weights[..., w0:w0 + p.mul_in1])

    def _apply_bcast(self, x, sh, weights) -> torch.Tensor:
        """Per path: the per-edge CG matrix ``K = sh . w3j`` ``[E, d1, d3]``,
        then ``y = sum_a x[e, u, a] K[e, a, m]`` as an elementwise product
        and a sum over the short ``d1`` axis, times the path weight and the
        per-edge weights."""
        xs = split_blocks(x, self.irreps_in)
        outs = [None] * len(self.irreps_out)
        for k, p in enumerate(self.paths):
            xin, sh_blk, C, W = self._path_inputs(k, xs, sh, weights)
            d1, d2, d3 = C.shape
            K = prec.matmul(sh_blk, C.permute(1, 0, 2).reshape(d2, d1 * d3),
                            self.precision, "tp").reshape(
                sh_blk.shape[0], d1, d3)
            y = (xin[..., :, :, None] * K[..., None, :, :]).sum(-2)
            y = p.path_weight * y * W[..., None]
            outs[p.i_out] = y if outs[p.i_out] is None else outs[p.i_out] + y
        return _merge_outs(outs, self.irreps_out, x)

    def _apply_combined(self, x, sh, weights) -> torch.Tensor:
        """One product over the combined CG constant ``[E, u, M]``, then each
        slot's ``[E, u, d3]`` times its path's per-edge weights (a broadcast
        product: its backward is a sum, not a scatter of repeats)."""
        u = self._uniform_mul
        e, P = x.shape[0], len(self.paths)
        xr = _to_channel_layout(x, self.irreps_in)            # [E, u, L]
        tmp = _stage1(xr, sh, self._const.get("C", x),
                      self.precision)                         # [E, u, M]
        W = weights.reshape(e, P, u)
        return merge_blocks([blk * W[:, k, :, None] for k, blk in
                             enumerate(torch.split(tmp, self._d3, dim=-1))])

    def _apply_pair_grouped(self, x, sh, weights) -> torch.Tensor:
        """One product per (l1, l2) pair over all its l3 outputs, then each
        output's block times its path's per-edge weights."""
        u = self._uniform_mul
        xs = split_blocks(x, self.irreps_in)
        outs = [None] * len(self.irreps_out)
        for g, (i1, i2, pids, d3s, woffs) in enumerate(self._pair_groups):
            off, d2 = self._sh_offsets[i2]
            tmp = _stage1(xs[i1], sh[..., off:off + d2],
                          self._const.get(("pair", g), x),
                          self.precision)                     # [E, u, M_g]
            for k, o, blk in zip(pids, woffs, torch.split(tmp, d3s, dim=-1)):
                yk = blk * weights[..., o:o + u, None]
                slot = self.paths[k].i_out
                outs[slot] = yk if outs[slot] is None else outs[slot] + yk
        return _merge_outs(outs, self.irreps_out, x)

    def _apply_per_path(self, x, sh, weights) -> torch.Tensor:
        xs = split_blocks(x, self.irreps_in)
        outs = [None] * len(self.irreps_out)
        for k, p in enumerate(self.paths):
            xin, sh_blk, C, W = self._path_inputs(k, xs, sh, weights)
            y = p.path_weight * (_stage1(xin, sh_blk, C, self.precision)
                                 * W[..., None])
            outs[p.i_out] = y if outs[p.i_out] is None else outs[p.i_out] + y
        return _merge_outs(outs, self.irreps_out, x)


class FullyConnectedTensorProduct(nn.Module):
    """Fully connected tensor product with shared weights (e3nn
    ``o3.FullyConnectedTensorProduct``, ``internal_weights=True``): the
    interaction blocks' ``skip_tp``, with ``x2`` the one-hot species.
    ``forward(x1 [N, irreps_in1.dim], x2 [N, irreps_in2.dim])`` returns
    ``[N, irreps_out.dim]``.

    Parameters ``w{k}`` ``[mul_in1, mul_in2, mul_out]`` per path (paths
    sorted by output irrep), drawn from N(0, 1), the flax names.  When
    ``x2`` is one block of even scalars and ``x1`` of one multiplicity (the
    models' only use), the CG collapses to the identity on the ``x2`` side
    and every output irrep is one batched product
    (``_scalar_in2_combined``); otherwise a product per path
    (``_per_path``).  ``node_chunk``: row blocks of that many nodes under
    ``torch.utils.checkpoint`` (``node_blocks``)."""

    def __init__(self, irreps_in1: Irreps, irreps_in2: Irreps,
                 irreps_out: Irreps, node_chunk: Optional[int] = None, *,
                 generator: torch.Generator):
        super().__init__()
        self.irreps_in1 = in1 = Irreps(irreps_in1)
        self.irreps_in2 = in2 = Irreps(irreps_in2)
        self.irreps_out = out = Irreps(irreps_out)
        self.node_chunk = node_chunk
        self.paths = sorted(tp_paths(in1, in2, out), key=lambda p: p.i_out)
        for k, p in enumerate(self.paths):
            w = torch.empty(p.mul_in1, p.mul_in2, p.mul_out)
            with torch.no_grad():
                w.normal_(0.0, 1.0, generator=generator)
            setattr(self, f"w{k}", nn.Parameter(w))
        self._const = _Constants()
        scalar_in2 = all(ir.l == 0 and ir.p == 1 for _, ir in in2)
        self.combined = (scalar_in2 and len({mul for mul, _ in in1}) == 1
                         and len(in2) == 1)
        if self.combined:
            self._const.add("C", _combined_cg(self.paths, in1,
                                              Irreps("1x0e"))[:, 0, :])
            self._m_offsets = [int(o) for o in np.cumsum(
                [0] + [p.ir_out.dim for p in self.paths])[:-1]]
        else:
            for k, p in enumerate(self.paths):
                self._const.add(("w3j", k),
                                wigner_3j(p.ir_in1.l, p.ir_in2.l, p.ir_out.l))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        C = self.node_chunk
        if C is None or x1.shape[0] <= C:
            return self._full(x1, x2)
        return node_blocks(self._full, C, x1, x2)

    def _full(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if self.combined:
            return self._scalar_in2_combined(x1, x2)
        return self._per_path(x1, x2)

    def _scalar_in2_combined(self, x1, x2) -> torch.Tensor:
        """``x2`` ``[N, v]`` scalars: the combined CG over ``x1`` alone (the
        scalar side's CG is 1), then per output irrep one batched product
        over ``k = (path, u)`` with the weights folded over ``v``."""
        u, n = self.irreps_in1[0][0], x1.shape[0]
        v = self.irreps_in2[0][0]
        xr = _to_channel_layout(x1, self.irreps_in1)          # [N, u, L]
        tmp = prec.matmul(xr, self._const.get("C", x1),
                          site="skip_tp")                     # [N, u, M]
        outs = [None] * len(self.irreps_out)
        for i_out, (mul_o, ir_o) in enumerate(self.irreps_out):
            pids = [k for k, p in enumerate(self.paths) if p.i_out == i_out]
            if not pids:
                continue
            d3, n_p = ir_o.dim, len(pids)
            T = torch.stack([tmp[..., self._m_offsets[k]:self._m_offsets[k] + d3]
                             for k in pids], dim=-2)          # [N, u, P, d3]
            T = T.transpose(-3, -2).reshape(n, n_p * u, d3)   # [N, (p,u), d3]
            W = torch.stack([getattr(self, f"w{k}") for k in pids])  # [P,u,v,w]
            Wx = prec.matmul(x2, W.permute(2, 0, 1, 3).reshape(
                v, n_p * u * mul_o), site="skip_tp").reshape(
                    n, n_p * u, mul_o)                        # [N, (p,u), w]
            outs[i_out] = prec.bmm(Wx.transpose(1, 2), T,
                                   site="skip_tp")            # [N, w, d3]
        return _merge_outs(outs, self.irreps_out, x1)

    def _per_path(self, x1, x2) -> torch.Tensor:
        xs1 = split_blocks(x1, self.irreps_in1)
        xs2 = split_blocks(x2, self.irreps_in2)
        outs = [None] * len(self.irreps_out)
        for k, p in enumerate(self.paths):
            y = p.path_weight * prec.einsum(
                "nua,nvb,abm,uvw->nwm", xs1[p.i_in1], xs2[p.i_in2],
                self._const.get(("w3j", k), x1), getattr(self, f"w{k}"),
                site="skip_tp")
            outs[p.i_out] = y if outs[p.i_out] is None else outs[p.i_out] + y
        return _merge_outs(outs, self.irreps_out, x1)
