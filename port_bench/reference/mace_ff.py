"""Plain reference of the ``mace_ff`` configuration: MACE (Batatia et al.
2022, arXiv:2206.07697) as a force field over its residual interaction
blocks, in float32 PyTorch, every contraction a ``torch.matmul`` or
``torch.bmm`` (so ``counts/mace_ff.py`` can count them), sums by
``index_add_``, no kernel, no cache and no batching.

    h0 = W_emb onehot(z)
    per layer: sc  = skip_tp(h, onehot(z))                  (self-connection)
               m_i = linear(sum_{j -> i} uvu(linear_up(h)_j, Y(r_ji), R(|r_ji|)))
                     / avg_num_neighbors
               h   = linear(SymmetricContraction_3(m)) + sc
               E  += sum_i readout(h)_i

Departures from the published model, each shared with the measured
program's configuration: the spherical harmonics go to the hidden L
(the program ties both to ``max_ell``); the symmetric contraction's
U tensors keep every coupling tree (no symmetrisation); its weights are
not element dependent.  The edge geometry (harmonics, radial basis) is
computed in float64 and rounded to float32: it has no parameters.

Parameter names are the measured program's, so one set of drawn weights
loads into both (``load``, strict).  The reference builds its own radius
graph from the positions (``make_graph``), on the device, in float64
distances.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from port_bench.reference import _e3
from port_bench.reference._e3 import Irrep


def init_rule(name: str, shape) -> tuple:
    """(mean, std) of the drawn weight ``name``: N(0, 1) for every e3nn-
    normalised weight (the forward divides by the fan), N(0, 1/K^2) for
    the symmetric contraction's ``[K, c]`` weights."""
    if ".contraction_" in name:
        return 0.0, 1.0 / shape[0]
    return 0.0, 1.0


def _mm_blocks(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[N, u, d] x [u, w] -> [N, w, d]`` as one matmul over (N, d)."""
    n, u, d = x.shape
    y = torch.matmul(x.transpose(1, 2).reshape(n * d, u), w)
    return y.reshape(n, d, -1).transpose(1, 2)


def split(x: torch.Tensor, irreps) -> List[torch.Tensor]:
    out, i = [], 0
    for mul, ir in irreps:
        out.append(x[:, i:i + mul * ir.dim].reshape(-1, mul, ir.dim))
        i += mul * ir.dim
    return out


def merge(blocks: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([b.reshape(b.shape[0], -1) for b in blocks], dim=-1)


class IrrepsLinear(nn.Module):
    """Per output irrep ``sum_i x_i W_i / sqrt(fan)`` over the input blocks
    of that irrep; only the diagonal when both sides list the same irreps
    with one multiplicity each.  Weights ``w{i}_{k}`` ``[mul_in, mul_out]``."""

    def __init__(self, irreps_in, irreps_out):
        super().__init__()
        self.irreps_in, self.irreps_out = irreps_in, irreps_out
        square = ([ir for _, ir in irreps_in] == [ir for _, ir in irreps_out]
                  and len({m for m, _ in irreps_in}) == 1
                  and len({m for m, _ in irreps_out}) == 1)
        self.paths = []
        for ko, (mo, ro) in enumerate(irreps_out):
            kis = [ko] if square else [ki for ki, (_, ri) in enumerate(irreps_in)
                                       if ri == ro]
            for ki in kis:
                self.register_parameter(
                    f"w{ki}_{ko}", nn.Parameter(torch.empty(irreps_in[ki][0], mo)))
            self.paths.append((kis, max(sum(irreps_in[ki][0] for ki in kis), 1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = split(x, self.irreps_in)
        outs = []
        for ko, ((mo, ro), (kis, fan)) in enumerate(zip(self.irreps_out,
                                                        self.paths)):
            y = x.new_zeros(x.shape[0], mo, ro.dim)
            for ki in kis:
                y = y + _mm_blocks(xs[ki], getattr(self, f"w{ki}_{ko}"))
            outs.append(y / math.sqrt(fan))
        return merge(outs)


class RadialMLP(nn.Module):
    """``x = silu(x W_i / sqrt(fan_in)) * c`` per hidden width, no bias,
    the last layer linear; weights ``w{i}``."""

    def __init__(self, dims):
        super().__init__()
        self.n = len(dims) - 1
        for i, (a, b) in enumerate(zip(dims, dims[1:])):
            self.register_parameter(f"w{i}", nn.Parameter(torch.empty(a, b)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            w = getattr(self, f"w{i}")
            x = torch.matmul(x, w) / math.sqrt(w.shape[0])
            if i < self.n - 1:
                x = torch.nn.functional.silu(x) * _e3.silu_second_moment()
        return x


class SkipTP(nn.Module):
    """Fully connected tensor product of the features with the one-hot
    species (a block of scalars): per path ``w{k}`` ``[u, v, w]``;
    ``out[n, w, m] = weight * sum_u (z_n W_k)[u, w] (x_n C)[u, m]`` with
    ``C`` the 3j tensor of (l, 0, l)."""

    def __init__(self, irreps_in, n_species: int, irreps_out):
        super().__init__()
        self.irreps_in, self.irreps_out = irreps_in, irreps_out
        self.paths = _e3.tp_paths(irreps_in, [(n_species, Irrep(0, 1))],
                                  irreps_out)
        for k, p in enumerate(self.paths):
            self.register_parameter(f"w{k}", nn.Parameter(
                torch.empty(p.mul_in1, p.mul_in2, p.mul_out)))
        self.cg = [torch.as_tensor(_e3.wigner_3j(p.ir_in1.l, 0, p.ir_out.l)[:, 0, :],
                                   dtype=torch.float32) for p in self.paths]

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        xs = split(x, self.irreps_in)
        n = x.shape[0]
        outs = [None] * len(self.irreps_out)
        for k, p in enumerate(self.paths):
            w = getattr(self, f"w{k}")
            u, v, wo = w.shape
            zw = torch.matmul(z, w.permute(1, 0, 2).reshape(v, u * wo))
            xc = torch.matmul(xs[p.i_in1].reshape(n * u, -1),
                              self.cg[k].to(x.device)).reshape(n, u, -1)
            y = p.weight * torch.bmm(zw.reshape(n, u, wo).transpose(1, 2), xc)
            outs[p.i_out] = y if outs[p.i_out] is None else outs[p.i_out] + y
        return merge([o if o is not None else x.new_zeros(n, mo, ro.dim)
                      for o, (mo, ro) in zip(outs, self.irreps_out)])


class Interaction(nn.Module):
    """The residual interaction: ``(message [N, c, (lmax + 1)^2], sc)``."""

    def __init__(self, irreps_in, hidden, lmax: int, n_species: int,
                 num_bessel: int, avg: float):
        super().__init__()
        self.irreps_in, self.hidden, self.avg = irreps_in, hidden, avg
        sh = _e3.sh_irreps(lmax)
        self.sh_irreps = sh
        self.tp_out, self.paths = _e3.tp_paths_uvu(irreps_in, sh, hidden)
        self.linear_up = IrrepsLinear(irreps_in, irreps_in)
        self.skip_tp = SkipTP(irreps_in, n_species, hidden)
        self.conv_tp_weights = RadialMLP(
            [num_bessel, 64, 64, 64, sum(p.mul_in1 for p in self.paths)])
        self.linear = IrrepsLinear(self.tp_out, hidden)
        self.cg = [torch.as_tensor(_e3.wigner_3j(p.ir_in1.l, p.ir_in2.l,
                                                 p.ir_out.l), dtype=torch.float32)
                   for p in self.paths]

    def messages(self, nf, sh, feats, s):
        """'uvu' messages of edges ``s``: per path ``K = Y @ C`` ``[E, d1,
        d3]``, then ``bmm(x_sender, K)`` times the path weight and the
        per-edge, per-channel weights of the radial MLP."""
        w = self.conv_tp_weights(feats)
        xs = split(nf[s], self.irreps_in)
        e = w.shape[0]
        offs = np.cumsum([0] + [ir.dim for _, ir in self.sh_irreps])
        outs, wo = [None] * len(self.tp_out), 0
        for k, p in enumerate(self.paths):
            C = self.cg[k].to(nf.device)
            d1, d2, d3 = C.shape
            K = torch.matmul(sh[:, offs[p.i_in2]:offs[p.i_in2 + 1]],
                             C.permute(1, 0, 2).reshape(d2, d1 * d3))
            y = torch.bmm(xs[p.i_in1], K.reshape(e, d1, d3))
            outs[p.i_out] = (p.weight * y) * w[:, wo:wo + p.mul_in1, None]
            wo += p.mul_in1
        return merge(outs)

    def forward(self, h, z, graph, chunk: Optional[int]):
        sc = self.skip_tp(h, z)
        nf = self.linear_up(h)
        s, r = graph["senders"], graph["receivers"]
        acc = nf.new_zeros(nf.shape[0], _e3.irreps_dim(self.tp_out))
        E = s.shape[0]
        step = E if chunk is None else chunk
        for a in range(0, E, step):
            sl = slice(a, min(a + step, E))
            args = (nf, graph["sh"][sl], graph["feats"][sl], s[sl])
            m = (checkpoint(self.messages, *args, use_reentrant=False)
                 if chunk is not None else self.messages(*args))
            acc = acc.index_add(0, r[sl], m)
        msg = self.linear(acc) / self.avg
        return torch.cat(split(msg, self.hidden), dim=-1), sc


class Contraction(nn.Module):
    """The symmetric contraction to each output irrep, the descending-nu
    chain per irrep: ``A_nu = U_nu W_nu``, then ``out = x . A_3``,
    ``out = x . (A_2 + out)``, ``out = x . (A_1 + out)``, each ``x .``
    a ``bmm`` over the channel (nu = 3) or the (node, channel) rows.
    Weights ``contraction_{ir}_w{nu}`` ``[K, c]``."""

    def __init__(self, hidden, correlation: int):
        super().__init__()
        self.coupling = [(1, ir) for _, ir in hidden]
        self.irs = [ir for _, ir in hidden]
        self.correlation = correlation
        self.c = hidden[0][0]
        self.U = {}
        for nu in range(1, correlation + 1):
            for ir in self.irs:
                U = _e3.u_matrix(self.coupling, ir, nu)
                self.U[(ir, nu)] = torch.as_tensor(U, dtype=torch.float32)
                self.register_parameter(f"contraction_{ir}_w{nu}", nn.Parameter(
                    torch.empty(U.shape[-1], self.c)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, d = x.shape
        xc = x.transpose(0, 1)                       # [c, b, d]
        outs = []
        for ir in self.irs:
            out = None
            for nu in range(self.correlation, 0, -1):
                U = self.U[(ir, nu)]
                if U.device != x.device:      # moved once, then kept there
                    U = self.U[(ir, nu)] = U.to(x.device)
                W = getattr(self, f"contraction_{ir}_w{nu}")
                A = torch.matmul(U.reshape(-1, U.shape[-1]), W)   # [(o, j.., i), c]
                A = A.reshape(U.shape[:-1] + (c,))
                if out is None:        # [c, i, (o, j..)]
                    A = A.permute(-1, -2, *range(U.ndim - 2)).reshape(c, d, -1)
                    out = torch.bmm(xc, A).permute(1, 0, 2)      # [b, c, (o j..)]
                else:
                    A = A.permute(-1, *range(U.ndim - 1)).reshape(c, -1)
                    full = (out + A[None]).reshape(b * c, -1, d)
                    out = torch.bmm(full, x.reshape(b * c, d, 1)).reshape(b, c, -1)
            outs.append(out.reshape(b, c * ir.dim))
        return torch.cat(outs, dim=-1)


class Product(nn.Module):
    def __init__(self, hidden, correlation: int):
        super().__init__()
        self.symmetric_contraction = Contraction(hidden, correlation)
        self.linear = IrrepsLinear(hidden, hidden)

    def forward(self, m, sc):
        return self.linear(self.symmetric_contraction(m)) + sc


class MACEForceField(nn.Module):
    def __init__(self, args: dict, avg_num_neighbors: float):
        super().__init__()
        lmax, emb = args["max_ell"], args["emb_dim"]
        self.in_dim, self.r_max = args["in_dim"], args["r_max"]
        self.lmax, self.num_bessel = lmax, args["num_bessel"]
        self.p = args["num_polynomial_cutoff"]
        hidden = [(emb, Irrep(l, (-1) ** l)) for l in range(lmax + 1)]
        scalars = [(emb, Irrep(0, 1))]
        self.node_embedding = IrrepsLinear([(self.in_dim, Irrep(0, 1))], scalars)
        self.interactions = nn.ModuleList(
            Interaction(scalars if i == 0 else hidden, hidden, lmax, self.in_dim,
                        self.num_bessel, avg_num_neighbors)
            for i in range(args["num_layers"]))
        self.products = nn.ModuleList(Product(hidden, args["correlation"])
                                      for _ in range(args["num_layers"]))
        self.readouts = nn.ModuleList(IrrepsLinear(hidden, [(1, Irrep(0, 1))])
                                      for _ in range(args["num_layers"]))

    def geometry(self, pos: torch.Tensor, graph: dict) -> None:
        """Adds ``sh`` and ``feats`` (float32, from float64) to ``graph``."""
        vec = (pos[graph["senders"]].double() - pos[graph["receivers"]].double())
        r = _e3.safe_norm(vec)
        graph["sh"] = _e3.spherical_harmonics(vec, self.lmax).float()
        graph["feats"] = _e3.bessel_cutoff(r, self.r_max, self.num_bessel,
                                           self.p).float()

    def forward(self, graph: dict, edge_chunk: Optional[int] = None,
                node_chunk: Optional[int] = None) -> torch.Tensor:
        z = torch.nn.functional.one_hot(graph["atoms"].long(),
                                        self.in_dim).float()
        h = self.node_embedding(z)
        atoms_e = None
        for inter, prod, read in zip(self.interactions, self.products,
                                     self.readouts):
            m, sc = inter(h, z, graph, edge_chunk)
            h = _rows(prod, node_chunk, m, sc)
            e = read(h)[:, 0]
            atoms_e = e if atoms_e is None else atoms_e + e
        return atoms_e


def _rows(fn, chunk: Optional[int], *xs):
    """``fn(*xs)`` on row blocks under checkpoint (rows independent)."""
    n = xs[0].shape[0]
    if chunk is None or n <= chunk:
        return fn(*xs)
    return torch.cat([checkpoint(fn, *(x[a:a + chunk] for x in xs),
                                 use_reentrant=False)
                      for a in range(0, n, chunk)])


def build(args: dict, graph: dict) -> MACEForceField:
    """The reference model; ``avg_num_neighbors`` is the graph's mean
    degree, as the configuration runs it."""
    n = graph["atoms"].shape[0]
    return MACEForceField(args, graph["senders"].shape[0] / n)


def make_graph(pos: torch.Tensor, atoms: torch.Tensor, cutoff: float,
               triplets: bool = False) -> Dict[str, torch.Tensor]:
    from port_bench.reference._graph import radius_graph
    s, r = radius_graph(pos, cutoff)
    return {"atoms": atoms, "pos": pos, "senders": s, "receivers": r}


def atom_energies(model: MACEForceField, graph: dict,
                  chunks: bool) -> torch.Tensor:
    """The atoms' energies ``[N]`` (the frame's is their sum); ``chunks``:
    edge and node blocks under checkpoint, so that the full-size frame
    fits."""
    if "sh" not in graph:
        model.geometry(graph["pos"], graph)
    return model(graph, 32768 if chunks else None, 2048 if chunks else None)
