"""Plain reference of the ``dimenet_pp`` configuration: DimeNet++
(Gasteiger et al. 2020, arXiv:2011.14115) in float32 PyTorch, every
product an ``nn.Linear``, every sum an ``index_add_``, no kernel, no
checkpoint and no batching.

    rbf_ji  = env(d/c) sin(freq (d/c))                      (trainable freq)
    sbf_kji = n_lk j_l(z_lk d_kj / c) Y_l0(angle_kji)
    x_ji    = silu(W [h(z_i), h(z_j), silu(W rbf_ji)])
    per block: x_ji <- post(silu(W x_ji) + silu(W_up sum_k silu(W_down
               (silu(W x_kj) * W W rbf_kj))[kj] * W W sbf_kji), x_ji)
    per output block: P_i += MLP(W_up sum_j (W rbf_ji) * x_ji)
    E = sum_i P_i

As in the measured program (and the fork it follows), the triplet angle
is taken at node i, between (j - i) and (k - i).  The bases have no
parameters and are computed in float64, then rounded to float32; the
Bessel zeros by bisection in numpy.  Parameter names are the measured
program's, so one set of drawn weights loads into both.
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

SQRT3 = math.sqrt(3.0)


def init_rule(name: str, shape) -> tuple:
    """(mean, std): Glorot-scaled normal weights, biases N(0, 0.1^2), the
    stored embedding table N(sqrt 3, 1) (read back shifted by -sqrt 3), the
    radial frequencies at n pi (std 0)."""
    if name == "rbf.freq":
        return torch.arange(1, shape[0] + 1, dtype=torch.float32) * math.pi, 0.0
    if name.endswith("emb.emb.weight"):
        return SQRT3, 1.0
    if name.endswith(".bias"):
        return 0.0, 0.1
    return 0.0, math.sqrt(2.0 / (shape[0] + shape[1]))


def _poly_sub(a, b):
    n = max(len(a), len(b))
    return np.pad(a, (0, n - len(a))) - np.pad(b, (0, n - len(b)))


@functools.lru_cache(maxsize=None)
def _jl_poly(l: int):
    """s_l, c_l (ascending in x^2): j_l = (s_l sin x + x c_l cos x) / x^(l+1)."""
    s, c = [np.array([1.0]), np.array([1.0])], [np.array([0.0]), np.array([-1.0])]
    for k in range(2, l + 1):
        s.append(_poly_sub((2 * k - 1) * s[k - 1], np.concatenate([[0.0], s[k - 2]])))
        c.append(_poly_sub((2 * k - 1) * c[k - 1], np.concatenate([[0.0], c[k - 2]])))
    return s[l], c[l]


def _jl_np(l: int, x: float) -> float:
    s, c = _jl_poly(l)
    u = x * x
    return (np.polyval(s[::-1], u) * math.sin(x)
            + x * np.polyval(c[::-1], u) * math.cos(x)) / x ** (l + 1)


@functools.lru_cache(maxsize=None)
def bessel_zeros(ns: int, nr: int):
    """The first ``nr`` zeros of j_l, l < ns, by bisection between the
    interlaced zeros of j_{l-1}."""
    zeros = [list(np.arange(1, nr + ns) * math.pi)]
    for l in range(1, ns):
        prev, cur = zeros[-1], []
        for a, b in zip(prev, prev[1:]):
            fa = _jl_np(l, a)
            for _ in range(200):
                m = 0.5 * (a + b)
                fm = _jl_np(l, m)
                if (fm < 0) == (fa < 0):
                    a, fa = m, fm
                else:
                    b = m
            cur.append(0.5 * (a + b))
        zeros.append(cur)
    return [z[:nr] for z in zeros]


def _jl(l: int, x: torch.Tensor) -> torch.Tensor:
    """j_l in float64: the closed form above min(1 + 0.8 l, 6), the
    ascending series (20 terms) below it."""
    small = x < min(1.0 + 0.8 * l, 6.0)
    xs = torch.where(small, 1.0, x)
    s, c = _jl_poly(l)
    u = xs * xs
    ps = sum(float(a) * u ** i for i, a in enumerate(s))
    pc = sum(float(a) * u ** i for i, a in enumerate(c))
    closed = (ps * torch.sin(xs) + xs * pc * torch.cos(xs)) / xs ** (l + 1)
    term, acc = torch.ones_like(x), torch.ones_like(x)
    for k in range(1, 20):
        term = term * (-x * x) / (2 * k * (2 * l + 2 * k + 1))
        acc = acc + term
    series = x ** l / float(np.prod(np.arange(2 * l + 1, 0, -2))) * acc
    return torch.where(small, series, closed)


def sbf(dist_kj: torch.Tensor, angle: torch.Tensor, ns: int, nr: int,
        cutoff: float) -> torch.Tensor:
    """``[T, ns*nr]``, column l*nr + k: n_lk j_l(z_lk d / c) sqrt((2l+1)/4pi)
    P_l(cos angle), float64."""
    z = bessel_zeros(ns, nr)
    cos = torch.cos(angle)
    P = [torch.ones_like(cos), cos]
    for l in range(2, ns):
        P.append(((2 * l - 1) * cos * P[l - 1] - (l - 1) * P[l - 2]) / l)
    cols = []
    for l in range(ns):
        pref = math.sqrt((2 * l + 1) / (4 * math.pi))
        for k in range(nr):
            norm = 1.0 / math.sqrt(0.5 * _jl_np(l + 1, z[l][k]) ** 2)
            cols.append(norm * _jl(l, z[l][k] * dist_kj / cutoff) * pref * P[l])
    return torch.stack(cols, dim=-1)


class DistEmb(nn.Module):
    def __init__(self, nr: int, cutoff: float, exponent: int):
        super().__init__()
        self.cutoff, self.p = cutoff, exponent + 1
        self.freq = nn.Parameter(torch.empty(nr))

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        x = (dist / self.cutoff)[:, None]
        p = self.p
        env = (1.0 / x - (p + 1) * (p + 2) / 2.0 * x ** (p - 1)
               + p * (p + 2.0) * x ** p - p * (p + 1) / 2.0 * x ** (p + 1)) * (x < 1)
        return env.float() * torch.sin(self.freq * x.float())


class Residual(nn.Module):
    def __init__(self, h: int):
        super().__init__()
        self.lin1, self.lin2 = nn.Linear(h, h), nn.Linear(h, h)

    def forward(self, x):
        return x + F.silu(self.lin2(F.silu(self.lin1(x))))


class Emb(nn.Module):
    def __init__(self, nr: int, h: int):
        super().__init__()
        self.emb = nn.Embedding(95, h)
        self.lin_rbf = nn.Linear(nr, h)
        self.lin = nn.Linear(3 * h, h)

    def forward(self, atoms, rbf, s, r):
        x = self.emb(atoms) - SQRT3
        return F.silu(self.lin(torch.cat([x[r], x[s], F.silu(self.lin_rbf(rbf))], -1)))


class Interaction(nn.Module):
    def __init__(self, h, i, b, ns, nr, before, after):
        super().__init__()
        self.lin_ji, self.lin_kj = nn.Linear(h, h), nn.Linear(h, h)
        self.lin_rbf1 = nn.Linear(nr, b, bias=False)
        self.lin_rbf2 = nn.Linear(b, h, bias=False)
        self.lin_down = nn.Linear(h, i, bias=False)
        self.lin_sbf1 = nn.Linear(ns * nr, b, bias=False)
        self.lin_sbf2 = nn.Linear(b, i, bias=False)
        self.lin_up = nn.Linear(i, h, bias=False)
        self.before_skip = nn.ModuleList(Residual(h) for _ in range(before))
        self.lin = nn.Linear(h, h)
        self.after_skip = nn.ModuleList(Residual(h) for _ in range(after))

    def forward(self, x, rbf, g):
        x_ji = F.silu(self.lin_ji(x))
        x_kj = F.silu(self.lin_down(F.silu(self.lin_kj(x))
                                    * self.lin_rbf2(self.lin_rbf1(rbf))))
        rows = x_kj[g["idx_kj"]] * self.lin_sbf2(self.lin_sbf1(g["sbf"]))
        folded = rows.new_zeros(x.shape[0], rows.shape[1]).index_add(
            0, g["idx_ji"], rows)
        h = x_ji + F.silu(self.lin_up(folded))
        for layer in self.before_skip:
            h = layer(h)
        h = F.silu(self.lin(h)) + x
        for layer in self.after_skip:
            h = layer(h)
        return h


class Output(nn.Module):
    def __init__(self, nr, h, o, out_dim, n_layers):
        super().__init__()
        self.lin_rbf = nn.Linear(nr, h, bias=False)
        self.lin_up = nn.Linear(h, o, bias=False)
        self.lins = nn.ModuleList(nn.Linear(o, o) for _ in range(n_layers))
        self.lin = nn.Linear(o, out_dim, bias=False)

    def forward(self, x, rbf, r, n):
        gated = self.lin_rbf(rbf) * x
        x = self.lin_up(gated.new_zeros(n, gated.shape[1]).index_add(0, r, gated))
        for lin in self.lins:
            x = F.silu(lin(x))
        return self.lin(x)


class DimeNetPP(nn.Module):
    def __init__(self, a: dict):
        super().__init__()
        h, nr, ns = a["hidden_channels"], a["num_radial"], a["num_spherical"]
        self.ns, self.nr, self.cutoff = ns, nr, a["cutoff"]
        self.rbf = DistEmb(nr, a["cutoff"], a["envelope_exponent"])
        self.emb = Emb(nr, h)
        self.outputs = nn.ModuleList(
            Output(nr, h, a["out_emb_channels"], a["out_dim"],
                   a["num_output_layers"]) for _ in range(a["num_layers"] + 1))
        self.interactions = nn.ModuleList(
            Interaction(h, a["int_emb_size"], a["basis_emb_size"], ns, nr,
                        a["num_before_skip"], a["num_after_skip"])
            for _ in range(a["num_layers"]))

    def forward(self, g: dict) -> torch.Tensor:
        s, r, n = g["senders"], g["receivers"], g["atoms"].shape[0]
        rbf = self.rbf(g["dist"])
        x = self.emb(g["atoms"].long(), rbf, s, r)
        P = self.outputs[0](x, rbf, r, n)
        for inter, out in zip(self.interactions, self.outputs[1:]):
            x = inter(x, rbf, g)
            P = P + out(x, rbf, r, n)
        return P[:, 0]


def build(args: dict, graph: dict) -> DimeNetPP:
    return DimeNetPP(args)


def make_graph(pos: torch.Tensor, atoms: torch.Tensor, cutoff: float,
               triplets: bool = True) -> Dict[str, torch.Tensor]:
    from port_bench.reference._graph import radius_graph, triplets as make_triplets
    s, r = radius_graph(pos, cutoff)
    i, j, k, kj, ji = make_triplets(s, r, pos.shape[0])
    return {"atoms": atoms, "pos": pos, "senders": s, "receivers": r,
            "idx_i": i, "idx_j": j, "idx_k": k, "idx_kj": kj, "idx_ji": ji}


def atom_energies(model: DimeNetPP, g: dict, chunks: bool) -> torch.Tensor:
    """The atoms' energies ``[N]`` (the frame's is their sum).  The geometry (distances, the triplet basis)
    is made once per graph, in float64; ``chunks`` is unused: the frame
    fits whole."""
    if "sbf" not in g:
        p = g["pos"].double()
        d = (p[g["receivers"]] - p[g["senders"]]).norm(dim=-1)
        pji = p[g["idx_j"]] - p[g["idx_i"]]
        pki = p[g["idx_k"]] - p[g["idx_i"]]
        angle = torch.atan2(torch.linalg.cross(pji, pki, dim=-1).norm(dim=-1),
                            (pji * pki).sum(-1))
        g["dist"] = d
        g["sbf"] = sbf(d[g["idx_kj"]], angle, model.ns, model.nr,
                       model.cutoff).float()
    return model(g)
