"""O(3) algebra of the plain references: irreps, real Wigner 3j tensors,
the tensor-product path tables and the generalised CG (U) tensors of MACE's
symmetric contraction, in numpy, and the edge geometry (real spherical
harmonics, the Bessel basis with its polynomial cutoff) in float64 torch.

A frozen copy of the conventions the measured program states (component
normalisation, the l = 1 basis (y, z, x), e3nn's 'element' path weights),
written out again here so that the reference imports nothing of the
program and takes none of its tables.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, List, Tuple

import numpy as np
import torch


@dataclass(frozen=True, order=True)
class Irrep:
    l: int
    p: int   # +1 even, -1 odd

    @property
    def dim(self) -> int:
        return 2 * self.l + 1

    def __repr__(self) -> str:
        return f"{self.l}{'e' if self.p == 1 else 'o'}"

    def __mul__(self, other: "Irrep"):
        for l in range(abs(self.l - other.l), self.l + other.l + 1):
            yield Irrep(l, self.p * other.p)


Irreps = List[Tuple[int, Irrep]]     # [(multiplicity, irrep)]


def irreps_dim(irreps: Irreps) -> int:
    return sum(mul * ir.dim for mul, ir in irreps)


def sh_irreps(lmax: int) -> Irreps:
    return [(1, Irrep(l, (-1) ** l)) for l in range(lmax + 1)]


@functools.lru_cache(maxsize=None)
def _su2_cg(j1: int, j2: int, j3: int) -> np.ndarray:
    """<j1 m1 j2 m2 | j3 m3> by the Racah formula in exact rationals."""
    f = math.factorial
    C = np.zeros((2 * j1 + 1, 2 * j2 + 1, 2 * j3 + 1))
    if not abs(j1 - j2) <= j3 <= j1 + j2:
        return C
    tri = Fraction((2 * j3 + 1) * f(j3 + j1 - j2) * f(j3 - j1 + j2)
                   * f(j1 + j2 - j3), f(j1 + j2 + j3 + 1))
    for m1 in range(-j1, j1 + 1):
        for m2 in range(-j2, j2 + 1):
            m3 = m1 + m2
            if abs(m3) > j3:
                continue
            norm = tri * (f(j3 + m3) * f(j3 - m3) * f(j1 - m1) * f(j1 + m1)
                          * f(j2 - m2) * f(j2 + m2))
            total = Fraction(0)
            for k in range(0, j1 + j2 - j3 + 1):
                dens = (k, j1 + j2 - j3 - k, j1 - m1 - k, j2 + m2 - k,
                        j3 - j2 + m1 + k, j3 - j1 - m2 + k)
                if min(dens) < 0:
                    continue
                den = 1
                for x in dens:
                    den *= f(x)
                total += Fraction((-1) ** k, den)
            if total:
                C[j1 + m1, j2 + m2, j3 + m3] = math.copysign(
                    math.sqrt(norm * total * total), total)
    return C


@functools.lru_cache(maxsize=None)
def _real_basis(l: int) -> np.ndarray:
    """A_l with Y_real = A_l Y_complex (real m = -l..l)."""
    A = np.zeros((2 * l + 1, 2 * l + 1), dtype=complex)
    A[l, l] = 1.0
    for m in range(1, l + 1):
        A[l + m, l - m] = 1 / math.sqrt(2)
        A[l + m, l + m] = (-1) ** m / math.sqrt(2)
        A[l - m, l - m] = 1j / math.sqrt(2)
        A[l - m, l + m] = -1j * (-1) ** m / math.sqrt(2)
    return A


@functools.lru_cache(maxsize=None)
def wigner_3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis 3j tensor C[m1, m2, m3], unit Frobenius norm, sign fixed
    so that the first entry above half the largest is positive."""
    C = np.einsum("ai,bj,ck,ijk->abc", _real_basis(l1), _real_basis(l2),
                  np.conj(_real_basis(l3)), _su2_cg(l1, l2, l3).astype(complex))
    mx = np.abs(C).max()
    if mx == 0:
        return C.real
    phase = C[np.unravel_index(np.argmax(np.abs(C)), C.shape)] / mx
    cand = np.array([1, -1, 1j, -1j])
    C = (C / cand[np.argmin(np.abs(cand - phase))]).real
    C = C / np.linalg.norm(C.ravel())
    flat = C.ravel()
    if flat[np.abs(flat) > 0.5 * np.abs(flat).max()][0] < 0:
        C = -C
    return C


@dataclass(frozen=True)
class Path:
    i_in1: int
    i_in2: int
    i_out: int
    mul_in1: int
    mul_in2: int
    mul_out: int
    ir_in1: Irrep
    ir_in2: Irrep
    ir_out: Irrep
    weight: float


def tp_paths(in1: Irreps, in2: Irreps, out: Irreps) -> List[Path]:
    """Fully connected paths ('uvw'), sorted by output irrep; path weight
    sqrt(ir_out.dim / fan_in), fan_in summed over the paths of an output."""
    raw = [(i1, i2, io, m1, m2, mo, r1, r2, ro)
           for i1, (m1, r1) in enumerate(in1) for i2, (m2, r2) in enumerate(in2)
           for rr in r1 * r2 for io, (mo, ro) in enumerate(out) if ro == rr]
    fan: Dict[int, int] = {}
    for r in raw:
        fan[r[2]] = fan.get(r[2], 0) + r[3] * r[4]
    paths = [Path(*r, math.sqrt(r[8].dim / fan[r[2]])) for r in raw]
    return sorted(paths, key=lambda p: p.i_out)


def tp_paths_uvu(in1: Irreps, in2: Irreps, target: Irreps
                 ) -> Tuple[Irreps, List[Path]]:
    """MACE's 'uvu' paths: each (in1, in2) pair gives an output slot of
    multiplicity ``mul_in1`` for every allowed irrep of ``target``; the
    slots sorted by irrep (stable); weight sqrt(ir_out.dim / mul_in2)."""
    targets = {ir for _, ir in target}
    raw = [(i1, i2, m1, m2, r1, r2, ro)
           for i1, (m1, r1) in enumerate(in1) for i2, (m2, r2) in enumerate(in2)
           for ro in r1 * r2 if ro in targets]
    order = sorted(range(len(raw)), key=lambda k: (raw[k][6].l, -raw[k][6].p))
    out = [(raw[k][2], raw[k][6]) for k in order]
    slot = {k: s for s, k in enumerate(order)}
    paths = [Path(i1, i2, slot[k], m1, m2, m1, r1, r2, ro,
                  math.sqrt(ro.dim / m2))
             for k, (i1, i2, m1, m2, r1, r2, ro) in enumerate(raw)]
    return out, sorted(paths, key=lambda p: p.i_out)


def _wigner_nj(irreps_list: List[Irreps]):
    """Every coupling tree of the copies in ``irreps_list``: ``[(ir_out,
    E [ir_out.dim, d1, ..., dn])]`` sorted by (l, -p); each step is a 3j
    tensor times sqrt(ir_out.dim)."""
    if len(irreps_list) == 1:
        (irreps,) = irreps_list
        e, i, ret = np.eye(irreps_dim(irreps)), 0, []
        for mul, ir in irreps:
            for _ in range(mul):
                ret.append((ir, e[i:i + ir.dim]))
                i += ir.dim
        return ret
    *left, right = irreps_list
    ret = []
    for ir_left, C_left in _wigner_nj(left):
        i = 0
        for mul, ir in right:
            for ir_out in ir_left * ir:
                C = wigner_3j(ir_out.l, ir_left.l, ir.l) * math.sqrt(ir_out.dim)
                C_full = np.einsum("oLm,L...->o...m", C, C_left)
                for u in range(mul):
                    E = np.zeros((ir_out.dim,) + C_left.shape[1:]
                                 + (irreps_dim(right),))
                    E[..., i + u * ir.dim:i + (u + 1) * ir.dim] = C_full
                    ret.append((ir_out, E))
            i += mul * ir.dim
    return sorted(ret, key=lambda x: (x[0].l, -x[0].p))


@functools.lru_cache(maxsize=None)
def _u_cached(coupling: Tuple[Tuple[int, Irrep], ...], ir_out: Irrep,
              nu: int) -> np.ndarray:
    stack = [E for ir, E in _wigner_nj([list(coupling)] * nu) if ir == ir_out]
    d = irreps_dim(list(coupling))
    if not stack:
        return np.zeros((ir_out.dim,) + (d,) * nu + (0,))
    return np.ascontiguousarray(np.stack(stack, axis=-1))


def u_matrix(coupling: Irreps, ir_out: Irrep, nu: int) -> np.ndarray:
    """U ``[ir_out.dim, d, ..., d, K]`` (the output axis kept for scalars
    too): every coupling path of ``nu`` copies of ``coupling`` to
    ``ir_out``."""
    return _u_cached(tuple(coupling), ir_out, nu)


def coupling_paths(coupling: Irreps, nu: int) -> Dict[Irrep, int]:
    """K of ``u_matrix(coupling, ir, nu)`` for every ir, counted from the
    coupling trees without building them."""
    counts: Dict[Irrep, int] = {}
    for mul, ir in coupling:
        counts[ir] = counts.get(ir, 0) + mul
    for _ in range(nu - 1):
        nxt: Dict[Irrep, int] = {}
        for ir_left, c in counts.items():
            for mul, ir in coupling:
                for ir_out in ir_left * ir:
                    nxt[ir_out] = nxt.get(ir_out, 0) + c * mul
        counts = nxt
    return counts


def safe_norm(x: torch.Tensor) -> torch.Tensor:
    sq = (x * x).sum(-1, keepdim=True)
    pos = sq > 1e-24
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)


def spherical_harmonics(vec: torch.Tensor, lmax: int) -> torch.Tensor:
    """``[E, (lmax+1)^2]`` real harmonics of the unit vectors, component
    normalised (|Y_l|^2 = 2l+1), by Y_l = c_l K_l^T (Y_{l-1} x Y_1)."""
    n = safe_norm(vec)
    u = vec / torch.where(n > 0, n, 1.0)
    y1 = math.sqrt(3.0) * torch.stack([u[:, 1], u[:, 2], u[:, 0]], dim=-1)
    out, prev = [torch.ones_like(u[:, :1]), y1], y1
    for l in range(2, lmax + 1):
        K = np.transpose(wigner_3j(l, l - 1, 1), (1, 2, 0)) * math.sqrt(2 * l + 1)
        raw = torch.einsum("ea,ei,aim->em", prev, y1,
                           torch.as_tensor(K, dtype=vec.dtype, device=vec.device))
        prev = raw * (math.sqrt(2 * l + 1) / safe_norm(raw).clamp_min(1e-300))
        out.append(prev)
    return torch.cat(out, dim=-1)


def bessel_cutoff(r: torch.Tensor, r_max: float, num_basis: int,
                  p: int) -> torch.Tensor:
    """``sqrt(2/r_max) sin(n pi r / r_max) / r`` times the polynomial
    envelope of order ``p`` (zero from r_max on); ``r`` ``[E, 1]``."""
    n = torch.arange(1, num_basis + 1, dtype=r.dtype, device=r.device)
    x = r / r_max
    env = (1.0 - ((p + 1.0) * (p + 2.0) / 2.0) * x ** p
           + p * (p + 2.0) * x ** (p + 1) - (p * (p + 1.0) / 2.0) * x ** (p + 2))
    return (math.sqrt(2.0 / r_max) * torch.sin(n * math.pi * r / r_max) / r
            * env * (r < r_max))


@functools.lru_cache(maxsize=None)
def silu_second_moment() -> float:
    """1 / sqrt(E[silu(x)^2]) for x ~ N(0, 1) (e3nn's normalize2mom),
    by the trapezoid rule in float64 on [-12, 12]."""
    xs = np.linspace(-12, 12, 200001)
    w = np.exp(-0.5 * xs ** 2) / math.sqrt(2 * math.pi)
    ys = xs / (1.0 + np.exp(-xs))
    return float(1.0 / math.sqrt(np.trapezoid(ys ** 2 * w, xs)))
