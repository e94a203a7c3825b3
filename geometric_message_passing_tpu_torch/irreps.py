"""O(3) irreducible-representation algebra (port of the JAX package's
``irreps.py``): numpy only, computed once on the host and folded into the
models as constants.

The port keeps its own copy, as it imports nothing of the JAX package:
``Irrep``/``Irreps``, the real-basis Wigner 3j tensors, the Wigner D
matrices of real irreps (for the equivariance tests) and the fully connected
tensor product's path table (``tp_paths``) and the generalised CG (U)
matrices of MACE's symmetric contraction (``u_matrix_real``) with their
opt-in disk cache (``set_disk_cache``).  MACE's 'uvu' paths
(``tp_paths_uvu``) wait for the force-field slice.

Conventions, as in the JAX package:
  * Real irreps of O(3) indexed by (l, p) with p in {+1, -1}, written "0e", "1o", ...
  * The l=1 basis is (y, z, x) so that real spherical harmonics follow the
    standard m = -l..l ordering.
  * Wigner-3j tensors are normalized to unit Frobenius norm ("component"
    normalization): sum_{m1,m2} C[m1,m2,m3] C[m1,m2,m3'] = delta / (2l3+1).
"""

from __future__ import annotations

import functools
import math
import os
import tempfile
from dataclasses import dataclass
from fractions import Fraction
from typing import Iterator, List, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "Irrep",
    "Irreps",
    "TPPath",
    "irrep_rep",
    "irreps_rep",
    "set_disk_cache",
    "sh_basis_change_matrix",
    "tp_paths",
    "u_matrix_real",
    "wigner_3j",
    "wigner_D_from_matrix",
]


# ---------------------------------------------------------------------------
# Irrep / Irreps
# ---------------------------------------------------------------------------


@dataclass(frozen=True, order=True)
class Irrep:
    """A single irreducible representation of O(3): degree ``l`` and parity ``p``."""

    l: int
    p: int  # +1 (even, "e") or -1 (odd, "o")

    def __post_init__(self):
        if self.l < 0 or self.p not in (1, -1):
            raise ValueError(f"invalid irrep l={self.l} p={self.p}")

    @property
    def dim(self) -> int:
        return 2 * self.l + 1

    def __repr__(self) -> str:
        return f"{self.l}{'e' if self.p == 1 else 'o'}"

    @staticmethod
    def parse(s: str) -> "Irrep":
        s = s.strip()
        return Irrep(int(s[:-1]), {"e": 1, "o": -1}[s[-1]])

    def __mul__(self, other: "Irrep") -> Iterator["Irrep"]:
        """Selection rule: |l1-l2| <= l <= l1+l2, parity multiplies."""
        p = self.p * other.p
        for l in range(abs(self.l - other.l), self.l + other.l + 1):
            yield Irrep(l, p)


class Irreps:
    """An ordered direct sum of irreps with multiplicities, e.g. ``64x0e+64x1o``."""

    def __init__(self, irreps: Union[str, "Irreps", Sequence, None] = None):
        mulirreps: List[Tuple[int, Irrep]] = []
        if irreps is None:
            pass
        elif isinstance(irreps, Irreps):
            mulirreps = list(irreps._list)
        elif isinstance(irreps, str):
            if irreps.strip():
                for term in irreps.split("+"):
                    term = term.strip()
                    if "x" in term:
                        mul_s, ir_s = term.split("x")
                        mulirreps.append((int(mul_s), Irrep.parse(ir_s)))
                    else:
                        mulirreps.append((1, Irrep.parse(term)))
        elif isinstance(irreps, Irrep):
            mulirreps = [(1, irreps)]
        else:
            for item in irreps:
                if isinstance(item, Irrep):
                    mulirreps.append((1, item))
                else:
                    mul, ir = item
                    if not isinstance(ir, Irrep):
                        ir = Irrep.parse(ir) if isinstance(ir, str) else Irrep(*ir)
                    mulirreps.append((int(mul), ir))
        self._list: List[Tuple[int, Irrep]] = mulirreps

    # -- container protocol --------------------------------------------------
    def __iter__(self):
        return iter(self._list)

    def __len__(self):
        return len(self._list)

    def __getitem__(self, i):
        out = self._list[i]
        return Irreps(out) if isinstance(i, slice) else out

    def __eq__(self, other):
        return isinstance(other, Irreps) and self._list == Irreps(other)._list

    def __hash__(self):
        return hash(tuple(self._list))

    def __repr__(self):
        return "+".join(f"{mul}x{ir}" for mul, ir in self._list) or "(empty)"

    def __add__(self, other) -> "Irreps":
        return Irreps(self._list + Irreps(other)._list)

    def __mul__(self, factor: int) -> "Irreps":
        """``irreps * k`` multiplies every multiplicity by k (e3nn semantics)."""
        return Irreps([(mul * factor, ir) for mul, ir in self._list])

    __rmul__ = __mul__

    # -- properties -----------------------------------------------------------
    @property
    def dim(self) -> int:
        return sum(mul * ir.dim for mul, ir in self._list)

    @property
    def num_irreps(self) -> int:
        return sum(mul for mul, _ in self._list)

    @property
    def lmax(self) -> int:
        return max((ir.l for _, ir in self._list), default=0)

    @property
    def ls(self) -> List[int]:
        return [ir.l for mul, ir in self._list for _ in range(mul)]

    def count(self, ir: Union[str, Irrep]) -> int:
        if isinstance(ir, str):
            ir = Irrep.parse(ir)
        elif isinstance(ir, tuple) and not isinstance(ir, Irrep):
            ir = Irrep(*ir)
        return sum(mul for mul, i in self._list if i == ir)

    def __contains__(self, ir) -> bool:
        if isinstance(ir, str):
            ir = Irrep.parse(ir)
        return any(i == ir for _, i in self._list)

    def slices(self) -> List[slice]:
        out, ix = [], 0
        for mul, ir in self._list:
            out.append(slice(ix, ix + mul * ir.dim))
            ix += mul * ir.dim
        return out

    # -- algebra ---------------------------------------------------------------
    def sort(self) -> "Irreps":
        """Stable sort by (l, p); returns sorted Irreps (e3nn returns a tuple;
        we only ever need the sorted irreps)."""
        return Irreps(sorted(self._list, key=lambda x: (x[1].l, -x[1].p)))

    def simplify(self) -> "Irreps":
        """Merge adjacent equal irreps."""
        out: List[Tuple[int, Irrep]] = []
        for mul, ir in self._list:
            if out and out[-1][1] == ir:
                out[-1] = (out[-1][0] + mul, ir)
            elif mul > 0:
                out.append((mul, ir))
        return Irreps(out)

    @staticmethod
    def spherical_harmonics(lmax: int) -> "Irreps":
        """1x0e + 1x1o + 1x2e + ... (parity (-1)^l)."""
        return Irreps([(1, Irrep(l, (-1) ** l)) for l in range(lmax + 1)])


# ---------------------------------------------------------------------------
# SU(2) Clebsch-Gordan -> real-basis Wigner 3j
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _su2_cg(j1: int, j2: int, j3: int) -> np.ndarray:
    """<j1 m1 j2 m2 | j3 m3> in the complex |j m> basis, from the Racah
    formula in exact rational arithmetic (the JAX package asks sympy for the
    same exact values).

    Indices ordered m = -j .. j.  Returns float64 [2j1+1, 2j2+1, 2j3+1]."""
    f = math.factorial
    C = np.zeros((2 * j1 + 1, 2 * j2 + 1, 2 * j3 + 1))
    if not (abs(j1 - j2) <= j3 <= j1 + j2):
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
                sign = 1.0 if total > 0 else -1.0
                # sqrt(norm) * |total| as one exact square root
                C[j1 + m1, j2 + m2, j3 + m3] = sign * math.sqrt(
                    norm * total * total)
    return C


@functools.lru_cache(maxsize=None)
def sh_basis_change_matrix(l: int) -> np.ndarray:
    """Unitary A_l with  Y_real = A_l @ Y_complex  (rows: real m = -l..l).

    Standard real-spherical-harmonic combination of Condon-Shortley complex
    SH (Wikipedia "Spherical harmonics # Real form"):
        Y_{l,-m} = (i/sqrt2)  (Y_l^{-m} - (-1)^m Y_l^{m})   m > 0
        Y_{l,0}  = Y_l^0
        Y_{l,+m} = (1/sqrt2)  (Y_l^{-m} + (-1)^m Y_l^{m})   m > 0
    """
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
    """Real-basis Wigner 3j tensor C[m1, m2, m3], unit Frobenius norm.

    Intertwines real irreps in standard-product form:
        einsum('ai,bj,ijk->abk', D1, D2, C) == einsum('abj,jk->abk', C, D3)
    for every rotation, with D_l = wigner_D_from_matrix(l, R).

    Construction: C_real = (A1 (x) A2) C_su2 A3^dagger, then a global phase
    in {1, -1, i, -i} is stripped (the transformed tensor is real up to that
    phase) and the sign fixed deterministically.
    """
    C = _su2_cg(l1, l2, l3).astype(complex)
    A1 = sh_basis_change_matrix(l1)
    A2 = sh_basis_change_matrix(l2)
    A3 = sh_basis_change_matrix(l3)
    C = np.einsum("ai,bj,ck,ijk->abc", A1, A2, np.conj(A3), C)
    absC = np.abs(C)
    mx = absC.max()
    if mx == 0:
        return C.real
    idx = np.unravel_index(np.argmax(absC), C.shape)
    phase = C[idx] / mx
    # snap to the nearest of {1,-1,i,-i}
    cand = np.array([1, -1, 1j, -1j])
    phase = cand[np.argmin(np.abs(cand - phase))]
    C = C / phase
    assert np.abs(C.imag).max() < 1e-10, (l1, l2, l3)
    C = C.real
    C = C / np.linalg.norm(C.ravel())
    # deterministic sign: first entry (C-order) with magnitude > 0.5*max is positive
    flat = C.ravel()
    pivot = flat[np.abs(flat) > 0.5 * np.abs(flat).max()][0]
    if pivot < 0:
        C = -C
    return C


# ---------------------------------------------------------------------------
# Wigner D for real irreps (test-time utility)
# ---------------------------------------------------------------------------

# permutation (x,y,z) -> (y,z,x): real l=1 basis
_P_YZX = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])


@functools.lru_cache(maxsize=None)
def _coupling_orthonormal(l: int) -> np.ndarray:
    """K[(2l-1), 3, (2l+1)] with orthonormal columns coupling (l-1) x 1 -> l."""
    W = wigner_3j(l - 1, 1, l)
    return W * math.sqrt(2 * l + 1)


def wigner_D_from_matrix(l: int, R: np.ndarray) -> np.ndarray:
    """Real Wigner D matrix of degree l for a 3x3 orthogonal matrix R.

    For O(3) irreps (l, p): D = det(R)^((1-p)/2 applied by caller) — this
    returns the SO(3) part for R with det=+1; for reflections pass R directly
    (the recursion stays valid for any orthogonal R, giving the l-rep of O(3)
    with parity (-1)^l, i.e. the spherical-harmonic rep).
    """
    if l == 0:
        return np.ones((1, 1))
    D1 = _P_YZX @ R @ _P_YZX.T
    if l == 1:
        return D1
    Dprev = wigner_D_from_matrix(l - 1, R)
    K = _coupling_orthonormal(l)  # [2l-1, 3, 2l+1]
    # D_l = K^T (D_{l-1} (x) D_1) K
    return np.einsum("abk, ai, bj, ijm -> km", K, Dprev, D1, K)


def irrep_rep(ir: Irrep, R: np.ndarray, det: float) -> np.ndarray:
    """Representation matrix of the O(3) irrep ``ir`` for orthogonal R = det * R_so3."""
    Rso3 = R * det  # det in {+1,-1}; det*R has det=+1
    D = wigner_D_from_matrix(ir.l, Rso3)
    parity_factor = det if ir.p == -1 else 1.0
    return parity_factor * D


def irreps_rep(irreps: Irreps, R: np.ndarray, det: float) -> np.ndarray:
    """Block-diagonal rep matrix of ``irreps`` (mul copies of each block)."""
    blocks = []
    for mul, ir in irreps:
        D = irrep_rep(ir, R, det)
        for _ in range(mul):
            blocks.append(D)
    n = sum(b.shape[0] for b in blocks)
    out = np.zeros((n, n))
    i = 0
    for b in blocks:
        d = b.shape[0]
        out[i : i + d, i : i + d] = b
        i += d
    return out


# ---------------------------------------------------------------------------
# Tensor-product path enumeration (fully-connected, 'uvw')
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TPPath:
    """One (l1,p1) x (l2,p2) -> (l3,p3) path of a fully-connected tensor product."""

    i_in1: int  # index into in1 irreps list
    i_in2: int  # index into in2 irreps list
    i_out: int  # index into out irreps list
    mul_in1: int
    mul_in2: int
    mul_out: int
    ir_in1: Irrep
    ir_in2: Irrep
    ir_out: Irrep
    path_weight: float  # normalization coefficient folded into forward


def tp_paths(in1: Irreps, in2: Irreps, out: Irreps) -> List[TPPath]:
    """Enumerate CG-allowed paths, with e3nn-style normalization
    (irrep_normalization='component', path_normalization='element').

    Mirrors the path set of e3nn's ``o3.FullyConnectedTensorProduct(in1,
    in2, out)``, TFN's edge tensor product.
    """
    raw: List[Tuple[int, int, int, int, int, int, Irrep, Irrep, Irrep]] = []
    for i1, (mul1, ir1) in enumerate(in1):
        for i2, (mul2, ir2) in enumerate(in2):
            for ir_out in ir1 * ir2:
                for io, (mul_o, ir_o) in enumerate(out):
                    if ir_o == ir_out:
                        raw.append((i1, i2, io, mul1, mul2, mul_o, ir1, ir2, ir_o))
    # fan-in per output irrep: sum of mul1*mul2 over paths feeding it
    fan_in = {}
    for (_, _, io, mul1, mul2, _, _, _, _) in raw:
        fan_in[io] = fan_in.get(io, 0) + mul1 * mul2
    paths = []
    for (i1, i2, io, mul1, mul2, mul_o, ir1, ir2, ir_o) in raw:
        alpha = math.sqrt(ir_o.dim / fan_in[io])
        paths.append(TPPath(i1, i2, io, mul1, mul2, mul_o, ir1, ir2, ir_o, alpha))
    return paths


def tp_paths_uvu(in1: Irreps, in2: Irreps, target: Irreps
                 ) -> Tuple[Irreps, List[TPPath]]:
    """The 'uvu' paths of MACE's convolution (e3nn's
    ``tp_out_irreps_with_instructions``): each (i1, i2) pair gives one
    output irrep of multiplicity ``mul_in1`` for every CG-allowed
    ``ir_out`` in ``target``; the outputs are sorted by irrep.

    Returns ``(irreps_out, paths)``, the paths naming their sorted output
    slots.  Each slot is fed by exactly one path summing ``mul_in2``
    elements, so its weight is ``sqrt(ir_out.dim / mul_in2)`` (component
    irreps, 'element' paths)."""
    raw = []
    for i1, (mul1, ir1) in enumerate(in1):
        for i2, (mul2, ir2) in enumerate(in2):
            for ir_out in ir1 * ir2:
                if ir_out in target:
                    raw.append((i1, i2, mul1, mul2, ir1, ir2, ir_out))
    order = sorted(range(len(raw)), key=lambda k: (raw[k][6].l, -raw[k][6].p))
    irreps_out = Irreps([(raw[k][2], raw[k][6]) for k in order])
    slot_of = {k: s for s, k in enumerate(order)}
    paths = []
    for k, (i1, i2, mul1, mul2, ir1, ir2, ir_out) in enumerate(raw):
        alpha = math.sqrt(ir_out.dim / mul2)
        paths.append(TPPath(i1, i2, slot_of[k], mul1, mul2, mul1, ir1, ir2,
                            ir_out, alpha))
    return irreps_out, paths


# ---------------------------------------------------------------------------
# Generalized coupling (U tensors) for the MACE symmetric contraction
# ---------------------------------------------------------------------------


def _wigner_nj(irreps_list: List[Irreps]) -> List[Tuple[Irrep, np.ndarray]]:
    """Recursive n-fold coupling of a list of Irreps into generalized Wigner
    tensors; returns ``[(ir_out, E)]`` with E of shape
    ``[ir_out.dim, d1, d2, ..., dn]``, sorted by (l, -p).

    Component normalization: each recursion step multiplies the unit-norm
    3j tensor by sqrt(ir_out.dim)."""
    if len(irreps_list) == 1:
        (irreps,) = irreps_list
        ret = []
        e = np.eye(irreps.dim)
        i = 0
        for mul, ir in irreps:
            for _ in range(mul):
                ret.append((ir, e[i:i + ir.dim]))
                i += ir.dim
        return ret

    *left_list, right = irreps_list
    ret = []
    for ir_left, C_left in _wigner_nj(left_list):
        i = 0
        for mul, ir in right:
            for ir_out in ir_left * ir:
                C = wigner_3j(ir_out.l, ir_left.l, ir.l) * math.sqrt(ir_out.dim)
                # C[m_out, m_left, m] ; C_left[m_left, d1..dk]
                C_full = np.einsum("oLm,L...->o...m", C, C_left)
                # the last factor spread over the full right-irreps dimension
                for u in range(mul):
                    E = np.zeros((ir_out.dim,) + C_left.shape[1:] + (right.dim,))
                    sl = slice(i + u * ir.dim, i + (u + 1) * ir.dim)
                    E[..., sl] = C_full
                    ret.append((ir_out, E))
            i += mul * ir.dim
    return sorted(ret, key=lambda x: (x[0].l, -x[0].p))


_DISK_CACHE_DIR = None


def set_disk_cache(path: str) -> None:
    """Keep the U matrices as ``.npy`` files under ``path`` (created if
    missing) and read them from there: opt-in, off by default.  Writes go
    through a temporary file and an atomic rename, so processes may share
    the directory."""
    global _DISK_CACHE_DIR
    os.makedirs(path, exist_ok=True)
    _DISK_CACHE_DIR = path


def _disk_cache_load(key: str):
    if _DISK_CACHE_DIR is None:
        return None
    f = os.path.join(_DISK_CACHE_DIR, f"{key}.npy")
    return np.load(f) if os.path.exists(f) else None


def _disk_cache_store(key: str, arr: np.ndarray) -> None:
    if _DISK_CACHE_DIR is None:
        return
    fd, tmp = tempfile.mkstemp(dir=_DISK_CACHE_DIR, suffix=".npy")
    with os.fdopen(fd, "wb") as fh:
        np.save(fh, arr)
    os.replace(tmp, os.path.join(_DISK_CACHE_DIR, f"{key}.npy"))


@functools.lru_cache(maxsize=None)
def _u_matrix_cached(irreps_in_str: str, ir_out_str: str,
                     correlation: int) -> np.ndarray:
    key = (f"U_{irreps_in_str}_{ir_out_str}_{correlation}"
           .replace("+", "_").replace("x", ""))
    hit = _disk_cache_load(key)
    if hit is not None:
        return hit
    irreps_in = Irreps(irreps_in_str)
    ir_out = Irrep.parse(ir_out_str)
    coupled = _wigner_nj([irreps_in] * correlation)
    stack = [E for ir, E in coupled if ir == ir_out]
    if not stack:
        U = np.zeros((ir_out.dim,) + (irreps_in.dim,) * correlation + (0,))
    else:
        U = np.stack(stack, axis=-1)  # [ir_out.dim, d^corr ..., n_paths]
    if ir_out.dim == 1:
        U = U[0]  # scalar output: the d_out axis omitted
    U = np.ascontiguousarray(U)
    _disk_cache_store(key, U)
    return U


def u_matrix_real(irreps_in: Irreps, ir_out: Irrep,
                  correlation: int) -> np.ndarray:
    """The U tensor of the generalized CG paths that couple ``correlation``
    copies of ``irreps_in`` (one channel each) to ``ir_out``: shape
    ``[ir_out.dim (omitted when 1), d, ..., d, n_paths]`` with d =
    ``irreps_in.dim``, float64, cached per process (one array shared by
    every caller: do not write to it)."""
    return _u_matrix_cached(str(irreps_in), str(ir_out), correlation)
