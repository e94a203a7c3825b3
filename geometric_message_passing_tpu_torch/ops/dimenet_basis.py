"""DimeNet/SphereNet basis functions: spherical Bessel x spherical harmonics
(port of ``ops/dimenet_basis.py``).

All symbolic work is reduced to coefficient tables built once in float64
numpy (the Bessel polynomials, their zeros and normalisers by scipy, the
Legendre tables and the harmonics' prefactors); on the device the bases are
Horner polynomials and sin/cos.

  * spherical Bessel j_l(x) = (s_l(x^2) sin x + x c_l(x^2) cos x) / x^(l+1),
    with integer-coefficient polynomials from j_l = (2l-1)/x j_{l-1} - j_{l-2};
  * zeros z_{l,k} of j_l by interlaced bisection from z_{0,k} = k pi;
  * normalised radial basis n_{l,k} j_l(z_{l,k} d / c),
    n_{l,k} = 1 / sqrt(0.5 j_{l+1}(z_{l,k})^2);
  * real spherical harmonics in DimeNet's convention:
    Y_l0 = pref(l,0) P_l(cos theta),
    Y_l,+-m = sqrt2 pref(l,m) sin^m(theta) {cos, sin}(m phi) Ptilde_lm(cos theta).

``spherical_bessel_jl`` switches to the ascending series below a per-l
threshold: the closed form cancels catastrophically in float32 at small x
and overflows at x = 0, where pad edges sit (dist 0).

The bases evaluate every (l, k) or (l, m) column at once, each column with
its own coefficients (polynomials padded with leading zeros, which Horner's
rule passes through exactly), so a basis is some tens of element-wise
launches on the card, not one set per column: the per-column loops of the
JAX package cost thousands of launches per step in eager PyTorch.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
from scipy import optimize, special
from torch import nn

# ---------------------------------------------------------------------------
# Coefficient tables (float64, built once)
# ---------------------------------------------------------------------------


def _poly_sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    n = max(len(a), len(b))
    return np.pad(a, (0, n - len(a))) - np.pad(b, (0, n - len(b)))


@functools.lru_cache(maxsize=None)
def _sph_bessel_poly(l: int) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """Coefficients (ascending powers of x^2) of s_l and c_l with
    j_l(x) = (s_l(x^2) sin x + x c_l(x^2) cos x) / x^(l+1)."""
    s = [np.array([1.0]), np.array([1.0])]      # s_0 = 1, s_1 = 1
    c = [np.array([0.0]), np.array([-1.0])]     # c_0 = 0, x c_1 = -x
    for ll in range(2, l + 1):
        # s_l = (2l-1) s_{l-1} - u s_{l-2}   (u = x^2), c_l likewise
        s.append(_poly_sub((2 * ll - 1) * s[ll - 1],
                           np.concatenate([[0.0], s[ll - 2]])))
        c.append(_poly_sub((2 * ll - 1) * c[ll - 1],
                           np.concatenate([[0.0], c[ll - 2]])))
    return tuple(s[l]), tuple(c[l])


@functools.lru_cache(maxsize=None)
def bessel_zeros(num_spherical: int, num_radial: int
                 ) -> Tuple[Tuple[float, ...], ...]:
    """The first ``num_radial`` positive zeros of j_l for l < num_spherical
    (the zeros of j_l separate those of j_{l+1})."""
    zeros = [tuple((np.arange(1, num_radial + num_spherical) * math.pi).tolist())]
    for l in range(1, num_spherical):
        prev = zeros[-1]
        zeros.append(tuple(
            optimize.brentq(lambda x: special.spherical_jn(l, x),
                            prev[k], prev[k + 1])
            for k in range(len(prev) - 1)))
    return tuple(tuple(z[:num_radial]) for z in zeros)


@functools.lru_cache(maxsize=None)
def bessel_normalizers(num_spherical: int, num_radial: int):
    z = bessel_zeros(num_spherical, num_radial)
    return tuple(
        tuple(float(1.0 / math.sqrt(0.5 * special.spherical_jn(l + 1, zk) ** 2))
              for zk in z[l])
        for l in range(num_spherical))


@functools.lru_cache(maxsize=None)
def _legendre_tilde(num_spherical: int):
    """Ptilde_lm(z) = P_lm(z) / (1 - z^2)^(m/2) coefficient tables
    (ascending powers of z), by the associated Legendre recursions."""
    P = [[None] * (l + 1) for l in range(num_spherical)]
    P[0][0] = np.array([1.0])
    if num_spherical > 1:
        P[1][0] = np.array([0.0, 1.0])
        for l in range(2, num_spherical):
            P[l][0] = _poly_sub(np.concatenate([[0.0], P[l - 1][0]]) * (2 * l - 1),
                                P[l - 2][0] * (l - 1)) / l
        for m in range(1, num_spherical):
            P[m][m] = (1 - 2 * m) * P[m - 1][m - 1]
            if m + 1 < num_spherical:
                P[m + 1][m] = (2 * m + 1) * np.concatenate([[0.0], P[m][m]])
            for l in range(m + 2, num_spherical):
                P[l][m] = _poly_sub(
                    np.concatenate([[0.0], P[l - 1][m]]) * (2 * l - 1),
                    P[l - 2][m] * (l + m - 1)) / (l - m)
    return tuple(tuple(tuple(c) for c in row if c is not None) for row in P)


def _sph_prefactor(l: int, m: int) -> float:
    return math.sqrt((2 * l + 1) * math.factorial(l - abs(m))
                     / (4 * math.pi * math.factorial(l + abs(m))))


def _horner(coeffs, x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros_like(x) + coeffs[-1]
    for c in coeffs[-2::-1]:
        acc = acc * x + c
    return acc


# ---------------------------------------------------------------------------
# Bases
# ---------------------------------------------------------------------------


def spherical_bessel_jl(l: int, x: torch.Tensor, small: Optional[float] = None,
                        series_terms: int = 12) -> torch.Tensor:
    """j_l by the closed form for x >= ``small`` and by the ascending series
    x^l / (2l+1)!! sum_k (-x^2/2)^k / (k! (2l+3)(2l+5)...(2l+2k+1)) below it.

    The series' terms shrink monotonically for x^2 < 2(2l+3), so it has no
    cancellation there; the default switch min(1 + 0.8 l, 6) lies inside
    both forms' float32 validity windows.  The double ``where`` keeps both
    branches' gradients finite (x = 0 included)."""
    if small is None:
        small = min(1.0 + 0.8 * l, 6.0)
    s, c = _sph_bessel_poly(l)
    small_mask = x < small
    xs = torch.where(small_mask, torch.ones_like(x), x)
    u = xs * xs
    num = _horner(s, u) * torch.sin(xs) + xs * _horner(c, u) * torch.cos(xs)
    closed = num / xs ** (l + 1)
    dfact = float(np.prod(np.arange(2 * l + 1, 0, -2)))   # (2l+1)!!
    v = x * x
    acc = torch.ones_like(x)
    term = torch.ones_like(x)
    for k in range(1, series_terms):
        term = term * (-v) / (2 * k * (2 * l + 2 * k + 1))
        acc = acc + term
    series = ((x ** l if l else torch.ones_like(x)) / dfact) * acc
    return torch.where(small_mask, series, closed)


class DistEmb(nn.Module):
    """Trainable-frequency Bessel distance embedding with the polynomial
    envelope (PyG's ``BesselBasisLayer``); ``zero_outside`` multiplies by
    (d < cutoff) as PyG does, SphereNet's envelope does not."""

    def __init__(self, num_radial: int, cutoff: float = 5.0,
                 envelope_exponent: int = 5, zero_outside: bool = False):
        super().__init__()
        self.cutoff, self.zero_outside = cutoff, zero_outside
        self.p = envelope_exponent + 1
        self.freq = nn.Parameter(torch.from_numpy(
            (np.arange(1, num_radial + 1) * math.pi).astype(np.float32)))

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        x = (dist / self.cutoff)[..., None]
        p = self.p
        a = -(p + 1) * (p + 2) / 2.0
        b = p * (p + 2.0)
        c = -p * (p + 1) / 2.0
        xs = torch.clamp_min(x, 1e-9)
        env = 1.0 / xs + a * x ** (p - 1) + b * x ** p + c * x ** (p + 1)
        if self.zero_outside:
            env = env * (x < 1.0)
        return env * torch.sin(self.freq * x)


def _padded(polys) -> np.ndarray:
    """``[max degree + 1, len(polys)]`` coefficients (ascending powers), each
    column padded with zeros at the top."""
    out = np.zeros((max(len(p) for p in polys), len(polys)))
    for col, p in enumerate(polys):
        out[: len(p), col] = p
    return out


def _ipow(x: torch.Tensor, exps: torch.Tensor, top: int) -> torch.Tensor:
    """``x ** exps`` column by column for integer ``exps`` in ``[0, top]``
    by repeated products (finite gradients at x = 0, unlike ``pow``)."""
    out = torch.ones_like(x)
    for p in range(1, top + 1):
        out = torch.where(exps >= p, out * x, out)
    return out


@functools.lru_cache(maxsize=None)
def _rbf_columns(num_spherical: int, num_radial: int, series_terms: int = 12):
    """Per-column constants of ``sph_bessel_rbf`` (column l * nr + k), as
    float32 numpy rows: zeros, normalisers, l, the series switch, (2l+1)!!,
    the series' divisors, and the s_l / c_l coefficient tables."""
    cols = [(l, k) for l in range(num_spherical) for k in range(num_radial)]
    zeros = bessel_zeros(num_spherical, num_radial)
    norms = bessel_normalizers(num_spherical, num_radial)
    ls = np.array([l for l, _ in cols])
    div = np.array([[2 * k * (2 * l + 2 * k + 1) for l, _ in cols]
                    for k in range(1, series_terms)], np.float64)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        z=f32([zeros[l][k] for l, k in cols]),
        norm=f32([norms[l][k] for l, k in cols]),
        l=f32(ls), top=int(ls.max()),
        small=f32([min(1.0 + 0.8 * l, 6.0) for l, _ in cols]),
        dfact=f32([np.prod(np.arange(2 * l + 1, 0, -2)) for l, _ in cols]),
        div=f32(div),
        s=f32(_padded([_sph_bessel_poly(l)[0] for l, _ in cols])),
        c=f32(_padded([_sph_bessel_poly(l)[1] for l, _ in cols])))


_ON_DEVICE: dict = {}


def _on(device: torch.device, cols: dict) -> dict:
    """The array entries of ``cols`` as tensors on ``device``, copied once
    per device (a copy from host memory per call would wait for the
    card)."""
    key = (id(cols), str(device))
    hit = _ON_DEVICE.get(key)
    if hit is None:
        hit = {k: torch.from_numpy(v).to(device) for k, v in cols.items()
               if isinstance(v, np.ndarray)}
        _ON_DEVICE[key] = hit
    return hit


def _horner_cols(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Horner's rule per column: ``coeffs [deg+1, C]``, ``x [R, C]``."""
    acc = torch.zeros_like(x) + coeffs[-1]
    for c in coeffs.flip(0)[1:]:
        acc = acc * x + c
    return acc


def sph_bessel_rbf(dist: torch.Tensor, num_spherical: int, num_radial: int,
                   cutoff: float) -> torch.Tensor:
    """The per-edge radial half of the 2D/3D bases: ``[E, ns*nr]`` of
    n_{l,k} j_l(z_{l,k} d / c), column l * nr + k, all columns at once
    (``spherical_bessel_jl``'s two branches, per column)."""
    cols = _rbf_columns(num_spherical, num_radial)
    t = _on(dist.device, cols)
    x = (dist / cutoff)[:, None] * t["z"]
    small_mask = x < t["small"]
    xs = torch.where(small_mask, torch.ones_like(x), x)
    u = xs * xs
    num = (_horner_cols(t["s"], u) * torch.sin(xs)
           + xs * _horner_cols(t["c"], u) * torch.cos(xs))
    closed = num / _ipow(xs, t["l"] + 1, cols["top"] + 1)
    v = x * x
    acc = torch.ones_like(x)
    term = torch.ones_like(x)
    for div in t["div"]:
        term = term * (-v) / div
        acc = acc + term
    series = (_ipow(x, t["l"], cols["top"]) / t["dfact"]) * acc
    return t["norm"] * torch.where(small_mask, series, closed)


@functools.lru_cache(maxsize=None)
def _cbf_columns(num_spherical: int):
    """Per-column constants of ``angle_cbf`` and ``torsion_cbf`` as float32
    numpy: the Legendre tables, |m|, the sign of m and the prefactors (times
    sqrt 2 for m != 0), torsion columns in the order l, then m = 0, +1..+l,
    -l..-1."""
    leg = _legendre_tilde(num_spherical)
    lm = [(0, 0)] + [(l, m) for l in range(1, num_spherical)
                     for m in list(range(0, l + 1)) + list(range(-l, 0))]
    pref = [(_sph_prefactor(l, 0) if m == 0
             else math.sqrt(2.0) * _sph_prefactor(l, abs(m))) for l, m in lm]
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        angle_leg=f32(_padded([leg[l][0] for l in range(num_spherical)])),
        angle_pref=f32([_sph_prefactor(l, 0) for l in range(num_spherical)]),
        leg=f32(_padded([leg[l][abs(m)] for l, m in lm])),
        am=f32([abs(m) for _, m in lm]), sign=f32([np.sign(m) for _, m in lm]),
        pref=f32(pref), top=num_spherical - 1)


def angle_cbf(angle: torch.Tensor, num_spherical: int) -> torch.Tensor:
    """The per-triplet angular half of the 2D basis: ``[T, ns]`` of
    pref(l,0) Ptilde_l0(cos angle)."""
    cols = _cbf_columns(num_spherical)
    t = _on(angle.device, cols)
    leg, pref = t["angle_leg"], t["angle_pref"]
    cos_t = torch.cos(angle)[:, None].expand(-1, num_spherical)
    return pref * _horner_cols(leg, cos_t)


def torsion_cbf(angle: torch.Tensor, phi: torch.Tensor,
                num_spherical: int) -> torch.Tensor:
    """The per-triplet angular half of the 3D basis: ``[T, ns*ns]`` of real
    Y_lm(theta, phi), within each l in the channel order m = 0, +1..+l,
    -l..-1."""
    cols = _cbf_columns(num_spherical)
    t = _on(angle.device, cols)
    width = t["am"].shape[0]
    cos_t = torch.cos(angle)[:, None].expand(-1, width)
    sin_t = torch.sin(angle)[:, None].expand(-1, width)
    pt = _horner_cols(t["leg"], cos_t) * _ipow(sin_t, t["am"], cols["top"])
    mphi = t["am"] * phi[:, None]
    trig = torch.where(t["sign"] > 0, torch.cos(mphi),
                       torch.where(t["sign"] < 0, torch.sin(mphi),
                                   torch.ones_like(mphi)))
    return t["pref"] * trig * pt


def angle_emb(dist: torch.Tensor, angle: torch.Tensor, idx_kj: torch.Tensor,
              num_spherical: int, num_radial: int,
              cutoff: float = 5.0) -> torch.Tensor:
    """The 2D (distance x angle) basis ``[T, ns*nr]``: n_{l,k} j_l(z_{l,k}
    d_kj / c) Y_l0(angle) (the JAX package's ``AngleEmb``, which has no
    parameters)."""
    rbf = sph_bessel_rbf(dist, num_spherical, num_radial, cutoff)
    return angle_product(rbf[idx_kj], angle_cbf(angle, num_spherical))


def angle_product(rbf_rows: torch.Tensor, cbf: torch.Tensor) -> torch.Tensor:
    """``[T, ns*nr]`` of the gathered radial rows times the angular part."""
    ns = cbf.shape[1]
    return (rbf_rows.reshape(-1, ns, rbf_rows.shape[1] // ns)
            * cbf[:, :, None]).reshape(rbf_rows.shape[0], -1)


def torsion_emb(dist: torch.Tensor, angle: torch.Tensor, phi: torch.Tensor,
                idx_kj: torch.Tensor, num_spherical: int, num_radial: int,
                cutoff: float = 5.0) -> torch.Tensor:
    """The 3D (distance x angle x torsion) basis ``[T, ns*ns*nr]`` (the JAX
    package's ``TorsionEmb``, which has no parameters)."""
    rbf = sph_bessel_rbf(dist, num_spherical, num_radial, cutoff)
    return torsion_product(rbf[idx_kj], torsion_cbf(angle, phi, num_spherical))


def torsion_product(rbf_rows: torch.Tensor, tcbf: torch.Tensor) -> torch.Tensor:
    """``[T, ns*ns*nr]`` of the gathered radial rows times Y_lm."""
    t = rbf_rows.shape[0]
    ns = math.isqrt(tcbf.shape[1])
    return (rbf_rows.reshape(t, 1, ns, -1)
            * tcbf.reshape(t, ns, ns, 1)).reshape(t, -1)
